"""Execution context threaded through the model apply functions: the
counterpart of ``repro.sharding.context.ExecContext``, holding only what
this slice of the port reads. The mesh fields arrive with sharded serving
(see ROADMAP.md)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ExecContext:
    # None: the tensors' device decides (the CUDA kernels on the card, their
    # plain versions on the CPU); "plain": the plain versions on any device.
    # It selects both the attention kernels and the SSD scan.
    attn_impl: Optional[str] = None

    @property
    def model_parallel(self) -> int:
        """Tensor-parallel shard count, read by ``sharding.comm``: 1 until
        sharded serving is ported."""
        return 1
