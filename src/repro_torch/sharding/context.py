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
    # plain versions on the CPU); "plain": the plain versions on any device
    attn_impl: Optional[str] = None
