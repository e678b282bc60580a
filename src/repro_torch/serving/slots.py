"""Slot-pool state for continuous batching: requests, responses, the
fixed-size cache-row allocator and the per-model pool — the counterpart of
``repro.serving.slots``."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.telemetry import EnergyBreakdown


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int = 16
    # encoder-decoder models: the encoder's frame embeddings (T_frames, d_model)
    enc_inputs: Optional[np.ndarray] = None
    t_submit: float = 0.0  # stamped by ServingEngine.submit
    # graceful degradation (repro_torch.serving.robustness): a deadline
    # turns into timeout -> bounded requeue-with-backoff -> explicit error
    priority: int = 0
    deadline_s: Optional[float] = None  # relative to t_submit; None = none
    retries: int = 0  # deadline requeues consumed so far


@dataclass
class Response:
    uid: int
    tokens: np.ndarray
    latency_s: float
    energy_j_pred: float
    # set when the request was rejected instead of served (e.g. oversized
    # prompt): the serving loop keeps draining, it never crashes mid-admit
    error: Optional[str] = None
    rails: Optional[EnergyBreakdown] = None


class SlotAllocator:
    """Fixed pool of cache rows for continuous batching. O(1) alloc/free,
    LIFO reuse so the most-recently-retired row is handed out first.
    Double-free and foreign-slot frees raise."""

    def __init__(self, n_slots: int):
        if n_slots <= 0:
            raise ValueError(f"n_slots must be positive, got {n_slots}")
        self.n_slots = n_slots
        self._free = list(range(n_slots - 1, -1, -1))
        self._in_use: set = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_active(self) -> int:
        return len(self._in_use)

    def alloc(self) -> Optional[int]:
        """Returns a free slot index, or None when the pool is full."""
        if not self._free:
            return None
        slot = self._free.pop()
        self._in_use.add(slot)
        return slot

    def free(self, slot: int) -> None:
        if slot not in self._in_use:
            raise ValueError(f"slot {slot} is not allocated")
        self._in_use.remove(slot)
        self._free.append(slot)


@dataclass
class _ActiveSeq:
    """A request resident in a cache slot."""
    req: Request
    slot: int
    pos: int  # next cache write position (prompt_len + generated so far)
    model: str = ""  # owning worker (stamped at admission; telemetry key)
    tokens: List[int] = field(default_factory=list)
    rails: EnergyBreakdown = field(default_factory=EnergyBreakdown)
    # seed-derived per-request sampling stream id (None on the greedy
    # path): token i draws from stream (rng, i), so sampled decode is
    # reproducible under any admission order / slot placement
    rng: Optional[int] = None
    # speculative decode (repro_torch.serving.speculative; inert without a
    # draft): draft_pos is the draft cache's frontier, the next position
    # the draft worker writes; spec_hist is the sliding (accepted, offered)
    # window behind the per-slot adaptive k
    draft_pos: int = 0
    spec_hist: List = field(default_factory=list)

    @property
    def energy_j(self) -> float:
        return self.rails.total_j


class _SlotPool:
    """Per-model continuous-batching state: the slot cache + allocator plus
    the dense (max_slots,) token/position arrays fed to the ragged decode."""

    def __init__(self, worker, max_slots: int):
        self.cache = worker.init_pool(max_slots)
        # a meshed worker's placement of the pool cache (leaf name -> the
        # activation rules' placement, sharding.partition_specs.cache_spec);
        # None on the single-device path
        self.cache_shardings = (worker._cache_shardings.get((max_slots, worker.max_enc_len))
                                if worker.mesh is not None else None)
        self.alloc = SlotAllocator(max_slots)
        self.active: Dict[int, _ActiveSeq] = {}
        self.tokens = np.zeros((max_slots, 1), np.int32)
        self.pos = np.zeros(max_slots, np.int32)
        # per-slot valid encoder length (encoder-decoder models): decode
        # masks each row's cross-attention to its own encoder region
        self.enc_len = np.zeros(max_slots, np.int32)
