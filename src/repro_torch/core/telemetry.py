"""Telemetry spine: the energy ledger, copied from ``repro.core.telemetry``.

Every layer emits :class:`StepEvent` records into one :class:`EnergyLedger`
instead of keeping private tallies: the device simulator computes per-rail
(CPU / GPU / bus) joules for every executed op; the closed-loop controller
(``core.controller``) appends one ``infer`` event per graph inference and
one ``request`` event per replayed arrival; the serving engine under
``AdaOperScheduler`` appends ``prefill`` / ``decode`` events for every
iteration, split per rail by the plan's fractions, and, with or without a
scheduler, a ``request`` event per retirement and a ``rejected`` event per
error response. Plain Python and numpy: no framework.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

RAILS = ("cpu", "gpu", "bus")


@dataclass
class EnergyBreakdown:
    """Joules attributed to each power rail.

    ``total_j`` is stored, not derived: the simulator computes the total in
    its original summation order so existing numerics stay bit-identical,
    while the rails carry the attribution. ``sum_of_rails_j`` re-derives the
    total from the rails; the two agree to float associativity (asserted by
    the energy-conservation test). Predicted (planner) energies whose rail
    split is unknown carry zero rails — ``unattributed_j`` exposes the gap.
    """

    cpu_j: float = 0.0
    gpu_j: float = 0.0
    bus_j: float = 0.0
    total_j: float = 0.0

    @property
    def sum_of_rails_j(self) -> float:
        return self.cpu_j + self.gpu_j + self.bus_j

    @property
    def unattributed_j(self) -> float:
        return self.total_j - self.sum_of_rails_j

    def __add__(self, other: "EnergyBreakdown") -> "EnergyBreakdown":
        return EnergyBreakdown(self.cpu_j + other.cpu_j,
                               self.gpu_j + other.gpu_j,
                               self.bus_j + other.bus_j,
                               self.total_j + other.total_j)

    def __iadd__(self, other: "EnergyBreakdown") -> "EnergyBreakdown":
        self.cpu_j += other.cpu_j
        self.gpu_j += other.gpu_j
        self.bus_j += other.bus_j
        self.total_j += other.total_j
        return self

    def fractions(self) -> Optional[Tuple[float, float, float]]:
        """(cpu, gpu, bus) shares of the rail-attributed energy, or None
        when nothing is attributed."""
        s = self.sum_of_rails_j
        if s <= 0.0:
            return None
        return (self.cpu_j / s, self.gpu_j / s, self.bus_j / s)

    def rails_dict(self) -> Dict[str, float]:
        return {"cpu": self.cpu_j, "gpu": self.gpu_j, "bus": self.bus_j}

    @classmethod
    def from_total(cls, total_j: float,
                   fractions: Optional[Sequence[float]] = None
                   ) -> "EnergyBreakdown":
        """Attribute ``total_j`` across rails by ``fractions`` (cpu, gpu,
        bus). ``None`` records the total with zero rails (unattributed)."""
        if fractions is None:
            return cls(0.0, 0.0, 0.0, float(total_j))
        fc, fg, fb = fractions
        return cls(total_j * fc, total_j * fg, total_j * fb, float(total_j))


@dataclass
class StepEvent:
    """One telemetry record: an op, an inference, an engine iteration, an
    idle gap, or a completed request.

    ``kind`` ∈ {"op", "infer", "prefill", "decode", "idle", "request",
    "rejected"} by convention (the ledger does not enforce a closed set).
    ``t_s`` is the virtual timestamp at the event's start where a virtual
    clock exists, else NaN; ``n_active`` is the number of residents sharing
    the step (1 for single-request events). ``meta`` carries layer-specific
    context (e.g. the fleet trace request, an admission reason).
    """

    kind: str
    latency_s: float
    energy: EnergyBreakdown
    t_s: float = float("nan")
    model: str = ""
    uid: Optional[int] = None
    n_active: int = 1
    meta: dict = field(default_factory=dict)


class EnergyLedger:
    """Append-only event stream plus named counters — the single source
    every report folds. Events are appended in execution order, so two runs
    of a deterministic replay produce identical ledgers."""

    def __init__(self):
        self.events: List[StepEvent] = []
        self.counters: Dict[str, int] = {}

    def __len__(self) -> int:
        return len(self.events)

    def append(self, event: StepEvent) -> StepEvent:
        self.events.append(event)
        return event

    def emit(self, kind: str, latency_s: float, energy: EnergyBreakdown,
             **kw) -> StepEvent:
        return self.append(StepEvent(kind, latency_s, energy, **kw))

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def clear(self) -> None:
        """Drop all events and counters (e.g. between a benchmark's warmup
        and measured pass)."""
        self.events.clear()
        self.counters.clear()

    # ------------------------------------------------------------------
    # folds — every aggregate a report prints derives from these
    # ------------------------------------------------------------------
    def select(self, kind: Optional[str] = None,
               model: Optional[str] = None) -> List[StepEvent]:
        return [e for e in self.events
                if (kind is None or e.kind == kind)
                and (model is None or e.model == model)]

    def total_energy(self, kind: Optional[str] = None,
                     model: Optional[str] = None) -> EnergyBreakdown:
        return fold_energy(self.select(kind=kind, model=model))

    def energy_by_model(self, kind: Optional[str] = None
                        ) -> Dict[str, EnergyBreakdown]:
        out: Dict[str, EnergyBreakdown] = {}
        for e in self.events:
            if kind is not None and e.kind != kind:
                continue
            out.setdefault(e.model, EnergyBreakdown())
            out[e.model] += e.energy
        return out

    def requests(self, model: Optional[str] = None) -> List[StepEvent]:
        """The per-request accounting stream: one event per served request,
        appended at retirement/completion by the emitting layer."""
        return self.select(kind="request", model=model)


def fold_energy(events: Iterable[StepEvent]) -> EnergyBreakdown:
    total = EnergyBreakdown()
    for e in events:
        total += e.energy
    return total
