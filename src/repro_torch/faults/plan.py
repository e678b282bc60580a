"""Typed, seedable fault schedules for chaos-tested replay (a copy of
``repro.faults.plan``).

A :class:`FaultPlan` is an ordered set of :class:`FaultEvent` windows on the
replay's *virtual* clock. The :class:`~repro_torch.faults.injector.FaultInjector`
walks the plan's boundaries as the replay driver advances time and mutates
the device simulator's fault state; recovery is exercised by the controller
(processor-fallback replanning, bounded op retries) and the serving engine
(deadline requeue, priority-aware shedding). Everything is deterministic in
``(scenario, duration, seed)`` — the same chaos replay always injects the
same faults at the same instants.

Fault taxonomy (see docs/robustness.md):

  * ``gpu_dropout`` / ``cpu_dropout`` — a processor rail fails outright:
    executing any op fraction on it raises ``ProcessorFault`` until the
    rail recovers; planners must pin partition ratios to the survivors.
  * ``thermal_throttle`` — a hard frequency-cap spike: the DVFS walk is
    clamped to ``scale`` x the preset operating point for the window.
  * ``battery_critical`` — the low-battery regime: the serving engine sheds
    lowest-priority queued requests with explicit error responses.
  * ``mem_pressure`` — latency inflation (x ``inflation``) invisible to the
    resource monitor, like the latent thermal state.
  * ``transient_op`` — arms ``count`` one-shot per-op execution failures;
    the controller retries the op a bounded number of times.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

KINDS = ("gpu_dropout", "cpu_dropout", "thermal_throttle",
         "battery_critical", "mem_pressure", "transient_op")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault window on the virtual clock. ``duration_s`` may
    be ``inf`` (never clears within the replay); ``transient_op`` events are
    instantaneous (they arm a failure budget instead of opening a window)."""
    kind: str
    t_start_s: float
    duration_s: float
    params: dict = field(default_factory=dict)

    @property
    def t_end_s(self) -> float:
        return self.t_start_s + self.duration_s


class FaultPlan:
    """An immutable, time-sorted schedule of fault events."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        for ev in events:
            if ev.kind not in KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r}; "
                                 f"choose from {KINDS}")
            if ev.t_start_s < 0.0 or ev.duration_s < 0.0:
                raise ValueError(f"fault event times must be non-negative: {ev}")
        self.events: Tuple[FaultEvent, ...] = tuple(
            sorted(events, key=lambda e: (e.t_start_s, e.kind)))

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self.events)

    def __eq__(self, other) -> bool:
        return isinstance(other, FaultPlan) and self.events == other.events

    def boundaries(self) -> List[Tuple[float, int, str, FaultEvent]]:
        """Every apply/clear instant, time-sorted. At equal times clears
        process before applies (action rank 0 < 1) so back-to-back windows
        hand over cleanly; ``transient_op`` has no clear boundary."""
        out: List[Tuple[float, int, str, FaultEvent]] = []
        for ev in self.events:
            out.append((ev.t_start_s, 1, "apply", ev))
            if ev.kind != "transient_op" and np.isfinite(ev.t_end_s):
                out.append((ev.t_end_s, 0, "clear", ev))
        out.sort(key=lambda b: (b[0], b[1], b[3].kind))
        return out

    def summary(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for ev in self.events:
            counts[ev.kind] = counts.get(ev.kind, 0) + 1
        return counts


# ---------------------------------------------------------------------------
# chaos scenario profiles (repro_torch.fleet wiring)
# ---------------------------------------------------------------------------
# Each profile lists (kind, start_frac, end_frac, params) windows in
# fractions of the trace duration; boundaries get a small seeded jitter so
# different devices/seeds see decorrelated (but reproducible) timelines.
# Both profiles include the gpu_dropout + thermal_throttle core the chaos
# acceptance gate exercises; transient op failures ride only on the mixed
# profile (they fire on the operator-graph execution path).

_PROFILES: Dict[str, Tuple[Tuple[str, float, float, dict], ...]] = {
    "chaos_voice": (
        ("mem_pressure", 0.05, 0.20, {"inflation": 1.6}),
        ("gpu_dropout", 0.28, 0.50, {}),
        ("thermal_throttle", 0.55, 0.78, {"scale": 0.5}),
        ("battery_critical", 0.80, float("inf"), {}),
    ),
    "chaos_mixed": (
        ("mem_pressure", 0.05, 0.18, {"inflation": 1.5}),
        ("transient_op", 0.12, 0.12, {"count": 2}),
        ("gpu_dropout", 0.25, 0.45, {}),
        ("thermal_throttle", 0.50, 0.72, {"scale": 0.5}),
        ("battery_critical", 0.78, float("inf"), {}),
    ),
}

CHAOS_SCENARIOS = tuple(sorted(_PROFILES))

_JITTER_FRAC = 0.02  # boundary jitter, as a fraction of the duration


def chaos_plan(scenario: str, duration_s: float,
               seed: int = 0) -> Optional[FaultPlan]:
    """The deterministic fault schedule for a chaos scenario (None for
    non-chaos scenario names — the fleet replay attaches an injector only
    when this returns a plan)."""
    profile = _PROFILES.get(scenario)
    if profile is None:
        return None
    rng = np.random.default_rng([int(seed) & 0x7FFFFFFF, 0xFA17])
    events: List[FaultEvent] = []
    for kind, f0, f1, params in profile:
        t0 = f0 * duration_s + float(rng.uniform(-1, 1)) * _JITTER_FRAC * duration_s
        t0 = min(max(t0, 0.0), duration_s)
        if not np.isfinite(f1):
            dur = float("inf")
        elif kind == "transient_op":
            dur = 0.0
        else:
            t1 = f1 * duration_s + float(rng.uniform(-1, 1)) * _JITTER_FRAC * duration_s
            dur = max(t1 - t0, 0.05 * duration_s)
        events.append(FaultEvent(kind, t0, dur, dict(params)))
    return FaultPlan(events)
