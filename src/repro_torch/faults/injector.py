"""Drives a :class:`~repro_torch.faults.plan.FaultPlan` against a live device
(a copy of ``repro.faults.injector``).

The injector owns a cursor into the plan's time-sorted boundary list; replay
drivers call :meth:`FaultInjector.advance_to` with the virtual clock before
each unit of work (``AdaOperController.run_trace``, ``ServingEngine``'s
continuous-batching loop, the fleet replay's merged timeline) and the
injector applies/clears every boundary crossed since the last call. All
mutation happens through a handful of *inert-by-default* fields on
``DeviceSim`` (``faulted_rails``, ``freq_cap``, ``lat_inflation``,
``battery_critical``, ``transient_fails``) — with no injector attached those
fields sit at their neutral values and every simulator code path is
bit-identical to the pre-fault stack.

Every transition is audited: a ``"fault"`` / ``"recovery"`` StepEvent (zero
energy, the fault kind + params in ``meta``) lands in the device's
``EnergyLedger``, and the ``faults`` / ``recoveries`` counters move in
lockstep — fleet reports reconcile the two (``tests/test_faults.py``).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

from repro_torch.core.telemetry import EnergyBreakdown
from repro_torch.faults.plan import FaultEvent, FaultPlan

# NOTE: deliberately no import of repro_torch.core.simulator — the simulator
# imports repro.faults.errors (which triggers this package's __init__), so
# an eager simulator import here would be a runtime circular import. The
# injector only needs the sim's fault fields, duck-typed.


class FaultInjector:
    """Applies a plan's fault windows to ``sim`` as virtual time advances."""

    def __init__(self, sim, plan: FaultPlan):
        self.sim = sim
        self.plan = plan
        self._boundaries: List[Tuple[float, int, str, FaultEvent]] = plan.boundaries()
        self._cursor = 0
        self._active: List[FaultEvent] = []
        sim.faults = self

    # ------------------------------------------------------------------
    @property
    def active(self) -> Tuple[FaultEvent, ...]:
        return tuple(self._active)

    def done(self) -> bool:
        return self._cursor >= len(self._boundaries)

    def advance_to(self, t_s: float) -> int:
        """Process every boundary with time <= ``t_s`` (small epsilon for
        float drift on the virtual clock). Returns the number of transitions
        applied — callers can use a nonzero return as a replan trigger,
        though the fault-epoch bump on ``sim`` already invalidates every
        plan cache."""
        n = 0
        eps = 1e-12
        while self._cursor < len(self._boundaries):
            t, _, action, ev = self._boundaries[self._cursor]
            if t > t_s + eps:
                break
            self._cursor += 1
            if action == "apply":
                self._apply(ev, t)
            else:
                self._clear(ev, t)
            n += 1
        return n

    # ------------------------------------------------------------------
    def _apply(self, ev: FaultEvent, t_s: float) -> None:
        if ev.kind == "transient_op":
            # arms a one-shot failure budget rather than opening a window;
            # the matching "recovery" event is emitted by the retry path
            # when the failed op re-executes successfully.
            self.sim.transient_fails += int(ev.params.get("count", 1))
        else:
            self._active.append(ev)
        self.sim.fault_epoch += 1
        self._refresh()
        self.sim.ledger.count("faults")
        self.sim.ledger.emit("fault", 0.0, EnergyBreakdown(), t_s=t_s,
                             meta={"fault": ev.kind, "params": dict(ev.params)})

    def _clear(self, ev: FaultEvent, t_s: float) -> None:
        self._active.remove(ev)
        self.sim.fault_epoch += 1
        self._refresh()
        self.sim.ledger.count("recoveries")
        self.sim.ledger.emit("recovery", 0.0, EnergyBreakdown(), t_s=t_s,
                             meta={"fault": ev.kind, "params": dict(ev.params)})

    def _refresh(self) -> None:
        """Recompute the sim's derived fault state from the active set (so
        overlapping windows compose: rails union, caps take the min, latency
        inflations multiply)."""
        sim = self.sim
        rails = set()
        cap_scale: Optional[float] = None
        inflation = 1.0
        battery_critical = False
        for ev in self._active:
            if ev.kind == "gpu_dropout":
                rails.add("gpu")
            elif ev.kind == "cpu_dropout":
                rails.add("cpu")
            elif ev.kind == "thermal_throttle":
                s = float(ev.params.get("scale", 0.5))
                cap_scale = s if cap_scale is None else min(cap_scale, s)
            elif ev.kind == "mem_pressure":
                inflation *= float(ev.params.get("inflation", 1.5))
            elif ev.kind == "battery_critical":
                battery_critical = True
        sim.faulted_rails = frozenset(rails)
        sim.lat_inflation = inflation
        sim.battery_critical = battery_critical
        if cap_scale is None:
            sim.freq_cap = None
        else:
            # cap relative to the preset operating point (the governor's
            # thermal ceiling), floored at the silicon's minimum clock
            sim.freq_cap = (
                max(sim.cpu_spec.f_min_ghz, cap_scale * sim.preset["cpu_f"]),
                max(sim.gpu_spec.f_min_ghz, cap_scale * sim.preset["gpu_f"]),
            )
            # clamp the live state immediately — a throttle event takes
            # effect now, not at the next OU step
            st = sim.state
            st.cpu_f = min(st.cpu_f, sim.freq_cap[0])
            st.gpu_f = min(st.gpu_f, sim.freq_cap[1])
