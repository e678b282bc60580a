"""Device-dynamics + energy ground-truth simulator (a copy of
``repro.core.simulator``; the fault injector that drives its fault hooks
waits, see ROADMAP.md).

Stands in for the phone's power rails (the paper instruments a Xiaomi 9 /
Snapdragon 855): two heterogeneous processor classes (CPU big-cluster, GPU)
with DVFS frequency walks, background-utilization bursts, a shared transfer
bus, and a cubic-in-frequency dynamic-power model. The profiler *learns*
this ground truth from noisy observations; the partitioner never sees the
true state — exactly the paper's measurement/feedback structure.

Workload presets mirror the paper's Fig. 2 conditions:
  moderate — CPU 1.49 GHz, GPU 499 MHz, CPU bg util 78.8%
  high     — CPU 0.88 GHz, GPU 427 MHz, CPU bg util 91.3%
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.opgraph import OpGraph, OpNode
from repro_torch.core.telemetry import EnergyBreakdown, EnergyLedger
from repro_torch.faults.errors import ProcessorFault, TransientOpFault


@dataclass(frozen=True)
class ProcSpec:
    name: str
    gflops_per_ghz: float  # effective GFLOP/s per GHz of clock
    mem_bw_gbps: float
    p_idle_w: float
    p_dyn_w_at_nominal: float  # dynamic power at nominal freq, full util
    f_nominal_ghz: float
    f_min_ghz: float
    f_max_ghz: float


# Snapdragon-855-flavoured constants (big cluster vs Adreno 640).
# Effective (not peak) throughputs: Adreno 640 ~350 GFLOP/s of real conv
# throughput at 585 MHz; big cluster ~65 GFLOP/s at 2.2 GHz — a ~5x ratio,
# which is what makes CoDL-style co-execution profitable at idle (~20%
# speedup) yet energy-negative (CPU joules/flop is ~3x the GPU's).
CPU = ProcSpec("cpu", gflops_per_ghz=30.0, mem_bw_gbps=14.0, p_idle_w=0.45,
               p_dyn_w_at_nominal=3.2, f_nominal_ghz=2.84, f_min_ghz=0.3, f_max_ghz=2.84)
GPU = ProcSpec("gpu", gflops_per_ghz=600.0, mem_bw_gbps=28.0, p_idle_w=0.25,
               p_dyn_w_at_nominal=2.1, f_nominal_ghz=0.585, f_min_ghz=0.25, f_max_ghz=0.675)

BUS_GBPS = 9.0  # CPU<->GPU staging via shared DRAM (CoDL's data-transform cost)
BUS_PJ_PER_BYTE = 110.0
SYNC_OVERHEAD_S = 10e-6  # co-execution join overhead per op

# ----- contention constants (named so repro.core.coexec seeds its
# contention-aware cost model from the same numbers the physics uses;
# values unchanged — every use below is bit-identical to the literals) -----
COEXEC_BG_PER_RUNNER = 0.05   # extra cpu/gpu background util per co-runner
BG_AVAIL_SLOPE = 0.35         # throughput stolen per unit background util
COEXEC_THERM_PER_RUNNER = 0.06  # thermal-target lift per co-runner
THERM_LAT_SLOPE = 0.20        # latency inflation per unit thermal state
THERM_EN_SLOPE = 0.35         # energy inflation per unit thermal state

PRESETS = {
    # (cpu_f, gpu_f, cpu_bg_util, gpu_bg_util, volatility)
    "moderate": dict(cpu_f=1.49, gpu_f=0.499, cpu_bg=0.788, gpu_bg=0.10, vol=0.03),
    "high": dict(cpu_f=0.88, gpu_f=0.427, cpu_bg=0.913, gpu_bg=0.25, vol=0.08),
    "idle": dict(cpu_f=2.2, gpu_f=0.585, cpu_bg=0.10, gpu_bg=0.02, vol=0.02),
}


@dataclass
class DeviceState:
    cpu_f: float
    gpu_f: float
    cpu_bg: float
    gpu_bg: float

    def as_features(self) -> np.ndarray:
        return np.array([self.cpu_f, self.gpu_f, self.cpu_bg, self.gpu_bg], np.float64)


class DeviceSim:
    """Two-class device with Ornstein-Uhlenbeck DVFS walk + bursty bg load.

    The processor silicon is per-instance (``cpu_spec`` / ``gpu_spec``) so a
    fleet population can perturb clocks, throughput and power around the
    Snapdragon-855 defaults (``repro_torch.fleet.population``); ``preset_params``
    overrides entries of the named preset's operating point. An optional
    battery (``battery_capacity_j``) turns the simulator into a drain
    accountant: callers (the fleet replay harness, ``advance_idle``) charge
    it with ``drain``.
    """

    def __init__(self, preset: str = "moderate", seed: int = 0,
                 cpu_spec: ProcSpec = CPU, gpu_spec: ProcSpec = GPU,
                 preset_params: dict = None,
                 battery_capacity_j: float = None):
        self.cpu_spec = cpu_spec
        self.gpu_spec = gpu_spec
        self.spec = {"cpu": cpu_spec, "gpu": gpu_spec}
        self.preset = dict(PRESETS[preset])
        if preset_params:
            self.preset.update(preset_params)
        self.battery_capacity_j = battery_capacity_j
        # `is not None`: a 0-joule battery is a dead battery, not "no battery"
        self.battery_j = (float(battery_capacity_j)
                          if battery_capacity_j is not None else None)
        self.rng = np.random.default_rng(seed)
        # the device's telemetry spine: the controller and serving engine
        # append StepEvents here; fleet reports and benchmarks fold it
        self.ledger = EnergyLedger()
        p = self.preset
        self.state = DeviceState(p["cpu_f"], p["gpu_f"], p["cpu_bg"], p["gpu_bg"])
        self._burst = 0.0
        # LATENT thermal state in [0,1]: rises under sustained activity,
        # cools when idle. Deliberately NOT exposed through observe() — the
        # resource monitor can't see it (no die-temperature rail), so the
        # offline GBDT cannot model it. Tracking its effect from energy
        # feedback is exactly the GRU's job (paper Challenge #1).
        self._therm = 0.2
        self._recent_active = 0.0
        # number of co-running model workers sharing the device. 1 = the
        # single-task setting (unchanged physics); >1 models the serving
        # engine's concurrent pools: the staging bus is time-shared and the
        # co-runners show up as extra background load + heat.
        self.coexec = 1
        # ----- fault-injection state (repro.faults). All defaults are
        # inert: with no injector attached, every code path below is
        # bit-identical to the pre-fault simulator (no extra RNG draws, no
        # arithmetic changes) — asserted by the baseline gates. -----
        self.faults = None  # attached FaultInjector, if any
        self.fault_epoch = 0  # bumps on every fault/recovery transition
        self.faulted_rails: frozenset = frozenset()  # {"cpu","gpu"} subsets
        self.freq_cap = None  # (cpu_ghz, gpu_ghz) hard throttle cap
        self.lat_inflation = 1.0  # mem-pressure latency multiplier
        self.battery_critical = False  # serving engine sheds low-priority
        self.transient_fails = 0  # armed one-shot per-op failures
        self.battery_dead = False
        self.battery_dead_t_s = None  # virtual time-of-death, if it died
        self.now_s = 0.0  # last virtual timestamp seen (replay drivers set)

    def set_coexec(self, n: int) -> None:
        """Declare ``n`` concurrently-active model workers (>=1)."""
        self.coexec = max(1, int(n))

    # ----- battery accounting (fleet-replay hook) -----
    @property
    def battery_pct(self) -> float:
        """Remaining battery in percent (100.0 when no battery is attached)."""
        if self.battery_j is None:
            return 100.0
        if self.battery_capacity_j <= 0.0:
            return 0.0
        return 100.0 * self.battery_j / self.battery_capacity_j

    def drain(self, energy_j: float) -> None:
        """Charge ``energy_j`` joules against the battery (no-op without
        one). The battery clamps at 0 and flips ``battery_dead`` — a dead
        device keeps simulating (the replay reports time-to-empty) but the
        serving engine treats it as permanently ``battery_critical``."""
        if self.battery_j is None:
            return
        self.battery_j = max(0.0, self.battery_j - float(energy_j))
        if self.battery_j <= 0.0 and not self.battery_dead:
            self.battery_dead = True
            self.battery_critical = True
            self.battery_dead_t_s = self.now_s
            self.ledger.count("battery_dead")
            self.ledger.emit("battery_dead", 0.0, EnergyBreakdown(),
                             t_s=self.now_s)

    def idle_power_w(self) -> float:
        """Leakage floor with both processor classes idle."""
        return self.cpu_spec.p_idle_w + self.gpu_spec.p_idle_w

    # ----- fault hooks (repro.faults) -----
    def advance_faults(self, t_s: float) -> int:
        """Move the virtual clock to ``t_s`` and let an attached
        :class:`~repro.faults.injector.FaultInjector` apply every scheduled
        fault/recovery boundary crossed. Returns the number of transitions
        (0, trivially, with no injector attached)."""
        self.now_s = float(t_s)
        if self.faults is None:
            return 0
        return self.faults.advance_to(self.now_s)

    def advance_idle(self, dt_s: float, max_steps: int = 20) -> None:
        """Idle the device for ``dt_s``: dynamics relax toward the preset
        (``active=0``), the die cools, and the leakage floor drains the
        battery. Long gaps are walked in at most ``max_steps`` chunks so a
        multi-second lull costs O(1) rather than O(dt/50ms) RNG draws."""
        if dt_s <= 0.0:
            return
        self.drain(self.idle_power_w() * dt_s)
        self.ledger.emit("idle", dt_s, EnergyBreakdown(
            cpu_j=self.cpu_spec.p_idle_w * dt_s,
            gpu_j=self.gpu_spec.p_idle_w * dt_s,
            total_j=self.idle_power_w() * dt_s))
        n = min(max_steps, max(1, int(round(dt_s / 0.05))))
        for _ in range(n):
            self.step(dt_s / n, active=0.0)

    # ----- dynamics -----
    def step(self, dt_s: float = 0.05, active: float = 1.0):
        p, s, r = self.preset, self.state, self.rng
        vol = p["vol"]
        # thermal integrator: sustained activity + bg load heat the die;
        # co-running workers keep more silicon hot
        target = min(1.0, 0.25 + 0.5 * active + 0.4 * s.cpu_bg
                     + COEXEC_THERM_PER_RUNNER * (self.coexec - 1))
        self._therm += 0.08 * (target - self._therm) + 0.01 * r.normal()
        self._therm = float(np.clip(self._therm, 0.0, 1.0))
        # OU pull toward preset mean + noise; clamp to spec range
        s.cpu_f += 0.2 * (p["cpu_f"] - s.cpu_f) + vol * r.normal() * 0.3
        s.gpu_f += 0.2 * (p["gpu_f"] - s.gpu_f) + vol * r.normal() * 0.08
        s.cpu_f = float(np.clip(s.cpu_f, self.cpu_spec.f_min_ghz, self.cpu_spec.f_max_ghz))
        s.gpu_f = float(np.clip(s.gpu_f, self.gpu_spec.f_min_ghz, self.gpu_spec.f_max_ghz))
        # injected thermal-throttle spike: a hard governor ceiling on top of
        # the spec clamp (inert when no throttle window is active)
        if self.freq_cap is not None:
            s.cpu_f = min(s.cpu_f, self.freq_cap[0])
            s.gpu_f = min(s.gpu_f, self.freq_cap[1])
        # bursty background load (2-state markov modulated). Bursts land
        # mostly on the CPU — that's where co-running app threads live.
        if r.random() < 0.10:
            self._burst = r.uniform(0.1, 0.6) if self._burst == 0.0 else 0.0
        s.cpu_bg = float(np.clip(p["cpu_bg"] + self._burst * (1 - p["cpu_bg"]) + vol * r.normal(), 0.0, 0.99))
        s.gpu_bg = float(np.clip(p["gpu_bg"] + self._burst * 0.25 + vol * r.normal() * 0.5, 0.0, 0.95))

    def observe(self, noise: bool = True) -> DeviceState:
        s = self.state
        if not noise:
            return dataclasses.replace(s)
        r = self.rng
        return DeviceState(
            cpu_f=s.cpu_f * (1 + 0.01 * r.normal()),
            gpu_f=s.gpu_f * (1 + 0.01 * r.normal()),
            cpu_bg=float(np.clip(s.cpu_bg + 0.03 * r.normal(), 0, 1)),
            gpu_bg=float(np.clip(s.gpu_bg + 0.03 * r.normal(), 0, 1)),
        )

    # ----- ground-truth physics -----
    def _class_time(self, spec: ProcSpec, f: float, bg: float, flops: float, bytes_: float) -> float:
        # Background load steals throughput sub-linearly: the DL threads run
        # at elevated priority on the big cores, so 90% average utilization
        # costs ~x2, not x10 (scheduler model, calibrated vs CoDL's report).
        avail = max(0.05, 1.0 - BG_AVAIL_SLOPE * bg)
        t_compute = flops / (spec.gflops_per_ghz * f * 1e9 * avail)
        t_mem = bytes_ / (spec.mem_bw_gbps * 1e9 * (0.5 + 0.5 * avail))
        return max(t_compute, t_mem)

    def _power(self, spec: ProcSpec, f: float, util: float) -> float:
        # P_dyn ~ f * V^2, with the DVFS voltage floored at ~67% of nominal
        # (real governors can't scale V below V_min, so low-frequency power
        # is linear in f, not cubic — without this floor co-execution looks
        # energy-free at low clocks, which contradicts measurement)
        fr = f / spec.f_nominal_ghz
        v2 = max(0.67, fr) ** 2
        return spec.p_idle_w + spec.p_dyn_w_at_nominal * fr * v2 * util

    def exec_op(self, op: OpNode, alpha: float, prev_alpha: float,
                state: DeviceState = None) -> Tuple[float, float]:
        """Execute op with fraction ``alpha`` on GPU, ``1-alpha`` on CPU.
        Returns (latency_s, energy_j) under the (true) device state."""
        lat, eb = self.exec_op_rails(op, alpha, prev_alpha, state)
        return lat, eb.total_j

    def exec_op_rails(self, op: OpNode, alpha: float, prev_alpha: float,
                      state: DeviceState = None, attribution: bool = False
                      ) -> Tuple[float, EnergyBreakdown]:
        """``exec_op`` with the energy attributed per power rail (CPU class,
        GPU class, transfer bus). ``total_j`` is computed in the historical
        summation order, so it is bit-identical to what ``exec_op`` always
        returned; the rails sum to it up to float associativity (asserted in
        ``tests/test_telemetry.py``). Pure in the device dynamics: no RNG
        draw, no state mutation — callers computing attribution only (not
        executing) pass ``attribution=True`` so injected faults neither
        fire nor drain their one-shot budgets.

        Raises :class:`~repro.faults.errors.ProcessorFault` when any op
        fraction lands on a faulted rail, and
        :class:`~repro.faults.errors.TransientOpFault` while the injector's
        armed transient-failure budget drains (execution paths only)."""
        if not attribution and (self.faulted_rails or self.transient_fails):
            if alpha > 0.0 and "gpu" in self.faulted_rails:
                raise ProcessorFault(
                    f"op {op.name!r}: alpha={alpha:g} dispatched onto "
                    "faulted gpu rail")
            if alpha < 1.0 and "cpu" in self.faulted_rails:
                raise ProcessorFault(
                    f"op {op.name!r}: alpha={alpha:g} leaves "
                    f"{1.0 - alpha:g} on faulted cpu rail")
            if self.transient_fails > 0:
                self.transient_fails -= 1
                raise TransientOpFault(
                    f"op {op.name!r}: transient execution failure "
                    f"({self.transient_fails} armed failures remain)")
        s = state or self.state
        # concurrent model workers: co-runners act as extra background load on
        # both processor classes, and the CPU<->GPU staging bus is time-shared
        cx = self.coexec
        cpu_bg = min(0.99, s.cpu_bg + COEXEC_BG_PER_RUNNER * (cx - 1))
        gpu_bg = min(0.95, s.gpu_bg + COEXEC_BG_PER_RUNNER * (cx - 1))
        cpu_spec, gpu_spec = self.cpu_spec, self.gpu_spec
        bytes_a = alpha * (op.bytes_in + op.bytes_out + op.weight_bytes)
        bytes_b = (1 - alpha) * (op.bytes_in + op.bytes_out + op.weight_bytes)
        t_gpu = self._class_time(gpu_spec, s.gpu_f, gpu_bg, alpha * op.flops, bytes_a) if alpha > 0 else 0.0
        t_cpu = self._class_time(cpu_spec, s.cpu_f, cpu_bg, (1 - alpha) * op.flops, bytes_b) if alpha < 1 else 0.0
        split = 0.0 < alpha < 1.0
        # boundary traffic: repartition between consecutive ops + co-exec halo
        move = abs(alpha - prev_alpha) * op.bytes_in + (op.comm_bytes_if_split * 0.5 if split else 0.0)
        t_bus = move / (BUS_GBPS * 1e9 / cx)
        lat = max(t_gpu, t_cpu) + t_bus + (SYNC_OVERHEAD_S if split else 0.0)
        if alpha > 0:
            e_gpu = t_gpu * self._power(gpu_spec, s.gpu_f, 1.0) + (lat - t_gpu) * gpu_spec.p_idle_w
        else:
            e_gpu = lat * gpu_spec.p_idle_w
        if alpha < 1:
            e_cpu = t_cpu * self._power(cpu_spec, s.cpu_f, 1.0) + (lat - t_cpu) * cpu_spec.p_idle_w
        else:
            e_cpu = lat * cpu_spec.p_idle_w
        e_bus = move * BUS_PJ_PER_BYTE * 1e-12
        # latent thermal effect: leakage power and throttling grow with die
        # temperature; invisible to the monitor (see __init__)
        k = 1.0 + THERM_EN_SLOPE * self._therm
        lat *= 1.0 + THERM_LAT_SLOPE * self._therm
        # injected memory pressure inflates latency, invisibly to the
        # monitor (like the thermal state). Guarded so the arithmetic is
        # untouched — bit-identical — when no mem_pressure window is active.
        if self.lat_inflation != 1.0:
            lat *= self.lat_inflation
        # total in the pre-refactor order ((gpu + cpu) + bus) * k: bit-equal
        # to the scalar exec_op of every previous revision
        return lat, EnergyBreakdown(cpu_j=e_cpu * k, gpu_j=e_gpu * k,
                                    bus_j=e_bus * k,
                                    total_j=((0.0 + e_gpu) + e_cpu + e_bus) * k)

    def rail_fractions(self, graph: OpGraph, plan,
                       state: DeviceState = None
                       ) -> Optional[Tuple[float, float, float]]:
        """(cpu, gpu, bus) energy shares of executing ``graph`` under
        ``plan``, evaluated against the current (or given) true state
        without advancing the dynamics — the attribution key the scheduler
        stamps on every partition plan so *predicted* energies can be split
        per rail in the ledger."""
        s = state or self.state
        eb = EnergyBreakdown()
        prev = plan[0] if len(plan) else 1.0
        for op, a in zip(graph.nodes, plan):
            _, e = self.exec_op_rails(op, float(a), float(prev), s,
                                      attribution=True)
            eb += e
            prev = a
        return eb.fractions()

    def exec_graph(self, graph: OpGraph, plan, state: DeviceState = None,
                   advance: bool = False) -> Tuple[float, float]:
        """plan: sequence of alphas, one per node. Returns (latency, energy)."""
        lat = en = 0.0
        prev = plan[0] if len(plan) else 1.0
        for op, a in zip(graph.nodes, plan):
            l, e = self.exec_op(op, float(a), float(prev), state)
            lat += l
            en += e
            prev = a
            if advance:
                self.step(l)
        return lat, en
