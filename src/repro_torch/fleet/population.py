"""Heterogeneous device-population sampler (a copy of
``repro.fleet.population``).

Perturbs the Snapdragon-855-flavoured :class:`ProcSpec` silicon, operating
point and volatility around the paper's presets into named device tiers
(flagship / mid / low), the hardware-diversity axis that "Smart at what
cost?" shows dominates real deployments. Each sampled
:class:`DeviceProfile` carries:

  * perturbed CPU/GPU specs (IPC-like throughput, memory bandwidth, clock
    ceiling, dynamic power scaled with die size),
  * a per-device operating point (preset frequencies/background load shifted
    by the tier draw),
  * a battery capacity in joules (drain accounting runs in the simulator),
  * a ``sim_factory`` so a per-device profiler can calibrate against *this*
    device's physics (``RuntimeEnergyProfiler.offline_calibrate``).

Sampling is deterministic in ``(n, seed, mix)``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.simulator import CPU, GPU, PRESETS, DeviceSim, ProcSpec


@dataclass(frozen=True)
class TierSpec:
    """Sampling ranges for one device tier (uniform draws)."""
    name: str
    perf_scale: Tuple[float, float]   # GFLOP/s-per-GHz + mem-BW multiplier
    clock_scale: Tuple[float, float]  # f_nominal/f_max + preset-freq multiplier
    bg_extra: Tuple[float, float]     # extra background utilization (absolute)
    vol_scale: Tuple[float, float]    # DVFS/bg volatility multiplier
    battery_j: Tuple[float, float]    # usable capacity in joules


TIERS: Dict[str, TierSpec] = {
    # ~855-class silicon, big battery, little co-running load
    "flagship": TierSpec("flagship", perf_scale=(0.95, 1.15),
                         clock_scale=(0.95, 1.05), bg_extra=(0.0, 0.05),
                         vol_scale=(0.9, 1.1), battery_j=(55e3, 68e3)),
    # 7-series-class: ~2/3 the throughput, warmer operating point
    "mid": TierSpec("mid", perf_scale=(0.55, 0.80), clock_scale=(0.80, 0.95),
                    bg_extra=(0.03, 0.12), vol_scale=(1.1, 1.5),
                    battery_j=(40e3, 55e3)),
    # entry-level: ~40% throughput, small battery, noisy thermals/governors
    "low": TierSpec("low", perf_scale=(0.30, 0.50), clock_scale=(0.60, 0.80),
                    bg_extra=(0.08, 0.22), vol_scale=(1.5, 2.2),
                    battery_j=(26e3, 40e3)),
}

DEFAULT_MIX = {"flagship": 0.25, "mid": 0.5, "low": 0.25}


def _scale_spec(spec: ProcSpec, perf: float, clock: float) -> ProcSpec:
    """Perturb one processor class: throughput/bandwidth scale with the perf
    draw, the clock range with the clock draw, and dynamic power sub-linearly
    with perf (smaller dies burn less absolute power but more joules/flop —
    the energy-efficiency gap between tiers)."""
    return dataclasses.replace(
        spec,
        gflops_per_ghz=spec.gflops_per_ghz * perf,
        mem_bw_gbps=spec.mem_bw_gbps * (0.5 + 0.5 * perf),
        p_dyn_w_at_nominal=spec.p_dyn_w_at_nominal * perf ** 0.6,
        f_nominal_ghz=spec.f_nominal_ghz * clock,
        f_max_ghz=spec.f_max_ghz * clock,
        f_min_ghz=spec.f_min_ghz * min(clock, 1.0),
    )


@dataclass(frozen=True)
class DeviceProfile:
    name: str
    tier: str
    seed: int
    cpu_spec: ProcSpec
    gpu_spec: ProcSpec
    clock_scale: float
    bg_extra: float
    vol_scale: float
    battery_capacity_j: float
    base_preset: str = "moderate"

    def _preset_params(self, preset: str) -> dict:
        """This device's operating point for a named workload preset."""
        p = dict(PRESETS[preset])
        p["cpu_f"] *= self.clock_scale
        p["gpu_f"] *= self.clock_scale
        p["cpu_bg"] = min(0.99, p["cpu_bg"] + self.bg_extra)
        p["gpu_bg"] = min(0.95, p["gpu_bg"] + 0.5 * self.bg_extra)
        p["vol"] = p["vol"] * self.vol_scale
        return p

    def make_sim(self, seed: Optional[int] = None,
                 preset: Optional[str] = None,
                 battery: bool = True) -> DeviceSim:
        preset = preset or self.base_preset
        return DeviceSim(
            preset, seed=self.seed if seed is None else seed,
            cpu_spec=self.cpu_spec, gpu_spec=self.gpu_spec,
            preset_params=self._preset_params(preset),
            battery_capacity_j=self.battery_capacity_j if battery else None)

    def sim_factory(self):
        """``(preset, seed) -> DeviceSim`` for profiler calibration: sweeps
        the stock preset names but always on THIS device's silicon and
        operating-point shifts (no battery — calibration is free)."""
        def make(preset: str, seed: int) -> DeviceSim:
            return self.make_sim(seed=seed, preset=preset, battery=False)
        return make

    def describe(self) -> dict:
        return {"name": self.name, "tier": self.tier,
                "cpu_gflops_per_ghz": self.cpu_spec.gflops_per_ghz,
                "gpu_gflops_per_ghz": self.gpu_spec.gflops_per_ghz,
                "clock_scale": self.clock_scale, "bg_extra": self.bg_extra,
                "battery_capacity_j": self.battery_capacity_j}


def sample_device(tier: str, rng: np.random.Generator, name: str,
                  seed: int) -> DeviceProfile:
    t = TIERS[tier]
    perf = float(rng.uniform(*t.perf_scale))
    clock = float(rng.uniform(*t.clock_scale))
    return DeviceProfile(
        name=name, tier=tier, seed=seed,
        cpu_spec=_scale_spec(CPU, perf, clock),
        gpu_spec=_scale_spec(GPU, perf, clock),
        clock_scale=clock,
        bg_extra=float(rng.uniform(*t.bg_extra)),
        vol_scale=float(rng.uniform(*t.vol_scale)),
        battery_capacity_j=float(rng.uniform(*t.battery_j)),
    )


def sample_population(n: int, seed: int = 0,
                      mix: Optional[Dict[str, float]] = None
                      ) -> List[DeviceProfile]:
    """Sample ``n`` devices with tier proportions ``mix`` (largest-remainder
    apportionment, so the tier counts are stable in ``n`` — no lucky draws)."""
    if n <= 0:
        raise ValueError(f"population size must be positive, got {n}")
    mix = dict(mix or DEFAULT_MIX)
    total = sum(mix.values())
    tiers = sorted(mix)  # stable order regardless of dict insertion
    exact = {t: n * mix[t] / total for t in tiers}
    counts = {t: int(exact[t]) for t in tiers}
    for t in sorted(tiers, key=lambda t: exact[t] - counts[t], reverse=True):
        if sum(counts.values()) >= n:
            break
        counts[t] += 1
    rng = np.random.default_rng(seed)
    out: List[DeviceProfile] = []
    for tier in tiers:
        for _ in range(counts[tier]):
            i = len(out)
            out.append(sample_device(tier, rng, f"{tier}-{i:02d}",
                                     seed=int(rng.integers(1 << 30))))
    return out
