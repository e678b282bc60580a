"""Fleet-replay metric aggregation (a copy of ``repro.fleet.report``).

Per-device and fleet-level rollups of the replay records: energy per
request (split per cpu/gpu/bus rail), battery drain, SLO attainment and
latency percentiles (p50/p95/p99, linear interpolation — the math is
hand-verified in ``tests/test_fleet.py``). The records themselves are
derived from the device's :class:`~repro_torch.core.telemetry.EnergyLedger`
(``repro_torch.fleet.replay``), so every number here traces to one event stream.
Serializes to/from the ``BENCH_fleet*.json`` schema gated by
``benchmarks/run.py --smoke``.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

PCTS = (50, 95, 99)


def latency_percentiles(latencies: Sequence[float]) -> Dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ...} via linear interpolation."""
    if len(latencies) == 0:
        return {f"p{q}": 0.0 for q in PCTS}
    xs = np.asarray(latencies, np.float64)
    return {f"p{q}": float(np.percentile(xs, q)) for q in PCTS}


@dataclass
class RequestRecord:
    """One replayed request, in simulated seconds. The per-rail energy
    fields carry the ledger's attribution (ground-truth physics on the
    graph path, plan-derived fractions on the serving path); ``energy_j``
    remains the authoritative total."""
    uid: int
    model: str
    priority: int
    t_arrival_s: float
    t_done_s: float
    latency_s: float  # completion - arrival (queueing included)
    energy_j: float
    slo_s: float
    slo_met: bool
    energy_cpu_j: float = 0.0
    energy_gpu_j: float = 0.0
    energy_bus_j: float = 0.0


@dataclass
class DeviceMetrics:
    device: str
    tier: str
    n_requests: int
    energy_j: float
    energy_per_request_j: float
    battery_start_pct: float
    battery_end_pct: float
    battery_drain_pct: float
    slo_attainment: float
    latency_s: Dict[str, float]  # p50/p95/p99
    counters: Dict[str, int] = field(default_factory=dict)
    # per-processor attribution of energy_j (cpu/gpu/bus), folded from the
    # same ledger-derived records as the total
    energy_rails_j: Dict[str, float] = field(default_factory=dict)
    # virtual time (s) at which the device's battery hit 0 mid-replay
    # (None = survived): the fleet-health number behind drained-device SLO
    # loss; ``DeviceSim.battery_dead_t_s`` via the replay harness
    time_to_empty_s: Optional[float] = None

    @classmethod
    def from_records(cls, device: str, tier: str,
                     records: Sequence[RequestRecord],
                     battery_start_pct: float, battery_end_pct: float,
                     counters: Dict[str, int] = None,
                     time_to_empty_s: Optional[float] = None
                     ) -> "DeviceMetrics":
        n = len(records)
        energy = float(sum(r.energy_j for r in records))
        met = sum(1 for r in records if r.slo_met)
        return cls(
            device=device, tier=tier, n_requests=n, energy_j=energy,
            energy_per_request_j=energy / n if n else 0.0,
            battery_start_pct=battery_start_pct,
            battery_end_pct=battery_end_pct,
            battery_drain_pct=battery_start_pct - battery_end_pct,
            slo_attainment=met / n if n else 1.0,
            latency_s=latency_percentiles([r.latency_s for r in records]),
            counters=dict(counters or {}),
            energy_rails_j={
                "cpu": float(sum(r.energy_cpu_j for r in records)),
                "gpu": float(sum(r.energy_gpu_j for r in records)),
                "bus": float(sum(r.energy_bus_j for r in records))},
            time_to_empty_s=time_to_empty_s,
        )


@dataclass
class FleetReport:
    scenario: str
    seed: int
    duration_s: float
    backend: str
    devices: List[DeviceMetrics]
    fleet: Dict[str, object]

    @classmethod
    def build(cls, scenario: str, seed: int, duration_s: float, backend: str,
              devices: List[DeviceMetrics],
              all_latencies: Sequence[float]) -> "FleetReport":
        """Fleet aggregates: totals are request-weighted (energy/request is
        total joules over total requests, SLO attainment is total met over
        total issued), battery drain is a per-device mean (each device owns
        one battery), latency percentiles pool every request."""
        n = sum(d.n_requests for d in devices)
        energy = sum(d.energy_j for d in devices)
        met = sum(d.slo_attainment * d.n_requests for d in devices)
        counters: Dict[str, int] = {}
        for d in devices:
            for k, v in d.counters.items():
                counters[k] = counters.get(k, 0) + v
        tiers: Dict[str, int] = {}
        for d in devices:
            tiers[d.tier] = tiers.get(d.tier, 0) + 1
        rails: Dict[str, float] = {"cpu": 0.0, "gpu": 0.0, "bus": 0.0}
        for d in devices:
            for k, v in (d.energy_rails_j or {}).items():
                rails[k] = rails.get(k, 0.0) + v
        fleet = {
            "n_devices": len(devices),
            "tier_counts": tiers,
            "n_requests": n,
            "energy_j": energy,
            "energy_rails_j": rails,
            "energy_per_request_j": energy / n if n else 0.0,
            "battery_drain_pct_mean": (
                float(np.mean([d.battery_drain_pct for d in devices]))
                if devices else 0.0),
            "slo_attainment": met / n if n else 1.0,
            "latency_s": latency_percentiles(all_latencies),
            "counters": counters,
        }
        # calibrated-interval quality, derived from the uncertainty counters
        # (repro_torch.uncertainty) — absent entirely when no model was attached,
        # keeping point-mode reports bit-identical to the committed baselines
        n_iv = counters.get("interval_observations", 0)
        if n_iv:
            fleet["interval_coverage"] = counters.get(
                "interval_covered", 0) / n_iv
            fleet["interval_width_j_mean"] = (
                counters.get("interval_width_uj", 0) / 1e6) / n_iv
        return cls(scenario, seed, duration_s, backend, devices, fleet)

    def to_dict(self) -> dict:
        return {"scenario": self.scenario, "seed": self.seed,
                "duration_s": self.duration_s, "backend": self.backend,
                "devices": [asdict(d) for d in self.devices],
                "fleet": self.fleet}

    @classmethod
    def from_dict(cls, d: dict) -> "FleetReport":
        return cls(d["scenario"], d["seed"], d["duration_s"], d["backend"],
                   [DeviceMetrics(**dev) for dev in d["devices"]], d["fleet"])

    def write_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)

    @classmethod
    def read_json(cls, path: str) -> "FleetReport":
        with open(path) as f:
            return cls.from_dict(json.load(f))
