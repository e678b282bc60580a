"""Baselines from the paper's Fig. 2 (a copy of ``repro.core.baselines``).

* MACE-GPU  — everything on the single fastest processor (no partitioning).
* CoDL-like — per-operator *latency*-optimal CPU+GPU co-execution, planned
  with an OFFLINE-calibrated cost model at nominal device state (CoDL's
  predictors are calibrated per-device ahead of time and do not track
  runtime load/DVFS — the gap AdaOper exploits).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.opgraph import OpGraph
from repro_torch.core.partitioner import PartitionPlan, dp_partition
from repro_torch.core.simulator import PRESETS, DeviceSim, DeviceState


def mace_gpu_plan(graph: OpGraph) -> PartitionPlan:
    alphas = np.ones(len(graph))
    return PartitionPlan(alphas, 0.0, 0.0)


def codl_plan(graph: OpGraph, obs_state: DeviceState = None,
              calibration_preset: str = "idle") -> PartitionPlan:
    """Latency-optimal DP under CoDL's offline-calibrated cost model.

    CoDL's per-platform predictors are frequency-aware (they read the DVFS
    state) but calibrated on an otherwise-idle device — they are blind to
    co-running background load, which is exactly the gap AdaOper's runtime
    profiler closes."""
    p = PRESETS[calibration_preset]
    assumed = DeviceState(
        cpu_f=obs_state.cpu_f if obs_state else p["cpu_f"],
        gpu_f=obs_state.gpu_f if obs_state else p["gpu_f"],
        cpu_bg=p["cpu_bg"], gpu_bg=p["gpu_bg"])
    sim = DeviceSim(calibration_preset, seed=0)

    def offline_cost(op, a, prev):
        return sim.exec_op(op, a, prev, state=assumed)

    return dp_partition(graph, offline_cost, objective="latency")
