"""Per-axis collective cost model for sharded serving: a copy of
``repro.sharding.comm``, stamping the plans of a context whose model axis
holds more than one rank as the reference stamps them (at one shard every
plan is returned unchanged).

AdaOper's thesis — spreading work across processors for speedup does not
automatically buy an energy win — reappears at chip scale: an N-way
tensor-parallel split divides compute latency by ~N but *adds* collective
traffic (two all-reduces of the activations per layer, one after the
attention output projection and one after the MLP down projection) whose
energy is pure overhead. This module prices that traffic so the serving
planner can stamp every plan with a per-axis communication term and the
ledger's bus rail can attribute it (``repro_torch.serving.planning``).

The constants model a chip-to-chip interconnect (ICI), distinct from the
single-device CPU<->GPU staging bus in ``repro_torch.core.simulator``
(``BUS_GBPS`` / ``BUS_PJ_PER_BYTE``): moving a byte between chips is
cheaper per byte than DRAM staging but the payloads are much larger.
Data-parallel axes carry no inference-time collectives (no gradient
sync), so their per-axis bytes are zero — the term exists so the
accounting stays per-axis when more axes start to move data.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# per-chip interconnect link bandwidth and transfer energy; SYNC is the
# per-collective launch/join overhead (ring setup, not bytes)
ICI_GBPS = 25.0
ICI_PJ_PER_BYTE = 45.0
COLLECTIVE_SYNC_S = 5e-6


# bytes per element by dtype name; numpy knows no "bfloat16" without the
# ml_dtypes package, which the JAX package brings and the port does not
_DTYPE_BYTES = {"bfloat16": 2}


def dtype_bytes(cfg) -> int:
    name = getattr(cfg, "dtype", "float32")
    return _DTYPE_BYTES.get(name) or np.dtype(name).itemsize


def allreduce_bytes_per_chip(payload_bytes: float, n: int) -> float:
    """Ring all-reduce: each chip sends (and receives) ``2*(n-1)/n`` of the
    payload — the reduce-scatter half plus the all-gather half."""
    if n <= 1:
        return 0.0
    return 2.0 * (n - 1) / n * float(payload_bytes)


def step_collective_bytes(cfg, batch: int, tokens_per_row: int,
                          n_model: int) -> float:
    """Per-chip bytes moved by one forward pass of ``batch`` rows of
    ``tokens_per_row`` tokens under ``n_model``-way tensor parallelism:
    two all-reduces of the (B, T, d_model) activations per layer."""
    payload = batch * tokens_per_row * cfg.d_model * dtype_bytes(cfg)
    return 2.0 * cfg.num_layers * allreduce_bytes_per_chip(payload, n_model)


def comm_term(cfg, ctx, batch: int, tokens_per_row: int) -> Optional[dict]:
    """The per-axis communication term stamped onto serving plans.

    Returns ``None`` when the context is not model-parallel — the
    single-device / mesh-of-1 path must keep byte-identical plans (the
    bit-exactness reference). Otherwise a dict with the per-chip bytes per
    mesh axis, the collective latency (bytes over ICI bandwidth plus one
    sync per all-reduce) and the fleet-wide transfer energy (every chip
    moves its share concurrently)."""
    n = getattr(ctx, "model_parallel", 1)
    if n <= 1:
        return None
    by = step_collective_bytes(cfg, batch, tokens_per_row, n)
    n_coll = 2 * cfg.num_layers
    per_axis = {str(ctx.model_axis): by}
    for a in getattr(ctx, "batch_axes", ()) or ():
        per_axis.setdefault(str(a), 0.0)  # DP: no inference collectives
    return {
        "n_shards": int(n),
        "per_axis_bytes": per_axis,
        "bytes_per_chip": by,
        "latency_s": by / (ICI_GBPS * 1e9) + n_coll * COLLECTIVE_SYNC_S,
        "energy_j": by * n * ICI_PJ_PER_BYTE * 1e-12,
    }


def shard_plan(plan: dict, term: Optional[dict], energy_key: str,
               latency_key: str) -> dict:
    """Re-price a single-device plan for its tensor-parallel execution.

    Latency: compute time divides by the shard count, then the collective
    term adds back on the critical path. Energy: the compute joules are
    *conserved* (the same flops run, spread over chips) and the collective
    joules add on top — the "speedup != energy win" signal. The plan's
    per-rail fractions are re-weighted so the bus rail carries the
    collective energy. ``term is None`` returns ``plan`` unchanged (the
    same object), keeping the unsharded path bit-identical."""
    if term is None:
        return plan
    out = dict(plan)
    e0, t0 = float(plan[energy_key]), float(plan[latency_key])
    e1 = e0 + term["energy_j"]
    out[latency_key] = t0 / term["n_shards"] + term["latency_s"]
    out[energy_key] = e1
    fr = plan.get("rails")
    if fr is not None and e1 > 0.0:
        s = e0 / e1
        out["rails"] = (fr[0] * s, fr[1] * s,
                        (fr[2] * e0 + term["energy_j"]) / e1)
    out["comm"] = term
    return out
