"""Logical-axis sharding rules: the counterpart of
``repro.sharding.partition_specs``, the same rule table and the same
decisions, with the placement of a leaf written as a tuple instead of a
``PartitionSpec``: one entry per dim, each a mesh-axis name, a tuple of
names, or ``None`` (the dim stays whole on every device).

MaxText-style rules keyed on parameter path + shape:
  * output-projection dims (q/kv/gate/up, vocab) -> 'model'
  * input-projection dims (wo, w_down first dim)  -> 'model'
  * remaining large dims optionally FSDP-sharded along the batch axes
    (on by default for models >= ``FSDP_THRESHOLD`` params — kimi-k2's 2 TB
    of bf16 weights *must* spread over all chips)
  * experts -> 'model' (expert parallelism); expert F dim FSDP-sharded
  * dims not divisible by the mesh axis are REPLICATED, never padded.

Activation / cache rules:
  * batch -> ('pod','data') when divisible, else KV-sequence -> 'data'
  * kv heads -> 'model' when divisible, else KV-sequence -> 'model'
    (flash-decode style partial softmax)

Replication is a *decision*, not a silent default: every dim that wanted a
mesh axis but was not divisible by it is recorded on the caller's
:class:`ShardingReport` and logged (serving workers keep the report as
``worker.shard_report``).

The trees are flat dicts keyed by the JAX package's '/'-joined paths
(``stages/0/l0/attn/wq`` ...) with the JAX layout's shapes, stage leaves
stacked on a leading repeats dim (``sharding.placement.jax_shapes`` gives
them for a config from the port's modules, allocating nothing). The mesh is
read only as a mapping of axis name to size (``context.axis_sizes``): a
torch ``DeviceMesh`` or a stand-in.
"""
from __future__ import annotations

import logging
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.sharding.context import axis_sizes

_log = logging.getLogger(__name__)

FSDP_THRESHOLD = 8e9  # params

Spec = Tuple  # one entry per dim: an axis name, a tuple of names, or None


@dataclass
class ShardingReport:
    """Tally of sharding decisions for one params/cache tree.

    ``sharded`` counts (leaf, dim) pairs that took a mesh axis;
    ``replicated`` counts pairs that *wanted* one but were not divisible by
    it (``events`` keeps ``(path, dim, size, axis)`` for each). Dims no
    rule ever targets are not decisions and are not counted."""
    sharded: int = 0
    replicated: int = 0
    events: List[Tuple[str, int, int, str]] = field(default_factory=list)

    def record(self, path: str, dim: int, size: int, axis, ok: bool) -> None:
        if ok:
            self.sharded += 1
        else:
            self.replicated += 1
            self.events.append((path, dim, int(size),
                                "+".join(axis) if isinstance(axis, tuple) else str(axis)))

    def log_summary(self, label: str) -> None:
        if self.replicated:
            sample = "; ".join(f"{p}[dim {d}]={n} !% {a}" for p, d, n, a in self.events[:4])
            _log.info("%s: %d dims sharded, %d replicated (not divisible by their mesh axis): "
                      "%s%s", label, self.sharded, self.replicated, sample,
                      " ..." if len(self.events) > 4 else "")
        else:
            _log.debug("%s: %d dims sharded, 0 replicated", label, self.sharded)


def _axis_size(mesh, axis) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in (axis if isinstance(axis, tuple) else (axis,))]))


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The shape of one device's piece of a leaf of ``shape`` placed by
    ``spec``: each dim divided by the size of the axes it names (the shape
    that ``jax.device_put`` gives each device's buffer)."""
    return tuple(n if a is None else n // _axis_size(mesh, a) for n, a in zip(shape, spec))


def _div(n, mesh, axis) -> bool:
    return axis is not None and n % _axis_size(mesh, axis) == 0


def _maybe(n, mesh, axis, report=None, path="", dim=0):
    """The one replication point: ``axis`` when ``n`` divides the mesh axis
    product, else ``None`` (replicate) — recorded on ``report``."""
    if axis is None:
        return None
    ok = _div(n, mesh, axis)
    if report is not None:
        report.record(path, dim, n, axis, ok)
    return axis if ok else None


def param_spec(path: str, shape: Tuple[int, ...], mesh, model_axis="model",
               fsdp_axes=None, report=None) -> Spec:
    """Rule table. ``path`` is the '/'-joined JAX tree path, ``shape`` the
    leaf's shape without the stacked repeats dim."""
    m = model_axis
    f = fsdp_axes
    nd = len(shape)
    if nd == 0:
        return ()
    leaf = path.split("/")[-1]

    def mb(dim, axis):
        return _maybe(shape[dim], mesh, axis, report, path, dim)

    if leaf in ("embedding", "lm_head"):
        if leaf == "embedding":  # (V, D)
            return (mb(0, m), mb(1, f))
        return (mb(0, f), mb(1, m))  # (D, V)
    if leaf in ("wq", "wk", "wv", "w_gate", "w_up", "wi") and nd == 2:
        return (mb(0, f), mb(1, m))
    if leaf in ("wo", "w_down", "out_proj") and nd == 2:
        return (mb(0, m), mb(1, f))
    if leaf == "w_dkv":  # (D, lr+rope)
        return (mb(0, f), None)
    if leaf == "w_ukv":  # (lr, H, nope+vd)
        return (None, mb(1, m), None)
    if leaf == "router":
        return (None, None)
    if "mlp" in path and nd == 3:  # moe experts (E,D,F)/(E,F,D)
        if leaf in ("w_gate", "w_up"):
            return (mb(0, m), None, mb(2, f))
        if leaf == "w_down":
            return (mb(0, m), mb(1, f), None)
    if leaf in ("in_proj", "x_proj", "dt_proj") and nd == 2:  # ssm projections
        return (mb(0, f), mb(1, m))
    if leaf == "conv_w":
        return (mb(0, m), None)
    if nd >= 2 and min(shape[-2:]) >= 1024:  # misc large matrices: fsdp
        return tuple([None] * (nd - 2) + [mb(nd - 2, f), None])
    return tuple([None] * nd)


def fsdp_default(cfg) -> bool:
    """FSDP on by default for models past the bf16-bytes threshold."""
    return cfg.param_count() * 2 >= FSDP_THRESHOLD


def params_shardings(shapes: Dict[str, Tuple[int, ...]], cfg, mesh, model_axis="model",
                     batch_axes=("data",), fsdp: bool = None,
                     report: ShardingReport = None) -> Dict[str, Spec]:
    """path -> placement for every leaf of ``shapes`` (path -> JAX-layout
    shape), in the order given; a stage leaf's stacked repeats dim stays
    whole."""
    if fsdp is None:
        fsdp = fsdp_default(cfg)
    fsdp_axes = tuple(batch_axes) if fsdp else None
    out = {}
    for path, shape in shapes.items():
        lead = 1 if "stages" in path.split("/") and len(shape) >= 1 else 0
        spec = param_spec(path, tuple(shape[lead:]), mesh, model_axis, fsdp_axes, report=report)
        out[path] = (None,) * lead + spec
    if report is not None:
        report.log_summary(f"params[{getattr(cfg, 'name', '?')}]")
    return out


def batch_shardings(cfg, mesh, shape_kind, batch_axes=("data",)) -> Dict[str, Spec]:
    ba = tuple(batch_axes)
    return {"tokens": (ba, None), "labels": (ba, None),
            **({"enc_inputs": (ba, None, None)} if cfg.is_encoder_decoder else {})}


def cache_spec(name: str, shape: Tuple[int, ...], mesh, batch_ok: bool, model_axis="model",
               batch_axes=("data",), report=None) -> Spec:
    """Activation-rule placement for one cache leaf (a pure function of the
    leaf name + shape). ``batch_ok`` says the pool batch divides the batch
    axes. The port's MLA ``latent`` leaf ([c_kv | k_rope] in one row) takes
    the rule of the JAX package's ``c_kv``."""
    ba = tuple(batch_axes)
    b_spec = ba if batch_ok else None
    seq_axis = None if batch_ok else "data"
    if name in ("k", "v", "xk", "xv"):  # (R,B,S,Hkv,Dh)
        hkv = shape[-2]
        h_spec = _maybe(hkv, mesh, model_axis, report, name, len(shape) - 2)
        # kv_heads < TP width: shard the KV SEQUENCE on 'model' instead
        s_spec = seq_axis if h_spec is not None else (seq_axis or model_axis)
        return (None, b_spec, s_spec, h_spec, None)
    if name in ("c_kv", "k_rope", "latent"):  # (R,B,S,r)
        return (None, b_spec, seq_axis,
                _maybe(shape[-1], mesh, model_axis, report, name, len(shape) - 1)
                if name in ("c_kv", "latent") else None)
    if name == "ssm":  # (R,B,H,P,N) or (R,B,di,N)
        return (None, b_spec, _maybe(shape[2], mesh, model_axis, report, name, 2),
                *([None] * (len(shape) - 3)))
    if name == "conv":  # (R,B,W-1,C)
        return (None, b_spec, None,
                _maybe(shape[-1], mesh, model_axis, report, name, len(shape) - 1))
    return tuple([None] * len(shape))


def cache_shardings(shapes: Dict[str, Tuple[int, ...]], cfg, mesh, batch, model_axis="model",
                    batch_axes=("data",), report: ShardingReport = None) -> Dict[str, Spec]:
    """KV/state-cache placement per the activation rules: leaf name ->
    placement for the cache leaves ``shapes`` (name -> shape)."""
    sizes = axis_sizes(mesh)
    bp = int(np.prod([sizes[a] for a in batch_axes]))
    batch_ok = batch % bp == 0
    out = {name: cache_spec(name, shape, mesh, batch_ok, model_axis=model_axis,
                            batch_axes=batch_axes, report=report)
           for name, shape in shapes.items()}
    if report is not None:
        report.log_summary(f"cache[{getattr(cfg, 'name', '?')} b={batch}]")
    return out
