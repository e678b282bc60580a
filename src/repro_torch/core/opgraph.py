"""Operator-graph IR — what AdaOper partitions.

A model is lowered to a chain of ``OpNode``s with per-op compute and I/O
metadata. Nodes carry a ``splittable`` flag and the parallel dimension's
grain so the partitioner knows which ops can be fractionally co-executed
across processor classes (CoDL-style channel/height splits) and which must
be placed whole (e.g. an SSM scan step along time).

A copy of ``repro.core.opgraph``. Graph constructors:
  * ``build_yolo_graph``        — the paper's evaluation model (conv chain).
  * ``build_transformer_graph`` — per-layer ops for every assigned arch
    (attention / MLA / MoE / SSD).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig

OP_TYPES = ("conv", "matmul", "attention", "moe", "scan", "norm", "embed")

# per-op feature block that does not depend on (alpha, prev_alpha, state):
# [log flops, log io bytes, log weight bytes] + op-type one-hot
STATIC_FEATURE_DIM = 3 + len(OP_TYPES)


@dataclass
class OpNode:
    name: str
    op_type: str  # conv | matmul | attention | moe | scan | norm | embed
    flops: float  # forward FLOPs for the given batch
    bytes_in: float
    bytes_out: float
    weight_bytes: float
    splittable: bool = True  # can be fractionally co-executed
    split_grain: int = 8  # number of equal shards the parallel dim allows
    comm_bytes_if_split: float = 0.0  # extra boundary bytes when split
    # lazily-built caches (planner fast path); invalidated only by
    # _invalidate_feature_cache() — op metadata is treated as immutable
    # once the node enters a graph.
    _feat_static: Optional[np.ndarray] = field(
        default=None, repr=False, compare=False)

    def static_features(self) -> np.ndarray:
        """Cached (STATIC_FEATURE_DIM,) feature block for this op."""
        f = self._feat_static
        if f is None:
            f = np.zeros(STATIC_FEATURE_DIM)
            f[0] = np.log1p(self.flops) / 25.0
            f[1] = np.log1p(self.bytes_in + self.bytes_out) / 25.0
            f[2] = np.log1p(self.weight_bytes) / 25.0
            f[3 + OP_TYPES.index(self.op_type)] = 1.0
            self._feat_static = f
        return f

    def _invalidate_feature_cache(self) -> None:
        """Clear ALL planner caches stored on this node: the static feature
        block and the alpha-level grid the partitioner memoises here."""
        self._feat_static = None
        self._alpha_levels = None  # set lazily by partitioner._levels_for


@dataclass
class OpGraph:
    name: str
    nodes: List[OpNode] = field(default_factory=list)
    _feat_matrix: Optional[np.ndarray] = field(
        default=None, repr=False, compare=False)

    def total_flops(self) -> float:
        return sum(n.flops for n in self.nodes)

    def total_bytes(self) -> float:
        return sum(n.bytes_in + n.bytes_out + n.weight_bytes for n in self.nodes)

    def static_feature_matrix(self) -> np.ndarray:
        """Cached (n_ops, STATIC_FEATURE_DIM) stack of per-op feature blocks."""
        if self._feat_matrix is None or len(self._feat_matrix) != len(self.nodes):
            self._feat_matrix = (np.stack([n.static_features() for n in self.nodes])
                                 if self.nodes else np.zeros((0, STATIC_FEATURE_DIM)))
        return self._feat_matrix

    def _invalidate_feature_cache(self) -> None:
        """Clear the graph-level matrix and every node's planner caches —
        call after mutating any op's metadata."""
        self._feat_matrix = None
        for n in self.nodes:
            n._invalidate_feature_cache()

    def __len__(self):
        return len(self.nodes)


# ---------------------------------------------------------------------------
# YOLOv2-tiny (the paper's Fig. 2 model)
# ---------------------------------------------------------------------------


def build_yolo_graph(batch: int = 1, resolution: int = 416, dtype_bytes: int = 4) -> OpGraph:
    from repro_torch.configs.yolo_v2_tiny import YOLO_STAGES

    g = OpGraph("yolo-v2-tiny")
    h = w = resolution
    ch = 3
    for i, (out_ch, pool) in enumerate(YOLO_STAGES):
        ksz = 1 if out_ch == 125 else 3
        flops = 2.0 * batch * h * w * ksz * ksz * ch * out_ch
        b_in = batch * h * w * ch * dtype_bytes
        b_out = batch * h * w * out_ch * dtype_bytes
        wb = ksz * ksz * ch * out_ch * dtype_bytes
        # convs split along output channels (16+ channels everywhere), so the
        # co-execution ratio grain is fine; a split re-reads the input on
        # both classes -> boundary traffic is the input activation
        g.nodes.append(OpNode(f"conv{i}", "conv", flops, b_in, b_out, wb,
                              splittable=True, split_grain=16,
                              comm_bytes_if_split=b_in))
        ch = out_ch
        if pool == 2:
            h //= 2
            w //= 2
    return g


# ---------------------------------------------------------------------------
# transformer-family graphs
# ---------------------------------------------------------------------------


def build_transformer_graph(cfg: ModelConfig, batch: int, seq: int,
                            kind: str = "prefill", dtype_bytes: int = 2) -> OpGraph:
    """One OpNode per major operator per layer. ``kind``: train|prefill|decode
    (decode => one query token against a ``seq``-long KV/state)."""
    g = OpGraph(f"{cfg.name}:{kind}")
    D, V = cfg.d_model, cfg.padded_vocab
    Sq = 1 if kind == "decode" else seq
    T = batch * Sq
    act = T * D * dtype_bytes

    g.nodes.append(OpNode("embed", "embed", 2.0 * T * D, T * 4, act,
                          V * D * dtype_bytes, splittable=True, split_grain=8,
                          comm_bytes_if_split=T * 4))

    kinds, mlps = cfg.layer_kinds(), cfg.mlp_kinds()
    for i, (k, m) in enumerate(zip(kinds, mlps)):
        if k in ("attn", "local", "global"):
            if cfg.use_mla:
                r = cfg.kv_lora_rank
                qk = cfg.qk_nope_dim + cfg.qk_rope_dim
                proj_f = 2.0 * T * D * (cfg.num_heads * qk + r + cfg.qk_rope_dim)
                proj_f += 2.0 * T * r * cfg.num_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                proj_f += 2.0 * T * cfg.num_heads * cfg.v_head_dim * D
                wb = (D * cfg.num_heads * qk + D * (r + cfg.qk_rope_dim)
                      + r * cfg.num_heads * (cfg.qk_nope_dim + cfg.v_head_dim)
                      + cfg.num_heads * cfg.v_head_dim * D) * dtype_bytes
            else:
                proj_f = 2.0 * T * D * (cfg.q_dim + 2 * cfg.kv_dim) + 2.0 * T * cfg.q_dim * D
                wb = (D * (cfg.q_dim + 2 * cfg.kv_dim) + cfg.q_dim * D) * dtype_bytes
            g.nodes.append(OpNode(f"l{i}.qkvo", "matmul", proj_f, act, act, wb,
                                  splittable=True, split_grain=cfg.num_kv_heads or 8,
                                  comm_bytes_if_split=act))
            kv_span = seq if k != "local" or not cfg.sliding_window else min(seq, cfg.sliding_window)
            att_f = 4.0 * batch * Sq * kv_span * cfg.num_heads * cfg.head_dim
            kv_bytes = batch * kv_span * (cfg.kv_dim * 2 if not cfg.use_mla
                                          else cfg.kv_lora_rank + cfg.qk_rope_dim) * dtype_bytes
            g.nodes.append(OpNode(f"l{i}.attn", "attention", att_f, act + kv_bytes, act, 0,
                                  splittable=True, split_grain=cfg.num_kv_heads or 8,
                                  comm_bytes_if_split=act))
        elif k in ("ssd", "mamba"):
            di, N = cfg.d_inner, cfg.ssm_d_state
            proj_f = 2.0 * T * D * 2 * di + 2.0 * T * di * D
            scan_f = 6.0 * T * di * N
            wb = (D * 2 * di + di * D) * dtype_bytes
            g.nodes.append(OpNode(f"l{i}.ssm_proj", "matmul", proj_f, act, act, wb,
                                  splittable=True, split_grain=8,
                                  comm_bytes_if_split=act))
            # the scan is sequential along time: splittable across channels
            # only, and NOT for decode (single step, state-carry dependency)
            g.nodes.append(OpNode(f"l{i}.scan", "scan", scan_f,
                                  T * di * dtype_bytes, T * di * dtype_bytes,
                                  di * N * dtype_bytes,
                                  splittable=(kind != "decode"), split_grain=8,
                                  comm_bytes_if_split=batch * di * N * 4))
        if m == "dense":
            f = 6.0 * T * D * cfg.d_ff
            g.nodes.append(OpNode(f"l{i}.mlp", "matmul", f, act, act,
                                  3 * D * cfg.d_ff * dtype_bytes, splittable=True,
                                  split_grain=8, comm_bytes_if_split=act))
        elif m == "moe":
            f = 6.0 * T * D * cfg.moe_d_ff * cfg.top_k
            f += 2.0 * T * D * cfg.num_experts  # router
            if cfg.num_shared_experts:
                f += 6.0 * T * D * cfg.moe_d_ff * cfg.num_shared_experts
            wb = cfg.num_experts * 3 * D * cfg.moe_d_ff * dtype_bytes
            # splitting an MoE layer across classes moves routed tokens
            g.nodes.append(OpNode(f"l{i}.moe", "moe", f, act, act, wb,
                                  splittable=True, split_grain=min(8, cfg.num_experts),
                                  comm_bytes_if_split=act * cfg.top_k))
    g.nodes.append(OpNode("lm_head", "matmul", 2.0 * T * D * V, act,
                          T * V * dtype_bytes, V * D * dtype_bytes,
                          splittable=True, split_grain=8,
                          comm_bytes_if_split=act))
    return g
