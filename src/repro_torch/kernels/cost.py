"""The work of one kernel call and the least time an H100 could take for it.

Each ``*_work`` function gives the operations and the bytes of one call of
a kernel from its shapes and positions: the operations by the kernel's own
count (2 FLOPs per multiply-add of each product it must form: 2·H·(Dk +
Dv) per kept (query, key) pair for the attention kernels), the bytes by
what the call must move, each input read once and each output written
once (the K / V entries that some query keeps, not the whole cache). The
positions are per-row lists of ints. ``bound`` turns (operations, bytes)
into the larger of the two times at the card's peak rates.

Two callers use the same formulas: the kernel wrappers' meta route
(``kernels.*``, on ``device="meta"`` tensors: the dry run,
``launch.dryrun``), which adds each call's work to the active op counter
(``utils.op_cost``), and ``chip_smoke.py``, which prints the bound beside
each kernel's measured time (PERF.md's kernel table).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils import op_cost

# NVIDIA H100 SXM data sheet: HBM rate and dense peaks (bf16 on the tensor
# cores, fp32 on the CUDA cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def key_span(qpos_first, qpos_last, kv_len, Sk, causal, window, start=0):
    """Keys that some query of a row keeps, its queries at ``qpos_first``
    .. ``qpos_last`` (ints, or numpy arrays of them): from the first
    query's window start to the last query's end; with ``qpos_first ==
    qpos_last`` the keys one query keeps. The cache holds keys [start,
    start + Sk) (a piece of a cut sequence; 0 for a whole cache)."""
    end = np.minimum(kv_len, start + Sk)
    hi = np.minimum(end, qpos_last + 1) if causal else end
    lo = np.maximum(start, np.maximum(0, qpos_first - window + 1) if window else 0)
    return np.maximum(0, hi - lo)


def bound(flops, nbytes, dtype_name):
    """(ms, "operations" or "bytes"): the larger of the operations at the
    dtype's peak and the bytes at the HBM rate."""
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes else "bytes")


def _rows(x, B, default):
    """A per-row int argument as an int64 array of B: None gives
    ``default``."""
    if x is None:
        x = default
    return np.broadcast_to(np.asarray(x, dtype=np.int64), (B,))


def attention_work(B, Sq, Sk, H, Hkv, Dk, Dv, elem, *, causal, window=None, q_offset=0,
                   kv_len=None):
    """The flash kernel's call: 2·H·(Dk + Dv) FLOPs per kept (query, key)
    pair; q and o once, K and V of the keys some query of the row keeps
    once. ``q_offset`` / ``kv_len``: int or B ints (None: Sk)."""
    qo, kl = _rows(q_offset, B, 0), _rows(kv_len, B, Sk)
    qpos = qo[:, None] + np.arange(Sq)
    pairs = int(key_span(qpos, qpos, kl[:, None], Sk, causal, window).sum())
    keys = int(key_span(qo, qo + Sq - 1, kl, Sk, causal, window).sum())
    nbytes = elem * (B * Sq * H * (Dk + Dv) + keys * Hkv * (Dk + Dv))
    return 2 * H * (Dk + Dv) * pairs, nbytes


def decode_work(B, Smax, H, Hkv, Dk, Dv, elem, *, window=None, q_offset=0, kv_len=None,
                k_start=None):
    """The decode kernel's call, one query per row (no causal mask:
    ``kv_len`` bounds the keys): each kept K / V entry read once, q and o
    once, 2·H·(Dk + Dv) FLOPs per entry. With ``k_start`` the piece mode:
    the cache holds keys [k_start, k_start + Smax) and o and the
    log-sum-exp are written in fp32."""
    start = 0 if k_start is None else k_start
    qo, kl = _rows(q_offset, B, 0), _rows(kv_len, B, start + Smax)
    hi = np.minimum(kl, start + Smax)
    lo = np.maximum(start, np.maximum(0, qo - window + 1) if window else 0)
    kept = int(np.maximum(0, hi - lo).sum())
    if k_start is None:
        nbytes = elem * (kept * Hkv * (Dk + Dv) + B * H * (Dk + Dv))
    else:
        nbytes = elem * (kept * Hkv * (Dk + Dv) + B * H * Dk) + 4 * B * H * (Dv + 1)
    return 2 * H * (Dk + Dv) * kept, nbytes


def mla_work(B, T, Smax, H, Hkv, Dk, Dv, elem, *, causal, window=None, q_offset=0, kv_len=None,
             v_shared=True, k_start=None):
    """The absorbed-MLA kernels' call, T rows per slot: each latent row that
    some row keeps read once (its first Dv columns being the values where
    ``v_shared``, else the values read beside it), q and o once; 2·H·(Dk +
    Dv) FLOPs per kept (row, key) pair. With ``k_start`` the piece mode:
    the cache holds keys [k_start, k_start + Smax), ``q_offset`` and
    ``kv_len`` are global, and o and the log-sum-exp are written in fp32."""
    start = 0 if k_start is None else k_start
    qo, kl = _rows(q_offset, B, 0), _rows(kv_len, B, start + Smax)
    qpos = qo[:, None] + np.arange(T)
    pairs = int(key_span(qpos, qpos, kl[:, None], Smax, causal, window, start).sum())
    rows = int(key_span(qo, qo + T - 1, kl, Smax, causal, window, start).sum())
    nbytes = elem * (rows * Hkv * (Dk + (0 if v_shared else Dv)) + B * T * H * Dk)
    nbytes += elem * B * T * H * Dv if k_start is None else 4 * B * T * H * (Dv + 1)
    return 2 * H * (Dk + Dv) * pairs, nbytes


def ssd_work(B, S, H, P, N, chunk, elem):
    """The SSD scan's call. Operations: per (row, chunk) C.B^T over the
    causal lower triangle once (B and C are shared by all heads), per head
    the masked decay matrix times x, C.h and the state update. Bytes: x,
    dA, dt, B, C read once, y and the fp32 final state written once."""
    Q = min(chunk, S)
    flops = 0
    for c0 in range(0, S, Q):
        q = min(Q, S - c0)
        tri = q * (q + 1) // 2
        flops += B * (2 * tri * N + H * (2 * tri * P + 4 * q * P * N))
    nbytes = (2 * elem * B * S * H * P + 2 * 4 * B * S * H + 2 * elem * B * S * N
              + 4 * B * H * P * N)
    return flops, nbytes


# ---- the bounds of chip_smoke.py's kernel table ------------------------------


def flash_bound(B, S, H, Hkv, D, window, dtype_name, elem, Dv=None):
    """Causal flash at B x S (a prefill): ``attention_work``'s bound."""
    Dv = D if Dv is None else Dv
    return bound(*attention_work(B, S, S, H, Hkv, D, Dv, elem, causal=True, window=window),
                 dtype_name)


def flash_bound_full(B, Sq, Sk, H, Hkv, D, dtype_name, elem):
    """Flash without a mask (the encoder, the cross-attention's prefill):
    every (query, key) pair kept."""
    return bound(*attention_work(B, Sq, Sk, H, Hkv, D, D, elem, causal=False), dtype_name)


def decode_bound_kept(kept, B, H, Hkv, D, dtype_name, elem):
    """Decode over ``kept`` K/V entries in all: each read once, q and o
    once, 4·H·D FLOPs per entry."""
    nbytes = elem * (kept * Hkv * 2 * D + 2 * B * H * D)
    return bound(4 * H * D * kept, nbytes, dtype_name)


def decode_bound(pos, Smax, H, Hkv, D, window, dtype_name, elem):
    """Decode of len(pos) rows at positions ``pos`` (kv_len pos + 1)."""
    pos = np.asarray(pos, dtype=np.int64)
    return bound(*decode_work(len(pos), Smax, H, Hkv, D, D, elem, window=window, q_offset=pos,
                              kv_len=pos + 1), dtype_name)


def mla_bound(offs, T, Smax, dtype_name, elem, H, Hkv=1, Dk=576, Dv=512):
    """The absorbed-MLA attention of T causal rows per slot at ``offs``
    (T = 1: the decode step, kv_len = offs + 1), values the latent rows'
    first Dv columns."""
    offs = np.asarray(offs, dtype=np.int64)
    return bound(*mla_work(len(offs), T, Smax, H, Hkv, Dk, Dv, elem, causal=True, q_offset=offs),
                 dtype_name)


def mla_piece_bound(offs, T, Sp, k_start, dtype_name, elem, H, Hkv=1, Dk=576, Dv=512):
    """The MLA kernels' piece mode: T causal rows per slot at ``offs`` (T =
    1: kv_len = offs + 1) over the piece of ``Sp`` latent rows from
    ``k_start``, o and the log-sum-exp written in fp32."""
    offs = np.asarray(offs, dtype=np.int64)
    return bound(*mla_work(len(offs), T, Sp, H, Hkv, Dk, Dv, elem, causal=True, q_offset=offs,
                           k_start=k_start), dtype_name)


def verify_bound(offs, T, Smax, H, Hkv, D, window, dtype_name, elem):
    """Flash at a verify's shape: the (query, key) pairs the causal mask
    keeps; q and o once, and K and V of the keys some query of the row
    keeps (the rest of the cache is never needed)."""
    offs = np.asarray(offs, dtype=np.int64)
    return bound(*attention_work(len(offs), T, Smax, H, Hkv, D, D, elem, causal=True,
                                 window=window, q_offset=offs), dtype_name)


def ssd_bound(B, S, dtype_name, elem, H, P, N, chunk):
    return bound(*ssd_work(B, S, H, P, N, chunk, elem), dtype_name)


# ---- the wrappers' meta route -------------------------------------------------


def host_rows(x, unknown):
    """A wrapper's ``q_offset`` / ``kv_len`` as host ints for ``*_work``: an
    int or None as it is, a host tensor's values, and ``unknown`` for a
    meta tensor, whose values no one knows (the work of the most keys)."""
    if isinstance(x, torch.Tensor):
        return unknown if x.is_meta else np.asarray(x.tolist(), dtype=np.int64)
    return x


def meta_call(name: str, work, *outs):
    """The meta route's result: add the call's (FLOPs, bytes) ``work`` to
    the active op counter under kernel ``name`` and return ``outs`` (meta
    tensors of the kernel's output shapes; one alone as itself). No kernel
    launches and no launch is counted."""
    op_cost.record_kernel(name, *work)
    return outs[0] if len(outs) == 1 else outs
