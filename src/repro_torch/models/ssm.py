"""State-space mixers, Mamba2 (SSD) and Mamba1 (Jamba's diagonal
selective scan): the counterpart of ``repro.models.ssm``.

Mamba2's prefill (``mamba2_forward``) runs the SSD chunked scan through
``kernels.ssd_scan``: the hand-written CUDA kernel on CUDA tensors, its
plain version on CPU tensors or with ``impl="plain"``. It computes the
function ``repro.models.ssm.ssd_chunked`` computes in the JAX model. Its
train forward (``impl=TRAIN_IMPL``) runs the port of that function,
``kernels.ssd_scan.ssd_chunked``, which autograd differentiates, as the
reference trains.

Mamba1 has no Pallas kernel in the JAX package, so it stays PyTorch here.
Its prefill and train forward (``mamba1_forward``) run ``selective_scan``
chunk by chunk (``cfg.ssm_chunk`` positions), carrying the (B, d_inner, N)
state across chunks. Inside a chunk the recurrence h_t = a_t h_{t-1} +
b_t, with a_t = exp(dt_t A) and b_t = dt_t u_t B_t, is a log-depth Hillis-Steele
scan over the (a, b) pairs under (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2),
the pairing ``jax.lax.associative_scan`` combines in the JAX package: each
level combines every position with the one 2^k before it. It never divides
by a running product of decays, which underflows to 0 at Jamba's dt * A
over 256 steps; a product that underflows here is a true decay to 0.

Decode (``mamba2_decode``, ``mamba1_decode``) is the single-step
recurrence against the carried (conv_state, ssm_state).

On a model axis of M > 1 (``ctx.model_parallel``; the placement is
``sharding.placement``'s) a rank runs its 1/M of the heads (Mamba2) or
inner channels (Mamba1), the sizes read from its parameters. Mamba2's
``in_proj`` yields the rank's z, x and dt and B and C whole, so the scan
needs no collective; its gated RMSNorm normalises over all of d_inner, so
the ranks' sums of squares are all-reduced before the scale (forward and
backward). In train mode the B and C columns of ``in_proj`` and of the
conv, which every rank holds whole but applies to its own heads, get a
partial gradient that ``training.train_loop.sync_grads`` sums over the
model axis (``ParamPlan.shared_rows``). Mamba1's
``x_proj`` takes the rank's channels and gives a partial sum of dt_rank +
2N columns, all-reduced (in fp32 when serving) before the dt / B / C norms,
which act on the whole. Every rank then applies the whole dt / B / C to its
own channels, so that all-reduce has an all-reduce backward
(``collectives.sum_over_model``): the gradient of the summed columns is the
sum of the ranks' gradients. The norms' scales, whole on every rank, get a
partial gradient (``ParamPlan.partial``). ``out_proj`` is row-parallel: the
caller sums its outputs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ssd_chunked, ssd_scan, ssd_scan_plain
from repro_torch.models.attention import TRAIN_IMPL
from repro_torch.models.layers import rms_norm_head, row_linear
from repro_torch.sharding import collectives


def _causal_conv(x, w, b):
    """Depthwise causal conv. x (B,S,C), w (C,W) fp32, b (C,) fp32 -> fp32."""
    W = w.shape[1]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, W - 1, 0))
    out = 0.0
    for i in range(W):
        out = out + xp[:, i:i + S, :] * w[:, i]
    return out + b


def _conv_step(state, x_new, w, b):
    """state (B,W-1,C) raw inputs; x_new (B,C). Returns (y (B,C), new_state)."""
    full = torch.cat([state, x_new[:, None, :]], dim=1)  # (B,W,C)
    y = torch.einsum("bwc,cw->bc", full, w) + b
    return y, full[:, 1:, :]


def _gated_rmsnorm(y, z, scale, cfg, ctx=None, eps=1e-6):
    """Mamba2 norm: rmsnorm(y * silu(z)) over all of d_inner; a model
    rank holds its channels of y, z and ``scale``, and the fp32 sum of
    squares is all-reduced over the model axis (``sum_over_model``: every
    rank's channels are divided by the whole sum, so in train mode its
    gradient is the sum of the ranks' gradients)."""
    g = y * F.silu(z)
    if ctx is None or ctx.model_parallel == 1:
        return rms_norm_head(g, scale, eps)
    gf = g.float()
    ss = collectives.sum_over_model(gf.square().sum(dim=-1, keepdim=True), ctx)
    return (gf * torch.rsqrt(ss / cfg.d_inner + eps) * scale).to(g.dtype)


def _row_parallel(lin: nn.Linear, x, ctx):
    """``lin(x)`` for a weight whose input dim a model rank holds 1/M of
    (Mamba1's ``x_proj``): the ranks' partial sums (``row_linear``: fp32
    when serving) all-reduced, in x's dtype. Every rank applies the whole
    sum to its own channels, so in train mode the backward sums the ranks'
    gradients (``sum_over_model``); serving's call is the same in-place
    all-reduce as ``reduce_from_model``'s."""
    if ctx is None or ctx.model_parallel == 1:
        return lin(x)
    return collectives.sum_over_model(row_linear(lin, x), ctx).to(x.dtype)


class Mamba2(nn.Module):
    """Mamba2 mixer parameters (counterpart of ``init_mamba2``'s dict):
    projections in the param dtype, ``conv_w`` (conv_dim, W) in the param
    dtype, ``conv_b``, ``A_log``, ``D``, ``dt_bias`` and ``norm`` in fp32."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        di, N, H = cfg.d_inner, cfg.ssm_d_state, cfg.ssm_num_heads
        conv_dim = di + 2 * N  # ngroups = 1
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = nn.Linear(cfg.d_model, 2 * di + 2 * N + H, bias=False, device=device,
                                 dtype=dtype)
        self.conv_w = nn.Parameter(torch.empty(conv_dim, cfg.ssm_d_conv, device=device,
                                               dtype=dtype))
        self.conv_b = nn.Parameter(torch.empty(conv_dim, **f32))
        self.A_log = nn.Parameter(torch.empty(H, **f32))
        self.D = nn.Parameter(torch.empty(H, **f32))
        self.dt_bias = nn.Parameter(torch.empty(H, **f32))
        self.norm = nn.Parameter(torch.empty(di, **f32))
        self.out_proj = nn.Linear(di, cfg.d_model, bias=False, device=device, dtype=dtype)

    @torch.no_grad()
    def init_constants(self, H: int, first: int = 0) -> None:
        """The JAX init's deterministic leaves: zero conv bias, A = -(1..16)
        over the H heads, D = 1, dt_bias = softplus^-1(0.01), unit norm
        scale. A model rank's shard holds heads [first, first + its heads)."""
        self.conv_b.zero_()
        n = self.A_log.shape[0]
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H))[first:first + n])
        self.D.fill_(1.0)
        self.dt_bias.fill_(float(torch.log(torch.expm1(torch.tensor(0.01)))))
        self.norm.fill_(1.0)


def _split(zxbcdt, p: Mamba2, cfg):
    """[z | x B C | dt] of ``in_proj``'s output, at the widths ``p``
    holds (a model rank's di/M and H/M, or the whole)."""
    di, H = p.norm.shape[0], p.A_log.shape[0]
    return torch.split(zxbcdt, [di, di + 2 * cfg.ssm_d_state, H], dim=-1)


def mamba2_forward(p: Mamba2, xin, cfg, mask=None, impl=None, ctx=None):
    """xin (B,S,D) -> (y (B,S,D), (conv_state, ssm_state)).

    ``mask`` (B,S) bool, True at valid positions, makes LEFT-padded
    (bucketed) prompts pad-safe: the conv input is zeroed at masked
    positions and ``dt`` is zeroed, so pad steps neither write into nor
    decay the state (``dA = dt * A = 0``, ``exp(0) = 1``). ``ctx`` at a
    model axis of M > 1: ``p`` holds a rank's heads (module docstring) and
    y is its partial sum of ``out_proj``."""
    B, S, _ = xin.shape
    di, N, H, P = p.norm.shape[0], cfg.ssm_d_state, p.A_log.shape[0], cfg.ssm_head_dim
    z, xBC, dt_raw = _split(p.in_proj(xin), p, cfg)
    if mask is not None:
        xBC = xBC * mask.to(xBC.dtype)[..., None]
    xBC_conv = F.silu(_causal_conv(xBC, p.conv_w.float(), p.conv_b).to(xin.dtype))
    xs, Bm, Cm = torch.split(xBC_conv, [di, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)  # (B,S,H)
    if mask is not None:
        dt = dt * mask.to(dt.dtype)[..., None]
    A = -torch.exp(p.A_log)  # (H,)
    xh = xs.reshape(B, S, H, P).contiguous()
    scan = {"plain": ssd_scan_plain, TRAIN_IMPL: ssd_chunked}.get(impl, ssd_scan)
    y, h_last = scan(xh, (dt * A).contiguous(), dt.contiguous(), Bm.contiguous(),
                     Cm.contiguous(), chunk=cfg.ssm_chunk)
    y = y + p.D[None, None, :, None] * xh.float()
    y = y.reshape(B, S, di).to(xin.dtype)
    y = _gated_rmsnorm(y, z, p.norm, cfg, ctx)
    W1 = cfg.ssm_d_conv - 1
    conv_state = xBC[:, -W1:, :] if S >= W1 else F.pad(xBC, (0, 0, W1 - S, 0))
    return row_linear(p.out_proj, y), (conv_state.to(xin.dtype), h_last)


def mamba2_decode(p: Mamba2, xin, cfg, conv_state, ssm_state, ctx=None):
    """xin (B,1,D); conv_state (B,W-1,conv_dim); ssm_state (B,H,P,N), a
    model rank's conv channels and heads at M > 1. Returns (y (B,1,D),
    (new conv_state, new ssm_state))."""
    B = xin.shape[0]
    di, N, H, P = p.norm.shape[0], cfg.ssm_d_state, p.A_log.shape[0], cfg.ssm_head_dim
    z, xBC, dt_raw = _split(p.in_proj(xin)[:, 0], p, cfg)
    y_conv, conv_state = _conv_step(conv_state.float(), xBC.float(), p.conv_w.float(), p.conv_b)
    xs, Bm, Cm = torch.split(F.silu(y_conv), [di, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)  # (B,H)
    A = -torch.exp(p.A_log)
    xh = xs.reshape(B, H, P)
    dA = torch.exp(dt * A)  # (B,H)
    ssm_state = ssm_state * dA[:, :, None, None] + torch.einsum("bh,bn,bhp->bhpn", dt, Bm, xh)
    y = torch.einsum("bn,bhpn->bhp", Cm, ssm_state) + p.D[None, :, None] * xh
    y = y.reshape(B, di).to(xin.dtype)
    y = _gated_rmsnorm(y, z.to(xin.dtype), p.norm, cfg, ctx)
    return row_linear(p.out_proj, y)[:, None, :], (conv_state.to(xin.dtype), ssm_state)


# ===========================================================================
# Mamba1 (Jamba's mixer)
# ===========================================================================


def dt_rank(cfg) -> int:
    return max(1, -(-cfg.d_model // 16))


class Mamba1(nn.Module):
    """Mamba1 mixer parameters (counterpart of ``init_mamba1``'s dict), in
    its order: projections and ``conv_w`` (d_inner, W) in the param dtype;
    ``conv_b``, ``dt_proj_b``, ``A_log`` (d_inner, N), ``D`` and Jamba's
    inner RMSNorm scales on dt, B and C in fp32."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        di, N, rank = cfg.d_inner, cfg.ssm_d_state, dt_rank(cfg)
        kw = dict(bias=False, device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = nn.Linear(cfg.d_model, 2 * di, **kw)
        self.conv_w = nn.Parameter(torch.empty(di, cfg.ssm_d_conv, device=device, dtype=dtype))
        self.conv_b = nn.Parameter(torch.empty(di, **f32))
        self.x_proj = nn.Linear(di, rank + 2 * N, **kw)
        self.dt_proj = nn.Linear(rank, di, **kw)
        self.dt_proj_b = nn.Parameter(torch.empty(di, **f32))
        self.A_log = nn.Parameter(torch.empty(di, N, **f32))
        self.D = nn.Parameter(torch.empty(di, **f32))
        self.dt_norm = nn.Parameter(torch.empty(rank, **f32))
        self.b_norm = nn.Parameter(torch.empty(N, **f32))
        self.c_norm = nn.Parameter(torch.empty(N, **f32))
        self.out_proj = nn.Linear(di, cfg.d_model, **kw)

    @torch.no_grad()
    def init_constants(self) -> None:
        """The JAX init's deterministic leaves: zero conv bias, dt_proj_b =
        softplus^-1(0.01), A = -(1..N) on every channel, D = 1, unit norm
        scales."""
        N = self.A_log.shape[1]
        self.conv_b.zero_()
        self.dt_proj_b.fill_(float(torch.log(torch.expm1(torch.tensor(0.01)))))
        self.A_log.copy_(torch.log(torch.arange(1, N + 1, dtype=torch.float32)).expand_as(
            self.A_log))
        self.D.fill_(1.0)
        for scale in (self.dt_norm, self.b_norm, self.c_norm):
            scale.fill_(1.0)


def _scan_pairs(a, b):
    """Inclusive scan along axis 1 of the pairs (a, b) under
    (a1, b1) . (a2, b2) = (a1 a2, b1 a2 + b2), Hillis-Steele: log2(Q)
    levels, each combining position t with t - 2^k. Each level makes new
    tensors (autograd keeps every level's inputs for the backward, so none
    is written in place); returns the scanned (a, b)."""
    d, n = 1, a.shape[1]
    while d < n:
        b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:], b[:, :-d])], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return a, b


def selective_scan(u, dt, Bm, Cm, A, chunk):
    """Diagonal selective scan, chunked: u (B,S,di), dt (B,S,di), Bm/Cm
    (B,S,N), A (di,N) fp32. h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t,
    y_t = sum_N C_t h_t, in fp32 from h_0 = 0. Returns (y (B,S,di) fp32,
    h_S (B,di,N) fp32), the function ``_selective_scan_chunked`` computes."""
    B, S, di = u.shape
    h = torch.zeros(B, di, A.shape[1], dtype=torch.float32, device=u.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, c0 + chunk)
        dtq = dt[:, sl].float()
        a = torch.exp(dtq[..., None] * A)  # (B,Q,di,N)
        b = (dtq * u[:, sl].float())[..., None] * Bm[:, sl, None, :].float()
        a, b = _scan_pairs(a, b)
        hs = torch.addcmul(b, h[:, None], a)  # h_t for every t of the chunk
        ys.append(torch.einsum("bqdn,bqn->bqd", hs, Cm[:, sl].float()))
        h = hs[:, -1]
    return torch.cat(ys, dim=1), h


def mamba1_forward(p: Mamba1, xin, cfg, mask=None, ctx=None):
    """xin (B,S,D) -> (y (B,S,D), (conv_state, ssm_state)). ``mask`` (B,S)
    bool, True at valid positions: the pad-safe scan of LEFT-padded prompts,
    as in ``mamba2_forward`` (zeroed conv input and ``dt``). ``ctx`` at a
    model axis of M > 1: ``p`` holds a rank's channels (module docstring)."""
    B, S, _ = xin.shape
    N, rank = cfg.ssm_d_state, dt_rank(cfg)
    x, z = p.in_proj(xin).chunk(2, dim=-1)
    if mask is not None:
        x = x * mask.to(x.dtype)[..., None]
    x_conv = F.silu(_causal_conv(x, p.conv_w.float(), p.conv_b).to(xin.dtype))
    dt_r, Bm, Cm = torch.split(_row_parallel(p.x_proj, x_conv, ctx), [rank, N, N], dim=-1)
    dt_r = rms_norm_head(dt_r, p.dt_norm)
    Bm = rms_norm_head(Bm, p.b_norm)
    Cm = rms_norm_head(Cm, p.c_norm)
    dt = F.softplus(p.dt_proj(dt_r).float() + p.dt_proj_b)  # (B,S,di)
    if mask is not None:
        dt = dt * mask.to(dt.dtype)[..., None]
    y, h_last = selective_scan(x_conv, dt, Bm, Cm, -torch.exp(p.A_log), cfg.ssm_chunk)
    y = y + p.D * x_conv.float()
    y = y.to(xin.dtype) * F.silu(z)
    W1 = cfg.ssm_d_conv - 1
    conv_state = x[:, -W1:, :] if S >= W1 else F.pad(x, (0, 0, W1 - S, 0))
    return row_linear(p.out_proj, y), (conv_state.to(xin.dtype), h_last)


def mamba1_decode(p: Mamba1, xin, cfg, conv_state, ssm_state, ctx=None):
    """xin (B,1,D); conv_state (B,W-1,d_inner); ssm_state (B,d_inner,N),
    a model rank's channels at M > 1. Returns (y (B,1,D), (new conv_state,
    new ssm_state))."""
    N, rank = cfg.ssm_d_state, dt_rank(cfg)
    x, z = p.in_proj(xin)[:, 0].chunk(2, dim=-1)
    y_conv, conv_state = _conv_step(conv_state.float(), x.float(), p.conv_w.float(), p.conv_b)
    x_conv = F.silu(y_conv).to(xin.dtype)
    dt_r, Bm, Cm = torch.split(_row_parallel(p.x_proj, x_conv, ctx), [rank, N, N], dim=-1)
    dt_r = rms_norm_head(dt_r, p.dt_norm)
    Bm = rms_norm_head(Bm, p.b_norm).float()
    Cm = rms_norm_head(Cm, p.c_norm).float()
    dt = F.softplus(p.dt_proj(dt_r).float() + p.dt_proj_b)  # (B,di)
    dA = torch.exp(dt[..., None] * -torch.exp(p.A_log))  # (B,di,N)
    ssm_state = ssm_state * dA + (dt * x_conv.float())[..., None] * Bm[:, None, :]
    y = torch.einsum("bdn,bn->bd", ssm_state, Cm) + p.D * x_conv.float()
    y = y.to(xin.dtype) * F.silu(z)
    return row_linear(p.out_proj, y)[:, None, :], (conv_state.to(xin.dtype), ssm_state)
