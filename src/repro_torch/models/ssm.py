"""State-space mixer, Mamba2 half: the counterpart of ``repro.models.ssm``.

Prefill (``mamba2_forward``) runs the SSD chunked scan through
``kernels.ssd_scan``: the hand-written CUDA kernel on CUDA tensors, its
plain version on CPU tensors or with ``impl="plain"``. It computes the
function ``repro.models.ssm.ssd_chunked`` computes in the JAX model.
Decode (``mamba2_decode``) is the single-step recurrence against the
carried (conv_state, ssm_state). Mamba1 waits (see ROADMAP.md).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
from repro_torch.models.layers import rms_norm_head


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


def _gated_rmsnorm(y, z, scale, eps=1e-6):
    """Mamba2 norm: rmsnorm(y * silu(z))."""
    return rms_norm_head(y * F.silu(z), scale, eps)


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
    def init_constants(self, H: int) -> None:
        """The JAX init's deterministic leaves: zero conv bias, A = -(1..16),
        D = 1, dt_bias = softplus^-1(0.01), unit norm scale."""
        self.conv_b.zero_()
        self.A_log.copy_(torch.log(torch.linspace(1.0, 16.0, H)))
        self.D.fill_(1.0)
        self.dt_bias.fill_(float(torch.log(torch.expm1(torch.tensor(0.01)))))
        self.norm.fill_(1.0)


def _split(zxbcdt, cfg):
    di, N = cfg.d_inner, cfg.ssm_d_state
    return torch.split(zxbcdt, [di, di + 2 * N, cfg.ssm_num_heads], dim=-1)


def mamba2_forward(p: Mamba2, xin, cfg, mask=None, impl=None):
    """xin (B,S,D) -> (y (B,S,D), (conv_state, ssm_state)).

    ``mask`` (B,S) bool, True at valid positions, makes LEFT-padded
    (bucketed) prompts pad-safe: the conv input is zeroed at masked
    positions and ``dt`` is zeroed, so pad steps neither write into nor
    decay the state (``dA = dt * A = 0``, ``exp(0) = 1``)."""
    B, S, _ = xin.shape
    di, N, H, P = cfg.d_inner, cfg.ssm_d_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    z, xBC, dt_raw = _split(p.in_proj(xin), cfg)
    if mask is not None:
        xBC = xBC * mask.to(xBC.dtype)[..., None]
    xBC_conv = F.silu(_causal_conv(xBC, p.conv_w.float(), p.conv_b).to(xin.dtype))
    xs, Bm, Cm = torch.split(xBC_conv, [di, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)  # (B,S,H)
    if mask is not None:
        dt = dt * mask.to(dt.dtype)[..., None]
    A = -torch.exp(p.A_log)  # (H,)
    xh = xs.reshape(B, S, H, P).contiguous()
    scan = ssd_scan_plain if impl == "plain" else ssd_scan
    y, h_last = scan(xh, (dt * A).contiguous(), dt.contiguous(), Bm.contiguous(),
                     Cm.contiguous(), chunk=cfg.ssm_chunk)
    y = y + p.D[None, None, :, None] * xh.float()
    y = y.reshape(B, S, di).to(xin.dtype)
    y = _gated_rmsnorm(y, z, p.norm)
    W1 = cfg.ssm_d_conv - 1
    conv_state = xBC[:, -W1:, :] if S >= W1 else F.pad(xBC, (0, 0, W1 - S, 0))
    return p.out_proj(y), (conv_state.to(xin.dtype), h_last)


def mamba2_decode(p: Mamba2, xin, cfg, conv_state, ssm_state):
    """xin (B,1,D); conv_state (B,W-1,conv_dim); ssm_state (B,H,P,N).
    Returns (y (B,1,D), (new conv_state, new ssm_state))."""
    B = xin.shape[0]
    di, N, H, P = cfg.d_inner, cfg.ssm_d_state, cfg.ssm_num_heads, cfg.ssm_head_dim
    z, xBC, dt_raw = _split(p.in_proj(xin)[:, 0], cfg)
    y_conv, conv_state = _conv_step(conv_state.float(), xBC.float(), p.conv_w.float(), p.conv_b)
    xs, Bm, Cm = torch.split(F.silu(y_conv), [di, N, N], dim=-1)
    dt = F.softplus(dt_raw.float() + p.dt_bias)  # (B,H)
    A = -torch.exp(p.A_log)
    xh = xs.reshape(B, H, P)
    dA = torch.exp(dt * A)  # (B,H)
    ssm_state = ssm_state * dA[:, :, None, None] + torch.einsum("bh,bn,bhp->bhpn", dt, Bm, xh)
    y = torch.einsum("bn,bhpn->bhp", Cm, ssm_state) + p.D[None, :, None] * xh
    y = y.reshape(B, di).to(xin.dtype)
    y = _gated_rmsnorm(y, z.to(xin.dtype), p.norm)
    return p.out_proj(y)[:, None, :], (conv_state.to(xin.dtype), ssm_state)
