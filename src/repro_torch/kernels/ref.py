"""The mathematical definitions the kernels compute: attention with
materialised scores and the sequential SSD recurrence, the counterparts of
``repro.kernels.ref.attention_ref`` and ``ssd_ref``. The kernel tests hold
the plain versions and the kernels against first principles with them."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal=True, window=None, softcap=None,
                  q_offset=0, kv_len=None, scale=None):
    """q (B,Sq,H,Dk); k/v (B,Sk,Hkv,D*); scalar q_offset / kv_len."""
    B, Sq, H, Dk = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = scale if scale is not None else Dk ** -0.5
    kx = k.repeat_interleave(G, dim=2).float()
    vx = v.repeat_interleave(G, dim=2).float()
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    qpos = q_offset + torch.arange(Sq, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    keep = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= (qpos - kpos) < window
    if kv_len is not None:
        keep &= kpos < kv_len
    s = s.masked_fill(~keep, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)  # fully-masked rows
    o = torch.einsum("bhqk,bkhd->bqhd", p, vx)
    return o.to(q.dtype)


def ssd_ref(x, dA, dt, Bm, Cm):
    """Sequential SSD recurrence: x (B,S,H,P); dA (B,S,H) log-decay
    (= dt * A); dt (B,S,H); Bm/Cm (B,S,N).
    h_t = exp(dA_t) h_{t-1} + dt_t B_t (x) x_t ; y_t = C_t . h_t.
    Returns (y (B,S,H,P) in x's dtype, h_final (B,H,P,N) fp32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = h * torch.exp(dA[:, t].float())[..., None, None] + torch.einsum(
            "bh,bn,bhp->bhpn", dt[:, t].float(), Bm[:, t].float(), x[:, t].float())
        ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, t].float(), h))
    return torch.stack(ys, dim=1).to(x.dtype), h
