"""The mathematical definition of attention (materialised scores), the
counterpart of ``repro.kernels.ref.attention_ref``. The kernel tests hold
the plain versions and the kernels against first principles with it."""
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
