"""Tiny-YOLOv2-style conv detector, the AdaOper paper's evaluation model:
the counterpart of ``repro.models.convnet``.

Nine conv stages from ``configs.yolo_v2_tiny.YOLO_STAGES``: a 3x3 conv
(SAME padding, stride 1; the last stage a 1x1 conv to 125 channels), an
fp32 bias, leaky ReLU 0.1 on every stage but the last, and a 2x2/2 VALID
max-pool where the stage says 2. It takes (B, H, W, 3) and returns
(B, H/32, W/32, 125), the JAX package's NHWC layouts; inside it runs NCHW
through ``F.conv2d`` (the JAX package computes the conv with
``lax.conv_general_dilated``, outside any Pallas kernel, so the library
conv is the counterpart). ``convert.yolo_params_from_numpy`` carries JAX
weights across (HWIO to OIHW).

It runs in fp32, with TF32 off on the card as the port's fp32 paths keep
it. Another dtype is refused: the reference's bf16 path (bf16 weights,
fp32 biases) promotes the activations to fp32 after the first bias and its
second conv then raises on mixed dtypes, so there is no bf16 semantics to
port (ROADMAP.md, Queue 3).
"""
from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.yolo_v2_tiny import YOLO_STAGES
from repro_torch.models.model import resolve_device


def _check_dtype(dtype) -> None:
    if dtype != torch.float32:
        raise NotImplementedError(f"yolo-v2-tiny in {dtype}: the port runs it in float32 only "
                                  "(the reference's bf16 path fails; see ROADMAP.md)")


class YOLO(nn.Module):
    """Counterpart of ``init_yolo``'s list of stage dicts: one ``nn.Conv2d``
    (OIHW weight, fp32 bias) per stage."""

    def __init__(self, in_ch: int = 3, device=None, dtype=torch.float32):
        super().__init__()
        _check_dtype(dtype)
        convs, ch = [], in_ch
        for out_ch, _pool in YOLO_STAGES:
            ksz = 1 if out_ch == 125 else 3
            convs.append(nn.Conv2d(ch, out_ch, ksz, padding="same", device=device,
                                   dtype=torch.float32))
            ch = out_ch
        self.convs = nn.ModuleList(convs)
        self.requires_grad_(False)


@torch.no_grad()
def init_yolo(seed: int = 0, device="cuda", in_ch: int = 3, dtype=torch.float32) -> YOLO:
    """Seeded random weights with the JAX init's distributions: each conv
    N(0,1) * sqrt(2 / (k*k*in)), biases 0. Drawn in fp32 from a
    ``torch.Generator`` on ``device`` (the bits differ from JAX's)."""
    _check_dtype(dtype)
    dev = resolve_device(device)
    model = YOLO(in_ch, dev, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for conv in model.convs:
        o, i, kh, kw = conv.weight.shape
        conv.weight.copy_(torch.randn(conv.weight.shape, generator=gen, device=dev)
                          * (2.0 / (kh * kw * i)) ** 0.5)
        conv.bias.zero_()
    return model


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@torch.no_grad()
def apply_yolo(model: YOLO, x: torch.Tensor) -> torch.Tensor:
    """x (B, H, W, 3) fp32 on the model's device -> (B, H/32, W/32, 125)."""
    _check_dtype(x.dtype)
    h = x.permute(0, 3, 1, 2)
    with _no_tf32():
        for conv, (out_ch, pool) in zip(model.convs, YOLO_STAGES):
            h = F.conv2d(h, conv.weight, conv.bias, padding="same")
            if out_ch != 125:
                h = torch.where(h > 0, h, 0.1 * h)  # leaky relu
            if pool == 2:
                h = F.max_pool2d(h, 2, 2)
    return h.permute(0, 2, 3, 1).contiguous()
