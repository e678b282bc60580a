"""GRU online corrector: the counterpart of ``repro.core.gru``.

AdaOper's runtime refinement: a small GRU consumes the recent window of
(op/device features, GBDT prediction, observed energy) tuples and predicts a
multiplicative correction for the next prediction, tracking drift that the
offline GBDT cannot see (thermal throttling, governor moves, contention).
Trained online with Adam on a sliding replay buffer.

The cell keeps the JAX package's gate equations and parameter layout
(``x @ W`` with W (in+hidden, hidden)), its zero-initialised head (the
corrector starts as the identity) and its Adam constants. It is host-side
control state, not the model: it runs in fp32 on the CPU, with its initial
weights drawn from an explicit ``torch.Generator`` (the bits differ from
JAX's; ``repro_torch.convert.gru_params_from_numpy`` carries JAX weights
across).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class GRUCell(nn.Module):
    def __init__(self, in_dim: int, hidden: int, gen: torch.Generator):
        super().__init__()
        s = 1.0 / np.sqrt(in_dim + hidden)

        def w():
            return nn.Parameter(torch.randn(in_dim + hidden, hidden, generator=gen) * s)

        self.wz, self.wr, self.wh = w(), w(), w()
        self.bz = nn.Parameter(torch.zeros(hidden))
        self.br = nn.Parameter(torch.zeros(hidden))
        self.bh = nn.Parameter(torch.zeros(hidden))
        # zero-init head: the corrector starts as the identity (correction 0)
        # and only departs from it as online evidence accumulates
        self.wo = nn.Parameter(torch.zeros(hidden, 1))
        self.bo = nn.Parameter(torch.zeros(1))

    def forward(self, xs: torch.Tensor) -> torch.Tensor:
        """xs (..., T, in_dim) -> (...,) log-correction prediction for step T."""
        h = xs.new_zeros(xs.shape[:-2] + (self.bz.shape[0],))
        for t in range(xs.shape[-2]):
            x = xs[..., t, :]
            hx = torch.cat([x, h], dim=-1)
            z = torch.sigmoid(hx @ self.wz + self.bz)
            r = torch.sigmoid(hx @ self.wr + self.br)
            hh = torch.tanh(torch.cat([x, r * h], dim=-1) @ self.wh + self.bh)
            h = (1 - z) * h + z * hh
        return (h @ self.wo + self.bo)[..., 0]


@dataclass
class GRUCorrector:
    in_dim: int
    window: int = 8
    hidden: int = 32
    lr: float = 3e-3
    buffer_size: int = 256
    seed: int = 0

    def __post_init__(self):
        gen = torch.Generator().manual_seed(self.seed)
        self.cell = GRUCell(self.in_dim, self.hidden, gen)
        self.reset_optimizer()
        self._buf_x: list = []
        self._buf_y: list = []
        self._hist: list = []

    def reset_optimizer(self) -> None:
        self.t = 0
        self.opt_m = {n: torch.zeros_like(p) for n, p in self.cell.named_parameters()}
        self.opt_v = {n: torch.zeros_like(p) for n, p in self.cell.named_parameters()}
        self._corr_key = None

    # ----- online API -----
    def predict_correction(self) -> float:
        """log-space correction to apply to the next GBDT prediction.
        Memoised on (history length, train step) — partitioner cost sweeps
        call this thousands of times between feedback events."""
        if len(self._hist) < 2:
            return 0.0
        key = (len(self._hist), self.t)
        if self._corr_key == key:
            return self._corr_val
        xs = np.stack(self._hist[-self.window:], 0)
        if xs.shape[0] < self.window:
            xs = np.pad(xs, ((self.window - xs.shape[0], 0), (0, 0)))
        with torch.no_grad():
            self._corr_val = float(self.cell(torch.from_numpy(xs.astype(np.float32))))
        self._corr_key = key
        return self._corr_val

    def record(self, features: np.ndarray, gbdt_pred: float, observed: float):
        """Feed one (features, prediction, observation) feedback tuple.
        The log-ratio is clipped: a degenerate GBDT prediction (~0 on a tiny
        op) must not inject a +25 outlier into the training buffer."""
        ratio = float(np.clip(
            np.log(max(observed, 1e-12) / max(gbdt_pred, 1e-12)), -2.0, 2.0))
        x = np.concatenate([features, [np.log1p(max(gbdt_pred, 0)), ratio]]).astype(np.float32)
        self._hist.append(x)
        if len(self._hist) >= self.window + 1:
            xs = np.stack(self._hist[-self.window - 1: -1], 0)
            self._buf_x.append(xs)
            self._buf_y.append(ratio)
            if len(self._buf_x) > self.buffer_size:
                self._buf_x.pop(0)
                self._buf_y.pop(0)

    def _adam_step(self, xs: torch.Tensor, ys: torch.Tensor) -> None:
        """One Adam step on the mean squared error, bias-corrected with the
        step count ``t`` (already incremented), as the JAX corrector does."""
        self.cell.zero_grad(set_to_none=True)
        loss = torch.mean((self.cell(xs) - ys) ** 2)
        loss.backward()
        t = float(self.t)
        with torch.no_grad():
            for n, p in self.cell.named_parameters():
                m = self.opt_m[n].mul_(ADAM_B1).add_((1 - ADAM_B1) * p.grad)
                v = self.opt_v[n].mul_(ADAM_B2).add_((1 - ADAM_B2) * p.grad * p.grad)
                mh = m / (1 - ADAM_B1 ** t)
                vh = v / (1 - ADAM_B2 ** t)
                p.sub_(self.lr * mh / (torch.sqrt(vh) + ADAM_EPS))

    def train_steps(self, n: int = 4, batch: int = 32):
        if len(self._buf_x) < 8:
            return
        rng = np.random.default_rng(self.t)
        for _ in range(n):
            idx = rng.integers(0, len(self._buf_x), min(batch, len(self._buf_x)))
            xs = torch.from_numpy(np.stack([self._buf_x[i] for i in idx]).astype(np.float32))
            ys = torch.from_numpy(np.array([self._buf_y[i] for i in idx], np.float32))
            self.t += 1
            self._adam_step(xs, ys)
