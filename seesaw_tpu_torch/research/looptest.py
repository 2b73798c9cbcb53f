"""Temperature-calibrated multiclass linear probe (research extra).

Counterpart of `seesaw_tpu/research/looptest.py` (the reference's
`seesaw/research/looptest.py:8-50`): logits are
(X @ normalize(W)ᵀ) · exp(log_temp) + b — a cosine classifier with a learned
per-class temperature — trained with cross-entropy, full batch, on the
module's device. `torch.optim.Adam` takes the three parameter groups at the
JAX package's learning rates (W: 1e-3, b: 5e-2, log_temp: 5e-3) and optax's
defaults (betas 0.9 / 0.999, eps 1e-8; optax's `adamw` with weight decay 0
is Adam). The epochs' losses stay on the device and are read once a fit.

The default W is drawn from a `torch.Generator` seeded with `seed`: JAX's
`jax.random.normal(PRNGKey(seed))` cannot be drawn without jax, so to
compute what the JAX package computes, carry its parameters across with
`TempRegression.from_params`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

LR_W, LR_B, LR_T = 1e-3, 5e-2, 5e-3


class TempRegressionParams(NamedTuple):
    W: np.ndarray  # (C, D)
    b: np.ndarray  # (C,)
    log_temps: np.ndarray  # (C,)


def init_params(in_features: int, out_classes: int, seed: int = 0,
                initial_weights: np.ndarray | None = None) -> TempRegressionParams:
    if initial_weights is not None:
        W = np.asarray(initial_weights, np.float32)
    else:
        gen = torch.Generator().manual_seed(seed)
        W = (torch.randn(out_classes, in_features, generator=gen)
             / np.sqrt(in_features)).numpy()
    return TempRegressionParams(W=W, b=np.zeros(out_classes, np.float32),
                                log_temps=np.zeros(out_classes, np.float32))


class TempRegression(torch.nn.Module):
    """Cosine classifier with learned per-class temperature, on `device`."""

    def __init__(self, in_features: int, out_classes: int,
                 initial_weights: np.ndarray | None = None, seed: int = 0, *, device):
        super().__init__()
        self.device = torch.device(device)
        p = init_params(in_features, out_classes, seed, initial_weights)
        self.W = torch.nn.Parameter(self._t(p.W))
        self.b = torch.nn.Parameter(self._t(p.b))
        self.log_temps = torch.nn.Parameter(self._t(p.log_temps))

    def _t(self, a) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    @staticmethod
    def from_params(params: TempRegressionParams, *, device) -> "TempRegression":
        """A module holding `params` (numpy W, b, log_temps; e.g. the JAX
        package's `TempRegression.params`, converted with np.asarray)."""
        W = np.asarray(params.W, np.float32)
        m = TempRegression(W.shape[1], W.shape[0], initial_weights=W, device=device)
        with torch.no_grad():
            m.b.copy_(m._t(params.b))
            m.log_temps.copy_(m._t(params.log_temps))
        return m

    def forward(self, X: torch.Tensor) -> torch.Tensor:
        Wn = self.W / torch.clamp_min(torch.linalg.norm(self.W, dim=1, keepdim=True), 1e-12)
        return (X @ Wn.T) * torch.exp(self.log_temps)[None, :] + self.b[None, :]

    def fit(self, X: np.ndarray, y: np.ndarray, epochs: int = 200) -> np.ndarray:
        """`epochs` full-batch Adam steps; returns each epoch's loss, taken
        before its update."""
        X = self._t(X)
        y = torch.as_tensor(np.asarray(y), dtype=torch.int64, device=self.device)
        opt = torch.optim.Adam([
            {"params": [self.W], "lr": LR_W},
            {"params": [self.b], "lr": LR_B},
            {"params": [self.log_temps], "lr": LR_T},
        ], betas=(0.9, 0.999), eps=1e-8)
        losses = torch.empty(epochs, device=self.device)
        for e in range(epochs):
            opt.zero_grad(set_to_none=True)
            loss = F.cross_entropy(self(X), y)
            loss.backward()
            opt.step()
            losses[e] = loss.detach()
        return losses.cpu().numpy()

    @property
    def params(self) -> TempRegressionParams:
        return TempRegressionParams(*(t.detach().cpu().numpy()
                                      for t in (self.W, self.b, self.log_temps)))

    def predict_logits(self, X: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self(self._t(X)).cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.predict_logits(X).argmax(axis=1)

    @property
    def temperatures(self) -> np.ndarray:
        return np.exp(self.params.log_temps)
