"""Logistic probe fit per feedback round, in PyTorch.

Counterpart of `seesaw_tpu/learners/logistic_regression.py`: the
cross-entropy probe (`LogisticRegression`: weighted binary cross-entropy
with balanced class weights) and the rank probe (`RankRegression`: the
sorted pairwise-rank loss of `ops.rank_loss.cheap_pairwise_rank_loss`, no
intercept), each with optional centering, the anchor regularizer
(|w| - 1)^2 + |w/|w| - q̂|^2 weighted by reg_lambda / n, warm starts, and
the LBFGS of `ops.lbfgs`.

The JAX version pads the labeled rows to power-of-two buckets to bound jit
recompiles; PyTorch runs eagerly, so the rows here are exactly the labeled
ones.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.lbfgs import lbfgs_minimize
from ..ops.rank_loss import cheap_pairwise_rank_loss


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _anchor_regularizer(w: torch.Tensor, qvec: Optional[torch.Tensor]):
    """(|w|-1)^2 + |ŵ - q̂|^2 with a smoothed norm (d|w|/dw is NaN at 0)."""
    norm = torch.sqrt(torch.sum(w * w) + 1e-12)
    penalty = (norm - 1.0) ** 2
    if qvec is None:
        return penalty
    return penalty + torch.sum((w / norm - qvec) ** 2)


def _ce_loss(Xc, y, sw, pos_weight, reg_weight, anchor, *, fit_intercept, mean_over):
    d = Xc.shape[1]

    def loss(params):
        w, b = params[:d], params[d]
        logits = Xc @ w + (b if fit_intercept else 0.0)
        per = _softplus(-logits) * y * pos_weight + _softplus(logits) * (1.0 - y)
        data = (per * sw).sum() / mean_over
        return data + reg_weight * _anchor_regularizer(w, anchor)

    return loss


def _rank_loss(Xc, y, reg_weight, anchor, *, fit_intercept):
    d = Xc.shape[1]

    def loss(params):
        w, b = params[:d], params[d]
        logits = Xc @ w + (b if fit_intercept else 0.0)
        data = cheap_pairwise_rank_loss(y, logits).sum()
        return data + reg_weight * _anchor_regularizer(w, anchor)

    return loss


def _fit_ce_rows(
    V: torch.Tensor,  # (N, D) index matrix, f32/bf16/int8
    row_scale: Optional[torch.Tensor],  # (N,) int8 dequant scales or None
    prows: torch.Tensor,  # (n,) int64 padded-layout rows
    y: torch.Tensor,  # (n,) f32
    sample_w: torch.Tensor,  # (n,) f32
    pos_weight: float,
    reg_weight: float,
    anchor: Optional[torch.Tensor],  # normalized anchor or None
    params0: torch.Tensor,  # (D+1,)
    *,
    fit_intercept: bool,
    max_iter: int,
    center: bool,
):
    """Serving-path fit on the index's device: row gather (+ int8 dequant),
    centering and the LBFGS solve. Returns (LBFGSResult, mu)."""
    X = V[prows].to(torch.float32)
    if row_scale is not None:
        X = X * row_scale[prows][:, None]
    n = X.shape[0]
    mu = X.sum(dim=0) / n if center else torch.zeros(X.shape[1], device=X.device)
    loss = _ce_loss(
        X - mu, y, sample_w, pos_weight, reg_weight, anchor,
        fit_intercept=fit_intercept, mean_over=float(n),
    )
    return lbfgs_minimize(loss, params0, max_iter=max_iter, history=10), mu


class LogisticRegression:
    """Weighted-BCE linear probe. `device` is where fits on host arrays run;
    fits over an index's rows run on the index's device."""

    loss_kind = "ce"

    def __init__(
        self,
        *,
        device,
        scale: Optional[str] = "centered",
        reg_lambda: float = 1.0,
        regularizer_vector: Optional[np.ndarray] = None,
        fit_intercept: bool = True,
        class_weights="balanced",
        max_iter: int = 100,
        **_unused,
    ):
        assert scale in ("centered", None)
        self.device = torch.device(device)
        self.scale = scale
        self.reg_lambda = reg_lambda
        self.fit_intercept = fit_intercept
        self.class_weights = class_weights
        self.max_iter = max_iter
        self.mu_: Optional[np.ndarray] = None
        self.params_: Optional[np.ndarray] = None  # warm start
        if regularizer_vector is not None:
            v = np.asarray(regularizer_vector, dtype=np.float32).reshape(-1)
            self.anchor_ = v / max(np.linalg.norm(v), 1e-12)
        else:
            self.anchor_ = None

    # -- shared argument preparation ----------------------------------------
    def _pos_weight(self, y: np.ndarray) -> float:
        if self.class_weights == "balanced":
            npos = max(int((y == 1).sum()), 1)
            nneg = max(int((y == 0).sum()), 1)
            return nneg / npos
        return float(self.class_weights or 1.0)

    def _params0(self, d: int) -> np.ndarray:
        if self.params_ is not None and self.params_.shape[0] == d + 1:
            return self.params_  # warm start
        if self.anchor_ is not None:
            # cold start AT the anchor: w = 0 is a stall point of the
            # anchor regularizer (see the JAX version)
            return np.concatenate([self.anchor_, np.zeros(1)]).astype(np.float32)
        return np.zeros(d + 1, dtype=np.float32)

    def _sample_weights(self, n, sample_weights) -> np.ndarray:
        if sample_weights is None:
            return np.ones(n, dtype=np.float32)
        return np.asarray(sample_weights, dtype=np.float32).reshape(-1)

    def _tensor(self, a, device) -> torch.Tensor:
        return torch.tensor(np.asarray(a, np.float32), device=device)

    # -- fits -----------------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray, sample_weights: Optional[np.ndarray] = None):
        X = np.asarray(X, dtype=np.float32)
        y = np.asarray(y, dtype=np.float32).reshape(-1)
        n, d = X.shape
        if self.scale == "centered":
            self.mu_ = X.mean(axis=0)
            X = X - self.mu_
        else:
            self.mu_ = np.zeros(d, dtype=np.float32)
        dev = self.device
        anchor = self._tensor(self.anchor_, dev) if self.anchor_ is not None else None
        if self.loss_kind == "ce":
            sw = self._sample_weights(n, sample_weights)
            loss = _ce_loss(
                self._tensor(X, dev), self._tensor(y, dev), self._tensor(sw, dev),
                self._pos_weight(y), self.reg_lambda / n, anchor,
                fit_intercept=self.fit_intercept, mean_over=float(n),
            )
        else:  # the rank loss takes no sample weights, as in the JAX package
            loss = _rank_loss(self._tensor(X, dev), self._tensor(y, dev),
                              self.reg_lambda / n, anchor,
                              fit_intercept=self.fit_intercept)
        res = lbfgs_minimize(
            loss, self._tensor(self._params0(d), dev),
            max_iter=self.max_iter, history=10,
        )
        if res.diverged:
            raise ValueError("regression training diverged (nan/inf loss)")
        self.params_ = res.x.cpu().numpy()
        return self

    def fit_rows(self, index, rows, y, sample_weights=None):
        """Fit over INDEX rows: on the index's device when it has no host
        mirror (the cross-entropy probe), through `fit` on the rows'
        vectors otherwise."""
        rows = np.asarray(rows, dtype=np.int64)
        if getattr(index, "vectors", None) is not None or self.loss_kind != "ce":
            return self.fit(index.vectors_for_rows(rows), y, sample_weights)
        dv = self.deferred_fit_rows(index, rows, y, sample_weights)
        res, mu = index.fit_deferred_logistic(dv)
        if res.diverged:
            raise ValueError("regression training diverged (nan/inf loss)")
        self.params_ = res.x.cpu().numpy()
        self.mu_ = mu.cpu().numpy()
        return self

    def deferred_fit_rows(self, index, rows, y, sample_weights=None):
        """The fit's arguments as a DeferredVector: the index runs the fit
        inside its next query (`MultiscaleIndex._query_logistic`). Apply the
        returned 'fit' payload with `apply_fit_result` to keep warm starts."""
        from ..ops.frame_scoring import DeferredLogistic

        assert self.loss_kind == "ce"
        rows = np.asarray(rows, dtype=np.int64)
        y = np.asarray(y, dtype=np.float32).reshape(-1)
        n = rows.shape[0]
        d = index.dim
        assert n == y.shape[0] and n > 0
        anchor = (self.anchor_ if self.anchor_ is not None
                  else np.zeros(d, dtype=np.float32))
        return DeferredLogistic(
            prows=index.padded_row_ids(rows).astype(np.int64), y=y,
            sw=self._sample_weights(n, sample_weights),
            n_real=n, pos_weight=self._pos_weight(y),
            reg_weight=self.reg_lambda / n,
            anchor=np.asarray(anchor, np.float32),
            params0=np.asarray(self._params0(d), np.float32),
            fit_intercept=self.fit_intercept, max_iter=self.max_iter,
            has_anchor=self.anchor_ is not None,
            center=self.scale == "centered",
            model=self,
        )

    def apply_fit_result(self, fit: dict):
        if bool(fit["diverged"]):
            raise ValueError("regression training diverged (nan/inf loss)")
        self.params_ = np.asarray(fit["params"])
        self.mu_ = np.asarray(fit["mu"])

    # -- use ------------------------------------------------------------------
    def get_coeff(self) -> np.ndarray:
        assert self.params_ is not None
        return self.params_[:-1].copy()


class RankRegression(LogisticRegression):
    """Pairwise-rank-loss probe; no intercept and no class weights by
    default."""

    loss_kind = "rank"

    def __init__(self, **kwargs):
        kwargs.setdefault("fit_intercept", False)
        kwargs.setdefault("class_weights", None)
        super().__init__(**kwargs)
