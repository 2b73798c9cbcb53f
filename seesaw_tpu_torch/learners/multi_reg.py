"""Multi-regularized per-round fit, the 'seesaw' method's learner, in PyTorch.

Counterpart of `seesaw_tpu/learners/multi_reg.py`: a single weight vector
(or a 2-head target/confusion pair) fit from the normalized query vector
with the 4-term loss

    L = label_loss + reg_data * w^T(XLX)w
               + reg_norm * (cosh(log w.w) - 1) + reg_query * (1 - w_hat.q_hat)/2

where label_loss is balanced weighted BCE or a max-inversion-normalized
pairwise rank/logistic loss, per-example weights are 1/(tiles in image),
and XLX is the trace-normalized graph-Laplacian quadratic form. The LBFGS is
`ops.lbfgs`, run on the learner's device (or, for a deferred round, on the
index's device inside the next query).

The JAX version pads the labeled rows to power-of-two buckets (weight 0,
pair-masked) to bound jit recompiles; PyTorch runs eagerly, so the rows
here are exactly the labeled ones and `valid` is None.

As in the JAX package, `pos_weight` is taken as a value only when it is a
Python float: anything else that is not "balanced", an int included, gives
1.0. The second head of `MultiRegFit` starts from the same numpy draw,
`np.random.default_rng(0)`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.lbfgs import lbfgs_minimize
from ..ops.rank_loss import pairwise_logistic_loss_sum, pairwise_rank_loss_sum
from ..utils.profiling import annotate


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.sum(v * v) + 1e-30)


def multi_reg_loss(
    w, X, y, sample_w, valid, qvec_hat, xlx,
    rank_loss_margin, pos_weight_value,
    reg_data_lambda, reg_norm_lambda, reg_query_lambda,
    *,
    label_loss_type: str,
    pos_weight_balanced: bool,
):
    """The 4-term 'seesaw' objective: label loss + cosh-log norm penalty +
    XLX data term + query-cosine term. `valid` (bool rows) or None."""
    logits = X @ w
    sw = sample_w
    pos_total = ((y == 1).to(torch.float32) * sw).sum()
    orig_sum = sw.sum()
    neg_total = orig_sum - pos_total

    if label_loss_type == "ce_loss":
        ce = _softplus(-logits) * y + _softplus(logits) * (1.0 - y)
        if pos_weight_balanced:
            pw = (neg_total + 1.0) / (pos_total + 1.0)
        else:
            pw = pos_weight_value
        sw2 = torch.where(y == 1, sw * pw, sw)
        sw2 = sw2 * orig_sum / torch.clamp(sw2.sum(), min=1e-30)
        loss_labels = (ce * sw2).sum()
    elif label_loss_type in ("pairwise_rank_loss", "pairwise_logistic_loss"):
        if label_loss_type == "pairwise_rank_loss":
            per_item, max_inv = pairwise_rank_loss_sum(
                y, logits, margin=rank_loss_margin,
                return_max_inversions=True, valid=valid,
            )
        else:
            per_item, max_inv = pairwise_logistic_loss_sum(
                y, logits, return_max_inversions=True, valid=valid
            )
        per_norm = per_item / torch.clamp(max_inv, min=1.0)
        have_both = (pos_total > 0) & (neg_total > 0)
        loss_labels = torch.where(have_both, (per_norm * sw).sum(), 0.0)
    else:
        raise ValueError(label_loss_type)

    w_hat = _normalize(w)
    ww = torch.clamp(w @ w, min=1e-30)
    loss_norm = reg_norm_lambda * (torch.cosh(torch.log(ww)) - 1.0)
    loss_datareg = reg_data_lambda * (w @ (xlx @ w))
    loss_queryreg = reg_query_lambda * (1.0 - w_hat @ qvec_hat) / 2.0
    return loss_labels + loss_norm + loss_datareg + loss_queryreg


def _pos_weight_value(pos_weight) -> float:
    return pos_weight if isinstance(pos_weight, float) else 1.0


def _sample_weights(n, sample_weights) -> np.ndarray:
    if sample_weights is None:
        return np.ones(n, dtype=np.float32)
    return np.asarray(sample_weights, dtype=np.float32).reshape(-1)


def _f32(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)


class RegFit:
    """The 4-term fit: `fit` on host rows runs on `device`; `deferred_fit_rows`
    packages the fit for the index's next query."""

    def __init__(
        self,
        *,
        device,
        xlx,
        qvec: np.ndarray,
        label_loss_type: str,
        rank_loss_margin: float = 0.0,
        pos_weight="balanced",
        reg_data_lambda: float,
        reg_norm_lambda: float,
        reg_query_lambda: float,
        max_iter: int = 100,
        verbose: bool = False,
        **_unused,
    ):
        """xlx: (D, D) numpy array or tensor (any device)."""
        assert label_loss_type in ("ce_loss", "pairwise_rank_loss", "pairwise_logistic_loss")
        q = np.asarray(qvec, dtype=np.float32).reshape(-1)
        nq = np.linalg.norm(q)
        assert nq > 0, "query vector must be nonzero"
        self.device = torch.device(device)
        self.qvec_hat = q / nq
        self.xlx = xlx
        self.label_loss_type = label_loss_type
        self.rank_loss_margin = float(rank_loss_margin)
        self.pos_weight = pos_weight
        self.reg_data_lambda = float(reg_data_lambda)
        self.reg_norm_lambda = float(reg_norm_lambda)
        self.reg_query_lambda = float(reg_query_lambda)
        self.max_iter = max_iter
        self.verbose = verbose
        self.coeff_: Optional[np.ndarray] = None

    def objective(self, X: torch.Tensor, y: torch.Tensor, sw: torch.Tensor):
        """The fit's loss as a function of w, over f32 tensors on one device
        (X's rows are centered here, like the reference)."""
        dev = X.device
        if X.shape[0] > 0:
            X = X - X.mean(dim=0, keepdim=True)
        qh, xlx = _f32(self.qvec_hat, dev), _f32(self.xlx, dev)
        pw = _pos_weight_value(self.pos_weight)

        def loss(w):
            return multi_reg_loss(
                w, X, y, sw, None, qh, xlx, self.rank_loss_margin, pw,
                self.reg_data_lambda, self.reg_norm_lambda, self.reg_query_lambda,
                label_loss_type=self.label_loss_type,
                pos_weight_balanced=self.pos_weight == "balanced",
            )

        return loss

    def solve(self, X: torch.Tensor, y: torch.Tensor, sw: torch.Tensor, *,
              deferred: bool = False):
        """LBFGS over `objective` from the query vector, on X's device.
        Returns (normalized coefficient, LBFGSResult). Its `fit.multireg`
        span counts the labelled rows, the iterations, the host reads and
        whether the fit runs inside the index's query (`deferred`)."""
        with annotate("fit.multireg", rows=int(X.shape[0]), deferred=int(deferred)) as sp:
            res = lbfgs_minimize(self.objective(X, y, sw), _f32(self.qvec_hat, X.device),
                                 max_iter=self.max_iter, history=10)
            sp.set(iters=res.n_iter, host_reads=res.host_syncs)
        return _normalize(res.x), res

    def fit(self, X: np.ndarray, y: np.ndarray, sample_weights: Optional[np.ndarray] = None):
        d = self.qvec_hat.shape[0]
        X = np.asarray(X, dtype=np.float32).reshape(-1, d)
        y = np.asarray(y, dtype=np.float32).reshape(-1)
        sw = _sample_weights(X.shape[0], sample_weights)
        dev = self.device
        coeff, res = self.solve(_f32(X, dev), _f32(y, dev), _f32(sw, dev))
        if res.diverged:
            raise ValueError("multi-reg fit diverged (nan/inf)")
        self.coeff_ = coeff.cpu().numpy()
        if self.verbose:
            print(f"reg fit loss={float(res.f):.5f}")
        return self

    def deferred_fit_rows(self, index, rows, y, sample_weights=None):
        """The fit as a DeferredVector: the index runs the labeled-row
        gather, the centering and the fit inside its next query, then the
        query over the fitted coefficient (`MultiscaleIndex._query_multireg`)."""
        from ..ops.frame_scoring import DeferredMultiReg

        rows = np.asarray(rows, dtype=np.int64)
        y = np.asarray(y, dtype=np.float32).reshape(-1)
        return DeferredMultiReg(
            prows=index.padded_row_ids(rows).astype(np.int64), y=y,
            sw=_sample_weights(rows.shape[0], sample_weights),
            model=self,
        )

    def get_coeff(self) -> np.ndarray:
        assert self.coeff_ is not None
        return self.coeff_.copy()


def two_head_loss(
    flat, X, ys, sample_w, valid, qvec_hat,
    reg_norm_lambda, reg_query_lambda,
):
    """The 2-head (target + confusion) objective: per-head BCE on
    normalized-head logits + soft cross-entropy among heads for rows with
    any label + cosh(log ||W_h||) norm penalty + query-angle anchors on both
    heads. `valid` (bool rows) or None."""
    d = X.shape[1]
    W = flat.reshape(2, d)
    Wn = W / torch.sqrt(torch.sum(W * W, dim=1, keepdim=True) + 1e-30)
    logits = X @ Wn.T  # (n, 2)

    # vertical: per-head BCE, summed over heads
    ce = _softplus(-logits) * ys + _softplus(logits) * (1.0 - ys)
    vertical_sum = ce.sum(dim=1) @ sample_w

    # horizontal: soft cross-entropy among heads for rows with any label
    near = ys.sum(dim=1)
    xent = -(ys * torch.log_softmax(logits, dim=1)).sum(dim=1)
    mask = near > 0
    if valid is not None:
        mask = mask & valid
    horizontal_sum = (torch.where(mask, xent, 0.0) * sample_w).sum()

    norms = torch.sqrt(torch.sum(W * W, dim=1) + 1e-30)
    loss_norm = reg_norm_lambda * (torch.cosh(torch.log(norms)) - 1.0).sum()
    loss_q1 = reg_query_lambda * (1.0 - Wn[0] @ qvec_hat) / 2.0
    loss_q2 = reg_query_lambda * (1.0 - Wn[1] @ qvec_hat) / 2.0
    return vertical_sum + horizontal_sum + loss_norm + loss_q1 + loss_q2


def _fit_two_head(X, ys, sample_w, valid, qvec_hat, W0, reg_norm_lambda,
                  reg_query_lambda, *, max_iter: int):
    d = X.shape[1]

    def loss_fn(flat):
        return two_head_loss(flat, X, ys, sample_w, valid, qvec_hat,
                             reg_norm_lambda, reg_query_lambda)

    res = lbfgs_minimize(loss_fn, W0.reshape(-1), max_iter=max_iter, history=10)
    W = res.x.reshape(2, d)
    return W / torch.sqrt(torch.sum(W * W, dim=1, keepdim=True) + 1e-30), res


class MultiRegFit:
    """Two-head (target + confusion-class) variant, fit on `device`."""

    def __init__(
        self,
        *,
        device,
        qvec: np.ndarray,
        reg_norm_lambda: float,
        reg_query_lambda: float,
        max_iter: int = 100,
        verbose: bool = False,
        **_unused,
    ):
        q = np.asarray(qvec, dtype=np.float32).reshape(-1)
        nq = np.linalg.norm(q)
        assert nq > 0
        self.device = torch.device(device)
        self.qvec_hat = q / nq
        self.reg_norm_lambda = float(reg_norm_lambda)
        self.reg_query_lambda = float(reg_query_lambda)
        self.max_iter = max_iter
        self.verbose = verbose
        self.W_: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray, ys: np.ndarray, sample_weights=None):
        d = self.qvec_hat.shape[0]
        X = np.asarray(X, dtype=np.float32).reshape(-1, d)
        ys = np.asarray(ys, dtype=np.float32)
        assert ys.ndim == 2 and ys.shape[1] == 2
        sw = _sample_weights(X.shape[0], sample_weights)
        if X.shape[0] > 0:
            X = X - X.mean(axis=0, keepdims=True)
        # near-query init for both heads, the JAX package's draw
        rng = np.random.default_rng(0)
        W0 = np.stack(
            [self.qvec_hat, self.qvec_hat + 0.01 * rng.normal(size=d).astype(np.float32)]
        )
        dev = self.device
        W, res = _fit_two_head(
            _f32(X, dev), _f32(ys, dev), _f32(sw, dev), None,
            _f32(self.qvec_hat, dev), _f32(W0, dev),
            self.reg_norm_lambda, self.reg_query_lambda, max_iter=self.max_iter,
        )
        if res.diverged:
            raise ValueError("two-head multi-reg fit diverged")
        self.W_ = W.cpu().numpy()
        return self

    def get_coeff(self) -> np.ndarray:
        assert self.W_ is not None
        return self.W_[0].copy()

    def get_confusion_vec(self) -> np.ndarray:
        assert self.W_ is not None
        return self.W_[1].copy()
