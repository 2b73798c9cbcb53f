"""SeeSaw's own method, `multi_reg`, in float64 plain PyTorch: the
benchmark's copy of the reference (the repo's tests hold the program to
`tests/plain_multi_reg.py`, the same method at a test's size). It imports
nothing of the program; its inputs are the benchmark's: the tile matrix, the
raw kNN lists, the text query vectors and the simulated user's labels.

Each round fits a query weight vector w from the normalised text vector q
by minimising, over the labelled tiles' rows X centred by their mean,

    L(w) = sum_i c_i CE(y_i, x_i.w) + l_data w'(X'LX / trace L)w
           + l_norm (cosh(log w'w) - 1) + l_query (1 - w.q / |w|) / 2

where L = D - W is the Laplacian of the raw forward lists symmetrised at
`knn_k` as `reference.Graph` does (every pair either row lists, once,
weighted exp(-distance / edist), no self pairs). A tile's weight is 1 /
(labelled tiles of its image); with `pos_weight` "balanced" the
positives' weights are scaled by (negatives' sum + 1) / (positives' sum +
1), then all of them so that they sum as before. The scan uses w / |w|.
Round 0 fits with no rows: the label term is 0.

Departures from upstream `seesaw/loops/multi_reg.py` (`RegModule`, the
loss at :125-134 and its LBFGS at :156), to stay independent of the code
under test: damped Newton from q with the exact Hessian (Cholesky of H + mu
I, mu raised from 0 until it factors) and a backtracking line search, to
|grad L| < 1e-10, where upstream and the program stop an LBFGS at a
tolerance; float64 throughout, where they fit in float32; the gradient and
the Hessian in closed form, not by autograd; log(1 + e^z) exactly; X'LX as
sum_i d_i x_i x_i' - sum_(a,b) w_ab (x_a x_b' + x_b x_a') over the pairs,
in chunks on the tiles' device.

`precision` "fp8" is the control: the rows (those of X'LX too) and the
text vector rounded to float8 e4m3, as `reference.dequantised` rounds them.
"""
from __future__ import annotations

import numpy as np
import torch

from . import reference as ref

F64 = ref.F64
CHUNK = 1 << 19  # rows or pairs summed at once: 2 GB of f64 rows at D = 512


def _rows(V, row_scale, ids, precision: str) -> torch.Tensor:
    return ref.dequantised(V, row_scale, ids, precision).to(F64)


def _query(q, precision: str) -> torch.Tensor:
    q = torch.as_tensor(q)
    if precision == "fp8":
        q = q.to(torch.float32).to(torch.float8_e4m3fn)
    return q.to(F64)


def symmetric_pairs(dst: torch.Tensor, dist: torch.Tensor, edist: float):
    """(a, b, w): every pair that either row of the raw lists (dst, dist)
    (n, k) names, once, with a < b and weight exp(-distance / edist)."""
    n, k = dst.shape
    src = torch.arange(n, device=dst.device).repeat_interleave(k)
    d = dst.reshape(-1).to(torch.int64)
    keep = src != d
    lo, hi = torch.minimum(src, d)[keep], torch.maximum(src, d)[keep]
    key, first = torch.unique(lo * n + hi, return_inverse=True)
    dd = torch.empty(key.numel(), dtype=F64, device=dst.device)
    dd.scatter_(0, first, dist.reshape(-1)[keep].to(F64))
    return key // n, key % n, torch.exp(-dd / edist)


def laplacian_form(V, row_scale, dst, dist, edist: float,
                   precision: str = "exact") -> torch.Tensor:
    """X'LX / trace(L) (D, D) of the stored tiles V."""
    n = V.shape[0]
    a, b, w = symmetric_pairs(dst, dist, edist)
    degree = torch.zeros(n, dtype=F64, device=V.device)
    degree.index_add_(0, a, w).index_add_(0, b, w)
    out = torch.zeros(V.shape[1], V.shape[1], dtype=F64, device=V.device)
    for lo in range(0, n, CHUNK):
        ids = torch.arange(lo, min(lo + CHUNK, n), device=V.device)
        X = _rows(V, row_scale, ids, precision)
        out += X.T @ (degree[ids, None] * X)
    cross = torch.zeros_like(out)
    for lo in range(0, a.numel(), CHUNK):
        sl = slice(lo, lo + CHUNK)
        cross += (_rows(V, row_scale, a[sl], precision) * w[sl, None]).T @ _rows(
            V, row_scale, b[sl], precision)
    out = out - cross - cross.T
    return (out + out.T) / 2 / degree.sum()


def balanced_weights(y: torch.Tensor, sw: torch.Tensor) -> torch.Tensor:
    """The label term's weight of each row under pos_weight "balanced"."""
    pos = (sw * (y == 1)).sum()
    total = sw.sum()
    scaled = torch.where(y == 1, sw * (total - pos + 1) / (pos + 1), sw)
    return scaled * total / scaled.sum() if scaled.numel() else scaled


class Objective:
    """L(w) of one round, with its gradient and Hessian."""

    def __init__(self, X, y, sw, q, A, *, reg_data_lambda: float, reg_norm_lambda: float,
                 reg_query_lambda: float):
        X = X.to(F64)
        self.X = X - X.mean(dim=0, keepdim=True) if X.shape[0] else X
        self.y = y.to(F64)
        self.c = balanced_weights(self.y, sw.to(F64))
        q = q.to(F64)
        self.q = q / q.norm()
        self.A = A.to(F64)
        self.ld, self.ln, self.lq = reg_data_lambda, reg_norm_lambda, reg_query_lambda

    def value(self, w: torch.Tensor) -> float:
        z = self.X @ w
        zero = torch.zeros_like(z)
        label = (self.c * (self.y * torch.logaddexp(zero, -z)
                           + (1 - self.y) * torch.logaddexp(zero, z))).sum()
        s = w @ w
        return float(label + self.ld * (w @ self.A @ w) + self.ln * ((s + 1 / s) / 2 - 1)
                     + self.lq * (1 - (w @ self.q) / s.sqrt()) / 2)

    def gradient(self, w: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(self.X @ w)
        s = w @ w
        r = s.sqrt()
        return (self.X.T @ (self.c * (p - self.y)) + 2 * self.ld * (self.A @ w)
                + self.ln * (1 - 1 / s**2) * w
                - self.lq / 2 * (self.q / r - (w @ self.q) * w / r**3))

    def hessian(self, w: torch.Tensor) -> torch.Tensor:
        p = torch.sigmoid(self.X @ w)
        s = w @ w
        r = s.sqrt()
        eye = torch.eye(w.numel(), dtype=F64, device=w.device)
        wq = w @ self.q
        outer = torch.outer(self.q, w)
        return (self.X.T @ ((self.c * p * (1 - p))[:, None] * self.X)
                + 2 * self.ld * self.A
                + self.ln * ((1 - 1 / s**2) * eye + 4 / s**3 * torch.outer(w, w))
                + self.lq / 2 * ((outer + outer.T + wq * eye) / r**3
                                 - 3 * wq * torch.outer(w, w) / r**5))


def newton_direction(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """-(H + mu I)^-1 g for the least mu in 0, 1e-12 s, 2e-12 s, ... (s the
    largest diagonal entry) at which H + mu I has a Cholesky factor."""
    eye = torch.eye(H.shape[0], dtype=H.dtype, device=H.device)
    mu, step = 0.0, 1e-12 * float(H.diagonal().abs().max())
    while True:
        factor, info = torch.linalg.cholesky_ex(H + mu * eye)
        if int(info) == 0:
            return -torch.cholesky_solve(g[:, None], factor)[:, 0]
        mu, step = mu + step, step * 2


def minimise(obj: Objective, w0: torch.Tensor, *, tol: float = 1e-10,
             max_steps: int = 200) -> tuple[torch.Tensor, int]:
    """Damped Newton from w0 until |grad| < tol: (w, steps). A step is
    halved until it meets Armijo's condition, or, once f has reached its
    float64 floor, until it lowers |grad|."""
    w = w0.to(F64).clone()
    f = obj.value(w)
    for step in range(max_steps):
        g = obj.gradient(w)
        gnorm = float(g.norm())
        if gnorm < tol:
            return w, step
        d = newton_direction(obj.hessian(w), g)
        slope = float(g @ d)
        t = 1.0
        while True:
            w_new = w + t * d
            f_new = obj.value(w_new)
            if f_new <= f + 1e-4 * t * slope:
                break
            if (abs(f_new - f) <= 1e-14 * max(abs(f), 1.0)
                    and float(obj.gradient(w_new).norm()) < gnorm):
                break
            t /= 2
            if t < 1e-20:
                raise RuntimeError(f"the line search failed at |grad| {gnorm:.3g}")
        w, f = w_new, f_new
    raise RuntimeError(f"no convergence in {max_steps} Newton steps")


def labelled(inputs, frames, accepted, user_box, precision: str = "exact"):
    """(X, y, sw) of a session's labels so far, as the program's query
    reads them (`reference.labelled_rows`): every tile of every frame shown,
    y = 1 where the frame was accepted and the tile's box overlaps the
    user's box, sw = 1 / (labelled tiles of its frame)."""
    pos, neg = ref.labelled_rows(frames, accepted, inputs.tile_boxes, user_box)
    rows = np.concatenate([pos, neg]).astype(np.int64)
    y = torch.cat([torch.ones(pos.size, dtype=F64), torch.zeros(neg.size, dtype=F64)])
    _, inverse, counts = np.unique(rows // inputs.tiles, return_inverse=True,
                                   return_counts=True)
    sw = torch.as_tensor(1.0 / counts[inverse], dtype=F64)
    dev = inputs.V.device
    X = _rows(inputs.V, inputs.row_scale, torch.as_tensor(rows, device=dev), precision)
    return X, y.to(dev), sw.to(dev)


def fit(X, y, sw, q, A, options: dict, precision: str = "exact") -> torch.Tensor:
    """One round's fitted vector, normalised: X the labelled rows (m, D),
    y their labels, sw their weights, q the text vector, A = X'LX / trace L,
    `options` the method's settings (the three lambdas)."""
    obj = Objective(X, y, sw, _query(q, precision).to(A.device), A,
                    reg_data_lambda=float(options["reg_data_lambda"]),
                    reg_norm_lambda=float(options["reg_norm_lambda"]),
                    reg_query_lambda=float(options["reg_query_lambda"]))
    w, _ = minimise(obj, obj.q)
    return w / w.norm()
