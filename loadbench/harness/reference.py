"""The plain reference: what a click should show, in float64 PyTorch.

It follows the published method (github.com/orm011/seesaw: the multiscale
frame ranking with its zoom-level augmentation, the Rocchio update, the kNN
label propagation) and imports nothing of the program under test. Its
inputs are the benchmark's own: the tile matrix and layout, the raw kNN
lists, the text query vectors and the simulated user's labels. Every
intermediate (dequantised rows, frame maxima, augmented scores, the Rocchio
vector, the symmetrised graph, the propagated scores) is worked out here
again.

`precision` selects the arithmetic: "exact" is float64 on the stored
values; the controls put the reference in the program's place one step
below the configuration's precision: "fp8" rounds bf16 vectors and queries
to float8 e4m3 (f32 sums), "int4" rounds int8 values and the queries to 4
bits (f32 sums); either propagates in bfloat16.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

F64 = torch.float64
ROW_CHUNK = 1 << 19


def dequantised(V: torch.Tensor, row_scale, rows=None, precision: str = "exact"):
    """Rows of the tile matrix as stored values (int8 times its row's
    scale), f64 ("exact") or f32 rounded per the control's `precision`."""
    v = V if rows is None else V[rows]
    s = None if row_scale is None else (row_scale if rows is None else row_scale[rows])
    if precision == "exact":
        out = v.to(F64)
        return out if s is None else out * s.to(F64)[:, None]
    if precision == "fp8":
        return v.to(torch.float8_e4m3fn).to(torch.float32)
    if precision == "int4":
        q = torch.clamp(torch.round(v.to(torch.float32) * (7.0 / 127.0)), -7, 7)
        return q * (s.to(torch.float32)[:, None] * (127.0 / 7.0))
    raise ValueError(f"unknown precision {precision!r}")


def _query_values(Q: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "exact":
        return Q.to(F64)
    if precision == "fp8":
        return Q.to(torch.float32).to(torch.float8_e4m3fn).to(torch.float32)
    if precision == "int4":
        qmax = Q.abs().amax(dim=1, keepdim=True)
        return torch.clamp(torch.round(Q / qmax * 7.0), -7, 7) * (qmax / 7.0)
    raise ValueError(f"unknown precision {precision!r}")


def tile_scores(V, row_scale, Q: torch.Tensor, precision: str = "exact") -> torch.Tensor:
    """(n, q) scores of every tile for q queries (Q (q, D)), in row chunks."""
    q = _query_values(Q.to(V.device), precision)
    out = torch.empty(V.shape[0], Q.shape[0], dtype=q.dtype, device=V.device)
    for lo in range(0, V.shape[0], ROW_CHUNK):
        rows = torch.arange(lo, min(lo + ROW_CHUNK, V.shape[0]), device=V.device)
        out[lo:lo + rows.numel()] = dequantised(V, row_scale, rows, precision).to(q.dtype) @ q.T
    return out


def augmentation_matrix(boxes: np.ndarray, zoom: np.ndarray) -> np.ndarray:
    """(T, T) matrix A of one frame's zoom-level augmentation: the augmented
    score of tile i is (A @ tile scores)[i]. Tile i joins every tile j of its
    frame whose box overlaps its own (IoU > 0); at each zoom level it takes
    the joined tile of highest IoU (the first on ties) and averages the
    levels that have one."""
    T = boxes.shape[0]
    x1 = np.maximum(boxes[:, None, 0], boxes[None, :, 0])
    y1 = np.maximum(boxes[:, None, 1], boxes[None, :, 1])
    x2 = np.minimum(boxes[:, None, 2], boxes[None, :, 2])
    y2 = np.minimum(boxes[:, None, 3], boxes[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    union = area[:, None] + area[None, :] - inter
    iou = np.where(union > 0, inter / np.where(union > 0, union, 1), 0.0)
    A = np.zeros((T, T))
    for i in range(T):
        picks = []
        for lvl in sorted(set(zoom.tolist())):
            cand = [j for j in range(T) if zoom[j] == lvl and iou[i, j] > 0]
            if cand:
                picks.append(max(cand, key=lambda j: (iou[i, j], -j)))
        for j in picks:
            A[i, j] += 1.0 / len(picks)
    return A


class Ranker:
    """The frame ranking of one click over per-tile scores: each frame's
    maximum tile score, the excluded frames left out, a shortlist of the
    best frames by it, each shortlisted frame scored by its best augmented
    tile, and the best of those shown."""

    def __init__(self, tile_boxes: np.ndarray, tile_zoom: np.ndarray, *, shortlist: int,
                 topk: int, device):
        self.T = tile_boxes.shape[0]
        self.A = torch.tensor(augmentation_matrix(tile_boxes, tile_zoom), dtype=F64,
                              device=device)
        self.shortlist, self.topk = shortlist, topk

    def frame_scores(self, s: torch.Tensor, frames: torch.Tensor) -> torch.Tensor:
        """Augmented scores of `frames` from tile scores s (n,)."""
        t = s.view(-1, self.T)[frames].to(F64)  # (k, T)
        return (t @ self.A.T).amax(dim=1)

    def rank(self, s: torch.Tensor, excluded: torch.Tensor):
        """(shortlisted frames, their augmented scores sorted best first,
        the frames shown) for tile scores s (n,) and an (F,) exclusion
        mask."""
        fmax = s.view(-1, self.T).amax(dim=1)
        fmax = torch.where(excluded, torch.tensor(float("-inf"), dtype=fmax.dtype,
                                                  device=fmax.device), fmax)
        k = min(self.shortlist, int((~excluded).sum()))
        short = torch.topk(fmax, k).indices
        aug = self.frame_scores(s, short)
        order = torch.argsort(aug, descending=True, stable=True)
        return short[order], aug[order], short[order][: self.topk]


def rank_gap(ranker: Ranker, s: torch.Tensor, excluded: torch.Tensor, shown,
             margin: int = 10) -> float:
    """How far the shown frames fall below the reference's choice, in units
    of the mean step between the reference's shortlisted frames: for the
    frame shown at position r, the r-th best augmented score among the
    frames the reference shortlists surely (all but the last `margin`, where
    rounding may move the shortlist's edge) minus the shown frame's, over
    the mean step; the largest of these, and 0 when every shown frame is as
    good as the reference's."""
    short, aug, _ = ranker.rank(s, excluded)
    sure = torch.topk(s.view(-1, ranker.T).amax(dim=1).masked_fill(excluded, float("-inf")),
                      max(1, short.numel() - margin)).indices
    best = torch.sort(ranker.frame_scores(s, sure), descending=True).values
    shown_t = torch.as_tensor(np.asarray(shown, dtype=np.int64), device=s.device)
    got = ranker.frame_scores(s, shown_t)
    step = float(aug[0] - aug[-1]) / max(aug.numel() - 1, 1)
    k = min(best.numel(), got.numel())
    worst = float((best[:k] - got[:k]).clamp(min=0).max()) if k else 0.0
    if worst == 0.0:
        return 0.0
    return worst / step if step > 0 else float("inf")


def labelled_rows(frames, accepted, tile_boxes: np.ndarray, user_box) -> tuple:
    """(positive rows, negative rows) of the labelled frames: a tile of an
    accepted frame is positive when its box overlaps the user's box, every
    other tile of a seen frame is negative."""
    b = np.asarray(user_box, dtype=np.float64)
    ix = np.clip(np.minimum(tile_boxes[:, 2], b[2]) - np.maximum(tile_boxes[:, 0], b[0]), 0, None)
    iy = np.clip(np.minimum(tile_boxes[:, 3], b[3]) - np.maximum(tile_boxes[:, 1], b[1]), 0, None)
    hit = (ix * iy) > 0
    T = tile_boxes.shape[0]
    pos, neg = [], []
    for f, a in zip(frames, accepted):
        for t in range(T):
            (pos if (a and hit[t]) else neg).append(int(f) * T + t)
    return np.asarray(pos, dtype=np.int64), np.asarray(neg, dtype=np.int64)


def rocchio(q0, V, row_scale, pos, neg, alpha, beta, gamma, precision="exact"):
    """alpha * q0 + beta * mean(positive rows) - gamma * mean(negative rows)."""
    dev = V.device

    def mean(rows):
        if len(rows) == 0:
            return torch.zeros(V.shape[1], dtype=F64, device=dev)
        r = torch.as_tensor(rows, device=dev)
        return dequantised(V, row_scale, r, precision).to(F64).mean(dim=0)

    q = torch.as_tensor(q0, dtype=F64, device=dev)
    return alpha * q + beta * mean(pos) - gamma * mean(neg)


class Graph:
    """The undirected kNN graph of the raw lists (dst, dist) (n, k): every
    pair that either row lists, once, weighted exp(-distance / edist), no
    self edges; the degree of a row is its weights' sum."""

    def __init__(self, dst: torch.Tensor, dist: torch.Tensor, edist: float):
        n, k = dst.shape
        dev = dst.device
        src = torch.arange(n, device=dev).repeat_interleave(k)
        d = dst.reshape(-1).to(torch.int64)
        keep = src != d
        lo, hi = torch.minimum(src, d)[keep], torch.maximum(src, d)[keep]
        dd = dist.reshape(-1)[keep].to(F64)
        key, first = torch.unique(lo * n + hi, return_inverse=True)
        dist_u = torch.empty(key.numel(), dtype=F64, device=dev).scatter_(0, first, dd)
        a, b = key // n, key % n
        w = torch.exp(-dist_u / edist)
        src, col, w = torch.cat([a, b]), torch.cat([b, a]), torch.cat([w, w])
        order = torch.argsort(src, stable=True)
        crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        crow[1:] = torch.cumsum(torch.bincount(src, minlength=n), 0)
        with warnings.catch_warnings():  # "beta state", unchecked invariants
            warnings.simplefilter("ignore", UserWarning)
            self.W = torch.sparse_csr_tensor(crow, col[order], w[order], size=(n, n))
            self.W32 = torch.sparse_csr_tensor(crow, col[order], w[order].float(),
                                               size=(n, n))
        self.n, self.edges = n, int(src.numel())
        self.degree = torch.zeros(n, dtype=F64, device=dev).index_add_(0, src, w)

    def apply(self, f: torch.Tensor) -> torch.Tensor:
        """W f: in f64 for f64 iterates; a lower precision's iterates are
        summed in f32 and rounded back."""
        if f.dtype == F64:
            return self.W @ f
        return (self.W32 @ f.to(torch.float32)).to(f.dtype)


def prior(s: torch.Tensor, norm_eps: float, calib_a: float, calib_b: float):
    """The propagation's prior from base scores: affinely mapped into
    (eps, 1 - eps), then sigmoid(calib_a * (x + calib_b))."""
    s = s.to(F64)
    lo, hi = s.min(), s.max()
    x = (s - lo) / (hi - lo) * (1 - 2 * norm_eps) + norm_eps
    return torch.sigmoid(calib_a * (x + calib_b))


def propagate(graph: Graph, prior_s: torch.Tensor, labels: torch.Tensor,
              is_labelled: torch.Tensor, *, lam: float, eps: float, max_iter: int,
              dtype=F64):
    """Jacobi label propagation from the prior: f <- (W f + lam * prior) /
    (degree + lam) with labelled rows held at their label, until the largest
    squared step falls below eps; the iterate before that step is the
    answer (the last iterate if it never does). Returns (the answer with
    the iterates a step before and after it, where they exist; the
    answer; the steps taken)."""
    p = prior_s.to(dtype)
    lab = labels.to(dtype)
    denom = graph.degree.to(dtype) + lam
    f, prev = torch.where(is_labelled, lab, p), None
    for step in range(1, max_iter + 1):
        new = torch.where(is_labelled, lab, (graph.apply(f) + lam * p) / denom)
        if float(((new - f) ** 2).max()) < eps:
            return [x for x in (prev, f, new) if x is not None], f, step
        prev, f = f, new
    return [x for x in (prev, f) if x is not None], f, max_iter
