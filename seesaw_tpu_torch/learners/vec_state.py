"""SGD query-vector state with the sparse inversion-count rank gradient.

Reimplements the reference's `pairwise_rank_loss.py` path (the original
'pytorch'/OldSeesaw method's update rule): the gradient of the mean pairwise
hinge loss wrt the weight vector equals

    dL/dw = X^T (inversions * sign) / npairs

where inversions_i counts the misordered (pos, neg) pairs element i is part
of (computed by one sort + two cumulative sums over the hardest-pos..
hardest-neg window), and sign is -1 for positives / +1 for negatives.
One SGD step per feedback batch, optional renormalization.

The port's own copy of `seesaw_tpu/learners/vec_state.py` (numpy only).
"""
from __future__ import annotations

import numpy as np


def _positive_inversions(labs: np.ndarray) -> np.ndarray:
    return np.cumsum(~labs) * labs


def _negative_inversions(labs: np.ndarray) -> np.ndarray:
    rev = ~labs[::-1]
    return _positive_inversions(rev)[::-1]


def compute_inversions(labs: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Per-element count of misordered opposite-label pairs."""
    assert labs.shape == scores.shape and labs.ndim == 1
    labs = labs.astype(bool)
    desc = np.argsort(-scores)
    ordered = labs[desc]
    total = _positive_inversions(ordered) + _negative_inversions(ordered)
    return total[np.argsort(desc)]


def rank_loss_gradient(
    w: np.ndarray, X: np.ndarray, labels: np.ndarray, margin: float
) -> tuple[np.ndarray, float]:
    """(gradient, loss) of mean pairwise hinge loss at margin, using the
    hardest-window sparse trick (reference `RankAndLoss`)."""
    labels = labels == 1.0
    npos, nneg = int(labels.sum()), int((~labels).sum())
    npairs = npos * nneg
    if npairs == 0:
        return np.zeros_like(w), 0.0

    scores = X @ w
    scores = scores - margin * labels  # handicap positives by the margin
    desc = np.argsort(-scores)
    ordered_labels = labels[desc]

    neg_pos = np.nonzero(~ordered_labels)[0]
    pos_pos = np.nonzero(ordered_labels)[0]
    hardest_neg = int(neg_pos[0])
    hardest_pos = int(pos_pos[-1])
    if hardest_neg > hardest_pos:  # perfectly separated (with margin)
        return np.zeros_like(w), 0.0

    window = desc[hardest_neg : hardest_pos + 1]
    s, l, Xw = scores[window], labels[window], X[window]

    nl = ~l
    pos_inv = np.cumsum(nl) * l
    neg_inv = (l.sum() - np.cumsum(l)) * nl
    inversions = pos_inv + neg_inv

    pos_scores = s[l].reshape(-1, 1)
    neg_scores = s[~l].reshape(1, -1)
    loss = float(np.clip(-(pos_scores - neg_scores), 0, None).sum() / npairs)

    signs = -(l.astype(np.float64) * 2 - 1.0)
    coeffs = inversions * signs / npairs
    grad = Xw.T @ coeffs
    return grad.astype(w.dtype), loss


class VecState:
    """SGD-updated query vector (reference `VecState`,
    pairwise_rank_loss.py:153-178)."""

    def __init__(self, w: np.ndarray, *, margin: float, lr: float = 0.01,
                 renormalize: bool = False):
        w = np.asarray(w, dtype=np.float32).reshape(-1)
        self.w = w / np.linalg.norm(w)
        self.margin = margin
        self.lr = lr
        self.renormalize = renormalize

    def get_vec(self) -> np.ndarray:
        return self.w.copy()

    def update(self, vecs: np.ndarray, labels: np.ndarray) -> float:
        grad, loss = rank_loss_gradient(
            self.w, np.asarray(vecs, np.float32),
            np.asarray(labels, np.float32), self.margin,
        )
        self.w = self.w - self.lr * grad
        if self.renormalize:
            self.w = self.w / max(np.linalg.norm(self.w), 1e-12)
        return loss
