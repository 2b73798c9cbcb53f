"""Score calibration: Platt sigmoid fits.

The port's own copy of `seesaw_tpu/calibration.py` (numpy only):
`GroundTruthCalibrator` fits sigma(A*s + B) on ground truth (debug and
benchmark use only); `FixedCalibrator` applies fixed coefficients
sigma(a*(s+b)).
"""
from __future__ import annotations

import numpy as np


def _platt_fit(scores: np.ndarray, y: np.ndarray, n_iter: int = 200):
    """Newton fit of P(y=1|s) = sigma(A s + B) with Platt's target smoothing."""
    prior0 = float((y <= 0).sum())
    prior1 = float((y > 0).sum())
    t = np.where(y > 0, (prior1 + 1.0) / (prior1 + 2.0), 1.0 / (prior0 + 2.0))
    A, B = 0.0, np.log((prior0 + 1.0) / (prior1 + 1.0))
    for _ in range(n_iter):
        z = A * scores + B
        p = 1.0 / (1.0 + np.exp(-z))
        g = p - t
        gA, gB = float(g @ scores), float(g.sum())
        w = p * (1 - p) + 1e-12
        hAA = float((w * scores * scores).sum())
        hAB = float((w * scores).sum())
        hBB = float(w.sum())
        det = hAA * hBB - hAB * hAB
        if abs(det) < 1e-12:
            break
        dA = (hBB * gA - hAB * gB) / det
        dB = (hAA * gB - hAB * gA) / det
        A, B = A - dA, B - dB
        if max(abs(dA), abs(dB)) < 1e-10:
            break
    return A, B


def compute_calibrated_probabilities(scores: np.ndarray, a: float, b: float):
    """sigma(a*s + b), clipped into the OPEN unit interval: a saturated fit
    (Platt's A diverges on separable ground truth) yields exact 0.0/1.0 in
    f64, which downstream probability models reject — the reference's own
    LKNN assert notes this "could fail by chance ... fix properly by
    applying sigmoid" (`loops/LKNN_model.py:89`); clipping is that fix."""
    p = 1.0 / (1.0 + np.exp(-(a * scores + b)))
    return np.clip(p, 1e-7, 1.0 - 1e-7)


class GroundTruthCalibrator:
    """Fits a sigmoid from raw scores to ground-truth relevance. Debug only —
    lets benchmarks report probabilities a perfect calibrator would give."""

    def __init__(self, vectors: np.ndarray, y: np.ndarray):
        self.vectors = vectors
        self._y = np.asarray(y, dtype=np.float64)

    def get_probabilities(self, qvec: np.ndarray, vectors: np.ndarray = None) -> np.ndarray:
        """Fit sigma(A s + B) on the *training* scores (self.vectors @ q vs
        y), then apply to the inference vectors' scores — reference
        `calibration.py:35-42` fits on self.X and predicts on `vectors`."""
        q = np.asarray(qvec).reshape(-1)
        train_scores = self.vectors @ q
        a, b = _platt_fit(np.asarray(train_scores, np.float64), self._y)
        V = self.vectors if vectors is None else vectors
        return compute_calibrated_probabilities(V @ q, a, b)

    def get_mean(self) -> float:
        return float((self._y > 0).mean())

    def fit(self, scores: np.ndarray):
        return _platt_fit(np.asarray(scores, np.float64), self._y)


class FixedCalibrator:
    """sigma(a * (s + b)) with fixed coefficients (reference `calibration.py:
    44-57`); sigmoid=False passes a*(s+b) through raw."""

    def __init__(self, a: float, b: float, sigmoid: bool = True):
        self.a = a
        self.b = b
        self.sigmoid = sigmoid

    def get_probabilities(self, scores_or_qvec: np.ndarray, vectors: np.ndarray = None) -> np.ndarray:
        if vectors is not None:
            scores = vectors @ np.asarray(scores_or_qvec).reshape(-1)
        else:
            scores = np.asarray(scores_or_qvec)
        if self.sigmoid:
            # reference semantics sigma(a*(s+b)) == sigma(a*s + a*b);
            # clipped into the open interval (see
            # compute_calibrated_probabilities)
            return compute_calibrated_probabilities(
                scores, self.a, self.a * self.b
            )
        return self.a * (scores + self.b)
