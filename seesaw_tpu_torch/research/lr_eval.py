"""Per-vector vs frame-pooled scorer evaluation (research extra).

Counterpart of `seesaw_tpu/research/lr_eval.py`, in the role of the
reference's `research/multiscale_lr_eval.py:14-107`: given a
labeled vector table (vectors, ys, dbidx), score with a query vector or a
probabilistic model, report average precision at tile granularity and with
max-pooling to frames, and compare zero-shot vs a trained logistic probe on
a train/test split — the study behind the multiscale-representation rows of
the paper's breakdown table. The probe is the port's
`learners.logistic_regression.LogisticRegression`, fitted on `device`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np


def get_scores(vec_or_model, X: np.ndarray) -> np.ndarray:
    if isinstance(vec_or_model, np.ndarray):
        return X @ vec_or_model.reshape(-1)
    if hasattr(vec_or_model, "predict_proba"):
        return np.asarray(vec_or_model.predict_proba(X)).reshape(-1)
    raise TypeError(f"cannot score with {type(vec_or_model)!r}")


def average_precision_score(ys: np.ndarray, scores: np.ndarray) -> float:
    """Area under the precision-recall step curve (sklearn convention:
    sum over recall increments of precision at each threshold)."""
    ys = np.asarray(ys, dtype=bool)
    order = np.argsort(-scores, kind="stable")
    ys = ys[order]
    scores_sorted = scores[order]
    npos = int(ys.sum())
    assert npos > 0, "need at least one positive"
    tp = np.cumsum(ys)
    precision = tp / np.arange(1, len(ys) + 1)
    recall = tp / npos
    # collapse tied scores to threshold boundaries (last index of each tie)
    boundary = np.ones(len(ys), dtype=bool)
    boundary[:-1] = scores_sorted[1:] != scores_sorted[:-1]
    precision, recall = precision[boundary], recall[boundary]
    drecall = np.diff(np.concatenate([[0.0], recall]))
    return float((precision * drecall).sum())


def get_metrics(dbidx: np.ndarray, ys: np.ndarray, scores: np.ndarray,
                frame_pooling: bool) -> dict:
    ys = np.asarray(ys, dtype=np.float64)
    if frame_pooling:
        import pandas as pd

        agg = (
            pd.DataFrame({"dbidx": dbidx, "scores": scores, "ys": ys})
            .groupby("dbidx")[["scores", "ys"]].max()
        )
        scores, ys = agg.scores.values, agg.ys.values
    return {
        "ap": average_precision_score(ys > 0, scores),
        "npos": int((ys > 0).sum()),
        "n": len(ys),
        "frame_pooling": frame_pooling,
    }


def eval_scorers(vectors: np.ndarray, ys: np.ndarray, dbidx: np.ndarray,
                 qvec: Optional[np.ndarray] = None,
                 train_frac: float = 0.5, seed: int = 0,
                 reg_lambda: float = 1.0, *, device) -> "pd.DataFrame":
    """Zero-shot (qvec) vs trained logistic probe, tile- and frame-level AP.
    The probe trains on a frame-disjoint split to avoid leakage."""
    import pandas as pd

    from ..learners.logistic_regression import LogisticRegression

    rng = np.random.default_rng(seed)
    frames = np.unique(dbidx)
    train_frames = set(
        rng.choice(frames, size=int(len(frames) * train_frac), replace=False).tolist()
    )
    is_train = np.array([d in train_frames for d in dbidx])

    rows = []
    scorers = {}
    if qvec is not None:
        scorers["zero_shot"] = np.asarray(qvec)
    lr = LogisticRegression(reg_lambda=reg_lambda, device=device)
    lr.fit(vectors[is_train], ys[is_train].astype(np.float32))
    scorers["logistic"] = lr

    test = ~is_train
    for name, scorer in scorers.items():
        scores = get_scores(scorer, vectors[test])
        for pooling in (False, True):
            m = get_metrics(dbidx[test], ys[test], scores, frame_pooling=pooling)
            rows.append(dict(scorer=name, **m))
    return pd.DataFrame(rows)
