"""Ranking metrics for benchmark sessions.

The port's own copy of `seesaw_tpu/metrics.py` (the reference's
`seesaw/metrics.py:8-137`): truncated average precision, DCG/nDCG against
the best achievable ordering, and batched rank-of-kth. Host-side numpy —
these run over per-session hit lists (tiny arrays).
"""
from __future__ import annotations

import numpy as np


def average_precision(
    hit_indices: np.ndarray,
    *,
    npositive: int,
    max_results: int | None = None,
    average_reciprocal_gap: bool = False,
) -> float:
    """Mean precision at each newly found positive, 0 for positives never found.

    ``hit_indices`` are 0-based positions (within the seen sequence) at which
    positives appeared, ascending. Results past ``max_results`` are treated as
    not found, for comparability across runs.
    """
    assert npositive > 0
    if max_results is None:
        max_results = npositive
    max_results = min(npositive, max_results)

    hit_indices = np.asarray(hit_indices)[:max_results]
    ranks = hit_indices + 1

    denominators = np.full(max_results, np.inf)
    if average_reciprocal_gap:
        padded = np.concatenate([np.zeros(1), ranks])
        gaps = padded[1:] - padded[:-1]
        numerator = 1.0
        denominators[: hit_indices.shape[0]] = gaps
    else:
        numerator = np.arange(max_results) + 1
        denominators[: hit_indices.shape[0]] = ranks

    return float(np.mean(numerator / denominators))


def average_reciprocal_gap(*args, **kwargs) -> float:
    return average_precision(*args, **kwargs, average_reciprocal_gap=True)


def dcg_score(hit_indices: np.ndarray) -> float:
    weights = 1.0 / np.log2(np.asarray(hit_indices) + 2)
    return float(weights.sum())


def best_possible_hits(nseen: int, npositive: int) -> np.ndarray:
    return np.arange(min(npositive, nseen))


def ndcg_score(hit_indices: np.ndarray, *, nseen: int, npositive: int) -> float:
    best = best_possible_hits(nseen, npositive)
    return dcg_score(hit_indices) / dcg_score(best)


def normalizedAP(
    hit_indices: np.ndarray, *, nseen: int, npositive: int, max_results: int | None = None
) -> float:
    best = best_possible_hits(nseen, npositive)
    best_ap = average_precision(best, npositive=npositive, max_results=max_results)
    return (
        average_precision(hit_indices, npositive=npositive, max_results=max_results)
        / best_ap
    )


def rank_of_kth(hit_indices: np.ndarray, *, ntotal: int, k: int):
    """1-based rank at which the k-th positive was found; inf if not found;
    None when k exceeds the number of positives in the database."""
    if k > ntotal:
        return None
    if hit_indices.shape[0] < k:
        return np.inf
    return int(hit_indices[k - 1] + 1)


def rank_kth(hit_indices: np.ndarray, *, ntotal: int, ks: np.ndarray) -> np.ndarray:
    """Batched :func:`rank_of_kth`: inf = not found, nan = not applicable."""
    hit_indices = np.asarray(hit_indices)
    ks = np.asarray(ks)
    ans = np.ones_like(ks, dtype=float)
    ans[ks > hit_indices.shape[0]] = np.inf
    found = ks <= hit_indices.shape[0]
    ans[found] = hit_indices[ks[found] - 1] + 1
    ans[ks > ntotal] = np.nan
    return ans


def compute_metrics(
    *, hit_indices: np.ndarray, batch_size: int, nseen: int, ntotal: int, max_results: int | None
) -> dict:
    hit_indices = np.asarray(hit_indices)
    ap = average_precision(hit_indices, npositive=ntotal, max_results=max_results)
    ndcg = ndcg_score(hit_indices, nseen=nseen, npositive=ntotal)
    rank_first, rank_second, rank_third, rank_tenth = rank_kth(
        hit_indices, ntotal=ntotal, ks=np.array([1, 2, 3, 10])
    )
    return dict(
        nfound=int(hit_indices.shape[0]),
        ndcg_score=ndcg,
        average_precision=ap,
        rank_first=rank_first,
        reciprocal_rank=1.0 / rank_first,
        rank_second=rank_second,
        rank_third=rank_third,
        rank_tenth=rank_tenth,
    )
