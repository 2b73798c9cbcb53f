"""Efficient nonmyopic search planners over the LKNN model.

Counterpart of `seesaw_tpu/loops/ens_search.py`, two implementations:
- 'vectorized': the one-step-lookahead expected utility for all candidates
  through `ops.ens.ens_expected_value`, on `device` (the production path);
- 'loop': the generic branch-and-prune tree search with upper/lower-bound
  pruning (functional model conditioning), numpy: the reference semantics
  oracle, usable at small N.
Picks take the first maximum (`np.nanargmax`). The CEAS helpers (the
Negative-Poisson-Binomial expectation) are numpy copies.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.ens import ens_expected_value
from .lknn_model import LKNNModel


@dataclass
class Result:
    value: float
    index: int
    pruned_fraction: Optional[float] = None


def _expected_utility_approx(t: int, model: LKNNModel) -> Result:
    assert t > 0
    idxs, scores = model.top_k_remaining(top_k=t)
    return Result(value=float(scores.sum()), index=int(idxs[0]))


def _opt_expected_utility_helper(
    *, i: int, lookahead_limit: int, t: int, model: LKNNModel, pruning_on: bool
) -> Result:
    assert 0 <= i < lookahead_limit
    if i == lookahead_limit - 1:
        return _expected_utility_approx(t - i, model)

    idxs = model.dataset.remaining_indices().to_array().astype(np.int64)
    p1 = model.predict_proba(idxs)

    def solve_idx(idx):
        u0 = _opt_expected_utility_helper(
            i=i + 1, lookahead_limit=lookahead_limit, t=t,
            model=model.condition(idx, 0), pruning_on=pruning_on,
        )
        u1 = _opt_expected_utility_helper(
            i=i + 1, lookahead_limit=lookahead_limit, t=t,
            model=model.condition(idx, 1), pruning_on=pruning_on,
        )
        return np.array([u0.value, u1.value])

    pruned_fraction = 0.0
    if pruning_on:
        pbound = model.probability_bound(1)
        value_bound1 = 1 + (t - i) * pbound
        top_idxs, top_ps = model.top_k_remaining(top_k=(t - i))
        top_idx, pval = int(top_idxs[0]), float(top_ps[0])
        value_bound0 = float(top_ps.sum())
        upper = p1 * value_bound1 + (1 - p1) * value_bound0
        lower = solve_idx(top_idx) @ np.array([1 - pval, pval])
        keep_mask = upper >= lower
        pruned_fraction = 1.0 - keep_mask.mean()
        idxs = idxs[keep_mask]
        p1 = p1[keep_mask]

    probs = np.stack([1 - p1, p1], axis=1)
    values = np.zeros_like(probs)
    for j, idx in enumerate(idxs):
        values[j] = solve_idx(int(idx))
    expected = (probs * (values + np.array([0.0, 1.0]))).sum(axis=1)
    pos = int(np.argmax(expected))
    return Result(value=float(expected[pos]), index=int(idxs[pos]),
                  pruned_fraction=pruned_fraction)


def _vectorized_lookahead(model: LKNNModel, *, t: int, lookahead_limit: int,
                          device) -> Result:
    """One-step-lookahead over all candidates on `device`."""
    num = model.numerators + model.gamma
    den1 = model.denominators + 1.0
    seen = model.dataset.seen_indices.to_array().astype(np.int64)
    num = num.astype(np.float32)
    if seen.size:
        num[seen] = -np.inf
    scores = num / den1.astype(np.float32)

    if lookahead_limit == 1:
        best = int(np.nanargmax(scores))
        return Result(value=float(scores[best]), index=best, pruned_fraction=0.0)

    assert lookahead_limit == 2
    def dev(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(device)

    ev = ens_expected_value(
        dev(scores, np.float32), dev(num, np.float32), dev(den1, np.float32),
        dev(model.nbr, np.int32), K=t - 1,
    ).cpu().numpy()
    best = int(np.nanargmax(ev))
    return Result(value=float(ev[best]), index=best, pruned_fraction=0.0)


def efficient_nonmyopic_search(
    model: LKNNModel,
    *,
    reward_horizon: int,
    lookahead_limit: int,
    pruning_on: bool,
    implementation: str = "vectorized",
    device=None,
) -> Result:
    """The planner's pick; `device` is where the vectorized lookahead runs
    (the loop oracle runs in numpy)."""
    assert reward_horizon > 0
    assert 1 <= lookahead_limit <= 2
    assert lookahead_limit <= reward_horizon
    if implementation == "vectorized":
        if device is None:
            raise ValueError("the vectorized planner needs a device")
        return _vectorized_lookahead(model, t=reward_horizon,
                                     lookahead_limit=lookahead_limit, device=device)
    if implementation == "loop":
        return _opt_expected_utility_helper(
            i=0, lookahead_limit=lookahead_limit, t=reward_horizon,
            model=model, pruning_on=pruning_on,
        )
    raise ValueError(implementation)


# ---------------------------------------------------------------------------
# CEAS: cost-effective variant via the Negative-Poisson-Binomial expectation
# ---------------------------------------------------------------------------
def npb_expectation(r: int, desc_probs: np.ndarray) -> float:
    """E[#draws until r successes] when drawing in the given (descending-
    probability) order — 'accu_prime' interpolated estimate (reference
    `npb_distribution.py:31-48`)."""
    csum = np.cumsum(desc_probs)
    first_crossing = int((csum < r).sum())
    m = first_crossing + 1
    if m > desc_probs.shape[0]:
        return math.inf
    excess = csum[m - 1] - r
    adjustment = excess / desc_probs[m - 1]
    return float(m - adjustment)


def min_expected_cost_approx(
    r: int, *, t: int, model: LKNNModel, top_k: Optional[int] = None
) -> Result:
    """Expected cost (queries) to find r more positives, t-step planner
    (reference `cost_effective_active_search.py:19-43`)."""
    if t == 1:
        idxs, probs = model.top_k_remaining(top_k=len(model.dataset.remaining_indices()))
        cost = npb_expectation(r, probs)
        return Result(value=cost, index=int(idxs[0]))

    idxs, probs = model.top_k_remaining(top_k=top_k or 10)
    min_cost, min_idx = math.inf, None
    for idx, p in zip(idxs, probs):
        r1 = min_expected_cost_approx(r - 1, t=t - 1, model=model.condition(int(idx), 1),
                                      top_k=top_k)
        r0 = min_expected_cost_approx(r, t=t - 1, model=model.condition(int(idx), 0),
                                      top_k=top_k)
        c = p * r1.value + (1 - p) * r0.value
        if c < min_cost:
            min_cost, min_idx = c, int(idx)
    return Result(value=min_cost, index=min_idx)
