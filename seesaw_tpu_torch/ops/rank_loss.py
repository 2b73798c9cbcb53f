"""Pairwise ranking losses and the O(n log n) sort-based gradient, in PyTorch.

Counterpart of `seesaw_tpu/ops/rank_loss.py`:

- dense O(n²) pairwise hinge and logistic losses (the multi-reg fit, where
  n is small per round);
- the fast zero-margin pairwise-rank gradient: for each element, the
  gradient of the summed hinge loss equals 2x its net reversal count, the
  displacement between its position in the (target, score)-lexicographic
  order and the (score, -target)-lexicographic ("anti-stable") order. Three
  sorts instead of an n x n matrix.

Torch has no `lexsort`: `_lexsort2` makes two stable sorts, the secondary
key first, which is the same permutation. `jax.ops.segment_sum` becomes a
`bincount`. Everything stays on the caller's device.
"""
from __future__ import annotations

import torch


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))  # jax.nn.softplus


def _t_ij(target: torch.Tensor) -> torch.Tensor:
    return torch.sign(target[:, None] - target[None, :])


def pairwise_rank_loss_matrix(target: torch.Tensor, scores: torch.Tensor, *, margin: float):
    """(n,n) hinge loss per ordered pair: max(0, margin - y_ij * s_ij) with
    y_ij = sign(t_i - t_j), s_ij = s_i - s_j; pairs with equal targets
    contribute 0 (their constant margin term is removed)."""
    t_ij = _t_ij(target)
    s_ij = scores[:, None] - scores[None, :]
    viol = margin - t_ij * s_ij
    # where(), not clamp or relu: the boundary pair (viol == 0) stays active
    # with gradient 1, the convention the sorted gradient's anti-stable
    # tie order depends on
    loss = torch.where(viol >= 0, viol, 0.0)
    return loss - margin * (t_ij == 0).to(loss.dtype)


def pairwise_logistic_loss_matrix(target: torch.Tensor, scores: torch.Tensor):
    """(n,n) logistic loss log(1 + exp(-s_ij * y_ij)) for pairs with
    different targets, 0 otherwise."""
    t_ij = _t_ij(target)
    s_ij = scores[:, None] - scores[None, :]
    return torch.where(t_ij != 0, _softplus(-s_ij * t_ij), 0.0)


def _pair_sums(loss, target, valid, return_max_inversions):
    comparable = (_t_ij(target) != 0).to(loss.dtype)
    if valid is not None:
        pair_ok = (valid[:, None] & valid[None, :]).to(loss.dtype)
        loss = loss * pair_ok
        comparable = comparable * pair_ok
    loss = loss.sum(dim=0)
    if return_max_inversions:
        return loss, comparable.sum(dim=0)
    return loss


def pairwise_rank_loss_sum(target, scores, *, margin: float,
                           return_max_inversions=False, valid=None):
    """Column-summed pairwise hinge loss. `valid` (bool) masks rows: pairs
    involving an invalid element contribute neither loss nor inversion
    counts."""
    return _pair_sums(pairwise_rank_loss_matrix(target, scores, margin=margin),
                      target, valid, return_max_inversions)


def pairwise_logistic_loss_sum(target, scores, *, return_max_inversions=False, valid=None):
    return _pair_sums(pairwise_logistic_loss_matrix(target, scores),
                      target, valid, return_max_inversions)


def _lexsort2(primary: torch.Tensor, secondary: torch.Tensor) -> torch.Tensor:
    """Indices sorting by primary asc, ties by secondary asc, stable."""
    by_secondary = torch.sort(secondary, stable=True).indices
    return by_secondary[torch.sort(primary[by_secondary], stable=True).indices]


def _inverse_permutation(p: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(p)
    inv[p] = torch.arange(p.shape[0], device=p.device)
    return inv


def quick_pairwise_gradient_parts(target: torch.Tensor, scores: torch.Tensor):
    """Gradient of the summed pairwise hinge loss at margin 0, by sorting.

    Returns (grads, max_reversals, total_pairs):
      grads: d/ds_i of sum_ij max(0, -y_ij s_ij), 2 x the net reversals
      max_reversals: per-element count of comparable pairs (other target)
      total_pairs: total ordered comparable pairs (n² - Σ group²)
    """
    n = target.shape[0]
    dev = target.device
    sindex = _lexsort2(target, scores)  # (target, score)-sorted order
    starget = target[sindex]
    sscores = scores[sindex]
    invsindex = _inverse_permutation(sindex)

    # anti-stable score sort: equal scores with unequal targets permute in
    # reverse, so boundary pairs still get gradient (the margin-0 hinge
    # subgradient convention)
    final_indices = _lexsort2(sscores, -starget)
    reverse_indices = _inverse_permutation(final_indices)
    net_reversals = (reverse_indices - torch.arange(n, device=dev)).to(torch.float32)

    # per-group counts of equal targets (groups are consecutive after sort)
    new_group = torch.ones(n, dtype=torch.int64, device=dev)
    new_group[1:] = (starget[1:] != starget[:-1]).to(torch.int64)
    group_id = torch.cumsum(new_group, 0) - 1
    counts = torch.bincount(group_id, minlength=n).to(torch.float32)
    elem_count = counts[group_id]
    max_reversals = n - elem_count
    total_pairs = n * n - torch.sum(counts * counts)
    return 2.0 * net_reversals[invsindex], max_reversals[invsindex], total_pairs


def _factor(total_pairs: torch.Tensor, normalized: bool) -> torch.Tensor:
    if not normalized:
        return torch.ones((), dtype=torch.float32, device=total_pairs.device)
    return torch.where(total_pairs > 0, 1.0 / torch.clamp(total_pairs, min=1.0), 1.0)


class _CheapPairwiseRankLoss(torch.autograd.Function):
    """Forward: |sorted gradient| x factor; backward: the sorted gradient
    itself (the JAX custom VJP)."""

    @staticmethod
    def forward(ctx, target, scores, normalized):
        grads, _, total_pairs = quick_pairwise_gradient_parts(target.detach(), scores.detach())
        factor = _factor(total_pairs, normalized)
        ctx.save_for_backward(grads, factor)
        return grads.abs() * factor

    @staticmethod
    def backward(ctx, g):
        grads, factor = ctx.saved_tensors
        return None, grads * factor * g, None


def cheap_pairwise_rank_loss(target: torch.Tensor, scores: torch.Tensor,
                             normalized: bool = True) -> torch.Tensor:
    """Per-element |gradient| of the zero-margin pairwise rank loss, whose
    backward is the true (sorted) gradient of the underlying hinge loss."""
    return _CheapPairwiseRankLoss.apply(target, scores, normalized)


def signed_inversions_matrix(target: torch.Tensor, scores: torch.Tensor, *, margin: float):
    """(n,n) ±1 matrix of margin violations."""
    t_ij = _t_ij(target)
    s_ij = scores[:, None] - scores[None, :] - margin * t_ij
    neg = (t_ij < 0) & (s_ij >= 0)
    pos = (t_ij > 0) & (s_ij <= 0)
    return pos.to(torch.float32) - neg.to(torch.float32)
