"""Vectorized one-step-lookahead ENS utility, in PyTorch.

Counterpart of `seesaw_tpu/ops/ens.py`: for every candidate vertex i, the
expected number of positives collected over the next K steps if i is
queried now,

    E[i] = p_i * (1 + Σ top-K scores | y_i=1) + (1-p_i) * (Σ top-K scores | y_i=0)

where conditioning on y_i updates only i's neighbours. Per candidate the
conditional top-K is assembled from the global top-(K+D) list (with i itself
and i's updated neighbours masked) plus i's updated neighbour scores. Rows
run in blocks of `block_size`, bounding memory at block_size x (K+2D), on
the inputs' device. Plain torch ops, as the JAX version is plain XLA.

The global list's ties go to the lower index first, as `jax.lax.top_k`
orders them (`ops.frame_scoring.topk_first`): its ids decide which entries
are masked. -inf slots (fewer than K finite candidates) contribute 0.

Candidates whose E differ by an f32 rounding are common (gamma is constant
up to a 1e-6 jitter), and the planner takes the first maximum, so the
rounding is the JAX package's own on every device: the top-K sums add left
to right, as XLA's reduction loop does, and the last line is one rounding of
p * (1 + e1) + ((1 - p) * e0), the fused multiply-add that XLA emits there
(the f32 product is exact in f64).
"""
from __future__ import annotations

import torch

from .frame_scoring import NEG_INF, topk_first


def ens_expected_value(
    scores: torch.Tensor,  # (N,) current scores, seen = -inf
    num: torch.Tensor,  # (N,) numerators + gamma (seen = -inf)
    den1: torch.Tensor,  # (N,) denominators + 1
    nbr: torch.Tensor,  # (N, D) int, -1 padding
    *,
    K: int,
    block_size: int = 1024,
) -> torch.Tensor:
    N, D = nbr.shape
    kk = min(K + D, N)
    top_scores, top_ids = topk_first(scores, kk)
    nbr = nbr.long()
    out = torch.empty(N, dtype=torch.float32, device=scores.device)
    for lo in range(0, N, block_size):
        i = torch.arange(lo, min(lo + block_size, N), device=scores.device)
        n = nbr[i]  # (B, D)
        n_safe = n.clamp(0, N - 1)

        new_den = den1[n_safe] + 1.0
        s_upd1 = (num[n_safe] + 1.0) / new_den
        s_upd0 = num[n_safe] / new_den
        self_or_pad = (n < 0) | (n == i[:, None])
        s_upd1 = torch.where(self_or_pad, NEG_INF, s_upd1)
        s_upd0 = torch.where(self_or_pad, NEG_INF, s_upd0)

        # copy of the global top list with overwritten entries masked
        is_self = top_ids[None, :] == i[:, None]  # (B, kk)
        in_nbrs = (top_ids[None, :, None] == n[:, None, :]).any(dim=2)
        top_copy = torch.where(is_self | in_nbrs, NEG_INF,
                               top_scores.expand(i.shape[0], kk))

        def cond_sum(s_upd):
            allscores = torch.cat([top_copy, s_upd], dim=1)
            best = torch.topk(allscores, min(K, allscores.shape[1]), dim=1).values
            best = torch.where(torch.isfinite(best), best, 0.0)
            acc = best[:, 0]
            for j in range(1, best.shape[1]):
                acc = acc + best[:, j]
            return acc

        e1 = cond_sum(s_upd1)
        e0 = cond_sum(s_upd0)
        p = scores[i]
        c = (1.0 - p) * e0
        ev = (p.double() * (1.0 + e1).double() + c.double()).float()
        out[i] = torch.where(torch.isfinite(p), ev, NEG_INF)
    return out
