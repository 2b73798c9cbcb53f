"""Label propagation as a Jacobi iteration over the padded adjacency.

Counterpart of `seesaw_tpu/ops/propagation.py`. One step is

    f <- (W f + lambda * prior) / (degree + lambda);  f[labeled] = label

stopping when max (f_new - f_old)^2 < epsilon or after max_iter steps. On
convergence the PRE-step iterate is returned, as the reference does (it
breaks out before `old_fvalues = new_fvalues`); only a run that does not
converge returns the last computed iterate. Each step is `ops.spmv.
jacobi_step`: the CUDA kernel on the card, its plain version on the CPU.

Steps ping-pong between two buffers and keep their state on the device, so
the host launches a segment of `dispatch_iters` steps and then reads
(steps done, converged) once: `PropagationResult.host_reads` counts those
reads. The fused KnnProp2 round (`propagate_rank`) reads nothing itself;
its caller reads the iteration count and the flag together with the ranked
result.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .frame_scoring import NEG_INF, rank_frames_from_scores_incr
from .spmv import DONE, ITERS, jacobi_step, new_state


class PropagationResult(NamedTuple):
    scores: torch.Tensor
    n_iter: int
    converged: bool
    host_reads: int  # device -> host reads the run made (one per segment)


class _Run:
    """The device state of one Jacobi run: f0 in buffer 0, the step state,
    and the per-row terms that stay fixed across steps."""

    def __init__(self, nbr, w, degree, prior, labels, is_labeled, start, *,
                 reg_lambda: float, epsilon: float):
        lam = float(reg_lambda)
        denom = degree + lam
        self.denom = torch.where(denom > 0, denom, torch.ones_like(denom))
        self.lam_prior = lam * prior
        f0 = torch.where(is_labeled, labels, start).to(torch.float32).contiguous()
        self.bufs = (f0, torch.empty_like(f0))
        self.state = new_state(f0.device)
        self.graph = (nbr, w)
        self.labels, self.is_labeled = labels, is_labeled
        self.epsilon = float(epsilon)

    def launch(self, first: int, steps: int):
        """Steps first .. first+steps-1 (step k reads buffer k % 2). The
        steps executed before are exactly those launched before, since a
        step after convergence is a no-op."""
        nbr, w = self.graph
        jacobi_step(self.bufs[first % 2], self.bufs[(first + 1) % 2], nbr, w,
                    self.denom, self.lam_prior, self.labels, self.is_labeled,
                    self.state, self.epsilon, steps)

    def select(self) -> torch.Tensor:
        """On the device, without a read: after i steps f = buffer i % 2 and
        the pre-step iterate the other; converged runs return the latter."""
        done = self.state[DONE] != 0
        in_one = ((self.state[ITERS] % 2) == 1) ^ done
        return torch.where(in_one, self.bufs[1], self.bufs[0])


def propagate(
    nbr: torch.Tensor,  # (N, Kp) int32, -1 padding
    w: torch.Tensor,  # (N, Kp) f32
    degree: torch.Tensor,  # (N,)
    prior: torch.Tensor,  # (N,) regularization targets
    labels: torch.Tensor,  # (N,) label values (meaningful where labeled)
    is_labeled: torch.Tensor,  # (N,) bool
    start: torch.Tensor,  # (N,) initial scores
    *,
    reg_lambda: float,
    max_iter: int = 300,
    epsilon: float = 1e-5,
    dispatch_iters: Optional[int] = None,
) -> PropagationResult:
    """Jacobi propagation in segments of at most `dispatch_iters` steps, one
    host read of (steps, done) per segment; the iterates equal one unbroken
    run's."""
    run = _Run(nbr, w, degree, prior, labels, is_labeled, start,
               reg_lambda=reg_lambda, epsilon=epsilon)
    c = max_iter if not dispatch_iters else min(dispatch_iters, max_iter)
    i, done, reads = 0, False, 0
    while True:
        run.launch(i, min(c, max_iter - i))
        i, done = (int(x) for x in run.state[[ITERS, DONE]].tolist())
        reads += 1
        if done or i >= max_iter:
            break
    scores = run.bufs[(i + 1) % 2] if done else run.bufs[i % 2]
    return PropagationResult(scores=scores, n_iter=i, converged=done, host_reads=reads)


class DeferredPropagation:
    """Round-deferred label propagation for the graph loop's serving path.

    `LabelPropagationRanker2.update` stages the round's clicks instead of
    propagating; `current_scores_any()` hands this marker to
    `MultiscaleIndex.rank_by_scores`, which runs click scatter -> Jacobi
    propagation -> ranking tail as one fused round (`propagate_rank`), with
    one host read for the ranked result and the convergence info."""

    def __init__(self, ranker):
        self.ranker = ranker


def propagate_rank(
    nbr, w, degree, prior,  # graph and prior, on the index's device
    labels0, is_labeled0,  # (N,) persistent ranker label state
    new_ids, new_vals,  # the round's clicks: (P,) int64 vertex ids, (P,) f32
    start,  # (N,) start iterate (the prior, or the last scores with warm start)
    pad_rows,  # (F*T,) exact row per padded row, or None when they coincide
    valid, boxes, zoom,  # ranking-tail index arrays
    excluded, new_excluded_ids,  # incremental exclusion protocol
    *,
    reg_lambda: float,
    epsilon: float,
    stop_at: int,
    shortlist_size: int,
    topk: int,
    aug_larger: str,
    aug_weight: str,
    agg_method: str,
    max_zoom: int,
):
    """The fused KnnProp2 round, counterpart of `propagate_rank_windowed`:
    scatter the clicks into the label state, run `stop_at` Jacobi steps (to
    convergence when that comes first), rank the propagated scores. Nothing
    is read from the device. When the run stops unconverged the ranking is
    over the partial iterate; the caller reads (n_iter, converged), resumes
    with `propagate` and ranks again (`MultiscaleIndex.
    _rank_deferred_propagation`). Returns (QueryResult, new exclusion mask,
    scores, labels, is_labeled, n_iter, converged), the last two as device
    scalars."""
    labels = labels0.clone()
    labels[new_ids] = new_vals
    is_labeled = is_labeled0.clone()
    is_labeled[new_ids] = True
    run = _Run(nbr, w, degree, prior, labels, is_labeled, start,
               reg_lambda=reg_lambda, epsilon=epsilon)
    run.launch(0, stop_at)
    scores = run.select()
    res, excluded = rank_padded(
        scores, pad_rows, valid, boxes, zoom, excluded, new_excluded_ids,
        shortlist_size=shortlist_size, topk=topk, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method, max_zoom=max_zoom,
    )
    return (res, excluded, scores, labels, is_labeled, run.state[ITERS],
            run.state[DONE] != 0)


def rank_padded(scores, pad_rows, valid, boxes, zoom, excluded, new_excluded_ids, **kw):
    """Ranking tail over exact-layout (N,) scores: into the frame-major
    padded layout (a gather when the index's rows are ragged), invalid rows
    at -inf, then `frame_scoring.rank_frames_from_scores_incr`."""
    s = scores if pad_rows is None else scores[pad_rows]
    s_pad = torch.where(valid.reshape(-1), s, NEG_INF)
    return rank_frames_from_scores_incr(s_pad, valid, boxes, zoom, excluded,
                                        new_excluded_ids, **kw)
