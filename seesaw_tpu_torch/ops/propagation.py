"""Label propagation as a Jacobi iteration over the padded adjacency.

Counterpart of `seesaw_tpu/ops/propagation.py`. One step is

    f <- (W f + lambda * prior) / (degree + lambda);  f[labeled] = label

stopping when max (f_new - f_old)^2 < epsilon or after max_iter steps. On
convergence the PRE-step iterate is returned, as the reference does (it
breaks out before `old_fvalues = new_fvalues`); only a run that does not
converge returns the last computed iterate. The steps run in `ops.spmv.
jacobi_step`: the CUDA kernel on the card, its plain version on the CPU.

Steps ping-pong between two buffers and keep their state on the device. A
segment of `dispatch_iters` steps is one `jacobi_step` call, which on the
card is one kernel launch that stops stepping once the run converges (the
counterpart of the JAX segment's `lax.while_loop`); the host then reads
(steps done, converged) once: `PropagationResult.host_reads` counts those
reads. The fused KnnProp2 round (`propagate_rank`) reads nothing itself;
its caller reads the iteration count and the flag together with the ranked
result.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.profiling import host_sync
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
        """Steps first .. first+steps-1 (step k reads buffer k % 2), one
        `jacobi_step` call. The steps executed before are exactly those
        asked for before, since a step after convergence is a no-op."""
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
        with host_sync("propagate"):
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
    tail,  # the index's ranking tail (`rank_tail.TailGraphs`)
    excluded, new_excluded_ids,  # incremental exclusion protocol
    *,
    reg_lambda: float,
    epsilon: float,
    stop_at: int,
    **rank,
):
    """The fused KnnProp2 round, counterpart of `propagate_rank_windowed`:
    scatter the clicks into the label state, run `stop_at` Jacobi steps (to
    convergence when that comes first), rank the propagated scores with
    `tail` (`rank` holds its options). Nothing is read from the device.
    When the run stops unconverged the ranking is over the partial iterate;
    the caller reads (n_iter, converged) from the packed result, resumes
    with `propagate` and ranks again (`MultiscaleIndex.
    _rank_deferred_propagation`). Returns (the packed (6k+3,) f64 result
    with n_iter and converged last, new exclusion mask, scores, labels,
    is_labeled)."""
    labels = labels0.clone()
    labels[new_ids] = new_vals
    is_labeled = is_labeled0.clone()
    with host_sync("upload.labeled"):  # a blocking copy of the True
        is_labeled[new_ids] = True
    run = _Run(nbr, w, degree, prior, labels, is_labeled, start,
               reg_lambda=reg_lambda, epsilon=epsilon)
    run.launch(0, stop_at)
    scores = run.select()
    packed, excluded = tail(scores, excluded, new_excluded_ids, run.state, **rank)
    return packed, excluded, scores, labels, is_labeled
