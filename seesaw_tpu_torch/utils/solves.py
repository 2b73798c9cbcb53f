"""Two LBFGS solves of one objective, compared step by step.

Two implementations of the same solve (the JAX package's and the port's, or
the port's on the card and on the CPU) evaluate the objective with sums in
another order, so its f32 values differ in their last bits. Most of the
time that moves nothing; but where a line search compares values that
differ only by rounding, the two solves may take a step differently, and
from there on their iterates part. That happens in three places:

- on the f32 floor: the objective has stopped changing in its last digits
  (within 8 ulps of the scale of its terms), so any step is a step along a
  flat direction;
- at a hinge kink: two scores of different targets lie within 8 ulps of
  each other, so rounding decides which side of the kink a point is on;
- a stalled search: one solve's line search found no decrease and stopped
  where the other found one (its own objective is lower at the other's
  next iterate): the rank probe's forward value is constant between order
  changes but for a small anchor term, so its searches compare values that
  differ by rounding.

`first_departure` runs both solves after k = 1, 2, ... iterations, holds
the iterates at the bar up to the first step where they part, and names
that place; a departure anywhere else is a fault. `trace_recorded_pair`
does so for two solves that `recording_solves` recorded, and
`explain_parting` for the solves of two runs of one session.
"""
from __future__ import annotations

import contextlib
import inspect
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)


def at_kink(scores: np.ndarray, target: np.ndarray) -> bool:
    """Two scores of different targets within 8 ulps of each other."""
    cross = target[:, None] != target[None, :]
    gap = np.abs(scores[:, None] - scores[None, :])[cross]
    return gap.size > 0 and gap.min() <= 8 * EPS32 * np.abs(scores).max()


def first_departure(
    solve_a: Callable[[int], tuple[np.ndarray, float, int]],
    solve_b: Callable[[int], tuple[np.ndarray, float, int]],
    fun_a: Callable[[np.ndarray], float],
    fun_b: Callable[[np.ndarray], float],
    *,
    x0: np.ndarray,
    max_iter: int,
    scale: float,
    kink: Optional[Callable[[np.ndarray], bool]] = None,
    rtol: float = 2e-4,
    atol: float = 2e-5,
) -> tuple[Optional[str], int]:
    """`solve_a(k)` / `solve_b(k)`: (x, f, n_iter) after at most k
    iterations from x0; `fun_a` / `fun_b`: each side's objective at a point.
    `scale` is the size of the objective's terms (e.g. the sum of its
    regularizers' weights), `kink(x)` tells whether x lies on a kink.
    Returns (None, k) when both solves end together at the bar after k
    steps, else ("floor" | "kink" | "stall", k) for a departure at step k;
    raises AssertionError for a departure anywhere else."""
    _, f_final, n_final = solve_a(max_iter)
    prev_a = prev_b = np.asarray(x0)
    for k in range(1, max_iter + 1):
        xa, _, _ = solve_a(k)
        xb, _, nb = solve_b(k)
        if not np.allclose(xb, xa, rtol=rtol, atol=atol):
            f_prev = fun_a(prev_a)
            if abs(f_prev - f_final) <= 8 * EPS32 * (abs(f_final) + scale):
                return "floor", k
            if kink is not None and kink(prev_a):
                return "kink", k
            a_stalled = np.array_equal(xa, prev_a) and fun_a(xb) < f_prev
            b_stalled = np.array_equal(xb, prev_b) and fun_b(xa) < fun_b(prev_b)
            if a_stalled or b_stalled:
                return "stall", k
            raise AssertionError(
                f"step {k}: the solves depart off the f32 floor ({f_prev!r} against "
                f"{f_final!r}), off any kink and with no stalled search")
        if k > n_final and nb < k:  # both solves ended, equal
            return None, k
        prev_a, prev_b = xa, xb
    return None, max_iter


class SolveRecord(NamedTuple):
    fun: Callable[[torch.Tensor], torch.Tensor]
    x0: torch.Tensor
    options: dict  # lbfgs_minimize's keyword arguments, defaults included
    result: object  # ops.lbfgs.LBFGSResult


@contextlib.contextmanager
def recording_solves():
    """Yield a list that receives a `SolveRecord` for every LBFGS solve the
    learners make while the context is open. `lbfgs_minimize` is wrapped
    where `learners.logistic_regression` and `learners.multi_reg` look it
    up; the solver itself is not touched."""
    from ..learners import logistic_regression, multi_reg
    from ..ops.lbfgs import lbfgs_minimize

    defaults = {k: p.default for k, p in inspect.signature(lbfgs_minimize).parameters.items()
                if p.kind is p.KEYWORD_ONLY}
    modules, rec = (logistic_regression, multi_reg), []
    prev = [m.lbfgs_minimize for m in modules]

    def recorder(solve):
        def recorded(fun, x0, **options):
            res = solve(fun, x0, **options)
            rec.append(SolveRecord(fun, x0, {**defaults, **options}, res))
            return res
        return recorded

    for m, solve in zip(modules, prev):
        m.lbfgs_minimize = recorder(solve)
    try:
        yield rec
    finally:
        for m, solve in zip(modules, prev):
            m.lbfgs_minimize = solve


def trace_recorded_pair(a, b, *, rtol: float = 2e-4, atol: float = 2e-5):
    """Hold two recorded solves of one objective (`SolveRecord`,
    e.g. one fit of a session on the card and the same fit on the CPU):
    (None, 0, err) when their results agree at the bar, else the departure
    `first_departure` names for them, with the results' largest difference
    `err`. The scale of the objective's terms is its value at the start
    point; no kink test (the objective's inputs are not known here)."""
    from ..ops.lbfgs import lbfgs_minimize

    xa, xb = (r.result.x.detach().cpu().numpy() for r in (a, b))
    err = float(np.abs(xa - xb).max(initial=0.0))
    if np.allclose(xb, xa, rtol=rtol, atol=atol):
        return None, 0, err

    def solver(r):
        def solve(k):
            res = lbfgs_minimize(r.fun, r.x0, **dict(r.options, max_iter=k))
            return res.x.cpu().numpy(), float(res.f), res.n_iter
        return solve

    def value(r):
        return lambda x: float(r.fun(torch.as_tensor(np.asarray(x, np.float32),
                                                     device=r.x0.device)))

    x0 = a.x0.detach().cpu().numpy()
    kind, step = first_departure(
        solver(a), solver(b), value(a), value(b), x0=x0,
        max_iter=a.options["max_iter"], scale=abs(value(a)(x0)), rtol=rtol, atol=atol)
    if kind is None:
        raise AssertionError(f"the traced solves agree, the recorded ones do not ({err!r})")
    return kind, step, err


def explain_parting(a_rounds, b_rounds, a_solves, b_solves, part: int) -> dict:
    """Two runs of one session of a fitted loop whose dbidxs part at round
    `part`. Each round is a dict whose "solves" is the (start, end) range of
    the `next` call's solves in its run's recorded list, and whose "refine"
    is None or a dict with the refine's range. Holds the solves pairwise
    (`trace_recorded_pair`, run a's against run b's), in order: each
    round's `next`, then its refine, up to the parting round's `next`. The
    first pair apart must depart on the f32 floor, at a kink or at a
    stalled search; a parting with every solve before it at the bar, or a
    departure anywhere else, fails."""
    if part >= min(len(a_rounds), len(b_rounds)):
        raise AssertionError(f"one session stopped at round {part}, the other did not")
    for i in range(part + 1):
        phases = [("next", a_rounds[i]["solves"], b_rounds[i]["solves"])]
        if i < part and a_rounds[i]["refine"] is not None:
            phases.append(("refine", a_rounds[i]["refine"]["solves"],
                           b_rounds[i]["refine"]["solves"]))
        for phase, (a0, a1), (b0, b1) in phases:
            if a1 - a0 != b1 - b0:
                raise AssertionError(f"round {i} {phase}: {a1 - a0} solves in one run, "
                                     f"{b1 - b0} in the other")
            for j in range(a1 - a0):
                kind, step, err = trace_recorded_pair(a_solves[a0 + j], b_solves[b0 + j])
                if kind is not None:
                    return dict(round=part, solve_round=i, phase=phase, departure=kind,
                                step=step, coeff_max_abs_diff=err)
    raise AssertionError(f"the sessions part at round {part} with every solve before it "
                         "at the bar")
