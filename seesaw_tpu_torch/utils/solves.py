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
that place; a departure anywhere else is a fault.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np

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
