"""L-BFGS with a strong-Wolfe line search, run eagerly in PyTorch.

Counterpart of `seesaw_tpu/ops/lbfgs.py`, with the same algorithm step for
step: two-loop recursion over a circular history of m pairs, first-step
scaling min(1, 1/|g|_1), a bracket-then-bisection-zoom line search (at most
20 evaluations, fallback to the last trial point if it decreased f), and the
same tolerances. This is not `torch.optim.LBFGS`. Gradients come from
`torch.autograd`.

All arithmetic stays in f32 tensors on the caller's device, like the JAX
version; only the branch decisions come to the host. The JAX version runs as
one `lax.while_loop` on the device, so it never waits for the host; this one
reads one small tensor per line-search evaluation and per iteration
(`LBFGSResult.host_syncs` counts them).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.profiling import host_sync

_C1 = 1e-4
_C2 = 0.9
_MAX_LS = 20


class LBFGSResult(NamedTuple):
    x: torch.Tensor
    f: torch.Tensor
    n_iter: int
    converged: bool  # a stopping tolerance was reached
    diverged: bool  # NaN/inf encountered
    host_syncs: int  # device-to-host reads the solve made


class _Syncs:
    """Counts the host reads of one solve."""

    def __init__(self):
        self.n = 0

    def read(self, *flags: torch.Tensor) -> list[bool]:
        self.n += 1
        packed = torch.stack([f.reshape(()) for f in flags])
        with host_sync("lbfgs"):
            return [bool(v) for v in packed.tolist()]


def _value_and_grad(fun: Callable[[torch.Tensor], torch.Tensor]):
    def vg(x: torch.Tensor):
        x = x.detach().requires_grad_(True)
        with torch.enable_grad():
            f = fun(x)
            (g,) = torch.autograd.grad(f, x)
        return f.detach(), g.detach()

    return vg


def _strong_wolfe(vg, x, d, f0, g0, alpha0, syncs: _Syncs):
    """Step length along d meeting the strong Wolfe conditions (N&W alg.
    3.5/3.6, bisection zoom). Returns (alpha, f_new, g_new); alpha is 0 when
    no point decreased f."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    dphi0 = g0 @ d
    stage = 0  # 0 bracketing, 1 zoom
    a_lo, phi_lo, a_hi = zero, f0, zero
    a_prev, phi_prev = zero, f0
    a = alpha0
    alpha, f, g = zero, f0, g0
    done = False
    i = 0
    while not done and i < _MAX_LS:
        f_a, g_a = vg(x + a * d)
        dphi_a = g_a @ d
        curvature_ok = torch.abs(dphi_a) <= -_C2 * dphi0
        if stage == 0:
            armijo = (f_a > f0 + _C1 * a * dphi0) | ((f_a >= phi_prev) & (i > 0))
            fail, ok, up = syncs.read(armijo, curvature_ok, dphi_a >= 0)
            new_stage = 1 if (fail or up) else 0
            a_lo, phi_lo, a_hi = (a_prev, phi_prev, a) if fail else (a, f_a, a_prev)
            done = (not fail) and ok
            next_a = (0.5 * (a_lo + a_hi) if (done or new_stage == 1)
                      else torch.clamp(a * 2.0, max=1e8))
            stage = new_stage
        else:
            armijo = (f_a > f0 + _C1 * a * dphi0) | (f_a >= phi_lo)
            same_side = dphi_a * (a_hi - a_lo) >= 0
            fail, ok, same = syncs.read(armijo, curvature_ok, same_side)
            done = (not fail) and ok
            a_hi1 = a if fail else a_hi
            a_hi = a_lo if ((not fail) and same) else a_hi1
            if not fail:
                a_lo, phi_lo = a, f_a
            next_a = 0.5 * (a_lo + a_hi)
        a_prev, phi_prev = a, f_a
        if done:
            alpha, f, g = a, f_a, g_a
        else:
            a = next_a
        i += 1
    if done:
        return alpha, f, g
    # the search never met Wolfe: take the last trial point if it at least
    # decreased f, otherwise no step
    f_last, g_last = vg(x + a * d)
    (decreased,) = syncs.read(f_last < f0)
    if decreased:
        return a, f_last, g_last
    return zero, f0, g0


def lbfgs_minimize(
    fun: Callable[[torch.Tensor], torch.Tensor],
    x0: torch.Tensor,
    *,
    max_iter: int = 100,
    history: int = 10,
    tol_grad: float = 1e-5,
    tol_change: float = 1e-9,
) -> LBFGSResult:
    """Minimize `fun` (R^d -> R, built from differentiable torch ops) from
    `x0` (f32, on the device the solve runs on)."""
    m = history
    d = x0.shape[0]
    vg = _value_and_grad(fun)
    syncs = _Syncs()
    kw = dict(dtype=x0.dtype, device=x0.device)
    S = torch.zeros((m, d), **kw)
    Y = torch.zeros((m, d), **kw)
    rho = torch.zeros(m, **kw)
    head = n_hist = 0

    x = x0.detach()
    f, g = vg(x)
    done, diverged = syncs.read(
        g.abs().max() <= tol_grad, ~torch.isfinite(f) | ~torch.isfinite(g).all()
    )
    k = 0
    while not done and not diverged and k < max_iter:
        # two-loop recursion, newest pair first
        q = g
        alphas = [None] * m
        for i in range(n_hist):
            pos = (head - 1 - i) % m
            a_i = rho[pos] * (S[pos] @ q)
            q = q - a_i * Y[pos]
            alphas[pos] = a_i
        r = q
        if n_hist > 0:
            newest = (head - 1) % m
            ys = S[newest] @ Y[newest]
            yy = Y[newest] @ Y[newest]
            gamma = torch.where(yy > 0, ys / torch.clamp(yy, min=1e-30), 1.0)
            r = gamma * q
        for i in range(n_hist):
            pos = (head - n_hist + i) % m  # oldest -> newest
            b = rho[pos] * (Y[pos] @ r)
            r = r + (alphas[pos] - b) * S[pos]
        direction = -r
        (descent,) = syncs.read(direction @ g < 0)
        if not descent:  # fall back to steepest descent
            direction = -g
        if k == 0:
            alpha0 = torch.clamp(1.0 / torch.clamp(g.abs().sum(), min=1e-30), max=1.0)
        else:
            alpha0 = torch.ones((), **kw)
        alpha, f_new, g_new = _strong_wolfe(vg, x, direction, f, g, alpha0, syncs)

        step = alpha * direction
        y = g_new - g
        sy = step @ y
        update, done, diverged = syncs.read(
            sy > 1e-10,
            (g_new.abs().max() <= tol_grad) | (alpha == 0.0)
            | (step.abs().max() < tol_change),
            ~torch.isfinite(f_new) | ~torch.isfinite(g_new).all(),
        )
        if update:
            S[head] = step
            Y[head] = y
            rho[head] = 1.0 / torch.clamp(sy, min=1e-30)
            head = (head + 1) % m
            n_hist = min(n_hist + 1, m)
        x, f, g = x + step, f_new, g_new
        k += 1
    return LBFGSResult(x=x, f=f, n_iter=k, converged=done, diverged=diverged,
                       host_syncs=syncs.n)
