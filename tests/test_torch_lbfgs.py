"""The port's eager strong-Wolfe LBFGS (`seesaw_tpu_torch.ops.lbfgs`)
against `seesaw_tpu.ops.lbfgs.lbfgs_minimize` on the logistic objective of
the LogReg2 probe, same numpy data and start point, on the CPU.

Tolerance: x within rtol 2e-4 / atol 2e-5, the bar the JAX package sets
between its own fit paths (tests/test_deferred_rocchio.py); f within rtol
1e-5.

Where a solve ends on the f32 floor (f no longer changes in its last
digit), the final line search compares f values equal up to rounding, and
the two frameworks' sums can decide that comparison differently: one takes
a last step along a flat direction (x moves ~1e-4, f does not), the other
stops. Those solves are held step for step up to that last step, and on f.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seesaw_tpu.learners.logistic_regression import _anchor_regularizer
from seesaw_tpu.ops.lbfgs import lbfgs_minimize as jax_lbfgs
from seesaw_tpu_torch.learners.logistic_regression import _ce_loss
from seesaw_tpu_torch.ops.lbfgs import lbfgs_minimize


def _problem(seed, n=60, d=16):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X -= X.mean(axis=0)
    w_true = rng.normal(size=d).astype(np.float32)
    y = (X @ w_true + 0.5 * rng.normal(size=n) > 0).astype(np.float32)
    anchor = w_true / np.linalg.norm(w_true)
    pos_weight = float(max((y == 0).sum(), 1) / max((y == 1).sum(), 1))
    return X, y, anchor.astype(np.float32), pos_weight


def _jax_loss(X, y, anchor, pos_weight, reg_weight, fit_intercept):
    d = X.shape[1]

    def loss(params):
        w, b = params[:d], params[d]
        logits = X @ w + (b if fit_intercept else 0.0)
        per = (jax.nn.softplus(-logits) * y * pos_weight
               + jax.nn.softplus(logits) * (1.0 - y))
        return per.sum() / X.shape[0] + reg_weight * _anchor_regularizer(w, anchor)

    return loss


def _solve_both(seed, fit_intercept, cold, max_iter):
    X, y, anchor, pos_weight = _problem(seed)
    d = X.shape[1]
    reg_weight = np.float32(5.0 / X.shape[0])
    x0 = (np.zeros(d + 1, np.float32) if cold
          else np.concatenate([anchor, [0.0]]).astype(np.float32))
    jl = _jax_loss(jnp.asarray(X), jnp.asarray(y), jnp.asarray(anchor),
                   jnp.float32(pos_weight), jnp.asarray(reg_weight), fit_intercept)
    want = jax.jit(functools.partial(jax_lbfgs, jl, max_iter=max_iter))(jnp.asarray(x0))
    tl = _ce_loss(torch.from_numpy(X), torch.from_numpy(y), torch.ones(X.shape[0]),
                  pos_weight, float(reg_weight), torch.from_numpy(anchor),
                  fit_intercept=fit_intercept, mean_over=float(X.shape[0]))
    return lbfgs_minimize(tl, torch.from_numpy(x0), max_iter=max_iter), want


@pytest.mark.parametrize("seed,fit_intercept", [(0, False), (1, True), (2, False), (3, True)])
def test_lbfgs_matches_jax_on_logistic(seed, fit_intercept):
    """Cold starts at w = 0, the regularizer's stall point (see the JAX
    learner): both stop after a few steps, at the same x."""
    got, want = _solve_both(seed, fit_intercept, cold=True, max_iter=50)
    assert not got.diverged and not bool(want.diverged)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(got.f), float(want.f), rtol=1e-5)
    assert got.host_syncs >= 2 * got.n_iter  # >= one read per step + per search


@pytest.mark.parametrize("seed,fit_intercept", [(9, True), (2, False)])
def test_lbfgs_warm_start_matches_jax_to_the_f32_floor(seed, fit_intercept):
    """Warm starts at the anchor end on the f32 floor (see the module
    docstring): the iterate before the last matches, and so does f."""
    full, want_full = _solve_both(seed, fit_intercept, cold=False, max_iter=50)
    assert full.n_iter == int(want_full.n_iter)
    np.testing.assert_allclose(float(full.f), float(want_full.f), rtol=1e-6)
    got, want = _solve_both(seed, fit_intercept, cold=False, max_iter=full.n_iter - 1)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=2e-4, atol=2e-5)


def test_lbfgs_quadratic_converges():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(8, 8)).astype(np.float32)
    H = torch.from_numpy(A @ A.T + 8 * np.eye(8, dtype=np.float32))
    b = torch.from_numpy(rng.normal(size=8).astype(np.float32))
    res = lbfgs_minimize(lambda x: 0.5 * x @ H @ x - b @ x, torch.zeros(8))
    assert res.converged and not res.diverged
    np.testing.assert_allclose(res.x.numpy(), torch.linalg.solve(H, b).numpy(),
                               rtol=1e-3, atol=1e-4)


def test_lbfgs_reports_divergence():
    res = lbfgs_minimize(lambda x: (x * float("nan")).sum(), torch.ones(4))
    assert res.diverged and res.n_iter == 0
