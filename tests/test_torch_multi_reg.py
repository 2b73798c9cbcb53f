"""The port's multi-reg learner (`seesaw_tpu_torch.learners.multi_reg`) and
rank probe against the JAX package's, on the CPU, on the same seeded numpy
inputs, in two stages:

1. the objectives at fixed points: value and gradient of `multi_reg_loss`
   (ce, pairwise rank and pairwise logistic losses; balanced and float
   `pos_weight`; with and without a row mask) and of `two_head_loss`,
   against `jax.value_and_grad`: rtol 1e-5 (atol 1e-6 for gradient entries
   near 0; f32 sums in another order);
2. the fitted coefficients of `RegFit`, `MultiRegFit` and `RankRegression`
   (LBFGS over those objectives, step for step the same algorithm):
   rtol 2e-4 / atol 2e-5, the bar the session tests use for LogReg2.

Where the two fits depart, the solves are traced step by step on the same
objective (LBFGS after k = 1, 2, ... iterations in each package,
`seesaw_tpu_torch.utils.solves.first_departure`): every step before the
departure is held at the bar, and the departure must come where f32
rounding alone decides a line search: on the objective's f32 floor, at a
hinge kink, or at a stalled search of the rank probe (that module says
which is which). Such departures are listed in ROADMAP.md queue 3 (`-s`
prints each with its size). The JAX side of a trace pads the rows as its
fit does.

Also: the deferred round on the port's index (gather + centering + fit
inside the query) equals the port's host fit of the same rows, and a
diverged deferred fit raises before the round publishes anything.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seesaw_tpu.indices.meta import VectorMeta
from seesaw_tpu.learners import RankRegression as JaxRank
from seesaw_tpu.learners import multi_reg as J
from seesaw_tpu.learners.logistic_regression import _anchor_regularizer
from seesaw_tpu.ops.lbfgs import lbfgs_minimize as jax_lbfgs
from seesaw_tpu.ops.rank_loss import cheap_pairwise_rank_loss
from seesaw_tpu_torch import convert
from seesaw_tpu_torch.indices.meta import VectorMeta as TMeta
from seesaw_tpu_torch.learners import RankRegression as TorchRank
from seesaw_tpu_torch.learners import multi_reg as T
from seesaw_tpu_torch.learners.logistic_regression import _rank_loss
from seesaw_tpu_torch.ops.lbfgs import lbfgs_minimize
from seesaw_tpu_torch.runtime.bitmap import BitMap
from seesaw_tpu_torch.utils.solves import at_kink, first_departure

FIT_TOL = dict(rtol=2e-4, atol=2e-5)
LOSSES = ["ce_loss", "pairwise_rank_loss", "pairwise_logistic_loss"]


def _data(seed, n=40, d=16):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    q = rng.normal(size=d).astype(np.float32)
    q /= np.linalg.norm(q)
    y = ((X @ q + 0.3 * rng.normal(size=n)) > 0.1).astype(np.float32)
    dbidx = rng.integers(0, n // 3, size=n)
    _, inv, cnt = np.unique(dbidx, return_inverse=True, return_counts=True)
    sw = (1.0 / cnt[inv]).astype(np.float32)
    A = rng.normal(size=(d, d)).astype(np.float32)
    xlx = (A @ A.T / d * 0.05).astype(np.float32)
    return X, y, sw, q, xlx, rng


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("pos_weight", ["balanced", 2.5])
@pytest.mark.parametrize("masked", [False, True])
def test_multi_reg_loss_value_and_grad_match_jax(loss, pos_weight, masked):
    X, y, sw, q, xlx, rng = _data(1)
    valid = rng.random(X.shape[0]) < 0.8 if masked else np.ones(X.shape[0], bool)
    X = X - X.mean(axis=0)
    args = (0.05, 2.5 if pos_weight != "balanced" else 1.0, 0.1, 10.0, 1.0)
    kw = dict(label_loss_type=loss, pos_weight_balanced=pos_weight == "balanced")
    for w in (q, q + 0.3 * rng.normal(size=q.shape[0]).astype(np.float32),
              0.2 * rng.normal(size=q.shape[0]).astype(np.float32)):
        want_f, want_g = jax.value_and_grad(
            lambda w_: J.multi_reg_loss(w_, jnp.asarray(X), jnp.asarray(y), jnp.asarray(sw),
                                        jnp.asarray(valid), jnp.asarray(q), jnp.asarray(xlx),
                                        *args, **kw))(jnp.asarray(w))
        wt = _t(w).clone().requires_grad_(True)
        got_f = T.multi_reg_loss(wt, _t(X), _t(y), _t(sw), _t(valid) if masked else None,
                                 _t(q), _t(xlx), *args, **kw)
        got_f.backward()
        np.testing.assert_allclose(float(got_f), float(want_f), rtol=1e-5)
        np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_two_head_loss_value_and_grad_match_jax(masked):
    X, y, sw, q, _, rng = _data(2)
    n, d = X.shape
    ys = np.stack([y, (rng.random(n) < 0.3).astype(np.float32) * (1 - y)], axis=1)
    ys[:5] = 0.0  # rows with no label
    valid = rng.random(n) < 0.8 if masked else np.ones(n, bool)
    for W in (np.stack([q, q + 0.01 * rng.normal(size=d).astype(np.float32)]),
              rng.normal(size=(2, d)).astype(np.float32)):
        want_f, want_g = jax.value_and_grad(
            lambda f: J.two_head_loss(f, jnp.asarray(X), jnp.asarray(ys), jnp.asarray(sw),
                                      jnp.asarray(valid), jnp.asarray(q), 10.0, 1.0))(
            jnp.asarray(W.reshape(-1)))
        ft = _t(W.reshape(-1)).clone().requires_grad_(True)
        got_f = T.two_head_loss(ft, _t(X), _t(ys), _t(sw), _t(valid) if masked else None,
                                _t(q), 10.0, 1.0)
        got_f.backward()
        np.testing.assert_allclose(float(got_f), float(want_f), rtol=1e-5)
        np.testing.assert_allclose(ft.grad.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-6)


def _check_departure(got, want, jax_fun, torch_fun, x0, scale, kink=None, max_iter=50):
    """`got`/`want`: the two packages' fitted coefficients. Passes when they
    agree at the bar; otherwise traces both LBFGS solves of the objective
    step by step (`utils.solves.first_departure`: every step before the
    first departure at the bar, the departure on the f32 floor, at a kink or
    at a stalled search). Returns the departure's kind, or None."""
    if np.allclose(got, want, **FIT_TOL):
        return None
    jsolve = jax.jit(lambda mi: jax_lbfgs(jax_fun, jnp.asarray(x0), max_iter=mi, history=10))

    def solve_jax(k):
        r = jsolve(jnp.int32(k))
        return np.asarray(r.x), float(r.f), int(r.n_iter)

    def solve_torch(k):
        r = lbfgs_minimize(torch_fun, torch.from_numpy(np.asarray(x0)), max_iter=k, history=10)
        return r.x.numpy(), float(r.f), r.n_iter

    kind, step = first_departure(
        solve_jax, solve_torch, lambda x: float(jax_fun(jnp.asarray(x))),
        lambda x: float(torch_fun(torch.from_numpy(x))), x0=x0, max_iter=max_iter,
        scale=scale, kink=kink)
    assert kind is not None, "the traced solves agree at the bar, the fits do not"
    # the departures ROADMAP.md lists (pytest -s shows them)
    print(f"fits part: {kind} at step {step}, max |diff| "
          f"{float(np.abs(np.asarray(got) - np.asarray(want)).max())!r}")
    return kind


def _regfit_kw(loss, pos_weight="balanced"):
    return dict(label_loss_type=loss, rank_loss_margin=0.0, pos_weight=pos_weight,
                reg_data_lambda=0.1, reg_norm_lambda=10.0, reg_query_lambda=1.0,
                max_iter=50)


def _check_regfit(X, y, sw, q, xlx, loss, pos_weight):
    kw = _regfit_kw(loss, pos_weight)
    want = J.RegFit(xlx=xlx, qvec=q, **kw).fit(X, y, sw).get_coeff()
    got = T.RegFit(device="cpu", xlx=xlx, qvec=q, **kw).fit(X, y, sw).get_coeff()
    pw = pos_weight if isinstance(pos_weight, float) else 1.0
    args = (0.0, pw, 0.1, 10.0, 1.0)
    lk = dict(label_loss_type=loss, pos_weight_balanced=pos_weight == "balanced")
    n = X.shape[0]
    Xc = X - X.mean(axis=0) if n else X  # the JAX fit centers in numpy ...
    Xt = _t(X) - _t(X).mean(dim=0) if n else _t(X)  # ... the port in torch
    npad = J._pad_pow2(max(n, 1))  # and the JAX fit pads the rows
    pad = [np.zeros((npad - n,) + a.shape[1:], a.dtype) for a in (Xc, y, sw)]
    Xp, yp, swp = (np.concatenate([a, z]) for a, z in zip((Xc, y, sw), pad))
    valid = np.arange(npad) < n

    def jax_fun(w):
        return J.multi_reg_loss(w, jnp.asarray(Xp), jnp.asarray(yp), jnp.asarray(swp),
                                jnp.asarray(valid), jnp.asarray(q), jnp.asarray(xlx),
                                *args, **lk)

    def torch_fun(w):
        return T.multi_reg_loss(w, Xt, _t(y), _t(sw), None, _t(q), _t(xlx), *args, **lk)

    kink = (lambda x: at_kink(Xc @ x, y)) if loss == "pairwise_rank_loss" else None
    return _check_departure(got, want, jax_fun, torch_fun, q, 11.0, kink)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("pos_weight", ["balanced", 3.0, 2])
def test_regfit_coefficients_match_jax(loss, pos_weight):
    """`pos_weight` 2 (an int) gives 1.0 in both packages."""
    X, y, sw, q, xlx, _ = _data(3)
    _check_regfit(X, y, sw, q / np.linalg.norm(q), xlx, loss, pos_weight)


@pytest.mark.parametrize("loss", LOSSES)
def test_regfit_with_no_labels_matches_jax(loss):
    """The label-free fit of MultiReg.set_text_vec: regularizers only."""
    _, _, _, q, xlx, _ = _data(4)
    empty = np.zeros((0, q.shape[0]), np.float32)
    _check_regfit(empty, np.zeros(0, np.float32), np.zeros(0, np.float32), q, xlx,
                  loss, "balanced")


@pytest.mark.parametrize("seed", [5, 6])
def test_multiregfit_coefficients_match_jax(seed):
    X, y, sw, q, _, rng = _data(seed)
    n, d = X.shape
    ys = np.stack([y, (rng.random(n) < 0.3).astype(np.float32) * (1 - y)], axis=1)
    kw = dict(reg_norm_lambda=10.0, reg_query_lambda=1.0, max_iter=50)
    want = J.MultiRegFit(qvec=q, **kw).fit(X, ys, sw)
    got = T.MultiRegFit(device="cpu", qvec=q, **kw).fit(X, ys, sw)
    Xc = X - X.mean(axis=0)
    W0 = np.stack([q, q + 0.01 * np.random.default_rng(0).normal(size=d).astype(np.float32)])
    npad = J._pad_pow2(n)  # the JAX fit pads the rows
    Xp, ysp, swp = (np.concatenate([a, np.zeros((npad - n,) + a.shape[1:], a.dtype)])
                    for a in (Xc, ys, sw))
    valid = np.arange(npad) < n

    def jax_fun(f):
        return J.two_head_loss(f, jnp.asarray(Xp), jnp.asarray(ysp), jnp.asarray(swp),
                               jnp.asarray(valid), jnp.asarray(q), 10.0, 1.0)

    def torch_fun(f):
        return T.two_head_loss(f, _t(Xc), _t(ys), _t(sw), None, _t(q), 10.0, 1.0)

    _check_departure(np.concatenate([got.get_coeff(), got.get_confusion_vec()]),
                     np.concatenate([want.get_coeff(), want.get_confusion_vec()]),
                     jax_fun, torch_fun, W0.reshape(-1), 21.0)


@pytest.mark.parametrize("seed", [7, 8])
def test_rank_regression_coefficients_match_jax(seed):
    X, y, _, q, _, _ = _data(seed)
    kw = dict(regularizer_vector=q, reg_lambda=5.0, max_iter=50)
    want = JaxRank(**kw).fit(X, y)
    got = TorchRank(device="cpu", **kw).fit(X, y)
    Xc = X - X.mean(axis=0)
    reg = 5.0 / X.shape[0]
    d = X.shape[1]

    def jax_fun(p):
        return (cheap_pairwise_rank_loss(jnp.asarray(y), jnp.asarray(Xc) @ p[:d]).sum()
                + reg * _anchor_regularizer(p[:d], jnp.asarray(want.anchor_)))

    torch_fun = _rank_loss(_t(Xc), _t(y), reg, _t(got.anchor_), fit_intercept=False)
    _check_departure(got.params_, want.params_, jax_fun, torch_fun,
                     np.concatenate([q, [0.0]]).astype(np.float32), 2 * reg,
                     kink=lambda p: at_kink(Xc @ p[:d], y))


def _index(seed=9, n_frames=30, tiles=4, d=16, device_dtype="float32"):
    rng = np.random.default_rng(seed)
    dbidx = np.repeat(np.arange(n_frames), tiles)
    zoom = np.tile(np.array([1, 1, 2, 2]), n_frames)
    xy = rng.uniform(0, 100, size=(n_frames * tiles, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + 40], axis=1)
    meta, order = VectorMeta.from_arrays(dbidx, zoom, boxes)
    V = rng.normal(size=(n_frames * tiles, d)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    tmeta = TMeta(**{f: getattr(meta, f) for f in TMeta.__dataclass_fields__})
    return convert.index_from_arrays(V[order], tmeta, device="cpu",
                                     device_dtype=device_dtype), rng


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("device_dtype", ["float32", "int8"])
def test_deferred_round_equals_host_fit(loss, device_dtype):
    idx, rng = _index(device_dtype=device_dtype)
    d = idx.dim
    q = rng.normal(size=d).astype(np.float32)
    rows = rng.choice(idx.meta.n_vectors, size=24, replace=False)
    ys = (np.arange(24) % 3 == 0).astype(np.float32)
    sw = rng.uniform(0.25, 1.0, size=24).astype(np.float32)
    xlx = (np.eye(d) * 1e-2).astype(np.float32)
    model = T.RegFit(device="cpu", xlx=xlx, qvec=q, **_regfit_kw(loss))
    out = idx.query(vector=model.deferred_fit_rows(idx, rows, ys, sw), topk=4,
                    shortlist_size=12)
    assert idx.last_fit["n_iter"] > 0 and idx.last_fit["host_syncs"] > 0
    # the host fit over the device rows' values (int8: dequantized): the
    # same ops on the same numbers
    X = idx._device_rows_f32(torch.from_numpy(idx.padded_row_ids(rows))).numpy()
    host = model.fit(X, ys, sw).get_coeff()
    np.testing.assert_array_equal(out["qvec"], host)
    want = idx.query(vector=host, topk=4, shortlist_size=12)
    assert list(out["dbidxs"]) == list(want["dbidxs"])


def test_diverged_deferred_fit_publishes_nothing():
    idx, rng = _index()
    d = idx.dim
    q = rng.normal(size=d).astype(np.float32)
    rows = rng.choice(idx.meta.n_vectors, size=24, replace=False)
    ys = (np.arange(24) % 2).astype(np.float32)
    model = T.RegFit(device="cpu", xlx=np.eye(d, dtype=np.float32), qvec=q,
                     **_regfit_kw("ce_loss"))
    returned = BitMap()
    first = idx.query(vector=q, topk=3, shortlist_size=12, exclude=returned)
    returned.update(first["dbidxs"])
    dv = model.deferred_fit_rows(idx, rows, ys)
    model.reg_norm_lambda = float("nan")  # f0 -> nan -> diverged
    with pytest.raises(ValueError, match="diverged"):
        idx.query(vector=dv, topk=3, shortlist_size=12, exclude=returned)
    model.reg_norm_lambda = 10.0
    again = idx.query(vector=dv, topk=3, shortlist_size=12, exclude=returned)
    assert not set(again["dbidxs"]) & set(first["dbidxs"])
    assert len(again["dbidxs"]) == 3


def test_first_departure_flags_another_objective():
    """The trace accepts no departure away from the floor, a kink or a
    stall: two solves of objectives that differ by 1% part at their first
    step, far from the floor, and the check fails."""
    rng = np.random.default_rng(10)
    A = rng.normal(size=(6, 6)).astype(np.float32)
    H = torch.from_numpy(A @ A.T + 6 * np.eye(6, dtype=np.float32))
    b = torch.from_numpy(rng.normal(size=6).astype(np.float32))

    def fun(scale):
        return lambda x: 0.5 * x @ H @ x - scale * (b @ x)

    def solve(scale):
        def run(k):
            r = lbfgs_minimize(fun(scale), torch.zeros(6), max_iter=k)
            return r.x.numpy(), float(r.f), r.n_iter
        return run

    def value(scale):
        return lambda x: float(fun(scale)(torch.from_numpy(x)))

    x0 = np.zeros(6, np.float32)
    assert first_departure(solve(1.0), solve(1.0), value(1.0), value(1.0), x0=x0,
                           max_iter=30, scale=1.0)[0] is None
    with pytest.raises(AssertionError, match="off the f32 floor"):
        first_departure(solve(1.0), solve(1.01), value(1.0), value(1.01), x0=x0,
                        max_iter=30, scale=1.0)
