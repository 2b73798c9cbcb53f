"""The port's research extras (`seesaw_tpu_torch.research`: `mixture`,
`looptest`, `lr_eval`) held against the JAX package's on the CPU, the same
numpy inputs on both sides.

Tolerances:
- EM state (means, covariances, log weights, mean log-likelihood) after 1,
  10 and 60 iterations: rtol 1e-5 / atol 1e-5 (f32 einsums, inverses and
  log-determinants in another order; measured ~2e-6);
- `gen_data`, `kmeans_plusplus`, `average_precision_score` and the zero-shot
  metrics: equal (the same numpy code);
- `TempRegression` with the JAX parameters carried across: the loss of
  every epoch rtol 1e-4 / atol 1e-5 and the final parameters atol 1e-4
  (300 Adam steps of f32 sums in another order; measured 1.2e-5 and 4e-6),
  predictions equal;
- `lr_eval`'s logistic probe: AP within 1e-6 (LBFGS fits held at the
  LogReg2 bar, tests/test_torch_learners.py, rank the test rows alike).
"""
import numpy as np
import pandas as pd
import pytest
import torch

import seesaw_tpu.research.looptest as JL
import seesaw_tpu.research.lr_eval as JE
import seesaw_tpu.research.mixture as JM
import seesaw_tpu_torch.research.looptest as TL
import seesaw_tpu_torch.research.lr_eval as TE
import seesaw_tpu_torch.research.mixture as TM

EM_TOL = dict(rtol=1e-5, atol=1e-5)


def _em_inputs(d=8, k=3):
    X, *_ = JM.gen_data(n_classes=k, n_dim=d, n_samples=1500, seed=3)
    mus0 = JM.kmeans_plusplus(X, X.mean(axis=0), k, seed=0)
    covs0 = np.stack([np.eye(d, dtype=np.float32)] * k)
    log_pz0 = np.full(k, -np.log(k), np.float32)
    return X, mus0, covs0, log_pz0


@pytest.mark.parametrize("n_iters", [1, 10, 60])
def test_em_state_matches_jax(n_iters):
    import jax.numpy as jnp

    args = _em_inputs()
    want = JM._em(*(jnp.asarray(a) for a in args), n_iters=n_iters)
    got = TM.em_steps(*(torch.from_numpy(a) for a in args), n_iters=n_iters)
    for name, g, w in zip(("mus", "covs", "log_pz", "ll"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **EM_TOL)


def test_mixture_model_matches_jax():
    X, cats, _, _, _ = JM.gen_data(n_classes=3, n_dim=4, n_samples=800, seed=5)
    Xys = (X[cats == 0][:20], np.ones(min(20, int((cats == 0).sum()))))
    jm, tm = JM.MixtureModel(3, seed=0), TM.MixtureModel(3, seed=0, device="cpu")
    np.testing.assert_allclose(tm.fit(X, Xys=Xys, max_iters=50),
                               jm.fit(X, Xys=Xys, max_iters=50), **EM_TOL)
    for name in ("mus", "covs", "log_pz"):
        np.testing.assert_allclose(getattr(tm, name), getattr(jm, name), err_msg=name,
                                   **EM_TOL)
    np.testing.assert_allclose(tm.log_px(X[:64]), jm.log_px(X[:64]), **EM_TOL)
    np.testing.assert_allclose(tm.predict_proba(X[:64]), jm.predict_proba(X[:64]), **EM_TOL)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_data_and_seeding_equal(seed):
    a, b = TM.gen_data(3, 5, 300, normalize=seed == 1, seed=seed), \
        JM.gen_data(3, 5, 300, normalize=seed == 1, seed=seed)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    X = np.random.default_rng(seed).normal(size=(200, 3)).astype(np.float32)
    c0 = np.array([5.0, 5.0, 5.0], np.float32)
    np.testing.assert_array_equal(TM.kmeans_plusplus(X, c0, 4, seed=seed),
                                  JM.kmeans_plusplus(X, c0, 4, seed=seed))


def test_em_recovers_clusters_on_the_port():
    X, cats, probs, mus, _ = TM.gen_data(n_classes=3, n_dim=4, n_samples=1500, seed=3)
    mm = TM.MixtureModel(n_components=3, seed=0, device="cpu")
    assert np.isfinite(mm.fit(X, max_iters=60))
    for mu in mus:
        assert np.linalg.norm(mm.mus - mu, axis=1).min() < 0.5
    assert np.abs(np.sort(probs) - np.sort(np.exp(mm.log_pz))).max() < 0.1
    ll0 = TM.MixtureModel(3, seed=0, device="cpu").fit(X, max_iters=1)
    assert mm.fit(X, max_iters=50) >= ll0  # EM is monotone in likelihood
    np.testing.assert_allclose(mm.predict_proba(X[:50]).sum(axis=1), 1.0, rtol=1e-5)


def _classes(seed=0, C=4, D=16, n=400):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(C, D)) * 3
    y = rng.integers(0, C, size=n)
    return (centers[y] + rng.normal(size=(n, D))).astype(np.float32), y


def test_temp_regression_matches_jax():
    X, y = _classes()
    jm = JL.TempRegression(16, 4, seed=0)
    tm = TL.TempRegression.from_params(
        TL.TempRegressionParams(*(np.asarray(t) for t in jm.params)), device="cpu")
    np.testing.assert_array_equal(tm.params.W, np.asarray(jm.params.W))
    want, got = jm.fit(X, y, epochs=300), tm.fit(X, y, epochs=300)
    assert got.shape == want.shape == (300,)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    for name, g, w in zip(("W", "b", "log_temps"), tm.params, jm.params):
        np.testing.assert_allclose(g, np.asarray(w), atol=1e-4, err_msg=name)
    np.testing.assert_array_equal(tm.predict(X), jm.predict(X))
    np.testing.assert_allclose(tm.temperatures, jm.temperatures, rtol=1e-4)


def test_temp_regression_learns_on_the_port():
    X, y = _classes()
    m = TL.TempRegression(16, 4, seed=0, device="cpu")
    losses = m.fit(X, y, epochs=300)
    assert losses[-1] < losses[0] * 0.5
    assert (m.predict(X) == y).mean() > 0.95
    assert (m.temperatures > 0).all()
    W0 = np.random.default_rng(1).normal(size=(3, 8)).astype(np.float32)
    np.testing.assert_array_equal(TL.TempRegression(8, 3, initial_weights=W0,
                                                    device="cpu").params.W, W0)
    # the default init is seeded: the same seed, the same weights
    np.testing.assert_array_equal(TL.TempRegression(8, 3, seed=4, device="cpu").params.W,
                                  TL.init_params(8, 3, seed=4).W)


def test_average_precision_and_metrics_equal():
    rng = np.random.default_rng(0)
    for trial in range(20):
        n = int(rng.integers(5, 200))
        ys = rng.integers(0, 2, size=n).astype(bool)
        ys[0] = True
        scores = rng.normal(size=n)
        if trial % 3 == 0:  # tied scores
            scores = np.round(scores, 1)
        assert TE.average_precision_score(ys, scores) == JE.average_precision_score(ys, scores)
        dbidx = np.arange(n) // 3
        for pooling in (False, True):
            assert TE.get_metrics(dbidx, ys, scores, pooling) == \
                JE.get_metrics(dbidx, ys, scores, pooling)


def test_eval_scorers_matches_jax():
    rng = np.random.default_rng(1)
    n_frames, tiles, d = 60, 5, 16
    dbidx = np.repeat(np.arange(n_frames), tiles)
    target = rng.normal(size=d)
    target /= np.linalg.norm(target)
    ys = np.zeros(n_frames * tiles)
    V = rng.normal(size=(n_frames * tiles, d)) * 0.8
    for f in rng.choice(n_frames, size=20, replace=False):
        i = f * tiles + int(rng.integers(tiles))
        V[i] += 2.5 * target
        ys[i] = 1.0
    V = (V / np.linalg.norm(V, axis=1, keepdims=True)).astype(np.float32)
    q = target + 0.8 * rng.normal(size=d)
    want = JE.eval_scorers(V, ys, dbidx, qvec=q, seed=0)
    got = TE.eval_scorers(V, ys, dbidx, qvec=q, seed=0, device="cpu")
    pd.testing.assert_frame_equal(got.drop(columns="ap"), want.drop(columns="ap"))
    np.testing.assert_allclose(got.ap.values, want.ap.values, rtol=0, atol=1e-6)
    zs = got[(got.scorer == "zero_shot") & ~got.frame_pooling].ap.iloc[0]
    lr = got[(got.scorer == "logistic") & ~got.frame_pooling].ap.iloc[0]
    assert lr > zs  # the trained probe denoises the query
