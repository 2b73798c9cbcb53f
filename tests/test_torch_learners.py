"""The port's LogisticRegression against the JAX probe on the same rows, on
the CPU, including a warm start carried across with
`seesaw_tpu_torch.convert.probe_from_arrays`.

Tolerance: coefficients rtol 2e-4 / atol 2e-5 (tests/test_deferred_rocchio.py's
bar between the JAX package's own fit paths).
"""
import numpy as np
import pytest

from seesaw_tpu.indices.meta import VectorMeta
from seesaw_tpu.indices.multiscale import MultiscaleIndex as JaxIndex
from seesaw_tpu.learners import LogisticRegression as JaxLR
from seesaw_tpu_torch import convert

OPTS = dict(class_weights="balanced", scale="centered", reg_lambda=5.0,
            fit_intercept=False, max_iter=50)


def _db(seed, n_frames=50, tiles=4, d=16):
    rng = np.random.default_rng(seed)
    dbidx = np.repeat(np.arange(n_frames), tiles)
    zoom = np.tile(np.array([1, 1, 2, 2]), n_frames)
    xy = rng.uniform(0, 100, size=(n_frames * tiles, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + 40], axis=1)
    meta, order = VectorMeta.from_arrays(dbidx, zoom, boxes)
    V = rng.normal(size=(n_frames * tiles, d)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    return V[order], meta


@pytest.mark.parametrize("device_dtype", ["float32", "int8"])
def test_deferred_fit_and_warm_start_match_jax(device_dtype):
    V, meta = _db(5)
    jidx = JaxIndex(vectors=V, meta=meta, device_dtype=device_dtype, use_pallas=True)
    tidx = convert.index_from_arrays(V, meta, device="cpu", device_dtype=device_dtype)
    rng = np.random.default_rng(6)
    tvec = rng.normal(size=V.shape[1]).astype(np.float32)
    tvec /= np.linalg.norm(tvec)
    rows = rng.choice(meta.n_vectors, size=30, replace=False)
    ys = (V[rows] @ tvec > 0).astype(np.float32)

    jm = JaxLR(regularizer_vector=tvec, **OPTS)
    want = jidx.query(vector=jm.deferred_fit_rows(jidx, rows, ys), topk=6, shortlist_size=20)
    jm.apply_fit_result(want["fit"])
    tm = convert.probe_from_arrays(None, None, jm.anchor_, device="cpu", **OPTS)
    got = tidx.query(vector=tm.deferred_fit_rows(tidx, rows, ys), topk=6, shortlist_size=20)
    tm.apply_fit_result(got["fit"])
    np.testing.assert_allclose(tm.params_, jm.params_, rtol=2e-4, atol=2e-5)
    assert list(got["dbidxs"]) == list(want["dbidxs"])

    # second round warm-started from the JAX probe's state
    more = rng.choice(meta.n_vectors, size=20, replace=False)
    rows2 = np.concatenate([rows, more])
    ys2 = (V[rows2] @ tvec > 0.1).astype(np.float32)
    tm2 = convert.probe_from_arrays(jm.params_, jm.mu_, jm.anchor_, device="cpu", **OPTS)
    jm.fit_rows(jidx, rows2, ys2)  # host-mirror path: JaxLR.fit
    tm2.fit_rows(tidx, rows2, ys2)
    np.testing.assert_allclose(tm2.params_, jm.params_, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(tm2.mu_, jm.mu_, rtol=1e-5, atol=1e-6)
