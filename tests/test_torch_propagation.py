"""The port's label propagation (`seesaw_tpu_torch.ops.propagation`,
`label_propagation`, `loops.knn_methods`) against the JAX package on the
same numpy inputs, on the CPU.

- `propagate` against JAX `propagate`: converged and cut-off runs, the same
  iteration count, the pre-step iterate on convergence, segments equal to
  one unbroken run, a warm start, one host read per segment.
- `LabelPropagation.fit_transform` (host arrays in, bounds-checked scores
  out) against the JAX one; the ranker's staging of clicks (its count of
  labeled negatives, its device label state) against its host mirrors.
- The fused KnnProp2 round (`MultiscaleIndex.rank_by_scores` over a
  `DeferredPropagation`, i.e. `propagate_rank`) against the JAX fused round
  (`propagate_rank_windowed`, its Pallas SpMV in interpret mode) on a small
  device-built index: same frames, scores, n_iter and convergence each
  round, also when a round outruns its dispatch budget and resumes.

Tolerances: scores rtol 2e-5 / atol 2e-6 (the JAX package's bar between its
windowed and dense propagation: f32 sums in another order); iteration
counts and frames equal.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seesaw_tpu.indices.meta import VectorMeta as JaxMeta
from seesaw_tpu.indices.multiscale import MultiscaleIndex as JaxIndex
from seesaw_tpu.knn_graph import KNNGraph as JaxGraph
from seesaw_tpu.knn_graph import rbf_kernel, symmetrize_weights
from seesaw_tpu.label_propagation import LabelPropagation as JaxLP
from seesaw_tpu.loops.knn_methods import LabelPropagationRanker2 as JaxRanker
from seesaw_tpu.ops.pallas_spmv import build_windowed_layout_auto
from seesaw_tpu.ops.propagation import propagate as jax_propagate
from seesaw_tpu.runtime.bitmap import BitMap as JaxBitMap
from seesaw_tpu_torch import convert
from seesaw_tpu_torch.indices.meta import VectorMeta
from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex
from seesaw_tpu_torch.label_propagation import LabelPropagation as TorchLP
from seesaw_tpu_torch.label_propagation import check_prior_bounds
from seesaw_tpu_torch.loops.knn_methods import LabelPropagationRanker2
from seesaw_tpu_torch.ops.propagation import DeferredPropagation, propagate
from seesaw_tpu_torch.runtime.bitmap import BitMap

TOL = dict(rtol=2e-5, atol=2e-6)
RANKER = dict(normalize_scores=True, normalize_epsilon=0.1,
              sigmoid_before_propagate=True, calib_a=2.0, calib_b=-0.5,
              prior_weight=1.0)


def _problem(seed=0, n=500, k=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    weights = symmetrize_weights(JaxGraph.build(X, k), rbf_kernel(0.5))
    prior = rng.uniform(0.05, 0.95, n).astype(np.float32)
    labels = (rng.random(n) < 0.4).astype(np.float32)
    is_labeled = rng.random(n) < 0.03
    return weights, prior, labels, is_labeled


def _both(weights, prior, labels, is_labeled, start=None, **kw):
    start = prior if start is None else start
    want = jax_propagate(
        jnp.asarray(weights.nbr), jnp.asarray(weights.w), jnp.asarray(weights.degree),
        jnp.asarray(prior), jnp.asarray(labels), jnp.asarray(is_labeled),
        jnp.asarray(start), **kw)
    tw = convert.weights_from_arrays(weights.nbr, weights.w, weights.degree, "cpu")
    lab, il, pr = convert.ranker_state_from_arrays(labels, is_labeled, prior, "cpu")
    got = propagate(*tw.device_arrays("cpu"), pr, lab, il,
                    torch.from_numpy(np.asarray(start, np.float32)), **kw)
    return got, want


@pytest.mark.parametrize("kw,converged", [
    (dict(reg_lambda=1.0, epsilon=1e-5), True),
    (dict(reg_lambda=1.0, epsilon=1e-12, max_iter=7), False),
    (dict(reg_lambda=0.3, epsilon=1e-6, dispatch_iters=3), True),
])
def test_propagate_matches_jax(kw, converged):
    got, want = _both(*_problem(), **kw)
    assert got.converged == bool(want.converged) == converged
    assert got.n_iter == int(want.n_iter) > 1
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), **TOL)
    segments = -(-got.n_iter // kw.get("dispatch_iters", 300))
    assert got.host_reads == segments


def test_converged_run_returns_the_pre_step_iterate():
    """Cut off one step before convergence, the run returns its last
    iterate; the converged run returns the same iterate, not its own last."""
    prob = _problem(1)
    full, _ = _both(*prob, reg_lambda=1.0, epsilon=1e-5)
    cut, _ = _both(*prob, reg_lambda=1.0, epsilon=1e-5, max_iter=full.n_iter - 1)
    assert full.converged and not cut.converged
    np.testing.assert_array_equal(full.scores.numpy(), cut.scores.numpy())


def test_segments_equal_one_run_and_warm_start():
    prob = _problem(2)
    one, _ = _both(*prob, reg_lambda=1.0, epsilon=1e-6)
    seg, _ = _both(*prob, reg_lambda=1.0, epsilon=1e-6, dispatch_iters=2)
    assert seg.n_iter == one.n_iter and seg.host_reads == -(-one.n_iter // 2)
    np.testing.assert_array_equal(seg.scores.numpy(), one.scores.numpy())
    # warm start from a near solution: fewer steps, same fixed point
    start = one.scores.numpy()
    got, want = _both(*prob, start=start, reg_lambda=1.0, epsilon=1e-6)
    assert got.n_iter == int(want.n_iter) < one.n_iter
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), **TOL)
    np.testing.assert_allclose(got.scores.numpy(), one.scores.numpy(), atol=1e-2)


@pytest.mark.parametrize("warm", [False, True])
def test_fit_transform_matches_jax(warm):
    """The host API of `LabelPropagation`: label ids and values in,
    bounds-checked host scores out, equal to the JAX package's."""
    weights, prior, labels, is_labeled = _problem(3)
    ids = np.nonzero(is_labeled)[0]
    start = np.full_like(prior, 0.5) if warm else None
    kw = dict(label_ids=ids, label_values=labels[ids], reg_values=prior, start_value=start)
    want = JaxLP(weights, reg_lambda=1.0).fit_transform(**kw)
    lp = TorchLP(convert.weights_from_arrays(weights.nbr, weights.w, weights.degree, "cpu"),
                 reg_lambda=1.0, device="cpu")
    got = lp.fit_transform(**kw)
    assert isinstance(got, np.ndarray)
    np.testing.assert_allclose(got, want, **TOL)
    assert lp.last_result.converged and lp.last_result.host_reads == 1
    with pytest.raises(AssertionError, match="prior bounds"):
        check_prior_bounds(got + 2.0, prior)


def _indexes(n_frames=64, T=5, d=16, seed=0):
    """The same device-built index (uniform tiling) in both packages."""
    rng = np.random.default_rng(seed)
    img = 224.0
    quads = np.array([[0, 0, img / 2, img / 2], [img / 2, 0, img, img / 2],
                      [0, img / 2, img / 2, img], [img / 2, img / 2, img, img],
                      [0, 0, img, img]], np.float32)[:T]
    zoom = np.array([1, 1, 1, 1, 2], np.int32)[:T]
    arrays = dict(
        dbidx=np.repeat(np.arange(n_frames, dtype=np.int32), T),
        zoom_level=np.tile(zoom, n_frames), boxes=np.tile(quads, (n_frames, 1)),
        frame_dbidx=np.arange(n_frames, dtype=np.int32),
        frame_starts=np.arange(0, (n_frames + 1) * T, T, dtype=np.int32),
        frame_id=np.repeat(np.arange(n_frames, dtype=np.int32), T),
    )
    V = rng.normal(size=(n_frames * T, d)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    jidx = JaxIndex.from_device_arrays(
        embedding=None, V=jnp.asarray(V), valid=jnp.ones((n_frames, T), bool),
        boxes=jnp.asarray(arrays["boxes"]), zoom=jnp.asarray(arrays["zoom_level"]),
        meta=JaxMeta(**arrays), use_pallas=False)
    tidx = MultiscaleIndex.from_device_arrays(
        embedding=None, V=torch.from_numpy(V), valid=torch.ones(n_frames, T, dtype=torch.bool),
        boxes=torch.from_numpy(arrays["boxes"]), zoom=torch.from_numpy(arrays["zoom_level"]),
        meta=VectorMeta(**arrays))
    return jidx, tidx, V


@pytest.mark.parametrize("dispatch_iters,warm", [(100, False), (1, False), (100, True)])
def test_fused_round_matches_jax_fused_round(dispatch_iters, warm):
    """Each round ranks the previous round's staged clicks fused; with a
    budget of one step per segment every multi-step round resumes."""
    jidx, tidx, V = _indexes()
    weights = symmetrize_weights(JaxGraph.build(V, 8), rbf_kernel(0.5))
    layout = build_windowed_layout_auto(weights.nbr, weights.w, min_coverage=0.0)
    jr = JaxRanker(weights=weights, windowed_layout=layout, warm_start=warm, **RANKER)
    tr = LabelPropagationRanker2(
        weights=convert.weights_from_arrays(weights.nbr, weights.w, weights.degree, "cpu"),
        device="cpu", warm_start=warm, **RANKER)
    jr.lp.dispatch_iters = tr.lp.dispatch_iters = dispatch_iters
    q = np.random.default_rng(3).normal(size=V.shape[1]).astype(np.float32)
    q /= np.linalg.norm(q)
    jr.set_base_scores(jidx.score_device(q))
    tr.set_base_scores(tidx.score_device(q))
    ret_j, ret_t = JaxBitMap(), BitMap()
    fused_rounds = resumed = 0
    for rnd in range(5):
        staged = tr.current_scores_any()
        want = jidx.rank_by_scores(jr.current_scores_any(), topk=3, shortlist_size=10,
                                   exclude=ret_j)
        got = tidx.rank_by_scores(staged, topk=3, shortlist_size=10, exclude=ret_t)
        assert list(got["dbidxs"]) == list(want["dbidxs"]), f"round {rnd}"
        np.testing.assert_allclose([a["score"] for a in got["activations"]],
                                   [a["score"] for a in want["activations"]], **TOL)
        if isinstance(staged, DeferredPropagation):
            fused_rounds += 1
            res = tr.last_result
            assert res.n_iter == jr.last_n_iter
            segments = -(-res.n_iter // dispatch_iters)
            assert res.host_reads <= 1 + segments
            resumed += res.n_iter > dispatch_iters
        ret_j.update(want["dbidxs"])
        ret_t.update(got["dbidxs"])
        rows = np.array([int(d_) * 5 for d_ in got["dbidxs"]])
        labels = (rows % 2 == 0).astype(np.float64)  # mixes pos + neg
        jr.update(rows, labels)
        tr.update(rows, labels)
    assert fused_rounds >= 3
    if dispatch_iters == 1:
        assert resumed > 0
    np.testing.assert_allclose(tr.current_scores(), jr.current_scores(), **TOL)
    np.testing.assert_array_equal(tr._labels_dev.numpy(), np.asarray(jr._labels_dev))


def test_update_stages_a_round_exactly_when_a_negative_is_labeled():
    """The ranker keeps a running count of labeled negatives; it must agree
    with the reference's scan of the host mirrors after every update,
    relabels included, and stage a round exactly when the count is > 0."""
    weights = symmetrize_weights(JaxGraph.build(_indexes()[2], 4), rbf_kernel(0.5))
    tr = LabelPropagationRanker2(weights=convert.weights_from_arrays(
        weights.nbr, weights.w, weights.degree, "cpu"), device="cpu", **RANKER)
    tr.set_base_scores(np.linspace(0, 1, tr.nvecs, dtype=np.float32))
    rng = np.random.default_rng(9)
    for step in range(40):
        rows = rng.choice(12, size=2, replace=False)  # few rows: many relabels
        labels = (rng.random(2) < (0.8 if step < 20 else 0.2)).astype(np.float64)
        staged_before = tr._needs_prop
        tr.update(rows, labels)
        scan = int((tr.labels[tr.is_labeled > 0] == 0).sum())
        assert tr._negatives == scan, f"step {step}"
        assert tr._needs_prop == (staged_before or scan > 0)
        tr._needs_prop = False  # as if the staged round had run


def test_device_labels_match_the_host_mirrors():
    """The device label state starts empty and takes every staged click by
    scatter, the last label of a row winning (a row relabeled within one
    staged round too); after each propagation it equals the host mirrors."""
    weights = symmetrize_weights(JaxGraph.build(_indexes()[2], 4), rbf_kernel(0.5))
    tr = LabelPropagationRanker2(weights=convert.weights_from_arrays(
        weights.nbr, weights.w, weights.degree, "cpu"), device="cpu", **RANKER)
    tr.set_base_scores(np.linspace(0, 1, tr.nvecs, dtype=np.float32))
    tr.update([3, 4], [1.0, 1.0])  # no negative: nothing staged to run yet
    assert not isinstance(tr.current_scores_any(), DeferredPropagation)
    for rows, labels in (([4, 7], [0.0, 1.0]), ([7, 9], [0.0, 0.0]), ([9], [1.0])):
        tr.update(rows, labels)
        tr.update(rows[:1], [1.0 - labels[0]])  # relabel before the round runs
        tr.current_scores()
        assert not tr._pending
        np.testing.assert_array_equal(tr._labels_dev.numpy(), tr.labels.astype(np.float32))
        np.testing.assert_array_equal(tr._is_labeled_dev.numpy(), tr.is_labeled > 0)


def test_host_consumer_flushes_a_staged_round():
    """current_scores() runs a staged round eagerly (the port's
    `_flush_propagation`), equal to the JAX eager path."""
    jidx, tidx, V = _indexes(seed=4)
    weights = symmetrize_weights(JaxGraph.build(V, 8), rbf_kernel(0.5))
    jr = JaxRanker(weights=weights, **RANKER)  # eager XLA path
    tr = LabelPropagationRanker2(weights=convert.weights_from_arrays(
        weights.nbr, weights.w, weights.degree, "cpu"), device="cpu", **RANKER)
    q = np.random.default_rng(5).normal(size=V.shape[1]).astype(np.float32)
    jr.set_base_scores(jidx.score(q))
    tr.set_base_scores(tidx.score(q))
    rows, labels = np.array([0, 5, 10, 15]), np.array([1.0, 0.0, 0.0, 1.0])
    jr.update(rows, labels)
    tr.update(rows, labels)
    assert isinstance(tr.current_scores_any(), DeferredPropagation)
    np.testing.assert_allclose(tr.current_scores(), jr.current_scores(), **TOL)
    assert not isinstance(tr.current_scores_any(), DeferredPropagation)
    top_t, _ = tr.top_k(5)
    top_j, _ = jr.top_k(5)
    np.testing.assert_array_equal(top_t, top_j)
    assert tr.last_result.host_reads == 1
