"""The port's ranking tail (`seesaw_tpu_torch.ops.frame_scoring`) against
`seesaw_tpu.ops.frame_scoring` on the same numpy inputs, on the CPU.

Tolerances: augmentation and ranking outputs rtol 1e-6 (the same f32
elementwise ops; no reduction longer than T); query scores rtol 1e-5 (f32
dots of D=32 terms summed in another order); int8 scores rtol 1e-6 (exact
int32 dots, same epilogue order). Tie order must match exactly.
"""
import functools
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seesaw_tpu.ops import frame_scoring as jfs
from seesaw_tpu_torch.ops import frame_scoring as tfs


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _frames(rng, B=6, T=8):
    xy = rng.uniform(0, 100, size=(B, T, 2)).astype(np.float32)
    wh = rng.uniform(10, 70, size=(B, T, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=-1)
    boxes[0, 1] = boxes[0, 0]  # an exact duplicate box (IoU tie)
    zoom = rng.integers(1, 4, size=(B, T)).astype(np.int32)
    scores = rng.normal(size=(B, T)).astype(np.float32)
    valid = rng.random((B, T)) < 0.8
    valid[:, 0] = True
    valid[-1] = False  # a frame with no valid tile
    scores = np.where(valid, scores, -np.inf).astype(np.float32)
    return boxes, zoom, scores, valid


@pytest.mark.parametrize(
    "aug_larger,aug_weight,agg_method",
    list(itertools.product(["all", "greater", "adjacent"],
                           ["level_max", "cont_weighted"],
                           ["avg_score", "avg_vector", "plain_score"])),
)
def test_augment_tile_scores_matrix(aug_larger, aug_weight, agg_method):
    boxes, zoom, scores, valid = _frames(np.random.default_rng(0))
    kw = dict(aug_larger=aug_larger, aug_weight=aug_weight,
              agg_method=agg_method, max_zoom=3)
    want = np.asarray(jax.vmap(functools.partial(jfs.augment_tile_scores, **kw))(
        jnp.asarray(boxes), jnp.asarray(zoom), jnp.asarray(scores), jnp.asarray(valid)))
    got = tfs.augment_tile_scores(_t(boxes), _t(zoom), _t(scores), _t(valid), **kw).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-6, atol=1e-7)


def _db(seed, F=40, T=8, D=32):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(F * T, D)).astype(np.float32)
    valid = rng.random((F, T)) < 0.8
    valid[:, 0] = True
    V[~valid.reshape(-1)] = 0.0
    xy = rng.uniform(0, 100, size=(F * T, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + 40], axis=1)
    zoom = rng.integers(1, 4, size=F * T).astype(np.int32)
    excluded = rng.random(F) < 0.2
    q = rng.normal(size=D).astype(np.float32)
    return V, valid, boxes, zoom, excluded, q


def _assert_same(got, want, rtol=1e-5):
    n = int(want.n_valid)
    assert int(got.n_valid) == n
    np.testing.assert_array_equal(got.frame_ids.numpy(), np.asarray(want.frame_ids))
    np.testing.assert_array_equal(got.act_boxes.numpy()[:n], np.asarray(want.act_boxes)[:n])
    np.testing.assert_allclose(got.frame_scores.numpy()[:n],
                               np.asarray(want.frame_scores)[:n], rtol=rtol)
    np.testing.assert_allclose(got.act_scores.numpy()[:n],
                               np.asarray(want.act_scores)[:n], rtol=rtol)


KW = dict(shortlist_size=12, topk=5, aug_larger="all", aug_weight="level_max",
          agg_method="avg_score", max_zoom=3)


@pytest.mark.parametrize("with_q2", [False, True])
def test_query_program_incr_matches_jax(with_q2):
    V, valid, boxes, zoom, excluded, q = _db(1)
    q2 = np.random.default_rng(9).normal(size=q.shape).astype(np.float32) * 0.3
    new_ids = np.array([4, 17, -1, -1, -1], np.int32)
    want, wmask = jfs.query_program_incr(
        *[jnp.asarray(a) for a in (V, valid, boxes, zoom, q)],
        jnp.asarray(q2) if with_q2 else None, jnp.asarray(excluded),
        jnp.asarray(new_ids), **KW)
    got, gmask = tfs.query_program_incr(
        *[_t(a) for a in (V, valid, boxes, zoom, q)], _t(q2) if with_q2 else None,
        _t(excluded), _t(new_ids).long(), **KW)
    _assert_same(got, want)
    np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_rank_from_frame_max_and_scoring_matvec(dtype):
    V, valid, boxes, zoom, excluded, q = _db(2)
    row_scale = None
    if dtype == "int8":
        rmax = np.abs(V).max(axis=1)
        row_scale = np.where(rmax > 0, rmax / 127.0, 1.0).astype(np.float32)
        V = np.clip(np.round(V / row_scale[:, None]), -127, 127).astype(np.int8)
    jV = jnp.asarray(V, dtype=jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(V)
    tV = _t(V).to(torch.bfloat16) if dtype == "bfloat16" else _t(V)
    jrs = None if row_scale is None else jnp.asarray(row_scale)
    trs = None if row_scale is None else _t(row_scale)
    rtol = 1e-6 if dtype == "int8" else 1e-5

    ws = np.asarray(jfs.scoring_matvec(jV, jnp.asarray(q), jrs))
    gs = tfs.scoring_matvec(tV, _t(q), trs).numpy()
    np.testing.assert_allclose(gs, ws, rtol=rtol, atol=1e-5)

    fmax = np.asarray(jfs.score_frames_max(jV, jnp.asarray(valid), jnp.asarray(q), jrs))
    fmax = np.where(excluded, -np.inf, fmax).astype(np.float32)
    T = valid.shape[1]
    want = jfs.rank_from_frame_max(
        jV, jnp.asarray(valid), jnp.asarray(boxes), jnp.asarray(zoom),
        jnp.asarray(q), jnp.asarray(fmax), jrs, None, tile_bound=T, **KW)
    got = tfs.rank_from_frame_max(
        tV, _t(valid), _t(boxes), _t(zoom), _t(q), _t(fmax), trs, None,
        tile_bound=T, **KW)
    _assert_same(got, want, rtol=rtol)


def test_apply_new_exclusions_returns_new_mask():
    rng = np.random.default_rng(3)
    excl = rng.random(30) < 0.3
    ids = np.array([0, 29, 7, -1, -1, 7], np.int32)
    want = np.asarray(jfs.apply_new_exclusions(jnp.asarray(excl), jnp.asarray(ids)))
    base = _t(excl.copy())
    got = tfs.apply_new_exclusions(base, _t(ids).long())
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(base.numpy(), excl)  # base untouched
    assert got.data_ptr() != base.data_ptr()


def test_planted_ties_take_the_lower_index_first():
    """Duplicate frames give equal frame maxima and equal augmented scores;
    two identical tiles in one frame tie on the top tile. Both packages must
    put the lower frame id first and take the first tile."""
    V, valid, boxes, zoom, excluded, q = _db(4, F=20)
    T = valid.shape[1]
    excluded[:] = False
    for dup in (9, 13, 16):  # copies of frame 2
        V[dup * T:(dup + 1) * T] = V[2 * T:3 * T]
        valid[dup] = valid[2]
        boxes[dup * T:(dup + 1) * T] = boxes[2 * T:3 * T]
        zoom[dup * T:(dup + 1) * T] = zoom[2 * T:3 * T]
    q = V[2 * T] * 3.0  # frame 2's first tile (and its copies) ranks first
    V[2 * T + 1] = V[2 * T]  # tile 1 ties tile 0 inside each copy
    for dup in (9, 13, 16):
        V[dup * T + 1] = V[dup * T]
    valid[[2, 9, 13, 16], 1] = True
    kw = dict(KW, agg_method="plain_score", topk=4)
    want = jfs.query_program(
        *[jnp.asarray(a) for a in (V, valid, boxes, zoom, q)], None,
        jnp.asarray(excluded), **kw)
    got = tfs.query_program(
        *[_t(a) for a in (V, valid, boxes, zoom, q)], None, _t(excluded), **kw)
    _assert_same(got, want)
    assert got.frame_ids.tolist() == [2, 9, 13, 16]
    np.testing.assert_array_equal(got.act_boxes[0].numpy(), boxes[2 * T])

    vals, idx = tfs.topk_first(torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0, -np.inf]), 4)
    assert idx.tolist() == [1, 2, 4, 3]
    wv, wi = jax.lax.top_k(jnp.asarray([1.0, 3.0, 3.0, 2.0, 3.0, -np.inf]), 4)
    assert np.asarray(wi).tolist() == idx.tolist()
    x = torch.tensor([[0.5, 2.0, 2.0, -1.0]])
    assert x.argmax(dim=1).item() == int(jnp.argmax(jnp.asarray(x.numpy()), axis=1)[0]) == 1
