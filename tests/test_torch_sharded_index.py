"""The port's mesh-sharded index against the JAX package's.

`seesaw_tpu_torch.parallel.sharded_index` and the mesh branches of
`seesaw_tpu_torch.indices.multiscale.MultiscaleIndex` and
`seesaw_tpu_torch.web.coalesce`, on a port mesh of S in {2, 4, 8} CPU
shards (`make_mesh(devices=["cpu"] * S)`), against the JAX package's on its
8 virtual CPU devices (`tests/conftest.py`), with the same numpy inputs: a
ragged database whose frame count no S divides, f32 / bf16 / int8 storage,
exclusions that grow across clicks, wholly excluded shards, fewer frames
than shards, a tie planted at the global shortlist cutoff, the discount
(second) vector, batch = solo, `rank_by_scores`, the coalescer, the
device-built shard split, and whole sessions over a `from_path(mesh=)`
index. The cases mirror `tests/test_sharded_index.py`,
`test_sharded_dtypes.py` and `test_sharded_stress.py`.

Tolerances: frame ids equal everywhere. Scores rtol 1e-5 / atol 1e-6 (f32
dots of <= 32 terms summed in another order; bf16 products are exact in
f32; int8 dots are exact and dequantized in the JAX package's order). The
sharded port against the single-device port: ids equal, scores rtol 1e-6
(the same arithmetic per frame; the discount vector's product has another
shape, so there 1e-5). Sessions: the bars of `tests/test_torch_session.py`.
"""
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import seesaw_tpu.basic_types as jbt  # noqa: E402
import seesaw_tpu_torch.basic_types as tbt  # noqa: E402
from seesaw_tpu.indices.meta import VectorMeta as JMeta  # noqa: E402
from seesaw_tpu.indices.multiscale import MultiscaleIndex as JIndex  # noqa: E402
from seesaw_tpu.parallel import make_mesh as jax_mesh  # noqa: E402
from seesaw_tpu.parallel import sharded_index as jsi  # noqa: E402
from seesaw_tpu.runtime.bitmap import BitMap as JBitMap  # noqa: E402
from seesaw_tpu_torch.indices.meta import VectorMeta  # noqa: E402
from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex  # noqa: E402
from seesaw_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from seesaw_tpu_torch.parallel import sharded_index as tsi  # noqa: E402
from seesaw_tpu_torch.runtime.bitmap import BitMap  # noqa: E402

SHARDS = [2, 4, 8]
TOL = dict(rtol=1e-5, atol=1e-6)


def cpu_mesh(S):
    return tmesh.make_mesh(devices=["cpu"] * S)


def _ragged(n_frames, d, seed, max_tiles=8, id_step=2):
    """Ragged frames (1..max_tiles tiles, zoom 1-3 boxes), unit vectors,
    dbidx != frame ordinal; (torch meta, jax meta, V in exact order)."""
    rng = np.random.default_rng(seed)
    dbidx, zoom, boxes = [], [], []
    for f in range(n_frames):
        for _ in range(int(rng.integers(1, max_tiles + 1))):
            zl = int(rng.integers(1, 4))
            size = 32.0 * (2 ** (zl - 1))
            x1, y1 = (float(rng.uniform(0, 224 - size)) for _ in range(2))
            dbidx.append(f * id_step + 5)
            zoom.append(zl)
            boxes.append((x1, y1, x1 + size, y1 + size))
    V = rng.normal(size=(len(dbidx), d)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    args = (np.array(dbidx), np.array(zoom), np.array(boxes, np.float32))
    meta, order = VectorMeta.from_arrays(*args)
    jmeta, jorder = JMeta.from_arrays(*args)
    assert (order == jorder).all()
    return meta, jmeta, V[order]


@pytest.fixture(scope="module")
def db():
    return _ragged(41, 24, seed=0)


def _acts(res):
    return np.array([a["score"] for a in res["activations"]], np.float32)


def _same(got, want, tol=TOL):
    assert list(got["dbidxs"]) == list(want["dbidxs"])
    np.testing.assert_allclose(_acts(got), _acts(want), **tol)


def test_make_mesh_and_collectives():
    m = cpu_mesh(3)
    assert m.size == 3 and m.distinct == (torch.device("cpu"),) and m.axis_name == "data"
    with pytest.raises(ValueError):
        tmesh.make_mesh(2, devices=["cpu"] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(AssertionError):
            tmesh.make_mesh(1)
    parts = [torch.full((2,), float(i)) for i in range(3)]
    g = tmesh.all_gather(m, parts)
    assert g[0] is g[1] is g[2]  # one concatenation per distinct device
    assert g[0].tolist() == [0, 0, 1, 1, 2, 2]
    assert [p.tolist() for p in tmesh.rotate(m, parts)] == [[1, 1], [2, 2], [0, 0]]
    assert float(tmesh.pmax(m, [p.sum() for p in parts])[1]) == 4.0
    assert float(tmesh.psum(m, [p.sum() for p in parts])[2]) == 6.0
    x = torch.arange(7.0)
    rows = tmesh.split_rows(m, x, 3, fill=-1.0)
    assert [r.tolist() for r in rows] == [[0, 1, 2], [3, 4, 5], [6, -1, -1]]
    assert rows[0].data_ptr() == x.data_ptr()  # a whole part is a view


_JAX_SOLO = {}


def _jax_clicks(jmeta, V, dtype, clicks, rng_seed):
    """The JAX sharded index's results over `clicks` growing exclusions."""
    key = (dtype, rng_seed)
    if key not in _JAX_SOLO:
        jidx = jsi.ShardedFrameIndex.build(V, jmeta, jax_mesh(8), dtype=dtype)
        rng = np.random.default_rng(rng_seed)
        excl = np.zeros(jmeta.n_frames, dtype=bool)
        out = []
        for _ in range(clicks):
            q = rng.normal(size=V.shape[1]).astype(np.float32)
            d, s, b, a = jsi.sharded_query_topk(jidx, q, excl.copy(), topk=6,
                                                shortlist_size=15)
            out.append((q, excl.copy(), d, s, b, a))
            excl[np.searchsorted(jmeta.frame_dbidx, d[:3])] = True
        _JAX_SOLO[key] = out
    return _JAX_SOLO[key]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("S", SHARDS)
def test_query_matches_jax_and_one_device(db, dtype, S):
    """Four clicks of growing exclusions: the port's sharded query equals
    the JAX package's and the port's single-device index."""
    meta, jmeta, V = db
    idx = tsi.ShardedFrameIndex.build(V, meta, cpu_mesh(S), dtype=dtype)
    assert idx.n_frames_local == -(-41 // S)
    one = MultiscaleIndex(device="cpu", vectors=V, meta=meta, device_dtype=dtype)
    for q, excl, d, s, b, a in _jax_clicks(jmeta, V, dtype, 4, rng_seed=1):
        got = tsi.sharded_query_topk(idx, q, excl, topk=6, shortlist_size=15)
        assert got[0].tolist() == d.tolist()
        np.testing.assert_allclose(got[1], s, **TOL)
        np.testing.assert_allclose(got[2], b, **TOL)
        np.testing.assert_allclose(got[3], a, **TOL)
        want = one.query(vector=q, topk=6, shortlist_size=15,
                         exclude=BitMap(meta.frame_dbidx[excl]))
        assert got[0].tolist() == want["dbidxs"].tolist()
        np.testing.assert_allclose(got[3], _acts(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "int8"])
@pytest.mark.parametrize("S", [3, 8])
def test_mesh_index_clicks_match_jax(db, dtype, S):
    """`MultiscaleIndex(mesh=)` over one session's growing BitMap (the
    device-resident per-shard masks, a click's delta riding in) against
    the JAX mesh index over the same clicks."""
    meta, jmeta, V = db
    tidx = MultiscaleIndex(vectors=V, meta=meta, mesh=cpu_mesh(S), device_dtype=dtype)
    jidx = JIndex(vectors=V, meta=jmeta, mesh=jax_mesh(8), device_dtype=dtype)
    assert tidx.mesh.size == S and tidx._V is None
    rng = np.random.default_rng(2)
    t_ex, j_ex = BitMap(), JBitMap()
    for click in range(5):
        q = rng.normal(size=V.shape[1]).astype(np.float32)
        want = jidx.query(vector=q, topk=4, shortlist_size=12, exclude=j_ex)
        got = tidx.query(vector=q, topk=4, shortlist_size=12, exclude=t_ex)
        _same(got, want)
        seen = t_ex.to_array()  # the exclusions the query just applied
        t_ex.update(got["dbidxs"])
        j_ex.update(want["dbidxs"])
    # the session's mask stays on the shards, equal to the host mask
    entry = next(iter(tidx._excl_entries.values()))
    assert isinstance(entry.dev, list) and len(entry.dev) == S
    mask = torch.cat(entry.dev)[: meta.n_frames].numpy()
    assert np.nonzero(mask)[0].tolist() == np.searchsorted(meta.frame_dbidx, seen).tolist()


@pytest.mark.parametrize("S", SHARDS)
def test_cutoff_tie_resolves_as_one_device(S):
    """Ties planted at the global shortlist cutoff across shards (frames
    10..19 share one raw max; their augmented scores rise with id): the
    shards shortlist exactly the single device's frames (lowest ids)."""
    n_frames, d = 24, 8
    dbidx = np.repeat(np.arange(n_frames), 2)
    zoom = np.tile([1, 2], n_frames)
    boxes = np.tile(np.array([[0, 0, 64, 64], [0, 0, 128, 128]], np.float32), (n_frames, 1))
    s0 = np.concatenate([10.0 - 0.1 * np.arange(10), np.full(10, 5.0), np.full(4, 1.0)])
    s1 = np.concatenate([10.0 - 0.1 * np.arange(10), 3.0 + 0.2 * np.arange(10),
                         np.full(4, 1.0)])
    V = np.zeros((n_frames * 2, d), np.float32)
    V[0::2, 0], V[1::2, 0] = s0, s1
    meta, order = VectorMeta.from_arrays(dbidx, zoom, boxes)
    jmeta, _ = JMeta.from_arrays(dbidx, zoom, boxes)
    V = V[order]
    q = np.zeros(d, np.float32)
    q[0] = 1.0
    excl = np.zeros(n_frames, dtype=bool)
    jidx = jsi.ShardedFrameIndex.build(V, jmeta, jax_mesh(8))
    want = jsi.sharded_query_topk(jidx, q, excl, topk=12, shortlist_size=15)
    assert set(want[0].tolist()) == set(range(10)) | {13, 14}
    idx = tsi.ShardedFrameIndex.build(V, meta, cpu_mesh(S))
    got = tsi.sharded_query_topk(idx, q, excl, topk=12, shortlist_size=15)
    assert got[0].tolist() == want[0].tolist()
    np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    one = MultiscaleIndex(device="cpu", vectors=V, meta=meta)
    assert one.query(vector=q, topk=12, shortlist_size=15)["dbidxs"].tolist() == got[0].tolist()


@pytest.mark.parametrize("S", [4, 8])
def test_fewer_frames_than_shards(S):
    rng = np.random.default_rng(3)
    xy = rng.uniform(0, 100, size=(6, 2)).astype(np.float32)
    wh = rng.uniform(10, 60, size=(6, 2)).astype(np.float32)
    args = (np.array([0, 0, 1, 2, 2, 2]), np.array([1, 2, 1, 1, 1, 2]),
            np.concatenate([xy, xy + wh], axis=1))
    meta, order = VectorMeta.from_arrays(*args)
    V = rng.normal(size=(6, 16)).astype(np.float32)[order]
    idx = tsi.ShardedFrameIndex.build(V, meta, cpu_mesh(S))
    q = rng.normal(size=16).astype(np.float32)
    got = tsi.sharded_query_topk(idx, q, np.zeros(3, bool), topk=3, shortlist_size=3)
    jidx = jsi.ShardedFrameIndex.build(V, JMeta.from_arrays(*args)[0], jax_mesh(8))
    want = jsi.sharded_query_topk(jidx, q, np.zeros(3, bool), topk=3, shortlist_size=3)
    assert got[0].tolist() == want[0].tolist() and set(got[0].tolist()) == {0, 1, 2}
    np.testing.assert_allclose(got[1], want[1], **TOL)


@pytest.fixture(scope="module")
def big_db():
    # 2003 frames x ~4 tiles; the last shard is part padding for every S
    return _ragged(2003, 32, seed=1, max_tiles=7)


@pytest.mark.parametrize("S", SHARDS)
def test_wholly_excluded_shards(big_db, S):
    """Every frame of the first and the last shard excluded (the ragged tail
    with it), then everything excluded: an empty result, as in JAX."""
    meta, jmeta, V = big_db
    tidx = MultiscaleIndex(vectors=V, meta=meta, mesh=cpu_mesh(S))
    one = MultiscaleIndex(device="cpu", vectors=V, meta=meta)
    jidx = JIndex(vectors=V, meta=jmeta, mesh=jax_mesh(8))
    Fs = tidx._sharded.n_frames_local
    ords = np.concatenate([np.arange(0, Fs), np.arange((S - 1) * Fs, meta.n_frames)])
    q = np.random.default_rng(5).normal(size=32).astype(np.float32)
    got = tidx.query(vector=q, topk=10, shortlist_size=40,
                     exclude=BitMap(meta.frame_dbidx[ords]))
    _same(got, one.query(vector=q, topk=10, shortlist_size=40,
                         exclude=BitMap(meta.frame_dbidx[ords])), dict(rtol=1e-6))
    _same(got, jidx.query(vector=q, topk=10, shortlist_size=40,
                          exclude=JBitMap(meta.frame_dbidx[ords])))
    assert not set(got["dbidxs"].tolist()) & set(meta.frame_dbidx[ords].tolist())
    empty = tidx.query(vector=q, topk=5, shortlist_size=20, exclude=BitMap(meta.frame_dbidx))
    assert len(empty["dbidxs"]) == 0


def test_shortlist_exceeds_shard_frames():
    meta, jmeta, V = _ragged(19, 16, seed=3, max_tiles=7)
    q = np.random.default_rng(4).normal(size=16).astype(np.float32)
    got = MultiscaleIndex(vectors=V, meta=meta, mesh=cpu_mesh(8)).query(
        vector=q, topk=12, shortlist_size=50)
    _same(got, JIndex(vectors=V, meta=jmeta, mesh=jax_mesh(8)).query(
        vector=q, topk=12, shortlist_size=50))
    _same(got, MultiscaleIndex(device="cpu", vectors=V, meta=meta).query(
        vector=q, topk=12, shortlist_size=50), dict(rtol=1e-6))


@pytest.mark.parametrize("S", SHARDS)
def test_discount_vector_matches_jax(S):
    """The two-query discount (multi_reg_neg's `vector2`) over the mesh."""
    meta, jmeta, V = _ragged(40, 16, seed=0, max_tiles=4)
    rng = np.random.default_rng(0)
    q, q2 = (rng.normal(size=16).astype(np.float32) for _ in range(2))
    got = MultiscaleIndex(vectors=V, meta=meta, mesh=cpu_mesh(S)).query(
        vector=q, vector2=q2, topk=8, shortlist_size=20)
    _same(got, JIndex(vectors=V, meta=jmeta, mesh=jax_mesh(8)).query(
        vector=q, vector2=q2, topk=8, shortlist_size=20))
    _same(got, MultiscaleIndex(device="cpu", vectors=V, meta=meta).query(
        vector=q, vector2=q2, topk=8, shortlist_size=20))


@pytest.mark.parametrize("S", SHARDS)
def test_batch_equals_solo_and_jax(db, S):
    meta, jmeta, V = db
    rng = np.random.default_rng(7)
    Q = 5
    qs = rng.normal(size=(Q, V.shape[1])).astype(np.float32)
    excl = np.zeros((Q, meta.n_frames), dtype=bool)
    for i in range(Q):
        excl[i, rng.choice(meta.n_frames, size=6, replace=False)] = True
    idx = tsi.ShardedFrameIndex.build(V, meta, cpu_mesh(S))
    batch = tsi.sharded_query_topk_batch(idx, qs, excl, topk=8, shortlist_size=20)
    jbatch = jsi.sharded_query_topk_batch(jsi.ShardedFrameIndex.build(V, jmeta, jax_mesh(8)),
                                          qs, excl, topk=8, shortlist_size=20)
    for i in range(Q):
        solo = tsi.sharded_query_topk(idx, qs[i], excl[i], topk=8, shortlist_size=20)
        for got in (batch[i], solo):
            assert got[0].tolist() == jbatch[i][0].tolist()
            for k in (1, 2, 3):
                np.testing.assert_allclose(got[k], jbatch[i][k], **TOL)


@pytest.mark.parametrize("S", SHARDS)
def test_rank_by_scores_matches_jax(db, S):
    """External per-tile scores (the knn_prop2 round's ranking) under an
    exclusion of the top frames, through the index and the direct API."""
    meta, jmeta, V = db
    scores = np.random.default_rng(5).normal(size=meta.n_vectors).astype(np.float32)
    tidx = MultiscaleIndex(vectors=V, meta=meta, mesh=cpu_mesh(S))
    one = MultiscaleIndex(device="cpu", vectors=V, meta=meta)
    jidx = JIndex(vectors=V, meta=jmeta, mesh=jax_mesh(8))
    head = one.rank_by_scores(scores, topk=3)["dbidxs"].tolist()
    for topk, sl in ((5, 20), (8, None)):
        got = tidx.rank_by_scores(scores, topk=topk, shortlist_size=sl, exclude=BitMap(head))
        _same(got, jidx.rank_by_scores(scores, topk=topk, shortlist_size=sl,
                                       exclude=JBitMap(head)), dict(rtol=2e-6))
        _same(got, one.rank_by_scores(scores, topk=topk, shortlist_size=sl,
                                      exclude=BitMap(head)), dict(rtol=1e-6))
    got = tsi.sharded_rank_by_scores(tidx._sharded, scores, np.zeros(meta.n_frames, bool),
                                     topk=6, shortlist_size=18)
    want = jsi.sharded_rank_by_scores(jidx._sharded, scores, np.zeros(meta.n_frames, bool),
                                      topk=6, shortlist_size=18)
    assert got[0].tolist() == want[0].tolist()
    np.testing.assert_allclose(got[1], want[1], rtol=2e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_device_built_split_equals_host_build(dtype):
    """`MultiscaleIndex.from_device_arrays(mesh=)` slices the padded
    matrix into the shards (views where whole; per-frame int8 scales become
    per-row): queries and row gathers equal the host-built mesh index's
    and the one-device device-built index's."""
    from seesaw_tpu_torch.utils import rounds as R

    gen = torch.Generator().manual_seed(0)
    one = R.device_index(800, 16, dtype, device="cpu", generator=gen,
                         int8_scale="frame" if dtype == "int8" else "row")
    m = cpu_mesh(3)
    V, valid = one._V, one._valid
    sharded = MultiscaleIndex.from_device_arrays(
        embedding=None, V=V, valid=valid, boxes=one._boxes, zoom=one._zoom, meta=one.meta,
        row_scale=None if dtype == "int8" else one._row_scale,
        frame_scale=one._frame_scale, mesh=m)
    assert sharded._sharded.V[0].data_ptr() == V.data_ptr()
    rng = np.random.default_rng(0)
    ex = BitMap()
    for _ in range(3):
        q = rng.normal(size=16).astype(np.float32)
        got = sharded.query(vector=q, topk=5, shortlist_size=20, exclude=ex)
        _same(got, one.query(vector=q, topk=5, shortlist_size=20, exclude=ex),
              dict(rtol=1e-6))
        ex.update(got["dbidxs"])
    rows = np.array([0, 7, 799, 401, 266])
    np.testing.assert_array_equal(sharded.vectors_for_rows(rows), one.vectors_for_rows(rows))
    np.testing.assert_allclose(sharded.score(q), one.score(q), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sharded.score_frames(q), one.score_frames(q),
                               rtol=1e-6, atol=1e-6)


def test_coalescer_batches_sharded_index():
    """Concurrent coalesced queries over a mesh index run one sharded
    batch and return what the JAX coalescer's solo results are."""
    from seesaw_tpu_torch.web.coalesce import QueryCoalescer

    rng = np.random.default_rng(11)
    n_frames, tiles, d = 40, 4, 16
    dbidx = np.repeat(np.arange(n_frames), tiles)
    zoom = np.tile([1, 1, 2, 2], n_frames)
    xy = rng.uniform(0, 100, size=(n_frames * tiles, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + 60], axis=1)
    meta, order = VectorMeta.from_arrays(dbidx, zoom, boxes)
    jmeta, _ = JMeta.from_arrays(dbidx, zoom, boxes)
    V = rng.normal(size=(n_frames * tiles, d)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    V = V[order]
    idx = MultiscaleIndex(vectors=V, meta=meta, mesh=cpu_mesh(4))
    jidx = JIndex(vectors=V, meta=jmeta, mesh=jax_mesh(8))
    co = QueryCoalescer(idx, window_ms=25.0, max_batch=8)
    n_threads = 5
    qs = rng.normal(size=(n_threads, d)).astype(np.float32)
    excludes = [rng.choice(meta.frame_dbidx, size=5, replace=False) for _ in range(n_threads)]
    results, errors = [None] * n_threads, []

    def worker(i):
        try:
            results[i] = co.query(vector=qs[i], topk=6, shortlist_size=20,
                                  exclude=BitMap(excludes[i]))
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert co.stats["batched"] > 0, co.stats
    for i in range(n_threads):
        _same(results[i], jidx.query(vector=qs[i], topk=6, shortlist_size=20,
                                     exclude=JBitMap(excludes[i])))


MESH_OPTIONS = {
    "plain": {},
    "rocchio_update": dict(rocchio_alpha=1.0, rocchio_beta=0.7, rocchio_gamma=0.3),
    "log_reg2": dict(class_weights="balanced", scale="centered", reg_lambda=5.0,
                     fit_intercept=False, max_iter=50),
    "knn_prop2": dict(matrix_options=dict(knn_path="k5", knn_k=5, edist=0.5),
                      normalize_scores=True, normalize_epsilon=0.1,
                      sigmoid_before_propagate=True, calib_a=2.0, calib_b=-0.5,
                      prior_weight=1.0),
}


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from synth import build_synthetic_root

    from seesaw_tpu.knn_graph import KNNGraph

    root = tmp_path_factory.mktemp("torch_mesh_session")
    gdm, ds, info = build_synthetic_root(str(root), dataset_name="msess")
    idx = ds.load_index("multiscale", options={})
    KNNGraph.build(idx.vectors, n_neighbors=5).save(idx.get_knng_path(name="k5"))
    table, _ = ds.load_ground_truth()
    return str(root), info["is_pos"], {int(d): b for d, b in zip(table.dbidx, table.boxes)}


@pytest.mark.parametrize("method", list(MESH_OPTIONS))
def test_session_over_mesh_index(synth_root, method):
    """Sessions over `from_path(mesh=)` (4 CPU shards) against the JAX
    package's sessions over its sharded index (`{"sharded": True}`, 8
    virtual devices): same images every round, activation scores within
    the single-device session bar."""
    from test_torch_session import _drive

    from seesaw_tpu.dataset import GlobalDataManager as JaxGDM
    from seesaw_tpu.session import make_session as jax_make_session
    from seesaw_tpu_torch.dataset import GlobalDataManager as TorchGDM
    from seesaw_tpu_torch.session import make_session as torch_make_session

    root, is_pos, gt = synth_root

    def params(bt, index_options):
        return bt.SessionParams(
            index_spec=bt.IndexSpec(d_name="msess", i_name="multiscale"),
            interactive=method, batch_size=3, shortlist_size=20,
            interactive_options=MESH_OPTIONS[method], index_options=index_options)

    s_jax = jax_make_session(JaxGDM(root), params(jbt, {"sharded": True}))["session"]
    s_torch = torch_make_session(TorchGDM(root), params(tbt, {"mesh": cpu_mesh(4)}),
                                 device="cpu")["session"]
    assert s_torch.index.mesh.size == 4
    want = _drive(s_jax, is_pos, gt, jbt.Box)
    got = _drive(s_torch, is_pos, gt, tbt.Box)
    for r, (g, w) in enumerate(zip(got, want)):
        assert g["dbidxs"] == w["dbidxs"], f"round {r}"
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-5, atol=1e-6)
    assert s_torch.seen.to_array().tolist() == s_jax.seen.to_array().tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_cuda_mesh_query_launches_k1_per_shard(dtype):
    """On a card (3 shards on cuda:0): each solo query launches the fused
    scan once per shard, and equals the one-device index's query. D = 32:
    the kernel reads rows of a multiple of 16 bytes (int8 included)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from seesaw_tpu_torch.ops import fused_scoring

    meta, _, V = _ragged(41, 32, seed=0)
    dev = torch.device("cuda", 0)
    m = MultiscaleIndex(vectors=V, meta=meta, mesh=tmesh.make_mesh(devices=[dev] * 3),
                        device_dtype=dtype)
    one = MultiscaleIndex(device=dev, vectors=V, meta=meta, device_dtype=dtype)
    rng = np.random.default_rng(3)
    ex = BitMap()
    for _ in range(3):
        q = rng.normal(size=V.shape[1]).astype(np.float32)
        before = fused_scoring.fused_frame_max.launches
        got = m.query(vector=q, topk=5, shortlist_size=12, exclude=ex)
        assert fused_scoring.fused_frame_max.launches - before == 3
        _same(got, one.query(vector=q, topk=5, shortlist_size=12, exclude=ex), dict(rtol=1e-6))
        ex.update(got["dbidxs"])
