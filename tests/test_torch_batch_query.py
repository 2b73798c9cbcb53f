"""The port's batch programs and request coalescer against the JAX package.

`seesaw_tpu_torch.ops.frame_scoring.query_program_batch*` against
`seesaw_tpu.ops.frame_scoring`'s on the same numpy inputs (Q = 5 queries,
each with its own exclusion mask), in f32, bf16, int8 with per-row scales
and int8 with per-frame scales (f32 and both int8 kinds at all 18
`aug_larger` x `aug_weight` x `agg_method` combinations); then the port's batch against its own solo
queries, and `seesaw_tpu_torch.web.coalesce` as `tests/test_batch_query.py`
holds the JAX coalescer: transparent under threads, a single caller passed
through, the frame-scale program chosen, masks that stay incremental, and
sessions that share one coalescing index.

Tolerances: ids and updated masks equal; scores rtol 1e-5 (f32 dots of 32
terms summed in another order; int8 dots are exact and dequantized in the
JAX package's order).
"""
import itertools
import sys
import threading
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from seesaw_tpu.ops import frame_scoring as jfs
from seesaw_tpu_torch.indices.meta import VectorMeta
from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex, quantize_int8
from seesaw_tpu_torch.ops import frame_scoring as tfs
from seesaw_tpu_torch.runtime.bitmap import BitMap
from seesaw_tpu_torch.web.coalesce import CoalescingIndex, QueryCoalescer

sys.path.insert(0, str(Path(__file__).resolve().parent))

Q, F, T, D = 5, 48, 8, 32
RANK = dict(shortlist_size=20, topk=6, aug_larger="all", aug_weight="level_max",
            agg_method="avg_score", max_zoom=3)


def _arrays(seed):
    """A frame-major padded matrix with invalid tiles, boxes, zoom levels,
    Q queries, Q distinct masks and Q click deltas (-1 padded)."""
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(F * T, D)).astype(np.float32)
    valid = rng.random((F, T)) < 0.8
    valid[:, 0] = True
    valid[3] = False  # a frame with no valid tile
    V[~valid.reshape(-1)] = 0.0
    xy = rng.uniform(0, 100, size=(F * T, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.uniform(20, 60, size=(F * T, 2))],
                           axis=1).astype(np.float32)
    zoom = rng.integers(1, 4, size=F * T).astype(np.int32)
    qs = rng.normal(size=(Q, D)).astype(np.float32)
    excl = np.zeros((Q, F), dtype=bool)
    new_ids = np.full((Q, 8), -1, dtype=np.int32)
    for i in range(Q):
        excl[i, rng.choice(F, size=7, replace=False)] = True
        new_ids[i, :i] = rng.choice(F, size=i, replace=False)
    return V, valid, boxes, zoom, qs, excl, new_ids


def _store(V, kind):
    """(JAX matrix, port matrix, per-row scales, per-frame scales) of one
    storage kind; int8 by the JAX index's numpy quantization."""
    if kind in ("float32", "bfloat16"):
        return (jnp.asarray(V).astype(kind), torch.from_numpy(V).to(getattr(torch, kind)),
                None, None)
    V8, rs, fs = quantize_int8(V, T, "frame" if kind == "int8_frame" else "row")
    return jnp.asarray(V8), torch.from_numpy(V8), rs, fs


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _assert_batch_equal(got, want, n_queries=Q):
    for i in range(n_queries):
        n = int(np.asarray(want.n_valid)[i])
        assert int(got.n_valid[i]) == n
        np.testing.assert_array_equal(got.frame_ids[i].numpy(), np.asarray(want.frame_ids)[i])
        np.testing.assert_array_equal(got.act_boxes[i, :n].numpy(),
                                      np.asarray(want.act_boxes)[i, :n])
        np.testing.assert_allclose(got.frame_scores[i, :n].numpy(),
                                   np.asarray(want.frame_scores)[i, :n], rtol=1e-5)
        np.testing.assert_allclose(got.act_scores[i, :n].numpy(),
                                   np.asarray(want.act_scores)[i, :n], rtol=1e-5)


def _rank_cases():
    """The default ranking options (RANK) in every storage kind, and all 18
    `aug_larger` x `aug_weight` x `agg_method` combinations in f32 and in
    int8 with per-row and per-frame scales (as tests/test_torch_frame_scoring.py
    covers the solo path)."""
    default = (RANK["aug_larger"], RANK["aug_weight"], RANK["agg_method"])
    cases = [pytest.param(kind, *default, id=kind)
             for kind in ("float32", "bfloat16", "int8", "int8_frame")]
    for kind in ("float32", "int8", "int8_frame"):
        for combo in itertools.product(["all", "greater", "adjacent"],
                                       ["level_max", "cont_weighted"],
                                       ["avg_score", "avg_vector", "plain_score"]):
            if combo != default:
                cases.append(pytest.param(kind, *combo, id="-".join((kind, *combo))))
    return cases


@pytest.mark.parametrize("kind,aug_larger,aug_weight,agg_method", _rank_cases())
def test_batch_programs_match_jax(kind, aug_larger, aug_weight, agg_method):
    rank = dict(RANK, aug_larger=aug_larger, aug_weight=aug_weight, agg_method=agg_method)
    V, valid, boxes, zoom, qs, excl, new_ids = _arrays(seed=1)
    jV, tV, rs, fs = _store(V, kind)
    jargs = (jV, jnp.asarray(valid), jnp.asarray(boxes), jnp.asarray(zoom), jnp.asarray(qs))
    targs = (tV, _t(valid), _t(boxes), _t(zoom), _t(qs))
    if kind == "int8_frame":
        want = jfs.query_program_batch_framescale(*jargs, jnp.asarray(excl), _j(fs), **rank)
        got = tfs.query_program_batch_framescale(*targs, _t(excl), _t(fs), **rank)
        want_i, want_m = jfs.query_program_batch_framescale_incr(
            *jargs, jnp.asarray(excl), jnp.asarray(new_ids), _j(fs), **rank)
        got_i, got_m = tfs.query_program_batch_framescale_incr(
            *targs, _t(excl), _t(new_ids).long(), _t(fs), **rank)
    else:
        want = jfs.query_program_batch(*jargs, jnp.asarray(excl), _j(rs), **rank)
        got = tfs.query_program_batch(*targs, _t(excl), _t(rs), **rank)
        want_i, want_m = jfs.query_program_batch_incr(
            *jargs, jnp.asarray(excl), jnp.asarray(new_ids), _j(rs), **rank)
        got_i, got_m = tfs.query_program_batch_incr(
            *targs, _t(excl), _t(new_ids).long(), _t(rs), **rank)
    _assert_batch_equal(got, want)
    _assert_batch_equal(got_i, want_i)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(want_m))
    assert not torch.equal(got_m, _t(excl))  # the deltas landed, out of place


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "int8_frame"])
def test_scoring_matmat_matches_jax_and_matvec(kind):
    """Each column of the batch scan is the solo scan of its query (int8:
    exactly), and the scan is JAX's `scoring_matmat`."""
    V, _, _, _, qs, _, _ = _arrays(seed=2)
    jV, tV, rs, _ = _store(V, kind)
    got = tfs.scoring_matmat(tV, _t(qs), _t(rs))
    want = np.asarray(jfs.scoring_matmat(jV, jnp.asarray(qs), _j(rs)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    for i in range(Q):
        solo = tfs.scoring_matvec(tV, _t(qs[i]), _t(rs)).numpy()
        if kind.startswith("int8"):
            np.testing.assert_array_equal(got[:, i].numpy(), solo)
        else:
            np.testing.assert_allclose(got[:, i].numpy(), solo, rtol=1e-5, atol=1e-5)


def _db(n_frames=60, tiles=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    dbidx = np.repeat(np.arange(n_frames), tiles)
    zoom = np.tile(np.array([1, 1, 2, 2])[:tiles], n_frames)
    xy = rng.uniform(0, 100, size=(n_frames * tiles, 2)).astype(np.float32)
    wh = rng.uniform(20, 60, size=(n_frames * tiles, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + wh], axis=1)
    meta, order = VectorMeta.from_arrays(dbidx, zoom, boxes)
    V = rng.normal(size=(n_frames * tiles, d)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    return V[order], meta


@pytest.mark.parametrize("dtype,scale", [("float32", "row"), ("bfloat16", "row"),
                                         ("int8", "row"), ("int8", "frame")])
def test_batch_equals_solo_queries(dtype, scale):
    """The batch over a port index equals Q solo queries (the fused scan
    path) with the same masks."""
    V, meta = _db(seed=9)
    idx = MultiscaleIndex(device="cpu", vectors=V, meta=meta, device_dtype=dtype,
                          int8_scale=scale)
    rng = np.random.default_rng(10)
    qs = rng.normal(size=(Q, V.shape[1])).astype(np.float32)
    excl = np.zeros((Q, meta.n_frames), dtype=bool)
    for i in range(Q):
        excl[i, rng.choice(meta.n_frames, size=7, replace=False)] = True
    rank = dict(RANK, max_zoom=idx._max_zoom)
    args = (idx._V, idx._valid, idx._boxes, idx._zoom, _t(qs), _t(excl))
    if idx._frame_scale is not None:
        batch = tfs.query_program_batch_framescale(*args, idx._frame_scale, **rank)
    else:
        batch = tfs.query_program_batch(*args, idx._row_scale, **rank)
    for i in range(Q):
        mask = _t(excl[i])
        solo, _ = idx._fused_query(_t(qs[i]), mask, idx._new_ids_tensor(np.zeros(0, int)),
                                   rank)
        n = int(solo.n_valid)
        assert int(batch.n_valid[i]) == n
        assert torch.equal(batch.frame_ids[i, :n], solo.frame_ids[:n])
        np.testing.assert_allclose(batch.frame_scores[i, :n].numpy(),
                                   solo.frame_scores[:n].numpy(), rtol=1e-5)


def _threaded(co, qs, excludes, **kw):
    results, errors = [None] * len(qs), []

    def worker(i):
        try:
            results[i] = co.query(vector=qs[i], exclude=excludes[i], **kw)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(qs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    return results


@pytest.mark.parametrize("dtype,scale", [("float32", "row"), ("int8", "frame")])
def test_coalescer_transparent(monkeypatch, dtype, scale):
    """Concurrent queries coalesce and each gets its solo result; an
    int8_scale='frame' index batches through the frame-scale program."""
    V, meta = _db(seed=3)
    idx = MultiscaleIndex(device="cpu", vectors=V, meta=meta, device_dtype=dtype,
                          int8_scale=scale)
    calls = {"framescale": 0, "batch": 0}
    for name, key in (("query_program_batch_framescale_incr", "framescale"),
                      ("query_program_batch_incr", "batch")):
        orig = getattr(tfs, name)

        def spy(*a, _orig=orig, _key=key, **k):
            calls[_key] += 1
            return _orig(*a, **k)

        monkeypatch.setattr(tfs, name, spy)
    co = QueryCoalescer(idx, window_ms=25.0, max_batch=8)
    rng = np.random.default_rng(4)
    qs = rng.normal(size=(6, V.shape[1])).astype(np.float32)
    excludes = [BitMap(rng.choice(meta.frame_dbidx, size=5, replace=False)) for _ in qs]
    results = _threaded(co, qs, excludes, topk=5, shortlist_size=20)
    assert co.stats["batched"] > 0, "no requests were coalesced"
    assert co.stats["batched"] + co.stats["solo"] == len(qs)
    want_key = "framescale" if scale == "frame" else "batch"
    assert calls[want_key] > 0 and sum(calls.values()) == calls[want_key]
    for i in range(len(qs)):
        want = idx.query(vector=qs[i], topk=5, shortlist_size=20,
                         exclude=BitMap(excludes[i].to_array()))
        assert list(results[i]["dbidxs"]) == list(want["dbidxs"])
        np.testing.assert_allclose([a["score"] for a in results[i]["activations"]],
                                   [a["score"] for a in want["activations"]], rtol=1e-5)


def test_coalescer_single_caller_and_solo_routes():
    """A lone caller, a second (discount) vector, an unknown keyword and a
    deferred vector all take the solo path."""
    from seesaw_tpu_torch.ops.frame_scoring import DeferredRocchio

    V, meta = _db(seed=5)
    idx = MultiscaleIndex(device="cpu", vectors=V, meta=meta)
    co = QueryCoalescer(idx, window_ms=1.0)
    rng = np.random.default_rng(6)
    q, q2 = rng.normal(size=(2, V.shape[1])).astype(np.float32)
    got = co.query(vector=q, topk=4, shortlist_size=16, exclude=None)
    want = idx.query(vector=q, topk=4, shortlist_size=16, exclude=None)
    assert list(got["dbidxs"]) == list(want["dbidxs"])
    assert co.stats == {"batched": 0, "solo": 1, "dispatches": 0}
    got2 = co.query(vector=q, vector2=q2, topk=4, shortlist_size=16)
    assert list(got2["dbidxs"]) == list(idx.query(vector=q, vector2=q2, topk=4,
                                                  shortlist_size=16)["dbidxs"])
    dv = DeferredRocchio(q, [0, 1], [2], 1.0, 0.7, 0.3)
    got3 = co.query(vector=dv, topk=4, shortlist_size=16)
    assert list(got3["dbidxs"]) == list(idx.query(vector=dv, topk=4,
                                                  shortlist_size=16)["dbidxs"])
    got4 = co.query(vector=q, topk=4, shortlist_size=16, not_an_option=1)
    assert list(got4["dbidxs"]) == list(want["dbidxs"])
    assert co.stats["solo"] == 1  # the passthroughs never entered a group


@pytest.mark.parametrize("device_dtype", ["float32", "int8"])
def test_coalesced_rounds_stay_incremental(monkeypatch, device_dtype):
    """Coalesced clicks keep each session's device mask resident: after the
    first non-empty sighting of each session's BitMap, later rounds ship
    only delta ordinals (as `tests/test_batch_query.py` counts for JAX), and
    results equal a control index queried with fresh masks every round."""
    V, meta = _db(seed=11)
    idx = MultiscaleIndex(device="cpu", vectors=V, meta=meta, device_dtype=device_dtype,
                          int8_scale="frame")
    ctrl = MultiscaleIndex(device="cpu", vectors=V, meta=meta, device_dtype=device_dtype,
                           int8_scale="frame")
    co = QueryCoalescer(idx, window_ms=15.0, max_batch=8)
    rng = np.random.default_rng(12)
    n_sessions = 4
    qs = rng.normal(size=(n_sessions, V.shape[1])).astype(np.float32)
    excludes = [BitMap() for _ in range(n_sessions)]

    rebuilds = {"n": 0}
    orig = MultiscaleIndex._frame_exclusion_mask

    def counting(self, exclude):
        if self is idx:
            rebuilds["n"] += 1
        return orig(self, exclude)

    monkeypatch.setattr(MultiscaleIndex, "_frame_exclusion_mask", counting)
    for _ in range(4):
        results = _threaded(co, qs, excludes, topk=3, shortlist_size=15)
        for i in range(n_sessions):
            want = ctrl.query(vector=qs[i], topk=3, shortlist_size=15,
                              exclude=BitMap(excludes[i].to_array()))
            assert list(results[i]["dbidxs"]) == list(want["dbidxs"])
            for db in results[i]["dbidxs"]:
                assert db not in excludes[i]
                excludes[i].add(int(db))
    assert co.stats["batched"] > 0
    assert rebuilds["n"] == n_sessions, f"expected {n_sessions} rebuilds, saw {rebuilds['n']}"
    # every published mask is a tensor of its own, never a row of a stack
    for e in idx._excl_entries.values():
        assert e.dev.dim() == 1 and e.dev.untyped_storage().nbytes() == meta.n_frames


def test_from_path_coalesces_and_sessions_share_one_index(tmp_path):
    """`coalesce_ms` makes `from_path` return a CoalescingIndex; sessions
    on one root share it through the loader's cache, and their concurrent
    re-ranks merge into batched scans with no repeats. With a `mesh` the
    coalescing index wraps the sharded index; `sharded=True` asks for every
    visible card, so without one it is refused."""
    from synth import QSTR, build_synthetic_root

    from seesaw_tpu_torch import GlobalDataManager, IndexSpec, SessionParams, make_session
    from seesaw_tpu_torch.indices.loader import index_cache

    build_synthetic_root(str(tmp_path), dataset_name="shared")
    gdm = GlobalDataManager(str(tmp_path))
    path = gdm.get_dataset("shared").index_path("multiscale")
    assert isinstance(MultiscaleIndex.from_path(path, device="cpu", coalesce_ms=5),
                      CoalescingIndex)
    from seesaw_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(devices=["cpu"] * 2)
    ci = MultiscaleIndex.from_path(path, device="cpu", coalesce_ms=5, mesh=mesh)
    assert isinstance(ci, CoalescingIndex) and ci.mesh == mesh
    if not torch.cuda.is_available():
        with pytest.raises(AssertionError):
            MultiscaleIndex.from_path(path, coalesce_ms=5, sharded=True)

    def params():
        return SessionParams(
            index_spec=IndexSpec(d_name="shared", i_name="multiscale"),
            interactive="plain", batch_size=3, shortlist_size=20,
            agg_method="avg_score", aug_larger="all",
            index_options={"coalesce_ms": 25.0},
        )

    s1 = make_session(gdm, params(), device="cpu")["session"]
    s2 = make_session(gdm, params(), device="cpu")["session"]
    assert s1.index is s2.index, "sessions must share one index object"
    assert isinstance(s1.index, CoalescingIndex)
    plain = gdm.get_dataset("shared").load_index("multiscale", device="cpu", options={})
    assert not isinstance(plain, CoalescingIndex)  # the key carries the options
    s1.set_text(QSTR)
    s2.set_text(QSTR)
    results = {}

    def drive(name, s):
        for _ in range(3):
            results.setdefault(name, []).extend(int(i) for i in s.next())

    threads = [threading.Thread(target=drive, args=(n, s)) for n, s in (("a", s1), ("b", s2))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert s1.index._coalescer.stats["batched"] > 0, s1.index._coalescer.stats
    assert len(results["a"]) == len(set(results["a"])) == 9
    assert len(results["b"]) == len(set(results["b"])) == 9
    index_cache.invalidate_prefix(str(tmp_path))
    again = gdm.get_dataset("shared").load_index("multiscale", device="cpu", options={})
    assert again is not plain  # a rebuilt root is never served from the stale entry


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "int8_frame"])
def test_card_batch_programs_match_plain(kind):
    """On the card the batch scan is the library product (`torch.mm` with
    f32 output, `torch._int_mm` with Q padded from 5 to 8): the batch
    programs equal their plain versions on the same tensors (int8 exactly)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's routes have no CPU mode")
    dev = torch.device("cuda")
    V, valid, boxes, zoom, qs, excl, new_ids = _arrays(seed=3)
    _, tV, rs, fs = _store(V, kind)
    args = [tV, _t(valid), _t(boxes), _t(zoom), _t(qs), _t(excl), _t(new_ids).long()]
    args = [a.to(dev) for a in args]
    if kind == "int8_frame":
        run = tfs.query_program_batch_framescale_incr
        args.append(_t(fs).to(dev))
    else:
        run = tfs.query_program_batch_incr
        args.append(None if rs is None else _t(rs).to(dev))
    got, got_m = run(*args, **RANK)
    want, want_m = run(*args, **RANK, plain=True)
    assert torch.equal(got_m, want_m)
    assert torch.equal(got.frame_ids, want.frame_ids)
    tol = dict(rtol=0, atol=0) if kind.startswith("int8") else dict(rtol=1e-5, atol=1e-5)
    for a, b in ((got.frame_scores, want.frame_scores), (got.act_scores, want.act_scores)):
        fin = torch.isfinite(b)
        torch.testing.assert_close(a[fin], b[fin], **tol)
