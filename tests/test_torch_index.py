"""The port's single-device MultiscaleIndex against the JAX index, on the
same on-disk root (tests/synth.py) or the same numpy arrays, on the CPU.

Tolerances: dbidxs equal; f32 activation scores rtol 1e-5 (f32 dots summed
in another order); bf16 rtol 1e-5 (both read the same bf16 bytes and sum in
f32); int8 rtol 1e-5 (exact int32 dots; the fused frame max multiplies its
scales in another order than the JAX XLA path, the rescored activations in
the same); device row sums atol 1e-5 (f32) / 5e-2 (int8 dequantized against
the exact host rows).
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synth import build_synthetic_root  # noqa: E402

from seesaw_tpu.indices.interface import AccessMethod  # noqa: E402
from seesaw_tpu.indices.meta import VectorMeta  # noqa: E402
from seesaw_tpu.indices.multiscale import MultiscaleIndex as JaxIndex  # noqa: E402
from seesaw_tpu.runtime.bitmap import BitMap  # noqa: E402
from seesaw_tpu_torch import convert  # noqa: E402
from seesaw_tpu_torch.indices.loader import load_index  # noqa: E402
from seesaw_tpu_torch.indices.meta import VectorMeta as TMeta  # noqa: E402
from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex  # noqa: E402
from seesaw_tpu_torch.ops.frame_scoring import DeferredLogistic  # noqa: E402
from seesaw_tpu_torch.runtime.bitmap import BitMap as TBitMap  # noqa: E402


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("torch_index")
    _, ds, _ = build_synthetic_root(str(r), dataset_name="tidx")
    return ds.index_path("multiscale")


def _make_arrays(n_images=30, d=32, seed=0):
    """Ragged tiling (2..5 tiles per image), non-contiguous dbidxs."""
    rng = np.random.default_rng(seed)
    img = 224.0
    quads = [(0.0, 0.0, img / 2, img / 2), (img / 2, 0.0, img, img / 2),
             (0.0, img / 2, img / 2, img), (img / 2, img / 2, img, img)]
    dbidx, zoom, boxes = [], [], []
    for i in range(n_images):
        tiles = [(1, q) for q in quads] + [(2, (0.0, 0.0, img, img))]
        for zl, bx in tiles[: int(rng.integers(2, 6))]:
            dbidx.append(i * 3)
            zoom.append(zl)
            boxes.append(bx)
    meta, _ = VectorMeta.from_arrays(np.array(dbidx), np.array(zoom),
                                     np.array(boxes, np.float32))
    V = rng.normal(size=(meta.n_vectors, d)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    return V, meta


def _tmeta(meta):
    """The same metadata as the port's own VectorMeta."""
    return TMeta(**{f: getattr(meta, f) for f in TMeta.__dataclass_fields__})


def _query(idx, q, exclude, **kw):
    r = idx.query(vector=q, topk=4, shortlist_size=12, exclude=exclude, **kw)
    return (list(r["dbidxs"]), [a["score"] for a in r["activations"]],
            [(a["x1"], a["y1"], a["x2"], a["y2"]) for a in r["activations"]])


def test_from_path_query_parity(root):
    jidx = AccessMethod.load(root, options={"use_pallas": True})
    tidx = load_index(root, device="cpu", options={"use_pallas": True})
    assert isinstance(tidx, MultiscaleIndex) and isinstance(jidx, JaxIndex)
    # the port's loader keeps a cache of its own: same key, other object
    assert load_index(root, device="cpu", options={"use_pallas": True}) is tidx
    rng = np.random.default_rng(1)
    excl_j, excl_t = BitMap(), TBitMap()
    for _ in range(4):
        q = rng.normal(size=tidx.dim).astype(np.float32)
        want, got = _query(jidx, q, excl_j), _query(tidx, q, excl_t)
        assert got[0] == want[0]
        assert got[2] == want[2]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)
        excl_j.update(want[0][:2])
        excl_t.update(got[0][:2])
    np.testing.assert_array_equal(tidx.score(q), jidx.score(q))
    # the JAX index pads the frame axis to the Pallas block size; the port
    # returns exactly one value per frame
    np.testing.assert_allclose(tidx.score_frames(q),
                               jidx.score_frames(q)[: tidx.n_frames], rtol=1e-5)


def test_incremental_exclusion_matches_full_rebuild():
    V, meta = _make_arrays()
    idx = MultiscaleIndex(device="cpu", vectors=V, meta=_tmeta(meta))
    oracle = MultiscaleIndex(device="cpu", vectors=V, meta=_tmeta(meta))
    jidx = JaxIndex(vectors=V, meta=meta, use_pallas=True)
    q = np.random.default_rng(1).normal(size=V.shape[1]).astype(np.float32)
    returned = TBitMap()  # one evolving bitmap, like InteractiveQuery.returned
    for r in range(6):
        got = _query(idx, q, returned)
        fresh = TBitMap(returned.to_array())  # always a full rebuild
        want = _query(oracle, q, fresh)
        jwant = _query(jidx, q, BitMap(returned.to_array()))
        assert got[0] == want[0] == jwant[0], f"round {r}"
        np.testing.assert_allclose(got[1], jwant[1], rtol=1e-5)
        returned.update(got[0][:2])
    # the shared base mask for exclude=None never changed
    _query(idx, q, None)
    assert not idx._excl_base.any()
    # a shrinking set falls back to a rebuild and the image is rankable again
    removed = got[0][0]
    returned.discard(removed)
    assert removed in _query(idx, q, returned)[0]


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_from_device_arrays_and_row_sums(dtype):
    V, meta = _make_arrays(seed=2)
    jidx = JaxIndex(vectors=V, meta=meta, device_dtype=dtype, use_pallas=True)
    host = MultiscaleIndex(device="cpu", vectors=V, meta=_tmeta(meta), device_dtype=dtype)
    dev = convert.index_from_device_state(
        np.asarray(jidx._V), np.asarray(jidx._valid), np.asarray(jidx._boxes),
        np.asarray(jidx._zoom), _tmeta(meta), device="cpu",
        row_scale=None if jidx._row_scale is None else np.asarray(jidx._row_scale),
    )
    assert dev.vectors is None
    np.testing.assert_array_equal(dev._V.numpy(), host._V.numpy())  # same bytes
    rng = np.random.default_rng(9)
    groups = [rng.choice(meta.n_vectors, size=17, replace=False),
              rng.choice(meta.n_vectors, size=5, replace=False),
              np.zeros(0, dtype=np.int64)]
    got = dev.sum_vectors_for_rows(groups)
    atol = 1e-5 if dtype == "float32" else 5e-2
    np.testing.assert_allclose(got, host.sum_vectors_for_rows(groups), atol=atol)
    assert (got[2] == 0).all()
    rows = rng.choice(meta.n_vectors, size=13, replace=False)
    np.testing.assert_allclose(dev.vectors_for_rows(rows), V[rows], atol=atol)

    q = rng.normal(size=V.shape[1]).astype(np.float32)
    returned = TBitMap()
    for _ in range(3):
        got_q = _query(dev, q, returned)
        want = _query(jidx, q, BitMap(returned.to_array()))
        assert got_q[0] == want[0]
        np.testing.assert_allclose(got_q[1], want[1], rtol=1e-5)
        returned.update(got_q[0][:2])


@pytest.mark.parametrize("dtype,int8_scale", [
    ("bfloat16", "row"), ("int8", "row"), ("int8", "frame"),
])
def test_low_precision_storage_matches_jax(dtype, int8_scale):
    V, meta = _make_arrays(n_images=40, seed=3)
    jidx = JaxIndex(vectors=V, meta=meta, device_dtype=dtype,
                    int8_scale=int8_scale, use_pallas=True)
    tidx = MultiscaleIndex(device="cpu", vectors=V, meta=_tmeta(meta),
                           device_dtype=dtype, int8_scale=int8_scale)
    n = meta.n_frames * tidx._tile_bound
    jV = np.asarray(jidx._V)[:n]
    if dtype == "int8":  # quantized by the same numpy code: same bytes
        np.testing.assert_array_equal(tidx._V.numpy(), jV)
        np.testing.assert_array_equal(tidx._row_scale.numpy(),
                                      np.asarray(jidx._row_scale)[:n])
    else:
        np.testing.assert_array_equal(tidx._V.float().numpy(), jV.astype(np.float32))
    rng = np.random.default_rng(4)
    for _ in range(3):
        q = rng.normal(size=V.shape[1]).astype(np.float32)
        got, want = _query(tidx, q, None), _query(jidx, q, None)
        assert got[0] == want[0]
        np.testing.assert_allclose(got[1], want[1], rtol=1e-5)


def test_diverged_fit_raises_before_the_exclusion_commit():
    V, meta = _make_arrays(seed=5)
    idx = MultiscaleIndex(device="cpu", vectors=V, meta=_tmeta(meta))
    excl = TBitMap()
    q = np.random.default_rng(6).normal(size=V.shape[1]).astype(np.float32)
    first = _query(idx, q, excl)
    excl.update(first[0])
    _query(idx, q, excl)  # publishes the session's device mask
    entry = idx._excl_entries[id(excl)]
    prev, dev = entry.prev.to_array().tolist(), entry.dev
    excl.update([int(meta.frame_dbidx[-1])])
    d = V.shape[1]
    dv = DeferredLogistic(
        prows=np.arange(4, dtype=np.int64), y=np.array([1, 0, 1, 0], np.float32),
        sw=np.ones(4, np.float32), n_real=4, pos_weight=1.0, reg_weight=1.0,
        anchor=np.zeros(d, np.float32),
        params0=np.full(d + 1, np.nan, np.float32),  # NaN loss from the start
        fit_intercept=False, max_iter=10, has_anchor=False, center=True, model=None,
    )
    with pytest.raises(ValueError, match="diverged"):
        idx.query(vector=dv, topk=4, shortlist_size=12, exclude=excl)
    assert entry.prev.to_array().tolist() == prev and entry.dev is dev
