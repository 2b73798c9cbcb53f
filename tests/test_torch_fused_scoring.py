"""The port's fused score + frame-max (`seesaw_tpu_torch.ops.fused_scoring`)
against the JAX Pallas kernel run in interpret mode, on the same numpy
inputs. On the CPU the port's wrapper runs its plain PyTorch version; the
CUDA kernel itself is compared with that plain version on the card by the
`cuda`-marked test (skipped without a GPU) and by chip_smoke.py.

Tolerances: f32 rtol 1e-5 / atol 1e-5 (one f32 dot of D=32 terms summed in
another order); int8 rtol 1e-6 (exact int32 dots, identical f32 epilogue).
The -inf pattern must be identical.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seesaw_tpu.ops import pallas_scoring as jps
from seesaw_tpu_torch.ops import fused_scoring as tfs

BF = 1024  # the Pallas kernel's frame-block granularity (JAX side only)


def _db(seed, F=45, T=8, D=32, dtype="float32"):
    rng = np.random.default_rng(seed)
    V = rng.normal(size=(F * T, D)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    valid = rng.random((F, T)) < 0.7
    valid[:, 0] = True
    valid[3] = False  # a frame with no valid tile at all
    V[~valid.reshape(-1)] = 0.0
    excluded = rng.random(F) < 0.2
    q = rng.normal(size=D).astype(np.float32)
    row_scale = None
    if dtype == "int8":
        rmax = np.abs(V).max(axis=1)
        row_scale = np.where(rmax > 0, rmax / 127.0, 1.0).astype(np.float32)
        V = np.clip(np.round(V / row_scale[:, None]), -127, 127).astype(np.int8)
    return V, valid, excluded, q, row_scale


def _jax_padded(V, valid, row_scale):
    F, T = valid.shape
    Fp = -(-F // BF) * BF
    Vp = np.zeros((Fp * T, V.shape[1]), V.dtype)
    Vp[: F * T] = V
    rs = None
    if row_scale is not None:
        rs = np.ones(Fp * T, np.float32)
        rs[: F * T] = row_scale
    return Vp, rs


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_fused_frame_max_matches_pallas(dtype):
    V, valid, excluded, q, rs = _db(0, dtype=dtype)
    Vp, rsp = _jax_padded(V, valid, rs)
    want = np.asarray(jps.fused_frame_max(
        jnp.asarray(Vp), jnp.asarray(valid), jnp.asarray(excluded), jnp.asarray(q),
        None if rsp is None else jnp.asarray(rsp),
        tile_bound=valid.shape[1], block_frames=BF, interpret=True,
    ))
    before = tfs.fused_frame_max.launches
    got = tfs.fused_frame_max(_t(V), _t(valid), _t(excluded), _t(q), _t(rs)).numpy()
    assert tfs.fused_frame_max.launches == before  # CPU: plain version, no launch
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    np.testing.assert_array_equal(got[~np.isfinite(got)], want[~np.isfinite(want)])
    fin = np.isfinite(want)
    rtol, atol = (1e-5, 1e-5) if dtype == "float32" else (1e-6, 0.0)
    np.testing.assert_allclose(got[fin], want[fin], rtol=rtol, atol=atol)
    assert not np.isfinite(got[3])  # fully invalid frame


@pytest.mark.parametrize("incr", [False, True])
def test_query_program_fused_matches_pallas(incr):
    V, valid, excluded, q, _ = _db(1)
    F, T = valid.shape
    rng = np.random.default_rng(2)
    xy = rng.uniform(0, 100, size=(F * T, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + 40], axis=1)
    zoom = rng.integers(1, 4, size=F * T).astype(np.int32)
    new_ids = np.array([5, 11, -1, -1], np.int32)
    kw = dict(shortlist_size=12, topk=5, aug_larger="all", aug_weight="level_max",
              agg_method="avg_score", max_zoom=4)
    Vp, _ = _jax_padded(V, valid, None)
    jargs = [jnp.asarray(a) for a in (Vp, valid, boxes, zoom, q, excluded)]
    targs = [_t(a) for a in (V, valid, boxes, zoom, q, excluded)]
    if incr:
        want, wmask = jps.query_program_fused_incr(
            *jargs, jnp.asarray(new_ids), tile_bound=T, block_frames=BF,
            interpret=True, **kw)
        got, gmask = tfs.query_program_fused_incr(*targs, _t(new_ids).long(), **kw)
        np.testing.assert_array_equal(gmask.numpy(), np.asarray(wmask))
        assert not targs[5][5]  # the input mask was not changed in place
    else:
        want = jps.query_program_fused(*jargs, tile_bound=T, block_frames=BF,
                                       interpret=True, **kw)
        got = tfs.query_program_fused(*targs, **kw)
    n = int(want.n_valid)
    assert int(got.n_valid) == n
    np.testing.assert_array_equal(got.frame_ids.numpy(), np.asarray(want.frame_ids))
    np.testing.assert_array_equal(got.act_boxes.numpy()[:n], np.asarray(want.act_boxes)[:n])
    np.testing.assert_allclose(got.frame_scores.numpy()[:n],
                               np.asarray(want.frame_scores)[:n], rtol=1e-5)
    np.testing.assert_allclose(got.act_scores.numpy()[:n],
                               np.asarray(want.act_scores)[:n], rtol=1e-5)


@pytest.mark.parametrize("bad", ["shape", "dtype", "row_scale_float", "mask_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    V, valid, excluded, q, _ = _db(3)
    args = [_t(V), _t(valid), _t(excluded), _t(q), None]
    if bad == "shape":
        args[3] = torch.zeros(V.shape[1] + 1)
    elif bad == "dtype":
        args[0] = args[0].to(torch.float16)
    elif bad == "row_scale_float":
        args[4] = torch.ones(V.shape[0])
    else:
        args[1] = args[1].to(torch.uint8)
    with pytest.raises((ValueError, TypeError)):
        tfs.fused_frame_max(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_cuda_kernel_matches_plain(dtype):
    """The hand-written kernel against its plain version on the card, at a
    ragged small shape (F not a multiple of the block, a fully invalid
    frame). f32/bf16: same bytes, f32 sums in another order; int8: exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    V, valid, excluded, q, rs = _db(4, F=1001, dtype="int8" if dtype == "int8" else "float32")
    dev = torch.device("cuda")
    tv = _t(V).to(dev)
    if dtype == "bfloat16":
        tv = tv.to(torch.bfloat16)
    args = (tv, _t(valid).to(dev), _t(excluded).to(dev), _t(q).to(dev),
            None if rs is None else _t(rs).to(dev))
    before = tfs.fused_frame_max.launches
    got = tfs.fused_frame_max(*args)
    torch.cuda.synchronize()
    assert tfs.fused_frame_max.launches == before + 1
    want = tfs.fused_frame_max_plain(*args)
    assert torch.equal(torch.isfinite(got), torch.isfinite(want))
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], rtol=1e-5, atol=1e-5)
