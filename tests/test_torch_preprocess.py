"""The port's image preprocessing and pooling against the JAX package's on
the same numpy inputs: `preprocess_image` (the same PIL path) exactly,
`normalize_pixels` at 1e-6, and `ops.pooling` at the cases of
tests/test_pooling.py (1e-5: window means summed in another order)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seesaw_tpu.models import preprocess as JP
from seesaw_tpu.ops import pooling as JO
from seesaw_tpu_torch.models import preprocess as TP
from seesaw_tpu_torch.ops import pooling as TO


@pytest.mark.parametrize("hw,target", [((32, 32), 32), ((48, 64), 32), ((100, 40), 32),
                                       ((300, 257), 224)])
def test_preprocess_image_matches_jax(hw, target):
    from PIL import Image

    rng = np.random.default_rng(hw[0])
    img = (rng.random(hw + (3,)) * 255).astype(np.uint8)
    want = JP.preprocess_image(img, target)
    got = TP.preprocess_image(img, target)
    assert got.shape == (target, target, 3) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    gray = Image.fromarray(img[..., 0])  # mode "L" goes through convert("RGB")
    np.testing.assert_array_equal(TP.preprocess_image(gray, target),
                                  JP.preprocess_image(gray, target))


def test_normalize_pixels_matches_jax():
    x = np.random.default_rng(0).random((2, 8, 8, 3)).astype(np.float32)
    want = np.asarray(JP.normalize_pixels(jnp.asarray(x)))
    got = TP.normalize_pixels(torch.from_numpy(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("h,w,k,s", [
    (8, 8, 4, 4), (9, 9, 4, 4), (14, 10, 6, 3), (224, 224, 112, 56), (7, 7, 7, 7),
])
def test_avg_pool_matches_jax(h, w, k, s):
    x = np.random.default_rng(0).normal(size=(2, 3, h, w)).astype(np.float32)
    want = np.asarray(JO.avg_pool2d(jnp.asarray(x), k, s))
    got = TO.avg_pool2d(torch.from_numpy(x), k, s)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), torch.nn.AvgPool2d(k, stride=s)(
        torch.from_numpy(x)).numpy(), atol=1e-5)


@pytest.mark.parametrize("center", [False, True])
def test_manual_pooling_matches_jax(center):
    x = np.broadcast_to(np.arange(10, dtype=np.float32), (10, 10)).copy()
    want = JO.manual_pooling(jnp.asarray(x), lambda win: win.mean(axis=(-2, -1)), 4, 4,
                             center=center)
    got = TO.manual_pooling(torch.from_numpy(x), lambda win: win.mean(dim=(-2, -1)), 4, 4,
                            center=center)
    assert got.shape == (2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_vector_kernel_and_sliding_window_match_jax():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 8, 8)).astype(np.float32)
    want = JO.manual_pooling(jnp.asarray(x), lambda win: win.reshape(-1)[:5] * 2.0, 4, 4)
    got = TO.manual_pooling(torch.from_numpy(x), lambda win: win.reshape(-1)[:5] * 2.0, 4, 4)
    assert got.shape == (5, 2, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)

    x4 = rng.normal(size=(1, 3, 12, 12)).astype(np.float32)
    want = JO.sliding_window(jnp.asarray(x4), lambda win: win.mean(axis=(-2, -1)), 6, 3)
    got = TO.sliding_window(torch.from_numpy(x4), lambda win: win.mean(dim=(-2, -1)), 6, 3)
    assert got.shape == (1, 3, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    with pytest.raises(ValueError):
        TO.sliding_window(torch.from_numpy(x4[0]), lambda win: win.mean(), 6, 3)
