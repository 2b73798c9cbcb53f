"""The port's pair attention (`seesaw_tpu_torch.ops.attention`, K5 forward)
against the JAX package's `fused_pair_attention` run in interpret mode (the
Pallas kernel on the CPU) and against its einsum formulation, on the same
numpy inputs. On the CPU the port's wrapper runs its plain version; the
CUDA kernel is held against that plain version on the card by the
`cuda`-marked tests (skipped without a GPU) and by chip_smoke.py.

Tolerances: f32 atol/rtol 1e-5 (64-term logits and L-term P·V summed in
another order); bf16 against JAX 2e-2 (the outputs' bf16 rounding, as
tests/test_pallas_attention.py); extreme logits 1e-3 (a saturated softmax
amplifies f32 ulps of the logits, as there). The bf16 CUDA kernel (tensor
cores) against the plain version: its logits are summed in another order
than the plain version's f32 GEMM, so a logit can move by an f32 bit and
flip one p's bf16 rounding, or an output can land on the other side of its
rounding boundary: rtol 2^-7 / atol 1e-3 (one output ulp; near 0 an
absolute step), with at most 0.1% of the outputs differing at all, and two
runs bit-identical. A kernel which skips rounding p to bf16 before P·V
moves ~40% of the outputs and fails.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from seesaw_tpu.ops.pallas_attention import fused_pair_attention
from seesaw_tpu_torch.ops import attention as tatt

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_pallas_attention import einsum_attention  # noqa: E402

TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _qkv(seed, B, L, W, dtype="float32", scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [(rng.normal(size=(B, L, W)) * scale).astype(np.float32) for _ in range(3)]
    jax_in = [jnp.asarray(a, getattr(jnp, dtype)) for a in arrs]
    # both sides see the same (rounded) values
    torch_in = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(TORCH_DTYPE[dtype])
                for a in jax_in]
    return jax_in, torch_in


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize(
    "B,L,heads",
    [(3, 50, 12), (2, 77, 8), (5, 64, 2), (2, 197, 2), (1, 257, 2)],
)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(B, L, heads, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(0, B, L, heads * 64, dtype)
    want = fused_pair_attention(jq, jk, jv, block_b=2, interpret=True)
    got = tatt.pair_attention(q, k, v, heads=heads)
    assert got.dtype == TORCH_DTYPE[dtype] and got.shape == (B, L, heads * 64)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_jax_einsum(causal):
    (jq, jk, jv), (q, k, v) = _qkv(5, 3, 50, 128)
    want = einsum_attention(jq, jk, jv, 2, causal=causal)
    got = tatt.pair_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("B,L,heads", [(3, 77, 8), (2, 12, 2), (1, 197, 2)])
def test_causal_matches_jax_kernel(B, L, heads):
    (jq, jk, jv), (q, k, v) = _qkv(7, B, L, heads * 64)
    want = fused_pair_attention(jq, jk, jv, block_b=2, interpret=True, causal=True)
    got = tatt.pair_attention(q, k, v, causal=True, heads=heads)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-5)
    # row 0 sees key 0 alone
    np.testing.assert_allclose(_np(got[:, 0]), _np(v[:, 0]), atol=1e-6)


def test_extreme_logits_stable():
    (jq, jk, _), (q, k, _) = _qkv(2, 2, 50, 128, scale=40.0)
    (_, _, jv), (_, _, v) = _qkv(3, 2, 50, 128)
    want = fused_pair_attention(jq, jk, jv, block_b=2, interpret=True)
    got = tatt.pair_attention(q, k, v)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-3, rtol=1e-3)


def test_heads_precondition_checked():
    q = torch.zeros(1, 8, 256)
    with pytest.raises(ValueError, match="head_dim 64"):
        tatt.pair_attention(q, q, q, heads=2)


@pytest.mark.parametrize("shape,match", [
    ((1, 385, 128), "L=385"),
    ((1, 8, 192), "even number"),
])
def test_unsupported_shapes_raise(shape, match):
    q = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        tatt.pair_attention(q, q, q)


def test_cpu_takes_the_plain_version_and_counts_no_launch():
    before = tatt.pair_attention.launches
    (_, _, _), (q, k, v) = _qkv(4, 2, 20, 128)
    torch.testing.assert_close(tatt.pair_attention(q, k, v, causal=True),
                               tatt.pair_attention_plain(q, k, v, causal=True),
                               rtol=0, atol=0)
    assert tatt.pair_attention.launches == before


def _no_build(*names):
    raise AssertionError(f"a CPU tensor asked for a kernel library {names}")


@pytest.mark.parametrize("causal", [False, True])
def test_cpu_bf16_loads_no_library_and_counts_no_launch(monkeypatch, causal):
    """bf16 CPU tensors take the plain version: no build, no launch counted,
    neither in all nor for bf16."""
    from seesaw_tpu_torch import _build

    monkeypatch.setattr(_build, "load_libraries", _no_build)
    before = tatt.pair_attention.launches, dict(tatt.pair_attention.launches_by_dtype)
    (_, _, _), (q, k, v) = _qkv(8, 2, 33, 128, "bfloat16")
    got = tatt.pair_attention(q, k, v, causal=causal, heads=2)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, tatt.pair_attention_plain(q, k, v, causal=causal),
                               rtol=0, atol=0)
    assert (tatt.pair_attention.launches, tatt.pair_attention.launches_by_dtype) == before


def test_reset_launch_counts():
    tatt.pair_attention.launches_by_dtype["bfloat16"] += 3
    tatt.pair_attention_bwd.launches += 2
    tatt.reset_launch_counts()
    for wrapper in (tatt.pair_attention, tatt.pair_attention_bwd):
        assert wrapper.launches == 0
        assert wrapper.launches_by_dtype == {"float32": 0, "bfloat16": 0}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


# the towers' shapes, and ragged lengths at the mma fragments' edges (1, 13,
# 33, 77, 257 against 16-row and 8-key tiles), causal and not; small batches
# take the f32 forward's small-grid kernel up to L = 128, and the last three
# (batches that fill the card) its 4-warp kernel
CUDA_SHAPES = [
    (3, 13, 128, False), (3, 13, 128, True), (4, 50, 768, False),
    (2, 77, 512, True), (2, 197, 768, False), (2, 257, 1024, False), (1, 384, 128, True),
    (5, 1, 256, False), (5, 1, 256, True), (3, 33, 256, False), (3, 33, 256, True),
    (2, 77, 512, False), (2, 257, 256, True),
    (200, 13, 128, True), (48, 33, 256, True), (40, 77, 512, False),
]
BF16_MAX_SHARE = 1e-3  # chip_smoke.py's ATTN_MAX_SHARE


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,causal", CUDA_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(cuda_device, B, L, W, causal, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn(B, L, W, device=cuda_device, generator=gen).to(TORCH_DTYPE[dtype])
               for _ in range(3))
    before = tatt.pair_attention.launches, tatt.pair_attention.launches_by_dtype[dtype]
    got = tatt.pair_attention(q, k, v, causal=causal, heads=W // 64)
    again = tatt.pair_attention(q, k, v, causal=causal)
    want = tatt.pair_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert tatt.pair_attention.launches == before[0] + 2
    assert tatt.pair_attention.launches_by_dtype[dtype] == before[1] + 2
    assert torch.equal(got, again)
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2**-7, atol=1e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    if dtype == "bfloat16":
        assert float((got != want).float().mean()) <= BF16_MAX_SHARE


@pytest.mark.cuda
def test_cuda_forward_only(cuda_device):
    """The forward kernel alone under no_grad; with a grad, the backward is
    the K6 kernel (one launch) and matches the plain backward."""
    q = torch.randn(1, 8, 128, device=cuda_device, requires_grad=True)
    k, v = torch.randn(2, 1, 8, 128, device=cuda_device)
    with torch.no_grad():
        before = tatt.pair_attention_bwd.launches
        assert tatt.pair_attention(q, q, q).shape == q.shape
        assert tatt.pair_attention_bwd.launches == before
    out = tatt.pair_attention(q, k, v)
    g = torch.randn_like(out)
    before = tatt.pair_attention_bwd.launches
    (dq,) = torch.autograd.grad(out, q, g)
    torch.cuda.synchronize()
    assert tatt.pair_attention_bwd.launches == before + 1
    torch.testing.assert_close(dq, tatt.pair_attention_bwd_plain(q.detach(), k, v, g)[0],
                               rtol=1e-5, atol=1e-5)
