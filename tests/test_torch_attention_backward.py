"""The port's pair-attention backward (`seesaw_tpu_torch.ops.attention`, K6)
against the JAX package's custom VJP of `fused_pair_attention`, run in
interpret mode (the Pallas backward kernel on the CPU), on the same numpy
inputs; the autograd Function against autograd of an f32 einsum; a
two-layer vision tower's gradients against the JAX tower's. On the CPU the
port runs its plain backward; the CUDA kernel is held against that plain
version by the `cuda`-marked tests (skipped without a GPU) and by
chip_smoke.py phase 8a.

Tolerances:
- f32 5e-5 (atol and rtol), the JAX package's own bar between its Pallas
  backward and einsum gradients (tests/test_pallas_attention.py:289-291);
  measured ~1e-6.
- bf16: at most 1% of each gradient's elements differ from JAX's, none by
  more than 4e-3 (measured: <= 0.05% differ, by <= 2e-3, where an f32 ds a
  rounding step off rounds to the neighbouring bf16 value). The variant that
  skips rounding ds to bf16 before dq and dk (autograd through
  `pair_attention_plain`) changes about half of dq and dk and fails it.
- The vision tower's gradients 1e-4 (f32 sums in another order through
  two layers and their backward).
- The CUDA kernel against the plain backward: f32 1e-5; bf16 rtol 2^-7 /
  atol 1e-3 (a one-ulp flip where ds or the output lands on a rounding
  boundary) with at most 0.1% of the elements differing (chip_smoke.py's
  BWD_MAX_SHARE), and two runs bit-identical.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seesaw_tpu.ops.pallas_attention import fused_pair_attention
from seesaw_tpu_torch.ops import attention as tatt

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_attention import TORCH_DTYPE, _np, _qkv  # noqa: E402

F32_TOL = dict(atol=5e-5, rtol=5e-5)
BF16_MAX_SHARE, BF16_ATOL = 0.01, 4e-3


def _inputs(seed, B, L, W, dtype):
    (jq, jk, jv), (q, k, v) = _qkv(seed, B, L, W, dtype)
    (jg, _, _), (g, _, _) = _qkv(seed + 100, B, L, W, dtype)
    return (jq, jk, jv, jg), (q, k, v, g)


def _jax_vjp(jq, jk, jv, jg, causal):
    _, vjp = jax.vjp(lambda q, k, v: fused_pair_attention(
        q, k, v, block_b=2, interpret=True, causal=causal), jq, jk, jv)
    return [np.asarray(x, np.float32) for x in vjp(jg)]


def _autograd_of_plain(q, k, v, g, causal):
    """Autograd through the plain forward: in bf16, ds is not rounded."""
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    out = tatt.pair_attention_plain(q, k, v, causal=causal)
    return torch.autograd.grad(out, (q, k, v), g)


def _bf16_mismatch(got, want):
    """(share of elements that differ, max abs difference)."""
    d = np.abs(_np(got) - want)
    return float((d > 0).mean()), float(d.max())


@pytest.mark.parametrize("B,L,W,causal", [
    (2, 12, 128, True),    # tests/test_pallas_attention.py:48
    (2, 50, 128, False),   # :157
    (3, 197, 128, False),  # :274
    (2, 1, 128, False),
    (2, 77, 512, True),    # the text tower
])
def test_plain_backward_matches_jax_f32(B, L, W, causal):
    jin, tin = _inputs(0, B, L, W, "float32")
    want = _jax_vjp(*jin, causal)
    got = tatt.pair_attention_bwd_plain(*tin, causal=causal, heads=W // 64)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.float32 and a.shape == (B, L, W)
        np.testing.assert_allclose(_np(a), b, **F32_TOL, err_msg=f"d{name}")


@pytest.mark.parametrize("B,L,W,causal", [
    (3, 50, 128, False), (3, 50, 128, True),  # tests/test_pallas_attention.py:238
    (2, 77, 512, True),
])
def test_plain_backward_matches_jax_bf16(B, L, W, causal):
    jin, tin = _inputs(1, B, L, W, "bfloat16")
    want = _jax_vjp(*jin, causal)
    got = tatt.pair_attention_bwd_plain(*tin, causal=causal)
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        share, worst = _bf16_mismatch(a, b)
        assert share <= BF16_MAX_SHARE and worst <= BF16_ATOL, (name, share, worst)
    # the variant that skips ds's rounding fails the bar on dq and dk
    variant = _autograd_of_plain(*tin, causal)
    for name, a, b in zip("qk", variant, want):
        share, worst = _bf16_mismatch(a, b)
        assert share > 0.2, (name, share, worst)


def test_l1_gradient_flows_to_v_only():
    """One key: p = 1, so dq = dk = 0 and dv = g."""
    _, (q, k, v, g) = _inputs(2, 3, 1, 256, "float32")
    dq, dk, dv = tatt.pair_attention_bwd_plain(q, k, v, g)
    assert not dq.any() and not dk.any()
    torch.testing.assert_close(dv, g, rtol=0, atol=0)


def _einsum_attention_f32(q, k, v, causal):
    """Plain f32 multi-head attention in PyTorch (no kernel precision)."""
    B, L, W = q.shape
    H = W // 64

    def split(t):
        return t.reshape(B, L, H, 64).transpose(1, 2)

    logits = torch.einsum("bhqd,bhkd->bhqk", split(q), split(k)) / 8.0
    if causal:
        logits = logits.masked_fill(torch.ones(L, L, dtype=torch.bool).triu(1), float("-inf"))
    out = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(logits, -1), split(v))
    return out.transpose(1, 2).reshape(B, L, W)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_function_matches_einsum(causal):
    _, (q, k, v, g) = _inputs(3, 2, 33, 256, "float32")
    qa, ka, va = (t.clone().requires_grad_() for t in (q, k, v))
    out = tatt.pair_attention(qa, ka, va, causal=causal, heads=4)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (qa, ka, va), g)
    qb, kb, vb = (t.clone().requires_grad_() for t in (q, k, v))
    want = torch.autograd.grad(_einsum_attention_f32(qb, kb, vb, causal), (qb, kb, vb), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    # the Function's backward is the plain backward on the CPU
    for a, b in zip(got, tatt.pair_attention_bwd_plain(q, k, v, g, causal=causal)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_non_contiguous_output_gradient():
    """out_proj's backward may hand the Function a transposed view."""
    _, (q, k, v, g) = _inputs(4, 2, 20, 128, "float32")
    qa = q.clone().requires_grad_()
    out = tatt.pair_attention(qa, k, v)
    gt = g.transpose(0, 1).contiguous().transpose(0, 1)
    assert not gt.is_contiguous()
    (got,) = torch.autograd.grad(out, qa, gt)
    torch.testing.assert_close(got, tatt.pair_attention_bwd_plain(q, k, v, g)[0],
                               rtol=0, atol=0)


def test_double_backward_raises():
    _, (q, k, v, _) = _inputs(5, 1, 8, 128, "float32")
    qa = q.clone().requires_grad_()
    out = tatt.pair_attention(qa, k, v)
    (dq,) = torch.autograd.grad(out.square().sum(), qa, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable|twice"):
        dq.sum().backward()


def test_cpu_backward_counts_no_launch():
    _, (q, k, v, g) = _inputs(6, 2, 10, 128, "float32")
    before = tatt.pair_attention_bwd.launches
    got = tatt.pair_attention_bwd(q, k, v, g, causal=True)
    for a, b in zip(got, tatt.pair_attention_bwd_plain(q, k, v, g, causal=True)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert tatt.pair_attention_bwd.launches == before


def test_vision_tower_gradients_match_jax(monkeypatch):
    """The config of tests/test_pallas_attention.py:204-235: every gradient
    of sum(tower(pixels)^2), the JAX side through its Pallas forward and
    backward (interpret mode), the port through its autograd Function."""
    from seesaw_tpu.models import clip as J
    from seesaw_tpu_torch.convert import clip_params_from_arrays
    from seesaw_tpu_torch.models import clip as T

    monkeypatch.setenv("SEESAW_FUSED_ATTN_INTERPRET", "1")
    info = dict(embed_dim=32, image_size=32, patch_size=16, vision_width=128,
                vision_layers=2, vision_heads=2, vocab_size=99, context_length=12,
                text_width=32, text_layers=1, text_heads=4)
    jcfg = J.ClipConfig(**info)
    params = J.init_params(jcfg, seed=0)
    px = np.random.default_rng(12).normal(size=(2, 32, 32, 3)).astype(np.float32)
    g_jax = jax.grad(lambda p: jnp.sum(J.VisionTower(jcfg).apply(
        {"params": p}, jnp.asarray(px)) ** 2))(params["vision"])

    model = T.ClipModel(T.ClipConfig(**info))
    model.load_state_dict(clip_params_from_arrays(jax.tree.map(np.asarray, params),
                                                  model.cfg))
    (model.vision(torch.from_numpy(px)) ** 2).sum().backward()
    grads = {f"vision.{n}": p.grad for n, p in model.vision.named_parameters()}
    want = clip_params_from_arrays(
        {"vision": jax.tree.map(np.asarray, g_jax), "text": params["text"],
         "logit_scale": params["logit_scale"]}, model.cfg)
    assert len(grads) == sum(k.startswith("vision.") for k in want)
    for name, got in grads.items():
        np.testing.assert_allclose(got.numpy(), want[name].numpy(), atol=1e-4, rtol=1e-4,
                                   err_msg=name)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,W,causal", [
    (3, 13, 128, True), (5, 1, 256, False), (4, 50, 768, False), (2, 77, 512, True),
    (2, 197, 768, False), (2, 257, 1024, False), (1, 384, 128, True),
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_matches_plain(cuda_device, B, L, W, causal, dtype):
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v, g = (torch.randn(B, L, W, device=cuda_device, generator=gen)
                  .to(TORCH_DTYPE[dtype]) for _ in range(4))
    before = tatt.pair_attention_bwd.launches
    got = tatt.pair_attention_bwd(q, k, v, g, causal=causal, heads=W // 64)
    again = tatt.pair_attention_bwd(q, k, v, g, causal=causal)
    want = tatt.pair_attention_bwd_plain(q, k, v, g, causal=causal)
    torch.cuda.synchronize()
    assert tatt.pair_attention_bwd.launches == before + 2
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else dict(rtol=2**-7, atol=1e-3)
    for a, b, c in zip(got, again, want):
        assert torch.equal(a, b)  # no atomics: the same bits every run
        torch.testing.assert_close(a.float(), c.float(), **tol)
        if dtype == "bfloat16":
            assert float((a != c).float().mean()) <= 1e-3
