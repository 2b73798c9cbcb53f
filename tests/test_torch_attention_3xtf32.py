"""The numerical premise of the f32 pair-attention kernels (K5, K6 in
`seesaw_tpu_torch/csrc/pair_attention.cu`): every product on TF32 tensor
cores through the 3xTF32 split passes the unchanged f32 bar against the
plain versions, and a single-TF32 design does not.

`_round_tf32` rounds f32 to TF32 (10 stored mantissa bits) to the nearest,
ties away from zero, on the bit pattern, as `cvt.rna.tf32.f32` does; each
operand x is split into big = rna(x) and small = rna(x - big), and a
product is summed as big·small + small·big + big·big with f32 sums. The
products of two TF32 values are exact in f32, so this is what the tensor
cores compute, up to the order of the f32 sums.

Bar: rtol 1e-5 / atol 1e-5, `chip_smoke.py`'s `ATTN_TOL["float32"]` and
`BWD_TOL["float32"]`. Measured on the CPU: 3xTF32 within 3e-6 at every shape;
one TF32 product (big·big) off by 3e-4 to 2e-3, far past it.
"""
import numpy as np
import pytest
import torch

from seesaw_tpu_torch.ops import attention as tatt

BAR = dict(rtol=1e-5, atol=1e-5)
# (B, L, causal) at the towers' lengths, 2 heads
SHAPES = [(3, 13, True), (2, 50, False), (2, 77, True), (1, 197, False)]


def _round_tf32(x):
    """f32 -> the nearest TF32 value, ties away from zero (finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    # adding half an ulp of TF32 to the magnitude bits rounds it half away
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, split):
    """a @ b over the last two axes, f32 operands on TF32 products: the
    3xTF32 split when `split`, else one product of the rounded operands."""
    a_big, b_big = _round_tf32(a), _round_tf32(b)
    if not split:
        return a_big @ b_big
    a_small, b_small = _round_tf32(a - a_big), _round_tf32(b - b_big)
    return (a_big @ b_small + a_small @ b_big) + a_big @ b_big


def _heads(t, H):
    B, L, _ = t.shape
    return t.reshape(B, L, H, 64).transpose(1, 2)


def _merge(t):
    B, H, L, _ = t.shape
    return t.transpose(1, 2).reshape(B, L, H * 64)


def _p(qh, kh, causal, split):
    L = qh.shape[2]
    logits = _mm(qh, kh.transpose(-1, -2), split) * 0.125
    if causal:
        logits = logits.masked_fill(torch.ones(L, L, dtype=torch.bool).triu(1), float("-inf"))
    return torch.softmax(logits, dim=-1)


def tf32_attention(q, k, v, causal, split=True):
    qh, kh, vh = (_heads(t, q.shape[-1] // 64) for t in (q, k, v))
    return _merge(_mm(_p(qh, kh, causal, split), vh, split))


def tf32_attention_bwd(q, k, v, g, causal, split=True):
    qh, kh, vh, gh = (_heads(t, q.shape[-1] // 64) for t in (q, k, v, g))
    p = _p(qh, kh, causal, split)
    dp = _mm(gh, vh.transpose(-1, -2), split)
    r = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - r)) * 0.125
    return tuple(_merge(t) for t in (_mm(ds, kh, split), _mm(ds.transpose(-1, -2), qh, split),
                                     _mm(p.transpose(-1, -2), gh, split)))


def _inputs(seed, B, L, n=4):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(B, L, 128)).astype(np.float32)) for _ in range(n)]


def test_round_tf32():
    one_ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1 + one_ulp / 2, 1 + one_ulp / 2 - 2**-23, -(1 + one_ulp / 2),
                      3.0e-3, -7.5])
    want = torch.tensor([1.0, 1 + one_ulp, 1.0, -(1 + one_ulp)])
    got = _round_tf32(x)
    assert torch.equal(got[:4], want)  # ties away from zero, sign kept
    assert not (got.view(torch.int32) & 0x1FFF).any()  # low 13 bits clear
    assert float(((got - x) / x).abs().max()) <= 2.0 ** -11
    big = _round_tf32(x)
    small = _round_tf32(x - big)
    # big + small keeps ~22 bits: within 2^-21 relative
    assert float(((big + small - x) / x).abs().max()) <= 2.0 ** -21


@pytest.mark.parametrize("B,L,causal", SHAPES)
def test_3xtf32_forward_within_f32_bar(B, L, causal):
    q, k, v = _inputs(0, B, L, 3)
    want = tatt.pair_attention_plain(q, k, v, causal=causal)
    torch.testing.assert_close(tf32_attention(q, k, v, causal), want, **BAR)


@pytest.mark.parametrize("B,L,causal", SHAPES)
def test_3xtf32_backward_within_f32_bar(B, L, causal):
    q, k, v, g = _inputs(1, B, L)
    want = tatt.pair_attention_bwd_plain(q, k, v, g, causal=causal)
    for name, got, ref in zip(("dq", "dk", "dv"), tf32_attention_bwd(q, k, v, g, causal), want):
        torch.testing.assert_close(got, ref, **BAR, msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.parametrize("B,L,causal", SHAPES)
def test_single_tf32_fails_the_f32_bar(B, L, causal):
    """The bar tells the two designs apart: one TF32 product per f32
    product misses it, forward and backward."""
    q, k, v, g = _inputs(2, B, L)
    with pytest.raises(AssertionError):
        torch.testing.assert_close(tf32_attention(q, k, v, causal, split=False),
                                   tatt.pair_attention_plain(q, k, v, causal=causal), **BAR)
    got = tf32_attention_bwd(q, k, v, g, causal, split=False)
    want = tatt.pair_attention_bwd_plain(q, k, v, g, causal=causal)
    for a, b in zip(got, want):
        with pytest.raises(AssertionError):
            torch.testing.assert_close(a, b, **BAR)
