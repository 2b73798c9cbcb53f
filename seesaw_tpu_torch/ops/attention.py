"""Pair attention: softmax(q kᵀ / 8) v per 64-wide head, the CLIP towers'
attention (forward).

Counterpart of `seesaw_tpu/ops/pallas_attention.py`. q, k, v and the output
are (B, L, W) in the projection layout, W = heads * 64, head h in channels
[64h, 64h + 64) (the convention of `reshape(B, L, H, 64)`); L <= 384. Logits
and softmax are f32 (max subtracted per row), p is rounded to the input type
before P·V, P·V accumulates in f32, and the output is in the input type.
`causal=True` keeps key <= query (the text tower).

`pair_attention` launches the hand-written kernel `csrc/pair_attention.cu`
on a CUDA tensor, or raises; on a CPU tensor it runs `pair_attention_plain`,
the same function in plain PyTorch. The kernel is forward only: its backward
(K6, `seesaw_tpu/ops/pallas_attention.py:115`) is not ported, so a CUDA
input that requires grad raises rather than drop the gradient.

The TPU kernel's head-pair block-diagonal packing, batch padding to the
block and VMEM block cap are not carried over: they fill the MXU's 128-deep
contraction and fit VMEM, and the CUDA kernel needs none of them.
"""
from __future__ import annotations

import ctypes

import torch

HEAD_DIM = 64
MAX_LEN = 384
_KIND = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v, heads):
    """(B, L, H) of valid inputs; raises ValueError / TypeError otherwise."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"q, k, v must share one (B, L, W) shape: {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    B, L, W = q.shape
    if heads is not None and heads * HEAD_DIM != W:
        raise ValueError(
            f"kernel requires head_dim 64: got heads={heads}, width={W}"
        )
    if W % (2 * HEAD_DIM):
        raise ValueError("needs an even number of 64-wide heads")
    if L > MAX_LEN:
        raise ValueError(
            f"short-sequence kernel: L={L} > {MAX_LEN} (CLIP towers: 50, 77, 197, 257)"
        )
    if q.dtype not in _KIND or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be f32 or all bf16 (got {q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    return B, L, W // HEAD_DIM


def pair_attention_plain(q, k, v, *, causal: bool = False, heads: int | None = None):
    """Plain PyTorch version of the kernel: the einsum formulation over the
    head-split layout, with the kernel's precision (f32 logits and softmax,
    p rounded to the input type, f32 P·V)."""
    B, L, H = _check(q, k, v, heads)

    def split(t):
        return t.reshape(B, L, H, HEAD_DIM).transpose(1, 2).to(torch.float32)

    logits = torch.einsum("bhqd,bhkd->bhqk", split(q), split(k)) / 8.0
    if causal:
        logits = logits + torch.triu(
            torch.full((L, L), float("-inf"), device=q.device), diagonal=1
        )
    p = torch.softmax(logits, dim=-1).to(q.dtype).to(torch.float32)
    out = torch.einsum("bhqk,bhkd->bhqd", p, split(v))
    return out.transpose(1, 2).reshape(B, L, H * HEAD_DIM).to(q.dtype)


def pair_attention(q, k, v, *, causal: bool = False, heads: int | None = None):
    """(B, L, W) attention output in the input type. Pass `heads` to have
    the 64-wide head width checked (the layout alone cannot tell H heads of
    64 from H/2 heads of 128). CPU tensors take the plain version; CUDA
    tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return pair_attention_plain(q, k, v, causal=causal, heads=heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, L, H = _check(q, k, v, heads)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "pair_attention on the card is forward only: its backward (K6, "
            "seesaw_tpu/ops/pallas_attention.py:115 _attn_bwd_kernel) is not "
            "ported yet; run the towers under torch.no_grad()"
        )
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k, v must be on one device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must start 16-byte aligned")
    out = torch.empty_like(q)
    if B == 0:
        return out

    from .._build import load_library

    fn = load_library("pair_attention").seesaw_pair_attention
    P = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, P, P, P, P, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(_KIND[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 out.data_ptr(), B, L, H, int(causal), stream)
    if err != 0:
        raise RuntimeError(f"pair_attention kernel launch failed: CUDA error {err}")
    pair_attention.launches += 1
    return out


pair_attention.launches = 0  # kernel launches in this process (CUDA only)
