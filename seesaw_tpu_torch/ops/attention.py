"""Pair attention: softmax(q kᵀ / 8) v per 64-wide head, the CLIP towers'
attention, forward (K5) and backward (K6).

Counterpart of `seesaw_tpu/ops/pallas_attention.py`. q, k, v and the output
are (B, L, W) in the projection layout, W = heads * 64, head h in channels
[64h, 64h + 64) (the convention of `reshape(B, L, H, 64)`); L <= 384. Logits
and softmax are f32 (max subtracted per row), p is rounded to the input type
before P·V, P·V accumulates in f32, and the output is in the input type.
`causal=True` keeps key <= query (the text tower).

`pair_attention` is a `torch.autograd.Function` that saves q, k and v (not
p), as the JAX custom VJP saves them. On a CUDA tensor its forward and
backward launch hand-written kernels or raise: f32 the kernels
`seesaw_pair_attention` and `seesaw_pair_attention_bwd` of
`csrc/pair_attention.cu`, which run every product on the tensor cores
through the 3xTF32 split (each f32 operand as two TF32 values, three TF32
products summed in f32), bf16 the tensor-core kernels
`seesaw_pair_attention_bf16` and `seesaw_pair_attention_bwd_bf16` of
`csrc/pair_attention_bf16.cu`. On a CPU tensor they run
`pair_attention_plain` and `pair_attention_bwd_plain`, the same functions in
plain PyTorch. Double backward is not supported.

The TPU kernels' head-pair block-diagonal packing, batch padding to the
block and VMEM block caps are not carried over: they fill the MXU's 128-deep
contraction and fit VMEM, and the CUDA kernels need none of them.
"""
from __future__ import annotations

import ctypes

import torch
from torch.autograd.function import once_differentiable

from ..utils.profiling import kernel_launch
from . import count_launch

HEAD_DIM = 64
MAX_LEN = 384
# input type -> (library, forward entry, backward entry)
_ROUTES = {
    torch.float32: ("pair_attention", "seesaw_pair_attention", "seesaw_pair_attention_bwd"),
    torch.bfloat16: ("pair_attention_bf16", "seesaw_pair_attention_bf16",
                     "seesaw_pair_attention_bwd_bf16"),
}


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
    if q.dtype not in _ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be f32 or all bf16 (got {q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    return B, L, W // HEAD_DIM


def _split(t, B, L, H):
    """(B, L, H * 64) in any type -> (B, H, L, 64) f32."""
    return t.reshape(B, L, H, HEAD_DIM).transpose(1, 2).to(torch.float32)


def _merge(t, B, L, H, dtype):
    return t.transpose(1, 2).reshape(B, L, H * HEAD_DIM).to(dtype)


def _softmax_f32(qh, kh, causal):
    """f32 p of the (B, H, L, 64) f32 heads: logits / 8, max subtracted."""
    L = qh.shape[2]
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / 8.0
    if causal:
        logits = logits + torch.triu(
            torch.full((L, L), float("-inf"), device=qh.device), diagonal=1
        )
    return torch.softmax(logits, dim=-1)


def pair_attention_plain(q, k, v, *, causal: bool = False, heads: int | None = None):
    """Plain PyTorch version of the forward kernel: the einsum formulation
    over the head-split layout, with the kernel's precision (f32 logits and
    softmax, p rounded to the input type, f32 P·V)."""
    B, L, H = _check(q, k, v, heads)
    p = _softmax_f32(_split(q, B, L, H), _split(k, B, L, H), causal)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(q.dtype).to(torch.float32),
                       _split(v, B, L, H))
    return _merge(out, B, L, H, q.dtype)


def pair_attention_bwd_plain(q, k, v, g, *, causal: bool = False,
                             heads: int | None = None):
    """Plain PyTorch version of the backward kernel (dq, dk, dv of the
    forward for the output gradient g), in the order of operations of
    `_attn_bwd_kernel` (`pallas_attention.py:137-180`): p recomputed in f32
    as the forward does; dp = g vᵀ in f32 from the input-type g and v;
    r = rowsum(p ∘ dp) with p unrounded; ds = p ∘ (dp − r) / 8 in f32; ds
    rounded to the input type before dq = ds k and dk = dsᵀ q, p rounded
    before dv = pᵀ g; all three summed in f32 and returned in the input type.
    Autograd through `pair_attention_plain` differs in bf16: it does not
    round ds."""
    B, L, H = _check(q, k, v, heads)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g must match q: {tuple(g.shape)} {g.dtype}, "
                         f"q {tuple(q.shape)} {q.dtype}")
    qh, kh, vh, gh = (_split(t, B, L, H) for t in (q, k, v, g))
    p = _softmax_f32(qh, kh, causal)
    dp = torch.einsum("bhqd,bhkd->bhqk", gh, vh)
    r = (p * dp).sum(dim=-1, keepdim=True)
    ds = (p * (dp - r)) * 0.125
    dsc = ds.to(q.dtype).to(torch.float32)
    pc = p.to(q.dtype).to(torch.float32)
    dq = torch.einsum("bhqk,bhkd->bhqd", dsc, kh)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsc, qh)
    dv = torch.einsum("bhqk,bhqd->bhkd", pc, gh)
    return tuple(_merge(t, B, L, H, q.dtype) for t in (dq, dk, dv))


def _launch(lib, fn_name, argtypes, args, device):
    """Call a kernel entry of `csrc/<lib>.cu` on `device`'s current stream;
    raises on the CUDA error it returns."""
    from .._build import load_library

    fn = getattr(load_library(lib), fn_name)
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with kernel_launch(f"ops.{fn_name.removeprefix('seesaw_')}"), torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} kernel launch failed: CUDA error {err}")


def _count(wrapper, dtype):
    count_launch(wrapper, str(dtype).removeprefix("torch."))


def reset_launch_counts():
    """Zero both wrappers' launch counts, the totals and the per-type split."""
    for wrapper in (pair_attention, pair_attention_bwd):
        wrapper.launches = 0
        wrapper.launches_by_dtype = {"float32": 0, "bfloat16": 0}


def _check_cuda(*ts):
    if any(t.device != ts[0].device for t in ts):
        raise ValueError("the tensors must be on one device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("the tensors must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("the tensors must start 16-byte aligned")


def _forward(q, k, v, causal, heads):
    if q.device.type == "cpu":
        return pair_attention_plain(q, k, v, causal=causal, heads=heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, L, H = _check(q, k, v, heads)
    _check_cuda(q, k, v)
    out = torch.empty_like(q)
    if B == 0:
        return out
    P, I = ctypes.c_void_p, ctypes.c_int
    lib, entry, _ = _ROUTES[q.dtype]
    _launch(lib, entry, [P, P, P, P, I, I, I, I],
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, L, H,
             int(causal)], q.device)
    _count(pair_attention, q.dtype)
    return out


def pair_attention_bwd(q, k, v, g, *, causal: bool = False, heads: int | None = None):
    """(dq, dk, dv) in the input type. CPU tensors take the plain version;
    CUDA tensors launch the backward kernel or raise."""
    if q.device.type == "cpu":
        return pair_attention_bwd_plain(q, k, v, g, causal=causal, heads=heads)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    B, L, H = _check(q, k, v, heads)
    if g.shape != q.shape or g.dtype != q.dtype:
        raise ValueError(f"g must match q: {tuple(g.shape)} {g.dtype}, "
                         f"q {tuple(q.shape)} {q.dtype}")
    _check_cuda(q, k, v, g)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    if B == 0:
        return dq, dk, dv
    # per row: the softmax max and sum, and r = rowsum(p ∘ dp)
    stats = torch.empty(3, B * H * L, dtype=torch.float32, device=q.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib, _, entry = _ROUTES[q.dtype]
    _launch(lib, entry, [P, P, P, P, P, P, P, P, I, I, I, I],
            [q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), stats.data_ptr(), B, L, H, int(causal)],
            q.device)
    _count(pair_attention_bwd, q.dtype)
    return dq, dk, dv


class _PairAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, heads):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.heads = causal, heads
        return _forward(q, k, v, causal, heads)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        # out_proj's backward may hand over a transposed view
        dq, dk, dv = pair_attention_bwd(q, k, v, g.contiguous(), causal=ctx.causal,
                                        heads=ctx.heads)
        return dq, dk, dv, None, None


def pair_attention(q, k, v, *, causal: bool = False, heads: int | None = None):
    """(B, L, W) attention output in the input type, differentiable in q, k
    and v. Pass `heads` to have the 64-wide head width checked (the layout
    alone cannot tell H heads of 64 from H/2 heads of 128). CPU tensors take
    the plain versions; CUDA tensors launch the kernels or raise."""
    return _PairAttention.apply(q, k, v, causal, heads)


# kernel launches in this process (CUDA only), forward and backward, in all
# and by input type ("float32": 3xTF32, "bfloat16": bf16 tensor cores)
reset_launch_counts()
