"""Fused score + frame-max: the scan over the embedding matrix.

Counterpart of `seesaw_tpu/ops/pallas_scoring.py`. `fused_frame_max`
returns, per frame, the max over its valid tiles of V.q with excluded frames
at -inf, without writing the (F*T,) score vector. On a CUDA tensor it
launches the hand-written kernel `csrc/fused_frame_max.cu` or raises; on a
CPU tensor it runs `fused_frame_max_plain`, the same function in plain
PyTorch. Top-k over the (F,) maxima and the shortlist augmentation are small
and stay in PyTorch (`frame_scoring.rank_from_frame_max`).

The TPU kernel's 1024-frame padding and VMEM sizing are not carried over:
the CUDA kernel masks its own ragged edge and needs 4*D bytes of shared
memory.
"""
from __future__ import annotations

import ctypes

import torch

from . import count_launch
from .frame_scoring import (
    NEG_INF, _INT8_EXACT_D, apply_new_exclusions, quantize_query,
    rank_from_frame_max,
)

MAX_TILES = 64  # bound on T that the wrapper accepts
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_PLAIN_CHUNK_FRAMES = 1 << 16  # frames per f32 upcast in the plain version


def _check(vectors, valid, excluded, qvec, row_scale):
    if vectors.dim() != 2 or valid.dim() != 2 or excluded.dim() != 1:
        raise ValueError("expected vectors (F*T, D), valid (F, T), excluded (F,)")
    F, T = valid.shape
    D = vectors.shape[1]
    if vectors.shape[0] != F * T or excluded.shape[0] != F or qvec.shape != (D,):
        raise ValueError(
            f"shape mismatch: vectors {tuple(vectors.shape)}, valid {(F, T)}, "
            f"excluded {tuple(excluded.shape)}, qvec {tuple(qvec.shape)}"
        )
    if vectors.dtype not in _KIND:
        raise TypeError(f"vectors must be f32, bf16 or int8 (got {vectors.dtype})")
    if valid.dtype != torch.bool or excluded.dtype != torch.bool:
        raise TypeError("valid and excluded must be bool")
    if row_scale is not None:
        if vectors.dtype != torch.int8:
            raise ValueError(
                f"row_scale is only meaningful for int8 vectors (got {vectors.dtype})"
            )
        if row_scale.shape != (F * T,) or row_scale.dtype != torch.float32:
            raise ValueError("row_scale must be f32 of shape (F*T,)")
    if vectors.dtype == torch.int8 and D > _INT8_EXACT_D:
        raise ValueError(f"int8 needs D <= {_INT8_EXACT_D}")
    return F, T, D


def fused_frame_max_plain(vectors, valid, excluded, qvec, row_scale=None):
    """Plain PyTorch version of the kernel: masked max of (V.float() @ q)
    viewed as (F, T), processed in frame chunks so that a 10M-row matrix is
    never upcast to f32 whole. Same arithmetic order as the kernel (int8:
    acc * row_scale, max, then * qmax/127 where finite)."""
    F, T, D = _check(vectors, valid, excluded, qvec, row_scale)
    qvec = qvec.to(torch.float32)
    if vectors.dtype == torch.int8:
        q_in, scale = quantize_query(qvec)
    else:
        q_in, scale = qvec.to(vectors.dtype).to(torch.float32), None
    out = torch.empty(F, dtype=torch.float32, device=vectors.device)
    for f0 in range(0, F, _PLAIN_CHUNK_FRAMES):
        f1 = min(F, f0 + _PLAIN_CHUNK_FRAMES)
        s = vectors[f0 * T:f1 * T].to(torch.float32) @ q_in
        if row_scale is not None:
            s = s * row_scale[f0 * T:f1 * T]
        s = torch.where(valid[f0:f1], s.view(f1 - f0, T), NEG_INF).amax(dim=1)
        out[f0:f1] = torch.where(excluded[f0:f1], NEG_INF, s)
    if scale is not None:
        out = torch.where(torch.isfinite(out), out * scale, out)
    return out


def fused_frame_max(vectors, valid, excluded, qvec, row_scale=None):
    """(F,) f32 per-frame maxima of V.q over valid tiles, excluded -> -inf.

    vectors (F*T, D) f32/bf16/int8 contiguous; valid (F, T) bool; excluded
    (F,) bool; qvec (D,) f32; row_scale (F*T,) f32 for int8 only. CPU tensors
    take the plain version; CUDA tensors launch the kernel or raise."""
    if vectors.device.type == "cpu":
        return fused_frame_max_plain(vectors, valid, excluded, qvec, row_scale)
    if vectors.device.type != "cuda":
        raise ValueError(f"unsupported device {vectors.device}")
    F, T, D = _check(vectors, valid, excluded, qvec, row_scale)
    dev = vectors.device
    tensors = [valid, excluded, qvec] + ([row_scale] if row_scale is not None else [])
    if any(t.device != dev for t in tensors):
        raise ValueError("all inputs must be on the device of `vectors`")
    if not (vectors.is_contiguous() and valid.is_contiguous()
            and excluded.is_contiguous()
            and (row_scale is None or row_scale.is_contiguous())):
        raise ValueError("inputs must be contiguous")
    if T > MAX_TILES:
        raise ValueError(f"tile_bound {T} exceeds the kernel's bound {MAX_TILES}")
    if (D * vectors.element_size()) % 16 or vectors.data_ptr() % 16:
        raise ValueError(
            "each row must be a multiple of 16 bytes on a 16-byte aligned base "
            f"(D={D}, dtype={vectors.dtype})"
        )
    if D * 4 > 48 * 1024:
        raise ValueError(f"D={D} exceeds the kernel's shared-memory query bound")

    qvec = qvec.to(torch.float32)
    q_scale = None
    if vectors.dtype == torch.int8:
        q_i8, q_scale = quantize_query(qvec)
        q_dev = q_i8.to(torch.int8).contiguous()
        q_scale = q_scale.reshape(1).contiguous()
    elif vectors.dtype == torch.bfloat16:
        q_dev = qvec.to(torch.bfloat16).to(torch.float32).contiguous()
    else:
        q_dev = qvec.contiguous()

    from .._build import load_library

    lib = load_library("fused_frame_max")
    fn = lib.seesaw_fused_frame_max
    P = ctypes.c_void_p
    fn.argtypes = [ctypes.c_int, P, P, P, P, P, P, P,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int, P]
    fn.restype = ctypes.c_int
    out = torch.empty(F, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(
            _KIND[vectors.dtype], vectors.data_ptr(), q_dev.data_ptr(),
            valid.data_ptr(), excluded.data_ptr(),
            row_scale.data_ptr() if row_scale is not None else None,
            q_scale.data_ptr() if q_scale is not None else None,
            out.data_ptr(), F, T, D, stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_frame_max kernel launch failed: CUDA error {err}")
    count_launch(fused_frame_max)
    return out


fused_frame_max.launches = 0  # kernel launches in this process (CUDA only)


def query_program_fused(
    vectors, valid, boxes, zoom, qvec, excluded, row_scale=None, *,
    shortlist_size: int, topk: int, aug_larger: str = "all",
    aug_weight: str = "level_max", agg_method: str = "avg_score", max_zoom: int = 8,
):
    """Full query with the fused shortlist scan: only the shortlisted
    frames' tiles are rescored (frame_scoring.rank_from_frame_max)."""
    fmax = fused_frame_max(vectors, valid, excluded, qvec, row_scale)
    return rank_from_frame_max(
        vectors, valid, boxes, zoom, qvec, fmax, row_scale, None,
        shortlist_size=shortlist_size, topk=topk, tile_bound=valid.shape[1],
        aug_larger=aug_larger, aug_weight=aug_weight,
        agg_method=agg_method, max_zoom=max_zoom,
    )


def query_program_fused_incr(
    vectors, valid, boxes, zoom, qvec, excluded, new_excluded_ids,
    row_scale=None, **kw,
):
    """query_program_fused after merging the click's new exclusions; returns
    (QueryResult, updated mask)."""
    excluded = apply_new_exclusions(excluded, new_excluded_ids)
    res = query_program_fused(
        vectors, valid, boxes, zoom, qvec, excluded, row_scale, **kw
    )
    return res, excluded
