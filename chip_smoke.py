#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`seesaw_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device check: a CUDA device must be present; TF32 is switched off.
2. build the kernels from `seesaw_tpu_torch/csrc` with nvcc, one process
   per source, started together: the fused frame-max scan, the kNN
   SpMV / Jacobi step and the pair attention of the CLIP towers (f32 on the
   tensor cores through the 3xTF32 split, bf16 on the tensor cores).
3. each kernel vs its plain PyTorch version on the card, with CUDA-event
   times (kernel and plain version alternated) and the time of the nearest
   single PyTorch call:
   a. frame max: f32, bf16 and int8 with per-row scales, at a small ragged
      shape and at the main path's shape (10M rows = 1.25M frames x 8 tiles
      x 512 dims); library call `torch.mv`;
   b. kNN SpMV and Jacobi step: a small ragged graph (N=3001, Kp=13, -1
      padding, a hub, labeled and isolated rows), the main path's graph
      (10M x 32, window-local, `rounds.window_local_graph`) and a uniform
      graph of the same size; the Jacobi step in both modes (running, and
      done: the output must stay untouched); at 10M a step's time and a
      100-step segment's (one launch) whose run converges after a few
      steps, device and host ms, its two buffers (at the SpMV bar), steps
      and done flag equal to the plain version's; library call
      `torch.sparse.mm` on a CSR tensor of the same graph.
4. port sessions on the card against the same sessions on the CPU, on a
   small synthetic root: plain, rocchio_update and log_reg2, then knn_prop2
   over the k=8 graph saved beside the index (restricted to k=5); same
   dbidxs every round, and the
   kernels launched every round (knn_prop2: every feedback round). The
   root's info.json names `clip-custom:<dir>`, a small CLIP artifact (64-wide
   heads, embed_dim = the index's dim, seeded weights): each session loads
   it through `MultiscaleIndex.from_path` and the registry on its own
   device, the text vectors agree, and the first CUDA session's text query
   launches the attention kernel once per text layer.
5. the per-click main path at deployment scale, as the JAX package's bench
   drives it (bench.py bench_session_rounds): 10M x 512 bf16 vectors made on
   the device from a seed, `MultiscaleIndex.from_device_arrays`,
   rocchio_update and log_reg2 sessions (batch 3, shortlist 50, a simulated
   user accepting ~30%), then a shorter rocchio_update session on int8
   storage with per-row scales. Each session's text query (round 0) goes
   through the ViT-B/32 text tower on the card (`ClipEmbedding`, seeded
   random weights). The scan kernel's launch counter must rise every round,
   the attention kernel's by 12 (one per text layer) for each text query.
6. the KnnProp2 graph round at deployment scale (bench.py bench_graph_10M):
   phase 5's int8 index, a 10M x 32 window-local graph made on the device,
   8 rounds of rank -> labels -> update with the configured ranker, then 8
   with warm_start. The Jacobi kernel's launch counter must rise every round
   after round 0, by exactly the round's segments (one launch a segment),
   and each round reads the host once per segment.
7. the CLIP towers (`seesaw_tpu_torch.models.clip`), all at full width:
   a. the pair-attention kernel against its plain version at the towers'
      shapes (ViT-B/32 vision B=1024 f32 and bf16 and fine-tuning's B=256
      in both; text B=1 and B=64 causal, and B=256 in both; ViT-B/16 vision
      L=197 f32 and bf16; ViT-L/14 vision L=257 f32 and bf16; small ragged
      cases), two runs bit-identical, CUDA-event times alternated, library
      call `scaled_dot_product_attention` on the head-split layout; device
      times (the kernels' durations under torch.profiler) of the kernel and
      of SDPA beside the events times;
   b. ViT-B/32 towers on the card against the same on the CPU (the
      seeded weights of phase 5, a few strings and 224 x 224 images, f32),
      12 attention launches per tower call;
   c. text-encode latency: p50 over 20 distinct strings, cache bypassed;
   d. vision throughput: `encode_image_batch` at B=1024 in f32 and bf16,
      images/s, the attention kernel's share of the forward, peak memory.
8. CLIP fine-tuning and textual feedback (`seesaw_tpu_torch.models.
   clip_finetune`, `loops.textual`):
   a. the attention backward kernel (K6) against its plain backward at the
      towers' shapes (fine-tuning's B=256 for ViT-B/32 vision and text,
      ViT-B/16, ViT-L/14, small ragged cases), f32 and bf16: two runs with
      identical bits, CUDA-event times alternated with the plain version,
      library call `torch.autograd.grad` through
      `scaled_dot_product_attention` on the head-split layout (backward
      only: the graph is built outside the timed calls), device times as
      in 7a; then p bit-identical in the forward and backward, f32 and bf16
      (v and g one-hot, L = 50 and L = 13 causal);
   b. one contrastive step of ViT-B/32 at B=8 with every parameter
      trainable, f32: every gradient on the card against the CPU's, 24 K6
      launches (12 vision and 12 text layers);
   c. `CLIPFineTuner` on ViT-B/32 at B=256, lr 1e-5, weight decay 0.1,
      warmup 2, f32 and bf16: 2 warm-up then 8 timed steps, ms a step,
      pairs/s, K6's share of a step, peak memory; 24 K5 and 24 K6 launches
      a step, all of the step's type (f32: 3xTF32, bf16: bf16 tensor cores),
      finite losses, the last below the first; then one step with
      the default `text/projection` config, which must launch no K6;
   d. `textual` sessions (linear and finetune modes) on a root like phase
      4's, on the card against the CPU: same dbidxs every round.
9. the remaining feedback methods (`multi_reg`, `multi_reg_neg`,
   `pseudo_lr`, `active_search`, `lknn`); run after phase 6, before the
   towers' phases (whose peak memory it would move):
   a. sessions of each on a root like phase 4's (multi_reg with each of its
      three label losses; multi_reg_neg with rejected boxes described as a
      confusion class; the active-search loops one image a round), on the
      card against the CPU: same dbidxs every round, scores within 2e-3
      for the fitted loops (their LBFGS solves may end apart on the f32
      floor or at a hinge kink, `seesaw_tpu_torch/utils/solves.py`); the
      scan kernel launched in every multi_reg round, the Jacobi kernel in
      every pseudo_lr refine;
   b. multi_reg at full size: a 10M x 512 bf16 index made as in phase 5,
      its XLX from a 10M x 32 window-local graph summed on the card in row
      chunks from the index's rows (first held against numpy's XLX on a
      200k-row graph), ce_loss and pairwise_rank_loss sessions of 10 rounds:
      p50 `next` and round, LBFGS host syncs a fit, XLX seconds, peak
      memory, the scan kernel in every round; a first feedback fit against
      the CPU port's fit of the same rows (rtol 2e-4 / atol 2e-5, or solves
      held step by step up to a departure on the floor or at a kink);
   c. one multi-reg fit at the JAX package's refine shape (512 x 512,
      pairwise_rank_loss, XLX = 1e-3 I, max_iter 50): ms a fit on the host
      clock, host syncs, against the CPU port as in b;
   d. `ens_expected_value` at 1M x 32, K=10, block 4096: CUDA-event ms,
      values against the CPU port (rtol 1e-6 / atol 1e-6) and the same pick.

The line before the last is the kernel record (JSON); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import copy
import json
import shutil
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

ROOT = Path(__file__).resolve().parent
N_VECTORS, TILES, DIM = 10_000_000, 8, 512
SHORTLIST, BATCH = 50, 3
TOL = {  # kernel vs plain version, same bytes in
    # f32 / bf16: f32 accumulation of 512 products in another order
    "float32": dict(rtol=1e-5, atol=1e-4),
    "bfloat16": dict(rtol=1e-5, atol=1e-4),
    # int8: exact int32 dot, identical f32 epilogue
    "int8": dict(rtol=1e-6, atol=0.0),
}
# kNN SpMV / Jacobi step vs plain version: f32 sums of Kp products in
# another order (the JAX package's bar between its windowed and dense SpMV)
SPMV_TOL = dict(rtol=2e-5, atol=2e-6)
GRAPH_K = 32  # bench.py bench_graph_10M
# pair attention vs plain version, same inputs: f32 sums of 64-term logits
# and L-term P.V in another order, each product by the 3xTF32 split (~22
# bits of each operand, tests/test_torch_attention_3xtf32.py). bf16: the
# tensor cores sum the logits in another order than the plain version's f32
# GEMM, so a logit moves by an f32 bit and flips one p's bf16 rounding, or an
# output lands on the other side of its rounding boundary: one output ulp,
# so rtol 2^-7 (an ulp at the bottom of a binade) and atol 1e-3 (near 0),
# K6's bar; and at most ATTN_MAX_SHARE of the outputs may differ at all. A
# kernel that skipped rounding p to bf16 before P.V moves ~40% and fails
ATTN_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2**-7, atol=1e-3)}
ATTN_MAX_SHARE = 1e-3
ATTN_CASES = (  # (name, B, L, W, causal, dtype): the towers' shapes
    ("text query", 1, 77, 512, True, "float32"),
    ("text batch", 64, 77, 512, True, "float32"),
    ("text", 256, 77, 512, True, "float32"),
    ("text", 256, 77, 512, True, "bfloat16"),
    ("vit-b32 vision", 1024, 50, 768, False, "float32"),
    ("vit-b32 vision", 1024, 50, 768, False, "bfloat16"),
    ("vit-b32 vision", 256, 50, 768, False, "float32"),
    ("vit-b32 vision", 256, 50, 768, False, "bfloat16"),
    ("vit-b16 vision", 256, 197, 768, False, "float32"),
    ("vit-b16 vision", 256, 197, 768, False, "bfloat16"),
    ("vit-l14 vision", 64, 257, 1024, False, "float32"),
    ("vit-l14 vision", 64, 257, 1024, False, "bfloat16"),
    ("small ragged", 3, 13, 128, True, "float32"),
    ("small ragged", 3, 13, 128, True, "bfloat16"),
    ("small ragged", 5, 33, 256, False, "bfloat16"),
)
# CLIP ViT-B/32 towers on the card vs on the CPU, f32 with TF32 off, unit
# embeddings: 12 layers of f32 GEMMs summed in another order
TOWER_TOL = dict(rtol=1e-4, atol=1e-4)
TOWER_LAYERS = 12  # ViT-B/32: 12 text and 12 vision layers, one launch each
VISION_BATCH = 1024
# pair-attention backward vs its plain backward, same inputs: f32 as the
# forward. bf16: the tensor cores sum logits and dp in another order than
# the plain version's f32 GEMMs, and an element moves by one output ulp
# where an f32 value (a p or ds before its rounding, or an output) lands on
# a rounding boundary in one version and not the other, so rtol 2^-7 (one
# ulp at the bottom of a binade) and atol 1e-3 for outputs near 0, where one
# ds a rounding step off (2^-8 of a ds, times a key) is many ulps of the
# cancelled sum; and at most BWD_MAX_SHARE of the elements may differ at
# all: a kernel that skipped rounding ds to bf16 before dq and dk moves about
# half
BWD_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2**-7, atol=1e-3)}
BWD_MAX_SHARE = 1e-3
BWD_CASES = (  # (name, B, L, W, causal): fine-tuning's batch at the towers' shapes
    ("vit-b32 vision", 256, 50, 768, False),
    ("text", 256, 77, 512, True),
    ("vit-b16 vision", 64, 197, 768, False),
    ("vit-l14 vision", 32, 257, 1024, False),
    ("small ragged", 3, 13, 128, True),
    ("small ragged", 5, 1, 256, False),
)
# ViT-B/32 gradients on the card vs the CPU, f32 with TF32 off: each
# tensor's max difference over its own max (floored at 1e-3 of the largest
# gradient of the model, for tensors whose gradient is zero up to rounding,
# as the k_proj biases'), after 12 layers forward and back in another order
# (measured 6.1e-6)
GRAD_TOL = 1e-4
FT_BATCH = 256  # seesaw_tpu/models/clip_finetune.py:79-84 measured B=256
FT_CONFIG = {"opt_config": {"": {"lr": 1e-5, "weight_decay": 0.1}}, "warmup": 2}
FT_WARMUP, FT_STEPS = 2, 8
_TEXTUAL = dict(image_loss_weight=0.5, vector_box_min_iou=0.2, num_warmup_steps=4,
                rounds=4, label_margin=0.1, rank_margin=0.1)
# seesaw_tpu/configs.py "textual" in both modes (finetune with lr 5e-3)
TEXTUAL_OPTIONS = {"linear": dict(_TEXTUAL, mode="linear"),
                   "finetune": dict(_TEXTUAL, mode="finetune", lr=5e-3)}
# data-sheet peaks of one H100 SXM at 700 W: HBM bytes/s, and operations/s by
# input type (f32 outside the tensor cores; bf16 and int8 dense tensor rates)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
# the f32 attention kernels' route: three TF32 products (495 TFLOP/s dense)
# for each f32 product
PEAK_OPS_3XTF32 = 495e12 / 3


def bound(n_bytes: float, n_ops: float, dtype: str, peak_ops: float | None = None):
    """(least ms the card could take, what bounds it): operations at
    `peak_ops`, else at the input type's peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / (peak_ops or PEAK_OPS[dtype])
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def log(msg: str):
    print(msg, flush=True)


def bf16_ulps(got, want):
    """(max distance in units of the bf16 ulp of the larger of the two
    values, share of elements that differ)."""
    import torch

    g, w = got.float(), want.float()
    big = torch.maximum(g.abs(), w.abs()).clamp_min(2.0**-126)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    d = (g - w).abs()
    return float((d / ulp).max()), float((d > 0).float().mean())


# -- phase 3 -----------------------------------------------------------------
def make_scan_case(F, T, D, dtype, gen, dev):
    import torch

    n = F * T
    if dtype == "int8":
        V = torch.randint(-127, 128, (n, D), dtype=torch.int8, device=dev, generator=gen)
        rs = (torch.rand(n, device=dev, generator=gen) * 0.5 + 0.5) / 127.0
    else:
        V = torch.randn(n, D, device=dev, generator=gen, dtype=getattr(torch, dtype))
        rs = None
    valid = torch.rand(F, T, device=dev, generator=gen) < 0.9
    valid[:, 0] = True
    valid[1] = False  # a frame with no valid tile
    V[~valid.reshape(-1)] = 0
    excluded = torch.rand(F, device=dev, generator=gen) < 0.05
    return V, valid, excluded, rs


def check_scan(dev, gen):
    import torch

    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.utils.profiling import cuda_ms

    records, worst = [], 0.0
    for dtype in ("float32", "bfloat16", "int8"):
        for F, T, D in ((1001, 8, 32), (N_VECTORS // TILES, TILES, DIM)):
            V, valid, excluded, rs = make_scan_case(F, T, D, dtype, gen, dev)
            qs = [torch.randn(D, device=dev, generator=gen) for _ in range(10)]
            got = fs.fused_frame_max(V, valid, excluded, qs[0], rs)
            want = fs.fused_frame_max_plain(V, valid, excluded, qs[0], rs)
            torch.cuda.synchronize()
            if not torch.equal(torch.isfinite(got), torch.isfinite(want)):
                raise AssertionError(f"{dtype} {F}x{T}x{D}: -inf pattern differs")
            fin = torch.isfinite(want)
            err = float((got[fin] - want[fin]).abs().max())
            torch.testing.assert_close(got[fin], want[fin], **TOL[dtype])
            worst = max(worst, err)
            line = f"scan {dtype} F={F} T={T} D={D}: max_abs_err={err!r}"
            if F > 10_000:
                args = [(V, valid, excluded, q, rs) for q in qs]
                # alternate plain, kernel, kernel, plain on the same card
                p1 = cuda_ms(fs.fused_frame_max_plain, args)
                k1 = cuda_ms(fs.fused_frame_max, args)
                k2 = cuda_ms(fs.fused_frame_max, args)
                p2 = cuda_ms(fs.fused_frame_max_plain, args)
                k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
                # the kernel reads only the valid tiles' rows
                n_valid = int(valid.sum())
                read = n_valid * D * V.element_size()
                gbs = read / (k_ms * 1e-3) / 1e9
                # the function's bytes: valid rows (+ their scales), the masks,
                # the query in and one f32 per frame out
                moved = (read + valid.numel() + F + D * 4 + F * 4
                         + (n_valid * 4 if rs is not None else 0))
                b_ms, b_by = bound(moved, 2 * n_valid * D, dtype)
                lib_ms = None
                if dtype != "int8":  # nearest single call: the matvec (no int8 mv)
                    lib_ms = cuda_ms(torch.mv, [(V, q.to(V.dtype)) for q in qs])
                line += (f" kernel_ms={k_ms!r} plain_ms={p_ms!r} kernel_GB/s={gbs!r}"
                         f" bound_ms={b_ms!r} ({b_by}) torch.mv_ms={lib_ms!r}")
                records.append(dict(dtype=dtype, ms=k_ms, plain_ms=p_ms, gbs=gbs,
                                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
            log(line)
            del V, valid, excluded, rs
            torch.cuda.empty_cache()
    return records, worst


def small_graph(dev, gen, n=3001, K=13):
    """Ragged graph: -1 padding, a hub (vertex 5 in every row), isolated
    rows (degree 0)."""
    import torch

    nbr = torch.randint(0, n, (n, K), dtype=torch.int32, device=dev, generator=gen)
    nbr[:, 0] = 5
    nbr[7, K // 2:] = -1
    nbr[11:14] = -1
    w = torch.rand(n, K, device=dev, generator=gen) * 0.9 + 0.1
    w[nbr < 0] = 0.0
    return nbr, w, w.sum(dim=1)


def check_spmv_case(name, nbr, w, degree, gen, timed):
    """knn_spmv and jacobi_step against their plain versions (the Jacobi
    step running and after `done`), then a whole propagation on the card
    against the same on the CPU; with `timed`, CUDA-event times of both
    kernels, their plain versions and torch.sparse.mm on a CSR copy."""
    import torch

    from seesaw_tpu_torch.ops import spmv
    from seesaw_tpu_torch.ops.propagation import propagate
    from seesaw_tpu_torch.utils import rounds as R
    from seesaw_tpu_torch.utils.profiling import cuda_ms

    dev = nbr.device
    n, K = nbr.shape
    f = torch.rand(n, device=dev, generator=gen)
    got, want = spmv.knn_spmv(f, nbr, w), spmv.knn_spmv_plain(f, nbr, w)
    torch.testing.assert_close(got, want, **SPMV_TOL)
    worst = float((got - want).abs().max())

    prior = torch.rand(n, device=dev, generator=gen)
    labels = (torch.rand(n, device=dev, generator=gen) < 0.3).float()
    is_labeled = torch.rand(n, device=dev, generator=gen) < 0.01
    denom = torch.where(degree + 1.0 > 0, degree + 1.0, 1.0)
    step_args = (nbr, w, denom, prior, labels, is_labeled)  # lambda = 1
    for done in (0, 1):
        outs = []
        for step in (spmv.jacobi_step, spmv.jacobi_step_plain):
            out, state = torch.full_like(f, 7.0), spmv.new_state(dev)
            state[spmv.DONE] = done
            step(f, out, *step_args, state, 1e-5)
            outs.append((out, state))
        torch.cuda.synchronize()
        (k_out, k_state), (p_out, p_state) = outs
        if k_state.tolist() != p_state.tolist():
            raise AssertionError(f"{name}: jacobi state {k_state.tolist()} != {p_state.tolist()}")
        if done and not bool((k_out == 7.0).all()):
            raise AssertionError(f"{name}: a step after `done` wrote its output")
        torch.testing.assert_close(k_out, p_out, **SPMV_TOL)
        worst = max(worst, float((k_out - p_out).abs().max()))
        if not done:
            dmax = float(((p_out - f) ** 2).max())
    # the max-delta scalar: done exactly when the plain max square is below eps
    for scale, want_done in ((1 + 1e-4, 1), (1 - 1e-4, 0)):
        state = spmv.new_state(dev)
        spmv.jacobi_step(f, torch.empty_like(f), *step_args, state, dmax * scale)
        if int(state[spmv.DONE]) != want_done:
            raise AssertionError(f"{name}: done={int(state[spmv.DONE])} at eps={dmax * scale!r}")

    # a whole run: the done flag stops the segment's remaining steps
    kw = dict(reg_lambda=1.0, epsilon=1e-5, dispatch_iters=100)
    run_args = (nbr, w, degree, prior, labels, is_labeled, prior.clone())
    on_gpu = propagate(*run_args, **kw)
    line = (f"spmv {name} N={n} Kp={K}: max_abs_err={worst!r} propagate n_iter="
            f"{on_gpu.n_iter} converged={on_gpu.converged} host_reads={on_gpu.host_reads}")
    if not on_gpu.converged or on_gpu.host_reads != 1:
        raise AssertionError(f"{name}: propagation {on_gpu[1:]}")
    if not timed:  # small: the same run on the CPU (plain steps) agrees
        on_cpu = propagate(*(t.cpu() for t in run_args), **kw)
        if on_gpu.n_iter != on_cpu.n_iter:
            raise AssertionError(f"{name}: {on_gpu.n_iter} steps on the card, {on_cpu.n_iter} on the CPU")
        err = float((on_gpu.scores.cpu() - on_cpu.scores).abs().max())
        torch.testing.assert_close(on_gpu.scores.cpu(), on_cpu.scores, **SPMV_TOL)
        log(line + f" cuda_vs_cpu_err={err!r}")
        return dict(max_abs_err=worst)

    fs = [(torch.rand(n, device=dev, generator=gen), nbr, w) for _ in range(10)]
    p1 = cuda_ms(spmv.knn_spmv_plain, fs)
    k1 = cuda_ms(spmv.knn_spmv, fs)
    k2 = cuda_ms(spmv.knn_spmv, fs)
    p2 = cuda_ms(spmv.knn_spmv_plain, fs)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    # eps 0: never done, so every timed step does the full work
    bufs = (f, torch.empty_like(f))
    steps = [(bufs[i % 2], bufs[(i + 1) % 2], *step_args, spmv.new_state(dev), 0.0)
             for i in range(10)]
    jp1 = cuda_ms(spmv.jacobi_step_plain, steps)
    jk1 = cuda_ms(spmv.jacobi_step, steps)
    jk2 = cuda_ms(spmv.jacobi_step, steps)
    jp2 = cuda_ms(spmv.jacobi_step_plain, steps)
    j_ms, jp_ms = (jk1 + jk2) / 2, (jp1 + jp2) / 2
    # a serving segment: one launch, SEGMENT_WORK steps doing work, the rest
    # skipped on the device; both buffers, its steps and done flag as the
    # plain version's
    seg_eps = R.converging_eps(f, step_args)
    seg = R.segment_ms(spmv.jacobi_step, f, step_args, seg_eps)
    want = (f.clone(), torch.empty_like(f), spmv.new_state(dev))
    spmv.jacobi_step_plain(want[0], want[1], *step_args, want[2], seg_eps, R.SEGMENT_STEPS)
    if [seg["steps"], seg["done"]] != want[2][[spmv.ITERS, spmv.DONE]].tolist() \
            or seg["launches"] != 1:
        raise AssertionError(f"{name}: segment {seg} against the plain version's "
                             f"{want[2].tolist()}")
    for got_buf, want_buf in zip(seg.pop("out")[:2], want[:2]):
        torch.testing.assert_close(got_buf, want_buf, **SPMV_TOL)
        worst = max(worst, float((got_buf - want_buf).abs().max()))
    del want
    # library yardstick: cuSPARSE through torch.sparse.mm on a CSR copy
    # (columns sorted within each row), used nowhere in the port
    real = nbr >= 0
    cols, order = torch.where(real, nbr, n).sort(dim=1)
    vals = torch.gather(w, 1, order)
    keep = cols < n
    counts = keep.sum(dim=1)
    crow = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    crow[1:] = counts.cumsum(0)
    A = torch.sparse_csr_tensor(crow, cols[keep].long(), vals[keep], size=(n, n))
    del cols, order, vals, keep
    lib_out = torch.sparse.mm(A, fs[0][0][:, None])[:, 0]
    torch.testing.assert_close(lib_out, spmv.knn_spmv_plain(*fs[0]), rtol=1e-4, atol=1e-4)
    lib_ms = cuda_ms(lambda f_, *_: torch.sparse.mm(A, f_[:, None]), fs)
    del A, lib_out
    slots = int(real.sum())
    # W f: nbr + w, f once, wf out; the step also reads denom, lam * prior,
    # labels and is_labeled, and writes the new iterate
    b_ms, b_by = bound(n * K * 8 + n * 4 + n * 4, 2 * slots, "float32")
    jb_ms, _ = bound(n * K * 8 + n * (4 + 4 * 3 + 1) + n * 4, 2 * slots + 4 * n, "float32")
    gbs = (n * K * 8 + 4 * slots + 4 * n) / (k_ms * 1e-3) / 1e9
    log(line + f" kernel_ms={k_ms!r} plain_ms={p_ms!r} torch.sparse.mm_csr_ms={lib_ms!r}"
        f" bound_ms={b_ms!r} ({b_by}) effective_GB/s={gbs!r} jacobi_kernel_ms={j_ms!r}"
        f" jacobi_plain_ms={jp_ms!r} jacobi_bound_ms={jb_ms!r}"
        f" segment_of_{R.SEGMENT_STEPS}: steps={seg['steps']} done={seg['done']}"
        f" launches={seg['launches']} device_ms={seg['device_ms']!r}"
        f" host_ms={seg['host_ms']!r}")
    return dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, gbs=gbs, jacobi_ms=j_ms,
                jacobi_plain_ms=jp_ms, jacobi_bound_ms=jb_ms, segment=seg)


def check_spmv(dev, gen):
    import torch

    from seesaw_tpu_torch.utils import rounds as R

    small = check_spmv_case("small ragged", *small_graph(dev, gen), gen, timed=False)
    g = R.window_local_graph(N_VECTORS, GRAPH_K, dev, gen)
    rec = check_spmv_case("main window-local", g.nbr, g.w, g.degree, gen, timed=True)
    del g
    torch.cuda.empty_cache()
    uni = check_spmv_case("main uniform", *R.uniform_graph(N_VECTORS, GRAPH_K, dev, gen),
                          gen, timed=True)
    torch.cuda.empty_cache()
    rec["max_abs_err"] = max(rec["max_abs_err"], small["max_abs_err"], uni["max_abs_err"])
    rec["uniform"] = uni
    return rec


# -- phase 4 -----------------------------------------------------------------
# the synthetic root's CLIP: kernel-eligible towers (64-wide heads, an even
# head count), embed_dim set to the index's dim
SMOKE_CLIP = dict(image_size=32, patch_size=16, vision_width=128, vision_layers=1,
                  vision_heads=2, vocab_size=99, context_length=16, text_width=128,
                  text_layers=2, text_heads=2)


def write_clip_artifact(path: Path, d: int, seed=0) -> str:
    """A converted-checkpoint directory (params.npz + info.json, no vocab:
    the hash tokenizer) of seeded weights; returns its `clip-custom:` name."""
    import torch

    from seesaw_tpu_torch.models.clip import (ClipConfig, config_to_info, init_params,
                                              save_params_npz)

    cfg = ClipConfig(embed_dim=d, **SMOKE_CLIP)
    path.mkdir(parents=True)
    save_params_npz(init_params(cfg, torch.Generator().manual_seed(seed)),
                    str(path / "params.npz"))
    (path / "info.json").write_text(json.dumps(dict(config_to_info(cfg), variant="custom")))
    return f"clip-custom:{path}"


def write_synthetic_root(root: Path, n_images=80, d=32, seed=0):
    """A planted multiscale index in the on-disk format both packages read
    (vectors.npz + info.json), like tests/synth.py, whose info.json names a
    small CLIP artifact written beside the root: positives hold a tile near
    that model's text embedding of the query. Returns (gdm, gt, model name)."""
    from seesaw_tpu_torch import GlobalDataManager
    from seesaw_tpu_torch.models.registry import load_embedding

    model = write_clip_artifact(root.with_name(root.name + "_clip"), d, seed)
    rng = np.random.default_rng(seed)
    qvec = load_embedding(model, "cpu").from_string(string="a dog")
    gdm = GlobalDataManager(str(root))
    ds = gdm.create_dataset("smoke", paths=[f"img_{i:04d}.jpg" for i in range(n_images)])
    is_pos = np.zeros(n_images, bool)
    is_pos[rng.choice(n_images, size=n_images // 4, replace=False)] = True
    img = 224.0
    quads = [(0, 0, img / 2, img / 2), (img / 2, 0, img, img / 2),
             (0, img / 2, img / 2, img), (img / 2, img / 2, img, img)]
    dbidx, zoom, boxes, vecs, gt = [], [], [], [], {}
    for i in range(n_images):
        target = int(rng.integers(0, 4)) if is_pos[i] else -1
        for t, (zl, box) in enumerate([(1, q) for q in quads] + [(2, (0, 0, img, img))]):
            v = rng.normal(size=d).astype(np.float32)
            v /= np.linalg.norm(v)
            if is_pos[i] and (t == target or zl == 2):
                v = qvec + 0.55 * v
                v /= np.linalg.norm(v)
            dbidx.append(i)
            zoom.append(zl)
            boxes.append(box)
            vecs.append(v)
        if is_pos[i]:
            gt[i] = quads[target]
    path = Path(ds.index_path("multiscale"))
    path.mkdir(parents=True)
    np.savez(path / "vectors.npz", vectors=np.stack(vecs), dbidx=np.array(dbidx),
             zoom_level=np.array(zoom), boxes=np.array(boxes, np.float32))
    (path / "info.json").write_text(json.dumps({
        "constructor": "seesaw_tpu.indices.multiscale.MultiscaleIndex",
        "model": model, "excluded": [],
    }))
    # k=8: multi_reg's degree (phase 9a); the other graph loops restrict it
    save_knn_graph(np.stack(vecs), path / "knn_graph", k=8)
    return gdm, gt, model


def save_knn_graph(V: np.ndarray, path: Path, k: int):
    """Brute-force cosine kNN of the index's rows (ascending distance, lower
    row first on ties), saved in the reference's `forward.parquet` format by
    the port's KNNGraph."""
    from seesaw_tpu_torch.knn_graph import KNNGraph

    dist = 1.0 - V @ V.T
    np.fill_diagonal(dist, np.inf)
    dst = np.argsort(dist, axis=1, kind="stable")[:, :k]
    KNNGraph(dst, np.take_along_axis(dist, dst, axis=1)).save(path)


SESSION_OPTIONS = {
    "plain": {},
    "rocchio_update": dict(rocchio_alpha=1.0, rocchio_beta=0.7, rocchio_gamma=0.3),
    "log_reg2": dict(class_weights="balanced", scale="centered", reg_lambda=5.0,
                     fit_intercept=False, max_iter=50),
    "knn_prop2": dict(matrix_options=dict(knn_path="", knn_k=5, edist=0.5),
                      normalize_scores=True, normalize_epsilon=0.1,
                      sigmoid_before_propagate=True, calib_a=2.0, calib_b=-0.5,
                      prior_weight=1.0),
}


CONFUSION = "a cat"  # phase 9a's description of a rejected box


def small_session_rounds(gdm, gt, method, device, rounds=6, *, options=None, batch=BATCH,
                         confusion=False):
    """One session on the small root. Returns a namespace: the dbidxs of
    each round, all activation scores, for each round whether its ranking
    ran a staged propagation (knn_prop2), the scan kernel's launches in its
    `next`, the Jacobi kernel's launches in its `next` and in its `refine`,
    the session's text vector, its embedding, and the attention kernel's
    launches in its text query. The simulated user accepts each ground-truth
    box; with `confusion` it rejects every other image by a box described
    CONFUSION."""
    from seesaw_tpu_torch import Box, IndexSpec, SessionParams, make_session
    from seesaw_tpu_torch.ops import attention, spmv
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops.propagation import DeferredPropagation

    p = SessionParams(index_spec=IndexSpec(d_name="smoke", i_name="multiscale"),
                      interactive=method, batch_size=batch, shortlist_size=20,
                      interactive_options=options or SESSION_OPTIONS[method],
                      index_options={"use_pallas": True})
    s = make_session(gdm, p, device=device)["session"]
    attn_before = attention.pair_attention.launches
    s.set_text("a dog")
    out = SimpleNamespace(dbidxs=[], staged=[], scan=[], next_jacobi=[], refine_jacobi=[],
                          text_launches=attention.pair_attention.launches - attn_before)
    for _ in range(rounds):
        model = s.loop.state.knn_model
        out.staged.append(model is not None
                          and isinstance(model.current_scores_any(), DeferredPropagation))
        jac, scan = spmv.jacobi_step.launches, fs.fused_frame_max.launches
        out.dbidxs.append([int(i) for i in s.next()])
        out.scan.append(fs.fused_frame_max.launches - scan)
        out.next_jacobi.append(spmv.jacobi_step.launches - jac)
        state = s.get_state()
        for im in state.gdata[-1]:
            b = gt.get(im.dbidx)
            if b is not None:
                im.boxes = [Box(x1=b[0], y1=b[1], x2=b[2], y2=b[3], marked_accepted=True)]
            elif confusion:
                im.boxes = [Box(x1=0.0, y1=0.0, x2=112.0, y2=112.0, description=CONFUSION,
                                marked_accepted=False)]
            else:
                im.boxes = []
        s.update_state(state)
        jac = spmv.jacobi_step.launches
        s.refine()
        out.refine_jacobi.append(spmv.jacobi_step.launches - jac)
    out.scores = np.array([a["score"] for acts in s.acc_activations for a in (acts or [])],
                          np.float32)
    # the string cache returns round 0's vector without a launch
    out.tvec, out.embedding = s.index.string2vec("a dog"), s.index.embedding
    return out


def check_sessions_cuda_vs_cpu():
    import torch

    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.models.registry import load_embedding
    from seesaw_tpu_torch.ops import fused_scoring as fs

    root = ROOT / "build" / "seesaw_tpu_torch" / "smoke_root"
    artifact = root.with_name(root.name + "_clip")
    for d in (root, artifact):
        shutil.rmtree(d, ignore_errors=True)
    gdm, gt, model = write_synthetic_root(root)
    on_card = load_embedding(model, "cuda:0")
    if load_embedding(model, "cuda") is not on_card:
        raise AssertionError("the registry keeps two models for 'cuda' and 'cuda:0'")
    for i, method in enumerate(("plain", "rocchio_update", "log_reg2", "knn_prop2")):
        before = fs.fused_frame_max.launches
        gpu = small_session_rounds(gdm, gt, method, torch.device("cuda"))
        on_gpu, s_gpu, tvec_gpu, emb_gpu = gpu.dbidxs, gpu.scores, gpu.tvec, gpu.embedding
        graph, text_launches = list(zip(gpu.staged, gpu.next_jacobi)), gpu.text_launches
        torch.cuda.synchronize()
        if emb_gpu is not on_card or not isinstance(emb_gpu, ClipEmbedding):
            raise AssertionError(f"{method}: the CUDA index did not load {model} on the card")
        # the first session encodes the query (one launch per text layer);
        # the shared embedding's string cache serves the later ones
        want = SMOKE_CLIP["text_layers"] if i == 0 else 0
        if text_launches != want:
            raise AssertionError(f"{method}: the text query made {text_launches} "
                                 f"attention launches, not {want}")
        if method == "knn_prop2":  # the scan is not on the graph round
            feedback = [n for staged, n in graph if staged]
            if not feedback or min(feedback) == 0:
                raise AssertionError(f"knn_prop2: Jacobi launches per feedback round {graph}")
        elif fs.fused_frame_max.launches - before < len(on_gpu):
            raise AssertionError(f"{method}: the CUDA session did not launch the kernel")
        cpu = small_session_rounds(gdm, gt, method, torch.device("cpu"))
        on_cpu, s_cpu, tvec_cpu, emb_cpu = cpu.dbidxs, cpu.scores, cpu.tvec, cpu.embedding
        if emb_cpu.device.type != "cpu":
            raise AssertionError(f"{method}: the CPU index took a model on {emb_cpu.device}")
        # unit text vector through 2 f32 layers, TF32 off
        np.testing.assert_allclose(tvec_gpu, tvec_cpu, rtol=1e-5, atol=1e-5)
        if on_gpu != on_cpu:
            raise AssertionError(f"{method}: cuda {on_gpu} != cpu {on_cpu}")
        err = float(np.abs(s_gpu - s_cpu).max())
        tvec_err = float(np.abs(tvec_gpu - tvec_cpu).max())
        log(f"session {method} ({model.split(':')[0]} index): cuda == cpu dbidxs over "
            f"{len(on_gpu)} rounds; max activation score diff {err!r}; text vector diff "
            f"{tvec_err!r}; attention launches in the text query {text_launches}"
            + (f"; (staged, Jacobi launches) per round {graph}" if method == "knn_prop2" else ""))
    for d in (root, artifact):
        shutil.rmtree(d, ignore_errors=True)


# -- phase 5 -----------------------------------------------------------------
def check_main_query(idx):
    """One full query through the kernel path against the plain full-score
    program on the same index: same frames, same activation scores."""
    import torch

    from seesaw_tpu_torch.ops import frame_scoring, fused_scoring

    q = torch.from_numpy(idx.string2vec("check")).to(idx.device)
    excl = torch.zeros(idx.n_frames, dtype=torch.bool, device=idx.device)
    kw = dict(shortlist_size=SHORTLIST, topk=10, max_zoom=idx._max_zoom)
    got = fused_scoring.query_program_fused(
        idx._V, idx._valid, idx._boxes, idx._zoom, q, excl, idx._row_scale, **kw)
    want = frame_scoring.query_program(
        idx._V, idx._valid, idx._boxes, idx._zoom, q, None, excl, idx._row_scale, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got.frame_ids, want.frame_ids):
        raise AssertionError(f"{got.frame_ids.tolist()} != {want.frame_ids.tolist()}")
    torch.testing.assert_close(got.act_scores, want.act_scores, rtol=1e-5, atol=1e-5)


def main_path(dev, gen, card, clip):
    import torch

    from seesaw_tpu_torch.ops import attention
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.utils import rounds as R

    rocchio, logreg = (R.session_params(m, batch_size=BATCH, shortlist_size=SHORTLIST)
                       for m in ("rocchio_update", "log_reg2"))
    rng = np.random.default_rng(0)
    idx = R.device_index(N_VECTORS, DIM, "bfloat16", device=dev, generator=gen,
                         embedding=clip)
    check_main_query(idx)
    log("main query: kernel path == plain full-score path (bf16, 10M rows)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # count only the main path's launches
    fs.fused_frame_max.launches = 0
    attention.reset_launch_counts()
    for name, params, rounds, dtype in (
        ("rocchio_update bf16", rocchio, 10, "bfloat16"),
        ("log_reg2 bf16", logreg, 10, "bfloat16"),
        ("rocchio_update int8", rocchio, 6, "int8"),
    ):
        if dtype == "int8" and idx.device_dtype != "int8":
            del idx
            torch.cuda.empty_cache()
            idx = R.device_index(N_VECTORS, DIM, "int8", device=dev, generator=gen,
                                 embedding=clip)
        before = attention.pair_attention.launches
        # a text query of its own per session: the embedding caches strings
        next_ms, round_ms, syncs = R.drive_session(idx, params, rounds, rng,
                                                   text=f"a photo for the {name} session")
        torch.cuda.synchronize()
        if attention.pair_attention.launches - before != TOWER_LAYERS:
            raise AssertionError(f"{name}: the text query made "
                                 f"{attention.pair_attention.launches - before} attention launches")
        # round 0 is the text query (no feedback yet); p50 over rounds 1..
        p50n, p50r = float(np.median(next_ms[1:])), float(np.median(round_ms[1:]))
        line = (f"[{card}] {name}: rounds={rounds} p50_session_next_ms={p50n!r} "
                f"p50_round_ms={p50r!r} round0_ms={round_ms[0]!r}")
        if syncs:
            line += f" lbfgs_host_syncs_per_round={syncs}"
        log(line)
    launches = fs.fused_frame_max.launches
    attn_launches = attention.pair_attention.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{card}] main path: kernel launches={launches} pair_attention launches="
        f"{attn_launches} peak device memory GB={peak!r}")
    if launches < 26:
        raise AssertionError(f"only {launches} kernel launches in 26 rounds")
    return launches, attn_launches, idx


# -- phase 6 -----------------------------------------------------------------
def knnprop_path(idx, dev, gen, card, rounds=8):
    """KnnProp2 rounds at full width over phase 5's index (bench.py
    bench_graph_10M): cold, then warm-started. Returns the launches of each
    kernel entry point in this path."""
    import torch

    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops import spmv
    from seesaw_tpu_torch.utils import rounds as R

    weights = R.window_local_graph(idx.meta.n_vectors, GRAPH_K, dev, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.fused_frame_max.launches = spmv.knn_spmv.launches = spmv.jacobi_step.launches = 0
    for name, warm in (("knn_prop2", False), ("knn_prop2 warm_start", True)):
        ranker = R.knnprop_ranker(weights, dev, warm_start=warm)
        before = spmv.jacobi_step.launches
        out = R.drive_knnprop_rounds(idx, ranker, rounds, seed=0, batch_size=BATCH,
                                     shortlist_size=SHORTLIST)
        torch.cuda.synchronize()
        if not all(out["propagated"][1:]):
            raise AssertionError(f"{name}: rounds without propagation {out['propagated']}")
        segs = [-(-i // ranker.lp.dispatch_iters) for i in out["iters"]]
        if any(r > 1 + s for r, s in zip(out["host_reads"], segs)):
            raise AssertionError(f"{name}: host reads {out['host_reads']} for segments {segs}")
        if out["launches"] != segs:  # one launch a segment
            raise AssertionError(f"{name}: Jacobi launches {out['launches']} for segments {segs}")
        # round 0 ranks the text prior; the first fused round warms the
        # allocator: p50 over rounds 2..
        p50 = float(np.median(out["round_ms"][2:]))
        log(f"[{card}] {name} {idx.meta.n_vectors}x{GRAPH_K} graph, {idx.device_dtype} "
            f"index: rounds={rounds} p50_round_ms={p50!r} round_ms={out['round_ms']} "
            f"jacobi_iters_per_round={out['iters']} host_reads_per_round={out['host_reads']}"
            f" jacobi_launches_per_round={out['launches']} segments_per_round={segs} "
            f"launches={spmv.jacobi_step.launches - before}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {"knn_spmv": spmv.knn_spmv.launches, "jacobi_step": spmv.jacobi_step.launches}
    log(f"[{card}] knn_prop2 path: kernel launches={launches} "
        f"fused_frame_max launches={fs.fused_frame_max.launches} "
        f"peak device memory GB={peak!r}")
    return launches


# -- phase 7 -----------------------------------------------------------------
def attention_bound(B, L, W, causal, dtype):
    """q, k, v read once and out written once; 2 x 2 x 64 operations per
    query-key pair that the mask keeps (Q K^T and P V; the softmax's
    exponentials are left out); f32 at the 3xTF32 rate."""
    pairs = L * (L + 1) // 2 if causal else L * L
    elem = 4 if dtype == "float32" else 2
    peak = PEAK_OPS_3XTF32 if dtype == "float32" else None
    return bound(4 * B * L * W * elem, 4 * 64 * B * (W // 64) * pairs, dtype, peak)


def check_attention(dev, gen):
    """Phase 7a: the pair-attention kernel against its plain version at each
    case of ATTN_CASES; two runs bit-identical; CUDA-event times over 5
    input sets (plain, kernel, kernel, plain) and of
    scaled_dot_product_attention on the head-split (B, H, L, 64) layout,
    split before the timed calls; device times of the kernel and of SDPA."""
    import torch
    import torch.nn.functional as F

    from seesaw_tpu_torch.ops import attention as A
    from seesaw_tpu_torch.utils.profiling import cuda_ms, device_ms

    records = []
    for name, B, L, W, causal, dtype in ATTN_CASES:
        sets = [[torch.randn(B, L, W, device=dev, generator=gen).to(getattr(torch, dtype))
                 for _ in range(3)] for _ in range(5)]
        q, k, v = sets[0]
        got = A.pair_attention(q, k, v, causal=causal, heads=W // 64)
        again = A.pair_attention(q, k, v, causal=causal, heads=W // 64)
        want = A.pair_attention_plain(q, k, v, causal=causal)
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"attention {name} {dtype}: two runs differ")
        err = float((got.float() - want.float()).abs().max())
        torch.testing.assert_close(got.float(), want.float(), **ATTN_TOL[dtype])
        ulps, share = bf16_ulps(got, want) if dtype == "bfloat16" else (0.0, 0.0)
        if share > ATTN_MAX_SHARE:
            raise AssertionError(f"attention {name} bf16: {share!r} of the outputs differ "
                                 f"from the plain version")

        def kern(q, k, v):
            return A.pair_attention(q, k, v, causal=causal)

        def plain(q, k, v):
            return A.pair_attention_plain(q, k, v, causal=causal)

        p1, k1, k2, p2 = (cuda_ms(f, sets) for f in (plain, kern, kern, plain))
        split = [[t.view(B, L, W // 64, 64).transpose(1, 2).contiguous() for t in qkv]
                 for qkv in sets]

        def library(q, k, v):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal)

        lib_out = library(*split[0]).transpose(1, 2).reshape(B, L, W)
        lib_err = float((lib_out.float() - want.float()).abs().max())
        lib_ms = cuda_ms(library, split)
        dev_ms, lib_dev_ms = device_ms(kern, sets), device_ms(library, split)
        b_ms, b_by = attention_bound(B, L, W, causal, dtype)
        rec = dict(case=name, B=B, L=L, W=W, causal=causal, dtype=dtype,
                   ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                   device_ms=dev_ms, library_device_ms=lib_dev_ms,
                   bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
        line = (f"attention {name} B={B} L={L} W={W} causal={causal} {dtype}: "
                f"max_abs_err={err!r} kernel_ms={rec['ms']!r} kernel_device_ms={dev_ms!r} "
                f"plain_ms={rec['plain_ms']!r} sdpa_ms={lib_ms!r} "
                f"sdpa_device_ms={lib_dev_ms!r} (sdpa vs plain max_abs_err={lib_err!r}) "
                f"bound_ms={b_ms!r} ({b_by}) bit-identical reruns")
        if dtype == "bfloat16":
            rec.update(max_ulps=ulps, share_differing=share)
            line += f" max_ulps={ulps!r} share_differing={share!r}"
        log(line)
        records.append(rec)
        del sets, split, got, again, want, lib_out
        torch.cuda.empty_cache()
    return records


def check_towers(dev, params):
    """Phase 7b: ViT-B/32 towers on the card against the same weights on the
    CPU, f32: unit text and image embeddings within TOWER_TOL, 12 attention
    launches per tower call on the card."""
    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.ops import attention as A

    on_gpu = ClipEmbedding("vit-b32", device=dev, params=params)
    on_cpu = ClipEmbedding("vit-b32", device="cpu", params=params)
    strings = ["a photo of a dog", "two cats on a red couch",
               "an aerial photograph of city traffic at night", "x"]
    px = np.random.default_rng(0).normal(size=(4, 224, 224, 3)).astype(np.float32)
    results = {}
    for what, run in (("text", lambda e: e.from_string(str_list=strings)),
                      ("image", lambda e: e.from_image(preprocessed_image=px))):
        before = A.pair_attention.launches
        got = run(on_gpu)
        launched = A.pair_attention.launches - before
        if launched != TOWER_LAYERS:
            raise AssertionError(f"{what} tower: {launched} attention launches, not {TOWER_LAYERS}")
        want = run(on_cpu)
        if not np.isfinite(got).all() or got.shape != (4, 512):
            raise AssertionError(f"{what} tower: shape {got.shape} or non-finite values")
        np.testing.assert_allclose(got, want, **TOWER_TOL)
        results[what] = float(np.abs(got - want).max())
    log(f"towers vit-b32 f32, cuda vs cpu: text max_abs_err={results['text']!r} "
        f"image max_abs_err={results['image']!r} (tol {TOWER_TOL}); "
        f"{TOWER_LAYERS} attention launches per tower call")


def text_encode_ms(clip, n=20):
    """Phase 7c: host ms of one text query through the text tower on the
    card (tokenize, encode, copy back), p50 over n distinct strings; the
    string cache is bypassed."""
    from seesaw_tpu_torch.ops import attention as A

    clip.from_string(str_list=["warm-up query"])
    times = []
    before = A.pair_attention.launches
    for i in range(n):
        t0 = time.perf_counter()
        clip.from_string(str_list=[f"a photo of object number {i} in the street"])
        times.append((time.perf_counter() - t0) * 1e3)
    if A.pair_attention.launches - before != n * TOWER_LAYERS:
        raise AssertionError("a text query did not launch the attention kernel per layer")
    return float(np.median(times)), times


def vision_throughput(dev, gen, params, attn):
    """Phase 7d: `encode_image_batch` of VISION_BATCH random 224 x 224 images
    on the card, f32 and bf16: CUDA-event ms per forward over 3 forwards,
    images/s, the attention kernel's share of the forward (12 launches at
    phase 7a's ms), peak memory. Returns (records, launches)."""
    import torch

    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.ops import attention as A
    from seesaw_tpu_torch.utils.profiling import cuda_ms

    px = torch.randn(VISION_BATCH, 224, 224, 3, device=dev, generator=gen)
    records = []
    A.reset_launch_counts()  # count only this path's launches
    for dtype in ("float32", "bfloat16"):
        emb = ClipEmbedding("vit-b32", device=dev, params=params, dtype=getattr(torch, dtype))
        emb.encode_image_batch(px[:8])  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = A.pair_attention.launches_by_dtype[dtype]
        fwd_ms = cuda_ms(emb.encode_image_batch, [(px,)] * 3)
        out = emb.encode_image_batch(px)
        torch.cuda.synchronize()
        launched = A.pair_attention.launches_by_dtype[dtype] - before
        if launched != 5 * TOWER_LAYERS:  # warm-up + 3 timed + 1
            raise AssertionError(f"vision {dtype}: {launched} {dtype} attention launches "
                                 f"in 5 forwards")
        if out.shape != (VISION_BATCH, 512) or not bool(torch.isfinite(out).all()):
            raise AssertionError(f"vision {dtype}: shape {tuple(out.shape)} or non-finite values")
        k5 = next(r for r in attn if r["case"] == "vit-b32 vision" and r["dtype"] == dtype
                  and r["B"] == VISION_BATCH)
        rec = dict(dtype=dtype, forward_ms=fwd_ms, images_per_s=VISION_BATCH / fwd_ms * 1e3,
                   attention_share=TOWER_LAYERS * k5["ms"] / fwd_ms,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        log(f"vision vit-b32 B={VISION_BATCH} {dtype}: forward_ms={fwd_ms!r} "
            f"images_per_s={rec['images_per_s']!r} attention_share={rec['attention_share']!r} "
            f"peak device memory GB={rec['peak_gb']!r}")
        records.append(rec)
        del emb, out
        torch.cuda.empty_cache()
    return records, dict(A.pair_attention.launches_by_dtype)


# -- phase 8 -----------------------------------------------------------------
def attention_bwd_bound(B, L, W, causal, dtype):
    """q, k, v and g read once, dq, dk and dv written once (7 B L W
    elements); 5 x 2 x 64 operations per query-key pair that the mask keeps,
    per head (the logits, dp, dq, dk and dv; the softmax left out); f32 at
    the 3xTF32 rate."""
    pairs = L * (L + 1) // 2 if causal else L * L
    elem = 4 if dtype == "float32" else 2
    peak = PEAK_OPS_3XTF32 if dtype == "float32" else None
    return bound(7 * B * L * W * elem, 5 * 2 * 64 * B * (W // 64) * pairs, dtype, peak)


def check_attention_bwd(dev, gen):
    """Phase 8a: the backward kernel against its plain backward at each case
    of BWD_CASES, f32 and bf16; two runs bit-identical; CUDA-event times
    over 5 input sets (plain, kernel, kernel, plain) and of the SDPA
    backward on the head-split layout."""
    import torch
    import torch.nn.functional as F

    from seesaw_tpu_torch.ops import attention as A
    from seesaw_tpu_torch.utils.profiling import cuda_ms, device_ms

    records = []
    for name, B, L, W, causal in BWD_CASES:
        H = W // 64
        for dtype in ("float32", "bfloat16"):
            sets = [[torch.randn(B, L, W, device=dev, generator=gen).to(getattr(torch, dtype))
                     for _ in range(4)] for _ in range(5)]
            got = A.pair_attention_bwd(*sets[0], causal=causal, heads=H)
            again = A.pair_attention_bwd(*sets[0], causal=causal, heads=H)
            want = A.pair_attention_bwd_plain(*sets[0], causal=causal)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError(f"attention bwd {name} {dtype}: two runs differ")
            err, ulps, share = 0.0, 0.0, 0.0
            for a, b in zip(got, want):
                torch.testing.assert_close(a.float(), b.float(), **BWD_TOL[dtype])
                err = max(err, float((a.float() - b.float()).abs().max()))
                if dtype == "bfloat16":
                    u, sh = bf16_ulps(a, b)
                    ulps, share = max(ulps, u), max(share, sh)
            if share > BWD_MAX_SHARE:
                raise AssertionError(f"attention bwd {name} bf16: {share!r} of the "
                                     f"elements differ from the plain backward")

            def kern(q, k, v, g):
                return A.pair_attention_bwd(q, k, v, g, causal=causal)

            def plain(q, k, v, g):
                return A.pair_attention_bwd_plain(q, k, v, g, causal=causal)

            p1, k1, k2, p2 = (cuda_ms(f, sets) for f in (plain, kern, kern, plain))
            split = [[t.view(B, L, H, 64).transpose(1, 2).contiguous() for t in s]
                     for s in sets]
            for s in split:
                for t in s[:3]:
                    t.requires_grad_()
            outs = [F.scaled_dot_product_attention(*s[:3], is_causal=causal) for s in split]

            def library(i):
                return torch.autograd.grad(outs[i], split[i][:3], split[i][3],
                                           retain_graph=True)

            calls = [(i,) for i in range(len(split))]
            lib_ms = cuda_ms(library, calls)
            dev_ms, lib_dev_ms = device_ms(kern, sets), device_ms(library, calls)
            b_ms, b_by = attention_bwd_bound(B, L, W, causal, dtype)
            rec = dict(case=name, B=B, L=L, W=W, causal=causal, dtype=dtype,
                       ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, library_ms=lib_ms,
                       device_ms=dev_ms, library_device_ms=lib_dev_ms,
                       bound_ms=b_ms, bound_by=b_by, max_abs_err=err)
            line = (f"attention bwd {name} B={B} L={L} W={W} causal={causal} {dtype}: "
                    f"max_abs_err={err!r} kernel_ms={rec['ms']!r} kernel_device_ms={dev_ms!r} "
                    f"plain_ms={rec['plain_ms']!r} sdpa_bwd_ms={lib_ms!r} "
                    f"sdpa_bwd_device_ms={lib_dev_ms!r} bound_ms={b_ms!r} ({b_by}) "
                    f"bit-identical reruns")
            if dtype == "bfloat16":
                rec.update(max_ulps=ulps, share_differing=share)
                line += f" max_ulps={ulps!r} share_differing={share!r}"
            log(line)
            records.append(rec)
            del sets, split, outs, got, again, want
            torch.cuda.empty_cache()
    return records


def check_p_identity(dev, gen, heads=2):
    """Phase 8a: p bit-identical in the forward and backward kernels, f32
    and bf16. Image b takes query row b of one q and k (B = L <= 64); v_j =
    e_j in every head, so the forward's output row b is round(p_b) exactly
    (f32: big + small of p's 3xTF32 split, summed alike in both kernels); g
    is e_0 on row b of each head, so the backward's dv[b, j, 64h] is
    round(p_bj) exactly."""
    import torch

    from seesaw_tpu_torch.ops import attention as A

    W = 64 * heads
    for dtype, L, causal in ((t, L, c) for t in (torch.float32, torch.bfloat16)
                             for L, c in ((50, False), (13, True))):
        B = L
        q, k = (torch.randn(1, L, W, device=dev, generator=gen).to(dtype)
                .expand(B, L, W).contiguous() for _ in range(2))
        eye = torch.eye(L, 64, device=dev, dtype=dtype)  # row j = e_j
        v = eye.repeat(1, heads).expand(B, L, W).contiguous()
        g = torch.zeros(B, L, W, device=dev, dtype=dtype)
        rows = torch.arange(B, device=dev)
        g[rows, rows, 0::64] = 1
        out = A.pair_attention(q, k, v, causal=causal, heads=heads)
        dv = A.pair_attention_bwd(q, k, v, g, causal=causal, heads=heads)[2]
        fwd_p = out[rows, rows].view(B, heads, 64)[:, :, :L]  # [i, h, j]
        bwd_p = dv[:, :, 0::64].permute(0, 2, 1)  # dv[i, j, 64 h] -> [i, h, j]
        torch.cuda.synchronize()
        if not torch.equal(fwd_p, bwd_p):
            n = int((fwd_p != bwd_p).sum())
            raise AssertionError(f"p {dtype} at L={L} causal={causal}: {n} of "
                                 f"{fwd_p.numel()} values differ between the forward and "
                                 f"the backward")
        sums = fwd_p.float().sum(-1)
        if not bool(((sums - 1).abs() < 0.05).all()):
            raise AssertionError(f"p {dtype} at L={L} causal={causal}: rows sum to {sums}")
        log(f"p identity {str(dtype).removeprefix('torch.')} L={L} causal={causal}: forward "
            f"round(p) == backward round(p), {fwd_p.numel()} values bit for bit")


def check_tower_gradients(dev, params):
    """Phase 8b: one contrastive step of ViT-B/32 at B=8, every parameter
    trainable, f32: each gradient on the card against the CPU's within
    GRAD_TOL; 24 K6 launches on the card."""
    import torch

    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.models.clip_finetune import clip_contrastive_loss
    from seesaw_tpu_torch.ops import attention as A
    from seesaw_tpu_torch.utils import rounds as R

    emb = ClipEmbedding("vit-b32", device="cpu", params=params)
    px, tok = R.finetune_batch(emb.cfg, 8, device="cpu",
                               generator=torch.Generator().manual_seed(1))
    grads, losses = {}, {}
    for device in (dev, torch.device("cpu")):
        model = emb.trainable_copy(device)
        before = A.pair_attention_bwd.launches
        loss = clip_contrastive_loss(model.encode_image(px.to(device)),
                                     model.encode_text(tok.to(device)), model.logit_scale)
        loss.backward()
        if device.type == "cuda":
            torch.cuda.synchronize()
            if A.pair_attention_bwd.launches - before != 2 * TOWER_LAYERS:
                raise AssertionError(f"ViT-B/32 step: {A.pair_attention_bwd.launches - before}"
                                     f" K6 launches, not {2 * TOWER_LAYERS}")
        grads[device.type] = {n: p.grad.cpu() for n, p in model.named_parameters()}
        losses[device.type] = float(loss.detach())
        del model
    cpu, gpu = grads["cpu"], grads["cuda"]
    top = max(float(g.abs().max()) for g in cpu.values())
    worst, at = 0.0, None
    for n, g in cpu.items():
        if not bool(torch.isfinite(gpu[n]).all()):
            raise AssertionError(f"ViT-B/32 gradient {n}: non-finite on the card")
        rel = float((gpu[n] - g).abs().max()) / max(float(g.abs().max()), 1e-3 * top)
        if rel > worst:
            worst, at = rel, n
    if worst > GRAD_TOL:
        raise AssertionError(f"ViT-B/32 gradient {at}: relative difference {worst!r}")
    log(f"gradients vit-b32 B=8 f32, cuda vs cpu: {len(cpu)} tensors, worst relative "
        f"difference {worst!r} ({at}; tol {GRAD_TOL}); loss cuda {losses['cuda']!r} cpu "
        f"{losses['cpu']!r}; {2 * TOWER_LAYERS} K6 launches")
    torch.cuda.empty_cache()
    return worst


def finetune_path(dev, gen, params, attn, bwd, card):
    """Phase 8c: CLIPFineTuner steps on ViT-B/32 at FT_BATCH, f32 and bf16,
    then one step of the default projection-only config. Returns (records,
    K5 launches, K6 launches) of this path, by input type."""
    import torch

    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.ops import attention as A
    from seesaw_tpu_torch.utils import rounds as R

    records = []
    A.reset_launch_counts()  # this path's launches
    for dtype in ("float32", "bfloat16"):
        emb = ClipEmbedding("vit-b32", device=dev, params=params, dtype=getattr(torch, dtype))
        before = [dict(f.launches_by_dtype) for f in (A.pair_attention, A.pair_attention_bwd)]
        out = R.drive_finetune(emb, FT_CONFIG, device=dev, batch=FT_BATCH, steps=FT_STEPS,
                               warmup_steps=FT_WARMUP, generator=gen)
        losses = out["losses"]
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError(f"fine-tune {dtype}: losses {losses}")
        want = [2 * TOWER_LAYERS] * (FT_WARMUP + FT_STEPS)
        if out["fwd_launches"] != want or out["bwd_launches"] != want:
            raise AssertionError(f"fine-tune {dtype}: K5 launches {out['fwd_launches']}, "
                                 f"K6 {out['bwd_launches']} a step")
        # every launch of the step took the step's type's kernels
        for f, b in zip((A.pair_attention, A.pair_attention_bwd), before):
            got = {t: f.launches_by_dtype[t] - b[t] for t in b}
            if got[dtype] != sum(want) or sum(got.values()) != sum(want):
                raise AssertionError(f"fine-tune {dtype}: launches by type {got}")
        ms = float(np.mean(out["step_ms"]))
        k6 = {r["case"]: r["ms"] for r in bwd if r["dtype"] == dtype and r["B"] == FT_BATCH}
        # K5 at the step's shapes (phase 7a has them in f32 and bf16)
        k5 = {r["case"]: r["ms"] for r in attn if r["dtype"] == dtype and r["B"] == FT_BATCH}
        rec = dict(dtype=dtype, step_ms=ms, p50_step_ms=float(np.median(out["step_ms"])),
                   min_step_ms=float(min(out["step_ms"])), max_step_ms=float(max(out["step_ms"])),
                   pairs_per_s=FT_BATCH / ms * 1e3,
                   k6_share=TOWER_LAYERS * (k6["vit-b32 vision"] + k6["text"]) / ms,
                   k5_share=(TOWER_LAYERS * (k5["vit-b32 vision"] + k5["text"]) / ms
                             if {"vit-b32 vision", "text"} <= k5.keys() else None),
                   peak_gb=out["peak_gb"], losses=losses)
        log(f"[{card}] fine-tune vit-b32 B={FT_BATCH} {dtype}: step_ms={ms!r} "
            f"p50_step_ms={rec['p50_step_ms']!r} pairs_per_s={rec['pairs_per_s']!r} "
            f"k6_share={rec['k6_share']!r} k5_share={rec['k5_share']!r} "
            f"peak device memory GB={rec['peak_gb']!r} "
            f"losses={losses} step_ms_all={out['step_ms']}")
        records.append(rec)
        del emb, out
        torch.cuda.empty_cache()
    emb = ClipEmbedding("vit-b32", device=dev, params=params)
    out = R.drive_finetune(emb, {}, device=dev, batch=FT_BATCH, steps=1, generator=gen)
    if out["bwd_launches"] != [0] or not np.isfinite(out["losses"]).all():
        raise AssertionError(f"projection-only step: {out['bwd_launches']} K6 launches, "
                             f"loss {out['losses']}")
    log(f"[{card}] fine-tune vit-b32 B={FT_BATCH} f32, default text/projection config: "
        f"step_ms={out['step_ms'][0]!r}, K6 launches 0")
    del emb, out
    torch.cuda.empty_cache()
    return (records, dict(A.pair_attention.launches_by_dtype),
            dict(A.pair_attention_bwd.launches_by_dtype))


def check_textual_cuda_vs_cpu():
    """Phase 8d: `textual` sessions in both modes on a root like phase 4's,
    on the card and on the CPU: same dbidxs every round, scores and model
    losses within 1e-5."""
    import torch

    from seesaw_tpu_torch import IndexSpec, SessionParams, make_session
    from seesaw_tpu_torch.utils import rounds as R

    root = ROOT / "build" / "seesaw_tpu_torch" / "textual_root"
    artifact = root.with_name(root.name + "_clip")
    for d in (root, artifact):
        shutil.rmtree(d, ignore_errors=True)
    gdm, gt, _ = write_synthetic_root(root)
    for mode, opts in TEXTUAL_OPTIONS.items():
        p = SessionParams(index_spec=IndexSpec(d_name="smoke", i_name="multiscale"),
                          interactive="textual", batch_size=BATCH, shortlist_size=20,
                          interactive_options=opts)
        runs, models = {}, {}
        for device in ("cuda", "cpu"):
            s = make_session(gdm, p, device=torch.device(device))["session"]
            runs[device] = R.drive_textual_session(s, gt, 6, text="a dog")
            models[device] = s.loop.model
        if models["cuda"].device.type != "cuda" or not models["cuda"].losses:
            raise AssertionError(f"textual {mode}: the CUDA session's model did not train "
                                 f"on the card")
        for r, ((gd, gs), (cd, cs)) in enumerate(zip(runs["cuda"], runs["cpu"])):
            if gd != cd:
                raise AssertionError(f"textual {mode} round {r}: cuda {gd} != cpu {cd}")
            np.testing.assert_allclose(gs, cs, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(models["cuda"].losses, models["cpu"].losses,
                                   rtol=1e-5, atol=1e-5)
        loss_err = float(np.abs(np.subtract(models["cuda"].losses, models["cpu"].losses)).max())
        log(f"textual {mode} session: cuda == cpu dbidxs over {len(runs['cuda'])} rounds; "
            f"model losses max diff {loss_err!r} over {len(models['cuda'].losses)} steps")
    for d in (root, artifact):
        shutil.rmtree(d, ignore_errors=True)


# -- phase 9 -----------------------------------------------------------------
_GRAPH5 = dict(knn_path="", knn_k=5, edist=0.5)
_MULTI_REG = dict(matrix_options=dict(_GRAPH5, knn_k=8), rank_loss_margin=0.0,
                  pos_weight="balanced", reg_data_lambda=0.1, reg_norm_lambda=10.0,
                  reg_query_lambda=1.0, max_iter=100)
MULTIREG_LOSSES = ("ce_loss", "pairwise_rank_loss", "pairwise_logistic_loss")
# (name, method, options, batch, confusion): seesaw_tpu/configs.py's defaults
# over the small root's graph (edist and the ranker's calibration as phase
# 4's knn_prop2, which suit the root's scores)
FEEDBACK_SESSIONS = tuple(
    (f"multi_reg {loss}", "multi_reg", dict(_MULTI_REG, label_loss_type=loss), BATCH, False)
    for loss in MULTIREG_LOSSES
) + (
    ("multi_reg_neg", "multi_reg_neg", dict(reg_norm_lambda=10.0, reg_query_lambda=1.0,
                                            max_iter=100, discount_neg=True), BATCH, True),
    ("pseudo_lr", "pseudo_lr", dict(
        label_prop_params=SESSION_OPTIONS["knn_prop2"],
        log_reg_params=dict(reg_lambda=10.0, max_iter=100), switch_over=True,
        real_sample_weight=5.0, sample_size=100), BATCH, False),
    ("active_search", "active_search", dict(
        matrix_options=_GRAPH5, gamma=dict(mode="fixed", value=0.1), reward_horizon=10,
        adjust_horizon=False, max_steps=100, pruning_on=False,
        implementation="vectorized"), 1, False),
    ("lknn", "lknn", dict(matrix_options=_GRAPH5, gamma=0.1, use_clip_as_gamma=False), 1, False),
)
# a fitted loop's coefficient comes from an LBFGS solve that may take its
# last steps differently on the card, on the f32 floor or at a hinge kink
# (`utils/solves.py`), moving a unit coefficient and so a score by up to
# ~1e-3 (tests/test_torch_session.py's bar against the JAX package)
FIT_SCORE_TOL = dict(rtol=0, atol=2e-3)
FIT_TOL = dict(rtol=2e-4, atol=2e-5)  # the LogReg2 bar, for fitted coefficients
XLX_CHECK_ROWS = 200_000
FIT_ROWS = 512  # bench.py bench_refine: 512 labeled rows x 512, max_iter 50
ENS_N, ENS_D, ENS_K, ENS_BLOCK = 1_000_000, 32, 10, 4096  # bench.py bench_ens


def check_feedback_sessions_cuda_vs_cpu():
    """Phase 9a: the feedback loops of this slice on a root like phase 4's,
    on the card and on the CPU: same dbidxs every round, scores within
    FIT_SCORE_TOL (fitted loops) or 1e-5; the scan kernel launched in every
    multi_reg round, the Jacobi kernel in every pseudo_lr refine. Returns
    this phase's launches of both kernels."""
    import torch

    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops import spmv

    root = ROOT / "build" / "seesaw_tpu_torch" / "feedback_root"
    artifact = root.with_name(root.name + "_clip")
    for d in (root, artifact):
        shutil.rmtree(d, ignore_errors=True)
    gdm, gt, _ = write_synthetic_root(root)
    fs.fused_frame_max.launches = spmv.jacobi_step.launches = 0
    for name, method, opts, batch, confusion in FEEDBACK_SESSIONS:
        runs = {}
        for device in ("cuda", "cpu"):
            np.random.seed(0)  # pseudo_lr draws its sample from numpy's global state
            runs[device] = small_session_rounds(
                gdm, gt, method, torch.device(device), rounds=6 if batch > 1 else 12,
                options=opts, batch=batch, confusion=confusion)
        torch.cuda.synchronize()
        g, c = runs["cuda"], runs["cpu"]
        if g.dbidxs != c.dbidxs:
            raise AssertionError(f"{name}: cuda {g.dbidxs} != cpu {c.dbidxs}")
        fitted = method in ("multi_reg", "multi_reg_neg", "pseudo_lr")
        np.testing.assert_allclose(g.scores, c.scores,
                                   **(FIT_SCORE_TOL if fitted else dict(rtol=1e-5, atol=1e-5)))
        if method == "multi_reg" and min(g.scan) < 1:
            raise AssertionError(f"{name}: scan launches per round {g.scan}")
        if method == "pseudo_lr" and min(g.refine_jacobi) < 1:
            raise AssertionError(f"{name}: Jacobi launches per refine {g.refine_jacobi}")
        err = float(np.abs(g.scores - c.scores).max(initial=0.0))
        log(f"session {name}: cuda == cpu dbidxs over {len(g.dbidxs)} rounds; max activation "
            f"score diff {err!r}; scan launches per round {g.scan}; Jacobi launches per "
            f"round in next {g.next_jacobi} and in refine {g.refine_jacobi}")
    launches = {"fused_frame_max": fs.fused_frame_max.launches,
                "jacobi_step": spmv.jacobi_step.launches}
    for d in (root, artifact):
        shutil.rmtree(d, ignore_errors=True)
    return launches


def solve_trace(model, X, y, sw):
    """`utils.solves.first_departure`'s view of a RegFit's solve on X's
    device: (solve after k iterations, objective at a point)."""
    import torch

    fun = model.objective(X, y, sw)

    def solve(k):
        m = copy.copy(model)
        m.max_iter = k
        res = m.solve(X, y, sw)[1]
        return res.x.cpu().numpy(), float(res.f), res.n_iter

    def value(x):
        return float(fun(torch.from_numpy(x).to(X.device)))

    return solve, value


def check_fit_cuda_vs_cpu(name, model, X, y, sw, coeff_gpu):
    """The RegFit's coefficient on the card against the CPU port's fit of
    the same rows at FIT_TOL; where they part, both solves are traced step
    by step (`utils/solves.py`) and must depart only on the f32 floor, at a
    kink or at a stalled search. Returns (max abs diff, departure)."""
    from seesaw_tpu_torch.utils.solves import at_kink, first_departure

    cpu_args = [t.cpu() for t in (X, y, sw)]
    coeff_cpu, _ = model.solve(*cpu_args)
    coeff_cpu = coeff_cpu.numpy()
    err = float(np.abs(coeff_gpu - coeff_cpu).max())
    if np.allclose(coeff_gpu, coeff_cpu, **FIT_TOL):
        return err, None
    Xc = (cpu_args[0] - cpu_args[0].mean(dim=0)).numpy()
    yn = cpu_args[1].numpy()
    solve_a, value_a = solve_trace(model, *cpu_args)
    solve_b, value_b = solve_trace(model, X, y, sw)
    kind, step = first_departure(
        solve_a, solve_b, value_a, value_b, x0=model.qvec_hat, max_iter=model.max_iter,
        scale=model.reg_norm_lambda + model.reg_query_lambda,
        kink=(lambda x: at_kink(Xc @ x, yn))
        if model.label_loss_type == "pairwise_rank_loss" else None,
        **FIT_TOL)
    if kind is None:
        raise AssertionError(f"{name}: the traced solves agree, the fits do not ({err!r})")
    return err, f"{kind} at step {step}"


def check_device_xlx(dev, gen):
    """Phase 9b: the XLX matrix summed in row chunks on the card against the
    numpy XLX of the same rows, over a 200k-row window-local graph of a
    bf16 matrix. Tolerance rtol 1e-5 / atol 1e-5 x max|XLX| (f32 sums of 6.4M
    products in another order)."""
    import torch

    from seesaw_tpu_torch.knn_graph import SymmetricWeights
    from seesaw_tpu_torch.utils import rounds as R

    g = R.window_local_graph(XLX_CHECK_ROWS, R.MULTIREG_GRAPH_K, dev, gen)
    V = torch.randn(XLX_CHECK_ROWS, DIM, device=dev, generator=gen, dtype=torch.bfloat16)
    got = g.xlx(lambda r: V[r].float(), device=dev).cpu().numpy()
    t0 = time.perf_counter()
    want = SymmetricWeights(*(t.cpu().numpy() for t in (g.nbr, g.w, g.degree))).xlx(
        V.float().cpu().numpy())
    host_s = time.perf_counter() - t0
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    err = float(np.abs(got - want).max())
    log(f"xlx {XLX_CHECK_ROWS}x{R.MULTIREG_GRAPH_K} graph, bf16 rows: device chunks == numpy, "
        f"max_abs_err={err!r} (max|XLX|={scale!r}); numpy took {host_s!r} s")
    del g, V
    torch.cuda.empty_cache()
    return err


def first_multireg_fit(idx, params):
    """A session's first feedback round at full size: the text query, one
    batch labeled (its first image accepted), refine, then the query that
    runs the deferred fit. Returns (the DeferredMultiReg, the fitted
    coefficient, the labeled rows' f32 vectors on the card)."""
    import torch

    from seesaw_tpu_torch import Box
    from seesaw_tpu_torch.session import Session

    dataset = SimpleNamespace(get_urls=lambda b: [f"b://{int(i)}" for i in b])
    s = Session(None, dataset, idx, params)
    s.set_text("a photo for the multi_reg fit check")
    s.next()
    state = s.get_state()
    for j, im in enumerate(state.gdata[-1]):
        im.boxes = ([Box(x1=0.0, y1=0.0, x2=112.0, y2=112.0, marked_accepted=True)]
                    if j == 0 else [])
    s.update_state(state)
    s.refine()
    dv = s.loop.curr_vec
    s.next()
    X = idx._device_rows_f32(torch.from_numpy(dv.prows).to(idx.device))
    return dv, np.asarray(s.loop.curr_vec, np.float32), X


def multireg_path(dev, gen, card, clip, rounds=10):
    """Phase 9b: multi_reg sessions on a 10M x 512 bf16 index built as in
    phase 5, regularized by a 10M x 32 window-local graph whose XLX the
    card sums in row chunks from the index's rows. Returns a record with
    the scan kernel's launches in the sessions."""
    import torch

    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.utils import rounds as R

    xlx_err = check_device_xlx(dev, gen)
    idx = R.device_index(N_VECTORS, DIM, "bfloat16", device=dev, generator=gen, embedding=clip,
                         path=str(ROOT / "build" / "seesaw_tpu_torch" / "multireg_index"))
    weights = R.window_local_graph(N_VECTORS, R.MULTIREG_GRAPH_K, dev, gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    opts = R.LOOP_OPTIONS["multi_reg"]["matrix_options"]
    xlx, xlx_s = R.multireg_xlx(idx, weights, opts)
    if not bool(torch.isfinite(xlx).all()):
        raise AssertionError("the 10M XLX matrix is not finite")
    log(f"[{card}] xlx {N_VECTORS}x{R.MULTIREG_GRAPH_K} graph, bf16 index rows on the card: "
        f"{xlx_s!r} s")
    dv, coeff, X = first_multireg_fit(
        idx, R.session_params("multi_reg", batch_size=BATCH, shortlist_size=SHORTLIST))
    fit_err, departure = check_fit_cuda_vs_cpu(
        "multi_reg 10M first fit", dv.model, X, torch.from_numpy(dv.y).to(dev),
        torch.from_numpy(dv.sw).to(dev), coeff)
    log(f"multi_reg 10M first feedback fit ({X.shape[0]} rows): cuda vs cpu coefficient "
        f"max_abs_err={fit_err!r}" + (f", solves part {departure}" if departure else ""))
    rng = np.random.default_rng(0)
    fs.fused_frame_max.launches = 0  # count only this path's launches
    out = {}
    for loss in ("ce_loss", "pairwise_rank_loss"):
        params = R.session_params("multi_reg", batch_size=BATCH, shortlist_size=SHORTLIST,
                                  label_loss_type=loss)
        before = fs.fused_frame_max.launches
        next_ms, round_ms, syncs = R.drive_session(
            idx, params, rounds, rng, text=f"a photo for the multi_reg {loss} session")
        torch.cuda.synchronize()
        if fs.fused_frame_max.launches - before < rounds:
            raise AssertionError(f"multi_reg {loss}: {fs.fused_frame_max.launches - before} "
                                 f"scan launches in {rounds} rounds")
        p50n, p50r = float(np.median(next_ms[1:])), float(np.median(round_ms[1:]))
        out[loss] = dict(p50_next_ms=p50n, p50_round_ms=p50r, syncs=syncs)
        log(f"[{card}] multi_reg {loss} bf16: rounds={rounds} p50_session_next_ms={p50n!r} "
            f"p50_round_ms={p50r!r} round0_ms={round_ms[0]!r} "
            f"lbfgs_host_syncs_per_fit={syncs}")
    launches = fs.fused_frame_max.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{card}] multi_reg path: scan kernel launches={launches} in {2 * rounds} rounds, "
        f"peak device memory GB={peak!r}")
    del idx, weights, xlx, X
    torch.cuda.empty_cache()
    return dict(launches=launches, xlx_s=xlx_s, xlx_err=xlx_err, fit_err=fit_err,
                departure=departure, peak_gb=peak, **out)


def multireg_fit_bench(dev, card, reps=5):
    """Phase 9c: one multi-reg fit at the JAX package's refine shape
    (bench.py bench_refine): 512 unit rows x 512, pairwise_rank_loss, XLX =
    1e-3 I, max_iter 50; host ms a fit (ending in a synchronize) and host
    syncs; the coefficient against the CPU port's fit."""
    import torch

    from seesaw_tpu_torch.learners.multi_reg import RegFit
    from seesaw_tpu_torch.utils import rounds as R

    rng = np.random.default_rng(0)
    X = rng.normal(size=(FIT_ROWS, DIM)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    y = rng.integers(0, 2, size=FIT_ROWS).astype(np.float32)
    q = rng.normal(size=DIM).astype(np.float32)
    model = RegFit(device=dev, xlx=(np.eye(DIM) * 1e-3).astype(np.float32), qvec=q,
                   label_loss_type="pairwise_rank_loss", rank_loss_margin=0.0,
                   pos_weight="balanced", reg_data_lambda=0.1, reg_norm_lambda=10.0,
                   reg_query_lambda=1.0, max_iter=50)
    args = [torch.from_numpy(a).to(dev) for a in (X, y, np.ones(FIT_ROWS, np.float32))]
    model.solve(*args)  # warm-up
    times = []
    for _ in range(reps):
        R.sync(dev)
        t0 = time.perf_counter()
        coeff, res = model.solve(*args)
        R.sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    err, departure = check_fit_cuda_vs_cpu("multi-reg fit 512x512", model, *args,
                                           coeff.cpu().numpy())
    ms = float(np.median(times))
    log(f"[{card}] multi-reg fit {FIT_ROWS}x{DIM} pairwise_rank_loss: p50_ms={ms!r} "
        f"ms={times} iterations={res.n_iter} host_syncs={res.host_syncs} cuda vs cpu "
        f"max_abs_err={err!r}" + (f", solves part {departure}" if departure else ""))
    return dict(ms=ms, times=times, n_iter=res.n_iter, host_syncs=res.host_syncs, err=err,
                departure=departure)


def ens_bench(dev, gen, card):
    """Phase 9d: `ens_expected_value` at the JAX package's shape (bench.py
    bench_ens: 1M x 32, K=10, block 4096), CUDA-event ms over 4 score sets,
    against the CPU port on the same inputs: values within rtol 1e-6 / atol
    1e-6, the same pick."""
    import torch

    from seesaw_tpu_torch.ops.ens import ens_expected_value
    from seesaw_tpu_torch.utils.profiling import cuda_ms

    nbr = torch.randint(0, ENS_N, (ENS_N, ENS_D), dtype=torch.int32, device=dev, generator=gen)
    num = torch.rand(ENS_N, device=dev, generator=gen) * 0.9 + 0.05
    den1 = 1.0 + torch.rand(ENS_N, device=dev, generator=gen) * 3.0
    sets = [(torch.rand(ENS_N, device=dev, generator=gen) * 0.98 + 0.01, num, den1, nbr)
            for _ in range(4)]

    def ens(*a):
        return ens_expected_value(*a, K=ENS_K, block_size=ENS_BLOCK)

    got = ens(*sets[0])
    ms = cuda_ms(ens, sets)
    want = ens(*(t.cpu() for t in sets[0]))
    got = got.cpu()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    if int(got.argmax()) != int(want.argmax()):
        raise AssertionError(f"ens: cuda picks {int(got.argmax())}, cpu {int(want.argmax())}")
    err = float((got - want).abs().max())
    log(f"[{card}] ens_expected_value N={ENS_N} D={ENS_D} K={ENS_K} block={ENS_BLOCK}: "
        f"ms={ms!r} cuda vs cpu max_abs_err={err!r} bit-identical={bool(torch.equal(got, want))}")
    del sets, nbr, num, den1
    torch.cuda.empty_cache()
    return dict(ms=ms, err=err)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import seesaw_tpu_torch  # noqa: F401
        from seesaw_tpu_torch import _build
        from seesaw_tpu_torch.utils.profiling import card_line
    except ImportError as e:
        print(f"chip_smoke: the package is not beside this script: {e}", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    # one nvcc each, together
    _build.load_libraries("fused_frame_max", "knn_spmv", "pair_attention",
                          "pair_attention_bf16")
    log(f"build fused_frame_max, knn_spmv, pair_attention, pair_attention_bf16: "
        f"{time.perf_counter() - t0!r} s (nvcc seconds {_build.build_seconds})")

    gen = torch.Generator(device=dev).manual_seed(0)
    scan, worst = check_scan(dev, gen)
    torch.cuda.synchronize()
    knn = check_spmv(dev, gen)
    torch.cuda.synchronize()
    check_sessions_cuda_vs_cpu()
    torch.cuda.synchronize()
    from seesaw_tpu_torch.models.clip import VARIANTS, ClipEmbedding, init_params

    # the ViT-B/32 weights of phases 5 and 7, seeded random
    clip_params = init_params(VARIANTS["vit-b32"], torch.Generator().manual_seed(0))
    clip = ClipEmbedding("vit-b32", device=dev, params=clip_params)
    launches, attn_launches, idx = main_path(dev, gen, card, clip)
    torch.cuda.synchronize()
    knn_launches = knnprop_path(idx, dev, gen, card)
    torch.cuda.synchronize()
    del idx
    torch.cuda.empty_cache()
    # phase 9, before the towers' phases, whose peak memory it would move
    feedback_launches = check_feedback_sessions_cuda_vs_cpu()
    multireg = multireg_path(dev, gen, card, clip)
    fit = multireg_fit_bench(dev, card)
    ens = ens_bench(dev, gen, card)
    torch.cuda.synchronize()
    attn = check_attention(dev, gen)
    check_towers(dev, clip_params)
    text_p50, text_times = text_encode_ms(clip)
    log(f"[{card}] text encode vit-b32 f32 (B=1, L=77): p50_ms={text_p50!r} "
        f"ms={text_times}")
    vision, vision_launches = vision_throughput(dev, gen, clip_params, attn)
    torch.cuda.synchronize()
    bwd = check_attention_bwd(dev, gen)
    check_p_identity(dev, gen)
    grad_err = check_tower_gradients(dev, clip_params)
    finetune, ft_fwd_launches, ft_bwd_launches = finetune_path(dev, gen, clip_params, attn, bwd,
                                                               card)
    check_textual_cuda_vs_cpu()
    torch.cuda.synchronize()
    bad = [m for m in sys.modules
           if m in ("jax", "flax", "optax") or m == "seesaw_tpu" or m.startswith("seesaw_tpu.")]
    if bad:
        raise AssertionError(f"the port imported {bad}")

    bf16 = next(r for r in scan if r["dtype"] == "bfloat16")
    text_query = next(r for r in attn if r["case"] == "text query")
    vit_bwd = next(r for r in bwd if r["case"] == "vit-b32 vision" and r["dtype"] == "float32")
    # the bf16 kernels at fine-tuning's ViT-B/32 vision layer (B=256, L=50, W=768)
    vit_fwd16 = next(r for r in attn if r["case"] == "vit-b32 vision" and r["B"] == FT_BATCH
                     and r["dtype"] == "bfloat16")
    vit_bwd16 = next(r for r in bwd if r["case"] == "vit-b32 vision" and r["dtype"] == "bfloat16")
    timing = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "device_ms",
              "library_device_ms")
    f32_fwd, bf16_fwd = ([r for r in attn if r["dtype"] == t] for t in ("float32", "bfloat16"))
    f32_bwd, bf16_bwd = ([r for r in bwd if r["dtype"] == t] for t in ("float32", "bfloat16"))
    log(json.dumps({"kernels": [{
        "name": "fused_frame_max", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/fused_frame_max.cu",
        "replaces": "seesaw_tpu/ops/pallas_scoring.py:43",
        "launches": launches,
        # phase 5 (the main path); 9a's multi_reg sessions; 9b's 10M multi_reg rounds
        "launches_by_path": {"main_path": launches,
                             "feedback_sessions": feedback_launches["fused_frame_max"],
                             "multi_reg_10M": multireg["launches"]},
        "max_abs_err": worst,
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
    }, {
        "name": "knn_spmv", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/knn_spmv.cu",
        "replaces": "seesaw_tpu/ops/pallas_spmv.py:606,204,210",
        # both entry points of the source; the graph round runs jacobi_step
        "launches": sum(knn_launches.values()), "launches_by_entry": knn_launches,
        # phase 9a's sessions (pseudo_lr's refines propagate)
        "launches_by_path": {"knn_prop2_10M": sum(knn_launches.values()),
                             "feedback_sessions": feedback_launches["jacobi_step"]},
        "max_abs_err": knn["max_abs_err"],
        "ms": knn["ms"], "plain_ms": knn["plain_ms"],
        "bound_ms": knn["bound_ms"], "bound_by": knn["bound_by"],
        "library_ms": knn["library_ms"],
        "jacobi_step_ms": knn["jacobi_ms"], "jacobi_step_plain_ms": knn["jacobi_plain_ms"],
        "jacobi_step_bound_ms": knn["jacobi_bound_ms"],
        "jacobi_step_uniform_ms": knn["uniform"]["jacobi_ms"],
        "jacobi_step_uniform_plain_ms": knn["uniform"]["jacobi_plain_ms"],
        "knn_spmv_uniform_ms": knn["uniform"]["ms"],
        # a SEGMENT_STEPS-step segment converging at its SEGMENT_WORK-th step
        "jacobi_segment_steps": knn["segment"]["steps"],
        "jacobi_segment_launches": knn["segment"]["launches"],
        "jacobi_segment_device_ms": knn["segment"]["device_ms"],
        "jacobi_segment_host_ms": knn["segment"]["host_ms"],
        "jacobi_segment_uniform_device_ms": knn["uniform"]["segment"]["device_ms"],
        "jacobi_segment_uniform_host_ms": knn["uniform"]["segment"]["host_ms"],
    }, {
        "name": "pair_attention", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/pair_attention.cu",
        "replaces": "seesaw_tpu/ops/pallas_attention.py:91",
        # f32 on the tensor cores by the 3xTF32 split; bf16 is pair_attention_bf16 below
        # phase 5's text queries (12 per session); the f32 forwards of 7d and 8c
        "launches": attn_launches,
        "launches_by_path": {"text_query_sessions": attn_launches,
                             "vision_encode": vision_launches["float32"],
                             "finetune": ft_fwd_launches["float32"]},
        "max_abs_err": max(r["max_abs_err"] for r in f32_fwd),
        # at the main path's shape (the text query: B=1, L=77, W=512, causal)
        **{k: text_query[k] for k in timing},
        "text_encode_p50_ms": text_p50,
        "cases": f32_fwd, "vision_vit_b32": vision,
    }, {
        "name": "pair_attention_bf16", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/pair_attention_bf16.cu",
        "replaces": "seesaw_tpu/ops/pallas_attention.py:91",
        # bf16 on the tensor cores: phase 8c's bf16 steps (24 a step) and the
        # bf16 vision forwards of 7d
        "launches": ft_fwd_launches["bfloat16"],
        "launches_by_path": {"vision_encode": vision_launches["bfloat16"],
                             "finetune": ft_fwd_launches["bfloat16"]},
        "max_abs_err": max(r["max_abs_err"] for r in bf16_fwd),
        "max_ulps": max(r["max_ulps"] for r in bf16_fwd),
        "share_differing": max(r["share_differing"] for r in bf16_fwd),
        **{k: vit_fwd16[k] for k in timing},
        "cases": bf16_fwd,
    }, {
        "name": "pair_attention_bwd", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/pair_attention.cu",
        "replaces": "seesaw_tpu/ops/pallas_attention.py:115",
        # f32 by the 3xTF32 split: phase 8c's f32 steps, 24 a step (12 vision,
        # 12 text layers)
        "launches": ft_bwd_launches["float32"],
        "max_abs_err": max(r["max_abs_err"] for r in f32_bwd),
        # at the main path's shape (fine-tuning's ViT-B/32 vision layer, f32)
        **{k: vit_bwd[k] for k in timing},
        "cases": f32_bwd, "finetune_vit_b32": finetune,
        "tower_gradient_rel_err": grad_err,
    }, {
        "name": "pair_attention_bwd_bf16", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/pair_attention_bf16.cu",
        "replaces": "seesaw_tpu/ops/pallas_attention.py:115",
        # bf16 on the tensor cores: phase 8c's bf16 steps, 24 a step
        "launches": ft_bwd_launches["bfloat16"],
        "max_abs_err": max(r["max_abs_err"] for r in bf16_bwd),
        "max_ulps": max(r["max_ulps"] for r in bf16_bwd),
        "share_differing": max(r["share_differing"] for r in bf16_bwd),
        **{k: vit_bwd16[k] for k in timing},
        "cases": bf16_bwd,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
