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
10. the offline build (`seesaw_tpu_torch.ingest`, `ops.knn`), run last, on
    480 synthetic 1280 x 720 JPEGs (BDD100K's frame size: 20 tiles a frame):
   a. the device tiler on the card against the CPU for 8 frames (atol
      2e-4), their ViT-B/32 f32 vectors (phase 7b's bar, 12 K5 launches);
      `exact_knn` at 20,000 x 512 clustered rows with planted duplicate rows,
      card against CPU: distances within KNN_TOL, ids equal outside
      near-ties, duplicates lowest id first;
   b. each stage alone (decode pool, upload + device tiling, B=256 encode
      in f32 and bf16), then `run_multiscale_extraction` and
      `create_multiscale_index` (clip-vit-b32 at full width and depth,
      seeded weights, B=256, device tiling, the exact K=32 graph) in bf16
      and f32: images/s, tiles/s, 12 K5 launches a batch; the saved index
      loaded back through the loader on the card, 4 `plain` rounds (K1 each
      round) and 4 `knn_prop2` rounds over the built graph (`jacobi_step` in
      each propagating round); a coarse index derived, loaded and queried;
   c. `exact_knn` over 1M x 512 clustered unit vectors made on the card
      (bench.py:1422-1428 at d = 512), K=32, TF32 off: seconds, peak
      memory, 512 rows against an f64 brute force on the card.

11. concurrent serving (`seesaw_tpu_torch.web`, the batch programs of
    `ops.frame_scoring`); run right after phase 6, over its index first:
   a. the batch of 16 queries (`bench.py:446-523`: 10M x 512, shortlist
      50, top-k 10) in int8 with row scales, int8 with frame scales and
      bf16, each query with its own mask: ids equal and scores within rtol
      1e-5 of 16 solo K1 queries and of the plain batch; CUDA-event ms of a
      dispatch in chains of 8 (each session excludes its own top hit),
      device ms and top kernels under torch.profiler, queries/s beside the
      16 solo queries, the bound by bytes (matrix, scales, (N, 16) scores),
      peak memory;
   b. 16 threads of simulated users, 10 rounds, over the bf16 index: 16
      `plain`, and 8 `plain` + 8 `rocchio_update`, each through a
      `CoalescingIndex` (3 ms) and without: p50 `next` (per session and in
      all), clicks/s, the coalescer's stats, K1 launches (every query of an
      uncoalesced run, every group of one and deferred round of a coalesced
      one), no repeated dbidx; then a traced coalesced run (idle share);
   c. two port servers on a root like phase 4's, one on the card and one
      on the CPU: the same HTTP client (`/user_session`, `/text`, `/next` x
      3 with boxes, `/getstate`, `/explore`, `/session_end`) for `plain`
      and `knn_prop2` gets equal dbidxs round by round; then 3 concurrent
      sessions of a `coalesce_ms: 25` yaml variant on the card's server:
      no error, no repeat; p50 `/next` over HTTP.

12. the evaluation path (`seesaw_tpu_torch.bench`, `research`, the tools),
    run after phase 10 (its 12e reads phase 10's JPEGs):
   a. the method study's corpus (`bench.study`, 4,000 images = 20,000 tiles
      x 512, 1 category a tier) built on the card and on the CPU: vectors
      bit-equal, kNN graphs within KNN_TOL; `run_study` with all 8 methods
      on each: dbidxs equal round by round, hit indices, counts and tables
      equal; where a fitted loop's session parts, its LBFGS solves, recorded
      on both sides, are traced step by step (`utils/solves.py`) and the
      first pair apart must depart on the f32 floor, at a kink or at a
      stalled search; K1 in every round of plain, rocchio_update, log_reg2
      and multi_reg and in every pseudo_lr round after its first accepted
      image, `jacobi_step` in every propagating knn_prop2 round and every
      pseudo_lr refine;
   b. the corpus at 40,000 images (200,000 tiles x 512) on the card: build
      seconds (the kNN build apart), each method's seconds, p50 of the
      harness's per-round latencies, launches; its tables on their own
      JSON line;
   c. `python -m seesaw_tpu_torch.bench.run_bench`'s `main` on a 2-variant
      yaml over 12a's root, 5 batches, with 2 `spawn` workers on the card
      (K1 launched in each worker's every session) and with 1: summaries
      equal;
   d. `research.looptest.TempRegression` (50,000 x 512, 100 classes, 200
      epochs) and `research.mixture.MixtureModel` (20,000 x 512, 4
      components, full covariance) on the card against the CPU; ms an
      epoch and an EM iteration (its loop held to no host sync);
   e. `ingest.extract_gt_vectors` over phase 10's 480 JPEGs with 2 boxes
      each, clip-vit-b32 at B=256 on the card: crops/s, 12 K5 launches a
      batch, 16 crops' vectors against the CPU at phase 7b's bar;
   f. `ingest.make_knn_graphs_batch` over 12a's roots (the index and a
      subset a category, K=10, factored), card against CPU;
   g. one `plain` harness session inside `utils.profiling.device_trace`:
      the trace names K1's kernel.
13. the mesh (`seesaw_tpu_torch.parallel`): 4 shards on the first four
    cards, or on cuda:0 four times on a one-card machine (the phase logs
    which); a-c run right after phase 6, d-g after phase 12:
   a. phase 5's device-built 10M x 512 index, bf16 and then phase 6's int8
      row scales, sliced into the shards on the card: 10 solo queries with
      growing exclusions over the sharded and the one-device index, dbidxs
      equal and scores within MESH_TOL, K1 launched once per shard per
      query, p50 ms of each; a tie planted at the shortlist cutoff across
      two shards keeps the lower frame id, as one device does;
   b. the coalescer's batch program over the mesh, Q = 16, against the
      one-device batch program (ids equal, BATCH_TOL), ms a dispatch in
      chains of CHAIN;
   c. `knn_prop2` rounds, cold and warm, of `LabelPropagationRanker2(mesh=)`
      over phase 6's 10M x 32 graph against the one-device ranker: dbidxs
      equal, scores within PROP_TOL, steps and done equal, `knn_spmv`
      launched once per shard per launched step (segments of 4 steps,
      doubling up to `dispatch_iters`), host reads <= 1 + segments;
   d. `sharded_exact_knn` at 262,144 x 512, K = 32 (phase 10c's corpus cut
      to a quarter) against `exact_knn` at KNN_TOL;
   e. phase 10's 480 JPEGs extracted data-parallel against one device
      (TOWER_TOL), K5 12 times per shard slice;
   f. `parallel.dryrun` at 4 shards on the card: K5 and K6 in its
      data-parallel fine-tune step, a finite loss;
   g. `init_multihost` at world size 1 over NCCL, one `all_reduce`.
14. the mesh across processes (`make_mesh(devices=, group=)`): 2
    processes x 2 shards, started with torch.multiprocessing (spawn), each
    given CUDA IPC views of this process's arrays (no second copy of an
    index), joined by gloo with both on cuda:0: NCCL refuses two ranks on
    one GPU, so the collectives cross host memory; a-b run right after 13c,
    c-d after 13g:
   a. 13a's queries over the bf16 and the int8 index (each process slicing
      its shards out of the shared matrix), 13a's tie (its two frames in
      different processes) and 13b's Q = 16 batch: dbidxs and scores
      bit-equal to 13a's and 13b's; K1 once per local shard per query; p50
      ms and the collectives' share;
   b. 13c's knn_prop2 rounds, cold and warm: dbidxs, steps, done and scores
      bit-equal to 13c's; the processes' knn_spmv launches add up to 13c's;
      ms a propagating round and the collectives' share;
   c. 13d's ring kNN build: ids equal to 13d's;
   d. `python -m seesaw_tpu_torch.parallel.dryrun --processes 2`: every
      part in both processes; the fine-tune step's loss and parameters
      within 2e-4 of 13f's.
   With two cards or more it runs again over NCCL, one process a card;
   with one, a line says that it did not, and why.

The line before the last is the kernel record (JSON); the last line is
{"ok": true, "device": {...}}; phase 10's, 11's, 12's, 13's and 14's
figures that are no kernel's print on their own JSON lines before the
kernel record (13's on a `{"multi_gpu": ...}` line, 14's on
`{"process_mesh": ...}` and `{"process_mesh_vs_in_process": ...}`).
The check that no `seesaw_tpu` module, jax, flax or optax was imported
runs after every phase (the servers' threads import lazily). Without a
CUDA device, or without the package beside this script, it exits non-zero
and prints no result.
"""
from __future__ import annotations

import copy
import json
import os
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
    """A planted multiscale index, like tests/synth.py, saved by the port's
    `MultiscaleIndex.save` in the on-disk format both packages read, whose
    info.json names a small CLIP artifact written beside the root: positives
    hold a tile near that model's text embedding of the query. Its k=8 kNN
    graph is the port's exact build on the CPU. Returns (gdm, gt, model
    name)."""
    from seesaw_tpu_torch import GlobalDataManager
    from seesaw_tpu_torch.indices.meta import VectorMeta
    from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex
    from seesaw_tpu_torch.knn_graph import KNNGraph
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
    meta, order = VectorMeta.from_arrays(np.array(dbidx), np.array(zoom),
                                         np.array(boxes, np.float32))
    idx = MultiscaleIndex(device="cpu", vectors=np.stack(vecs)[order], meta=meta)
    path = Path(ds.index_path("multiscale"))
    idx.save(str(path), model_name=model)
    # k=8: multi_reg's degree (phase 9a); the other graph loops restrict it.
    # Ascending distance, lower row first on equal similarity
    KNNGraph.build(idx.vectors, 8, device="cpu").save(path / "knn_graph")
    return gdm, gt, model


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
    return launches, weights


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


# -- phase 10 ----------------------------------------------------------------
INGEST_HW = (720, 1280)  # BDD100K's frame size: make_plan gives 20 tiles an image
INGEST_IMAGES, INGEST_CHECK_IMAGES, INGEST_BATCH, INGEST_GRAPH_K = 480, 8, 256, 32
INGEST_TILES = 20
# tiles on the card vs the CPU after CLIP normalization: the same
# antialiased resize summed in another order (~5e-5 of a [0, 1] pixel),
# divided by a std of 0.26 or more
TILE_TOL = 2e-4
# kNN distances (and the gap below which neighbours count as tied): an f32
# dot of two unit 512-vectors summed in order parts from the exact one by
# ~1.7e-7 (std, simulated for dots near 0.9, the clusters' similarity), so
# two f32 orders by ~2.4e-7; 2e-6 is eight of those
KNN_TOL = 2e-6
KNN_CHECK_N, KNN_CHECK_K = 20_000, 32
# the 10c corpus: bench.py:1422-1428's clustered unit vectors at d = 512,
# 1M rows (a ~52k-image BDD-like corpus at 20 tiles an image)
KNN_SCALE_N, KNN_SCALE_CLUSTERS, KNN_SCALE_K, KNN_SCALE_CHECK = 1 << 20, 16384, 32, 512
# the traced build: the first 128k rows, whose blocks and chunks have the
# full build's shapes (4096 x 65536)
KNN_PROFILE_N = 1 << 17


def write_jpegs(d: Path, n: int, seed: int) -> list[Path]:
    """n synthetic 1280 x 720 JPEGs (quality 90): a smooth random field with
    pixel noise, so that no tile is flat."""
    import PIL.Image
    from concurrent.futures import ThreadPoolExecutor

    d.mkdir(parents=True, exist_ok=True)
    h, w = INGEST_HW

    def one(i):
        rng = np.random.default_rng(seed + i)
        base = PIL.Image.fromarray(rng.integers(0, 256, size=(h // 40, w // 40, 3), dtype=np.uint8))
        arr = np.asarray(base.resize((w, h), PIL.Image.BICUBIC), dtype=np.int16)
        arr = arr + rng.integers(-12, 13, size=arr.shape, dtype=np.int16)
        p = d / f"frame_{i:05d}.jpg"
        PIL.Image.fromarray(arr.clip(0, 255).astype(np.uint8)).save(p, quality=90)
        return p

    with ThreadPoolExecutor(8) as pool:
        return list(pool.map(one, range(n)))


def clustered_unit_rows(n: int, d: int, n_clusters: int, gen, device):
    """bench.py:1422-1428's corpus made on `device`: cluster centers times 3
    plus unit noise, normalized, rows permuted."""
    import torch

    centers = torch.randn(n_clusters, d, generator=gen, device=device)
    V = centers[torch.arange(n, device=device) % n_clusters] * 3.0
    V += torch.randn(n, d, generator=gen, device=device)
    V /= V.norm(dim=1, keepdim=True)
    return V[torch.randperm(n, generator=gen, device=device)]


def check_planted_ties(ids: np.ndarray, groups):
    """Each member of a group of identical rows lists the group's other
    members first, ascending (lower id first on equal similarity)."""
    for g in groups:
        for row in g:
            want = [m for m in g if m != row][:ids.shape[1]]
            if ids[row, :len(want)].tolist() != want:
                raise AssertionError(f"row {row} of duplicate group {g}: "
                                     f"{ids[row, :len(g)].tolist()}")


def check_ingest_cuda_vs_cpu(dev, clip_params, paths):
    """Phase 10a: the device tiler and the ViT-B/32 f32 vectors of 8 frames
    on the card against the CPU; `exact_knn` at 20,000 x 512 (clustered, with
    planted duplicate rows) on the card against the CPU."""
    import PIL.Image
    import torch

    from seesaw_tpu_torch.ingest.device_tiling import make_plan, tile_images
    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.ops import attention as A
    from seesaw_tpu_torch.ops.knn import assert_knn_close, exact_knn

    imgs = torch.from_numpy(np.stack([np.asarray(PIL.Image.open(p).convert("RGB"))
                                      for p in paths[:INGEST_CHECK_IMAGES]]))
    plan = make_plan(*INGEST_HW)
    if plan.n_tiles != INGEST_TILES:
        raise AssertionError(f"{plan.n_tiles} tiles a 1280x720 frame, not {INGEST_TILES}")
    t_gpu = tile_images(plan, imgs.to(dev))
    t_cpu = tile_images(plan, imgs)
    tile_err = float((t_gpu.cpu() - t_cpu).abs().max())
    if not tile_err <= TILE_TOL:
        raise AssertionError(f"device tiles: card vs cpu {tile_err!r} > {TILE_TOL}")
    before = A.pair_attention.launches
    v_gpu = ClipEmbedding("vit-b32", device=dev, params=clip_params).encode_image_batch(t_gpu)
    torch.cuda.synchronize()
    if A.pair_attention.launches - before != TOWER_LAYERS:
        raise AssertionError("the tile batch did not launch the attention kernel per layer")
    v_cpu = ClipEmbedding("vit-b32", device="cpu", params=clip_params).encode_image_batch(t_cpu)
    v_gpu = torch.nn.functional.normalize(v_gpu.cpu(), dim=1).numpy()
    v_cpu = torch.nn.functional.normalize(v_cpu, dim=1).numpy()
    if v_gpu.shape != (INGEST_CHECK_IMAGES * INGEST_TILES, 512) or not np.isfinite(v_gpu).all():
        raise AssertionError(f"tile vectors: shape {v_gpu.shape} or non-finite values")
    np.testing.assert_allclose(v_gpu, v_cpu, **TOWER_TOL)
    vec_err = float(np.abs(v_gpu - v_cpu).max())
    log(f"ingest 10a: {INGEST_CHECK_IMAGES} frames 1280x720 -> {plan.n_tiles} tiles each; "
        f"tiles card vs cpu max_abs_err={tile_err!r} (tol {TILE_TOL}); vit-b32 f32 unit "
        f"vectors max_abs_err={vec_err!r} (tol {TOWER_TOL})")

    gen = torch.Generator(device="cpu").manual_seed(10)
    X = clustered_unit_rows(KNN_CHECK_N, 512, KNN_CHECK_N // 64, gen, "cpu")
    n = KNN_CHECK_N
    groups = [[11, 12, n // 4, n - 1], [40, 41], [n * 7 // 20, n * 13 // 20, n * 13 // 20 + 1]]
    for g in groups:
        X[g[1:]] = X[g[0]].clone()
    t0 = time.perf_counter()
    ids_gpu, d_gpu = exact_knn(X.to(dev), KNN_CHECK_K, device=dev)
    gpu_s = time.perf_counter() - t0
    ids_cpu, d_cpu = exact_knn(X, KNN_CHECK_K, device="cpu")
    out = assert_knn_close(ids_gpu, d_gpu, ids_cpu, d_cpu, KNN_TOL)
    for ids in (ids_gpu, ids_cpu):
        check_planted_ties(ids, groups)
    log(f"ingest 10a: exact_knn {KNN_CHECK_N}x512 K={KNN_CHECK_K} card vs cpu: "
        f"max_dist_err={out['max_dist_err']!r} (tol {KNN_TOL}); ids equal at "
        f"{int((ids_gpu == ids_cpu).sum())} of {ids_gpu.size} places, "
        f"{out['ids_compared']} held outside near-ties; planted ties lowest id first on both; "
        f"card s={gpu_s!r}")
    return {"tile_max_abs_err": tile_err, "vector_max_abs_err": vec_err,
            "knn_max_dist_err": out["max_dist_err"]}


def ingest_stage_rates(dev, clip_params, paths):
    """Each ingest stage alone, over the 480 frames, host clock ending in a
    synchronize: the decode pool; the upload and device tiling of decoded
    frames; the ViT-B/32 encode of B=256 tile batches (f32 and bf16)."""
    import torch

    from seesaw_tpu_torch.ingest.device_tiling import build_tiler, make_plan
    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.runtime.jpeg_decode import decode_pool, native_available

    t0 = time.perf_counter()
    decoded = {i: np.require(img, requirements=("C", "W"))
               for i, img in decode_pool([str(p) for p in paths], n_threads=8)}
    decode_s = time.perf_counter() - t0
    if len(decoded) != len(paths) or any(v is None for v in decoded.values()):
        raise AssertionError("the decode pool lost a frame")
    tiler = build_tiler(make_plan(*INGEST_HW))
    tiler(torch.from_numpy(decoded[0]).to(dev))  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(len(paths)):
        tiles = tiler(torch.from_numpy(decoded[i]).to(dev))
    torch.cuda.synchronize()
    tile_s = time.perf_counter() - t0
    del tiles
    rates = {"decoder": "native libjpeg pool" if native_available() else "PIL",
             "host_cpus": os.cpu_count(),
             "decode_images_per_s": len(paths) / decode_s,
             "upload_tile_images_per_s": len(paths) / tile_s}
    px = torch.randn(INGEST_BATCH, 224, 224, 3, device=dev)
    for dtype in ("float32", "bfloat16"):
        emb = ClipEmbedding("vit-b32", device=dev, params=clip_params, dtype=getattr(torch, dtype))
        emb.encode_image_batch(px)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(5):
            emb.encode_image_batch(px)
        torch.cuda.synchronize()
        rates[f"encode_images_per_s_{dtype}"] = 5 * INGEST_BATCH / INGEST_TILES / (
            time.perf_counter() - t0)
        del emb
    return rates


def ingest_path(dev, card, clip_params, paths):
    """Phase 10b: 480 synthetic 1280x720 JPEGs -> `create_multiscale_index`
    (clip-vit-b32 at full width and depth, seeded weights, B=256, device
    tiling, the exact K=32 graph) in bf16 and in f32: images/s and tiles/s of
    the extraction, K5's launches (12 a batch, all of the run's type); the
    saved index loaded back through the loader on the card, 4 `plain` rounds
    (K1 every round) and 4 `knn_prop2` rounds over the built graph
    (`jacobi_step` every propagating round); a coarse index derived and
    loaded. Returns the records and each path's launches."""
    import torch

    from seesaw_tpu_torch import GlobalDataManager
    from seesaw_tpu_torch.indices.coarse import CoarseIndex
    from seesaw_tpu_torch.indices.loader import index_cache
    from seesaw_tpu_torch.ingest.pipeline import (create_coarse_index,
                                                  create_multiscale_index,
                                                  run_multiscale_extraction)
    from seesaw_tpu_torch.knn_graph import KNNGraph
    from seesaw_tpu_torch.loops.graph_based import get_weights_from_index
    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.ops import attention as A
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops import spmv
    from seesaw_tpu_torch.utils import rounds as R

    root = ROOT / "build" / "seesaw_tpu_torch" / "ingest_root"
    shutil.rmtree(root, ignore_errors=True)
    ds = GlobalDataManager(str(root)).create_dataset("frames", image_src=str(paths[0].parent))
    n_tiles = INGEST_IMAGES * INGEST_TILES
    n_batches = -(-n_tiles // INGEST_BATCH)
    records, launches, vectors = {}, {}, {}
    for dtype in ("bfloat16", "float32"):
        emb = ClipEmbedding("vit-b32", device=dev, params=clip_params, dtype=getattr(torch, dtype))
        warm = SimpleNamespace(dbidxs=ds.dbidxs[:16], file_path=ds.file_path)
        run_multiscale_extraction(warm, emb, batch_size=INGEST_BATCH, tiling="device")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        A.reset_launch_counts()  # count only this run's launches
        t0 = time.perf_counter()
        v, dbidx, zoom, boxes = run_multiscale_extraction(ds, emb, batch_size=INGEST_BATCH,
                                                          tiling="device")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = dict(A.pair_attention.launches_by_dtype)
        if launched[dtype] != TOWER_LAYERS * n_batches or sum(launched.values()) != launched[dtype]:
            raise AssertionError(f"ingest {dtype}: K5 launches {launched}, not "
                                 f"{TOWER_LAYERS} x {n_batches} batches of {dtype}")
        if v.shape != (n_tiles, 512) or not np.isfinite(v).all():
            raise AssertionError(f"ingest {dtype}: vectors {v.shape} or non-finite values")
        if not (np.all(np.diff(dbidx) >= 0) and np.bincount(dbidx).tolist()
                == [INGEST_TILES] * INGEST_IMAGES):
            raise AssertionError(f"ingest {dtype}: not {INGEST_TILES} tiles a frame by dbidx")
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, atol=1e-5)
        vectors[dtype] = v
        launches[dtype] = launched[dtype]
        peak = torch.cuda.max_memory_allocated() / 1e9
        trace = traced(lambda: run_multiscale_extraction(ds, emb, batch_size=INGEST_BATCH,
                                                         tiling="device"))
        t0 = time.perf_counter()
        idx = create_multiscale_index(ds, f"ingest_{dtype}", "clip-vit-b32", device=dev,
                                      batch_size=INGEST_BATCH, force=True, tiling="device",
                                      build_knn_graph=INGEST_GRAPH_K, embedding=emb)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        rec = dict(images_per_s=INGEST_IMAGES / secs, tiles_per_s=n_tiles / secs,
                   extraction_s=secs, index_and_graph_build_s=build_s,
                   k5_launches=launched[dtype], batches=n_batches, peak_gb=peak, **trace)
        records[dtype] = rec
        log(f"[{card}] ingest 10b {dtype}: {INGEST_IMAGES} frames 1280x720 -> {n_tiles} tiles, "
            f"device tiling, B={INGEST_BATCH}: images_per_s={rec['images_per_s']!r} "
            f"tiles_per_s={rec['tiles_per_s']!r} extraction_s={secs!r} K5 launches="
            f"{launched[dtype]} ({TOWER_LAYERS} x {n_batches} batches); "
            f"create_multiscale_index with the K={INGEST_GRAPH_K} graph s={build_s!r}; "
            f"peak device memory GB={peak!r}; traced extraction: wall_ms="
            f"{trace['traced_wall_ms']!r} device busy_ms={trace['traced_busy_ms']!r} "
            f"kernels by device ms {trace['traced_kernels']}")
        del emb, idx
        torch.cuda.empty_cache()
    cos = float((vectors["bfloat16"] * vectors["float32"]).sum(axis=1).min())
    if not cos > 0.9:
        raise AssertionError(f"ingest: bf16 and f32 tile vectors part (min cosine {cos!r})")

    # the saved bf16 index, loaded back from disk through the loader
    index_cache.invalidate_prefix(ds.index_path("ingest_bfloat16"))
    idx = ds.load_index("ingest_bfloat16", device=dev)
    if idx.meta.n_vectors != n_tiles or idx.n_frames != INGEST_IMAGES:
        raise AssertionError("the loaded index lost rows")
    graph = KNNGraph.from_file(idx.get_knng_path(""))
    if graph.k != INGEST_GRAPH_K or graph.nvecs != n_tiles:
        raise AssertionError(f"graph {graph.nvecs} x {graph.k}")
    fs.fused_frame_max.launches = spmv.knn_spmv.launches = spmv.jacobi_step.launches = 0
    next_ms, round_ms, _ = R.drive_session(
        idx, R.session_params("plain", batch_size=BATCH, shortlist_size=SHORTLIST), 4,
        np.random.default_rng(0), text="a car at a crossing at night")
    launches["fused_frame_max"] = fs.fused_frame_max.launches
    weights = get_weights_from_index(idx, dict(knn_path="", knn_k=INGEST_GRAPH_K, edist=0.1))
    out = R.drive_knnprop_rounds(idx, R.knnprop_ranker(weights, dev), 4, seed=0,
                                 batch_size=BATCH, shortlist_size=SHORTLIST)
    torch.cuda.synchronize()
    launches["jacobi_step"] = spmv.jacobi_step.launches
    if launches["fused_frame_max"] < 4 or not any(out["propagated"]) or not launches["jacobi_step"]:
        raise AssertionError(f"rounds on the built index: launches {launches}, "
                             f"propagated {out['propagated']}")
    log(f"[{card}] ingest 10b: the saved bf16 index and its {n_tiles}x{INGEST_GRAPH_K} graph "
        f"loaded on the card: plain rounds next_ms={next_ms} round_ms={round_ms}, "
        f"fused_frame_max launches={launches['fused_frame_max']}; knn_prop2 rounds "
        f"round_ms={out['round_ms']} propagated={out['propagated']} jacobi_iters="
        f"{out['iters']} jacobi_step launches={launches['jacobi_step']}")
    coarse = create_coarse_index(ds, "ingest_coarse", from_index="ingest_bfloat16",
                                 device=dev, force=True)
    index_cache.invalidate_prefix(ds.index_path("ingest_coarse"))
    coarse = ds.load_index("ingest_coarse", device=dev)
    res = coarse.query(vector=coarse.vectors[7], topk=3)
    if not isinstance(coarse, CoarseIndex) or coarse.vectors.shape != (INGEST_IMAGES, 512) \
            or int(res["dbidxs"][0]) != int(coarse.meta.frame_dbidx[7]):
        raise AssertionError(f"coarse index: {type(coarse).__name__} {coarse.vectors.shape} "
                             f"top {res['dbidxs']}")
    log(f"ingest 10b: coarse index {coarse.vectors.shape} derived, loaded and queried on "
        f"the card; bf16 vs f32 tile vectors min cosine={cos!r}")
    del idx, coarse
    shutil.rmtree(root, ignore_errors=True)
    return records, launches


def knn_build_at_scale(dev, gen, card):
    """Phase 10c: `exact_knn` over KNN_SCALE_N x 512 clustered unit vectors
    made on the card, K=32, TF32 off: seconds and peak memory; 512 random
    rows held against an f64 brute force on the card."""
    import torch

    from seesaw_tpu_torch.ops.knn import assert_knn_close, exact_knn

    V = clustered_unit_rows(KNN_SCALE_N, 512, KNN_SCALE_CLUSTERS, gen, dev)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("the kNN build must run with TF32 off")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ids, dist = exact_knn(V, KNN_SCALE_K, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    rows = torch.randperm(KNN_SCALE_N, generator=gen, device=dev)[:KNN_SCALE_CHECK]
    S = V[rows].double() @ V.double().T
    S[torch.arange(KNN_SCALE_CHECK, device=dev), rows] = float("-inf")
    top_s, top_i = torch.topk(S, KNN_SCALE_K, dim=1)  # no ties: no duplicate rows
    del S
    r = rows.cpu().numpy()
    out = assert_knn_close(ids[r], dist[r], top_i.cpu().numpy(),
                           (1.0 - top_s).clamp_min(0.0).cpu().numpy(), KNN_TOL)
    flops = 2.0 * KNN_SCALE_N * KNN_SCALE_N * 512
    rec = dict(n=KNN_SCALE_N, d=512, k=KNN_SCALE_K, seconds=secs, peak_gb=peak,
               matmul_tflop=flops / 1e12, tflops_per_s=flops / secs / 1e12,
               max_dist_err_vs_f64=out["max_dist_err"],
               **traced(lambda: exact_knn(V[:KNN_PROFILE_N], KNN_SCALE_K, device=dev)))
    log(f"[{card}] knn build 10c: {KNN_SCALE_N}x512 K={KNN_SCALE_K} f32 (TF32 off): "
        f"seconds={secs!r} ({rec['tflops_per_s']!r} TFLOP/s of the {rec['matmul_tflop']!r} "
        f"TFLOP of products); peak device memory GB={peak!r}; {KNN_SCALE_CHECK} rows vs f64 "
        f"brute force max_dist_err={out['max_dist_err']!r} (tol {KNN_TOL}), "
        f"{out['ids_compared']} places held outside near-ties; traced at "
        f"{KNN_PROFILE_N} rows: wall_ms={rec['traced_wall_ms']!r} device busy_ms="
        f"{rec['traced_busy_ms']!r} kernels by device ms {rec['traced_kernels']}")
    return rec


# -- phase 11 ----------------------------------------------------------------
# bench.py bench_multi_query: Q = 16 sessions, 8 chained dispatches, the best
# of 3 chains; shortlist 50 and top-k 10 (bench.py SHORTLIST, TOPK)
Q_BATCH, CHAIN, TOPK = 16, 8, 10
BATCH_CELLS = (("bfloat16", "row"), ("int8", "row"), ("int8", "frame"))
EXCLUDED_PER_SESSION = 4096  # random frames in each session's mask, and its own top hit
# batch vs solo and vs plain: ids equal, scores f32 sums of 512 products in
# another order (int8: exact)
BATCH_TOL = dict(rtol=1e-5, atol=0.0)
SESSIONS, SESSION_ROUNDS, WINDOW_MS = 16, 10, 3.0


def batch_fn(idx, plain=False):
    """The index's batch program (frame-scale for int8 with per-frame
    scales), over (qs (Q, D), excluded (Q, F))."""
    from seesaw_tpu_torch.ops import frame_scoring as fsc

    rank = dict(shortlist_size=SHORTLIST, topk=TOPK, max_zoom=idx._max_zoom, plain=plain)
    arrays = (idx._V, idx._valid, idx._boxes, idx._zoom)
    if idx._frame_scale is not None:
        return lambda qs, ex: fsc.query_program_batch_framescale(
            *arrays, qs, ex, idx._frame_scale, **rank)
    return lambda qs, ex: fsc.query_program_batch(*arrays, qs, ex, idx._row_scale, **rank)


def solo_fn(idx):
    """One solo query through K1 (`query_program_fused`)."""
    from seesaw_tpu_torch.ops import fused_scoring as fs

    rank = dict(shortlist_size=SHORTLIST, topk=TOPK, max_zoom=idx._max_zoom)
    return lambda q, ex: fs.query_program_fused(idx._V, idx._valid, idx._boxes, idx._zoom,
                                                q, ex, idx._row_scale, **rank)


def check_batch(got, want, what) -> float:
    """Every query's valid ids equal and scores within BATCH_TOL; returns the
    largest score difference."""
    import torch

    worst = 0.0
    for i in range(got.frame_ids.shape[0]):
        n = int(want.n_valid[i])
        if int(got.n_valid[i]) != n or not torch.equal(got.frame_ids[i], want.frame_ids[i]):
            raise AssertionError(f"{what}: query {i} ids {got.frame_ids[i].tolist()} != "
                                 f"{want.frame_ids[i].tolist()}")
        for a, b in ((got.frame_scores, want.frame_scores), (got.act_scores, want.act_scores)):
            torch.testing.assert_close(a[i, :n], b[i, :n], **BATCH_TOL)
            worst = max(worst, float((a[i, :n] - b[i, :n]).abs().max()))
    return worst


def batch_cell(idx, name, dev, gen, card) -> dict:
    """Phase 11a for one storage: the batch of 16 queries, each with its own
    mask, against 16 solo K1 queries and against the plain batch; then CUDA
    events and device ms of a dispatch in chains of CHAIN, in which each
    session excludes its own top hit, beside the 16 solo queries; the bound;
    peak memory."""
    import torch

    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops.frame_scoring import QueryResult
    from seesaw_tpu_torch.utils.profiling import cuda_ms

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    F, Q = idx.n_frames, Q_BATCH
    rng = np.random.default_rng(0)
    run, plain, solo = batch_fn(idx), batch_fn(idx, plain=True), solo_fn(idx)
    qs = torch.from_numpy(rng.normal(size=(Q, DIM)).astype(np.float32)).to(dev)
    rows = torch.arange(Q, device=dev)
    excl = torch.zeros(Q, F, dtype=torch.bool, device=dev)
    excl[rows[:, None], torch.randint(0, F, (Q, EXCLUDED_PER_SESSION), device=dev,
                                      generator=gen)] = True
    excl[rows, run(qs, excl).frame_ids[:, 0].clamp(min=0)] = True  # each its own top hit
    got = run(qs, excl)
    solos = [solo(qs[i], excl[i]) for i in range(Q)]
    err_solo = check_batch(got, QueryResult(*(torch.stack(f) for f in zip(*solos))),
                           f"{name} batch vs 16 solo K1 queries")
    err_plain = check_batch(got, plain(qs, excl), f"{name} batch vs its plain version")

    def chain(qss):
        ex = excl
        for qk in qss:
            r = run(qk, ex)
            ex = ex.clone()
            ex[rows, r.frame_ids[:, 0].clamp(min=0)] = True
        return r

    chains = [torch.from_numpy(rng.normal(size=(CHAIN, Q, DIM)).astype(np.float32)).to(dev)
              for _ in range(4)]
    chain(chains[0])  # warm-up
    events = []
    for qss in chains[1:]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        chain(qss)
        end.record()
        torch.cuda.synchronize()
        events.append(start.elapsed_time(end) / CHAIN)
    trace = traced(lambda: chain(chains[1]))  # the device's split of a chain
    device = trace["traced_busy_ms"] / CHAIN
    solo_ms = Q * cuda_ms(solo, [(qs[i], excl[i]) for i in range(Q)])
    k1_ms = Q * cuda_ms(fs.fused_frame_max,
                        [(idx._V, idx._valid, excl[i], qs[i], idx._row_scale) for i in range(Q)])
    N = int(idx._V.shape[0])
    scale_bytes = (F * 4 if idx._frame_scale is not None
                   else N * 4 if idx._row_scale is not None else 0)
    n_bytes = N * DIM * idx._V.element_size() + scale_bytes + N * Q * 4
    bound_ms, bound_by = bound(n_bytes, 2.0 * N * DIM * Q, idx.device_dtype)
    ms = min(events)
    rec = {"cell": name, "Q": Q, "rows": N, "dim": DIM, "topk": TOPK,
           "shortlist": SHORTLIST, "ms_per_dispatch": ms, "ms_per_dispatch_runs": events,
           "device_ms_per_dispatch": device, "queries_per_s": Q * 1e3 / ms,
           "solo16_ms": solo_ms, "solo16_k1_only_ms": k1_ms,
           "solo_queries_per_s": Q * 1e3 / solo_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "max_abs_diff_vs_solo": err_solo,
           "max_abs_diff_vs_plain": err_plain,
           "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
           "chain_top_kernels_ms": trace["traced_kernels"]}
    log(f"[{card}] batch {name}: {json.dumps(rec)}")
    return rec


def concurrent_sessions(idx, card) -> tuple[list, dict]:
    """Phase 11b: SESSIONS threads, each a simulated user running
    SESSION_ROUNDS rounds over the 10M bf16 index, coalesced
    (CoalescingIndex, WINDOW_MS, batches of at most 16) and not, in two
    mixes; then a coalesced run under torch.profiler.
    Returns the records and the path's launches of K1 and the Jacobi
    kernel."""
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops import spmv
    from seesaw_tpu_torch.utils import rounds as R

    plain, rocchio = (R.session_params(m, batch_size=BATCH, shortlist_size=SHORTLIST)
                      for m in ("plain", "rocchio_update"))
    fs.fused_frame_max.launches = spmv.jacobi_step.launches = 0  # this path's launches
    recs = []
    for mix, params in (("16 plain", [plain]), ("8 plain + 8 rocchio_update", [plain, rocchio])):
        for window in (WINDOW_MS, None):
            before = fs.fused_frame_max.launches
            out = R.drive_concurrent_sessions(idx, params, SESSIONS, SESSION_ROUNDS,
                                              coalesce_ms=window)
            k1 = fs.fused_frame_max.launches - before
            queries = SESSIONS * SESSION_ROUNDS
            if window is None and k1 != queries:  # every query a solo scan
                raise AssertionError(f"{mix} uncoalesced: {k1} K1 launches for {queries} queries")
            if window is not None:
                st = out["stats"]
                if st["batched"] == 0:
                    raise AssertionError(f"{mix}: nothing coalesced {st}")
                # deferred Rocchio rounds (1..) pass the coalescer by, solo
                deferred = (SESSIONS // 2) * (SESSION_ROUNDS - 1) if len(params) > 1 else 0
                if st["batched"] + st["solo"] + deferred != queries or k1 != st["solo"] + deferred:
                    raise AssertionError(f"{mix}: stats {st}, K1 launches {k1}")
            rec = {"mix": mix, "coalesce_ms": window, "sessions": SESSIONS,
                   "rounds": SESSION_ROUNDS, "p50_next_ms": out["p50_next_ms"],
                   "p50_next_ms_by_session": [float(np.median(ms[1:])) for ms in out["next_ms"]],
                   "clicks_per_s": out["clicks_per_s"], "wall_s": out["wall_s"],
                   "coalescer_stats": out["stats"], "k1_launches": k1}
            log(f"[{card}] concurrent sessions {mix}, "
                f"{'coalesced' if window else 'uncoalesced'}: {json.dumps(rec)}")
            recs.append(rec)
    # where a coalesced run's time goes: the card's busy share of its wall
    trace = traced(lambda: R.drive_concurrent_sessions(
        idx, [plain], SESSIONS, SESSION_ROUNDS, coalesce_ms=WINDOW_MS))
    trace["idle_share"] = 1.0 - trace["traced_busy_ms"] / trace["traced_wall_ms"]
    log(f"[{card}] concurrent sessions 16 plain, coalesced, traced: {json.dumps(trace)}")
    recs.append({"mix": "16 plain", "coalesce_ms": WINDOW_MS, "traced": trace})
    return recs, {"fused_frame_max": fs.fused_frame_max.launches,
                  "jacobi_step": spmv.jacobi_step.launches}


class HttpClient:
    """A cookie-carrying client of the session server (the frontend's
    request shapes); `times` collects each `/next`'s host ms."""

    def __init__(self, base):
        self.base, self.cookie, self.times = base, None, []

    def post(self, path, body=None):
        import urllib.request

        req = urllib.request.Request(self.base + path, method="POST",
                                     data=json.dumps(body).encode() if body is not None else b"",
                                     headers={"Content-Type": "application/json"})
        if self.cookie:
            req.add_header("Cookie", f"session_id={self.cookie}")
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=300) as r:
            sc = r.headers.get("Set-Cookie")
            if sc and "session_id=" in sc:
                self.cookie = sc.split("session_id=")[1].split(";")[0]
            out = json.loads(r.read())
        if path == "/next":
            self.times.append((time.perf_counter() - t0) * 1e3)
        return out

    def get_text(self, path):
        import urllib.request

        with urllib.request.urlopen(self.base + path, timeout=300) as r:
            return r.read().decode()


def scripted_client(base, mode, gt, rounds=3):
    """/user_session, /text, /next x rounds (the simulated user accepts
    each ground-truth box), /getstate, /explore, /session_end. Returns
    (dbidxs of each round, the /next ms)."""
    import urllib.parse

    c = HttpClient(base)
    c.post(f"/user_session?mode={mode}&dataset=smoke&index=multiscale")
    state = c.post("/text?key=" + urllib.parse.quote("a dog"))
    seen = []
    for _ in range(rounds):
        batch = state["session"]["gdata"][-1]
        seen.append([im["dbidx"] for im in batch])
        for im in batch:
            b = gt.get(im["dbidx"])
            im["boxes"] = ([dict(x1=b[0], y1=b[1], x2=b[2], y2=b[3], marked_accepted=True)]
                           if b is not None else [])
        state = c.post("/next", {"client_data": state})
    seen.append([im["dbidx"] for im in state["session"]["gdata"][-1]])
    if c.post("/getstate")["session"]["gdata"] != state["session"]["gdata"]:
        raise AssertionError(f"{mode}: /getstate differs from the last /next")
    page = c.get_text("/explore?dataset=smoke&clusters=4&q=" + urllib.parse.quote("a dog"))
    if "const D = " not in page or "a dog" not in page:
        raise AssertionError(f"{mode}: /explore served no map")
    c.post("/session_end")
    flat = [i for r in seen for i in r]
    if len(flat) != len(set(flat)):
        raise AssertionError(f"{mode}: the session repeated a dbidx {seen}")
    return seen, c.times


def http_servers(card) -> tuple[dict, dict]:
    """Phase 11c: two servers of the port on a root like phase 4's (its
    CLIP artifact, so each new `/text` runs K5), one on the card, one on the
    CPU; the same scripted client against both for `plain` and `knn_prop2`
    (equal dbidxs round by round); then 3 concurrent sessions with
    coalesce_ms 25 (a yaml variant) on the card's server. Returns the record
    and this path's launches of K1, the Jacobi kernel and K5."""
    import threading
    import urllib.parse

    import torch

    from seesaw_tpu_torch.ops import attention, spmv
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.web.app import SeesawServer
    from seesaw_tpu_torch.web.coalesce import CoalescingIndex

    base_dir = ROOT / "build" / "seesaw_tpu_torch"
    root = base_dir / "web_root"
    dirs = (root, root.with_name(root.name + "_clip"), base_dir / "web_save")
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    _, gt, _ = write_synthetic_root(root)
    cfg = root / "serve.yaml"
    cfg.write_text("shared_session_params:\n  batch_size: 3\n  shortlist_size: 20\n"
                   "variants:\n  - name: co_plain\n    interactive: plain\n"
                   "    index_options:\n      coalesce_ms: 25\n")
    # count only this path's launches
    fs.fused_frame_max.launches = spmv.jacobi_step.launches = 0
    attention.reset_launch_counts()
    apps = {d: SeesawServer(str(root), str(base_dir / "web_save" / d), device=d,
                            config_path=str(cfg)) for d in ("cuda", "cpu")}
    httpds = {d: app.serve(host="127.0.0.1", port=0) for d, app in apps.items()}
    bases = {d: f"http://127.0.0.1:{h.server_address[1]}" for d, h in httpds.items()}
    rec = {"rounds": {}, "p50_next_http_ms": {}}
    try:
        for mode in ("plain", "knn_prop2"):
            (on_card, card_ms), (on_cpu, _) = (scripted_client(bases[d], mode, gt)
                                               for d in ("cuda", "cpu"))
            if on_card != on_cpu:
                raise AssertionError(f"HTTP {mode}: cuda {on_card} != cpu {on_cpu}")
            rec["rounds"][mode] = on_card
            rec["p50_next_http_ms"][mode] = float(np.median(card_ms))
        clients, states = [], []
        for _ in range(3):
            c = HttpClient(bases["cuda"])
            c.post("/user_session?mode=yaml_co_plain&dataset=smoke&index=multiscale")
            states.append(c.post("/text?key=" + urllib.parse.quote("a dog")))
            clients.append(c)
        sessions = [apps["cuda"].manager.get_session(c.cookie).session for c in clients]
        if not (isinstance(sessions[0].index, CoalescingIndex)
                and all(s.index is sessions[0].index for s in sessions)):
            raise AssertionError("the coalescing sessions do not share one CoalescingIndex")
        errors, seen = [], [[] for _ in clients]

        def drive(i):
            try:
                st = states[i]
                for _ in range(3):
                    for im in st["session"]["gdata"][-1]:
                        seen[i].append(im["dbidx"])
                        im["boxes"] = []
                    st = clients[i].post("/next", {"client_data": st})
            except Exception as e:  # re-raised below
                errors.append(e)

        threads = [threading.Thread(target=drive, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"concurrent HTTP sessions failed: {errors}")
        if any(len(s) != len(set(s)) or len(s) != 9 for s in seen):
            raise AssertionError(f"concurrent HTTP sessions repeated a dbidx: {seen}")
        rec["coalesced_sessions"] = {
            "stats": dict(sessions[0].index._coalescer.stats),
            "p50_next_http_ms": float(np.median([t for c in clients for t in c.times]))}
    finally:
        for h in httpds.values():
            h.shutdown()
            h.server_close()
        torch.cuda.synchronize()
        for d in dirs:
            shutil.rmtree(d, ignore_errors=True)
    launches = {"fused_frame_max": fs.fused_frame_max.launches,
                "jacobi_step": spmv.jacobi_step.launches,
                "pair_attention": attention.pair_attention.launches}
    if not all(launches.values()):
        raise AssertionError(f"the card's server launched {launches}")
    rec["launches"] = launches
    log(f"[{card}] HTTP servers (cuda vs cpu): {json.dumps(rec)}")
    return rec, launches


def serving_path(first_cell, dev, gen, card):
    """Phase 11 after 11a's first cell (over phase 6's int8 index with row
    scales): 11a over int8 with frame scales and over bf16, indices made as
    in phase 5; 11b over the bf16 index; 11c on a small root. Returns
    (record, launches by path)."""
    import torch

    from seesaw_tpu_torch.utils import rounds as R

    cells = [first_cell]
    for dtype, scale, name in (("int8", "frame", "int8 frame scales"),
                               ("bfloat16", "row", "bfloat16")):
        torch.cuda.empty_cache()
        idx = R.device_index(N_VECTORS, DIM, dtype, device=dev, generator=gen,
                             int8_scale=scale)
        cells.append(batch_cell(idx, name, dev, gen, card))
        if dtype == "bfloat16":
            sessions, session_launches = concurrent_sessions(idx, card)
        del idx
    torch.cuda.empty_cache()
    http, http_launches = http_servers(card)
    return ({"batch_programs": cells, "concurrent_sessions": sessions, "http": http},
            {"concurrent_sessions": session_launches, "web_server": http_launches})


# -- phase 12 ----------------------------------------------------------------
# the method study's corpus (bench/study.py: graded tiers, 1 category a tier,
# 24 positives and up to 18 distractors each) at CLIP's width: 4,000 images
# (20,000 tiles x 512) on the card and on the CPU; 40,000 images (200,000
# tiles, 0.41 GB f32) on the card alone
STUDY = dict(instances_per_tier=1, dim=DIM, seed=0)
STUDY_CHECK_IMAGES, STUDY_SCALE_IMAGES = 4_000, 40_000
# the loops whose `next` scans the index (K1) every round; pseudo_lr scans
# from its first accepted image on (before it, it ranks as knn_prop2 does);
# knn_prop2, active_search and lknn rank per-vector scores without the scan
SCAN_LOOPS = ("plain", "rocchio_update", "log_reg2", "multi_reg")
FITTED_LOOPS = ("log_reg2", "multi_reg", "pseudo_lr")
BENCH_BATCHES = 5
BENCH_YAML = f"""\
variants:
  - {{name: plain, interactive: plain}}
  - {{name: lr, interactive: log_reg2}}
datasets: [study]
shared_session_params:
  batch_size: 3
  shortlist_size: 40
  agg_method: avg_score
  aug_larger: all
  index_name: multiscale
shared_bench_params: {{n_batches: {BENCH_BATCHES}, max_results: 22, query_template: "a {{}}"}}
"""
# TempRegression at a probe's scale: 50,000 x 512 inputs, 100 classes, 200
# full-batch epochs. Card vs CPU: f32 GEMMs summed in another order through
# 200 Adam steps. At 10,000 rows an f32 fit parts from an f64 one by 6.7e-7
# of a loss and 1.4e-3 of a logit (of logits up to 14.5), so losses rtol
# 1e-4 and logits atol TEMPREG_LOGIT_TOL; predictions equal wherever the
# CPU's top two logits lie more than twice that apart
TEMPREG_N, TEMPREG_C, TEMPREG_EPOCHS = 50_000, 100, 200
TEMPREG_TOL = dict(rtol=1e-4, atol=1e-5)
TEMPREG_LOGIT_TOL = 1e-2
# a full-covariance mixture of 4 components over 20,000 x 512 points
# (`mixture.gen_data`): card vs CPU after 10 EM iterations, f32 einsums over
# 20,000 points and Cholesky factors of 512 x 512 covariances in another
# order. An f32 run parts from an f64 one by 1.6e-6 in the means, 4.2e-7 in
# the covariances and 7.4e-5 in the log-likelihood (of 714)
MIX_N, MIX_K, MIX_CHECK_ITERS, MIX_ITERS = 20_000, 4, 10, 100
MIX_TOL = dict(rtol=1e-4, atol=1e-4)
GT_BOXES, GT_CHECK_IMAGES = 2, 8  # boxes an image; images checked on the CPU


def session_probe():
    """A context in which every port `Session`'s `next` and `refine` are
    recorded, and every LBFGS solve (`utils.solves.recording_solves`). Each
    round records its session, loop and query string, the dbidxs `next`
    returned, whether a staged propagation was due (knn_prop2), the
    accepted images before `next`, the K1 and `jacobi_step` launches of
    `next` and of `refine`, and the range of solves each made."""
    import contextlib
    import itertools

    from seesaw_tpu_torch import session as S
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops import spmv
    from seesaw_tpu_torch.ops.propagation import DeferredPropagation
    from seesaw_tpu_torch.utils.solves import recording_solves

    def counts():
        return fs.fused_frame_max.launches, spmv.jacobi_step.launches

    @contextlib.contextmanager
    def probe():
        rounds, ids = [], itertools.count()
        orig_next, orig_refine = S.Session.next, S.Session.refine
        with recording_solves() as solves:
            def next_(self):
                sid = self.__dict__.setdefault("_probe_id", next(ids))
                model = self.loop.state.knn_model
                rec = dict(sid=sid, method=self.params.interactive, query=self.init_q,
                           staged=model is not None and isinstance(
                               model.current_scores_any(), DeferredPropagation),
                           accepted=len(self.accepted), refine=None)
                n0, (k1, jac) = len(solves), counts()
                out = orig_next(self)
                k1b, jacb = counts()
                rec.update(dbidxs=[int(i) for i in out], next_k1=k1b - k1,
                           next_jac=jacb - jac, solves=(n0, len(solves)))
                rounds.append(rec)
                return out

            def refine_(self):
                rec = next(r for r in reversed(rounds) if r["sid"] == self._probe_id)
                n0, (k1, jac) = len(solves), counts()
                orig_refine(self)
                k1b, jacb = counts()
                rec["refine"] = dict(k1=k1b - k1, jac=jacb - jac, solves=(n0, len(solves)))

            S.Session.next, S.Session.refine = next_, refine_
            try:
                yield SimpleNamespace(rounds=rounds, solves=solves)
            finally:
                S.Session.next, S.Session.refine = orig_next, orig_refine

    return probe()


def probe_sessions(probe) -> dict:
    """(loop, query) -> that session's rounds (one session each)."""
    out, sids = {}, {}
    for r in probe.rounds:
        key = (r["method"], r["query"])
        if sids.setdefault(key, r["sid"]) != r["sid"]:
            raise AssertionError(f"two sessions of {key}")
        out.setdefault(key, []).append(r)
    return out


def check_study_launches(sessions) -> dict:
    """K1 in every round of the scan loops' sessions and in every pseudo_lr
    round after its first accepted image; `jacobi_step` in every knn_prop2
    round that propagates and in every pseudo_lr refine. Returns the rounds
    and launches of each loop."""
    by_loop = {}
    for (method, query), rs in sessions.items():
        k1 = [r["next_k1"] for r in rs]
        refines = [r["refine"] for r in rs if r["refine"] is not None]
        staged = [r["next_jac"] for r in rs if r["staged"]]
        if method in SCAN_LOOPS and min(k1) < 1:
            raise AssertionError(f"{method} {query!r}: K1 launches per round {k1}")
        if method == "pseudo_lr" and (
                min(f["jac"] for f in refines) < 1
                or any(r["next_k1"] < 1 for r in rs if r["accepted"] > 0)):
            raise AssertionError(f"pseudo_lr {query!r}: K1 per round {k1}, Jacobi per "
                                 f"refine {[f['jac'] for f in refines]}")
        if method == "knn_prop2" and (not staged or min(staged) < 1):
            raise AssertionError(f"knn_prop2 {query!r}: Jacobi launches per propagating "
                                 f"round {staged}")
        tot = by_loop.setdefault(method, dict(rounds=0, fused_frame_max=0, jacobi_step=0,
                                              propagating_rounds=0))
        tot["rounds"] += len(rs)
        tot["propagating_rounds"] += len(staged)
        tot["fused_frame_max"] += sum(k1) + sum(f["k1"] for f in refines)
        tot["jacobi_step"] += sum(r["next_jac"] for r in rs) + sum(f["jac"] for f in refines)
    return by_loop


def study_cuda_vs_cpu(dev, card):
    """Phase 12a: the study corpus at STUDY_CHECK_IMAGES built on the card
    and on the CPU (vectors bit-equal, kNN graphs within KNN_TOL), then
    `run_study` with all eight methods on each: the same dbidxs round by
    round (a fitted loop's parting explained by its solves), hit indices,
    counts and tables; K1 and `jacobi_step` where each loop must launch
    them. Returns (record, the card's K1 and Jacobi launches, the card's
    root)."""
    import pandas as pd
    import torch

    from seesaw_tpu_torch.bench.study import (STUDY_METHODS, build_study_corpus,
                                              run_study, study_tables)
    from seesaw_tpu_torch.knn_graph import KNNGraph
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops import spmv
    from seesaw_tpu_torch.ops.knn import assert_knn_close
    from seesaw_tpu_torch.utils.solves import explain_parting

    base = ROOT / "build" / "seesaw_tpu_torch" / "study"
    shutil.rmtree(base, ignore_errors=True)
    runs = {}
    for name, device in (("cuda", dev), ("cpu", torch.device("cpu"))):
        root = base / f"{name}_root"
        t0 = time.perf_counter()
        _, ds, cats = build_study_corpus(str(root), device=device,
                                         n_images=STUDY_CHECK_IMAGES, **STUDY)
        torch.cuda.synchronize()
        corpus_s = time.perf_counter() - t0
        fs.fused_frame_max.launches = spmv.jacobi_step.launches = 0
        np.random.seed(0)  # pseudo_lr draws its sample from numpy's global state
        with session_probe() as probe:
            t0 = time.perf_counter()
            df = run_study(str(root), str(base / f"{name}_results"), device=device)
            torch.cuda.synchronize()
            study_s = time.perf_counter() - t0
        runs[name] = SimpleNamespace(
            root=str(root), ds=ds, cats=cats, corpus_s=corpus_s, study_s=study_s,
            df=df.sort_values(["variant", "category"]).reset_index(drop=True),
            sessions=probe_sessions(probe), solves=probe.solves,
            k1=fs.fused_frame_max.launches, jacobi=spmv.jacobi_step.launches)
    g, c = runs["cuda"], runs["cpu"]
    idx_g, idx_c = (Path(r.ds.index_path("multiscale")) for r in (g, c))
    with np.load(idx_g / "vectors.npz") as zg, np.load(idx_c / "vectors.npz") as zc:
        for k in zc.files:
            if not np.array_equal(zg[k], zc[k]):
                raise AssertionError(f"study corpus: {k} differs between card and CPU")
        shape = zg["vectors"].shape
    graph_g, graph_c = (KNNGraph.from_file(p / "knn_graph") for p in (idx_g, idx_c))
    knn = assert_knn_close(graph_g.dst, graph_g.dist, graph_c.dst, graph_c.dist, KNN_TOL)
    for f in ("ground_truth/box_data.parquet", "ground_truth/qgt.parquet"):
        pd.testing.assert_frame_equal(pd.read_parquet(Path(g.ds.path) / f),
                                      pd.read_parquet(Path(c.ds.path) / f))

    launches = check_study_launches(g.sessions)
    partings, same_hits = [], True
    for key in sorted(c.sessions):
        gr, cr = g.sessions[key], c.sessions[key]
        gd, cd = [r["dbidxs"] for r in gr], [r["dbidxs"] for r in cr]
        if gd == cd:
            continue
        part = next((i for i, (a, b) in enumerate(zip(gd, cd)) if a != b), min(len(gd), len(cd)))
        if key[0] not in FITTED_LOOPS:
            raise AssertionError(f"{key}: card and CPU part at round {part}: {gd[part:part + 1]} "
                                 f"!= {cd[part:part + 1]}")
        partings.append(dict(loop=key[0], query=key[1],
                             **explain_parting(cr, gr, c.solves, g.solves, part)))
    parted = {(p["loop"], p["query"]) for p in partings}
    for (_, a), (_, b) in zip(g.df.iterrows(), c.df.iterrows()):
        if (a.variant, a.category) != (b.variant, b.category):
            raise AssertionError("the card's and the CPU's study ran other sessions")
        same = (np.array_equal(a.hit_indices, b.hit_indices) and a.nseen == b.nseen
                and a.nfound == b.nfound and np.array_equal(a.dbidxs, b.dbidxs))
        if not same and (a.variant, f"a {a.category}") not in parted:
            raise AssertionError(f"{a.variant} {a.category}: summaries differ")
        same_hits &= bool(np.array_equal(a.hit_indices, b.hit_indices))
    tables = study_tables(g.df, g.cats)
    tables_equal = tables == study_tables(c.df, c.cats)
    if not tables_equal and same_hits:
        raise AssertionError("study tables differ with every session's hits equal")
    rec = dict(images=STUDY_CHECK_IMAGES, vectors=list(shape), sessions=len(g.df),
               corpus_s_card=g.corpus_s, corpus_s_cpu=c.corpus_s, study_s_card=g.study_s,
               study_s_cpu=c.study_s, knn_max_dist_err=knn["max_dist_err"],
               partings=partings, tables_equal=tables_equal,
               launches_by_loop=launches,
               mean_ndcg={m: v["ndcg_score"] for m, v in tables["overall"].items()})
    log(f"[{card}] evaluation 12a: study corpus {STUDY_CHECK_IMAGES} images = {shape[0]}x"
        f"{shape[1]} bit-equal card vs CPU, kNN max_dist_err={knn['max_dist_err']!r} (tol "
        f"{KNN_TOL}); run_study {len(STUDY_METHODS)} methods x {len(g.cats)} categories: "
        f"card s={g.study_s!r} cpu s={c.study_s!r} (corpus s card {g.corpus_s!r} cpu "
        f"{c.corpus_s!r}); dbidxs equal round by round in {len(c.sessions) - len(partings)} "
        f"of {len(c.sessions)} sessions, partings {partings}; tables equal={tables_equal}; "
        f"launches by loop {launches}; mean nDCG {rec['mean_ndcg']}")
    return rec, {"fused_frame_max": g.k1, "jacobi_step": g.jacobi}, g.root


def study_at_scale(dev, card):
    """Phase 12b: the study corpus at STUDY_SCALE_IMAGES on the card (the
    kNN build timed apart), then each method's sessions alone: seconds,
    p50 of the harness's per-round latencies (`BenchResult.latencies`),
    K1 and Jacobi launches. Returns (record, tables, launches)."""
    import pandas as pd
    import torch

    from seesaw_tpu_torch.bench.study import (STUDY_METHODS, build_study_corpus,
                                              run_study, study_tables)
    from seesaw_tpu_torch.knn_graph import KNNGraph
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops import spmv

    base = ROOT / "build" / "seesaw_tpu_torch" / "study_scale"
    shutil.rmtree(base, ignore_errors=True)
    knn_s, build = [], KNNGraph.build

    def timed_build(*a, **k):
        t0 = time.perf_counter()
        graph = build(*a, **k)
        torch.cuda.synchronize()
        knn_s.append(time.perf_counter() - t0)
        return graph

    KNNGraph.build = staticmethod(timed_build)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        _, ds, cats = build_study_corpus(str(base / "root"), device=dev,
                                         n_images=STUDY_SCALE_IMAGES, **STUDY)
        torch.cuda.synchronize()
        corpus_s = time.perf_counter() - t0
    finally:
        KNNGraph.build = staticmethod(build)
    methods, frames, launches = {}, [], {"fused_frame_max": 0, "jacobi_step": 0}
    for m in STUDY_METHODS:
        fs.fused_frame_max.launches = spmv.jacobi_step.launches = 0
        np.random.seed(0)
        t0 = time.perf_counter()
        df = run_study(str(base / "root"), str(base / f"results_{m}"), device=dev, methods=(m,))
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        lat = np.concatenate([np.asarray(v, float) for v in df.latencies])
        methods[m] = dict(seconds=secs, images_seen=int(df.nseen.sum()),
                          p50_latency_ms=float(np.median(lat)) * 1e3 if lat.size else None,
                          fused_frame_max=fs.fused_frame_max.launches,
                          jacobi_step=spmv.jacobi_step.launches,
                          mean_ndcg=float(df.ndcg_score.mean()))
        launches["fused_frame_max"] += fs.fused_frame_max.launches
        launches["jacobi_step"] += spmv.jacobi_step.launches
        frames.append(df)
    tables = study_tables(pd.concat(frames, ignore_index=True), cats)
    rec = dict(images=STUDY_SCALE_IMAGES, tiles=STUDY_SCALE_IMAGES * 5, dim=DIM,
               corpus_s_without_knn=corpus_s - sum(knn_s), knn_build_s=sum(knn_s),
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, methods=methods)
    log(f"[{card}] evaluation 12b: study corpus {STUDY_SCALE_IMAGES} images ({rec['tiles']} "
        f"tiles x {DIM}) on the card: build s={rec['corpus_s_without_knn']!r} without the kNN "
        f"graph, kNN s={rec['knn_build_s']!r}; per method {methods}")
    shutil.rmtree(base, ignore_errors=True)
    return rec, tables, launches


def bench_summaries(out_dir: Path):
    from seesaw_tpu_torch.bench.harness import get_all_session_summaries

    (res,) = out_dir.glob("bench_*")
    df = get_all_session_summaries(str(res), force_recompute=True)
    return df.sort_values(["variant", "category"]).reset_index(drop=True)


def run_bench_workers(root: str, dev, card):
    """Phase 12c: the `run_bench` twin on a 2-variant yaml over 12a's root,
    BENCH_BATCHES batches, with 2 `spawn` workers on the card and then with
    1: every session of both workers ran on the card (K1 launched in each
    worker process) and their summaries equal the 1-worker run's. Returns
    (record, K1 launches of both runs)."""
    import contextlib
    import io

    import torch

    from seesaw_tpu_torch.bench import run_bench

    base = ROOT / "build" / "seesaw_tpu_torch" / "run_bench"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    yaml_path = base / "bench.yaml"
    yaml_path.write_text(BENCH_YAML)
    rec, out = {}, {}
    for workers in (2, 1):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            _, runs = run_bench.main(["--root_dir", root, "--output_dir",
                                      str(base / f"w{workers}"), "--num_workers", str(workers),
                                      "--device", str(dev), str(yaml_path)])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        pids = sorted({r["pid"] for r in runs})
        bad = [r for r in runs if r["output_dir"] is None or r["device"] != str(dev)
               or r["fused_frame_max_launches"] < BENCH_BATCHES]
        if bad or len(pids) != workers or (workers > 1 and os.getpid() in pids):
            raise AssertionError(f"run_bench {workers} workers: processes {pids}, runs {runs}")
        out[workers] = bench_summaries(base / f"w{workers}")
        rec[f"workers_{workers}"] = dict(
            seconds=secs, sessions=len(runs),
            sessions_by_process=[sum(r["pid"] == p for r in runs) for p in pids],
            fused_frame_max=sum(r["fused_frame_max_launches"] for r in runs))
    a, b = out[2], out[1]
    if list(zip(a.variant, a.category)) != list(zip(b.variant, b.category)):
        raise AssertionError("run_bench: the two runs ran other sessions")
    for (_, x), (_, y) in zip(a.iterrows(), b.iterrows()):
        if not (np.array_equal(x.dbidxs, y.dbidxs) and np.array_equal(x.hit_indices, y.hit_indices)
                and x.nseen == y.nseen):
            raise AssertionError(f"run_bench {x.variant} {x.category}: 2 workers != 1 worker")
    log(f"[{card}] evaluation 12c: run_bench {len(a)} sessions (2 variants x "
        f"{a.category.nunique()} categories, {BENCH_BATCHES} batches) with 2 spawn workers on "
        f"the card == 1 worker, summaries equal; {rec}")
    shutil.rmtree(base, ignore_errors=True)
    return rec, sum(r["fused_frame_max"] for r in rec.values())


def research_cuda_vs_cpu(dev, card):
    """Phase 12d: `TempRegression` (TEMPREG_N x 512, TEMPREG_C classes,
    TEMPREG_EPOCHS epochs) and `MixtureModel` (MIX_N x 512, MIX_K
    components, full covariance) on the card against the CPU; ms an epoch
    and an EM iteration on the card, the EM loop run under torch's sync
    debug mode, so that a host sync inside it fails the phase."""
    import torch

    from seesaw_tpu_torch.research.looptest import TempRegression
    from seesaw_tpu_torch.research.mixture import MixtureModel, em_steps, gen_data

    rng = np.random.default_rng(12)
    centers = rng.normal(size=(TEMPREG_C, DIM)).astype(np.float32) * 0.1
    y = rng.integers(0, TEMPREG_C, TEMPREG_N)
    X = (centers[y] + rng.normal(size=(TEMPREG_N, DIM))).astype(np.float32)
    models, losses, secs = {}, {}, {}
    for name, device in (("cuda", dev), ("cpu", "cpu")):
        # warm-up: a process's first optimizer step loads torch's compiler
        # modules (seconds, once)
        TempRegression(DIM, TEMPREG_C, seed=1, device=device).fit(X[:1024], y[:1024], epochs=2)
        models[name] = TempRegression(DIM, TEMPREG_C, seed=0, device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses[name] = models[name].fit(X, y, epochs=TEMPREG_EPOCHS)
        secs[name] = time.perf_counter() - t0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], **TEMPREG_TOL)
    lg, lc = (models[n].predict_logits(X) for n in ("cuda", "cpu"))
    logit_err = float(np.abs(lg - lc).max())
    if not logit_err <= TEMPREG_LOGIT_TOL:
        raise AssertionError(f"TempRegression logits card vs CPU {logit_err!r}")
    top2 = np.sort(lc, axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 2 * TEMPREG_LOGIT_TOL
    if not np.array_equal(lg.argmax(1)[clear], lc.argmax(1)[clear]):
        raise AssertionError("TempRegression predictions differ outside logit ties")
    # where an epoch's time goes: 5 more epochs on the card under torch.profiler
    temp_trace = traced(lambda: models["cuda"].fit(X, y, epochs=5))
    temp = dict(n=TEMPREG_N, classes=TEMPREG_C, epochs=TEMPREG_EPOCHS,
                ms_per_epoch_card=secs["cuda"] / TEMPREG_EPOCHS * 1e3,
                ms_per_epoch_cpu=secs["cpu"] / TEMPREG_EPOCHS * 1e3,
                loss_first=float(losses["cuda"][0]), loss_last=float(losses["cuda"][-1]),
                loss_max_rel_err=float(np.abs(losses["cuda"] - losses["cpu"]).max()
                                       / np.abs(losses["cpu"]).min()),
                logit_max_abs_err=logit_err,
                predictions_differing=int((lg.argmax(1) != lc.argmax(1)).sum()),
                rows_at_a_tie=int((~clear).sum()), traced_5_epochs=temp_trace)

    Xm, *_ = gen_data(n_classes=MIX_K, n_dim=DIM, n_samples=MIX_N, seed=0)
    mms = {n: MixtureModel(MIX_K, seed=0, device=d) for n, d in (("cuda", dev), ("cpu", "cpu"))}
    lls = {n: m.fit(Xm, max_iters=MIX_CHECK_ITERS) for n, m in mms.items()}
    for attr in ("mus", "covs", "log_pz"):
        np.testing.assert_allclose(getattr(mms["cuda"], attr), getattr(mms["cpu"], attr),
                                   err_msg=attr, **MIX_TOL)
    np.testing.assert_allclose(lls["cuda"], lls["cpu"], **MIX_TOL)
    start = [torch.as_tensor(a, device=dev) for a in (
        Xm, mms["cuda"].mus, mms["cuda"].covs, mms["cuda"].log_pz)]
    em_steps(*start, n_iters=1)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    # the loop reads nothing back: torch raises on any synchronizing call
    torch.cuda.set_sync_debug_mode("error")
    try:
        *_, ll = em_steps(*start, n_iters=MIX_ITERS)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ll = float(ll)
    em_s = time.perf_counter() - t0
    if not np.isfinite(ll):
        raise AssertionError(f"EM log-likelihood {ll!r}")
    em_trace = traced(lambda: em_steps(*start, n_iters=5))
    mix = dict(n=MIX_N, k=MIX_K, dim=DIM, ll_after_check_iters=lls["cuda"],
               ll_after_check_iters_cpu=lls["cpu"],
               max_abs_diff={a: float(np.abs(getattr(mms["cuda"], a) - getattr(mms["cpu"], a))
                                      .max()) for a in ("mus", "covs", "log_pz")},
               ll_after_more_iters=ll, more_iters=MIX_ITERS,
               ms_per_iteration_card=em_s / MIX_ITERS * 1e3, traced_5_iterations=em_trace)
    log(f"[{card}] evaluation 12d: TempRegression {temp}; MixtureModel {mix}")
    return {"temp_regression": temp, "mixture": mix}


def gt_vectors_path(dev, card, clip_params, frames):
    """Phase 12e: `extract_gt_vectors` over phase 10's JPEGs with GT_BOXES
    ground-truth boxes each, clip-vit-b32 (the registry's seeded weights,
    full width and depth) at B=256 on the card: crops/s, 12 K5 launches a
    batch, and the first GT_CHECK_IMAGES images' crops encoded on the CPU
    at phase 7b's bar. Returns (record, K5 launches)."""
    import pandas as pd
    import torch

    from seesaw_tpu_torch import GlobalDataManager
    from seesaw_tpu_torch.ingest import extract_gt_vectors as X
    from seesaw_tpu_torch.labeldb import BoxTable
    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.ops import attention as A

    root = ROOT / "build" / "seesaw_tpu_torch" / "gt_root"
    shutil.rmtree(root, ignore_errors=True)
    ds = GlobalDataManager(str(root)).create_dataset("frames", image_src=str(frames[0].parent))
    rng = np.random.default_rng(12)
    n = len(ds.dbidxs) * GT_BOXES
    h, w = INGEST_HW
    xy = rng.uniform([0, 0], [w - 300, h - 300], size=(n, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(40, 300, size=(n, 2))], axis=1)
    cats = [("car", "person")[i % 2] for i in range(n)]
    dbidx = np.repeat(np.asarray(ds.dbidxs, np.int32), GT_BOXES)
    ds.save_ground_truth(
        BoxTable(dbidx=dbidx, boxes=boxes.astype(np.float32), description=cats,
                 marked_accepted=np.ones(n, bool)),
        pd.DataFrame({c: np.ones(len(ds.dbidxs), np.float32) for c in ("car", "person")}))
    argv = ["--root", str(root), "--dataset", "frames", "--model", "clip-vit-b32",
            "--output_path", str(root / "gt_vectors"), "--batch_size", str(INGEST_BATCH),
            "--device", str(dev)]
    A.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    df = X.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    batches = -(-n // INGEST_BATCH)
    launched = dict(A.pair_attention.launches_by_dtype)
    vecs = np.stack(df.vectors)
    if len(df) != n or launched["float32"] != TOWER_LAYERS * batches \
            or sum(launched.values()) != launched["float32"]:
        raise AssertionError(f"extract_gt_vectors: {len(df)} of {n} crops, K5 launches "
                             f"{launched} for {batches} batches")
    if vecs.shape != (n, 512) or not np.isfinite(vecs).all():
        raise AssertionError(f"gt vectors {vecs.shape} or non-finite values")
    box_table, _ = ds.load_ground_truth()
    keep = box_table.dbidx < GT_CHECK_IMAGES
    sub = BoxTable(dbidx=box_table.dbidx[keep], boxes=box_table.boxes[keep],
                   description=[d for d, k in zip(box_table.description, keep) if k],
                   marked_accepted=box_table.marked_accepted[keep])
    patches, rows = X.crop_patches(ds, sub, padding=60, target=224)
    cpu = X.encode_batched(ClipEmbedding("vit-b32", device="cpu", params=clip_params),
                           patches, len(rows), device="cpu")
    np.testing.assert_allclose(vecs[:len(rows)], cpu, **TOWER_TOL)
    rec = dict(images=len(ds.dbidxs), crops=n, batch=INGEST_BATCH, seconds=secs,
               crops_per_s=n / secs, k5_launches=launched["float32"], batches=batches,
               cpu_checked_crops=len(rows),
               max_abs_err_vs_cpu=float(np.abs(vecs[:len(rows)] - cpu).max()))
    log(f"[{card}] evaluation 12e: extract_gt_vectors {rec}")
    shutil.rmtree(root, ignore_errors=True)
    return rec, launched["float32"]


def knn_graphs_batch_cuda_vs_cpu(dev, gpu_root: str, cpu_root: str, card):
    """Phase 12f: `make_knn_graphs_batch` over 12a's roots (the whole index
    and one subset a category, K=10, and their factored graphs with
    k_intra 2), on the card against the CPU: ids equal outside near-ties,
    distances within KNN_TOL, factored graphs equal where their graphs'
    ids are."""
    import contextlib
    import io

    import torch

    from seesaw_tpu_torch import GlobalDataManager
    from seesaw_tpu_torch.ingest import make_knn_graphs_batch as M
    from seesaw_tpu_torch.knn_graph import KNNGraph
    from seesaw_tpu_torch.ops.knn import assert_knn_close

    argv = ["--dataset", "study", "--all_categories", "--full", "--n_neighbors", "10",
            "--factored_k_intra", "2", "--knng_name", "batch"]
    secs = {}
    for name, root, device in (("cuda", gpu_root, str(dev)), ("cpu", cpu_root, "cpu")):
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            M.main(["--root", root, *argv, "--device", device])
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    worst, graphs = 0.0, 0
    gds, cds = (GlobalDataManager(r).get_dataset("study") for r in (gpu_root, cpu_root))
    dirs = [(Path(gds.path), Path(cds.path))] + [
        (Path(gds.load_subset(f"cat_{c}").path), Path(cds.load_subset(f"cat_{c}").path))
        for c in cds.load_qgt().columns]
    for gp, cp in dirs:
        rel = Path("indices/multiscale/knn_graph/batch")
        g, c = KNNGraph.from_file(gp / rel), KNNGraph.from_file(cp / rel)
        out = assert_knn_close(g.dst, g.dist, c.dst, c.dist, KNN_TOL)
        worst = max(worst, out["max_dist_err"])
        fg, fc = (KNNGraph.from_file(p / "indices/multiscale/knn_graph/batch_factored")
                  for p in (gp, cp))
        if np.array_equal(g.dst, c.dst) and not np.array_equal(fg.dst, fc.dst):
            raise AssertionError(f"{gp}: factored graphs differ over equal graphs")
        graphs += 1
    rec = dict(graphs=graphs, k=10, seconds_card=secs["cuda"], seconds_cpu=secs["cpu"],
               max_dist_err=worst)
    log(f"[{card}] evaluation 12f: make_knn_graphs_batch {rec}")
    return rec


def traced_session(root: str, dev, card):
    """Phase 12g: one `plain` harness session on 12a's root inside
    `utils.profiling.device_trace`: the Chrome trace must exist and name
    K1's kernel. Returns (record, K1 launches)."""
    from seesaw_tpu_torch import IndexSpec, SessionParams
    from seesaw_tpu_torch.basic_types import BenchParams
    from seesaw_tpu_torch.bench.harness import BenchRunner
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.utils.profiling import device_trace

    base = ROOT / "build" / "seesaw_tpu_torch" / "study_trace"
    shutil.rmtree(base, ignore_errors=True)
    (base / "results").mkdir(parents=True)
    p = SessionParams(index_spec=IndexSpec(d_name="study", i_name="multiscale"),
                      interactive="plain", batch_size=3, shortlist_size=40,
                      agg_method="avg_score", aug_larger="all", interactive_options={})
    b = BenchParams(name="plain", ground_truth_category="hard0", qstr="a hard0",
                    n_batches=40, max_results=22)
    runner = BenchRunner(root, str(base / "results"), redirect_output=False, device=dev)
    fs.fused_frame_max.launches = 0
    with device_trace(base / "trace") as out:
        if out is None:
            raise AssertionError("device_trace did not trace (a trace was already active)")
        runner.run_loop(b, p)
    launches = fs.fused_frame_max.launches
    trace = json.loads((base / "trace" / "trace.json").read_text())
    k1 = [e for e in trace["traceEvents"] if "frame_max_kernel" in str(e.get("name", ""))]
    if not k1 or launches < 1:
        raise AssertionError(f"the trace names no K1 kernel ({launches} launches)")
    rec = dict(trace_mb=(base / "trace" / "trace.json").stat().st_size / 1e6,
               k1_kernel_events=len(k1), k1_launches=launches,
               k1_kernel_name=str(k1[0]["name"])[:80],
               meta=(base / "trace" / "trace_meta.txt").read_text().strip())
    log(f"[{card}] evaluation 12g: device_trace of a plain harness session {rec}")
    shutil.rmtree(base, ignore_errors=True)
    return rec, launches


def evaluation_path(dev, card, clip_params, frames):
    """Phase 12 (a-g). Returns (record, the 200k study's tables, launches
    by path)."""
    import torch

    t_phase = time.perf_counter()
    study, study_launches, gpu_root = study_cuda_vs_cpu(dev, card)
    cpu_root = str(Path(gpu_root).with_name("cpu_root"))
    torch.cuda.empty_cache()
    scale, tables, scale_launches = study_at_scale(dev, card)
    torch.cuda.empty_cache()
    bench, bench_launches = run_bench_workers(gpu_root, dev, card)
    research = research_cuda_vs_cpu(dev, card)
    torch.cuda.empty_cache()
    gt, gt_launches = gt_vectors_path(dev, card, clip_params, frames)
    graphs = knn_graphs_batch_cuda_vs_cpu(dev, gpu_root, cpu_root, card)
    trace, trace_launches = traced_session(gpu_root, dev, card)
    shutil.rmtree(Path(gpu_root).parent, ignore_errors=True)
    rec = {"method_study": study, "method_study_200k": scale, "run_bench": bench,
           "research": research, "extract_gt_vectors": gt, "make_knn_graphs_batch": graphs,
           "device_trace": trace, "phase_seconds": time.perf_counter() - t_phase}
    launches = {"fused_frame_max": {"method_study": study_launches["fused_frame_max"],
                                    "method_study_200k": scale_launches["fused_frame_max"],
                                    "run_bench": bench_launches, "device_trace": trace_launches},
                "jacobi_step": {"method_study": study_launches["jacobi_step"],
                                "method_study_200k": scale_launches["jacobi_step"]},
                "pair_attention": {"extract_gt_vectors": gt_launches}}
    return rec, tables, launches


# -- phase 13 ----------------------------------------------------------------
MESH_SHARDS = 4
MESH_QUERIES = 10
MESH_REBUILD_AT, MESH_REBUILD_FRAMES = 5, 5000  # a jump in the exclusions: a host rebuild
# sharded query vs the one-device index: K1 takes each frame's max with the
# same arithmetic on any shard, and the shortlist's rescoring has the same
# shapes, so equal bits are expected; the bar is an f32 ulp of the scores
MESH_TOL = dict(rtol=1e-6, atol=1e-6)
MESH_ROUNDS = 4  # knn_prop2 rounds, cold and warm each
# mesh propagation (row-block SpMV + PyTorch update) vs the one-launch
# Jacobi segment: f32 row sums in another order, tests/test_torch_propagation.py's bar
PROP_TOL = dict(rtol=2e-5, atol=2e-6)
MESH_KNN_N, MESH_KNN_K = 262_144, 32  # phase 10c's 1M corpus cut to a quarter


def card_mesh():
    """Phase 13's 4-shard mesh: the first four cards, or cuda:0 four times
    on a one-card machine. Returns (mesh, what it is, for the log)."""
    import torch

    from seesaw_tpu_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    if n >= MESH_SHARDS:
        mesh, how = make_mesh(MESH_SHARDS), f"the first {MESH_SHARDS} of {n} cards"
    else:
        mesh = make_mesh(devices=[torch.device("cuda", 0)] * MESH_SHARDS)
        how = f"cuda:0 {MESH_SHARDS} times: the {MESH_SHARDS} shards share one card"
    log(f"phase 13: a {MESH_SHARDS}-shard mesh on {how}")
    return mesh, how


def mesh_segments(n_iter, c, max_iter) -> list:
    """The segments a mesh propagation that stops after n_iter steps
    launches: 4 steps, doubling up to c, max_iter in all."""
    segs, n = [], min(4, c)
    while sum(segs) < n_iter:
        segs.append(min(n, max_iter - sum(segs)))
        n = min(2 * n, c)
    return segs


def sync_mesh(mesh):
    import torch

    for d in mesh.distinct:
        torch.cuda.synchronize(d)


def mesh_index(idx, mesh):
    """Phase 5's device-built index sliced into the mesh's shards on the card."""
    from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex

    return MultiscaleIndex.from_device_arrays(
        embedding=idx.embedding, V=idx._V, valid=idx._valid, boxes=idx._boxes,
        zoom=idx._zoom, meta=idx.meta, row_scale=idx._row_scale,
        frame_scale=idx._frame_scale, mesh=mesh)


def mesh_queries(idx, m_idx, name, card) -> dict:
    """Phase 13a for one storage: MESH_QUERIES solo queries with growing
    exclusions (each query's results, and one jump of MESH_REBUILD_FRAMES
    random frames) over the sharded index and the one-device index: dbidxs
    equal, scores within MESH_TOL; K1 launched once per shard per query;
    p50 host ms of each (ending in a sync)."""
    import torch

    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.runtime.bitmap import BitMap

    mesh = m_idx.mesh
    rng = np.random.default_rng(13)
    ex_m, ex_o = BitMap(), BitMap()
    m_ms, o_ms, worst, launched, results = [], [], 0.0, 0, []
    for i in range(MESH_QUERIES):
        if i == MESH_REBUILD_AT:
            jump = rng.choice(idx.meta.frame_dbidx, MESH_REBUILD_FRAMES, replace=False)
            ex_m.update(jump)
            ex_o.update(jump)
        q = rng.normal(size=DIM).astype(np.float32)
        fs.fused_frame_max.launches = 0
        t0 = time.perf_counter()
        got = m_idx.query(vector=q, topk=BATCH, shortlist_size=SHORTLIST, exclude=ex_m)
        sync_mesh(mesh)
        t1 = time.perf_counter()
        launched += fs.fused_frame_max.launches
        want = idx.query(vector=q, topk=BATCH, shortlist_size=SHORTLIST, exclude=ex_o)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        m_ms.append((t1 - t0) * 1e3)
        o_ms.append((t2 - t1) * 1e3)
        if got["dbidxs"].tolist() != want["dbidxs"].tolist():
            raise AssertionError(f"13a {name} query {i}: {got['dbidxs']} != {want['dbidxs']}")
        a, b = ([x["score"] for x in r["activations"]] for r in (got, want))
        np.testing.assert_allclose(a, b, **MESH_TOL)
        worst = max(worst, float(np.abs(np.subtract(a, b)).max(initial=0.0)))
        results.append((got["dbidxs"].tolist(), a))
        ex_m.update(got["dbidxs"])
        ex_o.update(want["dbidxs"])
    if launched != MESH_SHARDS * MESH_QUERIES:
        raise AssertionError(f"13a {name}: {launched} K1 launches, not "
                             f"{MESH_SHARDS} x {MESH_QUERIES}")
    rec = {"storage": name, "queries": MESH_QUERIES, "k1_launches": launched,
           "max_abs_err": worst, "sharded_p50_ms": float(np.median(m_ms)),
           "one_device_p50_ms": float(np.median(o_ms)), "sharded_ms": m_ms,
           "one_device_ms": o_ms}
    log(f"[{card}] 13a {name} 10M x 512, {MESH_SHARDS} shards: {json.dumps(rec)}")
    rec["results"] = results  # each query's dbidxs and scores, for phase 14a
    return rec


def mesh_cutoff_tie(idx, m_idx, card) -> dict:
    """Phase 13a: a tie planted at the global shortlist cutoff across two
    shards, which phase 14's layout puts in different processes. The frame
    at the cutoff (rank SHORTLIST under K1's maxima) has its tiles copied
    onto a frame of another process's shard below it, so both hold the
    same maximum; with topk = shortlist the sharded result must keep the
    lower frame id only, as one device does. The rows are restored."""
    import torch

    from seesaw_tpu_torch.ops import fused_scoring as fs

    sh = m_idx._sharded
    T, Fs = idx._tile_bound, sh.n_frames_local
    q = np.random.default_rng(131).normal(size=DIM).astype(np.float32)
    qt = torch.from_numpy(q).to(idx.device)
    none = torch.zeros(idx.n_frames, dtype=torch.bool, device=idx.device)
    fmax = fs.fused_frame_max(idx._V, idx._valid, none, qt, idx._row_scale).cpu().numpy()
    order = np.argsort(-fmax, kind="stable")
    c = int(order[SHORTLIST - 1])
    t = next(int(f) for f in order[SHORTLIST + 10:]
             if f // Fs // P14_LOCAL != c // Fs // P14_LOCAL)
    rc, rt = slice(c * T, (c + 1) * T), slice(t * T, (t + 1) * T)
    s_t, lt = t // Fs, slice((t % Fs) * T, (t % Fs + 1) * T)
    arrays = [(idx._V, sh.V[s_t])] + ([(idx._row_scale, sh.row_scale[s_t])]
                                      if idx._row_scale is not None else [])
    saved = [whole[rt].clone() for whole, _ in arrays]

    def write(vals):  # into the index and its shard (a view of it on one card)
        for (whole, shard), v in zip(arrays, vals):
            whole[rt] = v
            shard[lt] = v.to(shard.device)

    try:
        write([whole[rc] for whole, _ in arrays])
        fm = fs.fused_frame_max(idx._V, idx._valid, none, qt, idx._row_scale)
        if float(fm[t]) != float(fm[c]):
            raise AssertionError("13a: the planted frames do not tie")
        want = idx.query(vector=q, topk=SHORTLIST, shortlist_size=SHORTLIST)
        got = m_idx.query(vector=q, topk=SHORTLIST, shortlist_size=SHORTLIST)
    finally:
        write(saved)
    keep = idx.meta.frame_dbidx[min(c, t)]
    drop = idx.meta.frame_dbidx[max(c, t)]
    if got["dbidxs"].tolist() != want["dbidxs"].tolist():
        raise AssertionError(f"13a tie: sharded {got['dbidxs']} != one device {want['dbidxs']}")
    if keep not in want["dbidxs"] or drop in want["dbidxs"]:
        raise AssertionError("13a tie: the cutoff did not keep the lower frame id alone")
    rec = {"frames": [c, t], "shards": [c // Fs, t // Fs], "kept": int(keep)}
    log(f"[{card}] 13a cutoff tie across shards {rec['shards']}: frames {c} and {t} tie "
        f"at rank {SHORTLIST}; sharded == one device, frame {min(c, t)} kept")
    rec["results"] = (got["dbidxs"].tolist(), [x["score"] for x in got["activations"]])
    return rec


def mesh_masks(sh, ex):
    """(Q, F) masks on the primary device -> the shards' (Q, Fs) masks."""
    from seesaw_tpu_torch.parallel.mesh import split_rows

    return [p.T.contiguous() for p in split_rows(sh.mesh, ex.T, sh.n_frames_local, True)]


def mesh_batch(idx, m_idx, dev, gen, card) -> dict:
    """Phase 13b: the coalescer's batch program over the mesh (Q = 16, each
    query with its own mask) against the one-device batch program: ids
    equal, scores within BATCH_TOL; then host ms a dispatch (ending in a
    sync) in chains of CHAIN, each session excluding its own top hit."""
    import torch

    from seesaw_tpu_torch.parallel.sharded_index import sharded_query_batch_program

    sh = m_idx._sharded
    F, Q, Fs = idx.n_frames, Q_BATCH, sh.n_frames_local
    rng = np.random.default_rng(14)
    qs = torch.from_numpy(rng.normal(size=(Q, DIM)).astype(np.float32)).to(dev)
    rows = torch.arange(Q, device=dev)
    excl = torch.zeros(Q, F, dtype=torch.bool, device=dev)
    excl[rows[:, None], torch.randint(0, F, (Q, EXCLUDED_PER_SESSION), device=dev,
                                      generator=gen)] = True
    none = torch.full((Q, 1), -1, dtype=torch.int64, device=dev)
    rank = dict(shortlist_size=SHORTLIST, topk=TOPK)

    def run(qk, masks):
        return sharded_query_batch_program(sh, qk, masks, none, **rank)[0]

    got = run(qs, mesh_masks(sh, excl))
    err = check_batch(got, batch_fn(idx)(qs, excl), "13b sharded batch vs one device")
    ref = {"qs": qs, "excl": excl, "frame_ids": got.frame_ids.clone(),
           "frame_scores": got.frame_scores.clone()}  # for phase 14a

    def chain(qss):
        masks = mesh_masks(sh, excl)
        for qk in qss:
            r = run(qk, masks)
            top = r.frame_ids[:, 0].clamp(min=0)
            masks = [m.clone() for m in masks]
            for s, m in enumerate(masks):
                local = top.to(m.device) - s * Fs
                ok = (local >= 0) & (local < Fs)
                lc = local.clamp(0, Fs - 1)
                m[rows.to(m.device), lc] = m[rows.to(m.device), lc] | ok
        return r

    chains = [torch.from_numpy(rng.normal(size=(CHAIN, Q, DIM)).astype(np.float32)).to(dev)
              for _ in range(4)]
    chain(chains[0])  # warm-up
    ms = []
    for qss in chains[1:]:
        sync_mesh(sh.mesh)
        t0 = time.perf_counter()
        chain(qss)
        sync_mesh(sh.mesh)
        ms.append((time.perf_counter() - t0) * 1e3 / CHAIN)
    rec = {"Q": Q, "max_abs_diff_vs_one_device": err, "dispatch_ms": min(ms),
           "dispatch_ms_runs": ms}
    log(f"[{card}] 13b coalesced batch over the mesh ({idx.device_dtype}): {json.dumps(rec)}")
    return rec, ref


def mesh_knnprop(idx, m_idx, weights, dev, card) -> dict:
    """Phase 13c: MESH_ROUNDS knn_prop2 rounds, cold then warm-started, of
    `LabelPropagationRanker2(mesh=)` over the sharded index against the
    one-device ranker over the one-device index, the same clicks on both:
    dbidxs equal every round; after each propagating round the scores
    within PROP_TOL, steps and done equal, `knn_spmv` launched once per
    shard per launched step of `mesh_segments`, host reads <= 1 + segments."""
    from seesaw_tpu_torch.loops.knn_methods import LabelPropagationRanker2
    from seesaw_tpu_torch.ops import spmv
    from seesaw_tpu_torch.runtime.bitmap import BitMap
    from seesaw_tpu_torch.utils import rounds as R

    mesh = m_idx.mesh
    out, ref = {}, {"rounds": []}  # ref: what phase 14b is held to
    spmv.knn_spmv.launches = 0
    total = 0
    for warm in (False, True):
        r_one = R.knnprop_ranker(weights, dev, warm_start=warm)
        r_mesh = LabelPropagationRanker2(weights=weights, mesh=mesh, warm_start=warm,
                                         **R.KNNPROP_OPTIONS)
        q = np.random.default_rng(15).normal(size=DIM).astype(np.float32)
        base = idx.score_device(q / np.linalg.norm(q))
        ref["base"] = base
        r_one.set_base_scores(base)
        r_mesh.set_base_scores(base)
        rng = np.random.default_rng(16)
        ret_m, ret_o = BitMap(), BitMap()
        rec = dict(round_ms=[], steps=[], segments=[], host_reads=[], launches=[],
                   max_abs_err=[], propagating_round_ms=[])
        c = r_mesh.lp.dispatch_iters
        for r in range(MESH_ROUNDS):
            prev = r_mesh.last_result
            before = spmv.knn_spmv.launches
            t0 = time.perf_counter()
            res_m = m_idx.rank_by_scores(r_mesh.current_scores_any(), topk=BATCH,
                                         shortlist_size=SHORTLIST, exclude=ret_m)
            sync_mesh(mesh)
            rec["round_ms"].append((time.perf_counter() - t0) * 1e3)
            launched = spmv.knn_spmv.launches - before
            res_o = idx.rank_by_scores(r_one.current_scores_any(), topk=BATCH,
                                       shortlist_size=SHORTLIST, exclude=ret_o)
            got, want = res_m["dbidxs"].tolist(), res_o["dbidxs"].tolist()
            if got != want:
                raise AssertionError(f"13c round {r} (warm={warm}): {got} != {want}")
            pm = r_mesh.last_result
            if pm is not prev:  # the round propagated
                po = r_one.last_result
                if (pm.n_iter, pm.converged) != (po.n_iter, po.converged):
                    raise AssertionError(f"13c round {r}: steps/done {pm.n_iter}/"
                                         f"{pm.converged} != {po.n_iter}/{po.converged}")
                a = r_mesh._current_scores
                b = r_one._current_scores.to(a.device)
                err = float((a - b).abs().max())
                if not bool(((a - b).abs() <= PROP_TOL["atol"]
                             + PROP_TOL["rtol"] * b.abs()).all()):
                    raise AssertionError(f"13c round {r}: scores differ by {err}")
                seg_steps = mesh_segments(pm.n_iter, c, r_mesh.lp.max_iter)
                segs, steps_launched = len(seg_steps), sum(seg_steps)
                if launched != MESH_SHARDS * steps_launched:
                    raise AssertionError(f"13c round {r}: {launched} knn_spmv launches for "
                                         f"{steps_launched} steps on {MESH_SHARDS} shards")
                reads = pm.host_reads + 1  # the segments' reads and the ranking's
                if reads > 1 + segs:
                    raise AssertionError(f"13c round {r}: {reads} host reads, {segs} segments")
                for k, v in (("steps", pm.n_iter), ("segments", segs), ("host_reads", reads),
                             ("launches", launched), ("max_abs_err", err),
                             ("propagating_round_ms", rec["round_ms"][-1])):
                    rec[k].append(v)
            ref["rounds"].append({"warm": warm, "dbidxs": got} if pm is prev else {
                "warm": warm, "dbidxs": got, "steps": pm.n_iter, "done": pm.converged,
                "scores": r_mesh._current_scores.clone()})
            ret_m.update(got)
            ret_o.update(want)
            rows = idx.meta.frame_starts[np.searchsorted(idx.meta.frame_dbidx, got)]
            labels = (rng.random(len(rows)) < 0.3).astype(np.float64)
            r_mesh.update(rows, labels)
            r_one.update(rows, labels)
        if not rec["steps"]:
            raise AssertionError("13c: no round propagated")
        total += sum(rec["launches"])
        out["warm" if warm else "cold"] = rec
        log(f"[{card}] 13c knn_prop2 {'warm' if warm else 'cold'} over the mesh, "
            f"{idx.meta.n_vectors}x{GRAPH_K} graph: {json.dumps(rec)}")
    if spmv.knn_spmv.launches != total:
        raise AssertionError("13c: knn_spmv launched outside the mesh rounds")
    out["knn_spmv_launches"] = total
    return out, ref


def mesh_knn(mesh, dev, card) -> dict:
    """Phase 13d: `sharded_exact_knn` at MESH_KNN_N x 512, K = 32 (phase
    10c's clustered corpus, cut to a quarter) against `exact_knn` on one
    device: `assert_knn_close` at KNN_TOL; seconds of each."""
    import torch

    from seesaw_tpu_torch.ops.knn import assert_knn_close, exact_knn
    from seesaw_tpu_torch.parallel.sharded_graph import sharded_exact_knn

    gen = torch.Generator(device=dev).manual_seed(13)
    X = clustered_unit_rows(MESH_KNN_N, 512, MESH_KNN_N // 64, gen, dev)
    sync_mesh(mesh)
    t0 = time.perf_counter()
    ids_m, d_m = sharded_exact_knn(X, MESH_KNN_K, mesh)
    sync_mesh(mesh)
    t1 = time.perf_counter()
    ids_o, d_o = exact_knn(X, MESH_KNN_K, device=dev)
    t2 = time.perf_counter()
    chk = assert_knn_close(ids_m, d_m, ids_o, d_o, KNN_TOL)
    rec = {"rows": MESH_KNN_N, "k": MESH_KNN_K, "sharded_s": t1 - t0, "one_device_s": t2 - t1,
           "ids_equal_share": float((ids_m == ids_o).mean()), **chk}
    log(f"[{card}] 13d sharded exact kNN {MESH_KNN_N}x512 K={MESH_KNN_K}: {json.dumps(rec)}")
    return rec, {"X": X, "ids": ids_m, "dist": d_m}  # for phase 14c


def mesh_ingest(mesh, dev, card, clip_params, frames) -> dict:
    """Phase 13e: phase 10's 480 JPEGs extracted data-parallel over the
    mesh (device tiling, ViT-B/32 f32, B=256, slices of 64 on each shard's
    tower replica) against the one-device extraction: dbidx order equal,
    unit vectors within TOWER_TOL; K5 launched TOWER_LAYERS times per
    shard slice."""
    import torch

    from seesaw_tpu_torch import GlobalDataManager
    from seesaw_tpu_torch.ingest.pipeline import run_multiscale_extraction
    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.ops import attention as A

    root = ROOT / "build" / "seesaw_tpu_torch" / "mesh_ingest_root"
    shutil.rmtree(root, ignore_errors=True)
    ds = GlobalDataManager(str(root)).create_dataset("frames", image_src=str(frames[0].parent))
    emb = ClipEmbedding("vit-b32", device=dev, params=clip_params)
    A.reset_launch_counts()
    sync_mesh(mesh)
    t0 = time.perf_counter()
    v_m, db_m, _, _ = run_multiscale_extraction(ds, emb, batch_size=INGEST_BATCH,
                                                tiling="device", mesh=mesh)
    sync_mesh(mesh)
    mesh_s = time.perf_counter() - t0
    launched = A.pair_attention.launches
    t0 = time.perf_counter()
    v_o, db_o, _, _ = run_multiscale_extraction(ds, emb, batch_size=INGEST_BATCH,
                                                tiling="device")
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    n_tiles = INGEST_IMAGES * INGEST_TILES
    # each batch of L tiles splits into slices of ceil(L / shards) tiles
    sizes = [min(INGEST_BATCH, n_tiles - lo) for lo in range(0, n_tiles, INGEST_BATCH)]
    slices = sum(-(-L // -(-L // MESH_SHARDS)) for L in sizes)
    if launched != TOWER_LAYERS * slices:
        raise AssertionError(f"13e: {launched} K5 launches, not {TOWER_LAYERS} x {slices}")
    if not np.array_equal(db_m, db_o) or v_m.shape != (n_tiles, 512):
        raise AssertionError("13e: the mesh extraction's order or shape differs")
    np.testing.assert_allclose(v_m, v_o, **TOWER_TOL)
    shutil.rmtree(root, ignore_errors=True)
    rec = {"tiles": n_tiles, "batch": INGEST_BATCH, "k5_launches": launched,
           "max_abs_err": float(np.abs(v_m - v_o).max()), "mesh_s": mesh_s, "one_device_s": one_s,
           "mesh_tiles_per_s": n_tiles / mesh_s}
    log(f"[{card}] 13e data-parallel extraction: {json.dumps(rec)}")
    return rec


def mesh_dryrun(card) -> dict:
    """Phase 13f: the dry run twin at --n-devices 4 --device cuda, in this
    process: every part held against one device, K5 and K6 launched by the
    data-parallel step, a finite loss."""
    from seesaw_tpu_torch.parallel.dryrun import dryrun_multichip

    P14_DIR.mkdir(parents=True, exist_ok=True)
    out = dryrun_multichip(MESH_SHARDS, "cuda", params_out=P14_DIR / "dryrun_13f.npz")
    b = out["b_finetune"]
    if not (b["launches"]["pair_attention"] > 0 and b["launches"]["pair_attention_bwd"] > 0
            and np.isfinite(b["loss"])):
        raise AssertionError(f"13f: the data-parallel step {b}")
    if out["a_retrieval"]["launches"]["fused_frame_max"] == 0:
        raise AssertionError("13f: the sharded retrieval did not launch K1")
    if out["c_graph"]["launches"]["knn_spmv"] == 0:
        raise AssertionError("13f: the sharded propagation did not launch knn_spmv")
    log(f"[{card}] 13f dryrun: {json.dumps(out)}")
    return out


def multihost_nccl(dev, card) -> dict:
    """Phase 13g: `init_multihost` at world size 1 over NCCL, one
    all_reduce of a CUDA tensor, then `destroy_process_group`."""
    import socket

    import torch
    import torch.distributed as dist

    from seesaw_tpu_torch.parallel.multihost import ingest_file_range, init_multihost

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    n, rank = init_multihost(f"127.0.0.1:{port}", 1, 0, backend="nccl")
    try:
        x = torch.arange(4, dtype=torch.float32, device=dev)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        if (n, rank) != (1, 0) or x.tolist() != [0.0, 1.0, 2.0, 3.0]:
            raise AssertionError(f"13g: world {n} rank {rank} all_reduce {x.tolist()}")
        rng = ingest_file_range(10)
    finally:
        dist.destroy_process_group()
    rec = {"backend": "nccl", "world_size": n, "rank": rank, "file_range": list(rng),
           "init_to_destroy_s": time.perf_counter() - t0}
    log(f"[{card}] 13g multihost: {json.dumps(rec)}")
    return rec


def mesh_serving_path(idx, weights, dev, gen, card):
    """Phase 13a-c, right after phase 6 over its index (int8 row scales)
    and graph, with a bf16 index made as phase 5's first. Returns the
    records and each kernel's launches on these mesh paths."""
    import torch

    from seesaw_tpu_torch.utils import rounds as R

    t0 = time.perf_counter()
    mesh, how = card_mesh()
    recs = {"mesh": how}

    def sharded(one):
        m_idx = mesh_index(one, mesh)
        v0 = m_idx._sharded.V[0]
        if v0.device == one._V.device and v0.data_ptr() != one._V.data_ptr():
            raise AssertionError("13a: the shards on the index's card are not views of it")
        return m_idx

    bf16 = R.device_index(N_VECTORS, DIM, "bfloat16", device=dev, generator=gen)
    recs["queries_bfloat16"] = mesh_queries(bf16, sharded(bf16), "bfloat16", card)
    m_idx = sharded(idx)
    recs["queries_int8"] = mesh_queries(idx, m_idx, "int8 row scales", card)
    k1 = recs["queries_bfloat16"]["k1_launches"] + recs["queries_int8"]["k1_launches"]
    recs["cutoff_tie"] = mesh_cutoff_tie(idx, m_idx, card)
    recs["batch"], batch_ref = mesh_batch(idx, m_idx, dev, gen, card)
    recs["knn_prop2"], prop_ref = mesh_knnprop(idx, m_idx, weights, dev, card)
    recs["seconds"] = time.perf_counter() - t0
    # what phase 14a-b holds the process mesh to: 13a-c's results over these indexes
    ref = {"bf16": bf16, "queries_bfloat16": recs["queries_bfloat16"].pop("results"),
           "queries_int8": recs["queries_int8"].pop("results"),
           "tie": recs["cutoff_tie"]["frames"], "tie_results": recs["cutoff_tie"].pop("results"),
           "batch": batch_ref, "knn_prop2": prop_ref,
           "knn_prop2_launches": recs["knn_prop2"]["knn_spmv_launches"]}
    return recs, {"fused_frame_max": k1, "knn_spmv": recs["knn_prop2"]["knn_spmv_launches"]}, ref


def mesh_offline_path(dev, card, clip_params, frames):
    """Phase 13d-g, after phase 10 (13e reads its JPEGs). Returns the
    records and each kernel's launches on these mesh paths."""
    t0 = time.perf_counter()
    mesh, how = card_mesh()
    knn, knn_ref = mesh_knn(mesh, dev, card)
    recs = {"knn": knn, "ingest": mesh_ingest(mesh, dev, card, clip_params, frames),
            "dryrun": mesh_dryrun(card), "multihost": multihost_nccl(dev, card)}
    recs["seconds"] = time.perf_counter() - t0
    d = recs["dryrun"]
    launches = {"pair_attention_ingest": recs["ingest"]["k5_launches"],
                "dryrun": {k: sum(d[p]["launches"][k] for p in d if isinstance(d[p], dict)
                                  and "launches" in d[p])
                           for k in d["a_retrieval"]["launches"]}}
    return recs, launches, knn_ref


# -- phase 14 ----------------------------------------------------------------
P14_PROCESSES, P14_LOCAL = 2, 2  # phase 13's 4 shards: 2 in each of 2 processes
P14_DIR = ROOT / "build" / "seesaw_tpu_torch" / "phase14"
P14_TIMEOUT_S = 300.0  # a process of the mesh that has not finished by then has hung


def p14_runs() -> list:
    """Phase 14's runs: (backend, each process's card indices). gloo, both
    processes on cuda:0, since NCCL refuses two ranks on one GPU ("Duplicate
    GPU detected"); with two cards or more, NCCL too, one process a card."""
    import torch

    runs = [("gloo", [[0] * P14_LOCAL] * P14_PROCESSES)]
    if torch.cuda.device_count() >= P14_PROCESSES:
        runs.append(("nccl", [[r] * P14_LOCAL for r in range(P14_PROCESSES)]))
    return runs


def p14_spawn(target, backend, devices, payload) -> list:
    """Start the phase's processes (torch.multiprocessing, spawn: the CUDA
    tensors in `payload` reach them as IPC handles of this process's
    memory, not as copies), take each rank's record from a queue, and stop
    them all at the first failure or at P14_TIMEOUT_S. Returns the records
    in rank order."""
    import queue
    import socket

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    q = ctx.Queue()
    procs = [ctx.Process(target=target, args=(r, port, backend, devices[r], payload, q))
             for r in range(P14_PROCESSES)]
    for p in procs:
        p.start()
    recs, deadline = {}, time.monotonic() + P14_TIMEOUT_S
    try:
        while len(recs) < len(procs):
            try:
                rank, rec = q.get(timeout=1.0)
                recs[rank] = rec
            except queue.Empty:
                failed = [(r, p.exitcode) for r, p in enumerate(procs)
                          if p.exitcode is not None and r not in recs]
                if failed or time.monotonic() > deadline:
                    raise AssertionError(f"phase 14 {target.__name__} over {backend}: processes "
                                         f"(rank, exit code) {failed} failed or timed out")
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    import torch

    torch.cuda.ipc_collect()  # the shared blocks the processes released
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"phase 14 {target.__name__}: exit codes {codes}")
    return [recs[r] for r in range(P14_PROCESSES)]


def p14_join(rank, port, backend, devices):
    """In a phase-14 process: the port on the path, TF32 off as in the
    parent, the group joined, this process's shards of the global mesh."""
    sys.path.insert(0, str(ROOT))
    import torch

    import torch.distributed as dist

    from seesaw_tpu_torch.parallel.mesh import make_mesh
    from seesaw_tpu_torch.parallel.multihost import init_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    local = [torch.device("cuda", d) for d in devices]
    torch.cuda.set_device(local[0])
    init_multihost(f"127.0.0.1:{port}", P14_PROCESSES, rank, backend=backend)
    return make_mesh(devices=local, group=dist.group.WORLD)


def p14_leave(q, rank, rec, payload):
    """Release the parent's shared tensors, leave the group and hand the
    record to the parent; no `seesaw_tpu` module, jax, flax or optax may
    have been imported."""
    import gc

    import torch
    import torch.distributed as dist

    from seesaw_tpu_torch.parallel.multihost import shutdown_multihost

    payload.clear()
    gc.collect()
    torch.cuda.synchronize()
    dist.barrier()
    shutdown_multihost()
    rec["imported"] = [m for m in sys.modules if m in ("jax", "flax", "optax")
                       or m == "seesaw_tpu" or m.startswith("seesaw_tpu.")]
    q.put((rank, rec))


class CollectiveClock:
    """Host ms inside the process mesh's collectives (`parallel.mesh`'s
    gather and reduce, the results' landing, and the ring step), each
    bracketed by synchronizes, so that waiting for earlier kernels is not
    counted; patched in for a `with` block. The synchronizes slow the run
    they clock, so phase 14 clocks a pass of its own (`p14_clocked`) and
    keeps the times of a pass without the clock."""

    def __init__(self, modules_and_names):
        self.targets = modules_and_names
        self.ms = 0.0

    def __enter__(self):
        import torch

        self.saved = []
        for mod, name in self.targets:
            fn = getattr(mod, name)
            self.saved.append((mod, name, fn))

            def timed(*a, _fn=fn, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                torch.cuda.synchronize()
                self.ms += (time.perf_counter() - t0) * 1e3
                return out

            setattr(mod, name, timed)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def p14_clocked(run, targets=None):
    """`run(clock)` again, inside a CollectiveClock (by default over
    `parallel.mesh`'s gather, reduce and landing): the pass that measures
    the collectives' ms. The kernels it launches are not the main path's:
    the launch counters are put back after it."""
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops import spmv
    from seesaw_tpu_torch.parallel import mesh as M

    saved = fs.fused_frame_max.launches, spmv.knn_spmv.launches
    with CollectiveClock(targets or [(M, "_gathered"), (M, "_reduced"), (M, "_land")]) as clock:
        out = run(clock)
    fs.fused_frame_max.launches, spmv.knn_spmv.launches = saved
    return out


def p14_queries(m_idx, meta, mesh, clock=None) -> dict:
    """13a's query sequence (the same seeds, the same rebuild jump) over
    the process mesh: each query's dbidxs and scores and host ms (ending in
    a sync); with a `clock`, the collectives' ms and their share."""
    from seesaw_tpu_torch.runtime.bitmap import BitMap

    rng = np.random.default_rng(13)
    ex, ms, results = BitMap(), [], []
    for i in range(MESH_QUERIES):
        if i == MESH_REBUILD_AT:
            ex.update(rng.choice(meta.frame_dbidx, MESH_REBUILD_FRAMES, replace=False))
        q = rng.normal(size=DIM).astype(np.float32)
        sync_mesh(mesh)
        t0 = time.perf_counter()
        got = m_idx.query(vector=q, topk=BATCH, shortlist_size=SHORTLIST, exclude=ex)
        sync_mesh(mesh)
        ms.append((time.perf_counter() - t0) * 1e3)
        results.append((got["dbidxs"].tolist(), [x["score"] for x in got["activations"]]))
        ex.update(got["dbidxs"])
    out = {"results": results, "p50_ms": float(np.median(ms)), "ms": ms}
    if clock is not None:
        out.update(collectives_ms=clock.ms, collectives_share=clock.ms / sum(ms))
    return out


def p14_tie(m_idx, mesh, tie) -> tuple:
    """13a's planted cutoff tie: the process holding frame t's shard copies
    frame c's rows (and scales) into it, every process queries, and the
    rows are restored (on one card the shard is a view of the parent's
    index). Returns 13a's tie query's (dbidxs, scores)."""
    import torch
    import torch.distributed as dist

    sh = m_idx._sharded
    T, Fs = sh.tile_bound, sh.n_frames_local
    j = tie["t"] // Fs - mesh.local_shards.start
    lt = slice((tie["t"] % Fs) * T, (tie["t"] % Fs + 1) * T)
    mine = 0 <= j < len(sh.V)
    if mine:
        saved = (sh.V[j][lt].clone(), sh.row_scale[j][lt].clone())
        sh.V[j][lt] = tie["rows"].to(sh.V[j].device)
        sh.row_scale[j][lt] = tie["scale"].to(sh.V[j].device)
    torch.cuda.synchronize()
    dist.barrier()
    try:
        q = np.random.default_rng(131).normal(size=DIM).astype(np.float32)
        got = m_idx.query(vector=q, topk=SHORTLIST, shortlist_size=SHORTLIST)
    finally:
        if mine:
            sh.V[j][lt], sh.row_scale[j][lt] = saved
        torch.cuda.synchronize()
        dist.barrier()
    return got["dbidxs"].tolist(), [x["score"] for x in got["activations"]]


def p14_batch(m_idx, mesh, batch) -> dict:
    """13b's Q = 16 batch program over the process mesh on 13b's inputs:
    ids and scores against 13b's, host ms of a dispatch (p50 of 5)."""
    import torch

    from seesaw_tpu_torch.parallel.sharded_index import sharded_query_batch_program

    sh = m_idx._sharded
    qs = batch["qs"]
    none = torch.full((qs.shape[0], 1), -1, dtype=torch.int64, device=mesh.primary)
    ms = []
    for _ in range(5):
        sync_mesh(mesh)
        t0 = time.perf_counter()
        res = sharded_query_batch_program(sh, qs, mesh_masks(sh, batch["excl"]), none,
                                          shortlist_size=SHORTLIST, topk=TOPK)[0]
        sync_mesh(mesh)
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"Q": int(qs.shape[0]), "dispatch_p50_ms": float(np.median(ms)), "dispatch_ms": ms,
            "ids_equal": torch.equal(res.frame_ids.to(qs.device), batch["frame_ids"]),
            "scores_equal": torch.equal(res.frame_scores.to(qs.device), batch["frame_scores"])}


def p14_knnprop(m_idx, mesh, meta, graph, ref, clock=None) -> dict:
    """13c's knn_prop2 rounds, cold then warm, over the process mesh from
    13c's base scores and clicks: each round's dbidxs, and each propagating
    round's steps, done and scores, against 13c's; ms a round, and with a
    `clock` the collectives' ms in it and their share."""
    import torch

    from seesaw_tpu_torch.knn_graph import SymmetricWeights
    from seesaw_tpu_torch.loops.knn_methods import LabelPropagationRanker2
    from seesaw_tpu_torch.runtime.bitmap import BitMap
    from seesaw_tpu_torch.utils import rounds as R

    weights = SymmetricWeights(nbr=graph["nbr"], w=graph["w"], degree=graph["degree"])
    want = iter(ref["rounds"])
    rounds = []
    for warm in (False, True):
        r_mesh = LabelPropagationRanker2(weights=weights, mesh=mesh, warm_start=warm,
                                         **R.KNNPROP_OPTIONS)
        r_mesh.set_base_scores(ref["base"])
        rng = np.random.default_rng(16)
        ret = BitMap()
        for r in range(MESH_ROUNDS):
            w = next(want)
            prev, before = r_mesh.last_result, clock.ms if clock is not None else 0.0
            sync_mesh(mesh)
            t0 = time.perf_counter()
            res = m_idx.rank_by_scores(r_mesh.current_scores_any(), topk=BATCH,
                                       shortlist_size=SHORTLIST, exclude=ret)
            sync_mesh(mesh)
            got = res["dbidxs"].tolist()
            rec = {"warm": warm, "round_ms": (time.perf_counter() - t0) * 1e3,
                   "dbidxs_equal": got == w["dbidxs"]}
            if clock is not None:
                rec["collectives_ms"] = clock.ms - before
            pm = r_mesh.last_result
            if (pm is not prev) != ("scores" in w):
                raise AssertionError(f"14b round {r} (warm={warm}): propagated "
                                     f"{pm is not prev}, 13c {'scores' in w}")
            if pm is not prev:
                rec.update(steps=pm.n_iter, done=pm.converged,
                           steps_equal=(pm.n_iter, pm.converged) == (w["steps"], w["done"]),
                           scores_equal=torch.equal(r_mesh._current_scores.to(
                               w["scores"].device), w["scores"]))
            rounds.append(rec)
            ret.update(got)
            rows = meta.frame_starts[np.searchsorted(meta.frame_dbidx, got)]
            r_mesh.update(rows, (rng.random(len(rows)) < 0.3).astype(np.float64))
    prop = [x for x in rounds if "steps" in x]
    out = {"rounds": rounds, "propagating_round_ms": [x["round_ms"] for x in prop],
           "propagating_round_p50_ms": float(np.median([x["round_ms"] for x in prop]))}
    if clock is not None:
        out["collectives_share"] = (sum(x["collectives_ms"] for x in prop)
                                    / sum(x["round_ms"] for x in prop))
    return out


def p14_serving_child(rank, port, backend, devices, payload, q):
    """Phase 14a-b in one process of the mesh: 13a's queries over the bf16
    and the int8 index (each process holding its shards' slices: views of
    the parent's matrix on one card), 13b's batch, 13c's rounds, then 13a's
    tie; each kernel's launches in this process. The queries and the rounds
    run once for their times and once more clocked (`p14_clocked`)."""
    mesh = p14_join(rank, port, backend, devices)
    from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex
    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.ops import spmv
    from seesaw_tpu_torch.utils import rounds as R

    meta = R.uniform_meta(N_VECTORS // TILES)  # device_index's layout
    rec = {"rank": rank, "shards": list(mesh.local_shards),
           "devices": [str(d) for d in mesh.devices]}
    fs.fused_frame_max.launches = spmv.knn_spmv.launches = 0
    indexes = {}
    for name in ("bfloat16", "int8"):
        indexes[name] = MultiscaleIndex.from_device_arrays(embedding=None, meta=meta, mesh=mesh,
                                                           **payload[name])
        rec[f"queries_{name}"] = p14_queries(indexes[name], meta, mesh)
        rec[f"queries_{name}_clocked"] = p14_clocked(
            lambda clock: p14_queries(indexes[name], meta, mesh, clock))
    del indexes["bfloat16"]
    rec["batch"] = p14_batch(indexes["int8"], mesh, payload["batch"])
    args = (indexes["int8"], mesh, meta, payload["graph"], payload["knn_prop2"])
    rec["knn_prop2"] = p14_knnprop(*args)
    rec["knn_prop2_clocked"] = p14_clocked(lambda clock: p14_knnprop(*args, clock))
    rec["tie"] = p14_tie(indexes["int8"], mesh, payload["tie"])
    rec["launches"] = {"fused_frame_max": fs.fused_frame_max.launches,
                       "knn_spmv": spmv.knn_spmv.launches}
    del indexes
    p14_leave(q, rank, rec, payload)


def p14_knn_child(rank, port, backend, devices, payload, q):
    """Phase 14c in one process of the mesh: 13d's ring kNN build over
    13d's rows, against 13d's ids and distances; seconds, and in a second,
    clocked build the collectives' (gathers and ring steps) seconds."""
    mesh = p14_join(rank, port, backend, devices)
    from seesaw_tpu_torch.parallel import mesh as M
    from seesaw_tpu_torch.parallel import sharded_graph as tsg

    X = payload["X"]

    def build():
        sync_mesh(mesh)
        t0 = time.perf_counter()
        ids, d = tsg.sharded_exact_knn(X, MESH_KNN_K, mesh)
        sync_mesh(mesh)
        return {"seconds": time.perf_counter() - t0,
                "ids_equal": bool(np.array_equal(ids, payload["ids"].numpy())),
                "max_dist_diff": float(np.abs(d - payload["dist"].numpy()).max())}

    rec = {"rank": rank, "rows": int(X.shape[0]), "k": MESH_KNN_K, **build()}
    clocked = p14_clocked(lambda clock: {**build(), "collectives_s": clock.ms / 1e3},
                          [(M, "_gathered"), (tsg, "rotate")])
    rec["clocked"] = clocked
    rec["collectives_s"] = clocked["collectives_s"]
    del X
    p14_leave(q, rank, rec, payload)


def p14_check_serving(recs, ref, backend):
    """Every process's 14a-b results against 13a-c's: bit-equal."""
    for rec in recs:
        r = rec["rank"]
        if rec["imported"]:
            raise AssertionError(f"14 rank {r} imported {rec['imported']}")
        for name in ("bfloat16", "int8"):
            for key in (f"queries_{name}", f"queries_{name}_clocked"):
                if rec[key]["results"] != ref[f"queries_{name}"]:
                    raise AssertionError(f"14a {key} over {backend}, rank {r}: the queries "
                                         f"differ from 13a's")
        if tuple(rec["tie"]) != tuple(ref["tie_results"]):
            raise AssertionError(f"14a tie over {backend}, rank {r}: {rec['tie']} != 13a's "
                                 f"{ref['tie_results']}")
        if not (rec["batch"]["ids_equal"] and rec["batch"]["scores_equal"]):
            raise AssertionError(f"14a batch over {backend}, rank {r}: differs from 13b's")
        for key in ("knn_prop2", "knn_prop2_clocked"):
            for i, x in enumerate(rec[key]["rounds"]):
                if not (x["dbidxs_equal"] and x.get("steps_equal", True)
                        and x.get("scores_equal", True)):
                    raise AssertionError(f"14b {key} round {i} over {backend}, rank {r}: {x} "
                                         f"differs from 13c's")
        k1 = P14_LOCAL * (2 * MESH_QUERIES + 1)  # one a local shard a solo query
        if rec["launches"]["fused_frame_max"] != k1:
            raise AssertionError(f"14a rank {r}: {rec['launches']['fused_frame_max']} K1 "
                                 f"launches, not {k1}")
    spmv_total = sum(rec["launches"]["knn_spmv"] for rec in recs)
    if spmv_total != ref["knn_prop2_launches"]:
        raise AssertionError(f"14b: {spmv_total} knn_spmv launches, 13c's mesh "
                             f"{ref['knn_prop2_launches']}")


def process_mesh_serving(idx, weights, ref, card) -> dict:
    """Phase 14a-b, right after 13a-c: 13a's queries over the bf16 and the
    int8 index with 13a's tie, 13b's batch and 13c's rounds, over a mesh of
    P14_PROCESSES processes x P14_LOCAL shards; each held bit-equal to
    13a-c. Returns each run's figures and each process's launches."""
    import torch

    T = idx._tile_bound
    c, t = ref["tie"]

    def arrays(ix):
        return dict(V=ix._V, valid=ix._valid, boxes=ix._boxes, zoom=ix._zoom,
                    row_scale=ix._row_scale, frame_scale=ix._frame_scale)

    payload = {"bfloat16": arrays(ref["bf16"]), "int8": arrays(idx),
               "tie": {"c": c, "t": t, "rows": idx._V[c * T:(c + 1) * T].clone(),
                       "scale": idx._row_scale[c * T:(c + 1) * T].clone()},
               "batch": ref["batch"],
               "graph": {"nbr": weights.nbr, "w": weights.w, "degree": weights.degree},
               "knn_prop2": ref["knn_prop2"]}
    torch.cuda.synchronize()
    out = {}
    for backend, devices in p14_runs():
        t0 = time.perf_counter()
        recs = p14_spawn(p14_serving_child, backend, devices, payload)
        p14_check_serving(recs, ref, backend)
        run = {"processes": P14_PROCESSES, "shards_a_process": P14_LOCAL,
               "devices": [x["devices"] for x in recs], "seconds": time.perf_counter() - t0}
        for name in ("bfloat16", "int8"):
            for key in (f"queries_{name}", f"queries_{name}_clocked"):
                run[key] = [{f: v for f, v in x[key].items() if f != "results"} for x in recs]
        run["batch"] = [x["batch"] for x in recs]
        run["knn_prop2"] = [x["knn_prop2"] for x in recs]
        run["knn_prop2_clocked"] = [x["knn_prop2_clocked"] for x in recs]
        run["launches"] = [x["launches"] for x in recs]
        log(f"[{card}] 14a-b over {backend}, {P14_PROCESSES} processes x {P14_LOCAL} shards: "
            f"bit-equal to 13a-c; {json.dumps(run)}")
        out[backend] = run
    if "nccl" not in out:
        log(f"phase 14 over NCCL not run: {torch.cuda.device_count()} card(s), and NCCL refuses "
            f"two ranks on one GPU")
    return out


def p14_summary(card, m13, o13, s14, o14) -> dict:
    """Phase 14's figures beside phase 13's: the same work over 2 processes
    x 2 shards and over 4 shards in one process, on the same card. The
    times come from the passes without the clock; the collectives' share,
    and the clocked pass's own time, from the clocked pass."""
    prop13 = m13["knn_prop2"]["cold"]["propagating_round_ms"] + \
        m13["knn_prop2"]["warm"]["propagating_round_ms"]
    out = {"card": card}
    for name, key in (("bfloat16", "queries_bfloat16"), ("int8", "queries_int8")):
        out[f"query_p50_ms_{name}"] = {
            "in_process": m13[key]["sharded_p50_ms"],
            "processes": [r["p50_ms"] for r in s14[key]],
            "clocked_pass": [r["p50_ms"] for r in s14[f"{key}_clocked"]],
            "collectives_share": [r["collectives_share"] for r in s14[f"{key}_clocked"]]}
    out["batch_dispatch_ms"] = {"in_process": m13["batch"]["dispatch_ms"],
                                "processes": [r["dispatch_p50_ms"] for r in s14["batch"]]}
    out["propagating_round_p50_ms"] = {
        "in_process": float(np.median(prop13)),
        "processes": [r["propagating_round_p50_ms"] for r in s14["knn_prop2"]],
        "clocked_pass": [r["propagating_round_p50_ms"] for r in s14["knn_prop2_clocked"]],
        "collectives_share": [r["collectives_share"] for r in s14["knn_prop2_clocked"]]}
    out["ring_knn_s"] = {"in_process": o13["knn"]["sharded_s"],
                         "processes": [r["seconds"] for r in o14["knn"]],
                         "clocked_pass": [r["clocked"]["seconds"] for r in o14["knn"]],
                         "collectives_s": [r["collectives_s"] for r in o14["knn"]]}
    out["dryrun_processes_s"] = o14["dryrun"]["seconds"]
    out["phase_14_s"] = s14["seconds"] + o14["seconds"]
    return out


def process_mesh_offline(knn_ref, loss_13f, card) -> dict:
    """Phase 14c-d, after 13d-g: 13d's ring kNN build over the process mesh
    (ids equal to 13d's), then `python -m seesaw_tpu_torch.parallel.dryrun
    --processes 2` (parts (a)-(e) as SPMD programs; the fine-tune step's
    loss and parameters within 2e-4 of 13f's)."""
    import torch

    payload = {"X": knn_ref["X"], "ids": torch.from_numpy(knn_ref["ids"]),
               "dist": torch.from_numpy(knn_ref["dist"])}
    out = {}
    for backend, devices in p14_runs():
        t0 = time.perf_counter()
        recs = p14_spawn(p14_knn_child, backend, devices, payload)
        for rec in recs:
            if rec["imported"] or any(not x["ids_equal"] or x["max_dist_diff"] > KNN_TOL
                                      for x in (rec, rec["clocked"])):
                raise AssertionError(f"14c over {backend}: {rec}")
        log(f"[{card}] 14c ring kNN over {backend}, {P14_PROCESSES} processes x {P14_LOCAL} "
            f"shards: ids equal to 13d's; {json.dumps(recs)}")
        dry = p14_dryrun(backend, loss_13f, card)
        out[backend] = {"knn": recs, "dryrun": dry, "seconds": time.perf_counter() - t0}
    return out


def p14_dryrun(backend, loss_13f, card) -> dict:
    """14d: the dry run's own launcher, 2 processes x 2 shards on the
    card(s); part (b)'s loss and stepped parameters against 13f's."""
    import subprocess

    params = P14_DIR / f"dryrun_14d_{backend}.npz"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "seesaw_tpu_torch.parallel.dryrun", "--processes",
         str(P14_PROCESSES), "--devices-per-process", str(P14_LOCAL), "--device", "cuda",
         "--backend", backend, "--params-out", str(params)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"14d over {backend} exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    ranks = json.loads(proc.stdout.strip().splitlines()[-1])["dryrun"]["ranks"]
    with np.load(P14_DIR / "dryrun_13f.npz") as a, np.load(params) as b:
        if a.files != b.files:
            raise AssertionError("14d: the stepped parameters' names differ from 13f's")
        err = max(float(np.abs(a[k] - b[k]).max()) for k in a.files)
    losses = [r["b_finetune"]["loss"] for r in ranks]
    rec = {"seconds": secs, "param_max_abs_diff_vs_13f": err, "losses": losses,
           "loss_13f": loss_13f,
           "launches": [{k: sum(r[p]["launches"][k] for p in r if isinstance(r[p], dict)
                                and "launches" in r[p]) for k in r["a_retrieval"]["launches"]}
                        for r in ranks]}
    if err > 2e-4 or len(set(losses)) != 1 or abs(losses[0] - loss_13f) > 2e-4:
        raise AssertionError(f"14d over {backend}: {rec}")
    log(f"[{card}] 14d dryrun --processes {P14_PROCESSES} over {backend}: {json.dumps(rec)}")
    return rec


def traced(run) -> dict:
    """`run()` under torch.profiler: host-clock ms ending in a synchronize,
    the device's busy ms (summed kernel and copy durations, from every
    thread's launches) and the kernels with the most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"traced_wall_ms": wall, "traced_busy_ms": sum(by_name.values()),
            "traced_kernels": [(name[:80], ms) for name, ms in top]}


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
    knn_launches, weights = knnprop_path(idx, dev, gen, card)
    torch.cuda.synchronize()
    # phase 13a-c: the mesh over phase 6's index and graph
    mesh_serving, mesh_serving_launches, mesh_ref = mesh_serving_path(idx, weights, dev, gen,
                                                                      card)
    # phase 14a-b: the same over a mesh that spans processes
    log("phase 14: 2 processes x 2 shards, joined by gloo: NCCL refuses two ranks on one GPU, "
        "so on one card the processes share it and the collectives cross host memory")
    pmesh_serving = process_mesh_serving(idx, weights, mesh_ref, card)
    del weights, mesh_ref
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # phase 11: concurrent serving, over phase 6's index first
    first_cell = batch_cell(idx, "int8 row scales", dev, gen, card)
    del idx
    serving, serving_launches = serving_path(first_cell, dev, gen, card)
    torch.cuda.synchronize()
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
    # phase 10: the offline build
    frames = write_jpegs(ROOT / "build" / "seesaw_tpu_torch" / "ingest_frames", INGEST_IMAGES,
                         seed=0)
    ingest_check = check_ingest_cuda_vs_cpu(dev, clip_params, frames)
    stages = ingest_stage_rates(dev, clip_params, frames)
    log(f"[{card}] ingest stages alone (480 frames 1280x720; encode B={INGEST_BATCH}): {stages}")
    ingest, ingest_launches = ingest_path(dev, card, clip_params, frames)
    knn_scale = knn_build_at_scale(dev, gen, card)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # phase 12: the evaluation path (12e reads phase 10's frames)
    evaluation, study_tables_200k, eval_launches = evaluation_path(dev, card, clip_params,
                                                                   frames)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    # phase 13d-g: the mesh's offline build, extraction, dry run and multihost init
    mesh_offline, mesh_offline_launches, knn_ref = mesh_offline_path(dev, card, clip_params,
                                                                     frames)
    # phase 14c-d: the ring kNN build and the dry run over processes
    pmesh_offline = process_mesh_offline(knn_ref, mesh_offline["dryrun"]["b_finetune"]["loss"],
                                         card)
    del knn_ref
    shutil.rmtree(frames[0].parent, ignore_errors=True)
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
    # phase 10's figures that are no kernel's: each ingest stage alone, the
    # card-vs-CPU tiles, vectors and kNN, and the 1M-row kNN build
    log(json.dumps({"offline_build": {"ingest_stages": stages, "ingest_check": ingest_check,
                                      "knn_build_1M": knn_scale}}))
    # phase 11's figures: the batch programs (a library product, no kernel
    # of the port), concurrent sessions, the servers
    log(json.dumps({"concurrent_serving": serving}))
    # phase 12's figures: the method study, run_bench, research, tools
    log(json.dumps({"method_study_200k_tables": study_tables_200k}))
    log(json.dumps({"evaluation": evaluation}))
    # phase 13's figures; the 4 shards share one card where the mesh line says so
    mesh_dry = mesh_offline_launches["dryrun"]
    # phase 14's: every process's launches, summed for the kernel record
    p14_serve = pmesh_serving["gloo"]["launches"]
    p14_dry = pmesh_offline["gloo"]["dryrun"]["launches"]
    p14 = {k: sum(x[k] for x in p14_serve) for k in ("fused_frame_max", "knn_spmv")}
    p14_d = {k: sum(x[k] for x in p14_dry) for k in p14_dry[0]}
    log(json.dumps({"process_mesh": {"card": card, "serving": pmesh_serving,
                                     "offline": pmesh_offline}}))
    log(json.dumps({"process_mesh_vs_in_process": p14_summary(
        card, mesh_serving, mesh_offline, pmesh_serving["gloo"], pmesh_offline["gloo"])}))
    log(json.dumps({"multi_gpu": {
        "card": card, "serving": mesh_serving, "offline": mesh_offline,
        "launches": {"fused_frame_max": {"mesh_queries": mesh_serving_launches["fused_frame_max"],
                                         "mesh_dryrun": mesh_dry["fused_frame_max"]},
                     "knn_spmv": {"mesh_knn_prop2": mesh_serving_launches["knn_spmv"],
                                  "mesh_dryrun": mesh_dry["knn_spmv"]},
                     "pair_attention": {"mesh_ingest": mesh_offline_launches[
                         "pair_attention_ingest"], "mesh_dryrun": mesh_dry["pair_attention"]},
                     "pair_attention_bwd": {"mesh_dryrun": mesh_dry["pair_attention_bwd"]}}}}))
    log(json.dumps({"kernels": [{
        "name": "fused_frame_max", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/fused_frame_max.cu",
        "replaces": "seesaw_tpu/ops/pallas_scoring.py:43",
        "launches": launches,
        # phase 5 (the main path); 9a's multi_reg sessions; 9b's 10M multi_reg rounds
        "launches_by_path": {"main_path": launches,
                             "feedback_sessions": feedback_launches["fused_frame_max"],
                             "multi_reg_10M": multireg["launches"],
                             "ingest_index_rounds": ingest_launches["fused_frame_max"],
                             # phase 11b's solo scans; 11c's card server
                             "concurrent_sessions":
                                 serving_launches["concurrent_sessions"]["fused_frame_max"],
                             "web_server": serving_launches["web_server"]["fused_frame_max"],
                             # phase 12: every round of the scan loops' study
                             # sessions, the run_bench workers, the traced session
                             **{f"evaluation_{k}": v
                                for k, v in eval_launches["fused_frame_max"].items()},
                             # phase 13a's sharded queries (one a shard), 13f's dry run
                             "mesh_queries": mesh_serving_launches["fused_frame_max"],
                             "mesh_dryrun": mesh_dry["fused_frame_max"],
                             # phase 14a's queries over 2 processes (one a local
                             # shard), 14d's dry run, both processes summed
                             "process_mesh_queries": p14["fused_frame_max"],
                             "process_mesh_dryrun": p14_d["fused_frame_max"]},
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
                             "feedback_sessions": feedback_launches["jacobi_step"],
                             "ingest_graph_rounds": ingest_launches["jacobi_step"],
                             "concurrent_sessions":
                                 serving_launches["concurrent_sessions"]["jacobi_step"],
                             # 11c's knn_prop2 sessions over HTTP
                             "web_server": serving_launches["web_server"]["jacobi_step"],
                             # phase 12: the study's knn_prop2 rounds and pseudo_lr refines
                             **{f"evaluation_{k}": v
                                for k, v in eval_launches["jacobi_step"].items()},
                             # phase 13c's mesh rounds (knn_spmv, one a shard a
                             # step) and 13f's dry run
                             "mesh_knn_prop2": mesh_serving_launches["knn_spmv"],
                             "mesh_dryrun": mesh_dry["knn_spmv"],
                             # phase 14b's rounds over 2 processes, 14d's dry run
                             "process_mesh_knn_prop2": p14["knn_spmv"],
                             "process_mesh_dryrun": p14_d["knn_spmv"]},
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
                             "finetune": ft_fwd_launches["float32"],
                             "ingest": ingest_launches["float32"],
                             # 11c's first /text on the card's server
                             "web_server": serving_launches["web_server"]["pair_attention"],
                             # 12e: 12 a crop batch
                             "evaluation_extract_gt_vectors":
                                 eval_launches["pair_attention"]["extract_gt_vectors"],
                             # 13e's data-parallel extraction (12 a shard slice);
                             # 13f's dry run (its text and vision towers)
                             "mesh_ingest": mesh_offline_launches["pair_attention_ingest"],
                             "mesh_dryrun": mesh_dry["pair_attention"],
                             # 14d's dry run over 2 processes
                             "process_mesh_dryrun": p14_d["pair_attention"]},
        "max_abs_err": max(r["max_abs_err"] for r in f32_fwd),
        # at the main path's shape (the text query: B=1, L=77, W=512, causal)
        **{k: text_query[k] for k in timing},
        "text_encode_p50_ms": text_p50,
        "cases": f32_fwd, "vision_vit_b32": vision,
        "ingest_vit_b32": ingest["float32"],
    }, {
        "name": "pair_attention_bf16", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/pair_attention_bf16.cu",
        "replaces": "seesaw_tpu/ops/pallas_attention.py:91",
        # bf16 on the tensor cores: phase 8c's bf16 steps (24 a step) and the
        # bf16 vision forwards of 7d
        "launches": ft_fwd_launches["bfloat16"],
        "launches_by_path": {"vision_encode": vision_launches["bfloat16"],
                             "finetune": ft_fwd_launches["bfloat16"],
                             "ingest": ingest_launches["bfloat16"]},
        "max_abs_err": max(r["max_abs_err"] for r in bf16_fwd),
        "max_ulps": max(r["max_ulps"] for r in bf16_fwd),
        "share_differing": max(r["share_differing"] for r in bf16_fwd),
        **{k: vit_fwd16[k] for k in timing},
        "cases": bf16_fwd, "ingest_vit_b32": ingest["bfloat16"],
    }, {
        "name": "pair_attention_bwd", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/pair_attention.cu",
        "replaces": "seesaw_tpu/ops/pallas_attention.py:115",
        # f32 by the 3xTF32 split: phase 8c's f32 steps, 24 a step (12 vision,
        # 12 text layers)
        "launches": ft_bwd_launches["float32"],
        # 13f's data-parallel fine-tune step (the text tower's 2 layers a shard)
        "launches_by_path": {"finetune": ft_bwd_launches["float32"],
                             "mesh_dryrun": mesh_dry["pair_attention_bwd"],
                             # 14d's data-parallel step over 2 processes
                             "process_mesh_dryrun": p14_d["pair_attention_bwd"]},
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
