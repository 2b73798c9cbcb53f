#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`seesaw_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device check: a CUDA device must be present; TF32 is switched off.
2. build the fused frame-max kernel from `seesaw_tpu_torch/csrc` with nvcc.
3. kernel vs its plain PyTorch version on the card: f32, bf16 and int8 with
   per-row scales, at a small ragged shape and at the main path's shape
   (10M rows = 1.25M frames x 8 tiles x 512 dims), with CUDA-event times.
4. port sessions (plain, rocchio_update, log_reg2) on the card against the
   same sessions on the CPU, on a small synthetic root: same dbidxs every
   round.
5. the main path at deployment scale, as the JAX package's bench drives it
   (bench.py bench_session_rounds): 10M x 512 bf16 vectors made on the
   device from a seed, `MultiscaleIndex.from_device_arrays`, rocchio_update
   and log_reg2 sessions (batch 3, shortlist 50, a simulated user accepting
   ~30%), then a shorter rocchio_update session on int8 storage with
   per-row scales. The kernel's launch counter must rise every round.

The line before the last is the kernel record (JSON); the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

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


def log(msg: str):
    print(msg, flush=True)


def cuda_ms(fn, args_list) -> float:
    """Mean ms per call over the argument list, by CUDA events."""
    import torch

    fn(*args_list[0])  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args_list)


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
                read = int(valid.sum()) * D * V.element_size()
                gbs = read / (k_ms * 1e-3) / 1e9
                line += f" kernel_ms={k_ms!r} plain_ms={p_ms!r} kernel_GB/s={gbs!r}"
                records.append(dict(dtype=dtype, ms=k_ms, plain_ms=p_ms, gbs=gbs))
            log(line)
            del V, valid, excluded, rs
            torch.cuda.empty_cache()
    return records, worst


# -- phase 4 -----------------------------------------------------------------
def write_synthetic_root(root: Path, n_images=80, d=32, seed=0):
    """A planted multiscale index in the on-disk format both packages read
    (vectors.npz + info.json), like tests/synth.py: positives hold a tile
    near the text query's hash embedding."""
    from seesaw_tpu_torch import GlobalDataManager, HashEmbedding

    rng = np.random.default_rng(seed)
    qvec = HashEmbedding(d=d).from_string(string="a dog")
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
        "model": f"hash-{d}", "excluded": [],
    }))
    return gdm, gt


def small_session_rounds(gdm, gt, method, device, rounds=6):
    from seesaw_tpu_torch import Box, IndexSpec, SessionParams, make_session

    opts = {
        "plain": {},
        "rocchio_update": dict(rocchio_alpha=1.0, rocchio_beta=0.7, rocchio_gamma=0.3),
        "log_reg2": dict(class_weights="balanced", scale="centered", reg_lambda=5.0,
                         fit_intercept=False, max_iter=50),
    }[method]
    p = SessionParams(index_spec=IndexSpec(d_name="smoke", i_name="multiscale"),
                      interactive=method, batch_size=BATCH, shortlist_size=20,
                      interactive_options=opts, index_options={"use_pallas": True})
    s = make_session(gdm, p, device=device)["session"]
    s.set_text("a dog")
    out = []
    for _ in range(rounds):
        out.append([int(i) for i in s.next()])
        state = s.get_state()
        for im in state.gdata[-1]:
            b = gt.get(im.dbidx)
            im.boxes = ([Box(x1=b[0], y1=b[1], x2=b[2], y2=b[3], marked_accepted=True)]
                        if b is not None else [])
        s.update_state(state)
        s.refine()
    scores = [a["score"] for acts in s.acc_activations for a in acts]
    return out, np.array(scores, np.float32)


def check_sessions_cuda_vs_cpu():
    import torch

    from seesaw_tpu_torch.ops import fused_scoring as fs

    root = ROOT / "build" / "seesaw_tpu_torch" / "smoke_root"
    shutil.rmtree(root, ignore_errors=True)
    gdm, gt = write_synthetic_root(root)
    for method in ("plain", "rocchio_update", "log_reg2"):
        before = fs.fused_frame_max.launches
        on_gpu, s_gpu = small_session_rounds(gdm, gt, method, torch.device("cuda"))
        torch.cuda.synchronize()
        if fs.fused_frame_max.launches - before < len(on_gpu):
            raise AssertionError(f"{method}: the CUDA session did not launch the kernel")
        on_cpu, s_cpu = small_session_rounds(gdm, gt, method, torch.device("cpu"))
        if on_gpu != on_cpu:
            raise AssertionError(f"{method}: cuda {on_gpu} != cpu {on_cpu}")
        err = float(np.abs(s_gpu - s_cpu).max())
        log(f"session {method}: cuda == cpu dbidxs over {len(on_gpu)} rounds; "
            f"max activation score diff {err!r}")
    shutil.rmtree(root, ignore_errors=True)


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


def main_path(dev, gen, card):
    import torch

    from seesaw_tpu_torch.ops import fused_scoring as fs
    from seesaw_tpu_torch.utils import rounds as R

    rocchio, logreg = (R.session_params(m, batch_size=BATCH, shortlist_size=SHORTLIST)
                       for m in ("rocchio_update", "log_reg2"))
    rng = np.random.default_rng(0)
    idx = R.device_index(N_VECTORS, DIM, "bfloat16", device=dev, generator=gen)
    check_main_query(idx)
    log("main query: kernel path == plain full-score path (bf16, 10M rows)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fs.fused_frame_max.launches = 0  # count only the main path's launches
    for name, params, rounds, dtype in (
        ("rocchio_update bf16", rocchio, 10, "bfloat16"),
        ("log_reg2 bf16", logreg, 10, "bfloat16"),
        ("rocchio_update int8", rocchio, 6, "int8"),
    ):
        if dtype == "int8" and idx.device_dtype != "int8":
            del idx
            torch.cuda.empty_cache()
            idx = R.device_index(N_VECTORS, DIM, "int8", device=dev, generator=gen)
        next_ms, round_ms, syncs = R.drive_session(idx, params, rounds, rng)
        torch.cuda.synchronize()
        # round 0 is the text query (no feedback yet); p50 over rounds 1..
        p50n, p50r = float(np.median(next_ms[1:])), float(np.median(round_ms[1:]))
        line = (f"[{card}] {name}: rounds={rounds} p50_session_next_ms={p50n!r} "
                f"p50_round_ms={p50r!r} round0_ms={round_ms[0]!r}")
        if syncs:
            line += f" lbfgs_host_syncs_per_round={syncs}"
        log(line)
    launches = fs.fused_frame_max.launches
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{card}] main path: kernel launches={launches} peak device memory GB={peak!r}")
    if launches < 26:
        raise AssertionError(f"only {launches} kernel launches in 26 rounds")
    return launches


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
    _build.load_library("fused_frame_max")
    log(f"build fused_frame_max: {time.perf_counter() - t0!r} s "
        f"(nvcc {_build.build_seconds.get('fused_frame_max', 0.0)!r} s)")

    gen = torch.Generator(device=dev).manual_seed(0)
    scan, worst = check_scan(dev, gen)
    torch.cuda.synchronize()
    check_sessions_cuda_vs_cpu()
    torch.cuda.synchronize()
    launches = main_path(dev, gen, card)
    torch.cuda.synchronize()
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    bf16 = next(r for r in scan if r["dtype"] == "bfloat16")
    log(json.dumps({"kernels": [{
        "name": "fused_frame_max", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/fused_frame_max.cu",
        "replaces": "seesaw_tpu/ops/pallas_scoring.py:43",
        "launches": launches, "max_abs_err": worst,
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
