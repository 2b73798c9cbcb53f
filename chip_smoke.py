#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`seesaw_tpu_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. device check: a CUDA device must be present; TF32 is switched off.
2. build the kernels from `seesaw_tpu_torch/csrc` with nvcc, one process
   per source, started together: the fused frame-max scan and the kNN
   SpMV / Jacobi step.
3. each kernel vs its plain PyTorch version on the card, with CUDA-event
   times (kernel and plain version alternated) and the time of the nearest
   single PyTorch call:
   a. frame max: f32, bf16 and int8 with per-row scales, at a small ragged
      shape and at the main path's shape (10M rows = 1.25M frames x 8 tiles
      x 512 dims); library call `torch.mv`;
   b. kNN SpMV and Jacobi step: a small ragged graph (N=3001, Kp=13, -1
      padding, a hub, labeled and isolated rows) and the main path's graph
      (10M x 32, window-local, `rounds.window_local_graph`); the Jacobi step
      in both modes (running, and done: the output must stay untouched);
      library call `torch.sparse.mm` on a CSR tensor of the same graph.
4. port sessions on the card against the same sessions on the CPU, on a
   small synthetic root: plain, rocchio_update and log_reg2, then knn_prop2
   over a k=5 graph saved beside the index; same dbidxs every round, and the
   kernels launched every round (knn_prop2: every feedback round).
5. the per-click main path at deployment scale, as the JAX package's bench
   drives it (bench.py bench_session_rounds): 10M x 512 bf16 vectors made on
   the device from a seed, `MultiscaleIndex.from_device_arrays`,
   rocchio_update and log_reg2 sessions (batch 3, shortlist 50, a simulated
   user accepting ~30%), then a shorter rocchio_update session on int8
   storage with per-row scales. The scan kernel's launch counter must rise
   every round.
6. the KnnProp2 graph round at deployment scale (bench.py bench_graph_10M):
   phase 5's int8 index, a 10M x 32 window-local graph made on the device,
   8 rounds of rank -> labels -> update with the configured ranker, then 8
   with warm_start. The Jacobi kernel's launch counter must rise every round
   after round 0, and each round reads the host once per segment.

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
# kNN SpMV / Jacobi step vs plain version: f32 sums of Kp products in
# another order (the JAX package's bar between its windowed and dense SpMV)
SPMV_TOL = dict(rtol=2e-5, atol=2e-6)
GRAPH_K = 32  # bench.py bench_graph_10M
# data-sheet peaks of one H100 SXM at 700 W: HBM bytes/s, and operations/s by
# input type (f32 outside the tensor cores; bf16 and int8 dense tensor rates)
PEAK_BYTES = 3.35e12
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}


def bound(n_bytes: float, n_ops: float, dtype: str):
    """(least ms the card could take, what bounds it)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


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
        f" jacobi_plain_ms={jp_ms!r} jacobi_bound_ms={jb_ms!r}")
    return dict(max_abs_err=worst, ms=k_ms, plain_ms=p_ms, library_ms=lib_ms,
                bound_ms=b_ms, bound_by=b_by, gbs=gbs, jacobi_ms=j_ms,
                jacobi_plain_ms=jp_ms, jacobi_bound_ms=jb_ms)


def check_spmv(dev, gen):
    import torch

    from seesaw_tpu_torch.utils import rounds as R

    small = check_spmv_case("small ragged", *small_graph(dev, gen), gen, timed=False)
    g = R.window_local_graph(N_VECTORS, GRAPH_K, dev, gen)
    rec = check_spmv_case("main window-local", g.nbr, g.w, g.degree, gen, timed=True)
    del g
    torch.cuda.empty_cache()
    rec["max_abs_err"] = max(rec["max_abs_err"], small["max_abs_err"])
    return rec


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
    save_knn_graph(np.stack(vecs), path / "knn_graph", k=5)
    return gdm, gt


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


def small_session_rounds(gdm, gt, method, device, rounds=6):
    """Returns the dbidxs of each round, all activation scores, and for each
    round whether its ranking ran a staged propagation (knn_prop2) and how
    many Jacobi kernel launches it made."""
    from seesaw_tpu_torch import Box, IndexSpec, SessionParams, make_session
    from seesaw_tpu_torch.ops import spmv
    from seesaw_tpu_torch.ops.propagation import DeferredPropagation

    opts = SESSION_OPTIONS[method]
    p = SessionParams(index_spec=IndexSpec(d_name="smoke", i_name="multiscale"),
                      interactive=method, batch_size=BATCH, shortlist_size=20,
                      interactive_options=opts, index_options={"use_pallas": True})
    s = make_session(gdm, p, device=device)["session"]
    s.set_text("a dog")
    out, graph_rounds = [], []
    for _ in range(rounds):
        model = s.loop.state.knn_model
        staged = model is not None and isinstance(model.current_scores_any(),
                                                  DeferredPropagation)
        before = spmv.jacobi_step.launches
        out.append([int(i) for i in s.next()])
        graph_rounds.append((staged, spmv.jacobi_step.launches - before))
        state = s.get_state()
        for im in state.gdata[-1]:
            b = gt.get(im.dbidx)
            im.boxes = ([Box(x1=b[0], y1=b[1], x2=b[2], y2=b[3], marked_accepted=True)]
                        if b is not None else [])
        s.update_state(state)
        s.refine()
    scores = [a["score"] for acts in s.acc_activations for a in acts]
    return out, np.array(scores, np.float32), graph_rounds


def check_sessions_cuda_vs_cpu():
    import torch

    from seesaw_tpu_torch.ops import fused_scoring as fs

    root = ROOT / "build" / "seesaw_tpu_torch" / "smoke_root"
    shutil.rmtree(root, ignore_errors=True)
    gdm, gt = write_synthetic_root(root)
    for method in ("plain", "rocchio_update", "log_reg2", "knn_prop2"):
        before = fs.fused_frame_max.launches
        on_gpu, s_gpu, graph = small_session_rounds(gdm, gt, method, torch.device("cuda"))
        torch.cuda.synchronize()
        if method == "knn_prop2":  # the scan is not on the graph round
            feedback = [n for staged, n in graph if staged]
            if not feedback or min(feedback) == 0:
                raise AssertionError(f"knn_prop2: Jacobi launches per feedback round {graph}")
        elif fs.fused_frame_max.launches - before < len(on_gpu):
            raise AssertionError(f"{method}: the CUDA session did not launch the kernel")
        on_cpu, s_cpu, _ = small_session_rounds(gdm, gt, method, torch.device("cpu"))
        if on_gpu != on_cpu:
            raise AssertionError(f"{method}: cuda {on_gpu} != cpu {on_cpu}")
        err = float(np.abs(s_gpu - s_cpu).max())
        log(f"session {method}: cuda == cpu dbidxs over {len(on_gpu)} rounds; "
            f"max activation score diff {err!r}"
            + (f"; (staged, Jacobi launches) per round {graph}" if method == "knn_prop2" else ""))
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
    return launches, idx


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
        # round 0 ranks the text prior; the first fused round warms the
        # allocator: p50 over rounds 2..
        p50 = float(np.median(out["round_ms"][2:]))
        log(f"[{card}] {name} {idx.meta.n_vectors}x{GRAPH_K} graph, {idx.device_dtype} "
            f"index: rounds={rounds} p50_round_ms={p50!r} round_ms={out['round_ms']} "
            f"jacobi_iters_per_round={out['iters']} host_reads_per_round={out['host_reads']}"
            f" jacobi_launches_per_round={out['launches']} "
            f"launches={spmv.jacobi_step.launches - before}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    launches = {"knn_spmv": spmv.knn_spmv.launches, "jacobi_step": spmv.jacobi_step.launches}
    log(f"[{card}] knn_prop2 path: kernel launches={launches} "
        f"fused_frame_max launches={fs.fused_frame_max.launches} "
        f"peak device memory GB={peak!r}")
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
    _build.load_libraries("fused_frame_max", "knn_spmv")  # one nvcc each, together
    log(f"build fused_frame_max, knn_spmv: {time.perf_counter() - t0!r} s "
        f"(nvcc seconds {_build.build_seconds})")

    gen = torch.Generator(device=dev).manual_seed(0)
    scan, worst = check_scan(dev, gen)
    torch.cuda.synchronize()
    knn = check_spmv(dev, gen)
    torch.cuda.synchronize()
    check_sessions_cuda_vs_cpu()
    torch.cuda.synchronize()
    launches, idx = main_path(dev, gen, card)
    torch.cuda.synchronize()
    knn_launches = knnprop_path(idx, dev, gen, card)
    torch.cuda.synchronize()
    del idx
    bad = [m for m in sys.modules
           if m in ("jax", "flax") or m == "seesaw_tpu" or m.startswith("seesaw_tpu.")]
    if bad:
        raise AssertionError(f"the port imported {bad}")

    bf16 = next(r for r in scan if r["dtype"] == "bfloat16")
    log(json.dumps({"kernels": [{
        "name": "fused_frame_max", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/fused_frame_max.cu",
        "replaces": "seesaw_tpu/ops/pallas_scoring.py:43",
        "launches": launches, "max_abs_err": worst,
        "ms": bf16["ms"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": bf16["bound_by"],
        "library_ms": bf16["library_ms"],
    }, {
        "name": "knn_spmv", "route": "cuda",
        "source": "seesaw_tpu_torch/csrc/knn_spmv.cu",
        "replaces": "seesaw_tpu/ops/pallas_spmv.py:606,204,210",
        # both entry points of the source; the graph round runs jacobi_step
        "launches": sum(knn_launches.values()), "launches_by_entry": knn_launches,
        "max_abs_err": knn["max_abs_err"],
        "ms": knn["ms"], "plain_ms": knn["plain_ms"],
        "bound_ms": knn["bound_ms"], "bound_by": knn["bound_by"],
        "library_ms": knn["library_ms"],
        "jacobi_step_ms": knn["jacobi_ms"], "jacobi_step_plain_ms": knn["jacobi_plain_ms"],
        "jacobi_step_bound_ms": knn["jacobi_bound_ms"],
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
