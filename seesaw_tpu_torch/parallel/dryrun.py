"""Drive every mesh path once, each against its single-device result.

    python -m seesaw_tpu_torch.parallel.dryrun --n-devices 4 --device cpu|cuda
    python -m seesaw_tpu_torch.parallel.dryrun --processes 2 --devices-per-process 2 \
        --device cpu|cuda [--backend gloo|nccl]
    python -m seesaw_tpu_torch.parallel.dryrun --coordinator HOST:PORT --rank R \
        --world-size N --devices-per-process 2 --device cpu|cuda [--backend gloo|nccl]

The twin of the JAX package's multi-chip dry run
(`__graft_entry__.dryrun_multichip`), over a mesh of `--n-devices` shards
on `--device` repeated (one card, or the CPU, holds every shard). With
`--processes N` it starts N processes itself, joined by `torch.distributed`
(`multihost.init_multihost`), each holding `--devices-per-process` shards
of one mesh that spans them (S = N x M); `--coordinator/--rank/
--world-size` run one such process started by the user. Over a process
mesh parts (a)-(e) run as SPMD programs, every process holding each result
against its own one-device run, and (f) over the process's own shards in
one process: the coalescer keeps the in-process mesh. `--device cuda`
puts process r on card r modulo the visible cards; the backend defaults to
NCCL on cards and gloo on the CPU (processes that share a card need gloo:
NCCL refuses two ranks on one GPU).

a. sharded retrieval over ~2k ragged frames (a frame count the mesh does
   not divide, tile bound 16), and a batch of 4 queries equal to their solo
   queries;
b. a data-parallel fine-tune step of a text tower with 64-wide heads (so
   that on a card the attention kernels run: K5 forward, K6 backward):
   per-shard replicas compute their slice's loss and gradients, the
   gradients are averaged across the shards, and one Adam step follows;
   held against one step on the whole batch on one device;
c. the sharded kNN build and label propagation against one device;
d. data-parallel ingest encode of uint8 tiles (a vision tower with 64-wide
   heads) against one device;
e. three `knn_prop2` rounds over a mesh index with a mesh ranker against
   the single-device index and ranker;
f. four threads' queries coalesced into one sharded batch over the mesh
   index, each equal to its single-device solo query.

Prints one JSON line with each part's figures (and, on a card, each
kernel's launches; with `--processes`, every process's record); raises if
a check fails. `--params-out PATH` writes part (b)'s stepped parameters
(`.npz`; with `--processes`, rank 0's). Tolerances are stated where they
are checked.
"""
from __future__ import annotations

import argparse
import json
import socket
import subprocess
import sys
import tempfile
import threading
import time
from functools import partial
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh, psum
from .multihost import init_multihost, shutdown_multihost

# a text and vision tower whose attention the kernels take (64-wide heads,
# an even head count)
DRYRUN_CLIP = dict(embed_dim=32, image_size=32, patch_size=16, vision_width=128,
                   vision_layers=2, vision_heads=2, vocab_size=128, context_length=16,
                   text_width=128, text_layers=2, text_heads=2)
# f32 sums of the same products in another order (per-shard slices against
# the whole batch; the sharded kNN's matmul shapes against one device's)
TOL = dict(rtol=1e-5, atol=1e-5)
KNN_TOL = 2e-6


def _ragged_meta(rng, n_frames: int, max_tiles: int, d: int):
    from ..indices.meta import VectorMeta

    tiles_per = rng.integers(1, max_tiles, size=n_frames)
    total = int(tiles_per.sum())
    dbidx = np.repeat(np.arange(n_frames) * 3 + 1, tiles_per)
    zoom = rng.integers(1, 4, size=total)
    xy = rng.uniform(0, 100, size=(total, 2))
    boxes = np.concatenate([xy, xy + (30.0 * zoom)[:, None]], axis=1).astype(np.float32)
    meta, order = VectorMeta.from_arrays(dbidx, zoom, boxes)
    V = rng.normal(size=(meta.n_vectors, d)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    return meta, V


def retrieval(mesh: Mesh, rng) -> dict:
    """(a): a solo query with exclusions, and a batch equal to solo."""
    from ..indices.multiscale import MultiscaleIndex
    from ..runtime.bitmap import BitMap
    from .sharded_index import ShardedFrameIndex, sharded_query_topk, sharded_query_topk_batch

    n_frames, d = 256 * mesh.size + 7, 128
    meta, V = _ragged_meta(rng, n_frames, 10, d)
    idx = ShardedFrameIndex.build(V, meta, mesh)
    solo = MultiscaleIndex(device=mesh.primary, vectors=V, meta=meta)
    q = rng.normal(size=d).astype(np.float32)
    excluded = np.zeros(meta.n_frames, dtype=bool)
    excluded[[0, 7, n_frames - 1]] = True
    dbidxs, scores, _, _ = sharded_query_topk(idx, q, excluded, topk=10, shortlist_size=50)
    want = solo.query(vector=q, topk=10, shortlist_size=50,
                      exclude=BitMap(meta.frame_dbidx[[0, 7, n_frames - 1]]))
    if dbidxs.tolist() != want["dbidxs"].tolist():
        raise AssertionError(f"sharded query {dbidxs} != one device {want['dbidxs']}")
    if not (np.diff(scores) <= 1e-6).all():
        raise AssertionError("the merged top-k is not sorted")
    Q = 4
    qs = rng.normal(size=(Q, d)).astype(np.float32)
    excl_q = np.zeros((Q, meta.n_frames), dtype=bool)
    for i in range(Q):
        excl_q[i, rng.choice(meta.n_frames, size=5, replace=False)] = True
    batch = sharded_query_topk_batch(idx, qs, excl_q, topk=6, shortlist_size=30)
    for i in range(Q):
        one = sharded_query_topk(idx, qs[i], excl_q[i], topk=6, shortlist_size=30)
        if batch[i][0].tolist() != one[0].tolist():
            raise AssertionError(f"batched sharded query {i} diverged from solo")
        np.testing.assert_allclose(batch[i][1], one[1], **TOL)
    return {"frames": n_frames, "frames_per_shard": idx.n_frames_local, "batch_queries": Q}


def _tower(cfg, params, device):
    from ..models.clip import ClipModel

    with torch.device("meta"):
        model = ClipModel(cfg)
    model.load_state_dict({k: v.detach().to(device, copy=True) for k, v in params.items()},
                          assign=True)
    return model.requires_grad_(True)


def _text_loss(model, tokens, targets):
    txt = torch.nn.functional.normalize(model.encode_text(tokens), dim=-1)
    tgt = torch.nn.functional.normalize(targets, dim=-1)
    return (1.0 - (txt * tgt).sum(dim=-1)).mean()


def finetune_step(mesh: Mesh, rng, params_out=None) -> dict:
    """(b): per-shard losses and gradients, averaged across the shards (and
    processes), one Adam step; against one step on the whole batch on the
    primary device. `params_out`: write the stepped parameters there (npz)."""
    from ..models.clip import ClipConfig, init_params

    cfg = ClipConfig(**DRYRUN_CLIP)
    params = init_params(cfg, torch.Generator().manual_seed(0))
    S = mesh.size
    B = 2 * S
    tokens = rng.integers(1, cfg.vocab_size - 2, size=(B, cfg.context_length))
    tokens[:, -1] = cfg.vocab_size - 1  # EOT
    tokens = torch.from_numpy(tokens.astype(np.int64))
    targets = torch.from_numpy(rng.normal(size=(B, cfg.embed_dim)).astype(np.float32))
    per = B // S

    replicas = [_tower(cfg, params, dev) for dev in mesh.devices]  # this process's shards
    losses, grads = [], []
    for s, model, dev in zip(mesh.local_shards, replicas, mesh.devices):
        loss = _text_loss(model, tokens[s * per:(s + 1) * per].to(dev),
                          targets[s * per:(s + 1) * per].to(dev))
        names, ps = zip(*[(n, p) for n, p in model.named_parameters()])
        grads.append(torch.autograd.grad(loss, ps, allow_unused=True))
        losses.append(loss.detach())
    master = _tower(cfg, params, mesh.primary)
    for j, p in enumerate(master.parameters()):
        parts = [g[j] if g[j] is not None else torch.zeros_like(replicas[s].get_parameter(names[j]))
                 for s, g in enumerate(grads)]
        p.grad = psum(mesh, parts)[0] / S
    opt = torch.optim.Adam(master.parameters(), lr=1e-4)
    opt.step()
    mesh_loss = float(psum(mesh, losses)[0]) / S
    if params_out is not None:
        np.savez(params_out, **{n: p.detach().cpu().numpy() for n, p in master.named_parameters()})

    ref = _tower(cfg, params, mesh.primary)
    ref_loss = _text_loss(ref, tokens.to(mesh.primary), targets.to(mesh.primary))
    ref_loss.backward()
    ref_loss = float(ref_loss.detach())
    ref_opt = torch.optim.Adam(ref.parameters(), lr=1e-4)
    ref_opt.step()
    if not np.isfinite(mesh_loss):
        raise AssertionError(f"non-finite loss {mesh_loss}")
    np.testing.assert_allclose(mesh_loss, ref_loss, **TOL)
    err = max(float((a - b).detach().abs().max()) for a, b in
              zip(master.parameters(), ref.parameters()))
    # Adam's first step moves each weight by ~lr * sign(g): a parameter
    # whose averaged gradient is zero up to rounding may step either way,
    # so the bar is two steps of lr
    if not err <= 2e-4:
        raise AssertionError(f"data-parallel step differs from one device by {err}")
    return {"loss": mesh_loss, "loss_one_device": ref_loss, "param_max_abs_err": err,
            "batch": B}


def graph(mesh: Mesh, rng) -> dict:
    """(c): the sharded kNN build and propagation against one device."""
    from ..knn_graph import KNNGraph, rbf_kernel, symmetrize_weights
    from ..label_propagation import LabelPropagation
    from ..ops.knn import assert_knn_close

    n = 150 * mesh.size + 5
    V = rng.normal(size=(n, 32))
    V = (V / np.linalg.norm(V, axis=1, keepdims=True)).astype(np.float32)
    g = KNNGraph.build(V, 8, mesh=mesh)
    one = KNNGraph.build(V, 8, device=mesh.primary)
    knn = assert_knn_close(g.dst, g.dist, one.dst, one.dist, KNN_TOL)
    sw = symmetrize_weights(one, rbf_kernel(0.5))
    prior = rng.uniform(0.1, 0.9, size=n).astype(np.float32)
    kw = dict(label_ids=np.array([0, n - 1]), label_values=np.array([1.0, 0.0]),
              reg_values=prior)
    lp = LabelPropagation(sw, reg_lambda=1.0, max_iter=100, epsilon=1e-8, mesh=mesh)
    scores = lp.fit_transform(**kw)
    ref = LabelPropagation(sw, reg_lambda=1.0, max_iter=100, epsilon=1e-8,
                           device=mesh.primary).fit_transform(**kw)
    np.testing.assert_allclose(scores, ref, rtol=1e-5, atol=1e-6)
    return {"knn_max_dist_err": knn["max_dist_err"], "vectors": n,
            "propagation_steps": lp.last_result.n_iter,
            "propagation_max_abs_err": float(np.abs(scores - ref).max())}


def ingest_encode(mesh: Mesh, rng) -> dict:
    """(d): data-parallel encode of uint8 tiles against one device."""
    from ..ingest.pipeline import _BatchEncoder
    from ..models.clip import ClipConfig, ClipEmbedding, init_params
    from ..models.preprocess import normalize_pixels

    cfg = ClipConfig(**DRYRUN_CLIP)
    emb = ClipEmbedding(device=mesh.primary, cfg=cfg, dtype=None,
                        params=init_params(cfg, torch.Generator().manual_seed(1)))
    tiles = rng.integers(0, 255, size=(3 * mesh.size + 1, cfg.image_size, cfg.image_size, 3),
                         dtype=np.uint8)
    B = 2 * mesh.size
    out = {}
    for name, m in (("mesh", mesh), ("one", None)):
        enc = _BatchEncoder(emb, m)
        for lo in range(0, tiles.shape[0], B):
            px = torch.from_numpy(tiles[lo:lo + B]).to(mesh.primary)
            enc.submit(normalize_pixels(px.to(torch.float32) / 255.0))
        out[name] = enc.finish()
    if out["mesh"].shape != (tiles.shape[0], cfg.embed_dim):
        raise AssertionError(f"encoded {out['mesh'].shape}")
    np.testing.assert_allclose(out["mesh"], out["one"], **TOL)
    return {"tiles": int(tiles.shape[0]),
            "max_abs_err": float(np.abs(out["mesh"] - out["one"]).max())}


def _graph_index(mesh: Mesh, rng):
    from ..indices.meta import VectorMeta
    from ..knn_graph import KNNGraph, rbf_kernel, symmetrize_weights

    n_f = 40 * mesh.size + 3
    tiles = rng.integers(1, 5, size=n_f)
    dbidx = np.repeat(np.arange(n_f) * 3 + 1, tiles)
    total = int(tiles.sum())
    zoom = rng.integers(1, 3, size=total)
    xy = rng.uniform(0, 100, size=(total, 2))
    boxes = np.concatenate([xy, xy + (40.0 * zoom)[:, None]], axis=1).astype(np.float32)
    meta, order = VectorMeta.from_arrays(dbidx, zoom, boxes)
    V = rng.normal(size=(total, 32)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    V = V[order]
    sw = symmetrize_weights(KNNGraph.build(V, 6, mesh=mesh), rbf_kernel(0.5))
    return meta, V, sw


def knnprop_round(mesh: Mesh, rng) -> dict:
    """(e): three knn_prop2 rounds, mesh index + mesh ranker against the
    single-device index + ranker; the same dbidxs every round."""
    from ..indices.multiscale import MultiscaleIndex
    from ..loops.knn_methods import LabelPropagationRanker2
    from ..runtime.bitmap import BitMap

    meta, V, sw = _graph_index(mesh, rng)
    idx_mesh = MultiscaleIndex(vectors=V, meta=meta, mesh=mesh)
    idx_one = MultiscaleIndex(device=mesh.primary, vectors=V, meta=meta)
    opts = dict(normalize_scores=True, normalize_epsilon=0.1, sigmoid_before_propagate=True,
                calib_a=2.0, calib_b=0.0, prior_weight=1.0)
    r_mesh = LabelPropagationRanker2(weights=sw, mesh=mesh, **opts)
    r_one = LabelPropagationRanker2(weights=sw, device=mesh.primary, **opts)
    base = V @ V[0]
    for r in (r_mesh, r_one):
        r.set_base_scores(base.copy())
    ret_m, ret_o = BitMap(), BitMap()
    rounds = []
    for _ in range(3):
        got = []
        for idx_r, ranker, returned in ((idx_mesh, r_mesh, ret_m), (idx_one, r_one, ret_o)):
            res = idx_r.rank_by_scores(ranker.current_scores_any(), topk=3, shortlist_size=12,
                                       exclude=returned)
            ids = [int(x) for x in res["dbidxs"]]
            returned.update(ids)
            rows = meta.frame_starts[np.searchsorted(meta.frame_dbidx, ids)]
            ranker.update(rows, np.array([1.0, 0.0, 1.0])[: len(rows)])
            got.append(ids)
        if got[0] != got[1]:
            raise AssertionError(f"mesh knn_prop2 round diverged: {got[0]} vs {got[1]}")
        rounds.append(got[0])
    return {"rounds": rounds, "steps": r_mesh.last_result.n_iter,
            "host_reads": r_mesh.last_result.host_reads}


def coalesced(mesh: Mesh, rng) -> dict:
    """(f): four threads' queries coalesced over the mesh index, each equal
    to its single-device solo query. The coalescer keeps the in-process
    mesh: over a process mesh, this process's shards in one process."""
    from ..indices.multiscale import MultiscaleIndex
    from ..runtime.bitmap import BitMap
    from ..web.coalesce import CoalescingIndex

    if mesh.group is not None:
        mesh = make_mesh(devices=mesh.devices)
    meta, V = _ragged_meta(rng, 40 * mesh.size + 3, 5, 32)
    idx_mesh = MultiscaleIndex(vectors=V, meta=meta, mesh=mesh)
    idx_one = MultiscaleIndex(device=mesh.primary, vectors=V, meta=meta)
    cidx = CoalescingIndex(idx_mesh, window_ms=40.0, max_batch=8)
    qs = rng.normal(size=(4, 32)).astype(np.float32)
    excl = [BitMap(int(d) for d in rng.choice(meta.frame_dbidx, 3, replace=False))
            for _ in range(4)]
    results, errors = {}, []

    def one(i):
        try:
            results[i] = cidx.query(vector=qs[i], topk=4, shortlist_size=16, exclude=excl[i])
        except Exception as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for i in range(4):
        want = idx_one.query(vector=qs[i], topk=4, shortlist_size=16, exclude=excl[i])
        if list(results[i]["dbidxs"]) != list(want["dbidxs"]):
            raise AssertionError(f"coalesced mesh query {i} diverged from one device")
        np.testing.assert_allclose([a["score"] for a in results[i]["activations"]],
                                   [a["score"] for a in want["activations"]], **TOL)
    stats = dict(cidx._coalescer.stats)
    if stats["dispatches"] < 1:
        raise AssertionError(f"no coalesced dispatch: {stats}")
    return {"stats": stats}


def _launch_counters():
    from ..ops import attention, fused_scoring, spmv

    return {"fused_frame_max": fused_scoring.fused_frame_max,
            "knn_spmv": spmv.knn_spmv, "pair_attention": attention.pair_attention,
            "pair_attention_bwd": attention.pair_attention_bwd}


def dryrun_multichip(n_devices: int, device, *, group=None, params_out=None) -> dict:
    """Parts (a)-(f) over a mesh of `n_devices` shards on `device` repeated;
    with a `torch.distributed` group, these are this process's shards of a
    mesh over every process of it. Returns each part's figures and each
    kernel's launches in the part (in this process)."""
    mesh = make_mesh(devices=[torch.device(device)] * n_devices, group=group)
    rng = np.random.default_rng(0)
    counters = _launch_counters()
    out = {"n_devices": mesh.size, "device": str(mesh.primary), "processes": mesh.world,
           "rank": mesh.rank}
    for name, part in (("a_retrieval", retrieval),
                       ("b_finetune", partial(finetune_step, params_out=params_out)),
                       ("c_graph", graph), ("d_ingest_encode", ingest_encode),
                       ("e_knn_prop2", knnprop_round), ("f_coalesced", coalesced)):
        before = {k: c.launches for k, c in counters.items()}
        rec = part(mesh, rng)
        if mesh.primary.type == "cuda":
            torch.cuda.synchronize()
        rec["launches"] = {k: c.launches - before[k] for k, c in counters.items()}
        out[name] = rec
    return out


# a dry run process that has not finished by then has hung in a collective
PROCESS_TIMEOUT_S = 900.0


def free_port() -> int:
    """A free TCP port on this machine, for a group's coordinator."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(commands: list, logs: Path, *, timeout_s: float, env=None) -> None:
    """Run one process a command (the processes of one mesh), each writing
    its output to `logs`/rank<r>.log, and wait for all of them. A process
    that fails, or any left after `timeout_s` (hung in a collective), stops
    them all and raises with the first failed rank's output."""
    procs = []
    try:
        for r, cmd in enumerate(commands):
            log = open(Path(logs) / f"rank{r}.log", "w")
            procs.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, env=env,
                                           cwd=Path(__file__).resolve().parents[2]), log))
        deadline = time.monotonic() + timeout_s
        while any(p.poll() is None for p, _ in procs):
            if any(p.poll() not in (None, 0) for p, _ in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            log.close()
    failed = [r for r, (p, _) in enumerate(procs) if p.returncode != 0]
    if failed:
        r = failed[0]
        text = (Path(logs) / f"rank{r}.log").read_text()
        raise RuntimeError(f"process {r} of {len(commands)} failed (exit "
                           f"{procs[r][0].returncode}):\n{text[-6000:]}")


def dryrun_processes(n: int, devices_per_process: int, device: str, backend: str,
                     params_out=None) -> list:
    """Start `n` processes of this command joined at a free local port, each
    holding `devices_per_process` shards; return each rank's record."""
    coordinator = f"127.0.0.1:{free_port()}"
    with tempfile.TemporaryDirectory() as tmp:
        commands = []
        for r in range(n):
            cmd = [sys.executable, "-m", "seesaw_tpu_torch.parallel.dryrun",
                   "--coordinator", coordinator, "--rank", str(r), "--world-size", str(n),
                   "--devices-per-process", str(devices_per_process), "--device", device,
                   "--backend", backend, "--record-out", str(Path(tmp) / f"rank{r}.json")]
            if params_out is not None and r == 0:
                cmd += ["--params-out", str(params_out)]
            commands.append(cmd)
        run_processes(commands, Path(tmp), timeout_s=PROCESS_TIMEOUT_S)
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text()) for r in range(n)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n-devices", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--processes", type=int, default=0,
                    help="start this many processes of one mesh")
    ap.add_argument("--devices-per-process", type=int, default=None,
                    help="shards a process holds (default: --n-devices / --processes)")
    ap.add_argument("--coordinator", help="HOST:PORT of rank 0, for a process the user starts")
    ap.add_argument("--rank", type=int)
    ap.add_argument("--world-size", type=int)
    ap.add_argument("--backend", choices=("gloo", "nccl"),
                    help="default: nccl with --device cuda, gloo with --device cpu")
    ap.add_argument("--params-out", help="write part (b)'s stepped parameters (npz)")
    ap.add_argument("--record-out", help=argparse.SUPPRESS)  # a started process's record
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu")
    backend = args.backend or ("nccl" if torch.device(args.device).type == "cuda" else "gloo")
    if args.processes:
        per = args.devices_per_process or max(1, args.n_devices // args.processes)
        recs = dryrun_processes(args.processes, per, args.device, backend, args.params_out)
        print(json.dumps({"dryrun": {"processes": args.processes, "ranks": recs}}))
        return 0
    if args.coordinator is None:
        print(json.dumps({"dryrun": dryrun_multichip(args.n_devices, args.device,
                                                     params_out=args.params_out)}))
        return 0
    if args.rank is None or args.world_size is None:
        ap.error("--coordinator needs --rank and --world-size")
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", args.rank % torch.cuda.device_count())
    if device.type == "cuda":
        torch.cuda.set_device(device)
    init_multihost(args.coordinator, args.world_size, args.rank, backend=backend)
    try:
        rec = dryrun_multichip(args.devices_per_process or 1, device, group=dist.group.WORLD,
                               params_out=args.params_out)
    finally:
        shutdown_multihost()
    bad = [m for m in sys.modules if m == "jax" or m == "seesaw_tpu" or m.startswith("seesaw_tpu.")]
    if bad:
        raise AssertionError(f"the dry run imported {bad}")
    if args.record_out:
        Path(args.record_out).write_text(json.dumps(rec))
    print(json.dumps({"dryrun": rec}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
