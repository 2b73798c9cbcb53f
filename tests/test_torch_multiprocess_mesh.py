"""The port's mesh across processes against its in-process mesh and JAX.

Two process layouts of one mesh, each spawned once for the module: 2
processes x 2 shards (S = 4) and 3 processes x 1 shard (S = 3, so the ring
wraps across every process boundary). Each process joins a gloo group
through `parallel.multihost.init_multihost`, takes its shards of
`make_mesh(devices=["cpu"] * L, group=dist.group.WORLD)` and runs every
case below as an SPMD program (`run_cases`, this file run as a script,
started by `parallel.dryrun.run_processes`), writing its results to an
`.npz`; the parent checks that every rank wrote the same replicated
results, then holds them against the in-process port mesh of the same S
(`run_cases` in the parent) and against the JAX package on S of its 8
virtual CPU devices (`tests/conftest.py`), with the same numpy inputs.

Cases: solo queries in f32, bf16 and int8-row storage on a ragged database
whose frame count no S divides, over 3 clicks of growing exclusions; a
shard wholly excluded; a cutoff tie whose tied frames lie in different
processes; the discount (second) vector; a batch of Q = 4 equal to the solo
results; `rank_by_scores`; `rows_f32`; sessions of `plain` and `knn_prop2`
over `MultiscaleIndex.from_path(mesh=)`; the ring kNN build with planted
equal-similarity ties across processes; propagation (steps, converged,
host reads, scores); the dry run's data-parallel fine-tune step on a
two-layer tower; the processes' `ingest_file_range` parts of a tiny
dataset, whose concatenation is the one-process extraction; the mesh's
collectives; and a process mesh handed to the coalescer, which raises.

Bars: against JAX, those of `tests/test_torch_sharded_index.py` and
`test_torch_sharded_graph.py` (ids equal, scores rtol 1e-5 / atol 1e-6;
sessions as `test_session_over_mesh_index`). Against the in-process port
mesh, bit-equal, except the fine-tune step, whose gradient sum adds in
another order (each process its shards, then the processes): parameters
within 2e-4 (two Adam steps of its learning rate) and the loss within 1e-6
relative. The ingest parts: bit-equal (the hash embedding is a per-tile
function). Each process asserts that `jax` and `seesaw_tpu` are absent
from its `sys.modules`, and has a timeout, so a hang fails the test.
"""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

LAYOUTS = {"2x2": (2, 2), "3x1": (3, 1)}  # processes x shards a process
CHILD_TIMEOUT_S = 150.0
TOL = dict(rtol=1e-5, atol=1e-6)
DTYPES = ["float32", "bfloat16", "int8"]
CLICKS = 3
SESSION_ROUNDS = 4
TILE = dict(tile_size=32, factor=0.5, min_tile_size=32)
MESH_SESSION_OPTIONS = {
    "plain": {},
    "knn_prop2": dict(matrix_options=dict(knn_path="k5", knn_k=5, edist=0.5),
                      normalize_scores=True, normalize_epsilon=0.1,
                      sigmoid_before_propagate=True, calib_a=2.0, calib_b=-0.5,
                      prior_weight=1.0),
}


# -- inputs, made from seeds: the same in every process ----------------------
def ragged_arrays(n_frames, d, seed, max_tiles=8, id_step=2):
    """Ragged frames (1..max_tiles tiles, zoom 1-3 boxes), unit vectors,
    dbidx != frame ordinal: (dbidx, zoom, boxes, V) in input order."""
    rng = np.random.default_rng(seed)
    dbidx, zoom, boxes = [], [], []
    for f in range(n_frames):
        for _ in range(int(rng.integers(1, max_tiles + 1))):
            zl = int(rng.integers(1, 4))
            size = 32.0 * (2 ** (zl - 1))
            x1, y1 = (float(rng.uniform(0, 224 - size)) for _ in range(2))
            dbidx.append(f * id_step + 5)
            zoom.append(zl)
            boxes.append((x1, y1, x1 + size, y1 + size))
    V = rng.normal(size=(len(dbidx), d)).astype(np.float32)
    V /= np.linalg.norm(V, axis=1, keepdims=True)
    return np.array(dbidx), np.array(zoom), np.array(boxes, np.float32), V


def tie_arrays():
    """24 frames of 2 tiles: frames 10..19 share one raw max (5.0), so the
    shortlist of 15 cuts inside them; their augmented scores rise with id."""
    n_frames, d = 24, 8
    dbidx = np.repeat(np.arange(n_frames), 2)
    zoom = np.tile([1, 2], n_frames)
    boxes = np.tile(np.array([[0, 0, 64, 64], [0, 0, 128, 128]], np.float32), (n_frames, 1))
    s0 = np.concatenate([10.0 - 0.1 * np.arange(10), np.full(10, 5.0), np.full(4, 1.0)])
    s1 = np.concatenate([10.0 - 0.1 * np.arange(10), 3.0 + 0.2 * np.arange(10),
                         np.full(4, 1.0)])
    V = np.zeros((n_frames * 2, d), np.float32)
    V[0::2, 0], V[1::2, 0] = s0, s1
    return dbidx, zoom, boxes, V


def knn_vectors():
    """203 unit rows with exact duplicates whose ties cross process
    boundaries at S = 3 and S = 4: rows 150-155 copy row 3, row 110 row 100."""
    rng = np.random.default_rng(21)
    V = rng.normal(size=(203, 16))
    V = (V / np.linalg.norm(V, axis=1, keepdims=True)).astype(np.float32)
    V[150:156] = V[3]
    V[110] = V[100]
    return V


def propagation_problem():
    """A k = 6 graph over 90 unit rows (`ops.knn.exact_knn` on the CPU), 4
    labels, a prior; (nbr, dist) and the vectors for the weights."""
    rng = np.random.default_rng(7)
    n = 90
    ids = rng.choice(n, size=4, replace=False)
    labels = np.zeros(n, np.float32)
    labels[ids] = [1.0, 0.0, 1.0, 0.0]
    is_labeled = np.zeros(n, bool)
    is_labeled[ids] = True
    prior = rng.uniform(0.1, 0.9, size=n).astype(np.float32)
    V = rng.normal(size=(n, 16))
    V = (V / np.linalg.norm(V, axis=1, keepdims=True)).astype(np.float32)
    return V, prior, labels, is_labeled


PROP_KW = dict(reg_lambda=0.5, max_iter=200, epsilon=1e-10, dispatch_iters=17)


def _meta(args):
    from seesaw_tpu_torch.indices.meta import VectorMeta

    meta, order = VectorMeta.from_arrays(*args[:3])
    return meta, args[3][order]


def _acts(res):
    return np.array([a["score"] for a in res["activations"]], np.float32)


# -- the cases: every process of a process mesh runs them all, in order -------
def run_cases(mesh, work: Path) -> dict:
    """Every case over `mesh` (a process mesh, or the in-process mesh of the
    same S); returns the results as numpy arrays by name. `work` holds the
    parent's synthetic root and images."""
    from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex
    from seesaw_tpu_torch.knn_graph import KNNGraph, rbf_kernel, symmetrize_weights
    from seesaw_tpu_torch.ops.knn import exact_knn
    from seesaw_tpu_torch.parallel import mesh as M
    from seesaw_tpu_torch.parallel import sharded_graph as tsg
    from seesaw_tpu_torch.parallel import sharded_index as tsi
    from seesaw_tpu_torch.parallel.dryrun import finetune_step
    from seesaw_tpu_torch.runtime.bitmap import BitMap

    out = {}
    S = mesh.size

    # the collectives, on parts that name their shard
    parts = [torch.full((2,), float(s)) for s in mesh.local_shards]
    out["coll_all_gather"] = M.all_gather(mesh, parts)[-1].numpy()
    out["coll_rotate"] = np.stack([p.numpy() for p in M.rotate(mesh, parts)])
    out["coll_pmax"] = M.pmax(mesh, [p.sum() for p in parts])[0].numpy()
    out["coll_psum"] = M.psum(mesh, [p.sum() for p in parts])[0].numpy()
    out["coll_gather_to"] = M.gather_to(mesh, [p[None] for p in parts], dim=-1).numpy()
    out["coll_split_rows"] = np.stack([p.numpy() for p in
                                       M.split_rows(mesh, torch.arange(2.0 * S + 1), 2, -1.0)])

    # solo queries over 3 clicks of growing exclusions, each storage
    meta, V = _meta(ragged_arrays(41, 24, seed=0))
    for dtype in DTYPES:
        idx = tsi.ShardedFrameIndex.build(V, meta, mesh, dtype=dtype)
        rng = np.random.default_rng(1)
        excl = np.zeros(meta.n_frames, dtype=bool)
        for c in range(CLICKS):
            q = rng.normal(size=V.shape[1]).astype(np.float32)
            got = tsi.sharded_query_topk(idx, q, excl.copy(), topk=6, shortlist_size=15)
            for k, v in zip("dsba", got):
                out[f"q_{dtype}_{c}_{k}"] = v
            excl[np.searchsorted(meta.frame_dbidx, got[0][:3])] = True
        if dtype == "int8":
            prows = torch.arange(0, idx.n_frames * idx.tile_bound, 5)
            out["rows_int8"] = idx.rows_f32(prows).numpy()
        elif dtype == "float32":
            prows = torch.arange(0, idx.n_frames * idx.tile_bound, 5)
            out["rows_float32"] = idx.rows_f32(prows).numpy()

    # shard 1 wholly excluded, then everything
    midx = MultiscaleIndex(vectors=V, meta=meta, mesh=mesh)
    Fs = midx._sharded.n_frames_local
    q = np.random.default_rng(5).normal(size=V.shape[1]).astype(np.float32)
    gone = BitMap(meta.frame_dbidx[Fs:2 * Fs])
    res = midx.query(vector=q, topk=10, shortlist_size=30, exclude=gone)
    out["excl_shard_d"], out["excl_shard_a"] = res["dbidxs"], _acts(res)
    out["excl_all_n"] = np.array(len(midx.query(vector=q, topk=5, shortlist_size=20,
                                                exclude=BitMap(meta.frame_dbidx))["dbidxs"]))

    # a batch of 4 equal to its solo queries
    rng = np.random.default_rng(7)
    qs = rng.normal(size=(4, V.shape[1])).astype(np.float32)
    ex = np.zeros((4, meta.n_frames), dtype=bool)
    for i in range(4):
        ex[i, rng.choice(meta.n_frames, size=6, replace=False)] = True
    idx = tsi.ShardedFrameIndex.build(V, meta, mesh)
    batch = tsi.sharded_query_topk_batch(idx, qs, ex, topk=8, shortlist_size=20)
    for i in range(4):
        solo = tsi.sharded_query_topk(idx, qs[i], ex[i], topk=8, shortlist_size=20)
        for k, b, s in zip("dsba", batch[i], solo):
            out[f"batch_{i}_{k}"], out[f"batch_solo_{i}_{k}"] = b, s

    # rank_by_scores under an exclusion
    scores = np.random.default_rng(5).normal(size=meta.n_vectors).astype(np.float32)
    res = midx.rank_by_scores(scores, topk=5, shortlist_size=20,
                              exclude=BitMap(meta.frame_dbidx[[0, 5, 17, 33]]))
    out["rank_d"], out["rank_a"] = res["dbidxs"], _acts(res)

    # the cutoff tie
    tmeta, tV = _meta(tie_arrays())
    q = np.zeros(tV.shape[1], np.float32)
    q[0] = 1.0
    tidx = tsi.ShardedFrameIndex.build(tV, tmeta, mesh)
    got = tsi.sharded_query_topk(tidx, q, np.zeros(tmeta.n_frames, bool), topk=12,
                                 shortlist_size=15)
    out["tie_d"], out["tie_s"] = got[0], got[1]

    # the discount vector
    dmeta, dV = _meta(ragged_arrays(40, 16, seed=0, max_tiles=4))
    rng = np.random.default_rng(0)
    q, q2 = (rng.normal(size=16).astype(np.float32) for _ in range(2))
    res = MultiscaleIndex(vectors=dV, meta=dmeta, mesh=mesh).query(
        vector=q, vector2=q2, topk=8, shortlist_size=20)
    out["discount_d"], out["discount_a"] = res["dbidxs"], _acts(res)

    # the ring kNN build with planted ties
    ids, dist = tsg.sharded_exact_knn(knn_vectors(), 8, mesh, block_size=64)
    out["knn_ids"], out["knn_dist"] = ids, dist

    # propagation
    PV, prior, labels, is_labeled = propagation_problem()
    tw = symmetrize_weights(KNNGraph(*exact_knn(PV, 6, device="cpu")), rbf_kernel(0.5))
    pr = tsg.sharded_propagate(tw.nbr, tw.w, tw.degree, prior, labels, is_labeled,
                               prior.copy(), mesh, **PROP_KW)
    out["prop_scores"] = pr.scores.numpy()
    out["prop_meta"] = np.array([pr.n_iter, int(pr.converged), pr.host_reads])

    # sessions over from_path(mesh=)
    out.update(_sessions(mesh, work))

    # the dry run's data-parallel fine-tune step
    rec = finetune_step(mesh, np.random.default_rng(0), params_out=work / "params.npz")
    out["ft_loss"] = np.array(rec["loss"])
    with np.load(work / "params.npz") as z:
        out.update({f"ft_param_{k}": z[k] for k in z.files})
    return out


def _sessions(mesh, work: Path) -> dict:
    from seesaw_tpu_torch import basic_types as bt
    from seesaw_tpu_torch.dataset import GlobalDataManager
    from seesaw_tpu_torch.session import make_session

    info = json.loads((work / "session.json").read_text())
    is_pos = np.array(info["is_pos"], bool)
    gt = {int(k): v for k, v in info["gt"].items()}
    out = {}
    for method, opts in MESH_SESSION_OPTIONS.items():
        params = bt.SessionParams(
            index_spec=bt.IndexSpec(d_name="msess", i_name="multiscale"),
            interactive=method, batch_size=3, shortlist_size=20,
            interactive_options=opts, index_options={"mesh": mesh})
        s = make_session(GlobalDataManager(str(work / "root")), params, device="cpu")["session"]
        assert s.index.mesh is mesh
        for r, (dbidxs, scores) in enumerate(drive(s, is_pos, gt, bt.Box)):
            out[f"sess_{method}_{r}_d"], out[f"sess_{method}_{r}_a"] = dbidxs, scores
    return out


def drive(session, is_pos, gt, Box, rounds=SESSION_ROUNDS):
    """The simulated user of `tests/test_torch_session.py`: accept planted
    positives with their box, reject the rest. Returns each round's
    (dbidxs, activation scores)."""
    session.set_text("a dog")
    out = []
    for _ in range(rounds):
        dbidxs = np.array([int(i) for i in session.next()])
        acts = session.acc_activations[-1] or []
        out.append((dbidxs, np.array([a["score"] for a in acts], np.float32)))
        state = session.get_state()
        for imdata in state.gdata[-1]:
            if is_pos[imdata.dbidx]:
                x1, y1, x2, y2 = gt[imdata.dbidx]
                imdata.boxes = [Box(x1=x1, y1=y1, x2=x2, y2=y2, marked_accepted=True)]
            else:
                imdata.boxes = []
        session.update_state(state)
        session.refine()
    return out


def ingest_part(work: Path, rank, world) -> tuple:
    """This process's `ingest_file_range` part of the image folder, as its
    own dataset, extracted with the hash embedding: (vectors, global dbidx)."""
    from seesaw_tpu_torch.dataset import SeesawDataset
    from seesaw_tpu_torch.ingest.pipeline import run_multiscale_extraction
    from seesaw_tpu_torch.models.registry import load_embedding
    from seesaw_tpu_torch.parallel.multihost import ingest_file_range

    paths = sorted(p.name for p in (work / "images").iterdir())
    lo, hi = ingest_file_range(len(paths), rank, world)
    ds = SeesawDataset.create(str(work / f"ingest_{rank}_of_{world}"),
                              image_src=str(work / "images"), paths=paths[lo:hi], force=True)
    vecs, dbidx, _, _ = run_multiscale_extraction(ds, load_embedding("hash-16", "cpu"),
                                                  batch_size=8, n_decode_threads=2, **TILE)
    return vecs, dbidx + lo


def child_main(rank: int, world: int, local: int, port: int, work: str) -> None:
    """One process of a layout: join the group, run every case over the
    global mesh, write the results."""
    import torch.distributed as dist

    from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex
    from seesaw_tpu_torch.parallel.mesh import make_mesh
    from seesaw_tpu_torch.parallel.multihost import init_multihost, shutdown_multihost
    from seesaw_tpu_torch.web.coalesce import QueryCoalescer

    work = Path(work)
    mine = work / f"rank{rank}"
    mine.mkdir(exist_ok=True)
    assert init_multihost(f"127.0.0.1:{port}", world, rank, backend="gloo") == (world, rank)
    try:
        mesh = make_mesh(devices=["cpu"] * local, group=dist.group.WORLD)
        assert (mesh.size, mesh.rank, mesh.world) == (world * local, rank, world)
        assert list(mesh.local_shards) == list(range(rank * local, (rank + 1) * local))
        assert mesh.shard_ranks == tuple(s // local for s in range(world * local))
        # run_cases reads the parent's root and images from `work`
        for name in ("root", "session.json", "images"):
            link = mine / name
            if not link.exists():
                link.symlink_to(work / name)
        out = run_cases(mesh, mine)
        vecs, dbidx = ingest_part(mine, rank, world)
        out["ingest_vectors"], out["ingest_dbidx"] = vecs, dbidx
        meta, V = _meta(ragged_arrays(41, 24, seed=0))
        try:
            QueryCoalescer(MultiscaleIndex(vectors=V, meta=meta, mesh=mesh))
            out["coalescer_raises"] = np.array(False)
        except ValueError as e:
            out["coalescer_raises"] = np.array("in-process mesh" in str(e))
        dist.barrier()
    finally:
        shutdown_multihost()
    bad = [m for m in sys.modules if m == "jax" or m == "seesaw_tpu" or m.startswith("seesaw_tpu.")]
    assert not bad, bad
    np.savez(work / f"rank{rank}.npz", **out)


# -- the parent ---------------------------------------------------------------
@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The inputs on disk: a synthetic root with a k = 5 graph (the JAX
    package builds both) and a folder of tiny JPEGs."""
    import PIL.Image

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from synth import build_synthetic_root

    from seesaw_tpu.knn_graph import KNNGraph

    base = tmp_path_factory.mktemp("mp_mesh")
    _, ds, info = build_synthetic_root(str(base / "root"), dataset_name="msess")
    idx = ds.load_index("multiscale", options={})
    KNNGraph.build(idx.vectors, n_neighbors=5).save(idx.get_knng_path(name="k5"))
    table, _ = ds.load_ground_truth()
    gt = {int(d): [float(x) for x in b] for d, b in zip(table.dbidx, table.boxes)}
    (base / "session.json").write_text(json.dumps({"is_pos": info["is_pos"].tolist(),
                                                   "gt": gt}))
    (base / "images").mkdir()
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate([(64, 96), (96, 64), (64, 64), (80, 100), (50, 70)]):
        px = rng.integers(0, 255, size=(h // 8, w // 8, 3), dtype=np.uint8)
        PIL.Image.fromarray(px).resize((w, h)).save(base / "images" / f"img_{i}.jpg")
    return base


def _run_layout(d: Path, world: int, local: int) -> list:
    """Run the layout's processes (`dryrun.run_processes`: all stopped at
    the first failure or at the timeout) and return each rank's results."""
    from seesaw_tpu_torch.parallel.dryrun import free_port, run_processes

    port = free_port()
    # one thread each: the cases' tensors are far below torch's parallel
    # grain, and idle threads of several processes would contend for cores
    env = dict(os.environ, OMP_NUM_THREADS="1")
    run_processes([[sys.executable, __file__, "--child", str(r), str(world), str(local),
                    str(port), str(d)] for r in range(world)],
                  d, timeout_s=CHILD_TIMEOUT_S, env=env)
    outs = []
    for r in range(world):
        with np.load(d / f"rank{r}.npz") as z:
            outs.append({k: z[k] for k in z.files})
    return outs


@pytest.fixture(scope="module", params=list(LAYOUTS))
def layout(request, work):
    """(S, world, local, each rank's results, the in-process mesh's)."""
    from seesaw_tpu_torch.parallel.mesh import make_mesh

    world, local = LAYOUTS[request.param]
    S = world * local
    dirs = {}
    for name in ("layout", "inprocess"):
        dirs[name] = work / f"{name}_{world}x{local}"
        dirs[name].mkdir()
        for f in ("root", "session.json", "images"):
            (dirs[name] / f).symlink_to(work / f)
    # the in-process mesh's run while the processes run theirs
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(_run_layout, dirs["layout"], world, local)
        ref = run_cases(make_mesh(devices=["cpu"] * S), dirs["inprocess"])
        return S, world, local, ranks.result(), ref


def _jax_mesh(S):
    from seesaw_tpu.parallel import make_mesh

    return make_mesh(S)


def _jmeta(args):
    from seesaw_tpu.indices.meta import VectorMeta as JMeta

    return JMeta.from_arrays(*args[:3])[0]


def _close_ids(got_d, got_s, want_d, want_s):
    assert np.asarray(got_d).tolist() == np.asarray(want_d).tolist()
    np.testing.assert_allclose(got_s, want_s, **TOL)


def test_every_rank_returns_the_same_result(layout):
    _, world, _, ranks, ref = layout
    skip = {"coll_rotate", "coll_split_rows", "ingest_vectors", "ingest_dbidx"}  # per process
    for r in range(1, world):
        assert ranks[r].keys() == ranks[0].keys()
        for k in ranks[0]:
            if k not in skip:
                np.testing.assert_array_equal(ranks[r][k], ranks[0][k], err_msg=f"rank {r} {k}")
    assert set(ranks[0]) - set(ref) == {"ingest_vectors", "ingest_dbidx", "coalescer_raises"}


def test_collectives_cross_processes(layout):
    S, world, local, ranks, ref = layout
    for r, out in enumerate(ranks):
        assert out["coll_all_gather"].tolist() == np.repeat(np.arange(S), 2).tolist()
        mine = range(r * local, (r + 1) * local)
        assert out["coll_rotate"][:, 0].tolist() == [(s + 1) % S for s in mine]
        assert float(out["coll_pmax"]) == 2.0 * (S - 1)
        assert float(out["coll_psum"]) == float(S * (S - 1))
        assert out["coll_gather_to"].tolist() == [np.repeat(np.arange(S), 2).tolist()]
        full = np.concatenate([np.arange(2.0 * S + 1), [-1.0]])
        assert out["coll_split_rows"].tolist() == [full[2 * s:2 * s + 2].tolist() for s in mine]
        np.testing.assert_array_equal(out["coll_rotate"][:, 0], ref["coll_rotate"][list(mine), 0])


@pytest.mark.parametrize("dtype", DTYPES)
def test_solo_queries_match_inprocess_and_jax(layout, dtype):
    """3 clicks of growing exclusions: bit-equal to the in-process mesh,
    ids equal to JAX's and scores within TOL."""
    from seesaw_tpu.parallel import sharded_index as jsi

    S, _, _, ranks, ref = layout
    out = ranks[0]
    args = ragged_arrays(41, 24, seed=0)
    jmeta = _jmeta(args)
    V = args[3][JMetaOrder(args)]
    jidx = jsi.ShardedFrameIndex.build(V, jmeta, _jax_mesh(S), dtype=dtype)
    rng = np.random.default_rng(1)
    excl = np.zeros(jmeta.n_frames, dtype=bool)
    for c in range(CLICKS):
        q = rng.normal(size=V.shape[1]).astype(np.float32)
        want = jsi.sharded_query_topk(jidx, q, excl.copy(), topk=6, shortlist_size=15)
        for k, w in zip("dsba", want):
            got = out[f"q_{dtype}_{c}_{k}"]
            np.testing.assert_array_equal(got, ref[f"q_{dtype}_{c}_{k}"])
            if k == "d":
                assert got.tolist() == np.asarray(w).tolist()
            else:
                np.testing.assert_allclose(got, w, **TOL)
        excl[np.searchsorted(jmeta.frame_dbidx, np.asarray(want[0])[:3])] = True


def JMetaOrder(args):
    from seesaw_tpu.indices.meta import VectorMeta as JMeta

    return JMeta.from_arrays(*args[:3])[1]


def _jax_index(args, S, **kw):
    from seesaw_tpu.indices.multiscale import MultiscaleIndex as JIndex

    return JIndex(vectors=args[3][JMetaOrder(args)], meta=_jmeta(args), mesh=_jax_mesh(S), **kw)


def test_wholly_excluded_shard(layout):
    from seesaw_tpu.runtime.bitmap import BitMap as JBitMap

    S, _, _, ranks, ref = layout
    out = ranks[0]
    for k in ("excl_shard_d", "excl_shard_a", "excl_all_n"):
        np.testing.assert_array_equal(out[k], ref[k])
    args = ragged_arrays(41, 24, seed=0)
    jidx = _jax_index(args, S)
    Fs = -(-41 // S)
    q = np.random.default_rng(5).normal(size=24).astype(np.float32)
    want = jidx.query(vector=q, topk=10, shortlist_size=30,
                      exclude=JBitMap(jidx.meta.frame_dbidx[Fs:2 * Fs]))
    _close_ids(out["excl_shard_d"], out["excl_shard_a"], want["dbidxs"], _acts(want))
    assert not set(out["excl_shard_d"].tolist()) & set(jidx.meta.frame_dbidx[Fs:2 * Fs].tolist())
    assert int(out["excl_all_n"]) == 0


def test_cutoff_tie_across_processes(layout):
    """The frames tied at the cutoff lie in more than one process; the
    shards shortlist the single device's (lowest ids), as JAX's do."""
    from seesaw_tpu.parallel import sharded_index as jsi

    S, world, local, ranks, ref = layout
    out = ranks[0]
    Fs = -(-24 // S)
    assert len({f // Fs // local for f in range(10, 20)}) >= 2  # tied frames in >= 2 processes
    np.testing.assert_array_equal(out["tie_d"], ref["tie_d"])
    np.testing.assert_array_equal(out["tie_s"], ref["tie_s"])
    args = tie_arrays()
    V = args[3][JMetaOrder(args)]
    q = np.zeros(8, np.float32)
    q[0] = 1.0
    want = jsi.sharded_query_topk(jsi.ShardedFrameIndex.build(V, _jmeta(args), _jax_mesh(S)),
                                  q, np.zeros(24, bool), topk=12, shortlist_size=15)
    assert set(np.asarray(want[0]).tolist()) == set(range(10)) | {13, 14}
    _close_ids(out["tie_d"], out["tie_s"], want[0], want[1])


def test_discount_vector(layout):
    S, _, _, ranks, ref = layout
    out = ranks[0]
    np.testing.assert_array_equal(out["discount_d"], ref["discount_d"])
    np.testing.assert_array_equal(out["discount_a"], ref["discount_a"])
    rng = np.random.default_rng(0)
    q, q2 = (rng.normal(size=16).astype(np.float32) for _ in range(2))
    want = _jax_index(ragged_arrays(40, 16, seed=0, max_tiles=4), S).query(
        vector=q, vector2=q2, topk=8, shortlist_size=20)
    _close_ids(out["discount_d"], out["discount_a"], want["dbidxs"], _acts(want))


def test_batch_equals_solo(layout):
    from seesaw_tpu.parallel import sharded_index as jsi

    S, _, _, ranks, ref = layout
    out = ranks[0]
    args = ragged_arrays(41, 24, seed=0)
    rng = np.random.default_rng(7)
    qs = rng.normal(size=(4, 24)).astype(np.float32)
    ex = np.zeros((4, 41), dtype=bool)
    for i in range(4):
        ex[i, rng.choice(41, size=6, replace=False)] = True
    jbatch = jsi.sharded_query_topk_batch(
        jsi.ShardedFrameIndex.build(args[3][JMetaOrder(args)], _jmeta(args), _jax_mesh(S)),
        qs, ex, topk=8, shortlist_size=20)
    for i in range(4):
        for k in "dsba":
            np.testing.assert_array_equal(out[f"batch_{i}_{k}"], ref[f"batch_{i}_{k}"])
            np.testing.assert_array_equal(out[f"batch_solo_{i}_{k}"], ref[f"batch_solo_{i}_{k}"])
        assert out[f"batch_{i}_d"].tolist() == out[f"batch_solo_{i}_d"].tolist()
        _close_ids(out[f"batch_{i}_d"], out[f"batch_{i}_a"], jbatch[i][0], jbatch[i][3])


def test_rank_by_scores(layout):
    from seesaw_tpu.runtime.bitmap import BitMap as JBitMap

    S, _, _, ranks, ref = layout
    out = ranks[0]
    np.testing.assert_array_equal(out["rank_d"], ref["rank_d"])
    np.testing.assert_array_equal(out["rank_a"], ref["rank_a"])
    jidx = _jax_index(ragged_arrays(41, 24, seed=0), S)
    scores = np.random.default_rng(5).normal(size=jidx.meta.n_vectors).astype(np.float32)
    want = jidx.rank_by_scores(scores, topk=5, shortlist_size=20,
                               exclude=JBitMap(jidx.meta.frame_dbidx[[0, 5, 17, 33]]))
    _close_ids(out["rank_d"], out["rank_a"], want["dbidxs"], _acts(want))


def test_rows_f32(layout):
    """Rows held by other processes arrive through the all_reduce: f32 rows
    are the padded layout's vectors exactly, int8 rows within half a step
    of each row's scale; both bit-equal to the in-process mesh."""
    from seesaw_tpu_torch.indices.multiscale import padded_host_arrays

    S, _, _, ranks, ref = layout
    out = ranks[0]
    meta, V = _meta(ragged_arrays(41, 24, seed=0))
    host = padded_host_arrays(V, meta, "float32", "row")
    want = host["V"].numpy()[::5]
    np.testing.assert_array_equal(out["rows_float32"], want)
    np.testing.assert_array_equal(out["rows_float32"], ref["rows_float32"])
    np.testing.assert_array_equal(out["rows_int8"], ref["rows_int8"])
    step = np.abs(want).max(axis=1, keepdims=True) / 127.0
    assert (np.abs(out["rows_int8"] - want) <= 0.5 * step + 1e-7).all()


@pytest.mark.parametrize("method", list(MESH_SESSION_OPTIONS))
def test_sessions_over_from_path(layout, work, method):
    """Sessions over `from_path(mesh=)` against the JAX package's sessions
    over its sharded index (every virtual device)."""
    import seesaw_tpu.basic_types as jbt
    from seesaw_tpu.dataset import GlobalDataManager as JaxGDM
    from seesaw_tpu.session import make_session as jax_make_session

    S, _, _, ranks, ref = layout
    out = ranks[0]
    info = json.loads((work / "session.json").read_text())
    is_pos = np.array(info["is_pos"], bool)
    gt = {int(k): v for k, v in info["gt"].items()}
    params = jbt.SessionParams(
        index_spec=jbt.IndexSpec(d_name="msess", i_name="multiscale"),
        interactive=method, batch_size=3, shortlist_size=20,
        interactive_options=MESH_SESSION_OPTIONS[method], index_options={"sharded": True})
    s = jax_make_session(JaxGDM(str(work / "root")), params)["session"]
    for r, (d, a) in enumerate(drive(s, is_pos, gt, jbt.Box)):
        np.testing.assert_array_equal(out[f"sess_{method}_{r}_d"], ref[f"sess_{method}_{r}_d"])
        np.testing.assert_array_equal(out[f"sess_{method}_{r}_a"], ref[f"sess_{method}_{r}_a"])
        _close_ids(out[f"sess_{method}_{r}_d"], out[f"sess_{method}_{r}_a"], d, a)


def test_ring_knn_with_planted_ties(layout):
    from seesaw_tpu.parallel import sharded_exact_knn as jax_sharded_knn

    S, world, local, ranks, ref = layout
    out = ranks[0]
    Ns = -(-203 // S)
    assert 3 // Ns // local != 150 // Ns // local  # the duplicates' rows lie in two processes
    np.testing.assert_array_equal(out["knn_ids"], ref["knn_ids"])
    np.testing.assert_array_equal(out["knn_dist"], ref["knn_dist"])
    j_ids, j_dist = jax_sharded_knn(knn_vectors(), 8, _jax_mesh(S))
    np.testing.assert_array_equal(out["knn_ids"], np.asarray(j_ids))
    np.testing.assert_allclose(out["knn_dist"], np.asarray(j_dist), atol=1e-6)
    assert out["knn_ids"][3][:6].tolist() == list(range(150, 156))  # ties by lower id


def test_propagation(layout):
    from seesaw_tpu.knn_graph import KNNGraph as JKNNGraph
    from seesaw_tpu.knn_graph import rbf_kernel as jrbf
    from seesaw_tpu.knn_graph import symmetrize_weights as jsym
    from seesaw_tpu.parallel import sharded_propagate as jax_sharded_propagate
    from seesaw_tpu_torch.ops.knn import exact_knn

    S, _, _, ranks, ref = layout
    out = ranks[0]
    np.testing.assert_array_equal(out["prop_scores"], ref["prop_scores"])
    np.testing.assert_array_equal(out["prop_meta"], ref["prop_meta"])
    n_iter, converged, reads = out["prop_meta"].tolist()
    assert converged and 1 < n_iter < PROP_KW["max_iter"] and reads >= 2
    V, prior, labels, is_labeled = propagation_problem()
    jw = jsym(JKNNGraph(*exact_knn(V, 6, device="cpu")), jrbf(0.5))
    kw = {k: v for k, v in PROP_KW.items() if k != "dispatch_iters"}
    want = jax_sharded_propagate(jw.nbr, jw.w, jw.degree, prior, labels, is_labeled,
                                 prior.copy(), _jax_mesh(S), **kw)
    np.testing.assert_allclose(out["prop_scores"], np.asarray(want), **TOL)


def test_finetune_step(layout):
    """The data-parallel step's gradients sum each process's shards, then
    the processes: parameters within 2e-4 of the in-process mesh's, the
    loss within 1e-6 relative."""
    _, _, _, ranks, ref = layout
    out = ranks[0]
    np.testing.assert_allclose(out["ft_loss"], ref["ft_loss"], rtol=1e-6)
    names = [k for k in ref if k.startswith("ft_param_")]
    assert len(names) > 10
    for k in names:
        assert np.abs(out[k] - ref[k]).max() <= 2e-4, k


def test_ingest_parts_concatenate_to_one_process(layout, work):
    from seesaw_tpu_torch.dataset import SeesawDataset
    from seesaw_tpu_torch.ingest.pipeline import run_multiscale_extraction
    from seesaw_tpu_torch.models.registry import load_embedding

    _, world, _, ranks, _ = layout
    paths = sorted(p.name for p in (work / "images").iterdir())
    ds = SeesawDataset.create(str(work / f"ingest_whole_{world}"), image_src=str(work / "images"),
                              paths=paths, force=True)
    vecs, dbidx, _, _ = run_multiscale_extraction(ds, load_embedding("hash-16", "cpu"),
                                                  batch_size=8, n_decode_threads=2, **TILE)
    got_v = np.concatenate([o["ingest_vectors"] for o in ranks])
    got_d = np.concatenate([o["ingest_dbidx"] for o in ranks])
    assert sum(len(np.unique(o["ingest_dbidx"])) > 0 for o in ranks) == min(world, len(paths))
    np.testing.assert_array_equal(got_d, dbidx)
    np.testing.assert_array_equal(got_v, vecs)


def test_coalescer_refuses_a_process_mesh(layout):
    for out in layout[3]:
        assert bool(out["coalescer_raises"])


def test_build_lock_is_machine_wide(tmp_path, monkeypatch):
    """`_build.load_libraries` checks and builds under an exclusive flock on
    the build directory's lock file: another process cannot take it."""
    from seesaw_tpu_torch import _build

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    probe = ("import fcntl, sys; f = open(sys.argv[1], 'w')\n"
             "try:\n    fcntl.flock(f, fcntl.LOCK_EX | fcntl.LOCK_NB)\n"
             "except BlockingIOError:\n    sys.exit(3)\n")
    with _build._machine_lock():
        held = subprocess.run([sys.executable, "-c", probe, str(tmp_path / "build.lock")],
                              timeout=60)
    free = subprocess.run([sys.executable, "-c", probe, str(tmp_path / "build.lock")], timeout=60)
    assert (held.returncode, free.returncode) == (3, 0)


def test_a_collective_the_backend_cannot_carry_raises(monkeypatch):
    """No fallback: NCCL over a CPU mesh and a backend with no known
    transport raise, never switch to another transport."""
    from seesaw_tpu_torch.parallel import mesh as M

    m = M.Mesh((torch.device("cpu"),) * 2, group=object(), rank=0, world=2)
    parts = [torch.zeros(2), torch.ones(2)]
    monkeypatch.setattr(M.dist, "get_backend", lambda group: "nccl")
    with pytest.raises(ValueError, match="NCCL carries CUDA tensors"):
        M.all_gather(m, parts)
    monkeypatch.setattr(M.dist, "get_backend", lambda group: "mpi")
    for fn in (M.all_gather, M.pmax, M.psum, M.rotate, M.gather_to):
        with pytest.raises(ValueError, match="no transport known"):
            fn(m, parts)


def test_only_an_explicit_group_makes_a_process_mesh(tmp_path, monkeypatch):
    """After `init_multihost` a mesh stays in-process unless the group is
    passed; a process mesh given no devices holds this process's own card."""
    import torch.distributed as dist

    from seesaw_tpu_torch.parallel.mesh import make_mesh
    from seesaw_tpu_torch.parallel.multihost import init_multihost, shutdown_multihost

    assert init_multihost(f"file://{tmp_path / 'rendezvous'}", 1, 0, backend="gloo") == (1, 0)
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
        for m in (make_mesh(2), make_mesh(), make_mesh(devices=["cpu"] * 3)):
            assert (m.group, m.world, m.size) == (None, 1, len(m.devices))
        assert make_mesh(2).devices == (torch.device("cuda", 0), torch.device("cuda", 1))
        m = make_mesh(devices=["cpu"] * 2, group=dist.group.WORLD)
        assert (m.group is not None, m.rank, m.world, m.size) == (True, 0, 1, 2)
        m = make_mesh(group=dist.group.WORLD)
        assert m.devices == (torch.device("cuda", 1),) and m.group is not None
    finally:
        shutdown_multihost()


if __name__ == "__main__" and len(sys.argv) == 7 and sys.argv[1] == "--child":
    child_main(*(int(a) for a in sys.argv[2:6]), sys.argv[6])
