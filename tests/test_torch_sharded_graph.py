"""The port's mesh graph stack against the JAX package's.

`seesaw_tpu_torch.parallel.sharded_graph` (the ring kNN build and the
row-sharded Jacobi propagation), `KNNGraph.build(mesh=)`,
`LabelPropagation(mesh=)`, `LabelPropagationRanker2(mesh=)` and the
row-block form of `ops.spmv.knn_spmv`, on port meshes of S in {2, 4, 8}
CPU shards, against the JAX package on its 8 virtual CPU devices with the
same numpy inputs. The cases mirror `tests/test_sharded_graph.py` and
`test_sharded_stress.py`: the (n, k) cases, uneven rows, fewer rows than
shards, planted duplicates, both propagation programs of the JAX package
(`sharded_propagate` and, through a windowed layout in interpret mode,
`sharded_propagate_windowed`: the port has one program for both), the
wrapper, and warm-started mesh rankers.

Tolerances: kNN ids equal and distances within 1e-6 (f32 dots of <= 32
terms in another order: the ring's matmuls have other shapes), and within
`assert_knn_close`'s near-tie rule where JAX's planted duplicates meet.
Propagation: the port's sharded scores equal its single-device scores to
the bit (the plain SpMV sums each row alike), and JAX's within rtol 1e-5 /
atol 1e-6 (`tests/test_torch_propagation.py`'s bar); against the JAX
windowed program rtol 2e-5 / atol 2e-6 (its own bar against the XLA step);
warm-started rankers within 1e-4 of a cold single-device ranker (the stop
rule's tolerance, as the JAX test holds them).
"""
import numpy as np
import pytest
import torch

from seesaw_tpu.knn_graph import KNNGraph as JKNNGraph
from seesaw_tpu.knn_graph import rbf_kernel as jrbf
from seesaw_tpu.knn_graph import symmetrize_weights as jsym
from seesaw_tpu.label_propagation import LabelPropagation as JLP
from seesaw_tpu.parallel import make_mesh as jax_mesh
from seesaw_tpu.parallel import sharded_exact_knn as jax_sharded_knn
from seesaw_tpu.parallel import sharded_propagate as jax_sharded_propagate
from seesaw_tpu_torch.knn_graph import KNNGraph, rbf_kernel, symmetrize_weights
from seesaw_tpu_torch.label_propagation import LabelPropagation
from seesaw_tpu_torch.ops import spmv
from seesaw_tpu_torch.ops.knn import assert_knn_close, exact_knn
from seesaw_tpu_torch.ops.propagation import propagate
from seesaw_tpu_torch.parallel import mesh as tmesh
from seesaw_tpu_torch.parallel import sharded_graph as tsg

SHARDS = [2, 4, 8]
PROP_TOL = dict(rtol=1e-5, atol=1e-6)


def cpu_mesh(S):
    return tmesh.make_mesh(devices=["cpu"] * S)


@pytest.fixture(scope="module")
def jmesh():
    return jax_mesh(8)


def _unit(rng, n, d):
    v = rng.normal(size=(n, d))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("n,k", [(64, 5), (100, 8), (37, 3), (8, 7), (13, 4), (3, 2)])
def test_sharded_knn_matches_jax(jmesh, n, k, S):
    """(3, 2) has fewer rows than every S; 13 and 37 divide by none."""
    V = _unit(np.random.default_rng(n), n, 16)
    ids, dist = tsg.sharded_exact_knn(V, k, cpu_mesh(S))
    j_ids, j_dist = jax_sharded_knn(V, k, jmesh)
    one_ids, one_dist = exact_knn(V, k, device="cpu")
    np.testing.assert_array_equal(ids, np.asarray(j_ids))
    np.testing.assert_allclose(dist, np.asarray(j_dist), atol=1e-6)
    np.testing.assert_array_equal(ids, one_ids)
    np.testing.assert_allclose(dist, one_dist, atol=1e-6)
    assert ids.dtype == np.int32 and dist.dtype == np.float32


@pytest.mark.parametrize("S", [3, 8])
def test_sharded_knn_planted_duplicates(jmesh, S):
    """Duplicate clusters (similarities above 1 under rounding, exact ties
    across shards) at 2,037 rows: ties come out lowest id first, as on one
    device and in JAX."""
    rng = np.random.default_rng(6)
    V = _unit(rng, 2037, 16)
    V[500:510] = V[17]
    V[1999] = V[2]
    ids, dist = tsg.sharded_exact_knn(V, 8, cpu_mesh(S), block_size=256)
    j_ids, j_dist = jax_sharded_knn(V, 8, jmesh)
    assert_knn_close(ids, dist, np.asarray(j_ids), np.asarray(j_dist), 1e-6)
    one_ids, one_dist = exact_knn(V, 8, device="cpu")
    assert_knn_close(ids, dist, one_ids, one_dist, 1e-6)
    assert ids[17].tolist()[:8] == ([500, 501, 502, 503, 504, 505, 506, 507])


def test_exact_select_orders_ties_by_column():
    s = torch.tensor([[1.0, 3.0, 3.0, -0.0, 0.0, float("-inf"), 3.0],
                      [-2.0, -1.0, -1.0, -3.0, 5.0, 5.0, -1.0]])
    vals, pos = tsg._exact_select(s, 4)
    assert pos.tolist() == [[1, 2, 6, 0], [4, 5, 1, 2]]
    assert vals.tolist() == [[3.0, 3.0, 3.0, 1.0], [5.0, 5.0, -1.0, -1.0]]
    _, pos = tsg._exact_select(s[:1], 6)
    assert pos.tolist()[0][4:] == [3, 4]  # -0.0 and 0.0 tie: lower column first


@pytest.mark.parametrize("S", [2, 8])
def test_knn_graph_build_with_mesh(jmesh, S):
    V = _unit(np.random.default_rng(3), 50, 12)
    g = KNNGraph.build(V, 6, mesh=cpu_mesh(S))
    j = JKNNGraph.build(V, 6, mesh=jmesh)
    np.testing.assert_array_equal(g.dst, j.dst)
    np.testing.assert_allclose(g.dist, j.dist, atol=1e-6)
    one = KNNGraph.build(V, 6, mesh=cpu_mesh(1))  # a one-device mesh: one device
    np.testing.assert_array_equal(one.dst, g.dst)


def test_row_block_spmv_plain():
    """The row-block form: R rows of a graph with global column ids over
    the whole f give those rows of W f; the square form still refuses a
    shorter or longer f."""
    rng = np.random.default_rng(0)
    n, K = 50, 6
    nbr = torch.from_numpy(rng.integers(-1, n, size=(n, K)).astype(np.int32))
    w = torch.from_numpy(rng.random((n, K)).astype(np.float32))
    f = torch.from_numpy(rng.random(n).astype(np.float32))
    full = spmv.knn_spmv_plain(f, nbr, w)
    for lo, hi in ((0, 13), (13, 26), (39, 50)):
        got = spmv.knn_spmv(f, nbr[lo:hi], w[lo:hi], row_block=True)
        assert torch.equal(got, full[lo:hi])
    with pytest.raises(ValueError):
        spmv.knn_spmv(f[:10], nbr[:13], w[:13], row_block=True)
    with pytest.raises(ValueError):
        spmv.knn_spmv(f, nbr[:13], w[:13])


def _problem(seed, n, k=6, d=16):
    rng = np.random.default_rng(seed)
    V = _unit(rng, n, d)
    g = exact_knn(V, k, device="cpu")
    tw = symmetrize_weights(KNNGraph(*g), rbf_kernel(0.5))
    jw = jsym(JKNNGraph(*g), jrbf(0.5))
    ids = rng.choice(n, size=4, replace=False)
    labels = np.zeros(n, np.float32)
    labels[ids] = [1.0, 0.0, 1.0, 0.0]
    is_labeled = np.zeros(n, bool)
    is_labeled[ids] = True
    prior = rng.uniform(0.1, 0.9, size=n).astype(np.float32)
    return tw, jw, prior, labels, is_labeled


def _segments(n_iter, c, max_iter):
    """The segments a mesh run that stops after n_iter steps launches: 4
    steps, doubling up to c, max_iter in all."""
    segs, n = [], min(4, c)
    while sum(segs) < n_iter:
        segs.append(min(n, max_iter - sum(segs)))
        n = min(2 * n, c)
    return segs


@pytest.mark.parametrize("S", SHARDS)
@pytest.mark.parametrize("reg_lambda", [0.5, 2.0])
def test_sharded_propagate_matches_jax(jmesh, S, reg_lambda):
    tw, jw, prior, labels, is_labeled = _problem(7, 90)
    args = (prior, labels, is_labeled, prior.copy())
    kw = dict(reg_lambda=reg_lambda, max_iter=200, epsilon=1e-10)
    got = tsg.sharded_propagate(tw.nbr, tw.w, tw.degree, *args, cpu_mesh(S), **kw,
                                dispatch_iters=17)
    one = propagate(*(torch.from_numpy(x) for x in (tw.nbr, tw.w, tw.degree, *args)), **kw)
    assert torch.equal(got.scores, one.scores)
    assert (got.n_iter, got.converged) == (one.n_iter, one.converged)
    assert got.host_reads == len(_segments(got.n_iter, 17, 200))  # one read a segment
    want = jax_sharded_propagate(jw.nbr, jw.w, jw.degree, *args, jmesh, **kw)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want), **PROP_TOL)


def test_sharded_propagate_stops_at_max_iter():
    tw, _, prior, labels, is_labeled = _problem(8, 60)
    got = tsg.sharded_propagate(tw.nbr, tw.w, tw.degree, prior, labels, is_labeled, prior,
                                cpu_mesh(4), reg_lambda=0.1, max_iter=7, epsilon=0.0,
                                dispatch_iters=3)
    one = propagate(*(torch.from_numpy(x) for x in
                      (tw.nbr, tw.w, tw.degree, prior, labels, is_labeled, prior)),
                    reg_lambda=0.1, max_iter=7, epsilon=0.0)
    assert (got.n_iter, got.converged, got.host_reads) == (7, False, 3)
    assert torch.equal(got.scores, one.scores)


def test_mesh_segments_grow(monkeypatch):
    """Segments start at 4 steps and double up to dispatch_iters, so a run
    that converges in a few steps launches the SpMV for a few, once per
    shard per launched step."""
    assert list(tsg.segment_lengths(300, 100)) == [4, 8, 16, 32, 64, 100, 76]
    assert list(tsg.segment_lengths(7, 3)) == [3, 3, 1]
    assert list(tsg.segment_lengths(20)) == [4, 8, 8]
    calls = []
    spmv_one = tsg.knn_spmv
    monkeypatch.setattr(tsg, "knn_spmv", lambda *a, **k: calls.append(1) or spmv_one(*a, **k))
    tw, _, prior, labels, is_labeled = _problem(10, 80)
    for eps in (1e-2, 1e-4, 1e-8):
        calls.clear()
        got = tsg.sharded_propagate(tw.nbr, tw.w, tw.degree, prior, labels, is_labeled,
                                    prior, cpu_mesh(4), reg_lambda=1.0, max_iter=300,
                                    epsilon=eps, dispatch_iters=100)
        segs = _segments(got.n_iter, 100, 300)
        assert got.converged and got.host_reads == len(segs)
        assert len(calls) == 4 * sum(segs) < 4 * (2 * got.n_iter + 4)


@pytest.mark.parametrize("S", [3, 8])
def test_sharded_propagate_matches_jax_windowed(jmesh, S):
    """The JAX package's mesh windowed program (the Pallas lane-shuffle
    layout, relabeled; interpret mode) against the port's one program."""
    import dataclasses

    from seesaw_tpu.ops.pallas_spmv import apply_order, build_windowed_layout, rcm_order
    from seesaw_tpu.parallel.sharded_graph import sharded_propagate_windowed

    tw, jw, prior, labels, is_labeled = _problem(9, 300)
    order = rcm_order(jw.nbr)
    nbr2, w2, _ = apply_order(jw.nbr, jw.w, order)
    layout = dataclasses.replace(build_windowed_layout(nbr2, w2, B=128, W=512, cap=8),
                                 order=order)
    kw = dict(reg_lambda=1.0, max_iter=100, epsilon=1e-8)
    want = sharded_propagate_windowed(layout, jw.degree, prior, labels, is_labeled,
                                      prior.copy(), jmesh, **kw)
    got = tsg.sharded_propagate(tw.nbr, tw.w, tw.degree, prior, labels, is_labeled,
                                prior.copy(), cpu_mesh(S), **kw)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("S", SHARDS)
def test_label_propagation_with_mesh(jmesh, S):
    """`LabelPropagation(mesh=)` against JAX's and the port's one device."""
    tw, jw, prior, *_ = _problem(11, 40, k=5, d=8)
    kw = dict(label_ids=np.array([1, 20]), label_values=np.array([1.0, 0.0]),
              reg_values=prior)
    lp = LabelPropagation(tw, reg_lambda=1.0, max_iter=150, epsilon=1e-10, mesh=cpu_mesh(S))
    assert lp.device == torch.device("cpu") and lp.mesh.size == S
    got = lp.fit_transform(**kw)
    one = LabelPropagation(tw, reg_lambda=1.0, max_iter=150, epsilon=1e-10,
                           device="cpu").fit_transform(**kw)
    np.testing.assert_array_equal(got, one)
    want = JLP(jw, reg_lambda=1.0, max_iter=150, epsilon=1e-10, mesh=jmesh).fit_transform(**kw)
    np.testing.assert_allclose(got, want, **PROP_TOL)
    assert lp.mesh_graph() is lp.mesh_graph()  # sharded once per mesh


def test_label_propagation_large_ragged(jmesh):
    """10,003 rows (ragged for 8 shards), 64 labels, against JAX."""
    rng = np.random.default_rng(7)
    n, k = 10_003, 8
    dst = np.empty((n, k), dtype=np.int32)
    for j in range(k):
        dst[:, j] = (np.arange(n) + rng.integers(1, n)) % n
    dist = rng.uniform(0.05, 0.9, size=(n, k)).astype(np.float32)
    tw = symmetrize_weights(KNNGraph(dst, dist), rbf_kernel(0.5))
    jw = jsym(JKNNGraph(dst, dist), jrbf(0.5))
    prior = rng.uniform(0.1, 0.9, size=n).astype(np.float32)
    ids = rng.choice(n, size=64, replace=False)
    vals = rng.integers(0, 2, size=64).astype(np.float32)
    kw = dict(reg_lambda=1.0, max_iter=80, epsilon=1e-8)
    fit = dict(label_ids=ids, label_values=vals, reg_values=prior)
    got = LabelPropagation(tw, mesh=cpu_mesh(8), **kw).fit_transform(**fit)
    want = JLP(jw, mesh=jmesh, **kw).fit_transform(**fit)
    np.testing.assert_allclose(got, want, **PROP_TOL)
    np.testing.assert_allclose(got[ids], vals, atol=1e-6)


@pytest.mark.parametrize("S", [2, 4])
def test_mesh_ranker_warm_start(jmesh, S):
    """`LabelPropagationRanker2(mesh=, warm_start=True)` runs its rounds
    through the sharded program without deferring, and its converged
    scores agree with a cold single-device ranker's and with JAX's mesh
    ranker."""
    from seesaw_tpu.loops.knn_methods import LabelPropagationRanker2 as JRanker
    from seesaw_tpu_torch.loops.knn_methods import LabelPropagationRanker2
    from seesaw_tpu_torch.ops.propagation import DeferredPropagation

    rng = np.random.default_rng(23)
    n = 96
    V = _unit(rng, n, 8)
    g = exact_knn(V, 5, device="cpu")
    tw = symmetrize_weights(KNNGraph(*g), rbf_kernel(0.5))
    jw = jsym(JKNNGraph(*g), jrbf(0.5))
    opts = dict(normalize_scores=True, normalize_epsilon=0.1, sigmoid_before_propagate=True,
                calib_a=2.0, calib_b=-0.5, prior_weight=1.0)
    single = LabelPropagationRanker2(weights=tw, device="cpu", **opts)
    sharded = LabelPropagationRanker2(weights=tw, mesh=cpu_mesh(S), warm_start=True, **opts)
    jsharded = JRanker(weights=jw, mesh=jmesh, warm_start=True, **opts)
    for r in (single, sharded, jsharded):
        r.lp.epsilon = 1e-12
        r.lp.max_iter = 5000
    assert not sharded._defer_available() and single._defer_available()
    base = rng.normal(size=n).astype(np.float32)
    for r in (single, sharded, jsharded):
        r.set_base_scores(base)
    for ids, labs in [([4], [1.0]), ([50], [0.0]), ([7, 8], [1.0, 0.0])]:
        for r in (single, sharded, jsharded):
            r.update(ids, labs)
        assert not isinstance(sharded.current_scores_any(), DeferredPropagation)
        got = sharded.current_scores()
        np.testing.assert_allclose(got, single.current_scores(), atol=1e-4)
        np.testing.assert_allclose(got, jsharded.current_scores(), atol=1e-4)
    # the rounds with a negative propagated: one host read a segment
    res = sharded.last_result
    assert res.converged and res.host_reads == len(
        _segments(res.n_iter, sharded.lp.dispatch_iters, sharded.lp.max_iter))


def test_make_knn_graphs_batch_over_mesh(tmp_path):
    """`build_one` over a CPU mesh saves the graph that one device builds;
    `--sharded` without a card is refused with a usage error."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from synth import build_synthetic_root

    from seesaw_tpu_torch.dataset import GlobalDataManager
    from seesaw_tpu_torch.ingest import make_knn_graphs_batch as mkb

    build_synthetic_root(str(tmp_path), dataset_name="kg")
    ds = GlobalDataManager(str(tmp_path)).get_dataset("kg")
    mkb.build_one(ds, "multiscale", knng_name="mesh", n_neighbors=6, device="cpu",
                  mesh=cpu_mesh(4))
    mkb.build_one(ds, "multiscale", knng_name="one", n_neighbors=6, device="cpu")
    base = Path(ds.path) / "indices" / "multiscale" / "knn_graph"
    a, b = KNNGraph.from_file(base / "mesh"), KNNGraph.from_file(base / "one")
    np.testing.assert_array_equal(a.dst, b.dst)
    np.testing.assert_allclose(a.dist, b.dist, atol=1e-6)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit):
            mkb.main(["--root", str(tmp_path), "--dataset", "kg", "--sharded",
                      "--device", "cpu"])


@pytest.mark.cuda
@pytest.mark.parametrize("S", [2, 4])
def test_cuda_mesh_propagation_launches_row_block_kernel(S):
    """On a card (S shards on cuda:0): the row-block kernel equals its plain
    version on every block, and a mesh propagation launches it once per
    shard per launched step, its scores within PROP_TOL of the one-device
    Jacobi kernel's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dev = torch.device("cuda", 0)
    tw, _, prior, labels, is_labeled = _problem(12, 3001, k=13)
    nbr, w = torch.from_numpy(tw.nbr).to(dev), torch.from_numpy(tw.w).to(dev)
    f = torch.rand(tw.nvecs, device=dev)
    for lo, hi in ((0, 1000), (1000, 2001), (2001, 3001)):
        got = spmv.knn_spmv(f, nbr[lo:hi], w[lo:hi], row_block=True)
        want = spmv.knn_spmv_plain(f, nbr[lo:hi], w[lo:hi], row_block=True)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-6)
    mesh = tmesh.make_mesh(devices=[dev] * S)
    before = spmv.knn_spmv.launches
    got = tsg.sharded_propagate(tw.nbr, tw.w, tw.degree, prior, labels, is_labeled, prior,
                                mesh, reg_lambda=1.0, max_iter=300, epsilon=1e-8,
                                dispatch_iters=20)
    launched = spmv.knn_spmv.launches - before
    one = propagate(*(torch.from_numpy(x).to(dev) for x in
                      (tw.nbr, tw.w, tw.degree, prior, labels, is_labeled, prior)),
                    reg_lambda=1.0, max_iter=300, epsilon=1e-8, dispatch_iters=20)
    assert (got.n_iter, got.converged) == (one.n_iter, one.converged)
    segs = _segments(got.n_iter, 20, 300)
    assert got.host_reads == len(segs) and launched == S * sum(segs)
    torch.testing.assert_close(got.scores, one.scores, **PROP_TOL)
