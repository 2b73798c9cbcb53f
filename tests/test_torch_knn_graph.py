"""The port's kNN graph module (`seesaw_tpu_torch.knn_graph`) against the
JAX package's, on the same `forward.parquet`: reading, restricting,
symmetrizing and forward weighting must be exactly equal (both are the same
numpy code), and either package reads the other's saved graph."""
import numpy as np
import pytest
import torch

from seesaw_tpu import knn_graph as jkg
from seesaw_tpu_torch import knn_graph as tkg


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(300, 12)).astype(np.float32)
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    path = tmp_path_factory.mktemp("knng") / "knn_graph"
    jkg.KNNGraph.build(X, n_neighbors=8).save(path)
    return path


@pytest.mark.parametrize("k", [8, 5])
def test_graph_and_weights_equal_jax(saved, k):
    jg = jkg.KNNGraph.from_file(saved).restrict_k(k=k)
    tg = tkg.KNNGraph.from_file(saved).restrict_k(k=k)
    assert tg.k == k and tg.nvecs == jg.nvecs
    np.testing.assert_array_equal(tg.dst, jg.dst)
    np.testing.assert_array_equal(tg.dist, jg.dist)
    for fn in ("symmetrize_weights", "forward_weights"):
        jw = getattr(jkg, fn)(jg, jkg.rbf_kernel(0.3))
        tw = getattr(tkg, fn)(tg, tkg.rbf_kernel(0.3))
        for field in ("nbr", "w", "degree"):
            np.testing.assert_array_equal(getattr(tw, field), getattr(jw, field))
        X = np.random.default_rng(1).normal(size=(tw.nvecs, 4))
        np.testing.assert_array_equal(tw.xlx(X), jw.xlx(X))


def test_save_round_trip_both_ways(saved, tmp_path):
    tg = tkg.KNNGraph.from_file(saved)
    tg.save(tmp_path / "again")
    jg = jkg.KNNGraph.from_file(tmp_path / "again")
    np.testing.assert_array_equal(jg.dst, tg.dst)
    np.testing.assert_array_equal(jg.dist, tg.dist)


def test_device_arrays_cached_per_device(saved):
    w = tkg.symmetrize_weights(tkg.KNNGraph.from_file(saved), tkg.rbf_kernel(0.3))
    nbr, wt, deg = w.device_arrays("cpu")
    assert nbr.dtype == torch.int32 and wt.dtype == deg.dtype == torch.float32
    assert w.device_arrays(torch.device("cpu"))[0] is nbr  # one copy per device
    np.testing.assert_array_equal(nbr.numpy(), w.nbr)
    # tensor fields (a graph made on the device) are used as they are
    t = tkg.SymmetricWeights(nbr=nbr, w=wt, degree=deg)
    assert t.nvecs == w.nvecs and t.device_arrays("cpu")[1] is wt


# -- the build and the helpers of the offline slice ---------------------------
@pytest.fixture(scope="module")
def built():
    """Both packages' exact builds of the same unit rows, with a duplicate
    group, and a frame id per row (5 tiles a frame)."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(400, 12)).astype(np.float32)
    X[[10, 11, 300]] = X[42]
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    dbidx = np.repeat(np.arange(80), 5)
    return X, dbidx, jkg.KNNGraph.build(X, 8), tkg.KNNGraph.build(X, 8, device="cpu")


def test_build_equals_jax(built):
    """Ids equal (ties lowest id first), distances at 1e-6 (f32 dots summed
    in another order)."""
    _, _, jg, tg = built
    np.testing.assert_array_equal(tg.dst, jg.dst)
    np.testing.assert_allclose(tg.dist, jg.dist, rtol=0, atol=1e-6)
    assert tg.dst[42, :3].tolist() == [10, 11, 300]


def test_reverse_adjacency_equals_jax(built):
    _, _, jg, tg = built
    for got, want in zip(tg.reverse_adjacency(), jg.reverse_adjacency()):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


@pytest.mark.parametrize("k_intra,k_inter", [(0, 1), (2, 1), (1, 3)])
def test_factor_neighbors_equals_jax(built, k_intra, k_inter):
    _, dbidx, jg, _ = built
    tg = tkg.KNNGraph(jg.dst, jg.dist)  # the same edges: the numpy alone
    got = tkg.factor_neighbors(tg, dbidx, k_intra=k_intra, k_inter=k_inter)
    want = jkg.factor_neighbors(jg, dbidx, k_intra=k_intra, k_inter=k_inter)
    np.testing.assert_array_equal(got.dst, want.dst)
    np.testing.assert_array_equal(got.dist, want.dist)


@pytest.mark.parametrize("kernel", ["rbf", "knn"])
def test_laplacian_quadratic_and_kernels_equal_jax(built, kernel):
    _, _, jg, _ = built
    tg = tkg.KNNGraph(jg.dst, jg.dist)
    jk, tk = ((jkg.rbf_kernel(0.3), tkg.rbf_kernel(0.3)) if kernel == "rbf"
              else (jkg.knn_kernel(0.5), tkg.knn_kernel(0.5)))
    np.testing.assert_array_equal(tk(tg.dist), jk(jg.dist))
    jw, tw = jkg.symmetrize_weights(jg, jk), tkg.symmetrize_weights(tg, tk)
    x = np.random.default_rng(4).normal(size=tg.nvecs)
    assert tw.laplacian_quadratic(x) == jw.laplacian_quadratic(x)
    # x^T L x from the weights' own Laplacian, in f64
    L = np.zeros((tg.nvecs, tg.nvecs))
    for i in range(tg.nvecs):
        for j, w in zip(tw.nbr[i], tw.w[i]):
            if j >= 0:
                L[i, j] -= w
                L[i, i] += w
    assert tw.laplacian_quadratic(x) == pytest.approx(x @ L @ x, rel=1e-5)


def test_simple_knn_ranker_equals_jax(built):
    """Updates (first labels, relabels) and top_k of both rankers, from the
    same base scores."""
    from seesaw_tpu.loops.knn_methods import SimpleKNNRanker as J
    from seesaw_tpu_torch.loops.knn_methods import SimpleKNNRanker as T

    _, _, jg, _ = built
    tg = tkg.KNNGraph(jg.dst, jg.dist)
    base = np.random.default_rng(5).normal(size=tg.nvecs)
    rj, rt = J(jg, init_scores=base), T(tg, init_scores=base)
    np.testing.assert_array_equal(rt.current_scores(), rj.current_scores())
    for idxs, labels in (([42, 3, 10], [1, 0, 1]), ([3, 200], [1, 0]), ([42], [0])):
        rj.update(idxs, labels)
        rt.update(idxs, labels)
        np.testing.assert_array_equal(rt.current_scores(), rj.current_scores())
        for k, unlabeled in ((10, True), (None, False)):
            for got, want in zip(rt.top_k(k, unlabeled), rj.top_k(k, unlabeled)):
                np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(T(tg).current_scores(), J(jg).current_scores())
