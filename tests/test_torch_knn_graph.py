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
