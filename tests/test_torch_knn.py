"""The port's exact kNN build (`seesaw_tpu_torch.ops.knn.exact_knn`) against
the JAX package's `seesaw_tpu.ops.knn.exact_knn`, on the CPU.

The JAX build takes one dispatch up to N = 8192 and row blocks times column
chunks above; N = 500 and N = 9000 fall on each side. Both compute the dots
in f32 on the CPU; the tests hold ids equal and distances at 1e-6, on
inputs with planted duplicate rows (bit-equal similarities, which both
order lowest id first).
"""
import numpy as np
import pytest
import torch

from seesaw_tpu.ops.knn import exact_knn as jax_knn
from seesaw_tpu_torch.ops import knn
from seesaw_tpu_torch.ops.knn import assert_knn_close, exact_knn


def unit_rows(n, d, seed, dups=()):
    """Seeded unit rows; each (src, dsts) in `dups` copies row src over dsts."""
    X = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    for src, dsts in dups:
        X[list(dsts)] = X[src]
    return X / np.linalg.norm(X, axis=1, keepdims=True)


CASES = {  # N: (d, k, planted duplicate groups)
    500: (16, 10, [(3, range(250, 255)), (7, [100]), (499, [0, 498])]),
    9000: (16, 10, [(3, range(4500, 4505)), (7, [100]), (8999, [0, 4096, 8191])]),
}


@pytest.fixture(scope="module", params=sorted(CASES), ids=lambda n: f"N{n}")
def case(request):
    n = request.param
    d, k, dups = CASES[n]
    X = unit_rows(n, d, seed=n, dups=dups)
    return X, k, dups, jax_knn(X, k)


def test_matches_jax(case):
    X, k, dups, (want_ids, want_dist) = case
    ids, dist = exact_knn(X, k, device="cpu")
    assert ids.dtype == np.int32 and dist.dtype == np.float32 and ids.shape == (X.shape[0], k)
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=1e-6)
    assert (dist[:, 1:] >= dist[:, :-1]).all()
    assert (ids != np.arange(X.shape[0])[:, None]).all()  # no self-edges


def test_planted_ties_lowest_id_first(case):
    """A duplicate group's members come out adjacent and ascending, and the
    lowest ids of the group are the ones kept."""
    X, k, dups, (want_ids, _) = case
    ids, _ = exact_knn(X, k, device="cpu")
    for src, dsts in dups:
        group = sorted({src, *dsts})
        for row in group:
            others = [g for g in group if g != row]
            want = others[:k]
            np.testing.assert_array_equal(ids[row, :len(want)], want)
            np.testing.assert_array_equal(want_ids[row, :len(want)], want)


def test_any_block_and_chunk_size(case, monkeypatch):
    """Blocks and chunks that divide neither N nor each other give the
    default's result: the same ids, distances at 1e-6 (the CPU GEMM sums a
    dot in an order that depends on the block's shape; measured 1.8e-7).
    The JAX build is not run at such sizes."""
    X, k, _, _ = case
    ids, dist = exact_knn(X, k, device="cpu")
    for block, chunk in ((333, 777), (1, 4096), (4097, 13)):
        if X.shape[0] > 1000 and block == 1:
            block = 997
        monkeypatch.setattr(knn, "CHUNK_COLS", chunk)
        ids2, dist2 = exact_knn(torch.from_numpy(X), k, block, device="cpu")
        np.testing.assert_array_equal(ids2, ids)
        np.testing.assert_allclose(dist2, dist, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n,k", [(5, 10), (2, 3), (1, 4), (6, 5)])
def test_k_capped_at_n_minus_1(n, k):
    X = unit_rows(n, 4, seed=n)
    ids, dist = exact_knn(X, k, device="cpu")
    want_ids, want_dist = jax_knn(X, k)
    assert ids.shape == dist.shape == (n, min(k, n - 1))
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_allclose(dist, want_dist, rtol=0, atol=1e-6)


def test_all_rows_equal(monkeypatch):
    """Every similarity ties: each row's neighbours are the lowest other ids,
    in order, and the chunk selection must pick them (not any k of them)."""
    X = np.tile(unit_rows(1, 8, seed=0), (40, 1))
    want_ids, want_dist = jax_knn(X, 6)
    for chunk in (knn.CHUNK_COLS, 7):
        monkeypatch.setattr(knn, "CHUNK_COLS", chunk)
        ids, dist = exact_knn(X, 6, device="cpu")
        np.testing.assert_array_equal(ids, want_ids)
        np.testing.assert_allclose(dist, want_dist, rtol=0, atol=1e-6)
    assert ids[0].tolist() == [1, 2, 3, 4, 5, 6] and ids[5].tolist() == [0, 1, 2, 3, 4, 6]


def test_bad_sizes_raise():
    with pytest.raises(ValueError):
        exact_knn(unit_rows(4, 4, 0), 2, 0, device="cpu")


def test_assert_knn_close_rules():
    ids = np.array([[1, 2, 3, 4], [0, 2, 3, 4]])
    dist = np.array([[0.1, 0.2, 0.2 + 1e-7, 0.3], [0.1, 0.2, 0.3, 0.4]], np.float32)
    # a near-tie swap passes; the last place may differ (a neighbour beyond)
    swapped = np.array([[1, 3, 2, 4], [0, 2, 3, 9]])
    out = assert_knn_close(swapped, dist, ids, dist, 1e-6)
    assert out["ids_compared"] == 6
    with pytest.raises(AssertionError, match="rows differ"):
        assert_knn_close(np.array([[2, 1, 3, 4], [0, 2, 3, 4]]), dist, ids, dist, 1e-6)
    with pytest.raises(AssertionError, match="distances differ"):
        assert_knn_close(ids, dist + 1e-5, ids, dist, 1e-6)
    # equal similarities (equal distances in (0, 0.5)) must ascend by id
    tied = np.array([[0.1, 0.2, 0.2, 0.3], [0.1, 0.2, 0.3, 0.4]], np.float32)
    with pytest.raises(AssertionError, match="ascending id"):
        assert_knn_close(swapped, tied, ids, tied, 1e-6)
