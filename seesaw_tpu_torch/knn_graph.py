"""kNN graph: fixed-degree arrays, symmetrization, RBF weights.

Counterpart of `seesaw_tpu/knn_graph.py`. The graph is a padded
fixed-degree structure: after symmetrization every vertex holds up to Kp
neighbors in dense (N, Kp) id/weight arrays, with -1 padding. The host-side
functions are numpy and copied as they are from the JAX package, so both
packages build the same weights from the same `forward.parquet`:

- edge weight = kernel(distance); the symmetrized union of both directions
  counts a mutual edge once; self-edges are removed;
- degree = row weight sum;
- persistence: `forward.parquet` with (src_vertex, dst_vertex, distance,
  dst_rank) rows including rank-0 self edges, the reference's format.

`KNNGraph.build` runs the exact blocked build of `ops.knn` on an explicit
device, or over a mesh of devices (`parallel.sharded_graph.
sharded_exact_knn`); `factor_neighbors` is the JAX package's numpy as it
is.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable

import numpy as np
import torch


# rows a chunk of the device XLX sums at once: 64k x 512 f32 is 128 MB a
# gathered neighbour slot
XLX_CHUNK_ROWS = 1 << 16


def rbf_kernel(edist: float) -> Callable[[np.ndarray], np.ndarray]:
    """exp(-d/edist): weight falls to 1/e when cosine distance grows by edist."""
    assert edist > 0

    def kernel(arr: np.ndarray) -> np.ndarray:
        assert arr.min(initial=0.0) >= -1e-4
        return np.exp(-arr.astype(np.float64) / edist)

    return kernel


def knn_kernel(edist: float = 2.1) -> Callable[[np.ndarray], np.ndarray]:
    """Unit weight for every edge within distance edist."""
    assert edist > 0

    def kernel(arr: np.ndarray) -> np.ndarray:
        return (arr <= edist).astype(np.float32)

    return kernel


class KNNGraph:
    """Forward kNN edges in fixed-degree form: dst (N,K), dist (N,K),
    ascending by distance per row (self-edges excluded)."""

    def __init__(self, dst: np.ndarray, dist: np.ndarray):
        assert dst.shape == dist.shape and dst.ndim == 2
        self.dst = dst.astype(np.int32)
        self.dist = np.clip(dist.astype(np.float32), 0.0, None)

    @property
    def nvecs(self) -> int:
        return self.dst.shape[0]

    @property
    def k(self) -> int:
        return self.dst.shape[1]

    @staticmethod
    def build(vectors, n_neighbors: int, block_size: int | None = None, *, device=None,
              mesh=None) -> "KNNGraph":
        """Exact kNN graph of `vectors` (numpy or a tensor) built on `device`
        (`ops.knn.exact_knn`), or with a `mesh` of several devices the
        sharded ring build over them (a one-device mesh builds on its
        device); over a mesh that spans processes, every process gets the
        whole graph."""
        if mesh is not None and mesh.size > 1:
            from .parallel.sharded_graph import sharded_exact_knn

            return KNNGraph(*sharded_exact_knn(vectors, n_neighbors, mesh, block_size))
        from .ops.knn import exact_knn

        if mesh is not None:
            device = mesh.primary
        if device is None:
            raise ValueError("KNNGraph.build needs a device or a mesh")
        return KNNGraph(*exact_knn(vectors, n_neighbors, block_size, device=device))

    def restrict_k(self, *, k: int) -> "KNNGraph":
        assert k <= self.k, f"graph built with k={self.k}, requested {k}"
        if k == self.k:
            return self
        return KNNGraph(self.dst[:, :k], self.dist[:, :k])

    def reverse_adjacency(self) -> tuple[np.ndarray, np.ndarray]:
        """CSR-ish reverse lookup: (indptr (N+1,), src (E,)) where
        src[indptr[v]:indptr[v+1]] are vertices whose kNN list contains v."""
        flat_dst = self.dst.reshape(-1)
        order = np.argsort(flat_dst, kind="stable")
        srcs = (order // self.k).astype(np.int32)
        counts = np.bincount(flat_dst, minlength=self.nvecs)
        indptr = np.zeros(self.nvecs + 1, dtype=np.int64)
        np.cumsum(counts, out=indptr[1:])
        return indptr, srcs

    def save(self, path: str | Path):
        import pandas as pd

        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        N, K = self.dst.shape
        src = np.repeat(np.arange(N, dtype=np.int32), K)
        df = pd.DataFrame(
            {
                "src_vertex": np.concatenate([src, np.arange(N, dtype=np.int32)]),
                "dst_vertex": np.concatenate(
                    [self.dst.reshape(-1), np.arange(N, dtype=np.int32)]
                ),
                "distance": np.concatenate(
                    [self.dist.reshape(-1), np.zeros(N, dtype=np.float32)]
                ),
                "dst_rank": np.concatenate(
                    [np.tile(np.arange(1, K + 1, dtype=np.int32), N),
                     np.zeros(N, dtype=np.int32)]
                ),
            }
        )
        df = df.sort_values(["src_vertex", "dst_rank"]).reset_index(drop=True)
        df.to_parquet(p / "forward.parquet")

    @staticmethod
    def from_file(path: str | Path) -> "KNNGraph":
        import pandas as pd

        df = pd.read_parquet(Path(path) / "forward.parquet")
        df = df[df.src_vertex != df.dst_vertex]  # drop self edges
        df = df.sort_values(["src_vertex", "dst_rank"])
        counts = df.groupby("src_vertex").size()
        N = int(df.src_vertex.max()) + 1
        K = int(counts.max())
        dst = np.full((N, K), -1, dtype=np.int32)
        dist = np.full((N, K), np.inf, dtype=np.float32)
        src = df.src_vertex.values
        rank = df.groupby("src_vertex").cumcount().values
        dst[src, rank] = df.dst_vertex.values
        dist[src, rank] = df.distance.values
        # uniform degree is expected; a ragged graph is clipped to the
        # minimum common degree
        kmin = int(counts.min())
        return KNNGraph(dst[:, :kmin], dist[:, :kmin])


@dataclass
class SymmetricWeights:
    """Padded weighted graph: per-vertex neighbor lists.

    The fields are numpy arrays for a graph read from disk, or tensors for
    a graph made on the device (`utils.rounds.window_local_graph`).
    `device_arrays(device)` caches one tensor copy per device, so sessions
    that share a weight structure (`loops.graph_based.lookup_weights`) share
    one device copy, and a CPU and a CUDA session over the same weights each
    get their own."""

    nbr: np.ndarray  # (N, Kp) int32, -1 padding
    w: np.ndarray  # (N, Kp) float32, 0 padding
    degree: np.ndarray  # (N,) float32 row weight sums
    _device_cache: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def nvecs(self) -> int:
        return self.nbr.shape[0]

    def device_arrays(self, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(nbr int32, w f32, degree f32) contiguous on `device`, made once
        per device."""
        device = torch.device(device)
        key = str(device)
        out = self._device_cache.get(key)
        if out is None:
            out = tuple(
                torch.as_tensor(x, device=device).to(dt).contiguous()
                for x, dt in ((self.nbr, torch.int32), (self.w, torch.float32),
                              (self.degree, torch.float32))
            )
            self._device_cache[key] = out
        return out

    def laplacian_quadratic(self, x: np.ndarray) -> float:
        """x^T L x = 1/2 sum_ij w_ij (x_i - x_j)^2 (each edge once in each
        direction, matching L = D - W)."""
        xi = x[:, None]
        xj = np.where(self.nbr >= 0, x[np.clip(self.nbr, 0, None)], 0.0)
        sq = self.w * (xi - xj) ** 2
        return float(0.5 * sq.sum())

    def apply(self, x: np.ndarray) -> np.ndarray:
        """W @ x for vector or matrix x ((N,) or (N, D))."""
        idx = np.clip(self.nbr, 0, None)
        if x.ndim == 1:
            vals = np.where(self.nbr >= 0, x[idx], 0.0)
            return (self.w * vals).sum(axis=1)
        gathered = x[idx] * (self.nbr >= 0)[..., None]
        return np.einsum("nk,nkd->nd", self.w, gathered)

    def xlx(self, X, normalize_by_trace: bool = True, *, device=None):
        """X^T L X with L = D - W (optionally L / trace(L), the reference's
        scaling for the multi-reg Laplacian term).

        X is a numpy (N, D) array (computed in numpy, as the JAX package
        does), or a function that returns the f32 rows of an int64 row-id
        tensor on `device` (e.g. an index's `rows_f32`): then the product is
        summed over chunks of XLX_CHUNK_ROWS rows on that device, gathering
        each chunk's neighbour rows one slot at a time, so neither the
        (N, K, D) gather nor an f32 copy of X is ever made. Returns numpy for
        numpy X, else a (D, D) f32 tensor on `device`."""
        if isinstance(X, np.ndarray):
            DX = X * self.degree[:, None]
            WX = self.apply(X)
            xlx = X.T @ (DX - WX)
            if normalize_by_trace:
                xlx = xlx / max(self.degree.sum(), 1e-30)
            return xlx
        nbr, w, degree = self.device_arrays(device)
        N, K = nbr.shape
        acc = None
        for lo in range(0, N, XLX_CHUNK_ROWS):
            hi = min(lo + XLX_CHUNK_ROWS, N)
            Xc = X(torch.arange(lo, hi, device=nbr.device))
            M = Xc * degree[lo:hi, None]  # D X
            for k in range(K):  # - W X, one neighbour slot at a time
                col = nbr[lo:hi, k]
                wk = torch.where(col >= 0, w[lo:hi, k], 0.0)
                M.addcmul_(wk[:, None], X(col.clamp(min=0).long()), value=-1.0)
            part = Xc.T @ M
            acc = part if acc is None else acc.add_(part)
        if normalize_by_trace:
            acc = acc / max(float(degree.sum()), 1e-30)
        return acc


def factor_neighbors(
    graph: KNNGraph, dbidx: np.ndarray, k_intra: int, k_inter: int = 1
) -> KNNGraph:
    """Diversified neighbor lists: per vertex keep the k_inter closest
    vectors of each DISTINCT other frame plus up to k_intra same-frame
    neighbors, so that one image's tiles cannot monopolize propagation.
    Returns a padded fixed-degree graph (padding = self-edges with distance
    0, dropped by symmetrize_weights)."""
    N, K = graph.dst.shape
    dbidx = np.asarray(dbidx)
    src_frame = dbidx[np.arange(N)][:, None]  # (N, 1)
    dst_frame = dbidx[graph.dst]  # (N, K)

    intra = dst_frame == src_frame
    # rank among same-frame neighbors (rows already ascending by distance)
    intra_rank = np.cumsum(intra, axis=1)
    keep_intra = intra & (intra_rank <= k_intra)

    # inter: rank within each (row, dst_frame) group by order of appearance,
    # over row chunks: occurrences before column c via a (chunk, K, K)
    # equality mask against earlier columns
    keep_inter = np.zeros_like(intra)
    tril = np.tril(np.ones((K, K), dtype=bool), k=-1)  # earlier columns
    chunk = max(1, 8_000_000 // (K * K))  # bound the (chunk, K, K) temp
    for lo in range(0, N, chunk):
        hi = min(lo + chunk, N)
        f = dst_frame[lo:hi]
        same = f[:, :, None] == f[:, None, :]  # (c, K, K) frame equality
        prior = (same & tril[None]).sum(axis=2)  # occurrences before col
        keep_inter[lo:hi] = (~intra[lo:hi]) & (prior < k_inter)

    keep = keep_intra | keep_inter
    counts = keep.sum(axis=1)
    Kp = max(int(counts.max(initial=1)), 1)
    new_dst = np.repeat(np.arange(N, dtype=np.int32)[:, None], Kp, axis=1)  # self-pad
    new_dist = np.zeros((N, Kp), dtype=np.float32)
    rows, cols = np.nonzero(keep)
    slots = (np.cumsum(keep, axis=1) - 1)[rows, cols]
    new_dst[rows, slots] = graph.dst[rows, cols]
    new_dist[rows, slots] = graph.dist[rows, cols]
    return KNNGraph(new_dst, new_dist)


def forward_weights(
    graph: KNNGraph, kfun: Callable[[np.ndarray], np.ndarray]
) -> SymmetricWeights:
    """Fixed-degree FORWARD adjacency including the self vertex with weight
    0: the reference's `get_weight_matrix(symmetric=False)` followed by
    `setdiag(0)`. Row i holds {i} and its K forward neighbors as exactly K+1
    entries, sorted by neighbor id."""
    N, K = graph.dst.shape
    nbr = np.concatenate(
        [np.arange(N, dtype=np.int32)[:, None], graph.dst.astype(np.int32)], axis=1
    )
    w = np.concatenate(
        [np.zeros((N, 1), np.float32), kfun(graph.dist).astype(np.float32)],
        axis=1,
    )
    order = np.argsort(nbr, axis=1)
    nbr = np.take_along_axis(nbr, order, axis=1)
    w = np.take_along_axis(w, order, axis=1)
    # setdiag(0): zero every self entry, not just the prepended column
    w[nbr == np.arange(N, dtype=np.int32)[:, None]] = 0.0
    return SymmetricWeights(nbr=nbr, w=w, degree=w.sum(axis=1))


def symmetrize_weights(
    graph: KNNGraph, kfun: Callable[[np.ndarray], np.ndarray]
) -> SymmetricWeights:
    """Undirected union of the directed kNN edges, weight = kernel(distance).

    The reference builds W + W^T and divides by the per-edge count; since
    distance (hence weight) is symmetric this equals taking each undirected
    edge once with its kernel weight."""
    N, K = graph.dst.shape
    src = np.repeat(np.arange(N, dtype=np.int64), K)
    dst = graph.dst.reshape(-1).astype(np.int64)
    d = graph.dist.reshape(-1)

    keep = src != dst
    src, dst, d = src[keep], dst[keep], d[keep]
    # canonical undirected key, dedup keeping the first (distances agree)
    lo = np.minimum(src, dst)
    hi = np.maximum(src, dst)
    key = lo * N + hi
    order = np.argsort(key, kind="stable")
    key, lo, hi, d = key[order], lo[order], hi[order], d[order]
    first = np.ones_like(key, dtype=bool)
    first[1:] = key[1:] != key[:-1]
    lo, hi, d = lo[first], hi[first], d[first]

    w = kfun(d).astype(np.float32)
    pos = w > 0  # zero-weight edges are dropped
    lo, hi, w = lo[pos], hi[pos], w[pos]

    # per-vertex adjacency, both directions
    all_src = np.concatenate([lo, hi])
    all_dst = np.concatenate([hi, lo])
    all_w = np.concatenate([w, w])
    deg_count = np.bincount(all_src, minlength=N)
    Kp = max(int(deg_count.max(initial=1)), 1)

    order = np.argsort(all_src, kind="stable")
    all_src, all_dst, all_w = all_src[order], all_dst[order], all_w[order]
    slot = np.arange(all_src.shape[0]) - np.concatenate(
        [[0], np.cumsum(deg_count)]
    )[all_src]

    nbr = np.full((N, Kp), -1, dtype=np.int32)
    wmat = np.zeros((N, Kp), dtype=np.float32)
    nbr[all_src, slot] = all_dst.astype(np.int32)
    wmat[all_src, slot] = all_w
    degree = wmat.sum(axis=1).astype(np.float32)
    return SymmetricWeights(nbr=nbr, w=wmat, degree=degree)
