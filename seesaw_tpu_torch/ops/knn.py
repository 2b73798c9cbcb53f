"""Exact kNN construction as blocked matrix products.

Counterpart of `seesaw_tpu/ops/knn.py` (`exact_knn`): for each block of
query rows, the similarities to a chunk of columns come from one f32
`torch.matmul`, a per-chunk top-k selects that chunk's best, and a running
merge keeps each row's k best so far. The result is the JAX package's to the
bit where the similarities are: ids ordered by (similarity desc, column id
asc), self-edges excluded, k capped at N-1, cosine distance
`clip(1 - dot, 0)` (vectors are expected L2-normalized).

Ties are exact. `torch.topk` documents no order among equal values, nor
which of several values equal to the k-th it keeps; so a row of a chunk
whose k-th value has more copies in the chunk than the selection holds is
selected again: every element above the k-th value, then the copies of it
with the lowest column ids. The merge sorts on (-similarity, id), so
duplicate rows (bit-equal similarities) come out lowest id first, as
`lax.top_k` and the JAX package's two-key sorts order them.

Left out, as TPU workarounds the card does not need: the two-level
segment-max selection (it exists because `lax.top_k` streamed slowly on the
TPU), the watchdog-bounded dispatch groups with their download pipeline,
the small-N single-program switch, and the zero padding of the matrix to a
multiple of the block (which, with a block that does not divide the chunk,
corrupts the JAX build's tail rows). Any `block_size` works here: the last
block and chunk are just shorter.

The product is f32 on the device. Whether a CUDA matmul may use TF32
(`torch.backends.cuda.matmul.allow_tf32`) is the caller's choice, as for
every f32 product in this package.
"""
from __future__ import annotations

import numpy as np
import torch

BLOCK_ROWS = 4096  # query rows a block
CHUNK_COLS = 1 << 16  # columns a chunk: a (4096, 65536) f32 block is 1 GiB


def _chunk_topk(s: torch.Tensor, kc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, column positions) of each row's kc largest elements of `s`,
    where among the copies of the kc-th value the lowest positions are kept.
    One host read a call (whether any row needs its selection redone)."""
    vals, idx = torch.topk(s, kc, dim=1)
    kth = vals[:, -1:]
    # a row is ambiguous when the chunk holds more copies of its kc-th value
    # than topk kept: which copies it kept is unspecified
    ambiguous = ((s == kth).sum(1) > (vals == kth).sum(1)) & torch.isfinite(kth[:, 0])
    rows = ambiguous.nonzero()[:, 0]
    if rows.numel():
        sub, k_sub = s[rows], kth[rows]
        above, equal = sub > k_sub, sub == k_sub
        need = kc - above.sum(1, keepdim=True)
        keep = above | (equal & (equal.cumsum(1) <= need))
        cols = keep.nonzero()[:, 1].view(-1, kc)  # exactly kc a row, ascending
        vals[rows] = sub.gather(1, cols)
        idx[rows] = cols
    return vals, idx


def _merge(best_s, best_i, s, i, k: int):
    """The k best of both candidate lists by (value desc, id asc)."""
    cat_s, cat_i = torch.cat([best_s, s], dim=1), torch.cat([best_i, i], dim=1)
    order = torch.argsort(cat_i, dim=1, stable=True)
    cat_s, cat_i = cat_s.gather(1, order), cat_i.gather(1, order)
    order = torch.argsort(cat_s, dim=1, descending=True, stable=True)[:, :k]
    return cat_s.gather(1, order), cat_i.gather(1, order)


def exact_knn(vectors, n_neighbors: int, block_size: int | None = None, *,
              device) -> tuple[np.ndarray, np.ndarray]:
    """(N, k) neighbour ids (int32) and cosine distances (f32), ascending by
    distance, lower id first on equal similarity; k = min(n_neighbors, N-1).

    `vectors` is an (N, D) numpy array or tensor; the f32 matrix is made on
    `device`, and each block of `block_size` rows is scored against chunks of
    `CHUNK_COLS` columns."""
    block = BLOCK_ROWS if block_size is None else int(block_size)
    if block < 1:
        raise ValueError(f"block_size {block} must be positive")
    V = torch.as_tensor(vectors).to(device=device, dtype=torch.float32).contiguous()
    N = V.shape[0]
    k = max(min(int(n_neighbors), N - 1), 0)
    ids = torch.empty((N, k), dtype=torch.int64, device=V.device)
    sims = torch.empty((N, k), dtype=torch.float32, device=V.device)
    if k:
        for r0 in range(0, N, block):
            r1 = min(r0 + block, N)
            rows = V[r0:r1]
            best_s = sims.new_empty((r1 - r0, 0))
            best_i = ids.new_empty((r1 - r0, 0))
            for c0 in range(0, N, CHUNK_COLS):
                c1 = min(c0 + CHUNK_COLS, N)
                s = rows @ V[c0:c1].T
                s.diagonal(offset=r0 - c0).fill_(float("-inf"))  # self-edges
                cs, ci = _chunk_topk(s, min(k, c1 - c0))
                best_s, best_i = _merge(best_s, best_i, cs, ci + c0, k)
            sims[r0:r1], ids[r0:r1] = best_s, best_i
    dist = (1.0 - sims).clamp_min_(0.0)
    return (ids.to(torch.int32).cpu().numpy(), dist.cpu().numpy())


def assert_knn_close(ids, dist, ref_ids, ref_dist, tol: float) -> dict:
    """Hold a kNN result against a reference for the same rows (both ascending
    by distance, as `exact_knn` returns them):

    - distances agree place by place within `tol`;
    - ids agree as sets within each group of places whose reference
      distances lie within `tol` of their neighbours (near-ties may swap
      under another summation order), except the group that reaches the
      last place, which a neighbour beyond the list may share;
    - in each result, ids ascend across equal distances in (0, 0.5), where
      1 - dot is exact and equal distances mean equal similarities (the tie
      rule).

    Raises AssertionError; returns the largest distance difference and the
    number of places whose ids were compared."""
    ids, ref_ids = np.asarray(ids, np.int64), np.asarray(ref_ids, np.int64)
    dist, ref_dist = np.asarray(dist, np.float64), np.asarray(ref_dist, np.float64)
    if ids.shape != ref_ids.shape or dist.shape != ids.shape or ref_dist.shape != ids.shape:
        raise AssertionError(f"shapes {ids.shape} / {dist.shape} vs {ref_ids.shape}")
    err = float(np.abs(dist - ref_dist).max(initial=0.0))
    if not err <= tol:
        raise AssertionError(f"distances differ by {err!r} > {tol}")
    for name, i, d in (("result", ids, dist), ("reference", ref_ids, ref_dist)):
        tie = (d[:, 1:] == d[:, :-1]) & (d[:, 1:] > 0) & (d[:, 1:] < 0.5)
        if not (i[:, 1:] > i[:, :-1])[tie].all():
            raise AssertionError(f"{name}: equal similarities not in ascending id order")
    group = np.concatenate(
        [np.zeros((ids.shape[0], 1), np.int64),
         np.cumsum(np.diff(ref_dist, axis=1) > tol, axis=1)], axis=1)
    compared = group < group[:, -1:]  # a suffix: the last group
    n = max(int(ids.max(initial=0)), int(ref_ids.max(initial=0))) + 1
    got, want = np.sort(group * n + ids, axis=1), np.sort(group * n + ref_ids, axis=1)
    bad = (got != want) & compared
    if bad.any():
        r = int(np.nonzero(bad.any(axis=1))[0][0])
        raise AssertionError(f"{int(bad.any(axis=1).sum())} rows differ beyond near-ties; "
                             f"row {r}: {ids[r].tolist()} vs {ref_ids[r].tolist()}")
    return {"max_dist_err": err, "ids_compared": int(compared.sum())}
