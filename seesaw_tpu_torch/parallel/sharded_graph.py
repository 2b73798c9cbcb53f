"""Mesh-sharded graph stack: the exact kNN build and Jacobi propagation.

Counterpart of `seesaw_tpu/parallel/sharded_graph.py`.

- **kNN build** (`sharded_exact_knn`): rows are block-sharded over the
  mesh; the column blocks rotate around the ring (`mesh.rotate`, the
  counterpart of `ppermute`), so in S steps every shard scores its rows
  against every column block, one f32 `torch.matmul` per (row block, column
  chunk) as `ops.knn.exact_knn` does. Each chunk's k best come from one
  top-k over a unique int64 key (the similarity's order-preserving bits
  above the column's complement), so the selection orders ties by lower id
  with no host read; a running merge keeps each row's k best by
  (similarity desc, id asc) (`ops.knn._merge`), and the clipped cosine
  distance is taken only at the end. The tie rule is `ops.knn`'s.
- **propagation** (`sharded_propagate`): the padded fixed-degree graph is
  row-sharded; each Jacobi step gathers the score vector onto every shard's
  device, runs the row-block SpMV (`ops.spmv.knn_spmv`, the CUDA kernel on a
  card) once per shard, then the update, the clamp to the labels and the
  `pmax` convergence test. The done flag and the step count stay on the
  devices, and the host reads (steps, done) once a segment, as
  `ops.propagation.propagate` does. A step after convergence changes
  nothing, and a converged run returns the pre-step iterate, as the
  reference does. But on the mesh such a step still costs its gather and
  its launches, so segments start at FIRST_SEGMENT steps and double up to
  `dispatch_iters` (`segment_lengths`): a round that converges in a few
  steps launches a few, at the price of a read for each doubling.

Over a process mesh (`parallel.mesh`) each process runs its own shards'
part of both programs: the ring's rotations, the propagation's gathers and
its `pmax` cross processes, and every process ends with the same (N, k)
arrays, or the same scores, steps and converged flag.

The JAX package's `sharded_propagate_windowed` (its lane-shuffle layout on
the mesh) has no counterpart: the port has no windowed layout, and its
tests are held against `sharded_propagate`. A whole segment in one launch
(`ops.spmv.jacobi_step`) would need a barrier across devices, so the mesh
launches the row-block SpMV once per shard per step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..ops.knn import BLOCK_ROWS, CHUNK_COLS, _merge
from ..ops.propagation import PropagationResult
from ..ops.spmv import knn_spmv
from ..utils.profiling import host_sync
from .mesh import Mesh, all_gather, gather_to, pmax, rotate, split_rows

_SIGN_FLIP = 0x7FFFFFFF
FIRST_SEGMENT = 4  # steps of a mesh propagation's first segment


def _exact_select(s: torch.Tensor, kc: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(values, column positions) of each row's kc largest elements of the
    f32 `s`, equal values by lower column first, with no host read: one
    top-k over unique int64 keys, the value's order-preserving 32 bits times
    2^b plus the column's complement (b bits)."""
    width = s.shape[1]
    shift = max(1, (width - 1).bit_length())
    bits = (s + 0.0).view(torch.int32)  # + 0.0 makes -0.0 equal to +0.0
    ordered = torch.where(bits >= 0, bits, bits ^ _SIGN_FLIP).to(torch.int64)
    col = torch.arange(width - 1, -1, -1, device=s.device, dtype=torch.int64)
    _, pos = torch.topk(ordered * (1 << shift) + col, kc, dim=1)
    return s.gather(1, pos), pos


def sharded_exact_knn(vectors, n_neighbors: int, mesh: Mesh,
                      block_size: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
    """(N, k) neighbour ids (int32) and cosine distances (f32) over a device
    mesh, k = min(n_neighbors, N - 1); the result of `ops.knn.exact_knn` on
    one device, up to the order of the products' sums."""
    block = BLOCK_ROWS if block_size is None else int(block_size)
    V = torch.as_tensor(vectors).to(torch.float32)
    N = V.shape[0]
    k = min(int(n_neighbors), N - 1)
    assert k >= 1, "need at least 2 vectors"
    S = mesh.size
    Ns = -(-N // S)
    rows = [part.contiguous() for part in split_rows(mesh, V, Ns, 0.0)]
    cols = rows
    best = [(torch.empty(Ns, 0, device=r.device),
             torch.empty(Ns, 0, dtype=torch.int64, device=r.device)) for r in rows]
    for t in range(S):  # ring step t: shard s holds column block (s + t) % S
        for j, s in enumerate(mesh.local_shards):
            c = (s + t) % S
            n_valid = min(N - c * Ns, Ns)  # real columns of block c
            sims_best, ids_best = best[j]
            outs_s, outs_i = [], []
            for r0 in range(0, Ns, block):
                r1 = min(r0 + block, Ns)
                bs, bi = sims_best[r0:r1], ids_best[r0:r1]
                for c0 in range(0, n_valid, CHUNK_COLS):
                    c1 = min(c0 + CHUNK_COLS, n_valid)
                    sim = rows[j][r0:r1] @ cols[j][c0:c1].T
                    if c == s:
                        sim.diagonal(offset=r0 - c0).fill_(float("-inf"))  # self-edges
                    cs, ci = _exact_select(sim, min(k, c1 - c0))
                    bs, bi = _merge(bs, bi, cs, ci + (c * Ns + c0), k)
                outs_s.append(bs)
                outs_i.append(bi)
            best[j] = (torch.cat(outs_s), torch.cat(outs_i))
        if t < S - 1:
            cols = rotate(mesh, cols)
    sims = gather_to(mesh, [b for b, _ in best], device="cpu")[:N]
    ids = gather_to(mesh, [i for _, i in best], device="cpu")[:N]
    dist = (1.0 - sims).clamp_min_(0.0)
    return ids.to(torch.int32).numpy(), dist.numpy()


@dataclass
class ShardedGraph:
    """A padded fixed-degree graph split into S row blocks of `rows` rows
    (the last padded with -1 ids and zero weights), block s on shard s's
    device (the lists hold this process's blocks); column ids stay global."""

    mesh: Mesh
    n: int
    rows: int
    nbr: list  # (rows, Kp) int32
    w: list  # (rows, Kp) f32
    degree: list  # (rows,) f32


def shard_graph(mesh: Mesh, nbr, w, degree) -> ShardedGraph:
    """Row-shard (N, Kp) ids and weights and (N,) degrees (numpy, or tensors
    on any device; a block already on its device is a view)."""
    n = int(nbr.shape[0])
    rows = -(-n // mesh.size)

    def part(x, dtype, fill):
        return [p.contiguous() for p in
                split_rows(mesh, torch.as_tensor(x).to(dtype), rows, fill)]

    return ShardedGraph(mesh, n, rows, part(nbr, torch.int32, -1), part(w, torch.float32, 0.0),
                        part(degree, torch.float32, 0.0))


def segment_lengths(max_iter: int, dispatch_iters: Optional[int] = None):
    """The steps of each segment of a mesh propagation: FIRST_SEGMENT,
    doubling up to `dispatch_iters` (max_iter when None), max_iter in all."""
    cap = max_iter if not dispatch_iters else min(dispatch_iters, max_iter)
    n, i = min(FIRST_SEGMENT, cap), 0
    while i < max_iter:
        seg = min(n, max_iter - i)
        yield seg
        i += seg
        n = min(2 * n, cap)


def propagate_on_mesh(
    graph: ShardedGraph, prior, labels, is_labeled, start, *, reg_lambda: float,
    max_iter: int = 300, epsilon: float = 1e-5, dispatch_iters: Optional[int] = None,
) -> PropagationResult:
    """Jacobi propagation over a row-sharded graph (the vectors are (N,)
    numpy arrays or tensors on any device). Returns the scores on the
    mesh's primary device with the step count, the converged flag and the
    host reads (one a segment of `segment_lengths`)."""
    mesh, R = graph.mesh, graph.rows
    lam = float(reg_lambda)

    def vec(x, dtype, fill=0):
        return split_rows(mesh, torch.as_tensor(x).to(dtype), R, fill)

    labels_s, il_s = vec(labels, torch.float32), vec(is_labeled, torch.bool, False)
    denom = [torch.where(d + lam > 0, d + lam, 1.0) for d in graph.degree]
    lam_prior = [lam * p for p in vec(prior, torch.float32)]
    f = [torch.where(il, lab, st) for il, lab, st in
         zip(il_s, labels_s, vec(start, torch.float32))]
    f_prev = [x.clone() for x in f]
    steps = [torch.zeros((), dtype=torch.int32, device=d) for d in mesh.devices]
    done = [torch.zeros((), dtype=torch.bool, device=d) for d in mesh.devices]
    # the reduced delta makes every shard's (steps, done), and so every
    # process's once-a-segment read, agree
    i, converged, reads = 0, False, 0
    for seg in segment_lengths(max_iter, dispatch_iters):
        for _ in range(seg):
            fg = all_gather(mesh, f)
            new = [torch.where(il, lab, (knn_spmv(g, nb, ww, row_block=True) + lp) / den)
                   for g, nb, ww, lp, den, il, lab in
                   zip(fg, graph.nbr, graph.w, lam_prior, denom, il_s, labels_s)]
            delta = pmax(mesh, [((n - x) ** 2).max() for n, x in zip(new, f)])
            for s in range(len(f)):
                run = ~done[s]
                f_prev[s] = torch.where(run, f[s], f_prev[s])
                f[s] = torch.where(run, new[s], f[s])
                steps[s] = steps[s] + run.to(torch.int32)
                done[s] = done[s] | (run & (delta[s] < epsilon))
        with host_sync("propagate_on_mesh"):
            i, converged = torch.stack([steps[0], done[0].to(torch.int32)]).tolist()
        converged = bool(converged)
        reads += 1
        if converged or i >= max_iter:
            break
    out = [torch.where(d, fp, x) for d, fp, x in zip(done, f_prev, f)]
    scores = gather_to(mesh, out)[: graph.n]
    return PropagationResult(scores=scores, n_iter=i, converged=converged, host_reads=reads)


def sharded_propagate(nbr, w, degree, prior, labels, is_labeled, start, mesh: Mesh, *,
                      reg_lambda: float, max_iter: int = 300, epsilon: float = 1e-5,
                      dispatch_iters: Optional[int] = None) -> PropagationResult:
    """Row-sharded Jacobi propagation of the graph (nbr (N, Kp) int32 with
    -1 padding, w (N, Kp), degree (N,)); the iterates of
    `ops.propagation.propagate` on one device, up to the order of each
    row's sum."""
    return propagate_on_mesh(
        shard_graph(mesh, nbr, w, degree), prior, labels, is_labeled, start,
        reg_lambda=reg_lambda, max_iter=max_iter, epsilon=epsilon,
        dispatch_iters=dispatch_iters)
