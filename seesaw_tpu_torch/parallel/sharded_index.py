"""Row-sharded frame index: exact distributed top-k over a device mesh.

Counterpart of `seesaw_tpu/parallel/sharded_index.py`. The frames are
partitioned contiguously into S shards of Fs = ceil(F / S) frames in the
frame-major padded layout (`ops.frame_scoring`); the padding frames of the
last shard have no valid tile and stay excluded for good. Each shard's
blocks live on its device, and each shard runs the single-device program on
its own frames:

1. its frame maxima: the fused scan (`ops.fused_scoring.fused_frame_max`,
   the CUDA kernel on a card) for a solo query; the (Ns, D) @ (D, Q)
   product of `ops.frame_scoring.scoring_matmat` for a batch or a second
   (discount) vector, as the single-device batch programs compute it;
2. the global shortlist cutoff: each shard's top `shortlist_local`
   (score, global frame id) pairs are gathered onto every shard, the
   `k_global`-th pair under (score desc, id asc) is the cutoff, and the
   shard's frames below it are excluded. Ties at the cutoff resolve by id
   exactly as the single-device shortlist's top-k does, so the shards
   shortlist the very frames one device would;
3. the ranking tail on its shortlist (`rank_from_frame_max` after the
   scan, the full-score tail otherwise).

The (S x k) candidates merge on the mesh's primary device by a top-k over
the shards' lists in shard order. Over a process mesh (`parallel.mesh`)
each process builds and scans only its own shards' blocks
(`mesh.local_shards`, global ids in `offset`); the cutoff's gathers and the
merge's cross processes, so every process returns the same merged result.
Results are `QueryResult`s on the primary device, with global frame
ordinals; the host-facing functions
(`sharded_query_topk*`, `sharded_rank_by_scores`) decode them as the JAX
package's return them. Exclusion masks are lists of per-shard (Fs,) or
(Q, Fs) bool tensors; a query merges the click's new global frame ordinals
into its shard's mask and returns the new masks.

Departures from the JAX package: its mesh query scored with an XLA matvec,
because its kernel's 1024-frame blocks clashed with the shards; here every
solo query runs the kernel on each shard. A device-built index
(`from_device_arrays`) is sharded on the card by slicing its padded matrix,
with no host copy. Int8 storage always takes per-row scales, as there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..indices.meta import VectorMeta
from ..ops import frame_scoring as fsc
from ..ops.frame_scoring import NEG_INF, QueryResult, apply_new_exclusions, topk_first
from ..ops.fused_scoring import fused_frame_max
from .mesh import Mesh, all_gather, gather_to, psum, replicate, split_rows


@dataclass
class ShardedFrameIndex:
    """Per-shard padded blocks, each on its shard's device, and host
    metadata. Shard s owns global frames [s * Fs, (s + 1) * Fs); the lists
    hold this process's shards, in `mesh.local_shards` order."""

    mesh: Mesh
    V: list  # (Fs*T, D) f32 / bf16 / int8 per local shard
    valid: list  # (Fs, T) bool
    boxes: list  # (Fs*T, 4) f32
    zoom: list  # (Fs*T,) int
    frame_dbidx: np.ndarray  # (F,) global frame -> dbidx
    n_frames_local: int  # Fs
    tile_bound: int  # T
    max_zoom: int
    row_scale: Optional[list] = None  # (Fs*T,) f32 int8 dequant scales per shard
    pad_rows: Optional[torch.Tensor] = None  # (F*T,) exact row of each padded row, or None
    valid_flat: Optional[torch.Tensor] = None  # (F*T,) bool, on the primary device

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    @property
    def n_frames(self) -> int:
        return self.frame_dbidx.shape[0]

    @property
    def dim(self) -> int:
        return int(self.V[0].shape[1])

    def offset(self, s: int) -> int:
        """Global ordinal of shard s's first frame."""
        return s * self.n_frames_local

    # -- construction --------------------------------------------------------
    @staticmethod
    def build(vectors: np.ndarray, meta: VectorMeta, mesh: Mesh,
              dtype: str = "float32") -> "ShardedFrameIndex":
        """From host vectors in exact row order. dtype: 'float32',
        'bfloat16' or 'int8' (each padded row quantized by its own absmax,
        the single-device index's int8_scale='row')."""
        from ..indices.multiscale import padded_host_arrays

        host = padded_host_arrays(vectors, meta, dtype, "row")
        del host["frame_scale"]
        return ShardedFrameIndex._from_padded(mesh, meta, **host)

    @staticmethod
    def from_device_arrays(mesh: Mesh, meta: VectorMeta, *, V, valid, boxes, zoom,
                           row_scale=None, frame_scale=None) -> "ShardedFrameIndex":
        """From a device-built padded layout (`MultiscaleIndex.
        from_device_arrays`'s arrays, uniform tiling): each shard is a slice
        of the matrix, a view where the shard's device is the matrix's and
        the slice lies whole inside it. Per-frame int8 scales become per-row
        scales."""
        if frame_scale is not None and row_scale is None:
            row_scale = frame_scale.repeat_interleave(int(valid.shape[1]))
        return ShardedFrameIndex._from_padded(
            mesh, meta, V=V, valid=valid, boxes=boxes, zoom=zoom, row_scale=row_scale,
            pad_rows=None,
        )

    @staticmethod
    def _from_padded(mesh, meta, *, V, valid, boxes, zoom, row_scale, pad_rows):
        F, T = valid.shape
        if F != meta.n_frames or V.shape[0] != F * T:
            raise ValueError("padded arrays do not match the metadata's frames")
        S = mesh.size
        Fs = -(-F // S)
        R = Fs * T
        return ShardedFrameIndex(
            mesh=mesh,
            V=split_rows(mesh, V, R, 0),
            valid=split_rows(mesh, valid, Fs, False),
            boxes=split_rows(mesh, boxes, R, 0),
            zoom=split_rows(mesh, zoom, R, 0),
            frame_dbidx=meta.frame_dbidx,
            n_frames_local=Fs,
            tile_bound=T,
            max_zoom=max(meta.max_zoom_level, 1),
            row_scale=None if row_scale is None else split_rows(mesh, row_scale, R, 1.0),
            pad_rows=None if pad_rows is None else pad_rows.to(mesh.primary),
            valid_flat=valid.reshape(-1).to(mesh.primary),
        )

    # -- layouts -------------------------------------------------------------
    def shard_mask(self, mask) -> list:
        """(F,) bool (numpy, or a tensor) -> per-shard (Fs,) masks on the
        shards' devices; the padding frames are excluded."""
        m = (mask if isinstance(mask, torch.Tensor)
             else torch.from_numpy(np.ascontiguousarray(mask, dtype=bool)))
        return split_rows(self.mesh, m[:self.n_frames], self.n_frames_local, True)

    def shard_tile_scores(self, tile_scores) -> list:
        """(n_vectors,) per-tile scores in exact row order (numpy, or a
        tensor on any device) -> per-shard (Fs*T,) scores in the padded
        layout, invalid and padding rows at -inf. Made on the primary
        device, then split."""
        s = torch.as_tensor(tile_scores, dtype=torch.float32).to(self.mesh.primary)
        if self.pad_rows is not None:
            s = s[self.pad_rows]
        s = torch.where(self.valid_flat, s, NEG_INF)
        return split_rows(self.mesh, s, self.n_frames_local * self.tile_bound, NEG_INF)

    def rows_f32(self, prows: torch.Tensor) -> torch.Tensor:
        """f32 rows of the padded layout (an int64 tensor on the primary
        device), dequantized for int8, on the primary device. Every shard
        gathers the ids (clamped into its block) and keeps its own, so no
        host read decides which shard holds a row. Over a process mesh the
        processes' masked sums add by one all_reduce: a row held by another
        process arrives from it, and the others contribute exact zeros."""
        R = self.n_frames_local * self.tile_bound
        shard = prows // R
        out = None
        for j, (s, dev) in enumerate(zip(self.mesh.local_shards, self.mesh.devices)):
            local = (prows - s * R).clamp(0, R - 1).to(dev)
            X = self.V[j][local].to(torch.float32)
            if self.row_scale is not None:
                X = X * self.row_scale[j][local][:, None]
            X = torch.where((shard == s)[:, None], X.to(self.mesh.primary), 0.0)
            out = X if out is None else out + X
        return out if self.mesh.group is None else psum(self.mesh, [out])[0]

    def score_vectors(self, qvec: torch.Tensor) -> torch.Tensor:
        """(F*T,) raw padded-layout scores V.q on the primary device."""
        q = replicate(self.mesh, qvec.to(torch.float32))
        parts = [fsc.scoring_matvec(V, qs, rs) for V, qs, rs in
                 zip(self.V, q, self._row_scales())]
        return gather_to(self.mesh, parts)[: self.n_frames * self.tile_bound]

    def score_frames(self, qvec: torch.Tensor) -> torch.Tensor:
        """(F,) max tile score per frame on the primary device."""
        q = replicate(self.mesh, qvec.to(torch.float32))
        parts = [fsc.score_frames_max(V, valid, qs, rs) for V, valid, qs, rs in
                 zip(self.V, self.valid, q, self._row_scales())]
        return gather_to(self.mesh, parts)[: self.n_frames]

    def _row_scales(self) -> list:
        return self.row_scale if self.row_scale is not None else [None] * len(self.V)

    # -- the per-shard programs ----------------------------------------------
    def _apply_new(self, excluded: list, new_ids: torch.Tensor) -> list:
        """Merge new GLOBAL frame ordinals ((M,) or (Q, M), -1 padded) into
        each shard's mask; ordinals of other shards land in the scratch slot."""
        Fs = self.n_frames_local
        out = []
        for j, (s, ids) in enumerate(zip(self.mesh.local_shards,
                                         replicate(self.mesh, new_ids))):
            local = ids - self.offset(s)
            local = torch.where((ids >= 0) & (local >= 0) & (local < Fs), local, -1)
            out.append(apply_new_exclusions(excluded[j], local))
        return out

    def _cutoff_keep(self, fmax: list, shortlist_size: int) -> list:
        """Per-shard keep masks of the global shortlist: the frames at or
        above the k_global-th (score, global id) pair under (score desc,
        id asc). Every shard contributes at most min(k_global, Fs) <=
        shortlist_local frames to the global top k_global, so the gathered
        local top lists hold the cutoff pair, gathered in shard order (across
        processes too). Works over a leading Q axis."""
        S, Fs = self.n_shards, self.n_frames_local
        sl = min(shortlist_size, Fs)
        k_global = min(shortlist_size, S * sl)
        tops = [topk_first(f, sl) for f in fmax]
        shards = self.mesh.local_shards
        all_s = all_gather(self.mesh, [v for v, _ in tops], dim=-1)
        all_g = all_gather(self.mesh, [i + self.offset(s) for s, (_, i) in zip(shards, tops)],
                           dim=-1)
        cut = {}  # one cutoff per distinct device
        keep = []
        for j, (s, f) in enumerate(zip(shards, fmax)):
            dev = self.mesh.devices[j]
            if dev not in cut:
                cut[dev] = _kth_pair(all_s[j], all_g[j], k_global)
            cut_s, cut_id = cut[dev]
            gid = torch.arange(Fs, device=f.device) + self.offset(s)
            keep.append((f > cut_s[..., None])
                        | ((f == cut_s[..., None]) & (gid <= cut_id[..., None])))
        return keep

    def _merge(self, results: list, topk: int) -> QueryResult:
        """The shards' (k,) or (Q, k) results, gathered in global shard
        order -> the merged top-k on the primary device (of every process),
        frame ids global."""
        m = self.mesh
        gfids = gather_to(m, [torch.where(r.frame_ids >= 0, r.frame_ids + self.offset(s), -1)
                              for s, r in zip(m.local_shards, results)], dim=-1)
        scores = gather_to(m, [r.frame_scores for r in results], dim=-1)
        boxes = gather_to(m, [r.act_boxes for r in results], dim=-2)
        act = gather_to(m, [r.act_scores for r in results], dim=-1)
        top, pos = topk_first(scores, min(topk, scores.shape[-1]))
        ok = top > NEG_INF
        return QueryResult(
            frame_ids=torch.where(ok, gfids.gather(-1, pos), -1),
            frame_scores=top,
            act_boxes=boxes.gather(-2, pos[..., None].expand(*pos.shape, 4)),
            act_scores=act.gather(-1, pos),
            n_valid=ok.sum(dim=-1),
        )

    def _tail(self, shortlist_size: int, topk: int, aug_larger: str, aug_weight: str,
              agg_method: str, max_zoom: Optional[int]) -> dict:
        Fs = self.n_frames_local
        return dict(shortlist_size=min(shortlist_size, Fs), topk=min(topk, Fs),
                    aug_larger=aug_larger, aug_weight=aug_weight, agg_method=agg_method,
                    max_zoom=self.max_zoom if max_zoom is None else max_zoom)


def _kth_pair(scores: torch.Tensor, gids: torch.Tensor, k: int):
    """The k-th (score, id) pair along the last axis under (score desc,
    id asc)."""
    o = torch.argsort(gids, dim=-1, stable=True)
    s, g = scores.gather(-1, o), gids.gather(-1, o)
    o = torch.argsort(s, dim=-1, descending=True, stable=True)
    return s.gather(-1, o)[..., k - 1], g.gather(-1, o)[..., k - 1]


def sharded_query_program(
    idx: ShardedFrameIndex, qvec: torch.Tensor, excluded: list, new_ids: torch.Tensor,
    qvec2: Optional[torch.Tensor] = None, *, shortlist_size: int, topk: int,
    aug_larger: str = "all", aug_weight: str = "level_max", agg_method: str = "avg_score",
    max_zoom: Optional[int] = None,
) -> tuple[QueryResult, list]:
    """One query over the mesh: per shard the click's exclusions, the frame
    maxima (the fused scan; with `qvec2`, the product of both queries and
    their difference), the global cutoff and the ranking tail; then the
    merge. `shortlist_size` is the GLOBAL shortlist. Returns (merged
    QueryResult on the primary device, the shards' new masks)."""
    tail = idx._tail(shortlist_size, topk, aug_larger, aug_weight, agg_method, max_zoom)
    Fs, T = idx.n_frames_local, idx.tile_bound
    q = replicate(idx.mesh, qvec.to(torch.float32))
    q2 = None if qvec2 is None else replicate(idx.mesh, qvec2.to(torch.float32))
    exc = idx._apply_new(excluded, new_ids)
    rs = idx._row_scales()
    fmax, scores = [], []
    for s in range(len(idx.V)):  # this process's shards, by local position
        if q2 is None:
            fmax.append(fused_frame_max(idx.V[s], idx.valid[s], exc[s], q[s], rs[s]))
            continue
        both = fsc.scoring_matmat(idx.V[s], torch.stack([q[s], q2[s]]), rs[s])
        sc = both[:, 0] - both[:, 1]
        fm = torch.where(idx.valid[s], sc.view(Fs, T), NEG_INF).amax(dim=1)
        fmax.append(torch.where(exc[s], NEG_INF, fm))
        scores.append(sc)
    keep = idx._cutoff_keep(fmax, shortlist_size)
    results = []
    for s in range(len(idx.V)):
        if q2 is None:
            results.append(fsc.rank_from_frame_max(
                idx.V[s], idx.valid[s], idx.boxes[s], idx.zoom[s], q[s],
                torch.where(keep[s], fmax[s], NEG_INF), rs[s], None, tile_bound=T, **tail))
        else:
            results.append(fsc._rank_frames(scores[s], idx.valid[s], idx.boxes[s],
                                            idx.zoom[s], exc[s] | ~keep[s], **tail))
    return idx._merge(results, topk), exc


def sharded_query_batch_program(
    idx: ShardedFrameIndex, qvecs: torch.Tensor, excluded: list, new_ids: torch.Tensor, *,
    shortlist_size: int, topk: int, aug_larger: str = "all", aug_weight: str = "level_max",
    agg_method: str = "avg_score", max_zoom: Optional[int] = None, plain: bool = False,
) -> tuple[QueryResult, list]:
    """Q queries over the mesh: per shard one (Ns, D) @ (D, Q) product
    (`scoring_matmat`, or its plain version with `plain`), each query's
    cutoff and ranking tail, and a per-query merge. excluded: per-shard
    (Q, Fs) masks; new_ids (Q, M). Returns (QueryResult with a leading Q
    axis on the primary device, the shards' new (Q, Fs) masks)."""
    tail = idx._tail(shortlist_size, topk, aug_larger, aug_weight, agg_method, max_zoom)
    Fs, T = idx.n_frames_local, idx.tile_bound
    Q = qvecs.shape[0]
    qs = replicate(idx.mesh, qvecs.to(torch.float32))
    exc = idx._apply_new(excluded, new_ids)
    scan = fsc.scoring_matmat_plain if plain else fsc.scoring_matmat
    scores = [scan(V, q, rs) for V, q, rs in zip(idx.V, qs, idx._row_scales())]
    fmax = [torch.where(e, NEG_INF, torch.where(valid[:, :, None], sc.view(Fs, T, Q),
                                                NEG_INF).amax(dim=1).T)
            for sc, valid, e in zip(scores, idx.valid, exc)]
    keep = idx._cutoff_keep(fmax, shortlist_size)
    results = [fsc._rank_frames_batch(scores[s], idx.valid[s], idx.boxes[s], idx.zoom[s],
                                      exc[s] | ~keep[s], **tail)
               for s in range(len(idx.V))]
    return idx._merge(results, topk), exc


def sharded_rank_program(
    idx: ShardedFrameIndex, tile_scores: list, excluded: list, new_ids: torch.Tensor, *,
    shortlist_size: int, topk: int, aug_larger: str = "all", aug_weight: str = "level_max",
    agg_method: str = "avg_score", max_zoom: Optional[int] = None,
) -> tuple[QueryResult, list]:
    """Rank frames by external per-tile scores (per-shard padded layout,
    `shard_tile_scores`) over the mesh, with the query's cutoff protocol:
    the KnnProp2 round's ranking tail. Returns (merged QueryResult, new
    masks)."""
    tail = idx._tail(shortlist_size, topk, aug_larger, aug_weight, agg_method, max_zoom)
    Fs, T = idx.n_frames_local, idx.tile_bound
    exc = idx._apply_new(excluded, new_ids)
    fmax = [torch.where(e, NEG_INF, torch.where(valid, ts.view(Fs, T), NEG_INF).amax(dim=1))
            for ts, valid, e in zip(tile_scores, idx.valid, exc)]
    keep = idx._cutoff_keep(fmax, shortlist_size)
    results = [fsc._rank_frames(tile_scores[s], idx.valid[s], idx.boxes[s], idx.zoom[s],
                                exc[s] | ~keep[s], **tail)
               for s in range(len(idx.V))]
    return idx._merge(results, topk), exc


# -- host-facing entry points (the JAX package's signatures) -----------------
def _host_rows(idx: ShardedFrameIndex, res: QueryResult) -> list:
    """Decode a (Q, k) result into Q (dbidxs, frame_scores, act_boxes,
    act_scores) numpy tuples, truncated to the valid rows."""
    fids, scores = res.frame_ids.cpu().numpy(), res.frame_scores.cpu().numpy()
    boxes, act = res.act_boxes.cpu().numpy(), res.act_scores.cpu().numpy()
    n_valid = res.n_valid.cpu().numpy()
    out = []
    for q in range(fids.shape[0]):
        n = int(n_valid[q])
        out.append((idx.frame_dbidx[fids[q, :n]], scores[q, :n], boxes[q, :n], act[q, :n]))
    return out


def _qtensor(idx, vec) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(vec, dtype=np.float32)).to(idx.mesh.primary)


def _no_new(idx, *lead) -> torch.Tensor:
    return torch.full((*lead, 1), -1, dtype=torch.int64, device=idx.mesh.primary)


def sharded_query_topk_incr(idx: ShardedFrameIndex, qvec, excluded_dev: list, new_ids, *,
                            topk: int, shortlist_size: Optional[int] = None,
                            aug_larger: str = "all", aug_weight: str = "level_max",
                            agg_method: str = "avg_score", qvec2=None):
    """A query with the device-resident masks (`shard_mask`) and the click's
    new global frame ordinals ((M,), -1 padded). Returns (dbidxs,
    frame_scores, act_boxes, act_scores, new masks)."""
    if shortlist_size is None:
        shortlist_size = topk
    res, new_mask = sharded_query_program(
        idx, _qtensor(idx, np.asarray(qvec).reshape(-1)), excluded_dev,
        torch.as_tensor(new_ids, dtype=torch.int64).to(idx.mesh.primary),
        None if qvec2 is None else _qtensor(idx, np.asarray(qvec2).reshape(-1)),
        shortlist_size=shortlist_size, topk=topk, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method)
    return (*_host_rows(idx, QueryResult(*(f[None] for f in res)))[0], new_mask)


def sharded_query_topk(idx: ShardedFrameIndex, qvec, excluded_global, *, topk: int,
                       shortlist_size: Optional[int] = None, aug_larger: str = "all",
                       aug_weight: str = "level_max", agg_method: str = "avg_score",
                       qvec2=None):
    """A query from a host (F,) exclusion mask. Returns (dbidxs,
    frame_scores, act_boxes, act_scores) truncated to the valid rows."""
    return sharded_query_topk_incr(
        idx, qvec, idx.shard_mask(np.asarray(excluded_global)), _no_new(idx),
        topk=topk, shortlist_size=shortlist_size, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method, qvec2=qvec2)[:4]


def sharded_query_topk_batch_incr(idx: ShardedFrameIndex, qvecs, excluded_dev: list,
                                  new_ids, *, topk: int, shortlist_size: Optional[int] = None,
                                  aug_larger: str = "all", aug_weight: str = "level_max",
                                  agg_method: str = "avg_score"):
    """Q coalesced queries with per-shard (Q, Fs) masks and (Q, M) new
    ordinals. Returns (per-query result tuples, the shards' new (Q, Fs)
    masks: row q of each is session q's)."""
    if shortlist_size is None:
        shortlist_size = topk
    res, new_mask = sharded_query_batch_program(
        idx, _qtensor(idx, np.asarray(qvecs)), excluded_dev,
        torch.as_tensor(new_ids, dtype=torch.int64).to(idx.mesh.primary),
        shortlist_size=shortlist_size, topk=topk, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method)
    return _host_rows(idx, res), new_mask


def sharded_query_topk_batch(idx: ShardedFrameIndex, qvecs, excluded_global, *, topk: int,
                             shortlist_size: Optional[int] = None, aug_larger: str = "all",
                             aug_weight: str = "level_max", agg_method: str = "avg_score"):
    """Q queries from host (Q, F) masks; each result equals its solo
    `sharded_query_topk` up to the order of the product's sums."""
    excl = np.asarray(excluded_global, dtype=bool)
    masks = [torch.stack(m) for m in zip(*(idx.shard_mask(row) for row in excl))]
    return sharded_query_topk_batch_incr(
        idx, qvecs, masks, _no_new(idx, excl.shape[0]), topk=topk,
        shortlist_size=shortlist_size, aug_larger=aug_larger, aug_weight=aug_weight,
        agg_method=agg_method)[0]


def sharded_rank_by_scores(idx: ShardedFrameIndex, tile_scores, excluded_global, *,
                           topk: int, shortlist_size: Optional[int] = None,
                           aug_larger: str = "all", aug_weight: str = "level_max",
                           agg_method: str = "avg_score"):
    """Rank by per-tile scores in exact row order (or already per-shard,
    a list) from a host (F,) mask; the shortlist defaults as the index's
    `rank_by_scores`. Returns (dbidxs, frame_scores, act_boxes,
    act_scores)."""
    if shortlist_size is None or shortlist_size < topk:
        shortlist_size = max(topk * 5, shortlist_size or 0)
    shortlist_size = min(shortlist_size, idx.n_frames)
    parts = tile_scores if isinstance(tile_scores, list) else idx.shard_tile_scores(tile_scores)
    res, _ = sharded_rank_program(
        idx, parts, idx.shard_mask(np.asarray(excluded_global)), _no_new(idx),
        shortlist_size=shortlist_size, topk=min(topk, idx.n_frames), aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method)
    return _host_rows(idx, QueryResult(*(f[None] for f in res)))[0]
