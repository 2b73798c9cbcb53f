"""MultiscaleIndex on one device, in PyTorch.

Counterpart of the single-device `seesaw_tpu/indices/multiscale.py`. The
embedding matrix, tile boxes and zoom levels live on `device` in the
frame-major padded layout (frame f owns rows [f*T, (f+1)*T), T the
power-of-two tile bound); every query without a second vector runs the
fused scan (`ops.fused_scoring`): the CUDA kernel on a CUDA index, its plain
version on a CPU index. The per-session exclusion mask stays on the device
across clicks; a click ships only the newly excluded frame ordinals.

Graph loops rank externally produced per-vector scores with
`rank_by_scores`; a staged KnnProp2 round runs fused inside it
(`_rank_deferred_propagation`).

With a `mesh` of several devices (`parallel.mesh`) the padded matrix is
row-sharded across them (`parallel.sharded_index.ShardedFrameIndex`) and
never kept whole on one device: queries, batch queries and rankings run the
per-shard programs with the global shortlist cutoff and merge on the mesh's
primary device, where the exclusion masks' lists, the deferred fits and the
host-facing state live. A staged KnnProp2 round does not fuse over a mesh:
its propagation runs first, then the sharded ranking. A one-device mesh is
the single-device index. Over a mesh that spans processes
(`make_mesh(devices=..., group=...)`) each process builds, or slices, only its
own shards (`from_path(mesh=)` in every process reads the same files), and
queries and rankings return the same result in every process, provided
every process makes the same calls (`parallel/mesh.py`).

`save` writes the JAX package's on-disk format, with the JAX class in
`info.json`'s constructor string, so an index saved here loads in both
packages. `from_path` with `coalesce_ms` returns the index wrapped in a
`web.coalesce.CoalescingIndex`. Dropped because
the GPU does not need them: the 1024-frame padding of the Pallas block
granularity (and with it the JAX index's refusal of `use_pallas` on a
mesh), the routing of int8 around the kernel, and the power-of-two row
buckets that bounded jit recompiles.
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..box_utils import max_iou_per_left
from ..labeldb import LabelDB
from ..models.registry import load_embedding
from ..ops import frame_scoring
from ..ops.fused_scoring import query_program_fused_incr
from ..ops.propagation import (
    DeferredPropagation, PropagationResult, propagate, propagate_rank, rank_padded,
)
from ..parallel.sharded_index import (
    ShardedFrameIndex, sharded_query_program, sharded_rank_program,
)
from ..query_interface import InteractiveQuery
from ..runtime.bitmap import BitMap, FrozenBitMap
from .interface import AccessMethod
from .meta import VectorMeta, next_pow2


class _ExclEntry:
    """Per-session device exclusion state: `dev` is exactly `prev`'s
    exclusions; `obj` keeps the session's BitMap alive so that its id()
    cannot be reused while cached."""

    __slots__ = ("obj", "prev", "dev", "gen")

    def __init__(self, obj, prev, dev):
        self.obj = obj
        self.prev = prev
        self.dev = dev
        self.gen = 0


def match_labels_to_vectors(
    label_db: LabelDB, meta: VectorMeta, target_description: Optional[str] = None
):
    """For every vector of every seen image, the max IoU between its tile
    box and any matching labeled box; ys = (max_iou > 0). Returns
    (row_indices, dbidx, ys, max_iou). Host-side numpy, as in the JAX
    package."""
    seen_ids = np.asarray(label_db.get_seen().to_array(), dtype=np.int64)
    fpos = np.searchsorted(meta.frame_dbidx, seen_ids)
    safe = np.minimum(fpos, meta.n_frames - 1)
    fpos = fpos[(fpos < meta.n_frames) & (meta.frame_dbidx[safe] == seen_ids)]
    rows = (
        np.concatenate(
            [np.arange(meta.frame_starts[f], meta.frame_starts[f + 1]) for f in fpos]
        )
        if fpos.size
        else np.zeros(0, dtype=np.int64)
    )
    if target_description is not None:
        table = label_db.get_box_table(target_description=target_description)
    else:
        table = label_db.get_box_table(accepted_only=True)

    max_iou = np.zeros(rows.shape[0], dtype=np.float32)
    if len(table):
        for dbidx in np.unique(meta.dbidx[rows]):
            lab = table.boxes[table.dbidx == dbidx]
            if lab.shape[0] == 0:
                continue
            sel = np.where(meta.dbidx[rows] == dbidx)[0]
            max_iou[sel] = max_iou_per_left(meta.boxes[rows[sel]], lab)
    ys = (max_iou > 0).astype(np.float32)
    return rows, meta.dbidx[rows], ys, max_iou


def quantize_int8(V_pad: np.ndarray, tile_bound: int, int8_scale: str):
    """Symmetric int8 quantization of the padded matrix with per-row or
    per-frame scales, by the JAX package's numpy code. Returns (int8 matrix,
    per-row scales, per-frame scales or None)."""
    row_max = np.abs(V_pad).max(axis=1)
    fscales = None
    if int8_scale == "frame":
        frame_max = row_max.reshape(-1, tile_bound).max(axis=1)
        fscales = np.where(frame_max > 0, frame_max / 127.0, 1.0).astype(np.float32)
        scales = np.repeat(fscales, tile_bound)
    elif int8_scale == "row":
        scales = np.where(row_max > 0, row_max / 127.0, 1.0).astype(np.float32)
    else:
        raise ValueError(f"unknown int8_scale {int8_scale!r}")
    V8 = np.clip(np.round(V_pad / scales[:, None]), -127, 127).astype(np.int8)
    return V8, scales, fscales


def padded_host_arrays(vectors: np.ndarray, meta: VectorMeta, device_dtype: str,
                       int8_scale: str = "row") -> dict:
    """The index's frame-major padded layout as CPU tensors: V in its storage
    type (invalid rows zero; int8 with its per-row and, for
    int8_scale='frame', per-frame scales), valid, boxes, zoom and the exact
    row of each padded row. The keyword arguments of
    `ShardedFrameIndex._from_padded` and, moved to a device, of the
    single-device state."""
    T = next_pow2(max(meta.max_tiles_per_frame, 1))
    rows, valid = meta.padded_rows(T)
    flat_rows = rows.reshape(-1)
    V_pad = np.ascontiguousarray(np.asarray(vectors)[flat_rows], dtype=np.float32)
    V_pad[~valid.reshape(-1)] = 0.0
    row_scale = frame_scale = None
    if device_dtype == "int8":
        V_pad, scales, fscales = quantize_int8(V_pad, T, int8_scale)
        row_scale = torch.from_numpy(scales)
        if fscales is not None:
            frame_scale = torch.from_numpy(fscales)
        V = torch.from_numpy(V_pad)
    elif device_dtype in ("bfloat16", "float32"):
        V = torch.from_numpy(V_pad).to(getattr(torch, device_dtype))
    else:
        raise ValueError(f"unknown device_dtype {device_dtype!r}")
    return dict(V=V, valid=torch.from_numpy(valid),
                boxes=torch.from_numpy(meta.boxes[flat_rows]),
                zoom=torch.from_numpy(meta.zoom_level[flat_rows]),
                row_scale=row_scale, frame_scale=frame_scale,
                pad_rows=torch.from_numpy(flat_rows.astype(np.int64, copy=False)))


class MultiscaleIndex(AccessMethod):
    # how many newly excluded frames per click ride into the query; bigger
    # deltas rebuild the mask on the host
    _EXCL_DELTA = 8
    _EXCL_CACHE = 32  # max sessions with a device-resident mask

    def __init__(
        self,
        *,
        device=None,
        embedding=None,
        vectors: np.ndarray,
        meta: VectorMeta,
        path: Optional[str] = None,
        excluded: Optional[BitMap] = None,
        device_dtype: str = "float32",
        int8_scale: str = "row",
        use_pallas: bool = False,
        mesh=None,
    ):
        """device_dtype: 'float32', 'bfloat16' or 'int8' (symmetric scales
        per row, or per frame with int8_scale='frame'; a mesh always takes
        per-row scales, as the JAX package's). `use_pallas` is accepted for
        option compatibility with the JAX index and ignored: every query
        without a second vector takes the fused scan. `mesh`: row-shard the
        matrix over its devices; the index's `device` is then the mesh's
        primary, and `device` may be left out."""
        del use_pallas
        self.device = _index_device(device, mesh)
        self.embedding = embedding
        self.path = path
        self.meta = meta
        self.vectors = np.ascontiguousarray(vectors, dtype=np.float32)
        assert self.vectors.shape[0] == meta.n_vectors
        self.excluded = excluded if excluded is not None else BitMap()
        self.all_indices = FrozenBitMap(
            BitMap(meta.frame_dbidx).difference(self.excluded).to_array()
        )

        self.device_dtype = device_dtype
        base = (
            self.excluded.contains_many(meta.frame_dbidx.astype(np.uint32))
            if len(self.excluded)
            else np.zeros(meta.n_frames, dtype=bool)
        )
        sharded = mesh is not None and mesh.size > 1
        host = padded_host_arrays(self.vectors, meta, device_dtype,
                                  "row" if sharded else int8_scale)
        if sharded:
            del host["frame_scale"]
            self._set_sharded_state(ShardedFrameIndex._from_padded(mesh, meta, **host), base)
            return
        dev = self.device
        self._set_device_state(
            **{k: None if v is None else v.to(dev) for k, v in host.items()},
            base_excluded=base,
        )

    def _set_device_state(self, *, V, valid, boxes, zoom, row_scale,
                          frame_scale, base_excluded, pad_rows=None):
        self._sharded = None
        self._V = V
        self._valid = valid
        self._tile_bound = None if valid is None else int(valid.shape[1])
        self._boxes = boxes
        self._zoom = zoom
        self._row_scale = row_scale
        self._frame_scale = frame_scale
        self._max_zoom = max(self.meta.max_zoom_level, 1)
        self._base_excluded_mask = base_excluded
        # exact row of each padded row (ragged tiling), or None when the
        # padded layout is the exact one (uniform tiling, device-built)
        self._pad_rows = pad_rows
        self._excl_lock = threading.Lock()
        self._excl_entries = OrderedDict()  # id(BitMap) -> _ExclEntry
        self._excl_base = None  # device mask for exclude=None
        self.last_fit = None  # n_iter / host_syncs of the last LogReg2 fit
        self._vectors_dev = None  # device copy of the host mirror, made on first use

    def _set_sharded_state(self, sharded: ShardedFrameIndex, base_excluded):
        """A mesh index: the blocks live on the shards' devices, and nothing
        of the matrix on the primary device."""
        self._set_device_state(V=None, valid=None, boxes=None, zoom=None, row_scale=None,
                               frame_scale=None, base_excluded=base_excluded)
        self._sharded = sharded
        self._tile_bound = sharded.tile_bound
        self._max_zoom = sharded.max_zoom

    @property
    def mesh(self):
        """The mesh the matrix is sharded over, or None."""
        return None if self._sharded is None else self._sharded.mesh

    @staticmethod
    def from_device_arrays(
        *,
        embedding,
        V: torch.Tensor,  # (F*T, D) frame-major padded, on the device
        valid: torch.Tensor,  # (F, T) bool
        boxes: torch.Tensor,  # (F*T, 4) f32
        zoom: torch.Tensor,  # (F*T,) int
        meta: VectorMeta,
        row_scale: Optional[torch.Tensor] = None,
        frame_scale: Optional[torch.Tensor] = None,  # (F,) int8 per-frame
        use_pallas: bool = True,
        path: Optional[str] = None,
        mesh=None,
    ) -> "MultiscaleIndex":
        """Serving-scale construction from arrays already on the device, with
        no host copy of the embedding matrix; labeled-row vectors for the
        per-round fits are gathered from the device matrix. The device is
        V's; `path` names the index directory (its kNN graphs), if any. With
        a `mesh` of several devices the arrays are sliced into the shards on
        the card (`ShardedFrameIndex.from_device_arrays`, int8 per-row
        scales), and the index lives on the mesh."""
        del use_pallas
        self = MultiscaleIndex.__new__(MultiscaleIndex)
        self.device = V.device if mesh is None else _index_device(None, mesh)
        self.embedding = embedding
        self.path = path
        self.meta = meta
        self.vectors = None
        self.excluded = BitMap()
        self.all_indices = FrozenBitMap(meta.frame_dbidx)
        self.device_dtype = str(V.dtype).removeprefix("torch.")
        F, T = valid.shape
        if F != meta.n_frames or T < meta.max_tiles_per_frame or V.shape[0] != F * T:
            raise ValueError("device arrays do not match the metadata's frames")
        if mesh is not None and mesh.size > 1:
            self._set_sharded_state(ShardedFrameIndex.from_device_arrays(
                mesh, meta, V=V, valid=valid, boxes=boxes, zoom=zoom, row_scale=row_scale,
                frame_scale=frame_scale), np.zeros(meta.n_frames, dtype=bool))
            return self
        self._set_device_state(
            V=V, valid=valid, boxes=boxes, zoom=zoom, row_scale=row_scale,
            frame_scale=frame_scale,
            base_excluded=np.zeros(meta.n_frames, dtype=bool),
        )
        return self

    # -- rows ----------------------------------------------------------------
    @property
    def dim(self) -> int:
        return self._sharded.dim if self._sharded is not None else int(self._V.shape[1])

    def _uniform_tiling(self) -> bool:
        """Whether the padded layout is the exact one (every frame holds
        tile_bound tiles), as in a device-built index."""
        return self.meta.n_vectors == self.meta.n_frames * self._tile_bound

    def padded_row_ids(self, rows: np.ndarray) -> np.ndarray:
        """Exact-layout row indices -> padded device-layout row indices."""
        rows = np.asarray(rows, dtype=np.int64)
        f = self.meta.frame_id[rows]
        offs = rows - self.meta.frame_starts[f]
        return f.astype(np.int64) * self._tile_bound + offs

    def _device_rows_f32(self, prows: torch.Tensor) -> torch.Tensor:
        """Gather padded-layout rows from the device matrix as f32 (int8:
        dequantized by the row's, or the frame's, scale); on a mesh, from
        the shards onto the primary device."""
        if self._sharded is not None:
            return self._sharded.rows_f32(prows)
        X = self._V[prows].to(torch.float32)
        if self._row_scale is not None:
            X = X * self._row_scale[prows][:, None]
        elif self._frame_scale is not None:
            X = X * self._frame_scale[prows // self._tile_bound][:, None]
        return X

    def _rows_tensor(self, rows) -> torch.Tensor:
        return torch.from_numpy(self.padded_row_ids(rows)).to(self.device)

    def sum_vectors_for_rows(self, groups) -> np.ndarray:
        """(k, D) f32 sums over exact-layout row groups (empty -> zeros):
        from the host mirror when there is one, otherwise reduced on the
        device with one transfer of the k sums."""
        if self.vectors is not None:
            return super().sum_vectors_for_rows(groups)
        sums = [
            self._device_rows_f32(self._rows_tensor(g)).sum(dim=0) if len(g)
            else torch.zeros(self.dim, device=self.device)
            for g in groups
        ]
        return torch.stack(sums).cpu().numpy()

    def vectors_for_rows(self, rows: np.ndarray) -> np.ndarray:
        """f32 vectors for exact-layout rows: the host mirror, or a gather
        from the device matrix."""
        rows = np.asarray(rows, dtype=np.int64)
        if self.vectors is not None:
            return self.vectors[rows]
        return self._device_rows_f32(self._rows_tensor(rows)).cpu().numpy()

    def vectors_f32(self) -> torch.Tensor:
        """(n_vectors, D) f32 on the device in exact row order: a copy of
        the host mirror (made once), or the device matrix (dequantized for
        int8) when there is no mirror, which needs uniform tiling."""
        if self.vectors is not None:
            if self._vectors_dev is None:
                self._vectors_dev = torch.from_numpy(self.vectors).to(self.device)
            return self._vectors_dev
        if not self._uniform_tiling():
            raise ValueError("device vectors_f32() needs uniform tiling")
        return self._device_rows_f32(torch.arange(self.meta.n_vectors, device=self.device))

    def rows_f32(self, rows: torch.Tensor) -> torch.Tensor:
        """f32 vectors of exact-layout rows (an int64 tensor on the device),
        gathered from the device matrix (dequantized for int8); needs uniform
        tiling, where the exact and padded layouts agree."""
        if not self._uniform_tiling():
            raise ValueError("device rows_f32() needs uniform tiling")
        return self._device_rows_f32(rows)

    def get_data(self, dbidx: int) -> dict:
        """One image's tiles: boxes, zoom levels, f32 vectors (host mirror,
        or gathered from the device) and exact-layout rows."""
        f = int(np.searchsorted(self.meta.frame_dbidx, dbidx))
        if f >= self.meta.n_frames or self.meta.frame_dbidx[f] != dbidx:
            raise KeyError(f"dbidx {dbidx} not in index")
        lo, hi = int(self.meta.frame_starts[f]), int(self.meta.frame_starts[f + 1])
        rows = np.arange(lo, hi)
        return {
            "boxes": self.meta.boxes[lo:hi],
            "zoom_level": self.meta.zoom_level[lo:hi],
            "vectors": self.vectors_for_rows(rows),
            "rows": rows,
        }

    # -- basic ops -----------------------------------------------------------
    def string2vec(self, string: str) -> np.ndarray:
        vec = self.embedding.from_string(string=string)
        vec = np.asarray(vec, dtype=np.float32).reshape(-1)
        return vec / np.linalg.norm(vec)

    def _qtensor(self, vec) -> torch.Tensor:
        return torch.from_numpy(
            np.ascontiguousarray(np.asarray(vec, np.float32).reshape(-1))
        ).to(self.device)

    def score_device(self, vec: np.ndarray):
        """Per-vector scores, left on the device for a device-built index
        (which needs uniform tiling: padded layout == exact layout); host
        scores from the mirror otherwise."""
        if self.vectors is None:
            if not self._uniform_tiling():
                raise ValueError("device score() needs uniform tiling")
            if self._sharded is not None:
                return self._sharded.score_vectors(self._qtensor(vec))
            rs = self._row_scale
            if rs is None and self._frame_scale is not None:
                rs = self._frame_scale.repeat_interleave(self._tile_bound)
            return frame_scoring.score_vectors(self._V, self._qtensor(vec), rs)
        return self.vectors @ np.asarray(vec, np.float32).reshape(-1)

    def score(self, vec: np.ndarray) -> np.ndarray:
        s = self.score_device(vec)
        return s.cpu().numpy() if isinstance(s, torch.Tensor) else np.asarray(s)

    def score_frames(self, vec: np.ndarray) -> np.ndarray:
        """Max tile score per frame (on a mesh, per shard, then gathered)."""
        if self._sharded is not None:
            return self._sharded.score_frames(self._qtensor(vec)).cpu().numpy()
        return frame_scoring.score_frames_max(
            self._V, self._valid, self._qtensor(vec), self._row_scale
        ).cpu().numpy()

    def __len__(self) -> int:
        return len(self.all_indices)

    @property
    def n_frames(self) -> int:
        return self.meta.n_frames

    # -- device-persistent exclusion state ----------------------------------
    # Each session's (F,) mask lives on the device across clicks; per query
    # only the delta against the session's previous exclusion set rides in,
    # and the query returns the updated mask, published by a
    # generation-checked commit.
    def _frame_exclusion_mask(self, exclude: Optional[BitMap]) -> np.ndarray:
        mask = self._base_excluded_mask.copy()
        if exclude is not None and len(exclude):
            mask |= exclude.contains_many(self.meta.frame_dbidx.astype(np.uint32))
        return mask

    def _mask_to_device(self, mask: np.ndarray):
        """A host (F,) mask in the query programs' layout: one (F,) tensor,
        or on a mesh the shards' (Fs,) tensors (`ShardedFrameIndex.
        shard_mask`)."""
        if self._sharded is not None:
            return self._sharded.shard_mask(mask)
        return torch.from_numpy(mask).to(self.device)

    def _new_ids_tensor(self, ords: np.ndarray) -> torch.Tensor:
        out = np.full(self._EXCL_DELTA, -1, dtype=np.int64)
        out[: ords.shape[0]] = ords
        return torch.from_numpy(out).to(self.device)

    def _dbidx_to_frame_ordinals(self, ids: np.ndarray) -> np.ndarray:
        fd = self.meta.frame_dbidx
        pos = np.searchsorted(fd, ids)
        safe = np.minimum(pos, fd.shape[0] - 1)
        return pos[(pos < fd.shape[0]) & (fd[safe] == ids)].astype(np.int64)

    def _device_exclusion(self, exclude: Optional[BitMap]):
        """(device mask, padded new frame ordinals, commit token)."""
        no_new = np.zeros(0, dtype=np.int64)
        with self._excl_lock:
            if exclude is None or len(exclude) == 0:
                if self._excl_base is None:
                    self._excl_base = self._mask_to_device(self._base_excluded_mask.copy())
                return self._excl_base, self._new_ids_tensor(no_new), None

            key = id(exclude)
            e = self._excl_entries.get(key)
            if e is not None and e.obj is exclude and e.prev is not None:
                added = exclude.difference(e.prev)
                removed = e.prev.difference(exclude)
                if len(removed) == 0 and len(added) <= self._EXCL_DELTA:
                    ords = self._dbidx_to_frame_ordinals(
                        np.asarray(added.to_array(), dtype=np.int64)
                    )
                    e.gen += 1
                    self._excl_entries.move_to_end(key)
                    token = (key, e.gen, exclude, exclude.copy())
                    return e.dev, self._new_ids_tensor(ords), token

            # first sighting of this set, or it shrank or jumped: rebuild on
            # the host once, then incremental again
            mask = self._mask_to_device(self._frame_exclusion_mask(exclude))
            self._excl_entries[key] = _ExclEntry(exclude, exclude.copy(), mask)
            self._excl_entries.move_to_end(key)
            while len(self._excl_entries) > self._EXCL_CACHE:
                self._excl_entries.popitem(last=False)  # evict LRU session
            return mask, self._new_ids_tensor(no_new), None

    def _commit_exclusion(self, token, new_mask):
        if token is None:
            return
        key, gen, exclude, prev_copy = token
        with self._excl_lock:
            e = self._excl_entries.get(key)
            # only the latest hand-out for this session may publish
            if e is not None and e.obj is exclude and e.gen == gen:
                e.prev = prev_copy
                e.dev = new_mask

    # -- query ---------------------------------------------------------------
    def query(
        self,
        *,
        vector,
        vector2: Optional[np.ndarray] = None,
        topk: int,
        shortlist_size: Optional[int] = None,
        exclude: Optional[BitMap] = None,
        agg_method: str = "avg_score",
        aug_larger: str = "all",
        aug_weight: str = "level_max",
        force_exact: bool = False,  # exact is the only path; kept for API parity
        rescore_method=None,  # unused, as in the JAX index
        **kwargs,
    ) -> dict:
        if shortlist_size is None or shortlist_size < topk:
            shortlist_size = max(topk * 5, shortlist_size or 0)
        rank = dict(
            shortlist_size=min(shortlist_size, self.n_frames),
            topk=min(topk, self.n_frames),
            aug_larger=aug_larger, aug_weight=aug_weight,
            agg_method=agg_method, max_zoom=self._max_zoom,
        )
        if isinstance(vector, frame_scoring.DeferredVector):
            assert vector2 is None
            handler = {
                frame_scoring.DeferredRocchio: self._query_rocchio,
                frame_scoring.DeferredLogistic: self._query_logistic,
                frame_scoring.DeferredMultiReg: self._query_multireg,
            }[type(vector)]
            return handler(vector, exclude=exclude, rank=rank)

        mask, new_ids, token = self._device_exclusion(exclude)
        q = self._qtensor(vector)
        if vector2 is None:
            res, new_mask = self._fused_query(q, mask, new_ids, rank)
        elif self._sharded is not None:
            res, new_mask = sharded_query_program(
                self._sharded, q, mask, new_ids, self._qtensor(vector2), **rank)
        else:  # the discounted query has no fused form, as in the JAX package
            res, new_mask = frame_scoring.query_program_incr(
                self._V, self._valid, self._boxes, self._zoom, q,
                self._qtensor(vector2), mask, new_ids, self._row_scale, **rank,
            )
        self._commit_exclusion(token, new_mask)
        return self._format_result(res)[0]

    def _fused_query(self, q, mask, new_ids, rank):
        if self._sharded is not None:
            return sharded_query_program(self._sharded, q, mask, new_ids, **rank)
        return query_program_fused_incr(
            self._V, self._valid, self._boxes, self._zoom, q, mask, new_ids,
            self._row_scale, **rank,
        )

    def _query_rocchio(self, dv, *, exclude, rank) -> dict:
        """Feedback round with the Rocchio update resolved on the device:
        class-mean gather + update + fused query, no host round trip."""
        mask, new_ids, token = self._device_exclusion(exclude)

        def class_mean(rows):
            if rows.size == 0:
                return torch.zeros(self.dim, device=self.device)
            return self._device_rows_f32(self._rows_tensor(rows)).sum(dim=0) / rows.size

        q = (dv.alpha * self._qtensor(dv.q0) + dv.beta * class_mean(dv.pos_rows)
             - dv.gamma * class_mean(dv.neg_rows))
        res, new_mask = self._fused_query(q, mask, new_ids, rank)
        self._commit_exclusion(token, new_mask)
        out, (qh,) = self._format_result(res, q)
        out["qvec"] = qh
        return out

    def fit_deferred_logistic(self, dv):
        """Run a DeferredLogistic's fit on this index's device. Returns
        (LBFGSResult, mu)."""
        from ..learners.logistic_regression import _fit_ce_rows

        dev = self.device

        def t(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)

        V, row_scale, prows = self._V, self._row_scale, torch.from_numpy(dv.prows).to(dev)
        if self._sharded is not None:  # the labeled rows, gathered from the shards
            V, row_scale = self._device_rows_f32(prows), None
            prows = torch.arange(prows.shape[0], device=dev)
        res, mu = _fit_ce_rows(
            V, row_scale, prows,
            t(dv.y), t(dv.sw), dv.pos_weight, dv.reg_weight,
            t(dv.anchor) if dv.has_anchor else None, t(dv.params0),
            fit_intercept=dv.fit_intercept, max_iter=dv.max_iter,
            center=dv.center,
        )
        self.last_fit = {"n_iter": res.n_iter, "host_syncs": res.host_syncs}
        return res, mu

    def _query_logistic(self, dv, *, exclude, rank) -> dict:
        """LogReg2 round: labeled-row gather + LBFGS fit + the fused query
        over the fitted coefficient. A diverged fit raises before the
        exclusion commit, so the session's state stays clean."""
        mask, new_ids, token = self._device_exclusion(exclude)
        res_fit, mu = self.fit_deferred_logistic(dv)
        if res_fit.diverged:
            raise ValueError("regression training diverged (nan/inf loss)")
        params = res_fit.x
        res, new_mask = self._fused_query(params[:-1], mask, new_ids, rank)
        self._commit_exclusion(token, new_mask)
        out, (params_h, mu_h, f_h) = self._format_result(
            res, params, mu, res_fit.f.reshape(1)
        )
        out["qvec"] = params_h[:-1].copy()
        out["fit"] = {"params": params_h, "mu": mu_h, "loss": float(f_h[0]),
                      "diverged": False}
        return out

    def fit_deferred_multireg(self, dv):
        """Run a DeferredMultiReg's fit on this index's device over the
        labeled rows gathered from the device matrix (dequantized for int8).
        Returns (coefficient, LBFGSResult)."""
        dev = self.device
        X = self._device_rows_f32(torch.from_numpy(dv.prows).to(dev))
        coeff, res = dv.model.solve(X, torch.from_numpy(dv.y).to(dev),
                                    torch.from_numpy(dv.sw).to(dev))
        self.last_fit = {"n_iter": res.n_iter, "host_syncs": res.host_syncs}
        return coeff, res

    def _query_multireg(self, dv, *, exclude, rank) -> dict:
        """MultiReg ('seesaw') round: labeled-row gather + centering + the
        4-term LBFGS fit + the fused query over the coefficient. A diverged
        fit raises before the exclusion commit, so the session's state stays
        clean."""
        mask, new_ids, token = self._device_exclusion(exclude)
        coeff, res_fit = self.fit_deferred_multireg(dv)
        if res_fit.diverged:
            raise ValueError("multi-reg fit diverged (nan/inf)")
        res, new_mask = self._fused_query(coeff, mask, new_ids, rank)
        self._commit_exclusion(token, new_mask)
        out, (coeff_h,) = self._format_result(res, coeff)
        out["qvec"] = coeff_h
        return out

    def rank_by_scores(
        self,
        scores,  # (N,) per-vector scores in exact layout, or DeferredPropagation
        *,
        topk: int,
        shortlist_size: Optional[int] = None,
        exclude: Optional[BitMap] = None,
        agg_method: str = "avg_score",
        aug_larger: str = "all",
        aug_weight: str = "level_max",
    ) -> dict:
        """Rank frames by externally produced per-vector scores (label
        propagation) with the same shortlist + augmentation tail as query().
        A DeferredPropagation marker runs the staged KnnProp2 round (click
        scatter + Jacobi propagation + this ranking) fused."""
        if shortlist_size is None or shortlist_size < topk:
            shortlist_size = max(topk * 5, shortlist_size or 0)
        rank = dict(
            shortlist_size=min(shortlist_size, self.n_frames),
            topk=min(topk, self.n_frames),
            aug_larger=aug_larger, aug_weight=aug_weight,
            agg_method=agg_method, max_zoom=self._max_zoom,
        )
        if isinstance(scores, DeferredPropagation):
            if self._sharded is None:
                return self._rank_deferred_propagation(scores.ranker, exclude=exclude,
                                                       rank=rank)
            # no fused round over a mesh: propagate first, then rank
            scores = scores.ranker._flush_propagation()
        mask, new_ids, token = self._device_exclusion(exclude)
        s = torch.as_tensor(scores, dtype=torch.float32).to(self.device)
        if s.shape[0] != self.meta.n_vectors:
            raise ValueError(f"{s.shape[0]} scores for {self.meta.n_vectors} vectors")
        if self._sharded is not None:
            res, new_mask = sharded_rank_program(
                self._sharded, self._sharded.shard_tile_scores(s), mask, new_ids, **rank)
        else:
            res, new_mask = rank_padded(s, self._pad_rows, self._valid, self._boxes,
                                        self._zoom, mask, new_ids, **rank)
        self._commit_exclusion(token, new_mask)
        return self._format_result(res)[0]

    def _rank_deferred_propagation(self, ranker, *, exclude, rank) -> dict:
        """The fused KnnProp2 round: the staged clicks scatter into the
        device label state, up to one segment (`lp.dispatch_iters`) of Jacobi
        steps runs, the scores are ranked, and the ranked result, the
        iteration count and the converged flag come back in ONE transfer.
        A round that needs more than one segment resumes segment by segment
        from the partial iterate (already label-clamped, so the sequence
        continues exactly) and ranks again over an empty exclusion delta
        against the round's new mask. The ranker's state is committed last."""
        lp = ranker.lp
        nbr, w, degree = lp.graph()
        mask, new_ids, token = self._device_exclusion(exclude)
        labels_dev, il_dev, ids, vals = ranker._deferred_state()
        stop = int(min(lp.dispatch_iters or lp.max_iter, lp.max_iter))
        res, new_mask, scores, labels2, il2, i, done = propagate_rank(
            nbr, w, degree, ranker.prior_scores, labels_dev, il_dev, ids, vals,
            ranker._propagation_start(), self._pad_rows, self._valid, self._boxes,
            self._zoom, mask, new_ids,
            reg_lambda=float(lp.reg_lambda), epsilon=lp.epsilon, stop_at=stop, **rank,
        )
        out, (i_h, done_h) = self._format_result(res, i.float(), done.float())
        n_iter, converged, reads = int(i_h[0]), bool(done_h[0]), 1
        if not converged and n_iter < lp.max_iter:
            pr = propagate(
                nbr, w, degree, ranker.prior_scores, labels2, il2, scores,
                reg_lambda=float(lp.reg_lambda), max_iter=lp.max_iter - n_iter,
                epsilon=lp.epsilon, dispatch_iters=lp.dispatch_iters,
            )
            scores, converged = pr.scores, pr.converged
            n_iter, reads = n_iter + pr.n_iter, reads + pr.host_reads
            res, new_mask = rank_padded(
                scores, self._pad_rows, self._valid, self._boxes, self._zoom,
                new_mask, self._new_ids_tensor(np.zeros(0, dtype=np.int64)), **rank,
            )
            out = self._format_result(res)[0]
            reads += 1
        self._commit_exclusion(token, new_mask)
        ranker._commit_deferred(scores, labels2, il2, PropagationResult(
            scores=scores, n_iter=n_iter, converged=converged, host_reads=reads))
        return out

    def _format_result(self, res, *extras: torch.Tensor):
        """QueryResult (+ extra f32 tensors) -> host, in ONE transfer of a
        packed f64 buffer (exact for f32 values and for ids below 2^53).
        Returns (result dict, extras as f32 numpy arrays)."""
        k = res.frame_ids.shape[0]
        parts = [res.frame_ids, res.act_boxes.reshape(-1), res.act_scores,
                 res.n_valid.reshape(1)] + [e.reshape(-1) for e in extras]
        host = torch.cat([p.to(torch.float64) for p in parts]).cpu().numpy()
        off, ext = 6 * k + 1, []
        for e in extras:
            ext.append(host[off:off + e.numel()].astype(np.float32))
            off += e.numel()
        return self._host_result(host, k), ext

    def _format_results(self, res) -> list:
        """A batch's QueryResult (a leading Q axis on every field) -> one
        result dict per query, in ONE transfer."""
        Q, k = res.frame_ids.shape
        parts = [res.frame_ids, res.act_boxes.reshape(Q, -1), res.act_scores,
                 res.n_valid.reshape(Q, 1)]
        host = torch.cat([p.to(torch.float64) for p in parts], dim=1).cpu().numpy()
        return [self._host_result(row, k) for row in host]

    def _host_result(self, host: np.ndarray, k: int) -> dict:
        """Decode one packed row (ids, boxes, scores, count) into the result
        dict."""
        fids = host[:k].astype(np.int64)
        boxes = host[k:5 * k].reshape(k, 4).astype(np.float32)
        scores = host[5 * k:6 * k].astype(np.float32)
        n = int(host[6 * k])
        dbidxs = self.meta.frame_dbidx[fids[:n]]
        activations = [
            {
                "x1": float(b[0]), "y1": float(b[1]),
                "x2": float(b[2]), "y2": float(b[3]),
                "dbidx": int(dbidx), "score": float(s),
            }
            for b, s, dbidx in zip(boxes[:n], scores[:n], dbidxs)
        ]
        return {"dbidxs": dbidxs.astype(np.int64), "activations": activations}

    def new_query(self) -> "BoxFeedbackQuery":
        return BoxFeedbackQuery(self)

    def subset(self, indices: BitMap) -> "MultiscaleIndex":
        keep = np.asarray(indices.to_array(), dtype=np.int64)
        mask = self.meta.subset_mask(keep)
        if mask.all():
            return self
        return MultiscaleIndex(
            device=self.device, embedding=self.embedding,
            vectors=self.vectors[mask], meta=self.meta.select_rows(mask),
            device_dtype=self.device_dtype, mesh=self.mesh,
        )

    def get_knng_path(self, name: str = "") -> str:
        assert self.path is not None
        return str(Path(self.path) / "knn_graph" / name)

    # -- persistence ---------------------------------------------------------
    def save(self, index_path: str, model_name: str = ""):
        """Write `vectors.npz` (the vectors in exact row order, from the host
        mirror or gathered from the device, and the tile metadata) and
        `info.json` naming the JAX class, which both packages' loaders map;
        drop this package's cached loads of the path."""
        from .loader import index_cache

        index_cache.invalidate_prefix(str(Path(index_path)))
        p = Path(index_path)
        p.mkdir(parents=True, exist_ok=True)
        np.savez(
            p / "vectors.npz",
            vectors=self.vectors_for_rows(np.arange(self.meta.n_vectors)),
            dbidx=self.meta.dbidx,
            zoom_level=self.meta.zoom_level,
            boxes=self.meta.boxes,
        )
        info = {
            "constructor": "seesaw_tpu.indices.multiscale.MultiscaleIndex",
            "model": model_name,
            "excluded": self.excluded.to_array().tolist() if len(self.excluded) else [],
        }
        (p / "info.json").write_text(json.dumps(info))

    # -- loading -------------------------------------------------------------
    @staticmethod
    def from_path(index_path: str, *, device=None, embedding=None,
                  **options) -> "MultiscaleIndex":
        """Read the `vectors.npz` / `info.json` that the JAX package writes;
        without `embedding`, the model `info.json` names is loaded onto
        `device` (by default the mesh's primary). Options: device_dtype,
        int8_scale, use_pallas (ignored), coalesce_ms (returns a
        `CoalescingIndex` with that window), mesh (a `parallel.mesh.Mesh` to
        shard the index over) and sharded=True (a mesh of every visible
        card)."""
        mesh = options.get("mesh")
        if mesh is None and options.get("sharded"):
            from ..parallel.mesh import make_mesh

            mesh = make_mesh()
        if device is None:
            device = _index_device(None, mesh)
        p = Path(index_path)
        info = json.loads((p / "info.json").read_text())
        with np.load(p / "vectors.npz") as z:
            meta, order = VectorMeta.from_arrays(z["dbidx"], z["zoom_level"], z["boxes"])
            vectors = z["vectors"][order]
        if embedding is None and info.get("model"):
            embedding = load_embedding(info["model"], device)
        device_dtype = options.get("device_dtype")
        if device_dtype is None:  # same rule as the JAX index
            device_dtype = "bfloat16" if vectors.size * 4 > 4 * 1024**3 else "float32"
        idx = MultiscaleIndex(
            device=device, embedding=embedding, vectors=vectors, meta=meta,
            path=str(p), excluded=BitMap(info.get("excluded") or []),
            device_dtype=device_dtype,
            int8_scale=options.get("int8_scale", "row"),
            mesh=mesh,
        )
        if options.get("coalesce_ms"):
            # concurrent sessions share one (N, D) @ (D, Q) scan
            from ..web.coalesce import CoalescingIndex

            return CoalescingIndex(idx, window_ms=float(options["coalesce_ms"]))
        return idx


def _index_device(device, mesh) -> torch.device:
    """The device an index's host-facing state lives on: `device`, or the
    mesh's primary (which `device`, if given, must be)."""
    if mesh is None:
        if device is None:
            raise ValueError("an index needs a device or a mesh")
        return torch.device(device)
    if device is not None:
        d = torch.device(device)
        if d.type != mesh.primary.type or d.index not in (None, mesh.primary.index):
            raise ValueError(f"device {device} is not the mesh's primary {mesh.primary}")
    return mesh.primary


class BoxFeedbackQuery(InteractiveQuery):
    """Query state + label->vector matching for box feedback."""

    index: MultiscaleIndex

    def __init__(self, index: MultiscaleIndex, _y: np.ndarray = None):
        super().__init__(index, _y=_y)

    def query_random(self, batch_size: int) -> dict:
        remaining = BitMap(self.index.meta.frame_dbidx).difference(self.returned)
        idxs = np.random.permutation(remaining.to_array())[:batch_size]
        self.returned.update(idxs)  # random batches count as returned too
        return {"dbidxs": idxs.astype(np.int64), "activations": None}

    def getXy(self, get_positions: bool = False, target_description: Optional[str] = None):
        rows, dbidx, ys, max_iou = match_labels_to_vectors(
            self.label_db, self.index.meta, target_description=target_description
        )
        if get_positions:
            return rows[ys > 0], rows[ys == 0]
        return {"rows": rows, "dbidx": dbidx, "ys": ys, "max_iou": max_iou}
