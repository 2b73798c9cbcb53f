"""Struct-of-arrays vector metadata for patch-embedding indices.

The port's own copy of `seesaw_tpu/indices/meta.py`: a columnar numpy struct
sorted by dbidx, with a precomputed frame segmentation so that the query
program treats every image as a contiguous tile segment.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np


def next_pow2(x: int, floor: int = 8) -> int:
    """Tile-bound granularity shared by the single-chip and sharded padded
    layouts (one definition so the two can never drift apart)."""
    p = floor
    while p < x:
        p *= 2
    return p


@dataclass
class VectorMeta:
    """Per-vector metadata, sorted by dbidx (frames contiguous).

    Attributes:
      dbidx: (N,) int32 image id per vector, ascending.
      zoom_level: (N,) int32 pyramid level of the tile (1 = finest).
      boxes: (N,4) float32 [x1,y1,x2,y2] tile extent in original image pixels.
      frame_dbidx: (F,) int32 distinct dbidxs, ascending.
      frame_starts: (F+1,) int32 segment offsets: frame f owns rows
        [frame_starts[f], frame_starts[f+1]).
      frame_id: (N,) int32 inverse mapping row -> frame ordinal.
    """

    dbidx: np.ndarray
    zoom_level: np.ndarray
    boxes: np.ndarray
    frame_dbidx: np.ndarray
    frame_starts: np.ndarray
    frame_id: np.ndarray

    @property
    def n_vectors(self) -> int:
        return self.dbidx.shape[0]

    @property
    def n_frames(self) -> int:
        return self.frame_dbidx.shape[0]

    @property
    def max_tiles_per_frame(self) -> int:
        if self.n_frames == 0:
            return 0
        return int(np.max(np.diff(self.frame_starts)))

    @property
    def max_zoom_level(self) -> int:
        return int(self.zoom_level.max(initial=0))

    @staticmethod
    def from_arrays(
        dbidx: np.ndarray, zoom_level: np.ndarray, boxes: np.ndarray
    ) -> tuple["VectorMeta", np.ndarray]:
        """Build metadata, sorting rows by dbidx (stable). Returns the meta
        plus the permutation that must also be applied to the vector matrix."""
        dbidx = np.asarray(dbidx, dtype=np.int32)
        order = np.argsort(dbidx, kind="stable")
        dbidx = dbidx[order]
        zoom_level = np.asarray(zoom_level, dtype=np.int32)[order]
        boxes = np.asarray(boxes, dtype=np.float32)[order]

        frame_dbidx, frame_id, counts = np.unique(
            dbidx, return_inverse=True, return_counts=True
        )
        frame_starts = np.zeros(frame_dbidx.shape[0] + 1, dtype=np.int32)
        np.cumsum(counts, out=frame_starts[1:])
        meta = VectorMeta(
            dbidx=dbidx,
            zoom_level=zoom_level,
            boxes=boxes,
            frame_dbidx=frame_dbidx.astype(np.int32),
            frame_starts=frame_starts,
            frame_id=frame_id.astype(np.int32),
        )
        return meta, order

    def padded_rows(self, tile_bound: int) -> tuple[np.ndarray, np.ndarray]:
        """Frame-major padded gather plan: (rows, valid), both (F, T).

        rows[f, t] indexes into the exact (sorted) layout, clipped for
        padding; valid marks real tiles. Used to build the device-resident
        padded arrays that make frame-max a reshape (ops.frame_scoring)."""
        T = tile_bound
        starts = self.frame_starts[:-1].astype(np.int64)
        lengths = np.diff(self.frame_starts).astype(np.int64)
        assert lengths.max(initial=0) <= T, "tile_bound too small"
        offs = np.arange(T, dtype=np.int64)
        rows = np.clip(starts[:, None] + offs[None, :], 0, max(self.n_vectors - 1, 0))
        valid = offs[None, :] < lengths[:, None]
        return rows.astype(np.int64), valid

    def subset_mask(self, keep_dbidx: np.ndarray) -> np.ndarray:
        """Row mask selecting vectors whose dbidx is in ``keep_dbidx``."""
        return np.isin(self.dbidx, keep_dbidx)

    def select_rows(self, mask: np.ndarray) -> "VectorMeta":
        meta, order = VectorMeta.from_arrays(
            self.dbidx[mask], self.zoom_level[mask], self.boxes[mask]
        )
        # rows were already sorted; the stable re-sort is the identity
        assert np.array_equal(order, np.arange(order.shape[0]))
        return meta

    # -- persistence -------------------------------------------------------
    def save(self, path: str | Path):
        np.savez_compressed(
            path,
            dbidx=self.dbidx,
            zoom_level=self.zoom_level,
            boxes=self.boxes,
        )

    @staticmethod
    def load(path: str | Path) -> "VectorMeta":
        with np.load(path) as z:
            meta, order = VectorMeta.from_arrays(z["dbidx"], z["zoom_level"], z["boxes"])
        assert np.array_equal(order, np.arange(order.shape[0])), "stored meta must be sorted"
        return meta
