"""CoarseIndex: one whole-image vector per image, on one device.

Counterpart of `seesaw_tpu/indices/coarse.py`: derived from a multiscale
index by averaging each image's most zoomed-out tiles
(`ingest.pipeline.create_coarse_index`). It is the port's `MultiscaleIndex`
with one tile per frame (augmentation degenerates to the identity, so
queries rank by the plain score), and labels are taken per image (binary
accept), not by box IoU. `save` writes the JAX class into `info.json`, so a
coarse index saved here loads in both packages.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

import numpy as np

from ..models.registry import load_embedding
from ..query_interface import InteractiveQuery
from ..runtime.bitmap import BitMap
from .meta import VectorMeta
from .multiscale import MultiscaleIndex


def _coarse_meta(dbidx: np.ndarray):
    n = dbidx.shape[0]
    boxes = np.tile(np.array([[0.0, 0.0, 1.0, 1.0]], dtype=np.float32), (n, 1))
    return VectorMeta.from_arrays(dbidx, np.ones(n, dtype=np.int32), boxes)


class CoarseIndex(MultiscaleIndex):
    def __init__(self, *, device, embedding=None, vectors, dbidx, path=None,
                 excluded=None, device_dtype: str = "float32"):
        meta, order = _coarse_meta(np.asarray(dbidx, dtype=np.int32))
        super().__init__(
            device=device, embedding=embedding, vectors=np.asarray(vectors)[order],
            meta=meta, path=path, excluded=excluded, device_dtype=device_dtype,
        )

    def query(self, **kwargs):
        kwargs.setdefault("agg_method", "plain_score")
        return super().query(**kwargs)

    def new_query(self) -> "CoarseQuery":
        return CoarseQuery(self)

    def subset(self, indices: BitMap) -> "CoarseIndex":
        keep = np.asarray(indices.to_array(), dtype=np.int64)
        mask = self.meta.subset_mask(keep)
        if mask.all():
            return self
        return CoarseIndex(
            device=self.device, embedding=self.embedding, vectors=self.vectors[mask],
            dbidx=self.meta.dbidx[mask], device_dtype=self.device_dtype,
        )

    def save(self, index_path: str, model_name: str = ""):
        from .loader import index_cache

        index_cache.invalidate_prefix(str(Path(index_path)))
        p = Path(index_path)
        p.mkdir(parents=True, exist_ok=True)
        np.savez(p / "vectors.npz", vectors=self.vectors, dbidx=self.meta.dbidx)
        info = {
            "constructor": "seesaw_tpu.indices.coarse.CoarseIndex",
            "model": model_name,
        }
        (p / "info.json").write_text(json.dumps(info))

    @staticmethod
    def from_path(index_path: str, *, device, embedding=None, **options) -> "CoarseIndex":
        """Options: device_dtype ('float32' or 'bfloat16')."""
        p = Path(index_path)
        info = json.loads((p / "info.json").read_text())
        with np.load(p / "vectors.npz") as z:
            vectors = z["vectors"]
            dbidx = z["dbidx"]
        if embedding is None and info.get("model"):
            embedding = load_embedding(info["model"], device)
        return CoarseIndex(device=device, embedding=embedding, vectors=vectors, dbidx=dbidx,
                           path=str(p), device_dtype=options.get("device_dtype", "float32"))


class CoarseQuery(InteractiveQuery):
    index: CoarseIndex

    def query_random(self, batch_size: int) -> dict:
        remaining = BitMap(self.index.meta.frame_dbidx).difference(self.returned)
        idxs = np.random.permutation(remaining.to_array())[:batch_size]
        self.returned.update(idxs)
        return {"dbidxs": idxs.astype(np.int64), "activations": None}

    def getXy(self, get_positions: bool = False, target_description: Optional[str] = None):
        """Image-level binary labels."""
        meta = self.index.meta
        seen = self.label_db.get_seen()
        seen_mask = seen.contains_many(meta.dbidx.astype(np.uint32))
        rows = np.where(seen_mask)[0]
        ys = np.array(
            [float(self.label_db.get(int(meta.dbidx[r]), format="binary") or 0)
             for r in rows],
            dtype=np.float32,
        )
        if get_positions:
            return rows[ys > 0], rows[ys == 0]
        return {
            "rows": rows,
            "dbidx": meta.dbidx[rows],
            "ys": ys,
            "max_iou": ys.copy(),
        }
