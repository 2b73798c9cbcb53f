"""AccessMethod: the index contract between retrieval and the session layer.

The port's own copy of `seesaw_tpu/indices/interface.py`: text embedding,
top-k query with exclusion, query-state factory, subsetting. Loading by the
`info.json` constructor string is `indices.loader.load_index`.
"""
from __future__ import annotations

import numpy as np


class AccessMethod:
    def string2vec(self, string: str) -> np.ndarray:
        raise NotImplementedError("abstract")

    def query(self, *, vector: np.ndarray, topk: int, exclude=None, **kwargs) -> dict:
        """Returns {'dbidxs': int array, 'activations': per-image activation
        tables (or None)} for the top-k non-excluded images."""
        raise NotImplementedError("abstract")

    def new_query(self):
        raise NotImplementedError("abstract")

    def vectors_for_rows(self, rows: np.ndarray) -> np.ndarray:
        """f32 vectors for row indices. Default: slice the host mirror;
        indexes without one (MultiscaleIndex.from_device_arrays) gather the
        rows from the device matrix instead."""
        return self.vectors[np.asarray(rows, dtype=np.int64)]

    def sum_vectors_for_rows(self, groups) -> np.ndarray:
        """(k, D) f32 sums of row groups (empty group -> zeros). Default
        reduces the host mirror; device-only indexes override to reduce on
        device and ship k vectors instead of the full labeled matrix."""
        d = self.vectors.shape[1]
        return np.stack([
            self.vectors[np.asarray(g, dtype=np.int64)].sum(axis=0)
            if len(g) else np.zeros(d, dtype=np.float32)
            for g in groups
        ]).astype(np.float32)

    def subset(self, indices) -> "AccessMethod":
        raise NotImplementedError("abstract")

    def __len__(self) -> int:
        raise NotImplementedError("abstract")

    def get_knng_path(self, name: str = "") -> str:
        raise NotImplementedError("abstract")
