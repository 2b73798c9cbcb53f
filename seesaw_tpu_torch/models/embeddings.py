"""XEmbedding: the model contract between the embedding and index layers.

The port's own copy of the framework-free part of
`seesaw_tpu/models/embeddings.py`: `from_string`, `from_image` and
`from_raw` return (n, d) float arrays. Implementations:

- `ClipEmbedding` (`models/clip.py`): the PyTorch CLIP towers on a device,
  the production model.
- `HashEmbedding`: deterministic seeded-random unit vectors per input;
  tests and benchmarks build synthetic datasets with it.
"""
from __future__ import annotations

import hashlib
from typing import List, Optional

import numpy as np


class XEmbedding:
    def from_string(self, *, string: str = None, str_list: List[str] = None) -> np.ndarray:
        raise NotImplementedError("abstract")

    def from_image(self, *, preprocessed_image=None, image=None) -> np.ndarray:
        raise NotImplementedError("abstract")

    def from_raw(self, data) -> np.ndarray:
        raise NotImplementedError("abstract")

    @property
    def dim(self) -> int:
        raise NotImplementedError("abstract")


def _hash_vec(key: str, d: int) -> np.ndarray:
    seed = int.from_bytes(hashlib.sha256(key.encode()).digest()[:8], "little")
    rng = np.random.default_rng(seed)
    v = rng.normal(size=d).astype(np.float32)
    return v / np.linalg.norm(v)


class HashEmbedding(XEmbedding):
    """Deterministic pseudo-random unit embedding keyed by content hash."""

    def __init__(self, d: int = 64):
        self._d = d

    @property
    def dim(self) -> int:
        return self._d

    def from_string(self, *, string: str = None, str_list: List[str] = None) -> np.ndarray:
        if string is not None:
            return _hash_vec(string, self._d)
        return np.stack([_hash_vec(s, self._d) for s in (str_list or [])])

    def from_image(self, *, preprocessed_image=None, image=None) -> np.ndarray:
        data = preprocessed_image if preprocessed_image is not None else image
        return _hash_vec(repr(np.asarray(data).tobytes()), self._d)

    def from_raw(self, data) -> np.ndarray:
        return _hash_vec(repr(data), self._d)

    def encode_image_batch(self, pixels) -> np.ndarray:
        """Batch analogue of from_image (host-side; test/dev model)."""
        return np.stack(
            [self.from_image(preprocessed_image=np.asarray(p)) for p in pixels]
        )
