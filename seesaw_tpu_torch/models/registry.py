"""Model registry: resolve an `info.json` model name to an embedding.

The `hash-<d>` branch of `seesaw_tpu/models/registry.py`, with a
process-wide cache of its own. `clip-*` names need the CLIP towers, a later
slice of the port.
"""
from __future__ import annotations

import threading

_cache: dict = {}
_lock = threading.Lock()


def load_embedding(name: str):
    with _lock:
        if name not in _cache:
            _cache[name] = _construct(name)
        return _cache[name]


def _construct(name: str):
    if name.startswith("hash-"):
        from .embeddings import HashEmbedding

        return HashEmbedding(d=int(name.split("-", 1)[1]))
    if name.startswith("clip-"):
        raise NotImplementedError(
            f"embedding {name!r} needs the CLIP towers, not ported yet; "
            "pass embedding= to the index"
        )
    raise ValueError(f"unknown model spec {name!r}")
