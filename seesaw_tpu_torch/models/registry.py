"""Model registry: resolve an `info.json` model name to an embedding.

Counterpart of `seesaw_tpu/models/registry.py`, with a process-wide cache of
its own keyed by (name, device), so one model never serves two devices:
- `hash-<d>`: the deterministic hash embedding;
- `clip-<variant>` or `clip-<variant>:<path>`: the CLIP towers on `device`.
  The path may be a converted artifact directory (params.npz + info.json +
  vocab), a params.npz, or a torch state-dict file; with no path the
  variant's weights are `init_params` from seed 0.
"""
from __future__ import annotations

import pathlib
import threading

import torch

_cache: dict = {}
_lock = threading.Lock()


def load_embedding(name: str, device):
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        # "cuda" and "cuda:<current>" are one card: one copy of the model
        device = torch.device("cuda", torch.cuda.current_device())
    key = (name, str(device))
    with _lock:
        if key not in _cache:
            _cache[key] = _construct(name, device)
        return _cache[key]


def _construct(name: str, device: torch.device):
    if name.startswith("hash-"):
        from .embeddings import HashEmbedding

        return HashEmbedding(d=int(name.split("-", 1)[1]))
    if name.startswith("clip-"):
        from .clip import ClipEmbedding

        variant, _, ckpt = name.split("-", 1)[1].partition(":")
        if ckpt and (pathlib.Path(ckpt) / "info.json").exists():
            return ClipEmbedding.from_artifact(ckpt, device=device)
        return ClipEmbedding(variant=variant, checkpoint=ckpt or None, device=device)
    raise ValueError(f"unknown model spec {name!r}")
