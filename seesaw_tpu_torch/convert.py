"""JAX-side state, passed as numpy arrays, -> the port's objects.

- `index_from_arrays`: an index from a JAX index's host `vectors` and
  `meta`; the port quantizes int8 by the same numpy code, so both packages
  hold the same bytes.
- `index_from_device_state`: an index from a JAX index's device arrays
  (`_V`, `_valid`, `_boxes`, `_zoom`, `_row_scale`, `_frame_scale`, brought
  to numpy), dropping the 1024-frame tail that the Pallas layout pads on.
- `probe_from_arrays`: a `LogisticRegression` carrying a JAX probe's warm
  start (`params_`, `mu_`, `anchor_`).
- `weights_from_arrays`: a JAX `SymmetricWeights`' (nbr, w, degree) as the
  port's weight structure, with its tensors on `device`.
- `ranker_state_from_arrays`: a JAX label-propagation ranker's device state
  (labels, is_labeled, prior) as tensors.
- `clip_params_from_arrays`: a JAX `ClipModel`'s params (a nested dict of
  numpy arrays) as the port's CLIP state dict; `clip_arrays_from_state_dict`
  is its inverse.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .indices.meta import VectorMeta
from .knn_graph import SymmetricWeights
from .indices.multiscale import MultiscaleIndex
from .learners import LogisticRegression
from .models.clip import ClipConfig, _flatten, _npz_arrays, _state_dict_from_flat


def to_tensor(a: np.ndarray, device) -> torch.Tensor:
    """numpy (including ml_dtypes bfloat16, as JAX hands it out) -> tensor.
    Copies: arrays that JAX hands out are read-only."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def index_from_arrays(vectors: np.ndarray, meta: VectorMeta, *, device,
                      device_dtype: str = "float32", int8_scale: str = "row",
                      embedding=None) -> MultiscaleIndex:
    return MultiscaleIndex(
        device=device, embedding=embedding, vectors=vectors, meta=meta,
        device_dtype=device_dtype, int8_scale=int8_scale,
    )


def index_from_device_state(
    V: np.ndarray, valid: np.ndarray, boxes: np.ndarray, zoom: np.ndarray,
    meta: VectorMeta, *, device, row_scale: Optional[np.ndarray] = None,
    frame_scale: Optional[np.ndarray] = None, embedding=None,
) -> MultiscaleIndex:
    F = meta.n_frames
    T = valid.shape[1]
    n = F * T

    def opt(a, k):
        return None if a is None else to_tensor(np.asarray(a)[:k], device)

    return MultiscaleIndex.from_device_arrays(
        embedding=embedding, V=to_tensor(np.asarray(V)[:n], device),
        valid=to_tensor(np.asarray(valid)[:F], device),
        boxes=to_tensor(np.asarray(boxes)[:n], device),
        zoom=to_tensor(np.asarray(zoom)[:n], device),
        meta=meta, row_scale=opt(row_scale, n), frame_scale=opt(frame_scale, F),
    )


def probe_from_arrays(params_: Optional[np.ndarray], mu_: Optional[np.ndarray],
                      anchor_: Optional[np.ndarray], *, device,
                      **options) -> LogisticRegression:
    probe = LogisticRegression(device=device, **options)
    probe.params_ = None if params_ is None else np.asarray(params_, np.float32)
    probe.mu_ = None if mu_ is None else np.asarray(mu_, np.float32)
    probe.anchor_ = None if anchor_ is None else np.asarray(anchor_, np.float32)
    return probe


def weights_from_arrays(nbr: np.ndarray, w: np.ndarray, degree: np.ndarray,
                        device) -> SymmetricWeights:
    weights = SymmetricWeights(nbr=np.array(nbr, np.int32), w=np.array(w, np.float32),
                               degree=np.array(degree, np.float32))
    weights.device_arrays(device)
    return weights


def ranker_state_from_arrays(labels: np.ndarray, is_labeled: np.ndarray,
                             prior: np.ndarray, device):
    """(labels f32, is_labeled bool, prior f32) tensors on `device`."""
    return (to_tensor(np.asarray(labels, np.float32), device),
            to_tensor(np.asarray(is_labeled, bool), device),
            to_tensor(np.asarray(prior, np.float32), device))


def clip_params_from_arrays(tree, cfg: ClipConfig) -> dict:
    """JAX `ClipModel` params, e.g. `jax.tree.map(np.asarray, params)`, ->
    the state dict of the port's `ClipModel(cfg)`: flax (in, out) kernels
    become (out, in) weights, the (kh, kw, in, out) patch kernel the patch
    embedding's (out, kh * kw * in) weight, layer-norm scales weights.
    Raises if a name or shape does not match `cfg`."""
    return _state_dict_from_flat(_flatten(tree), cfg)


def clip_arrays_from_state_dict(sd) -> dict:
    """The port's CLIP state dict (on any device) -> the JAX `ClipModel`'s
    params as a nested dict of f32 numpy arrays, flax's layout:
    `{"vision": {"layer_0": {"self_attn": {"q_proj": {"kernel": ...}}}},
    ..., "logit_scale": ...}`. The inverse of `clip_params_from_arrays`."""
    tree: dict = {}
    for path, a in _npz_arrays(sd).items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return tree
