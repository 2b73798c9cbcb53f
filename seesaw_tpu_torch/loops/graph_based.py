"""Graph-based loop: KnnProp2, rank by propagated label scores.

Counterpart of `seesaw_tpu/loops/graph_based.py`: read and restrict the kNN
graph, RBF-weight and symmetrize it, and each round propagate the user's
labels over it; the ranking runs the frame-augmentation tail over the
propagated per-tile scores. Weight structures are memoized process-wide in
a cache of the port's own, and each keeps one tensor copy per device.

The JAX package's windowed layout for its TPU lane-shuffle kernel (and the
sidecar file that caches its layout decisions) is not carried over: the
card's kernel reads the graph's own (N, Kp) arrays. The option
`interactive_options.windowed` is accepted and ignored.
"""
from __future__ import annotations

import threading
from typing import Optional

import numpy as np
from pydantic import BaseModel

from ..knn_graph import KNNGraph, forward_weights, rbf_kernel, symmetrize_weights
from .knn_methods import LabelPropagationRanker2
from .loop_base import LoopBase


class WeightMatrixOptions(BaseModel):
    knn_path: str = ""
    knn_k: int
    edist: float
    self_edges: bool = False
    normalized_weights: bool = False
    symmetric: bool = True
    xlx_matrix: bool = False


_wm_cache: dict = {}
_wm_lock = threading.Lock()


def lookup_weights(opts: WeightMatrixOptions, *, use_cache: bool = True,
                   X_vectors: Optional[np.ndarray] = None):
    """Weight structure (or the XLX matrix) for a graph path, cached."""
    key = opts.model_dump_json()
    with _wm_lock:
        if use_cache and key in _wm_cache:
            return _wm_cache[key]
    knng = KNNGraph.from_file(opts.knn_path).restrict_k(k=opts.knn_k)
    if opts.symmetric:
        weights = symmetrize_weights(knng, rbf_kernel(opts.edist))
    else:
        # uniform-degree forward adjacency (self included, weight 0)
        weights = forward_weights(knng, rbf_kernel(opts.edist))
    if opts.xlx_matrix:
        assert X_vectors is not None
        out = weights.xlx(X_vectors, normalize_by_trace=True)
    else:
        out = weights
    if use_cache:
        with _wm_lock:
            out = _wm_cache.setdefault(key, out)
    return out


def get_weights_from_index(idx, weight_matrix_options: dict, xlx_matrix: bool = False,
                           X_vectors=None):
    opts = WeightMatrixOptions(**weight_matrix_options)
    opts.xlx_matrix = xlx_matrix
    opts.knn_path = str(idx.get_knng_path(name=weight_matrix_options.get("knn_path", "")))
    use_cache = "subset" not in opts.knn_path
    return lookup_weights(opts, use_cache=use_cache,
                          X_vectors=X_vectors if xlx_matrix else None)


def get_label_prop(q, label_prop_params: dict) -> LabelPropagationRanker2:
    weights = get_weights_from_index(q.index, label_prop_params["matrix_options"])
    kwargs = {k: v for k, v in label_prop_params.items()
              if k not in ("matrix_options", "windowed")}
    return LabelPropagationRanker2(weights=weights, device=q.index.device, **kwargs)


class KnnProp2(LoopBase):
    def __init__(self, gdm, q, params, knn_model):
        super().__init__(gdm, q, params)
        self.state.knn_model = knn_model

    @staticmethod
    def from_params(gdm, q, p):
        return KnnProp2(gdm, q, p, get_label_prop(q, p.interactive_options))

    def set_text_vec(self, tvec):
        super().set_text_vec(tvec)
        self.state.knn_model.set_base_scores(self.index.score_device(tvec))

    def next_batch(self):
        p = self.params
        res = self.index.rank_by_scores(
            self.state.knn_model.current_scores_any(),
            topk=p.batch_size,
            shortlist_size=p.shortlist_size,
            exclude=self.q.returned,
            agg_method=p.agg_method,
            aug_larger=p.aug_larger,
            aug_weight=p.aug_weight or "level_max",
        )
        self.q.returned.update(res["dbidxs"])
        return res

    def refine(self, change=None):
        pos, neg = self.q.getXy(get_positions=True)
        idxs = np.concatenate([pos, neg])
        labels = np.concatenate([np.ones_like(pos), np.zeros_like(neg)])
        self.state.knn_model.update(idxs, labels)
