"""PseudoLR: logistic probe on real labels + propagated pseudo-labels.

Counterpart of `seesaw_tpu/loops/pseudo_lr.py`: label propagation
(`KnnProp2`, the Jacobi kernel on a CUDA index) produces soft labels on an
unlabeled sample; a logistic regression is fit on real+pseudo examples with
real labels up-weighted, on the index's device; optionally it ranks via the
graph until both a positive and a negative exist ('switch_over').
"""
from __future__ import annotations

import numpy as np

from ..learners import LogisticRegression
from .graph_based import KnnProp2, get_label_prop
from .point_based import PointBased
from .util import makeXy


class PseudoLR(PointBased):
    def __init__(self, gdm, q, params):
        super().__init__(gdm, q, params)
        opts = params.interactive_options or {}
        self.options = opts
        self.label_prop_params = opts["label_prop_params"]
        self.log_reg_params = opts["log_reg_params"]
        self.switch_over = opts["switch_over"]
        self.real_sample_weight = opts["real_sample_weight"]
        assert self.real_sample_weight >= 1.0
        label_prop = get_label_prop(q, label_prop_params=self.label_prop_params)
        self.knn_based = KnnProp2(gdm, q, params, knn_model=label_prop)

    @staticmethod
    def from_params(gdm, q, params):
        return PseudoLR(gdm, q, params)

    def set_text_vec(self, tvec):
        super().set_text_vec(tvec)
        self.knn_based.set_text_vec(tvec)

    def refine(self, change=None):
        self.knn_based.refine()
        # the ranker's host scores: the staged propagation runs here
        X, y, is_real = makeXy(
            self.index, self.knn_based.state.knn_model,
            sample_size=self.options["sample_size"],
        )
        model = LogisticRegression(
            device=self.index.device, regularizer_vector=self.state.tvec,
            **self.log_reg_params
        )
        weights = np.ones_like(y)
        weights[is_real > 0] = self.real_sample_weight
        model.fit(X, y, weights)
        self.curr_vec = model.get_coeff().reshape(-1)

    def next_batch(self):
        pos, neg = self.q.getXy(get_positions=True)
        if self.switch_over and (len(pos) == 0 or len(neg) == 0):
            return self.knn_based.next_batch()
        return super().next_batch()
