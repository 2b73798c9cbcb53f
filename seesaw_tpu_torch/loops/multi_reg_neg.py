"""MultiRegNeg: the two-head variant with a confusion class.

Counterpart of `seesaw_tpu/loops/multi_reg_neg.py`. It fits (target,
confusion) weight vectors jointly from box descriptions: boxes not marked
accepted define the confusion class, and at ranking time the confusion
head's scores are subtracted (the query's `vector2`, which takes the
unfused full-score query, as in the JAX package). The fit runs on the
index's device.
"""
from __future__ import annotations

import numpy as np

from ..learners.multi_reg import MultiRegFit
from .multi_reg import _per_image_weights
from .point_based import PointBased


class MultiRegNeg(PointBased):
    def __init__(self, gdm, q, params):
        super().__init__(gdm, q, params)
        self.options = params.interactive_options or {}
        self.confusion_vec = None

    @staticmethod
    def from_params(gdm, q, params):
        return MultiRegNeg(gdm, q, params)

    def set_text_vec(self, tvec):
        super().set_text_vec(tvec)
        self.curr_vec = self.curr_qvec
        self.confusion_vec = None

    def refine(self, change=None):
        xy = self.q.getXy()
        rows, y, dbidx = xy["rows"], xy["ys"], xy["dbidx"]
        X = self.index.vectors_for_rows(rows)

        # confusion class: description of the first non-accepted labeled box
        table = self.q.label_db.get_box_table(accepted_only=False)
        descs = [
            d for d, acc in zip(table.description, table.marked_accepted)
            if not acc and d is not None
        ]
        if descs:
            yconf = self.q.getXy(target_description=descs[0])["ys"]
        else:
            yconf = np.zeros_like(y)
        ys = np.stack([y, yconf], axis=1).astype(np.float32)

        assert self.curr_qvec is not None
        model = MultiRegFit(
            device=self.index.device,
            qvec=self.curr_qvec,
            reg_norm_lambda=self.options["reg_norm_lambda"],
            reg_query_lambda=self.options["reg_query_lambda"],
            max_iter=self.options.get("max_iter", 100),
            verbose=self.options.get("verbose", False),
        )
        model.fit(X, ys, _per_image_weights(dbidx))
        self.curr_vec = model.get_coeff()
        self.confusion_vec = model.get_confusion_vec()

    def next_batch(self):
        vector2 = (
            self.confusion_vec
            if (self.options.get("discount_neg", True) and self.confusion_vec is not None)
            else None
        )
        return self.q.query_stateful(
            vector=np.asarray(self.curr_vec).reshape(-1),
            batch_size=self.params.batch_size,
            shortlist_size=self.params.shortlist_size,
            agg_method=self.params.agg_method,
            aug_larger=self.params.aug_larger,
            aug_weight=self.params.aug_weight or "level_max",
            vector2=vector2,
        )
