"""MultiReg: the full 'seesaw' feedback method.

Counterpart of `seesaw_tpu/loops/multi_reg.py`. Per round it fits a weight
vector from the query anchor with label loss + graph-Laplacian data
regularizer + norm + query-angle regularizers (`learners.multi_reg.RegFit`),
weighting each tile by 1/(tiles in its image). With labels, the fit runs
inside the next query on the index's device (`DeferredMultiReg`); the
label-free fit of `set_text_vec` runs on the index's device too. A
device-built index (no host mirror) gives the XLX matrix its rows from the
device matrix, summed in row chunks there.
"""
from __future__ import annotations

import numpy as np

from ..learners.multi_reg import RegFit
from .graph_based import get_weights_from_index
from .point_based import PointBased


def _per_image_weights(dbidx: np.ndarray) -> np.ndarray:
    """weight = 1 / (number of labeled tiles in the same image)."""
    if dbidx.shape[0] == 0:
        return np.ones(0, dtype=np.float32)
    _, inverse, counts = np.unique(dbidx, return_inverse=True, return_counts=True)
    return (1.0 / counts[inverse]).astype(np.float32)


class MultiReg(PointBased):
    def __init__(self, gdm, q, params):
        super().__init__(gdm, q, params)
        self.options = params.interactive_options or {}
        X = q.index.vectors if q.index.vectors is not None else q.index.rows_f32
        self.xlx = get_weights_from_index(
            q.index, self.options["matrix_options"], xlx_matrix=True, X_vectors=X,
        )

    @staticmethod
    def from_params(gdm, q, params):
        return MultiReg(gdm, q, params)

    def set_text_vec(self, tvec):
        super().set_text_vec(tvec)
        # with both regularizers active the optimization is well-defined even
        # before any labels: run it immediately
        if (
            self.options.get("reg_data_lambda", 0) > 0
            and self.options.get("reg_query_lambda", 0) > 0
            and self.started
        ):
            self.refine()
        else:
            self.curr_vec = self.curr_qvec

    def refine(self, change=None):
        xy = self.q.getXy()
        rows, ys, dbidx = xy["rows"], xy["ys"], xy["dbidx"]
        assert self.curr_qvec is not None
        model = RegFit(
            device=self.index.device,
            xlx=self.xlx,
            qvec=self.curr_qvec,
            label_loss_type=self.options["label_loss_type"],
            rank_loss_margin=self.options.get("rank_loss_margin", 0.0),
            pos_weight=self.options.get("pos_weight", "balanced"),
            reg_data_lambda=self.options["reg_data_lambda"],
            reg_norm_lambda=self.options["reg_norm_lambda"],
            reg_query_lambda=self.options["reg_query_lambda"],
            max_iter=self.options.get("max_iter", 100),
            verbose=self.options.get("verbose", False),
        )
        if rows.shape[0] > 0:
            # the fit runs inside the next query
            self.curr_vec = model.deferred_fit_rows(
                self.index, rows, ys, _per_image_weights(dbidx)
            )
            return
        model.fit(self.index.vectors_for_rows(rows), ys, _per_image_weights(dbidx))
        self.curr_vec = model.get_coeff()
