"""LoopBase: the feedback-method contract and start-policy gating.

The port's own copy of `seesaw_tpu/loops/loop_base.py`: a loop owns the
current query vector and implements `next_batch`/`refine`;
`refine_external`/`next_batch_external` apply the session's start policy:
custom behavior starts once the configured labeling condition is met, and
before that the text vector ranks.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..basic_types import SessionParams
from ..query_interface import InteractiveQuery


@dataclass
class LoopState:
    curr_str: Optional[str] = None
    tvec: Optional[np.ndarray] = None
    vec_state: object = None
    knn_model: object = None


class LoopBase:
    q: InteractiveQuery
    params: SessionParams
    state: LoopState

    def __init__(self, gdm, q: InteractiveQuery, params: SessionParams):
        self.gdm = gdm
        self.params = params
        self.state = LoopState()
        self.q = q
        self.index = q.index
        self.curr_qvec: Optional[np.ndarray] = None
        self.reversal = False  # set by the session on accept-after-reject
        self.started = params.start_policy == "from_start"

    def set_reversals(self):
        if not self.reversal:
            self.reversal = True

    def get_stats(self):
        return None

    def set_text_vec(self, vec: np.ndarray):
        self.curr_qvec = vec
        self.state.tvec = vec

    def _next_batch_curr_vec(self, vec: np.ndarray) -> dict:
        assert not np.isnan(vec).any(), "NaN in query vector"
        return self.q.query_stateful(
            vector=vec,
            batch_size=self.params.batch_size,
            shortlist_size=self.params.shortlist_size,
            agg_method=self.params.agg_method,
            aug_larger=self.params.aug_larger,
            aug_weight=self.params.aug_weight or "level_max",
        )

    @staticmethod
    def from_params(gdm, q, params) -> "LoopBase":
        raise NotImplementedError("implement in subclass")

    def next_batch_external(self) -> dict:
        if self.started:
            return self.next_batch()
        return self._next_batch_curr_vec(vec=self.curr_qvec)

    def next_batch(self) -> dict:
        raise NotImplementedError("implement in subclass")

    def refine(self, change=None):
        raise NotImplementedError("implement in subclass")

    def _labeled_image_counts(self):
        """(n_pos_images, n_neg_images) from per-vector labels, max per image."""
        xy = self.q.getXy()
        dbidx, ys = xy["dbidx"], xy["ys"]
        if dbidx.shape[0] == 0:
            return 0, 0
        uniq = np.unique(dbidx)
        n_pos = n_neg = 0
        for u in uniq:
            m = ys[dbidx == u].max()
            if m == 1.0:
                n_pos += 1
            else:
                n_neg += 1
        return n_pos, n_neg

    def refine_external(self, change=None):
        if not self.started:
            len_pos, len_neg = self._labeled_image_counts()
            policy = self.params.start_policy
            if policy == "from_start":
                start = True
            elif policy == "after_first_batch":
                start = (len_pos + len_neg) > 0
            elif policy == "after_first_positive":
                start = len_pos > 0
            elif policy == "after_first_negative":
                start = len_neg > 0
            elif policy == "after_first_positive_and_negative":
                start = len_pos > 0 and len_neg > 0
            elif policy == "after_first_reversal":
                start = self.reversal
            else:
                raise ValueError(f"start_policy {policy!r} not implemented")
            self.started = start

        if self.started:
            self.refine(change=change)
