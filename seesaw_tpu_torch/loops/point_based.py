"""Point-based loops: rank by one query vector, refine the vector.

Counterpart of `seesaw_tpu/loops/point_based.py`; the loop contract
(`LoopBase`, start policies) is the JAX package's own, which is
framework-free.
"""
from __future__ import annotations

import numpy as np

from seesaw_tpu.loops.loop_base import LoopBase

from ..learners import LogisticRegression
from ..ops.frame_scoring import DeferredRocchio, DeferredVector


class PointBased(LoopBase):
    def __init__(self, gdm, q, params):
        super().__init__(gdm, q, params)
        self.curr_vec = None

    def set_text_vec(self, vec):
        super().set_text_vec(vec)
        self.curr_vec = vec

    def next_batch(self):
        assert self.curr_vec is not None
        if isinstance(self.curr_vec, DeferredVector):
            res = self.q.query_stateful(
                vector=self.curr_vec,
                batch_size=self.params.batch_size,
                shortlist_size=self.params.shortlist_size,
                agg_method=self.params.agg_method,
                aug_larger=self.params.aug_larger,
                aug_weight=self.params.aug_weight or "level_max",
            )
            # the vector resolved on the device rides back with the result
            if "qvec" in res:
                self.curr_vec = res.pop("qvec")
            return res
        return self._next_batch_curr_vec(np.asarray(self.curr_vec).reshape(-1))

    def refine(self, change=None):
        raise NotImplementedError("implement in subclass")


class Plain(PointBased):
    """Zero-feedback baseline: always rank by the text vector."""

    @staticmethod
    def from_params(gdm, q, params):
        return Plain(gdm, q, params)

    def refine(self, change=None):
        pass


class LogReg2(PointBased):
    """Fit a logistic probe on labeled tile vectors; its coefficient becomes
    the query vector. Skips fitting while labels are one-sided."""

    def __init__(self, gdm, q, params):
        super().__init__(gdm, q, params)
        self.model = None

    @staticmethod
    def from_params(gdm, q, params):
        return LogReg2(gdm, q, params)

    def set_text_vec(self, vec):
        super().set_text_vec(vec)
        self.model = None

    def next_batch(self):
        res = super().next_batch()
        fit = res.pop("fit", None) if isinstance(res, dict) else None
        if fit is not None:
            self.model.apply_fit_result(fit)  # keeps warm starts working
        return res

    def refine(self, change=None):
        xy = self.q.getXy()
        rows, ys = xy["rows"], xy["ys"]
        if rows.shape[0] == 0 or (ys == 1).all() or (ys == 0).all():
            return
        if self.model is None:
            opts = dict(self.params.interactive_options or {})
            opts.pop("model_type", None)
            self.model = LogisticRegression(
                device=self.index.device, regularizer_vector=self.state.tvec, **opts
            )
        # the fit runs inside the next query
        self.curr_vec = self.model.deferred_fit_rows(self.index, rows, ys)


class RocchioUpdate(PointBased):
    """q <- alpha*q0 + beta*mean(relevant) - gamma*mean(non-relevant)."""

    def __init__(self, gdm, q, params):
        super().__init__(gdm, q, params)
        opts = params.interactive_options or {}
        self.alpha = opts["rocchio_alpha"]
        self.beta = opts["rocchio_beta"]
        self.gamma = opts["rocchio_gamma"]

    @staticmethod
    def from_params(gdm, q, params):
        return RocchioUpdate(gdm, q, params)

    def refine(self, change=None):
        xy = self.q.getXy()
        rows, ys = xy["rows"], xy["ys"]
        # the class means and the update run inside the next query
        self.curr_vec = DeferredRocchio(
            self.curr_qvec, rows[ys > 0], rows[ys == 0], self.alpha, self.beta, self.gamma,
        )


class RandomResults(LoopBase):
    """Random unseen images; no feedback. Benchmark floor."""

    @staticmethod
    def from_params(gdm, q, params):
        return RandomResults(gdm, q, params)

    def set_text_vec(self, vec):
        self.curr_qvec = vec

    def next_batch_external(self):
        return self.q.query_random(batch_size=self.params.batch_size)

    def refine_external(self, change=None):
        pass
