"""Active-search loops: ENS planner (ActiveSearch) and greedy LKNN.

Counterpart of `seesaw_tpu/loops/active_search.py`: an LKNN probability
model over the kNN graph, with gamma either fixed or calibrated from CLIP
scores; per round the planner picks ONE vector (batch_size-1 loops)
maximizing expected positives over the reward horizon, optionally adjusted
to the remaining budget; the vectorized planner runs on the index's device.
Labels condition the model on the image's first vector. The model needs
the index's host vectors, as in the JAX package.
"""
from __future__ import annotations

import math

import numpy as np

from ..calibration import FixedCalibrator
from .ens_search import efficient_nonmyopic_search
from .graph_based import get_weights_from_index
from .lknn_model import Dataset, LKNNModel, initial_gamma_array
from .loop_base import LoopBase


def _model_from_index(q, interactive_options) -> tuple[LKNNModel, np.ndarray]:
    weights = get_weights_from_index(q.index, interactive_options["matrix_options"])
    dataset = Dataset.from_vectors(q.index.vectors)
    gamma0 = initial_gamma_array(0.1, q.index.vectors.shape[0])
    return LKNNModel.from_dataset(dataset, nbr=weights.nbr, gamma=gamma0), weights.nbr


class _LKNNLoopBase(LoopBase):
    """Shared dbidx<->vector translation + conditioning plumbing."""

    def _first_vec_of_dbidx(self, dbidx: int) -> int:
        meta = self.index.meta
        f = int(np.searchsorted(meta.frame_dbidx, dbidx))
        assert meta.frame_dbidx[f] == dbidx
        return int(meta.frame_starts[f])

    def _emit_vector(self, vec_idx: int) -> dict:
        meta = self.index.meta
        dbidx = int(meta.dbidx[vec_idx])
        # mark ALL the image's tiles seen in the planner so no other tile of
        # the same image is proposed again (the no-repeat session contract;
        # the reference only conditioned one tile, which can repeat images
        # on multiscale indices)
        f = int(np.searchsorted(meta.frame_dbidx, dbidx))
        lo, hi = int(meta.frame_starts[f]), int(meta.frame_starts[f + 1])
        self.prob_model.dataset.seen_indices.update(np.arange(lo, hi))
        ans = {"dbidxs": np.array([dbidx], dtype=np.int64), "activations": None}
        self.q.returned.update(ans["dbidxs"])
        return ans

    def _apply_change(self, change):
        assert change is not None, "session always provides the change list"
        translated = []
        if getattr(self, "_refine_not_called_before", True):
            pos, neg = self.q.getXy(get_positions=True)
            translated += [(int(i), 1) for i in pos]
            translated += [(int(i), 0) for i in neg]
            self._refine_not_called_before = False
        else:
            for dbidx, y in change:
                translated.append((self._first_vec_of_dbidx(int(dbidx)), int(y)))
        for idx, y in translated:
            self.prob_model.condition_(idx, y)


class ActiveSearch(_LKNNLoopBase):
    def __init__(self, gdm, q, params):
        super().__init__(gdm, q, params)
        opts = params.interactive_options or {}
        self.options = opts
        self.prob_model, self._nbr = _model_from_index(q, opts)
        self.pruned_fractions = []
        self._refine_not_called_before = True

        self.gamma_cfg = opts["gamma"]
        if self.gamma_cfg["mode"] == "clip":
            calibration = self.gamma_cfg["calibration"]
            if calibration == "ground_truth":
                self._calibrator = q.get_calibrator()
                assert self._calibrator is not None, "pass_ground_truth required"
            elif calibration == "sigmoid":
                self._calibrator = FixedCalibrator(
                    a=self.gamma_cfg["a"], b=self.gamma_cfg["b"], sigmoid=True
                )
            elif calibration == "raw":
                self._calibrator = FixedCalibrator(a=1.0, b=0.0, sigmoid=False)
            else:
                raise ValueError(f"unknown calibration {calibration!r}")
        elif self.gamma_cfg["mode"] == "fixed":
            self.prob_model = self.prob_model.with_gamma(
                initial_gamma_array(self.gamma_cfg["value"], q.index.vectors.shape[0])
            )
        else:
            raise ValueError(f"unknown gamma mode {self.gamma_cfg['mode']!r}")

    @staticmethod
    def from_params(gdm, q, p):
        return ActiveSearch(gdm, q, p)

    def get_stats(self):
        return {"pruned_fractions": self.pruned_fractions}

    def set_text_vec(self, tvec):
        super().set_text_vec(tvec)
        self.scores = self.index.score(tvec)
        if self.gamma_cfg["mode"] == "clip":
            probs = self._calibrator.get_probabilities(tvec, self.index.vectors)
            self.prob_model = self.prob_model.with_gamma(probs)

    def next_batch(self):
        opts = self.options
        reward_horizon = opts["reward_horizon"]
        if opts.get("adjust_horizon"):
            remaining = opts["max_steps"] - len(self.q.returned)
        else:
            remaining = math.inf
        adjusted = int(min(reward_horizon, remaining))
        assert adjusted > 0, "horizon exhausted"
        lookahead = min(2, adjusted)
        res = efficient_nonmyopic_search(
            self.prob_model,
            reward_horizon=adjusted,
            lookahead_limit=lookahead,
            pruning_on=opts.get("pruning_on", False),
            implementation=opts.get("implementation", "vectorized"),
            device=self.index.device,
        )
        self.pruned_fractions.append(res.pruned_fraction)
        return self._emit_vector(int(res.index))

    def refine(self, change=None):
        self._apply_change(change)


class LKNNSearch(_LKNNLoopBase):
    """Greedy top-1 by current LKNN score."""

    def __init__(self, gdm, q, params):
        super().__init__(gdm, q, params)
        opts = params.interactive_options or {}
        self.options = opts
        self.prob_model, self._nbr = _model_from_index(q, opts)
        self._refine_not_called_before = True
        self._calibrator = q.get_calibrator()

        gamma = opts["gamma"]
        if gamma == "calibrate":
            assert self._calibrator is not None
            gamma_mean = self._calibrator.get_mean()
        else:
            gamma_mean = gamma
        self.prob_model = self.prob_model.with_gamma(
            initial_gamma_array(gamma_mean, q.index.vectors.shape[0])
        )
        self.use_clip_as_gamma = opts["use_clip_as_gamma"]

    @staticmethod
    def from_params(gdm, q, p):
        return LKNNSearch(gdm, q, p)

    def set_text_vec(self, tvec):
        super().set_text_vec(tvec)
        self.scores = self.index.score(tvec)
        if self.use_clip_as_gamma:
            if self._calibrator is None:
                probs = self.scores
            else:
                probs = self._calibrator.get_probabilities(tvec, self.index.vectors)
            self.prob_model = self.prob_model.with_gamma(probs)

    def next_batch(self):
        vec_idx, _ = self.prob_model.top_k_remaining(top_k=1)
        return self._emit_vector(int(vec_idx[0]))

    def refine(self, change=None):
        self._apply_change(change)
