"""Label-propagation ranking over the kNN graph.

Counterpart of `seesaw_tpu/loops/knn_methods.py`: normalize and
sigmoid-calibrate the base scores into a prior, and propagate the user's
labels over the graph after each batch that holds a negative.
`SimpleKNNRanker` (the neighbour-vote estimate over the reverse adjacency)
is the JAX package's numpy as it is.

The port's ranker always runs in the JAX package's device mode: the prior,
the labels and the last scores live on the ranker's device, each feedback
round stages its clicks, and the next `MultiscaleIndex.rank_by_scores` runs
click scatter + propagation + ranking as one fused round
(`ops.propagation.DeferredPropagation`). Host mirrors of the labels stay
authoritative for `top_k` and analysis; a host consumer of the scores runs
a staged round eagerly first. A ranker over a `mesh` (`LabelPropagationRanker2
(mesh=)`, row-sharded propagation) does not defer, as in the JAX package:
the staged round runs when its scores are asked for, and the index ranks
the scores it gets.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..knn_graph import KNNGraph, SymmetricWeights
from ..label_propagation import LabelPropagation, check_prior_bounds
from ..ops.propagation import DeferredPropagation, PropagationResult
from ..utils.profiling import annotate, host_sync


def sigmoid(x):
    """1 / (1 + exp(-x)) for numpy arrays or tensors."""
    exp = torch.exp if isinstance(x, torch.Tensor) else np.exp
    return 1.0 / (1.0 + exp(-x))


def normalize_scores(scores, epsilon: float):
    """Affine-map scores into (epsilon, 1-epsilon); all-equal maps to 0.5.
    Numpy arrays or tensors (f32 throughout); a device tensor costs one
    read for the gap check."""
    assert epsilon < 0.5
    lo = scores.min()
    gap = scores.max() - lo
    with host_sync("normalize_scores"):
        gap_h = float(gap)
    if gap_h == 0:
        full = torch.full_like if isinstance(scores, torch.Tensor) else np.full_like
        return full(scores, 0.5)
    x = (scores - lo) / gap
    return x * (1 - 2 * epsilon) + epsilon


class SimpleKNNRanker:
    """Each vertex's score is a pseudo-count average of its own prior and the
    labels of the vertices whose kNN lists name it; labeled vertices score
    their label. Host numpy."""

    def __init__(self, knng: KNNGraph, init_scores: Optional[np.ndarray] = None):
        self.knng = knng
        n = knng.nvecs
        if init_scores is None:
            self.init_numerators = np.ones(n) * 0.1
        else:
            self.set_base_scores(init_scores)
        self.pscount = 1.0
        self.numerators = np.zeros(n)
        self.denominators = np.zeros(n)
        self.labels = np.zeros(n)
        self.is_labeled = np.zeros(n)
        self._rev_indptr, self._rev_src = knng.reverse_adjacency()

    def set_base_scores(self, scores: np.ndarray):
        assert scores.shape[0] == self.knng.nvecs
        self.init_numerators = sigmoid(2 * scores)

    def current_scores(self) -> np.ndarray:
        num = self.pscount * self.init_numerators + self.numerators
        denom = self.pscount + self.denominators
        estimates = num / denom
        return self.labels * self.is_labeled + estimates * (1 - self.is_labeled)

    def update(self, idxs, labels):
        for idx, label in zip(idxs, labels):
            idx, label = int(idx), float(label)
            assert np.isclose(label, 0) or np.isclose(label, 1)
            if self.is_labeled[idx] > 0:
                delta_num = label - self.labels[idx]
                delta_denom = 0
            else:
                delta_num = label
                delta_denom = 1
            self.labels[idx] = label
            self.is_labeled[idx] = 1
            # vertices that list idx among their neighbors
            rev = self._rev_src[self._rev_indptr[idx]: self._rev_indptr[idx + 1]]
            self.numerators[rev] += delta_num
            self.denominators[rev] += delta_denom

    def top_k(self, k: Optional[int], unlabeled_only: bool = True):
        if unlabeled_only:
            subset = np.where(self.is_labeled < 1)[0]
        else:
            subset = np.arange(self.knng.nvecs)
        raw = self.current_scores()
        order = np.argsort(-raw[subset])
        if k is not None:
            order = order[:k]
        top = subset[order]
        return top, raw[top]


class BaseLabelPropagationRanker:
    def __init__(
        self,
        *,
        nvecs: int,
        device,
        normalize_scores: bool,
        sigmoid_before_propagate: bool,
        calib_a: float,
        calib_b: float,
        prior_weight: float,
        normalize_epsilon: Optional[float] = None,
        warm_start: bool = False,
        **_other,
    ):
        self.nvecs = nvecs
        self.device = torch.device(device)
        self.normalize = normalize_scores
        if self.normalize:
            assert normalize_epsilon is not None
            self.epsilon = normalize_epsilon
        self.calib_a = calib_a
        self.calib_b = calib_b
        self.prior_weight = prior_weight
        self.sigmoid_before_propagate = sigmoid_before_propagate
        # opt-in serving optimization: start each round's Jacobi run from the
        # previous round's scores instead of the prior (the reference always
        # starts from the prior). The fixed point is unique for
        # reg_lambda > 0, so only the stopping iterate moves, within about
        # sqrt(epsilon).
        self.warm_start = warm_start
        self.is_labeled = np.zeros(nvecs)  # host mirrors
        self.labels = np.zeros(nvecs)
        self._negatives = 0  # labeled rows whose label is 0
        self.prior_scores: Optional[torch.Tensor] = None  # (N,) on the device
        self._current_scores: Optional[torch.Tensor] = None
        self._labels_dev = None  # device-persistent label state
        self._is_labeled_dev = None
        self._pending: list = []  # (idx, label) staged since the last round
        self._needs_prop = False  # a staged round waits for the next ranking
        # the last propagation (fused or eager): n_iter, converged, host_reads
        self.last_result: Optional[PropagationResult] = None

    def set_base_scores(self, init_scores):
        """Base scores (numpy or a tensor) -> the prior on the ranker's
        device. With labels already given, the next ranking propagates."""
        assert init_scores.shape[0] == self.nvecs
        s = torch.as_tensor(init_scores, dtype=torch.float32).to(self.device)
        if self.normalize:
            s = normalize_scores(s, epsilon=self.epsilon)
        if self.sigmoid_before_propagate:
            s = sigmoid(self.calib_a * (s + self.calib_b))
        self.prior_scores = s
        self._current_scores = s
        self._needs_prop = bool(self.is_labeled.any())

    def _propagation_start(self) -> torch.Tensor:
        """The prior (reference semantics), or the last scores with
        warm_start."""
        if self.warm_start and self._current_scores is not None:
            return self._current_scores
        return self.prior_scores

    def update(self, idxs, labels):
        with annotate("prop.update"):
            for idx, label in zip(idxs, labels):
                idx, label = int(idx), float(label)
                assert np.isclose(label, 0) or np.isclose(label, 1)
                # keep the count of labeled negatives instead of scanning the
                # (N,) mirrors on every click, as the reference does
                if self.is_labeled[idx] > 0 and self.labels[idx] == 0:
                    self._negatives -= 1
                self._negatives += label == 0
                self.labels[idx] = label
                self.is_labeled[idx] = 1
                self._pending.append((idx, label))
        if self._negatives > 0:
            self._needs_prop = True
        # no negatives: scores unchanged (labels still clamp in the next run)

    def _ensure_device_labels(self) -> None:
        """First use of the device label state: all unlabeled. Every click
        so far is still staged (nothing is consumed before this state
        exists), so the round's scatter brings it level with the host
        mirrors without uploading them."""
        if self._labels_dev is None:
            self._labels_dev = torch.zeros(self.nvecs, dtype=torch.float32, device=self.device)
            self._is_labeled_dev = torch.zeros(self.nvecs, dtype=torch.bool, device=self.device)

    def _pending_scatter(self):
        """The staged clicks as (ids int64, vals f32) tensors on the device,
        one entry per row with its last label (a scatter with repeated ids
        has no defined winner). The JAX package pads them to power-of-two
        buckets to bound jit recompiles; eager PyTorch needs no padding."""
        last = dict(self._pending)
        ids = np.fromiter(last.keys(), dtype=np.int64, count=len(last))
        vals = np.fromiter(last.values(), dtype=np.float32, count=len(last))
        with host_sync("upload.clicks"):
            ids_dev = torch.from_numpy(ids).to(self.device)
        with host_sync("upload.clicks"):
            vals_dev = torch.from_numpy(vals).to(self.device)
        return ids_dev, vals_dev

    def _deferred_state(self):
        """(labels, is_labeled, ids, vals) for the fused round: the persistent
        device label state without the staged clicks, which ride into the
        round as a scatter. `_commit_deferred` publishes what it returns."""
        with annotate("prop.stage", clicks=len(self._pending)):
            self._ensure_device_labels()
            return (self._labels_dev, self._is_labeled_dev, *self._pending_scatter())

    def _commit_deferred(self, scores, labels_dev, is_labeled_dev,
                         result: PropagationResult):
        """Publish a fused round: its scores become current, its label state
        replaces the persistent arrays, the staged clicks are consumed."""
        self._labels_dev = labels_dev
        self._is_labeled_dev = is_labeled_dev
        self._pending.clear()
        self._current_scores = scores
        self._needs_prop = False
        self.last_result = result

    def _flush_propagation(self) -> torch.Tensor:
        """Run a staged round eagerly (a host consumer asked for scores).
        Its span records the run's `steps`, `segments` and `converged`."""
        if self._needs_prop:
            with annotate("prop.flush") as sp:
                self._ensure_device_labels()
                if self._pending:
                    ids, vals = self._pending_scatter()
                    self._labels_dev[ids] = vals
                    with host_sync("upload.labeled"):  # a blocking copy of the True
                        self._is_labeled_dev[ids] = True
                    self._pending.clear()
                self._current_scores = self._propagate(self._propagation_start())
                self._needs_prop = False
                r = self.last_result
                sp.set(steps=r.n_iter, segments=r.host_reads, converged=r.converged)
        return self._current_scores

    def _propagate(self, start):
        raise NotImplementedError

    def current_scores(self) -> np.ndarray:
        """Host scores (runs a staged round first), bounds-checked against
        the prior."""
        scores = self._flush_propagation()
        with host_sync("current_scores"):
            cs = scores.cpu().numpy()
        check_prior_bounds(cs, self.prior_scores)
        return cs

    def _defer_available(self) -> bool:
        """Whether a staged round may fuse into the next ranking."""
        return True

    def current_scores_any(self):
        """Scores without a host read: the device tensor, or a
        DeferredPropagation marker when a round is staged (the next
        `rank_by_scores` fuses it; a ranker that does not defer runs the
        round here)."""
        if self._needs_prop:
            if self._defer_available():
                return DeferredPropagation(self)
            return self._flush_propagation()
        return self._current_scores

    def top_k(self, k: Optional[int], unlabeled_only: bool = True):
        if unlabeled_only:
            subset = np.where(self.is_labeled < 1)[0]
        else:
            subset = np.arange(self.nvecs)
        raw = self.current_scores()
        order = np.argsort(-raw[subset])
        if k is not None:
            order = order[:k]
        top = subset[order]
        return top, raw[top]


class LabelPropagationRanker2(BaseLabelPropagationRanker):
    def __init__(self, *, weights: SymmetricWeights, device=None, verbose: int = 0,
                 mesh=None, **other):
        """`mesh`: propagate row-sharded over its devices; the ranker's
        state lives on the mesh's primary device (the default `device`)."""
        if device is None:
            if mesh is None:
                raise ValueError("LabelPropagationRanker2 needs a device or a mesh")
            device = mesh.primary
        super().__init__(nvecs=weights.nvecs, device=device, **other)
        self.weights = weights
        self.lp = LabelPropagation(weights, reg_lambda=self.prior_weight,
                                   device=device, max_iter=300, verbose=verbose,
                                   mesh=mesh)

    def _defer_available(self) -> bool:
        # the fused round runs the one-launch Jacobi segment on one device
        return self.lp.mesh is None

    def _propagate(self, start):
        scores = self.lp.fit_transform_device(
            labels=self._labels_dev, is_labeled=self._is_labeled_dev,
            reg_values=self.prior_scores, start=start)
        self.last_result = self.lp.last_result
        return scores
