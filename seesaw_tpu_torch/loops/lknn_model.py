"""L-KNN probability model for active search.

The port's own copy of `seesaw_tpu/loops/lknn_model.py` (numpy, over the
port's `runtime.bitmap`). score_i = (numerator_i + gamma_i) /
(denominator_i + 1) over the fixed-degree padded graph, where labeling a
vertex adds (y, 1) to every neighbour's (numerator, denominator).
Conditioning is functional (`condition`, a new model for the tree-search
planners) or in place (`condition_`). Top-k queries mask seen vertices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from ..runtime.bitmap import BitMap, FrozenBitMap


@dataclass
class Dataset:
    """Immutable-ish labeled-set tracker (reference `common.py:6-47`)."""

    idx2label: Dict[int, int]
    seen_indices: BitMap
    all_indices: FrozenBitMap
    vectors: Optional[np.ndarray] = None

    @staticmethod
    def from_vectors(vectors) -> "Dataset":
        n = len(vectors)
        return Dataset({}, BitMap(), FrozenBitMap(range(n)), vectors)

    @staticmethod
    def from_labels(idxs, labels, vectors) -> "Dataset":
        return Dataset(
            dict(zip(map(int, idxs), map(int, labels))),
            BitMap(idxs),
            FrozenBitMap(range(len(vectors))),
            vectors,
        )

    def with_label(self, i: int, y: int) -> "Dataset":
        assert i in self.all_indices
        new_labels = dict(self.idx2label)
        new_labels[int(i)] = int(y)
        new_seen = self.seen_indices.copy()
        new_seen.add(int(i))
        return Dataset(new_labels, new_seen, self.all_indices, self.vectors)

    def get_labels(self) -> Tuple[np.ndarray, np.ndarray]:
        idxs = self.seen_indices.to_array().astype(np.int64)
        labs = np.array([self.idx2label[int(i)] for i in idxs])
        return idxs, labs

    def remaining_indices(self) -> BitMap:
        return BitMap(self.all_indices.to_array()) - self.seen_indices


def initial_gamma_array(gamma: float, n: int) -> np.ndarray:
    """Near-constant gamma with tiny jitter for tie-breaking (reference
    `LKNN_model.py:71-73`)."""
    rnd = np.random.default_rng(seed=0)
    return rnd.normal(loc=gamma, scale=1e-6, size=n)


class LKNNModel:
    def __init__(
        self,
        dataset: Dataset,
        *,
        gamma: np.ndarray,
        nbr: np.ndarray,  # (N, Kp) int32, -1 = padding
        numerators: np.ndarray,
        denominators: np.ndarray,
        copy_on_condition: bool = True,
    ):
        self.dataset = dataset
        self.nbr = nbr
        self.gamma = np.asarray(gamma, dtype=np.float64)
        assert self.gamma.shape[0] == nbr.shape[0]
        assert ((0 < self.gamma) & (self.gamma < 1)).all(), (
            "gamma must lie strictly in (0,1) — calibrate scores first"
        )
        self.numerators = numerators
        self.denominators = denominators
        self.copy_on_condition = copy_on_condition

    @staticmethod
    def from_dataset(dataset: Dataset, *, nbr: np.ndarray, gamma: np.ndarray) -> "LKNNModel":
        n = nbr.shape[0]
        return LKNNModel(
            dataset,
            gamma=gamma,
            nbr=nbr,
            numerators=np.zeros(n),
            denominators=np.zeros(n),
        )

    # -- scores ------------------------------------------------------------
    def scores(self) -> np.ndarray:
        return (self.numerators + self.gamma) / (self.denominators + 1.0)

    def predict_proba(self, idxs: np.ndarray) -> np.ndarray:
        return self.scores()[np.asarray(idxs, dtype=np.int64)]

    def _masked_scores(self) -> np.ndarray:
        s = self.scores()
        seen = self.dataset.seen_indices.to_array()
        if seen.size:
            s[seen.astype(np.int64)] = -np.inf
        return s

    def top_k_remaining(self, top_k: int) -> Tuple[np.ndarray, np.ndarray]:
        s = self._masked_scores()
        k = min(top_k, s.shape[0])
        part = np.argpartition(-s, k - 1)[:k]
        order = part[np.argsort(-s[part])]
        return order, s[order]

    def probability_bound(self, n: int) -> float:
        """Upper bound on any remaining score after n more positives."""
        idxs = self.dataset.remaining_indices().to_array().astype(np.int64)
        bounds = (self.gamma[idxs] + n + self.numerators[idxs]) / (
            1.0 + n + self.denominators[idxs]
        )
        return float(np.max(bounds))

    # -- conditioning ------------------------------------------------------
    def _deltas(self, idx: int, y: int) -> Tuple[float, float]:
        curr = self.dataset.idx2label.get(int(idx))
        if curr is None:
            return float(y), 1.0
        return float(y - curr), 0.0

    def _neighbors(self, idx: int) -> np.ndarray:
        row = self.nbr[int(idx)]
        return row[row >= 0].astype(np.int64)

    def condition(self, idx: int, y: int) -> "LKNNModel":
        """Functional conditioning (planner branches)."""
        dn, dd = self._deltas(idx, y)
        nb = self._neighbors(idx)
        num = self.numerators.copy()
        den = self.denominators.copy()
        num[nb] += dn
        den[nb] += dd
        return LKNNModel(
            self.dataset.with_label(idx, y),
            gamma=self.gamma,
            nbr=self.nbr,
            numerators=num,
            denominators=den,
        )

    def condition_(self, idx: int, y: int):
        """In-place conditioning (session updates)."""
        dn, dd = self._deltas(idx, y)
        nb = self._neighbors(idx)
        self.numerators[nb] += dn
        self.denominators[nb] += dd
        self.dataset = self.dataset.with_label(idx, y)

    def with_gamma(self, new_gamma: np.ndarray) -> "LKNNModel":
        return LKNNModel(
            self.dataset,
            gamma=new_gamma,
            nbr=self.nbr,
            numerators=self.numerators,
            denominators=self.denominators,
        )
