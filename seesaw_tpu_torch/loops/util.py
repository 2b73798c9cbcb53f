"""Loop helpers: pseudo-labeling.

The port's own copy of `seesaw_tpu/loops/util.py`. The unlabeled sample is
drawn from numpy's global random state, as there, so a session of each
package on the same stream draws the same rows.
"""
from __future__ import annotations

import numpy as np


def makeXy(idx, ranker, sample_size: int, pseudo_label: bool = True):
    """Real labeled vectors + a random sample of unlabeled vectors scored by
    the ranker as soft pseudo-labels. Returns (X, y, is_real)."""
    is_labeled = ranker.is_labeled > 0
    X = idx.vectors[is_labeled]
    y = ranker.labels[is_labeled]
    is_real = np.ones_like(y)

    if pseudo_label:
        unl = ~is_labeled
        vec2 = idx.vectors[unl]
        ylab2 = ranker.current_scores()[unl]
        rsample = np.random.permutation(vec2.shape[0])[:sample_size]
        X = np.concatenate([X, vec2[rsample]])
        y = np.concatenate([y, ylab2[rsample]])
        is_real = np.concatenate([is_real, np.zeros(rsample.shape[0])])
    return X, y, is_real
