"""Box geometry the port calls: pairwise IoU and the per-box best IoU that
label -> tile matching uses. The port's own copy of those functions of
`seesaw_tpu/box_utils.py` (numpy). Boxes are (x1, y1, x2, y2) with
x2 >= x1, y2 >= y1, in pixels.
"""
from __future__ import annotations

import numpy as np


def box_area(b: np.ndarray) -> np.ndarray:
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def pairwise_intersection(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """(N,M) intersection areas between two box sets."""
    lt = np.maximum(b1[:, None, :2], b2[None, :, :2])
    rb = np.minimum(b1[:, None, 2:], b2[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    return wh[..., 0] * wh[..., 1]


def box_iou(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """Pairwise IoU between two (K,4) box arrays."""
    inter = pairwise_intersection(b1, b2)
    union = box_area(b1)[:, None] + box_area(b2)[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(union > 0, inter / np.where(union > 0, union, 1.0), 0.0)


def max_iou_per_left(b1: np.ndarray, b2: np.ndarray) -> np.ndarray:
    """For every box in b1, the maximum IoU against any box in b2 (0 if b2
    is empty)."""
    if b2 is None or len(b2) == 0:
        return np.zeros(b1.shape[0])
    return box_iou(b1, b2).max(axis=1)
