"""Box geometry the port calls: pairwise IoU and the per-box best IoU that
label -> tile matching uses, and the segment / box batches whose
`best_square_box` cuts the square crops of the textual loop's `computed`
image-vector strategy. The port's own copy of those parts of
`seesaw_tpu/box_utils.py` (numpy; the notebook HTML views are left out).
Boxes are (x1, y1, x2, y2) with x2 >= x1, y2 >= y1, in pixels.
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


class Segment:
    """Batch of 1-D segments as (middle, radius) pairs: vectorized interval
    arithmetic for box cropping."""

    def __init__(self, middle: np.ndarray, radius: np.ndarray):
        self.middle = np.asarray(middle, dtype=np.float64)
        self.radius = np.asarray(radius, dtype=np.float64)

    @staticmethod
    def from_x1x2(*, x1x2: np.ndarray = None, x1=None, x2=None) -> "Segment":
        if x1x2 is not None:
            x1, x2 = x1x2[:, 0], x1x2[:, 1]
        x1, x2 = np.asarray(x1, np.float64), np.asarray(x2, np.float64)
        if not (x1 <= x2).all():
            raise ValueError("segment with x1 > x2")
        return Segment((x1 + x2) / 2, (x2 - x1) / 2)

    @staticmethod
    def from_midrad(mid, rad) -> "Segment":
        rad = np.asarray(rad, np.float64)
        if not (rad >= 0).all():
            raise ValueError("segment with a negative radius")
        return Segment(mid, rad)

    def to_x1x2(self) -> np.ndarray:
        return np.stack([self.x1(), self.x2()], axis=1)

    def mid(self):
        return self.middle

    def rad(self):
        return self.radius

    def x1(self):
        return self.middle - self.radius

    def x2(self):
        return self.middle + self.radius

    def num_segments(self) -> int:
        return self.middle.shape[0]

    def length(self) -> np.ndarray:
        return 2 * self.radius

    def clip(self, minx, maxx) -> "Segment":
        minx, maxx = np.asarray(minx, np.float64), np.asarray(maxx, np.float64)
        return Segment.from_x1x2(
            x1=np.clip(self.x1(), minx, maxx), x2=np.clip(self.x2(), minx, maxx)
        )

    def intersection(self, other: "Segment") -> "Segment":
        if self.num_segments() != other.num_segments():
            raise ValueError("segment batches differ in length")
        x1 = np.maximum(self.x1(), other.x1())
        x2 = np.minimum(self.x2(), other.x2())
        return Segment.from_x1x2(x1=np.minimum(x1, x2), x2=x2)

    def fits(self, minx=None, maxx=None) -> bool:
        ok = np.ones(self.num_segments(), dtype=bool)
        if minx is not None:
            ok &= self.x1() >= np.asarray(minx) - 1e-9
        if maxx is not None:
            ok &= self.x2() <= np.asarray(maxx) + 1e-9
        return bool(ok.all())

    def pad(self, padding, minx, maxx) -> "Segment":
        padding = np.asarray(padding, np.float64)
        if not (padding >= 0).all():
            raise ValueError("negative padding")
        return Segment.from_midrad(self.mid(), self.rad() + padding).clip(minx, maxx)

    def best_seg(self, new_len, minx, maxx) -> "Segment":
        """New segment of the target length inside [minx, maxx] with maximal
        overlap, centered as close to the original middle as bounds allow."""
        minx, maxx = np.asarray(minx, np.float64), np.asarray(maxx, np.float64)
        if not (maxx >= minx).all() or not self.fits(minx, maxx):
            raise ValueError("segments outside their bounds")
        new_len = np.minimum(np.asarray(new_len, np.float64), maxx - minx)
        raw = Segment.from_midrad(self.mid(), new_len / 2.0)
        left_excess = np.clip(minx - raw.x1(), 0, None)
        right_excess = np.clip(raw.x2() - maxx, 0, None)
        shifted = Segment.from_midrad(
            mid=raw.mid() + left_excess - right_excess, rad=raw.rad()
        )
        return shifted.clip(minx, maxx)


class BoxBatch:
    """Batch of axis-aligned boxes as an (x-segment, y-segment) pair."""

    def __init__(self, xseg: Segment, yseg: Segment):
        self.xseg = xseg
        self.yseg = yseg

    @staticmethod
    def from_xyxy(xyxy: np.ndarray) -> "BoxBatch":
        xyxy = np.asarray(xyxy, np.float64)
        return BoxBatch(
            Segment.from_x1x2(x1=xyxy[:, 0], x2=xyxy[:, 2]),
            Segment.from_x1x2(x1=xyxy[:, 1], x2=xyxy[:, 3]),
        )

    def to_xyxy(self) -> np.ndarray:
        return np.stack([self.x1(), self.y1(), self.x2(), self.y2()], axis=1)

    def x1(self):
        return self.xseg.x1()

    def x2(self):
        return self.xseg.x2()

    def y1(self):
        return self.yseg.x1()

    def y2(self):
        return self.yseg.x2()

    def width(self):
        return self.xseg.length()

    def height(self):
        return self.yseg.length()

    def area(self):
        return self.width() * self.height()

    def intersection(self, other: "BoxBatch") -> "BoxBatch":
        return BoxBatch(
            self.xseg.intersection(other.xseg), self.yseg.intersection(other.yseg)
        )

    def pad(self, padding, xmax, ymax) -> "BoxBatch":
        return BoxBatch(
            self.xseg.pad(padding, 0, xmax), self.yseg.pad(padding, 0, ymax)
        )

    def best_square_box(self, xmax=np.inf, ymax=np.inf, min_side=0) -> "BoxBatch":
        """Square crop within bounds with maximal overlap, near-centered."""
        xmax, ymax = np.asarray(xmax, np.float64), np.asarray(ymax, np.float64)
        min_side = np.asarray(min_side, np.float64)
        max_container = np.minimum(xmax, ymax)
        box_side = np.maximum(self.height(), self.width())
        target = np.maximum(
            np.minimum(box_side, max_container), np.minimum(min_side, max_container)
        )
        return BoxBatch(
            self.xseg.best_seg(target, minx=0, maxx=xmax),
            self.yseg.best_seg(target, minx=0, maxx=ymax),
        )


class BoundingBoxBatch(BoxBatch):
    """BoxBatch bound to image dimensions."""

    def __init__(self, xseg, yseg, im_width, im_height):
        super().__init__(xseg, yseg)
        self.im_width = np.asarray(im_width, np.float64)
        self.im_height = np.asarray(im_height, np.float64)

    @staticmethod
    def from_boxbatch(bx: BoxBatch, im_width, im_height) -> "BoundingBoxBatch":
        return BoundingBoxBatch(bx.xseg, bx.yseg, im_width, im_height)

    def pad(self, padding) -> "BoundingBoxBatch":
        bbx = super().pad(padding, xmax=self.im_width, ymax=self.im_height)
        return BoundingBoxBatch.from_boxbatch(bbx, self.im_width, self.im_height)

    def best_square_box(self, min_side=0) -> "BoundingBoxBatch":
        bb = super().best_square_box(
            xmax=self.im_width, ymax=self.im_height, min_side=min_side
        )
        return BoundingBoxBatch(bb.xseg, bb.yseg, self.im_width, self.im_height)
