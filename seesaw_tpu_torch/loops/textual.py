"""Textual feedback loop: refine with the users' box descriptions.

Counterpart of `seesaw_tpu/loops/textual.py`. Gathers the labeled boxes'
best-matching tile vectors together with their description strings, then
updates the OnlineModel (per-string linear scorers, or fine-tuning of the
text projection) on the session's device and re-ranks:

- linear mode: the target string's probability for every tile of the
  database, computed on the device, feeds the ranking tail
  (`rank_by_scores`);
- finetune mode: the tuned target-string vector drives the standard query.
"""
from __future__ import annotations

import numpy as np

from ..box_utils import box_iou
from ..models.online_model import OnlineModel
from .loop_base import LoopBase


def join_vecs2annotations(index, dbidx: int, annotations):
    """For each annotation box: the best-IoU tile's vector, the box's
    description and accept mark, and that IoU. Returns (vectors,
    descriptions, accepted, best_iou)."""
    data = index.get_data(dbidx)
    ann_boxes = np.array([(b.x1, b.y1, b.x2, b.y2) for b in annotations], dtype=np.float32)
    ious = box_iou(ann_boxes, data["boxes"])  # (A, T)
    best_tile = np.argmax(ious, axis=1)
    best_iou = np.max(ious, axis=1)
    vecs = data["vectors"][best_tile]
    descs = np.array([b.description or "" for b in annotations], dtype=object)
    accepted = np.array([bool(b.marked_accepted) for b in annotations])
    return vecs, descs, accepted, best_iou


def compute_box_vectors(index, dataset, dbidx: int, annotations, *, min_side=64):
    """'computed' image_vector_strategy: embed a square crop around each
    labeled box with the index's CLIP model; `best_square_box` picks the
    maximal-overlap near-centered square within the image."""
    import PIL.Image

    from ..box_utils import BoundingBoxBatch, BoxBatch

    im = PIL.Image.open(dataset.file_path(dbidx))
    if im.mode != "RGB":
        im = im.convert("RGB")
    w, h = im.size
    boxes = np.array([(b.x1, b.y1, min(b.x2, w), min(b.y2, h)) for b in annotations],
                     dtype=np.float64)
    bb = BoundingBoxBatch.from_boxbatch(BoxBatch.from_xyxy(boxes), w, h)
    squares = bb.best_square_box(min_side=min_side).to_xyxy()
    vecs = []
    for (x1, y1, x2, y2) in squares:
        crop = im.crop((round(x1), round(y1), round(x2), round(y2)))
        vecs.append(index.embedding.from_image(image=crop)[0])
    descs = np.array([b.description or "" for b in annotations], dtype=object)
    accepted = np.array([bool(b.marked_accepted) for b in annotations])
    return np.stack(vecs), descs, accepted


class TextualFeedback(LoopBase):
    def __init__(self, gdm, q, params):
        super().__init__(gdm, q, params)
        cfg = dict(params.interactive_options or {})
        self.model = OnlineModel(self.index.embedding, cfg, device=self.index.device)
        self.vector_box_min_iou = cfg.get("vector_box_min_iou", 0.0)
        self.mode = cfg["mode"]
        self.image_vector_strategy = params.image_vector_strategy or "matched"
        self._dataset = None  # needed for 'computed' crops
        if self.image_vector_strategy == "computed" and gdm is not None:
            self._dataset = gdm.get_dataset(params.index_spec.d_name)
        self._updated = False

    @staticmethod
    def from_params(gdm, q, params):
        return TextualFeedback(gdm, q, params)

    def set_text_vec(self, tvec):
        super().set_text_vec(tvec)
        self.model.reset()
        self._updated = False

    def next_batch(self):
        p = self.params
        if self.mode == "linear" and self._updated:
            scores = self.model.score_vecs(self.index.vectors_f32())
            res = self.index.rank_by_scores(
                scores,
                topk=p.batch_size,
                shortlist_size=p.shortlist_size,
                exclude=self.q.returned,
                agg_method=p.agg_method,
                aug_larger=p.aug_larger,
                aug_weight=p.aug_weight or "level_max",
            )
            self.q.returned.update(res["dbidxs"])
            return res
        if self.mode == "finetune" and self._updated:
            vec = self.model.encode_string(self.state.curr_str)
        else:
            vec = self.curr_qvec
        return self._next_batch_curr_vec(np.asarray(vec).reshape(-1))

    def refine(self, change=None):
        vecs, strs, acc = [], [], []
        for dbidx in self.q.label_db.get_seen():
            annot = self.q.label_db.get(int(dbidx), format="box")
            if not annot:
                continue
            if self.image_vector_strategy == "computed" and self._dataset is not None:
                v, d, a = compute_box_vectors(self.index, self._dataset, int(dbidx), annot)
                vecs.append(v)
                strs.append(d)
                acc.append(a)
                continue
            v, d, a, iou = join_vecs2annotations(self.index, int(dbidx), annot)
            keep = iou > self.vector_box_min_iou
            if keep.any():
                vecs.append(v[keep])
                strs.append(d[keep])
                acc.append(a[keep])
        if not vecs:
            return
        self.model.update(np.concatenate(vecs), np.concatenate(acc),
                          np.concatenate(strs), self.state.curr_str)
        self._updated = True
