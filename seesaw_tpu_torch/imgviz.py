"""Image visualization helpers: boxes, activations, session montages.

Role of the reference's plotnine/ggplot notebook helpers
(the reference's `seesaw/imgviz.py:25-110`) without the plotnine/tensorflow
dependency stack: plain PIL drawing — ground-truth/feedback boxes,
activation overlays with scores, and a session montage (accept/reject
borders, newest batch first) for debugging saved sessions.

The port's own copy of `seesaw_tpu/imgviz.py` (PIL and numpy only).
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import PIL.Image
import PIL.ImageDraw

ACCEPT = (65, 195, 99)
REJECT = (217, 83, 79)
ACTIVATION = (255, 211, 77)
BOX = (45, 108, 223)


def _to_pil(image) -> PIL.Image.Image:
    if isinstance(image, PIL.Image.Image):
        return image.convert("RGB")
    return PIL.Image.fromarray(np.asarray(image)).convert("RGB")


def draw_boxes(image, boxes, *, color=BOX, width: int = 3,
               labels: Optional[Sequence[str]] = None) -> PIL.Image.Image:
    """Copy of the image with [x1,y1,x2,y2] rectangles (optional labels)."""
    im = _to_pil(image).copy()
    d = PIL.ImageDraw.Draw(im)
    for i, b in enumerate(np.asarray(boxes, dtype=np.float64).reshape(-1, 4)):
        d.rectangle(list(b), outline=color, width=width)
        if labels is not None and labels[i]:
            d.text((b[0] + 2, max(b[1] - 12, 0)), str(labels[i]), fill=color)
    return im


def draw_activations(image, activations, *, width: int = 3) -> PIL.Image.Image:
    """Overlay activation boxes with their scores (the query result's
    'activations' entries: dicts with x1..y2 and score)."""
    im = _to_pil(image).copy()
    d = PIL.ImageDraw.Draw(im)
    for a in activations or []:
        box = [a["x1"], a["y1"], a["x2"], a["y2"]]
        d.rectangle(box, outline=ACTIVATION, width=width)
        d.text((box[0] + 2, max(box[1] - 12, 0)), f"{a.get('score', 0):.3f}",
               fill=ACTIVATION)
    return im


def draw_imdata(image, imdata) -> PIL.Image.Image:
    """One session entry: feedback boxes (green/red by acceptance) +
    activation overlays. `imdata` is a basic_types.Imdata or its dict."""
    get = (lambda k: getattr(imdata, k, None)) if not isinstance(imdata, dict) \
        else (lambda k: imdata.get(k))
    im = _to_pil(image)
    boxes = get("boxes")
    accepted = bool(boxes) and any(
        (b.get("marked_accepted") if isinstance(b, dict) else b.marked_accepted)
        for b in boxes
    )
    if get("activations"):
        acts = [
            a if isinstance(a, dict) else
            dict(x1=a.box.x1, y1=a.box.y1, x2=a.box.x2, y2=a.box.y2, score=a.score)
            for a in get("activations")
        ]
        im = draw_activations(im, acts)
    if boxes:
        arr = np.array([
            [b["x1"], b["y1"], b["x2"], b["y2"]] if isinstance(b, dict)
            else [b.x1, b.y1, b.x2, b.y2] for b in boxes
        ])
        im = draw_boxes(im, arr, color=ACCEPT if accepted else BOX)
    border = ACCEPT if accepted else (REJECT if boxes == [] else (60, 60, 60))
    out = PIL.Image.new("RGB", (im.width + 8, im.height + 8), border)
    out.paste(im, (4, 4))
    return out


def montage(images: List[PIL.Image.Image], cols: int = 4,
            cell: int = 224, pad: int = 6,
            background=(17, 17, 17)) -> PIL.Image.Image:
    """Grid montage of already-rendered cells (row-major)."""
    n = len(images)
    cols = max(1, min(cols, n))
    rows = math.ceil(n / cols)
    out = PIL.Image.new(
        "RGB",
        (cols * (cell + pad) + pad, rows * (cell + pad) + pad),
        background,
    )
    for i, im in enumerate(images):
        im = _to_pil(im).copy()
        im.thumbnail((cell, cell))
        r, c = divmod(i, cols)
        out.paste(im, (pad + c * (cell + pad), pad + r * (cell + pad)))
    return out


def session_montage(state, file_path_fn, cols: int = 4,
                    newest_first: bool = True) -> PIL.Image.Image:
    """Render a SessionState's gdata as one annotated grid: every seen image
    with its feedback boxes and activations (debugging saved sessions)."""
    cells = []
    batches = list(state.gdata)
    if newest_first:
        batches = batches[::-1]
    for batch in batches:
        for imdata in batch:
            img = PIL.Image.open(file_path_fn(imdata.dbidx))
            cells.append(draw_imdata(img, imdata))
    return montage(cells, cols=cols)
