"""Per-session label store: dbidx -> list of labeled boxes.

The port's own copy of `seesaw_tpu/labeldb.py`. An entry of ``None`` means
the image was seen but not labeled (negative when read in binary form);
``[]`` means explicitly no boxes. Array accessors return struct-of-array
views for label matching.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from .basic_types import Box
from .runtime.bitmap import BitMap


@dataclass
class BoxTable:
    """Columnar view over labeled boxes across images."""

    dbidx: np.ndarray  # (E,) int32
    boxes: np.ndarray  # (E,4) float32 [x1,y1,x2,y2]
    description: List[Optional[str]] = field(default_factory=list)
    marked_accepted: np.ndarray = field(
        default_factory=lambda: np.zeros(0, dtype=bool)
    )

    def __len__(self):
        return self.dbidx.shape[0]

    def for_dbidx(self, dbidx: int) -> np.ndarray:
        return self.boxes[self.dbidx == dbidx]

    @staticmethod
    def empty() -> "BoxTable":
        return BoxTable(
            dbidx=np.zeros(0, dtype=np.int32),
            boxes=np.zeros((0, 4), dtype=np.float32),
            description=[],
            marked_accepted=np.zeros(0, dtype=bool),
        )


class LabelDB:
    def __init__(self):
        self.ldata: Dict[int, Optional[List[Box]]] = {}

    def get_seen(self) -> BitMap:
        return BitMap(self.ldata.keys())

    def put(self, dbidx: int, boxes: Optional[List[Box]]):
        self.ldata[int(dbidx)] = boxes

    def fill(self, box_table: BoxTable):
        """Bulk-load ground-truth boxes, marking them accepted (reference
        `labeldb.py:15-21` — used to prefill annotation sessions)."""
        for dbidx in np.unique(box_table.dbidx):
            rows = np.where(box_table.dbidx == dbidx)[0]
            boxes = [
                Box(
                    x1=float(box_table.boxes[i, 0]),
                    y1=float(box_table.boxes[i, 1]),
                    x2=float(box_table.boxes[i, 2]),
                    y2=float(box_table.boxes[i, 3]),
                    description=(
                        box_table.description[i] if box_table.description else None
                    ),
                    marked_accepted=True,
                )
                for i in rows
            ]
            self.put(int(dbidx), boxes)

    def get_box_table(self, accepted_only: bool = False,
                      target_description: Optional[str] = None) -> BoxTable:
        """All labeled boxes as columns. ``None``/``[]`` entries contribute
        nothing. Optionally filter to accepted boxes or a description."""
        dbidxs, rows, descs, accs = [], [], [], []
        for dbidx, boxes in self.ldata.items():
            if not boxes:
                continue
            for b in boxes:
                if accepted_only and not b.marked_accepted:
                    continue
                if target_description is not None and b.description != target_description:
                    continue
                dbidxs.append(dbidx)
                rows.append((b.x1, b.y1, b.x2, b.y2))
                descs.append(b.description)
                accs.append(b.marked_accepted)
        if not rows:
            return BoxTable.empty()
        return BoxTable(
            dbidx=np.array(dbidxs, dtype=np.int32),
            boxes=np.array(rows, dtype=np.float32),
            description=descs,
            marked_accepted=np.array(accs, dtype=bool),
        )

    def get(self, dbidx: int, format: str = "box"):
        """``None`` -> never seen. Seen-but-unlabeled is treated as negative
        (empty) for 'array'/'binary' formats, matching reference
        `labeldb.py:52-56`."""
        dbidx = int(dbidx)
        if dbidx not in self.ldata:
            return None
        boxes = self.ldata[dbidx]
        if format == "box":
            return boxes
        if boxes is None:
            boxes = []
        if format == "array":
            if not boxes:
                return np.zeros((0, 4), dtype=np.float32)
            return np.array(
                [(b.x1, b.y1, b.x2, b.y2) for b in boxes], dtype=np.float32
            )
        if format == "binary":
            return 1 if len(boxes) > 0 else 0
        raise ValueError(f"unknown format {format!r}")
