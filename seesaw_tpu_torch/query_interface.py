"""InteractiveQuery: stateful wrapper tracking returned images and labels.

The port's own copy of `seesaw_tpu/query_interface.py`: the index is
stateless; this object owns the `returned` bitmap (the exclusion set) and the
per-session LabelDB, and forwards queries.
"""
from __future__ import annotations

import numpy as np

from .indices.interface import AccessMethod
from .labeldb import LabelDB
from .runtime.bitmap import BitMap


class InteractiveQuery:
    def __init__(self, index: AccessMethod, _y: np.ndarray = None):
        self.index = index
        self.returned = BitMap()  # images handed to the user (not nec. labeled)
        self.label_db = LabelDB()
        if _y is not None:
            from .calibration import GroundTruthCalibrator

            self._calibrator = GroundTruthCalibrator(self.index.vectors, _y)
        else:
            self._calibrator = None

    def get_calibrator(self):
        return self._calibrator

    def query_stateful(self, *args, **kwargs):
        batch_size = kwargs.pop("batch_size")
        res = self.index.query(*args, topk=batch_size, **kwargs, exclude=self.returned)
        self.returned.update(res["dbidxs"])
        return res

    def getXy(self, **options):
        raise NotImplementedError("abstract")
