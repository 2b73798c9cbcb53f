"""Session: the interactive seesaw loop over the PyTorch index.

The state machine (seen/accepted bitmaps, action log, label diffing,
reversal detection, panel data) is the JAX package's framework-free
`seesaw_tpu.session.Session`; this subclass binds the port's loop registry
and profiler spans, and `make_session` loads the index through the port's
loader onto an explicit device.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from seesaw_tpu import session as _base
from seesaw_tpu.basic_types import BenchParams, SessionParams
from seesaw_tpu.labeldb import LabelDB
from seesaw_tpu.runtime.bitmap import BitMap

from .indices.loader import load_index
from .loops.registry import build_loop_from_params
from .utils.profiling import annotate


class Session(_base.Session):
    # The constructor mirrors `seesaw_tpu/session.py` Session.__init__
    # (lines 34-76) statement for statement, except that the loop comes from
    # the port's registry; tests/test_torch_session.py checks that both set
    # the same instance attributes.
    def __init__(self, gdm, dataset, hdb, params: SessionParams,
                 _y: Optional[np.ndarray] = None):
        self.gdm = gdm
        self.dataset = dataset
        self.acc_indices = []
        self.acc_activations = []
        self.seen = BitMap()
        self.accepted = BitMap()
        self.params = params
        self.init_q = None
        self.timing = []
        self.image_timing = {}
        self.index = hdb
        self.q = hdb.new_query()
        if _y is not None:
            from seesaw_tpu.calibration import GroundTruthCalibrator

            self.q._calibrator = GroundTruthCalibrator(self.index.vectors, _y)

        # prefilled ground-truth labels (annotation-mode sessions)
        self.label_db = LabelDB()
        if self.params.annotation_category is not None:
            box_table = self.dataset.load_ground_truth_boxes(
                self.params.annotation_category
            )
            if len(box_table) == 0:
                print(
                    f"warning: no gt entries for category "
                    f"{self.params.annotation_category!r}"
                )
            self.label_db.fill(box_table)

        self.loop = build_loop_from_params(self.gdm, self.q, params=self.params)
        self.action_log = []
        self._last_change = None
        self._log("init")

    def next(self) -> np.ndarray:
        self._log("next.start")
        start = time.time()
        with annotate("session.next"):
            r = self.loop.next_batch_external()
        delta = time.time() - start
        self.acc_indices.append(np.asarray(r["dbidxs"]))
        self.acc_activations.append(r["activations"])
        self.timing.append(delta)
        self._log("next.end")
        return r["dbidxs"]

    def refine(self):
        self._log("refine.start")
        with annotate("session.refine"):
            self.loop.refine_external(self._last_change)
        self._log("refine.end")


def make_session(gdm, p: SessionParams, b: Optional[BenchParams] = None, *,
                 device) -> dict:
    """Open the dataset named by `p`, load its index onto `device` and start
    a Session (counterpart of `seesaw_tpu.session.make_session`)."""
    ds = gdm.get_dataset(p.index_spec.d_name)
    idx = load_index(ds.index_path(p.index_spec.i_name), device=device,
                     options=p.index_options)
    if p.index_spec.c_name is not None:
        ds = ds.load_subset(p.index_spec.c_name)
        idx = idx.subset(BitMap(ds.dbidxs))
    _y = None
    if p.pass_ground_truth:
        _y = np.asarray(ds.load_qgt()[b.ground_truth_category])[idx.meta.dbidx]
    session = Session(gdm, ds, idx, p, _y=_y)
    return {"session": session, "dataset": ds}
