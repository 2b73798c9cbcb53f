"""Session: the interactive seesaw loop state machine over the PyTorch index.

Counterpart of `seesaw_tpu/session.py`, self-contained: it owns the
seen/accepted bitmaps, the action log and the per-round timing, diffs the
client's state into (dbidx, label) changes, detects reversals and drives the
loop's refine/next. The loop comes from the port's registry, and
`make_session` loads the index through the port's loader onto an explicit
device. The numeric work happens in the loop's device programs.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np

from .basic_types import (
    ActivationData,
    BenchParams,
    Box,
    Imdata,
    LogEntry,
    SessionParams,
    SessionState,
    is_image_accepted,
)
from .indices.interface import AccessMethod
from .indices.loader import load_index
from .labeldb import LabelDB
from .loops.registry import build_loop_from_params
from .query_interface import InteractiveQuery
from .runtime.bitmap import BitMap
from .utils.profiling import annotate


class Session:
    def __init__(
        self,
        gdm,
        dataset,
        hdb: AccessMethod,
        params: SessionParams,
        _y: Optional[np.ndarray] = None,
    ):
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
        self.q: InteractiveQuery = hdb.new_query()
        if _y is not None:
            from .calibration import GroundTruthCalibrator

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

    # -- bookkeeping ---------------------------------------------------------
    def get_totals(self):
        return {"seen": len(self.seen), "accepted": len(self.accepted)}

    def get_method_stats(self):
        return self.loop.get_stats()

    def _log(self, message: str):
        self.action_log.append(
            {
                "logger": "server",
                "time": time.time(),
                "message": message,
                "seen": len(self.seen),
                "accepted": len(self.accepted),
            }
        )

    # -- the loop ------------------------------------------------------------
    def next(self) -> np.ndarray:
        with annotate("session.next"):
            self._log("next.start")
            start = time.time()
            r = self.loop.next_batch_external()
            delta = time.time() - start
            self.acc_indices.append(np.asarray(r["dbidxs"]))
            self.acc_activations.append(r["activations"])
            self.timing.append(delta)
            self._log("next.end")
        return r["dbidxs"]

    def set_text(self, key: str):
        with annotate("session.set_text"):
            self._log("set_text")
            self.init_q = key
            self.loop.state.curr_str = key
            vec = self.index.string2vec(string=key)
            self.loop.set_text_vec(vec)

    def update_state(self, state: SessionState):
        with annotate("session.update_state"):
            self._update_labeldb(state)
            self._log("update_state.end")
            if self._check_reversals():
                self.loop.set_reversals()

    def _check_reversals(self) -> bool:
        """A reversal: some rejected image followed by an accepted one, in
        presentation order."""
        if len(self.accepted) == 0 or len(self.accepted) == len(self.seen):
            return False
        min_so_far = 1
        for batch in self.acc_indices:
            for idx in batch:
                idx = int(idx)
                if idx not in self.accepted:
                    min_so_far = 0
                elif min_so_far == 0:
                    return True
        return False

    def refine(self):
        with annotate("session.refine"):
            self._log("refine.start")
            self.loop.refine_external(self._last_change)
            self._log("refine.end")

    # -- state (de)serialization --------------------------------------------
    def get_state(self) -> SessionState:
        gdata = []
        for i, (indices, accs) in enumerate(
            zip(self.acc_indices, self.acc_activations)
        ):
            prefill = (
                self.params.annotation_category is not None
                and i == len(self.acc_indices) - 1
            )
            gdata.append(
                self.get_panel_data(
                    idxbatch=indices, activation_batch=accs, prefill=prefill
                )
            )
        return SessionState(
            params=self.params,
            gdata=gdata,
            timing=self.timing,
            reference_categories=[],
            query_string=self.loop.state.curr_str,
            action_log=[LogEntry(**e) for e in self.action_log],
        )

    def get_panel_data(self, *, idxbatch, activation_batch=None, prefill=False):
        reslabs = []
        urls = self.dataset.get_urls(idxbatch)
        for i, (url, dbidx) in enumerate(zip(urls, idxbatch)):
            dbidx = int(dbidx)
            if prefill:
                boxes = self.label_db.get(dbidx, format="box")
            else:
                boxes = self.q.label_db.get(dbidx, format="box")

            if not activation_batch:
                activations = None
            else:
                act = activation_batch[i]
                acts = act if isinstance(act, list) else [act]
                activations = [
                    ActivationData(
                        box=Box(x1=a["x1"], y1=a["y1"], x2=a["x2"], y2=a["y2"]),
                        score=a["score"],
                    )
                    for a in acts
                ]
            reslabs.append(
                Imdata(
                    url=url,
                    dbidx=dbidx,
                    boxes=boxes,
                    activations=activations,
                    timing=self.image_timing.get(dbidx, []),
                )
            )
        return reslabs

    def _update_labeldb(self, state: SessionState):
        self.action_log = [
            e.model_dump() if isinstance(e, LogEntry) else e for e in state.action_log
        ]
        old_accepted = self.accepted.copy()
        old_seen = self.seen.copy()
        self.accepted.clear()
        self.seen.clear()
        for ldata in state.gdata:
            for imdata in ldata:
                self.image_timing[imdata.dbidx] = imdata.timing
                self.seen.add(imdata.dbidx)
                if is_image_accepted(imdata):
                    self.accepted.add(imdata.dbidx)
                self.q.label_db.put(imdata.dbidx, imdata.boxes)

        delta_accepted = self.accepted - old_accepted
        delta_seen = self.seen - old_seen
        changed = delta_seen.union(delta_accepted)
        self._last_change = [
            (int(idx), 1 if int(idx) in delta_accepted else 0) for idx in changed
        ]


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
