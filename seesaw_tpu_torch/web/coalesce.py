"""Request coalescing: concurrent sessions share one device scan.

Counterpart of `seesaw_tpu/web/coalesce.py`. The scan over the embedding
matrix is bound by the memory rate, and an (N, D) @ (D, Q) product reads
the matrix once for Q queries (`ops.frame_scoring.query_program_batch`), so
Q concurrent sessions cost little more than one. The coalescer makes that
transparent: `query()` calls from server threads that arrive within a small
window and share their static parameters run as one batched call, and each
caller gets the result its solo query would have given (up to the order of
the scan's sums; `tests/test_torch_batch_query.py`).

Leader election, no background thread: the first thread to open a
(topk, shortlist, aug...) group sleeps the window, drains the group and
executes it; followers wait on their event. Over a mesh-sharded index the
batch is one `parallel.sharded_index.sharded_query_batch_program`: each
shard's (Ns, D) @ (D, Q) product, the per-query cutoffs and the merge, and
each session's per-shard masks are committed back. The mesh stays in one
process: an index over a mesh that spans processes raises, as sessions
arrive in one server process and a process mesh needs every process to
make the same calls.
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np
import torch

from ..ops import frame_scoring
from ..parallel.mesh import require_in_process
from ..parallel.sharded_index import sharded_query_batch_program


class _Req:
    __slots__ = ("vector", "exclude", "result", "error", "event")

    def __init__(self, vector, exclude):
        self.vector = vector
        self.exclude = exclude
        self.result = None
        self.error = None
        self.event = threading.Event()


class QueryCoalescer:
    def __init__(self, index, window_ms: float = 3.0, max_batch: int = 16):
        require_in_process(getattr(index, "mesh", None), "the query coalescer")
        self.index = index
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._groups: dict = {}
        self.stats = {"batched": 0, "solo": 0, "dispatches": 0}

    def _count(self, key: str, n: int = 1):
        with self._lock:
            self.stats[key] += n

    def query(
        self,
        *,
        vector,
        vector2=None,
        topk: int,
        shortlist_size: Optional[int] = None,
        exclude=None,
        agg_method: str = "avg_score",
        aug_larger: str = "all",
        aug_weight: str = "level_max",
        **kwargs,
    ) -> dict:
        idx = self.index
        # kwargs beyond the no-op parity params are not part of the group
        # key, so a batched run could not honor them: such requests, second
        # (discount) vectors and deferred vectors (resolved inside the solo
        # query on the device) take the solo path
        extra = {k for k in kwargs if k not in ("force_exact", "rescore_method")}
        if (
            vector2 is not None or extra
            or isinstance(vector, frame_scoring.DeferredVector)
        ):
            return idx.query(
                vector=vector, vector2=vector2, topk=topk,
                shortlist_size=shortlist_size, exclude=exclude,
                agg_method=agg_method, aug_larger=aug_larger,
                aug_weight=aug_weight, **kwargs,
            )

        key = (topk, shortlist_size, agg_method, aug_larger, aug_weight)
        me = _Req(vector, exclude)
        with self._lock:
            group = self._groups.setdefault(key, [])
            group.append(me)
            leader = len(group) == 1
        if leader:
            time.sleep(self.window)
            with self._lock:
                batch = self._groups.pop(key, [me])
            self._execute(batch, key)
        else:
            # window + dispatch + generous device headroom
            me.event.wait(timeout=60.0)
            if not me.event.is_set():  # pragma: no cover - watchdog fallback
                return idx.query(
                    vector=vector, topk=topk, shortlist_size=shortlist_size,
                    exclude=exclude, agg_method=agg_method,
                    aug_larger=aug_larger, aug_weight=aug_weight,
                )
        if me.error is not None:
            raise me.error
        return me.result

    # ------------------------------------------------------------------ #
    def _execute(self, batch, key):
        topk, shortlist_size, agg_method, aug_larger, aug_weight = key
        idx = self.index
        try:
            if len(batch) == 1:
                self._count("solo")
                batch[0].result = idx.query(
                    vector=batch[0].vector, topk=topk,
                    shortlist_size=shortlist_size, exclude=batch[0].exclude,
                    agg_method=agg_method, aug_larger=aug_larger,
                    aug_weight=aug_weight,
                )
                return

            self._count("dispatches")
            # oversize groups run in chunks of max_batch
            for lo in range(0, len(batch), self.max_batch):
                chunk = batch[lo: lo + self.max_batch]
                self._count("batched", len(chunk))
                self._run_chunk(chunk, topk, shortlist_size, agg_method,
                                aug_larger, aug_weight)
        except Exception as e:
            for r in batch:
                r.error = e
        finally:
            for r in batch:
                r.event.set()

    def _run_chunk(self, chunk, topk, shortlist_size, agg_method,
                   aug_larger, aug_weight):
        idx = self.index
        if shortlist_size is None or shortlist_size < topk:
            shortlist_size = max(topk * 5, shortlist_size or 0)
        rank = dict(
            shortlist_size=min(shortlist_size, idx.n_frames),
            topk=min(topk, idx.n_frames), aug_larger=aug_larger,
            aug_weight=aug_weight, agg_method=agg_method, max_zoom=idx._max_zoom,
        )
        qs = torch.from_numpy(np.stack([
            np.asarray(r.vector, np.float32).reshape(-1) for r in chunk
        ])).to(idx.device)
        # each session's mask stays on the device across clicks; only the
        # click's newly excluded frame ordinals ride in
        excl = [idx._device_exclusion(r.exclude) for r in chunk]
        new_ids = torch.stack([ni for _, ni, _ in excl])  # (Q, M)
        if idx._sharded is not None:
            # each shard's (Q, Fs) stack of the sessions' masks
            masks = [torch.stack(parts) for parts in zip(*(m for m, _, _ in excl))]
            res, new_masks = sharded_query_batch_program(idx._sharded, qs, masks, new_ids,
                                                         **rank)
            results = idx._format_results(res)
            for i, r in enumerate(chunk):
                idx._commit_exclusion(excl[i][2], [m[i].clone() for m in new_masks])
                r.result = results[i]
            return
        masks = torch.stack([m for m, _, _ in excl])  # (Q, F), a new tensor
        if idx._frame_scale is not None:
            # int8 with per-frame scales: the tile max over the integer dots
            res, new_masks = frame_scoring.query_program_batch_framescale_incr(
                idx._V, idx._valid, idx._boxes, idx._zoom, qs, masks, new_ids,
                idx._frame_scale, **rank,
            )
        else:
            res, new_masks = frame_scoring.query_program_batch_incr(
                idx._V, idx._valid, idx._boxes, idx._zoom, qs, masks, new_ids,
                idx._row_scale, **rank,
            )
        results = idx._format_results(res)
        for i, r in enumerate(chunk):
            # a row of its own: no session's mask may share the stacked
            # tensor's storage with another's
            idx._commit_exclusion(excl[i][2], new_masks[i].clone())
            r.result = results[i]


class CoalescingIndex:
    """Index proxy routing `query` through a QueryCoalescer.

    Sessions made over this wrapper coalesce their per-click re-ranks;
    everything else goes to the inner index. Enabled by
    `index_options={"coalesce_ms": 3}` (`MultiscaleIndex.from_path`)."""

    def __init__(self, inner, window_ms: float = 3.0, max_batch: int = 16):
        self._inner = inner
        self._coalescer = QueryCoalescer(inner, window_ms=window_ms,
                                         max_batch=max_batch)

    def query(self, **kwargs) -> dict:
        return self._coalescer.query(**kwargs)

    def new_query(self):
        from ..indices.multiscale import BoxFeedbackQuery

        return BoxFeedbackQuery(self)

    def __getattr__(self, name):
        return getattr(self._inner, name)
