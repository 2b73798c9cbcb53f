"""The ranking tail of the fused KnnProp2 round, as one function run eager
or replayed as one CUDA graph.

After a round's Jacobi launch the host enqueues the ranking of the
propagated scores: the exclusion merge, the padded layout and frame max,
the shortlist, the zoom-level augmentation, the final top-k and the packing
of the result for its one host read, some fifty kernels from about a
hundred Python-level ops. Each op gives up the interpreter lock around its
dispatch, and with several server threads each taking it back may wait for
another thread's Python. `rank_tail` is that chain as one function;
`TailGraphs` runs it, on a CUDA index, as one replay of a graph captured at
the first round of its shapes, so the enqueue takes a handful of ops.
"""
from __future__ import annotations

import threading
from typing import NamedTuple

import torch

from ..utils.profiling import annotate
from .frame_scoring import NEG_INF, pack_result, rank_frames_from_scores_incr
from .spmv import DONE, ITERS


def rank_padded(scores, pad_rows, valid, boxes, zoom, excluded, new_excluded_ids, **kw):
    """Ranking tail over exact-layout (N,) scores: into the frame-major
    padded layout (a gather when the index's rows are ragged), invalid rows
    at -inf, then `frame_scoring.rank_frames_from_scores_incr`."""
    s = scores if pad_rows is None else scores[pad_rows]
    s_pad = torch.where(valid.reshape(-1), s, NEG_INF)
    return rank_frames_from_scores_incr(s_pad, valid, boxes, zoom, excluded,
                                        new_excluded_ids, **kw)


def rank_tail(scores, excluded, new_excluded_ids, state, *, pad_rows, valid, boxes, zoom,
              **rank):
    """`rank_padded` over a Jacobi run's scores, packed with the run's step
    count and converged flag from its `state`: returns (the (6k+3,) f64
    buffer that `MultiscaleIndex._read_packed` decodes, the new (F,)
    exclusion mask)."""
    res, excluded = rank_padded(scores, pad_rows, valid, boxes, zoom, excluded,
                                new_excluded_ids, **rank)
    return pack_result(res, state[ITERS], state[DONE] != 0), excluded


def tail_key(scores, excluded, valid, pad_rows, *, shortlist_size, topk, aug_larger,
             aug_weight, agg_method, max_zoom) -> tuple:
    """What a captured tail depends on besides its inputs' values: the
    device, N, F, T, the ranking options and whether the rows are ragged."""
    return (str(scores.device), scores.shape[0], excluded.shape[0], valid.shape[1], topk,
            shortlist_size, aug_larger, aug_weight, agg_method, max_zoom, pad_rows is None)


class _Graph(NamedTuple):
    """A captured tail: its static inputs and outputs and the stream its
    replays go on."""

    graph: torch.cuda.CUDAGraph
    inputs: tuple
    outputs: tuple
    stream: torch.cuda.Stream


class TailGraphs:
    """One index's ranking tails. On a CUDA index each key (`tail_key`) gets
    one graph, shared by every thread, captured at its first round after one
    eager warm-up on a side stream, in a private memory pool and in
    thread-local capture mode, so other threads go on enqueuing meanwhile.
    A round then copies its inputs into the graph's, replays it and clones
    the outputs, under one lock held only across that enqueue: the lock
    and the one stream order every hand-off, so no replay overwrites
    outputs another thread has not cloned. CPU tensors, a caller on another
    stream than the graph's and a key whose capture failed run `rank_tail`
    eagerly. `replays`, `captures` and `eager` count the rounds."""

    def __init__(self, *, pad_rows, valid, boxes, zoom):
        self._arrays = dict(pad_rows=pad_rows, valid=valid, boxes=boxes, zoom=zoom)
        self._lock = threading.Lock()
        self._graphs = {}  # key -> _Graph, or None where the capture failed
        self.replays = self.captures = self.eager = 0

    def __call__(self, scores, excluded, new_excluded_ids, state, **rank):
        """`rank_tail` over these inputs: (packed result, new mask). The
        `prop.rank` span records whether the round replayed a graph
        (`graph`), captured one (`captured`) and waited for the lock
        (`lock_wait_us`)."""
        inputs = (scores, excluded, new_excluded_ids, state)
        with annotate("prop.rank", graph=0, captured=0) as sp:
            if scores.device.type == "cuda":
                key = tail_key(scores, excluded, self._arrays["valid"],
                               self._arrays["pad_rows"], **rank)
                with self._lock:
                    sp.set_elapsed_us("lock_wait_us")
                    if key not in self._graphs:
                        self._graphs[key] = self._capture(inputs, rank)
                        sp.set(captured=int(self._graphs[key] is not None))
                    g = self._graphs[key]
                    if g is not None and torch.cuda.current_stream(scores.device) == g.stream:
                        torch._foreach_copy_(g.inputs, inputs)  # one op, not four, under the lock
                        g.graph.replay()
                        out = tuple(t.clone() for t in g.outputs)
                        self.replays += 1
                        sp.set(graph=1)
                        return out
            with self._lock:
                self.eager += 1
            return rank_tail(*inputs, **self._arrays, **rank)

    def _capture(self, inputs, rank):
        """A graph of `rank_tail` over static copies of `inputs`, or None
        where the capture fails."""
        stream = torch.cuda.current_stream(inputs[0].device)
        static = tuple(t.clone() for t in inputs)
        side = torch.cuda.Stream(inputs[0].device)
        side.wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.stream(side):
                rank_tail(*static, **self._arrays, **rank)  # warm-up
            with torch.cuda.graph(graph, stream=side, capture_error_mode="thread_local"):
                outputs = rank_tail(*static, **self._arrays, **rank)
        except RuntimeError:
            return None
        finally:
            stream.wait_stream(side)
        self.captures += 1
        return _Graph(graph, static, outputs, stream)
