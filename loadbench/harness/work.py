"""The device work the window's clicks needed, counted by the benchmark from
the program's counters and its own clicks, and its least time on the chip
(`roofline.py`).

- A solo scan (K1, `fused_frame_max.launches`) reads the index once.
- A batch of the coalescer (`QueryCoalescer.stats`: dispatches and the
  queries they carried) reads the index once and writes its scores.
- A `knn_prop2` session's round 0 scans the index once for its prior.
- A Jacobi step reads the symmetric graph and the row vectors once
  (`roofline.jacobi_step_bytes`).
"""
from __future__ import annotations

import torch

from . import roofline


def index_dtype(inputs) -> str:
    return "int8" if inputs.V.dtype == torch.int8 else "bfloat16"


def stored_edges(graph_raw) -> int:
    """Entries of the symmetric graph the raw lists make: every pair either
    row lists, once, in both directions, no self edges."""
    dst, _ = graph_raw
    n, k = dst.shape
    src = torch.arange(n, device=dst.device).repeat_interleave(k)
    d = dst.reshape(-1).to(torch.int64)
    keep = src != d
    key = torch.minimum(src, d)[keep] * n + torch.maximum(src, d)[keep]
    return 2 * int(torch.unique(key).numel())


def scan_seconds(run, solo: int, batches: int, batched_queries: int) -> float:
    """Least seconds of `solo` single-query scans and `batches` batch scans
    carrying `batched_queries` queries in all."""
    inp = run.inputs
    ib, dt = inp.index_bytes(), index_dtype(inp)
    least = solo * roofline.least_seconds(*roofline.scan_work(ib, inp.n, inp.dim, 1, dt))
    if batches:
        b, f, _ = roofline.scan_work(ib, inp.n, inp.dim, batched_queries, dt)
        least += roofline.least_seconds(b + (batches - 1) * ib, f, dt)
    return least


def prior_scans(run) -> int:
    """`knn_prop2` rounds 0 finished in the window: each scanned the index."""
    if run.cell.method != "knn_prop2":
        return 0
    return sum(1 for c in run.window_clicks() if c.k == 0)


def jacobi_steps(run) -> int:
    return sum(c.steps for c in run.clicks if c.steps is not None and run.in_window(c.t_next))


def jacobi_seconds(run, steps: int) -> float:
    if not steps:
        return 0.0
    if "edges" not in run.extra:
        run.extra["edges"] = stored_edges(run.graph_raw)
    return steps * roofline.least_seconds(
        roofline.jacobi_step_bytes(run.inputs.n, run.extra["edges"]))


def window_least_seconds(run) -> float:
    """Least seconds of all the device work the window's clicks needed."""
    solo = run.delta("k1_launches") or 0
    batches = run.delta("coalesce.dispatches") or 0
    queries = run.delta("coalesce.batched") or 0
    return (scan_seconds(run, solo + prior_scans(run), batches, queries)
            + jacobi_seconds(run, jacobi_steps(run)))
