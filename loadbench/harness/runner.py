"""One run of a cell: set up, measure the window, read the metrics, judge.

Set-up makes the index (and the graph, where the configuration has one) on
the device from the seed, hands it to the port, warms the shapes the cell's
traffic uses and starts the users; the window opens once they are warm.
After the window the program's state is dropped, the metrics are read, and
the reference judges what the window's sessions were shown.
"""
from __future__ import annotations

import gc
import importlib.util
import os
import shutil
import sys
import tempfile
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import inputs as inp
from . import judge, stats, trace
from .cell import BENCH_DIR, Cell
from .load import Load, QueryEmbedding

FORBIDDEN = ("jax", "jaxlib", "flax", "seesaw_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's, flax's or the JAX
    package's, compared as whole names."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


@dataclass
class RunView:
    """What a metric's reader reads: the window, every click, the
    program's counters over the window, the trace, the inputs' sizes."""
    cell: Cell
    setup_s: float
    t_open: float
    t_close: float
    clicks: list
    counters: dict  # name -> (value at the opening, value at the close)
    inputs: inp.IndexInputs
    graph_raw: tuple | None
    trace: trace.TraceSummary | None = None
    extra: dict = field(default_factory=dict)

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open

    def in_window(self, t: float) -> bool:
        return self.t_open <= t <= self.t_close

    def window_clicks(self):
        return [c for c in self.clicks if self.in_window(c.t_end)]

    def window_next_ms(self):
        return [c.next_ms for c in self.clicks if self.in_window(c.t_next)]

    def delta(self, name: str):
        a, b = self.counters.get(name, (None, None))
        return None if a is None or b is None else b - a


def read_metric(name: str, view: RunView):
    """The value `loadbench/metrics/<name>.py` reads, or None."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"loadbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(view)


def _counters(served):
    from seesaw_tpu_torch.ops import fused_scoring, spmv

    out = {"k1_launches": fused_scoring.fused_frame_max.launches,
           "jacobi_launches": spmv.jacobi_step.launches}
    co = getattr(served, "_coalescer", None)
    if co is not None:
        with co._lock:
            out.update({f"coalesce.{k}": v for k, v in co.stats.items()})
    return out


def _session_params(cell: Cell):
    from seesaw_tpu_torch.basic_types import IndexSpec, SessionParams

    s = cell.config["session"]
    return SessionParams(
        index_spec=IndexSpec(d_name="loadbench", i_name=cell.config["name"]),
        interactive=cell.method, batch_size=int(s["batch_size"]),
        shortlist_size=int(s["shortlist_size"]), agg_method=s["agg_method"],
        aug_larger=s["aug_larger"], aug_weight=s["aug_weight"],
        start_policy=s["start_policy"],
        interactive_options=dict(cell.config["methods"][cell.method]),
    )


def warm_batches(idx, params, max_batch: int, dim: int):
    """Run the coalescer's batch program once at every batch size the
    traffic can form (1 to `max_batch` queries), through a coalescer of
    its own whose window is long enough to gather each group."""
    from seesaw_tpu_torch.web.coalesce import CoalescingIndex

    co = CoalescingIndex(idx, window_ms=50.0, max_batch=max_batch)
    rng = np.random.default_rng(0)
    for q in range(1, max_batch + 1):
        vecs = rng.normal(size=(q, dim)).astype(np.float32)
        threads = [threading.Thread(target=co.query, kwargs=dict(
            vector=v, topk=params.batch_size, shortlist_size=params.shortlist_size,
            agg_method=params.agg_method, aug_larger=params.aug_larger,
            aug_weight=params.aug_weight)) for v in vecs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    if idx.device.type == "cuda":
        torch.cuda.synchronize(idx.device)


def run(cell: Cell, *, seed: int, seconds: float, traced: bool, device, t_start: float,
        log=print, control: str | None = None):
    """One run. Returns (result dict for the last line, numbers compared).
    With `control` (a precision of `reference.py`) the numbers compared also
    hold, under `control`, the control's readings on the same sessions."""
    from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex
    from seesaw_tpu_torch.loops.graph_based import get_weights_from_index
    from seesaw_tpu_torch.web.coalesce import CoalescingIndex

    cfg, traffic = cell.config, cell.traffic
    dev = torch.device(device)
    workdir = tempfile.mkdtemp(prefix="loadbench-")  # under TMPDIR
    try:
        # -- set-up --------------------------------------------------------
        index_inputs = inp.IndexInputs(cfg, seed, dev)
        idx = MultiscaleIndex.from_device_arrays(
            embedding=QueryEmbedding(seed, index_inputs.dim), V=index_inputs.V,
            valid=index_inputs.valid, boxes=index_inputs.boxes, zoom=index_inputs.zoom,
            meta=inp.vector_meta(index_inputs), row_scale=index_inputs.row_scale,
            path=workdir)
        graph_raw, graph_s = None, 0.0
        mo = cfg["methods"][cell.method].get("matrix_options")
        if mo is not None:
            # the graph file stands for the one a deployment already has: its
            # making and writing are the benchmark's, and not in setup_s
            t_graph = time.perf_counter()
            dst, dist = inp.knn_graph(index_inputs.n, cfg["graph"], int(mo["knn_k"]), seed,
                                      dev)
            nbytes = inp.write_forward_parquet(idx.get_knng_path(mo["knn_path"]),
                                               dst.cpu().numpy(), dist.cpu().numpy())
            graph_s = time.perf_counter() - t_graph
            log(f"graph file: {nbytes} bytes, made and written in {graph_s:.3f} s")
            graph_raw = (dst, dist)
            # the loop's own lookup (`KnnProp2.from_params`), made once here so
            # that the users share its cached weights
            t_read = time.perf_counter()
            weights = get_weights_from_index(idx, mo)
            slots = weights.device_arrays(idx.device)[0].shape[1]
            del weights
            log(f"the program read and symmetrised the graph in "
                f"{time.perf_counter() - t_read:.3f} s, {slots} slots a row")
        params = _session_params(cell)
        served = idx
        if traffic.get("coalesce_ms"):
            served = CoalescingIndex(idx, window_ms=float(traffic["coalesce_ms"]),
                                     max_batch=int(traffic["max_batch"]))
            warm_batches(idx, params, int(traffic["max_batch"]), index_inputs.dim)
        load = Load(served, params, seed=seed, traffic=traffic, cell_config=cfg)
        load.start()
        load.warm(int(traffic["warm_clicks"]), float(traffic["warm_seconds"]))
        if load.errors:
            raise load.errors[0]
        # -- the window ----------------------------------------------------
        prof = trace.start() if traced else None
        with torch.profiler.record_function(trace.WINDOW):
            t_open = time.perf_counter()
            before = _counters(served)
            cpu0 = sum(os.times()[:2])
            time.sleep(max(0.0, t_open + seconds - time.perf_counter()))
            t_close = time.perf_counter()
            cpu1 = sum(os.times()[:2])
            after = _counters(served)
        load.finish()
        if prof is not None:
            prof.stop()
        log(f"this process kept {(cpu1 - cpu0) / (t_close - t_open):.3f} of "
            f"{os.cpu_count()} CPUs busy over the window")
        found = forbidden_modules()
        if found:
            raise ImportError(f"modules of JAX or the JAX package were loaded: {found}")
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
        summary = trace.reduce(prof) if prof is not None else None
        del prof
        if summary is not None:
            with_op = sum(k.seconds for k in summary.kernels if k.op)
            log(f"trace: {len(summary.kernels)} device ops, {with_op:.4f} s of them tied to "
                f"an operator")
        log(f"set-up: {t_open - t_start:.3f} s, of which the graph file "
            f"{graph_s:.3f} s (not in setup_s)")
        view = RunView(cell=cell, setup_s=t_open - t_start - graph_s, t_open=t_open,
                       t_close=t_close, clicks=load.clicks(),
                       counters={k: (before.get(k), after.get(k)) for k in after},
                       inputs=index_inputs, graph_raw=graph_raw, trace=summary)
        metrics = {}
        for m in (cell.per_layer if traced else cell.end_to_end):
            v = read_metric(m["name"], view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        attempted = len(view.window_clicks()) + len(load.errors)
        log("clicks completed in each 5 s of the window: "
            f"{stats.slices([c.t_end for c in view.window_clicks()], t_open, t_close, 5.0)}")
        nexts = view.window_next_ms()
        log(f"window: {attempted} clicks, {len(nexts)} nexts, next p50 "
            f"{stats.percentile(nexts, 50)} p95 {stats.percentile(nexts, 95)} ms")
        # -- the program's state goes; the reference judges -----------------
        sessions, errors = load.sessions, list(load.errors)
        del load, served, idx
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        values = judge.readings(cfg, traffic, seed, index_inputs, graph_raw, sessions,
                                (t_open, t_close))
        if control is not None:
            values["control"] = judge.readings(cfg, traffic, seed, index_inputs, graph_raw,
                                               sessions, (t_open, t_close), control)
        correct, checks = judge.verdict(values, cell.limits)
        correct = correct and not errors
        result = {"correct": bool(correct), "attempted": attempted, "failed": len(errors),
                  "metrics": metrics, "device": _device(dev, peak, summary)}
        if summary is not None:
            result["breakdown"] = {"device_ops": summary.device_ops,
                                   "idle_gaps": summary.idle_gaps}
        result["checks"] = checks
        return result, values
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _device(dev, peak, summary) -> dict:
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
               "memory_peak_bytes": int(peak)}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if summary is not None:
        out["busy_s"] = summary.busy_s
        out["window_s"] = summary.window_s
    return out
