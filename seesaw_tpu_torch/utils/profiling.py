"""Device profiling hooks (counterpart of `seesaw_tpu/utils/profiling.py`)
on `torch.profiler`, the program's spans, the card line that every device
measurement is written beside, and the two clocks of the card's
measurements: CUDA events and the device time torch.profiler records.

`device_trace(dir)` records a `torch.profiler` trace (the host's ops, and
the card's kernels and copies when a card is present) into `dir` as a
Chrome trace (`trace.json`, for chrome://tracing or Perfetto), tolerates
nested use and records wall time.

`annotate(name, **attrs)` opens a span. Spans record exactly while a
`torch.profiler` trace runs (`device_trace`, or any `profile` started in
the process); otherwise `annotate` hands back one shared no-op that reads
no clock and builds no RecordFunction. A recording span opens
`torch.profiler.record_function(name)`, so it lies on the trace's timeline
beside the kernels launched inside it, and on closing appends a
`SpanRecord` to a bounded in-memory buffer that `spans(t0, t1)` reads.
`host_sync(site)` is the span around a call that waits for the card, and
`kernel_launch(name)` the span around a hand-written kernel's launch.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import NamedTuple

import torch
import torch.autograd.profiler as _autograd_profiler
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


_active = False


@contextlib.contextmanager
def device_trace(trace_dir: str | os.PathLike):
    """Write a torch.profiler trace to `trace_dir/trace.json`, and the wall
    seconds to `trace_dir/trace_meta.txt`. Re-entrant: inner uses are no-ops
    (yielding None) while a trace is active."""
    global _active
    if _active:
        yield None
        return
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    _active = True
    t0 = time.perf_counter()
    try:
        with profile(activities=activities) as prof:
            yield trace_dir
            if torch.cuda.is_available():
                torch.cuda.synchronize()
        prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))
    finally:
        _active = False
        dt = time.perf_counter() - t0
        (Path(trace_dir) / "trace_meta.txt").write_text(f"wall_seconds={dt:.3f}\n")


class SpanRecord(NamedTuple):
    name: str
    id: int
    parent: int | None  # the enclosing span on this thread
    request: int  # the id of this thread's outermost open span
    thread: int
    t0: int  # time.perf_counter_ns()
    t1: int
    cpu0: int  # time.thread_time_ns()
    cpu1: int
    attrs: dict


class SpanBuffer:
    """The newest `capacity` records, in the order they closed; `dropped`
    counts the older ones pushed out."""

    def __init__(self, capacity: int = 1 << 20):
        self._records = collections.deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dropped = 0

    def append(self, record: SpanRecord) -> None:
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(record)

    def between(self, t0: int | None = None, t1: int | None = None) -> list:
        """The records whose end lies in [t0, t1] (perf_counter ns)."""
        with self._lock:
            records = list(self._records)
        return [r for r in records
                if (t0 is None or r.t1 >= t0) and (t1 is None or r.t1 <= t1)]


_BUFFER = SpanBuffer()
_ids = itertools.count(1)


class _OpenSpans(threading.local):
    def __init__(self):
        self.stack = []


_open = _OpenSpans()


class _Off:
    """The span handed out while no trace runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass

    def set_elapsed_us(self, attr: str):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("name", "attrs", "op", "id", "parent", "request", "t0", "cpu0", "_rf", "_op")

    def __init__(self, name: str, attrs: dict, op: bool = False):
        self.name, self.attrs, self.op = name, attrs, op

    def set(self, **attrs):
        """Add counts to the span's record."""
        self.attrs.update(attrs)

    def set_elapsed_us(self, attr: str):
        """Record under `attr` the microseconds since the span opened."""
        self.attrs[attr] = (time.perf_counter_ns() - self.t0) / 1e3

    def __enter__(self):
        stack = _open.stack
        self.id = next(_ids)
        if stack:
            self.parent, self.request = stack[-1].id, stack[-1].request
        else:
            self.parent, self.request = None, self.id
        stack.append(self)
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        if self.op:
            self._op = torch._C._profiler._RecordFunctionFast(self.name)
            self._op.__enter__()
        self.cpu0 = time.thread_time_ns()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        cpu1 = time.thread_time_ns()
        if self.op:
            self._op.__exit__(*exc)
        self._rf.__exit__(*exc)
        _open.stack.pop()
        _BUFFER.append(SpanRecord(self.name, self.id, self.parent, self.request,
                                  threading.get_ident(), self.t0, t1, self.cpu0, cpu1,
                                  self.attrs))
        return False


def annotate(name: str, **attrs):
    """A span named `name` carrying the counts `attrs`: recorded while a
    `torch.profiler` trace runs, the shared no-op otherwise."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs)


def host_sync(site: str):
    """The span around one call at `site` that makes the host wait for the
    card: a read from the device, or an upload from pageable host memory
    (a blocking copy to the card synchronizes its stream first); the
    uploads' sites start with `upload.`."""
    return annotate("host.sync", site=site)


def kernel_launch(name: str, **attrs):
    """The span around a launch of a hand-written kernel through ctypes.
    Besides the user annotation it opens an operator record, the kind the
    profiler ties the kernels launched inside it to (it ties none to a
    user annotation), so the trace names the kernel's operator `name`."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, attrs, op=True)


def spans(t0: int | None = None, t1: int | None = None) -> list:
    """The recorded spans (`SpanRecord`) that ended in [t0, t1]
    (perf_counter ns), oldest first."""
    return _BUFFER.between(t0, t1)


def dropped_spans() -> int:
    """Spans the full buffer has pushed out so far."""
    return _BUFFER.dropped


def card_line() -> str:
    """The card's name and power limit, as `nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader` prints them for the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, args_list) -> float:
    """Mean ms per call over the argument list, by CUDA events."""
    fn(*args_list[0])  # warm-up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for args in args_list:
        fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / len(args_list)


def profiled_ms(run, calls: int):
    """Device ms per call of `run()`, which makes `calls` calls: the summed
    durations of the device's kernels and copies under torch.profiler, so
    the host's launches are left out. None where the profiler saw no
    device activity (not measured)."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    return us / 1e3 / calls if us > 0 else None


def device_ms(fn, args_list):
    """Mean device ms per call over the argument list (`profiled_ms`),
    after one warm-up call."""
    fn(*args_list[0])
    torch.cuda.synchronize()
    return profiled_ms(lambda: [fn(*args) for args in args_list], len(args_list))
