"""Device profiling hooks (counterpart of `seesaw_tpu/utils/profiling.py`)
on `torch.profiler`, the card line that every device measurement is written
beside, and the two clocks of the card's measurements: CUDA events and the
device time torch.profiler records.

`device_trace(dir)` records a `torch.profiler` trace (the host's ops, and
the card's kernels and copies when a card is present) into `dir` as a
Chrome trace (`trace.json`, for chrome://tracing or Perfetto), tolerates
nested use and records wall time; `annotate(name)` puts a named span into
it; `maybe_trace_from_env` traces when SEESAW_PROFILE_DIR names a
directory.
"""
from __future__ import annotations

import contextlib
import os
import subprocess
import time
from pathlib import Path

import torch
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


@contextlib.contextmanager
def maybe_trace_from_env(var: str = "SEESAW_PROFILE_DIR"):
    """Trace if the env var names a directory; plain no-op otherwise."""
    d = os.environ.get(var)
    if not d:
        yield None
        return
    with device_trace(d) as out:
        yield out


def annotate(name: str):
    """Named span inside a `torch.profiler` trace (a cheap no-op outside
    one)."""
    return torch.profiler.record_function(name)


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
