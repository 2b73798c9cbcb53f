"""Named spans for the PyTorch profiler (counterpart of
`seesaw_tpu/utils/profiling.py::annotate`), the card line that every
device measurement is written beside, and the two clocks of the card's
measurements: CUDA events and the device time torch.profiler records."""
from __future__ import annotations

import subprocess

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile


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
