"""The traced run: a `torch.profiler` trace of the window, reduced to the
device's busy time, its operations by name, the idle gaps by what the host
was doing, and each kernel with the operator that launched it.

The window is marked by a `loadbench.window` annotation that the main
thread holds from the window's opening to its close. A kernel is tied to
the PyTorch operator that launched it where the profiler links them (a
kernel launched through `ctypes`, as K1 and `jacobi_step` are, has none).
An idle gap of the card is put down to the `loadbench.*` annotation
(`load.py`) that most user threads hold at its middle. The card's own
copies of annotations are no device work and are left out.
"""
from __future__ import annotations

import re
from collections import Counter
from dataclasses import dataclass, field

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

WINDOW = "loadbench.window"
PREFIX = "loadbench."


@dataclass
class Kernel:
    name: str
    seconds: float
    op: str | None  # the operator that launched it, where recorded


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernels: list = field(default_factory=list)  # Kernel, in the window
    device_ops: list = field(default_factory=list)  # [name, seconds], top 10
    idle_gaps: list = field(default_factory=list)  # [host span, seconds], top 10


def short_name(name: str) -> str:
    """A kernel's name without its argument list and return type, at most
    96 characters."""
    name = re.sub(r"^void ", "", name)
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            cut = i
            break
    return name[:cut][:96]


def start():
    """A started profiler over the host and the card, recording every
    thread's operators where this PyTorch can."""
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    try:
        cfg = torch.profiler._ExperimentalConfig(profile_all_threads=True)
        prof = profile(activities=acts, experimental_config=cfg)
    except (TypeError, AttributeError):
        prof = profile(activities=acts)
    prof.start()
    return prof


def _is_annotation(e) -> bool:
    """Whether an event is a user annotation (on the host, or its copy on
    the card's timeline), not an operator, a runtime call or device work."""
    flag = getattr(e, "is_user_annotation", None)
    if flag is not None:
        return bool(flag())
    name = e.name()
    return "(" not in name and "::" not in name and not name.startswith(("Memcpy", "Memset"))


def _union(intervals):
    """Merged (start, end) intervals, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _open_span_at(times, spans):
    """For each time (sorted ascending), the name of the span (name, start,
    end) open on the most threads then ("host idle" when none is)."""
    edges = []
    for name, t0, t1 in spans:
        edges.append((t0, 1, name))
        edges.append((t1, -1, name))
    edges.sort()
    active = Counter()
    out, i = [], 0
    for t in times:
        while i < len(edges) and edges[i][0] <= t:
            _, d, name = edges[i]
            active[name] += d
            i += 1
        live = [(c, n) for n, c in active.items() if c > 0]
        out.append(max(live, key=lambda x: (x[0], x[1]))[1] if live else "host idle")
    return out


def reduce(prof) -> TraceSummary:
    """Reduce a stopped profiler."""
    events = prof.profiler.kineto_results.events()
    window = [e for e in events if e.name() == WINDOW and e.device_type() != DeviceType.CUDA]
    if not window:
        raise RuntimeError("the trace has no window annotation")
    w0, w1 = window[0].start_ns(), window[0].end_ns()

    ops, device, spans = {}, [], []
    for e in events:
        if e.device_type() == DeviceType.CUDA:
            if not _is_annotation(e):
                device.append(e)
            continue
        ops[e.correlation_id()] = e
        if e.name().startswith(PREFIX) and e.name() != WINDOW:
            spans.append((e.name(), e.start_ns(), e.end_ns()))

    kernels, intervals, by_name = [], [], Counter()
    for e in device:
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        intervals.append((s, t))
        sec = (t - s) / 1e9
        by_name[short_name(e.name())] += sec
        op = ops.get(e.linked_correlation_id())
        kernels.append(Kernel(e.name(), sec, op.name() if op is not None else None))
    merged = _union(intervals)
    busy = sum(e - s for s, e in merged) / 1e9
    bounds = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(bounds[0::2], bounds[1::2]) if b > a]
    mids = [(a + b) // 2 for a, b in gaps]
    order = sorted(range(len(gaps)), key=lambda i: mids[i])
    names = _open_span_at([mids[i] for i in order], spans)
    idle = Counter()
    for i, name in zip(order, names):
        idle[name] += (gaps[i][1] - gaps[i][0]) / 1e9
    return TraceSummary(
        window_s=(w1 - w0) / 1e9, busy_s=busy, kernels=kernels,
        device_ops=[[n, s] for n, s in by_name.most_common(10)],
        idle_gaps=[[n, s] for n, s in idle.most_common(10)],
    )
