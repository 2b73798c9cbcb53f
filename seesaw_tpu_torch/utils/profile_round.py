"""Where the time of a serving round goes, by a `torch.profiler` trace.

    python -m seesaw_tpu_torch.utils.profile_round [--rounds 8]

Builds the deployment-shaped index of `utils.rounds` (10M x 512 bf16 by
default) and, for `rocchio_update` and `log_reg2`, runs a two-round warm-up
session, an untraced session of `--rounds` rounds (host-clock round and
`next` times, LBFGS host syncs of each fit) and then a session of as many
rounds under `torch.profiler`. The traced session gives, per
round, the device's busy time (union of kernel and copy intervals), the
fused kernel's and the radix sort's time, the kernel count and the host
time of each named span; tracing thousands of small launches slows the
host, so the idle share is taken against the untraced session's rounds:
1 - traced busy / untraced wall. One JSON line per loop; the profiler
tables go to `--out`. On the CPU (`--device cpu`, a small `--n-vectors`) it
runs the same rounds and reports the host spans only.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import rounds as R
from .profiling import card_line

SPANS = ("session.next", "round.label", "round.update_state", "round.refine")
_ANNOTATIONS = frozenset(SPANS) | {"session.refine"}
BATCH, SHORTLIST, SEED = 3, 50, 0  # bench.py bench_session_rounds


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, -np.inf
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def device_breakdown(events) -> dict:
    """Busy time, kernel count and the fused scan's and the sort's time from
    the trace's device events."""
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name not in _ANNOTATIONS  # span ranges, not device work
           and not getattr(e, "is_user_annotation", False)]
    if not dev:
        return {}

    def ms(pred):
        return sum(e.time_range.elapsed_us() for e in dev if pred(e.name)) / 1e3

    return dict(
        busy_ms=_busy_us([(e.time_range.start, e.time_range.end) for e in dev]) / 1e3,
        device_ops=len(dev),
        kernels=sum(1 for e in dev if not e.name.startswith(("Memcpy", "Memset"))),
        k1_ms=ms(lambda n: "frame_max_kernel" in n),
        sort_ms=ms(lambda n: "RadixSort" in n),
        copy_ms=ms(lambda n: n.startswith(("Memcpy", "Memset"))),
    )


def profile_loop(idx, method, args, rng, tag):
    from torch.profiler import ProfilerActivity, profile

    params = R.session_params(method, batch_size=BATCH, shortlist_size=SHORTLIST)
    R.drive_session(idx, params, 2, rng)  # warm-up: allocator, kernel build, cuBLAS
    next_ms, round_ms, syncs = R.drive_session(idx, params, args.rounds, rng)
    acts = [ProfilerActivity.CPU]
    if idx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, acc_events=True) as prof:
        t0 = time.perf_counter()
        R.drive_session(idx, params, args.rounds, rng)
        traced_ms = (time.perf_counter() - t0) * 1e3
    n = args.rounds
    spans = {}
    for k in prof.key_averages():  # a span also shows as a device range
        if k.key in SPANS:
            spans[k.key] = max(spans.get(k.key, 0.0), k.cpu_time_total / 1e3 / n)
    rec = dict(loop=method, rounds=n, round_ms=round_ms, next_ms=next_ms,
               lbfgs_host_syncs=syncs, traced_wall_ms=traced_ms,
               host_span_ms_per_round=spans)
    dev = device_breakdown(prof.events())
    if dev:
        rec.update({f"{k}_per_round": v / n for k, v in dev.items()})
        rec["idle_share"] = 1.0 - dev["busy_ms"] / sum(round_ms)
        rec["k1_share_of_busy"] = dev["k1_ms"] / dev["busy_ms"]
    elif idx.device.type == "cuda":
        raise RuntimeError("the trace holds no device events")
    print(f"[{tag}] {json.dumps(rec)}", flush=True)
    sort_by = "self_cuda_time_total" if dev else "self_cpu_time_total"
    return rec, (f"== {method}, {n} traced rounds, by {sort_by}\n"
                 + prof.key_averages().table(sort_by=sort_by, row_limit=40)
                 + f"\n== {method}, by self_cpu_time_total\n"
                 + prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-vectors", type=int, default=10_000_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--out", default="chiprun_out/profile_round.txt")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        tag = card_line()
    else:
        tag = "cpu"
    print(tag, flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rng = np.random.default_rng(SEED)
    idx = R.device_index(args.n_vectors, args.dim, "bfloat16", device=dev, generator=gen)
    tables = []
    for method in ("rocchio_update", "log_reg2"):
        tables.append(profile_loop(idx, method, args, rng, tag)[1])
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(f"{tag}\n\n" + "\n\n".join(tables) + "\n")
    print(f"profiler tables: {out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
