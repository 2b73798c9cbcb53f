"""Percent of the scan's roofline: the least time of the window's scans
(the index read once a launch, `harness/work.py`) over the traced device
time of the scan's kernels: K1 (`frame_max_kernel`) for a solo query and
the product of a coalesced batch (the kernels its `aten::mm` or
`aten::_int_mm` launched; no other path of these mixes calls either)."""
from loadbench.harness import roofline, work

BATCH_OPS = ("aten::mm", "aten::_int_mm")


def read(run):
    if run.trace is None:
        return None
    solo_s = batch_s = 0.0
    solo = 0
    for k in run.trace.kernels:
        if "frame_max_kernel" in k.name:
            solo_s += k.seconds
            solo += 1
        elif k.op in BATCH_OPS:
            batch_s += k.seconds
    least, measured = work.scan_seconds(run, solo, 0, 0), solo_s
    batches = run.delta("coalesce.dispatches") or 0
    if batches and batch_s > 0:
        least += work.scan_seconds(run, 0, batches, run.delta("coalesce.batched"))
        measured += batch_s
    return roofline.share(least, measured)
