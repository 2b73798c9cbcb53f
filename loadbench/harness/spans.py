"""The program's own spans over the window, for the readers in
`metrics/`: `seesaw_tpu_torch.utils.profiling.spans`, which the program
fills while a `torch.profiler` trace runs, as in the traced run. A program
without that reader, or a run that recorded nothing, gives None."""
from __future__ import annotations


def in_window(run):
    """The spans that ended in the window, or None."""
    try:
        from seesaw_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    return read(int(run.t_open * 1e9), int(run.t_close * 1e9)) or None


def next_parts(run):
    """For each `session.next` that ended in the window: (wall ns, wall ns
    inside its outermost `host.sync` descendants, thread CPU ns outside
    them), or None."""
    records = in_window(run)
    if records is None:
        return None
    roots = {r.id: r for r in records if r.name == "session.next" and r.parent is None}
    if not roots:
        return None
    by_id = {r.id: r for r in records}
    syncs = {rid: [] for rid in roots}
    for r in records:
        parent = by_id.get(r.parent)
        outer = parent is None or parent.name != "host.sync"
        if r.name == "host.sync" and r.request in syncs and outer:
            syncs[r.request].append(r)
    out = []
    for rid, root in roots.items():
        wait = sum(s.t1 - s.t0 for s in syncs[rid])
        wait_cpu = sum(s.cpu1 - s.cpu0 for s in syncs[rid])
        out.append((root.t1 - root.t0, wait, root.cpu1 - root.cpu0 - wait_cpu))
    return out


def mean(values):
    return sum(values) / len(values) if values else None
