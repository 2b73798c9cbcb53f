"""The wall time of a fused propagation round's ranking tail: the mean over
the window's `prop.rank` spans of the program (the tail's enqueue, eager or
as a graph replay, and the waits inside it)."""
from loadbench.harness import spans


def read(run):
    records = spans.in_window(run)
    if records is None:
        return None
    return spans.mean([(r.t1 - r.t0) / 1e6 for r in records if r.name == "prop.rank"])
