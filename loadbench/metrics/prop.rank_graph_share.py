"""The share of the window's `prop.rank` spans that replayed a captured
graph (`graph` 1) rather than enqueue the ranking tail op by op; None where
no span carries `graph` (a program without the graph path)."""
from loadbench.harness import spans


def read(run):
    records = spans.in_window(run)
    if records is None:
        return None
    flags = [r.attrs["graph"] for r in records if r.name == "prop.rank" and "graph" in r.attrs]
    return 100.0 * spans.mean(flags) if flags else None
