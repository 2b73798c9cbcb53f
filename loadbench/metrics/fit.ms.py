"""The wall time of a `multi_reg` fit: the mean over the window's
`fit.multireg` spans of the program (the LBFGS over the labelled rows, its
host reads included); None where no span was recorded."""
from loadbench.harness import spans


def read(run):
    records = spans.in_window(run)
    if records is None:
        return None
    return spans.mean([(r.t1 - r.t0) / 1e6 for r in records if r.name == "fit.multireg"])
