"""LBFGS iterations a `multi_reg` fit took, by the program's count (the
`iters` of its `fit.multireg` spans), the mean over the fits that ended in
the window."""
from loadbench.harness import spans


def read(run):
    records = spans.in_window(run)
    if records is None:
        return None
    return spans.mean([r.attrs["iters"] for r in records if r.name == "fit.multireg"])
