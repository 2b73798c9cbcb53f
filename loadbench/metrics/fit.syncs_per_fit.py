"""Host reads a `multi_reg` fit made (each a wait for the card: the LBFGS's
branch decisions), by the program's count (the `host_reads` of its
`fit.multireg` spans), the mean over the fits that ended in the window."""
from loadbench.harness import spans


def read(run):
    records = spans.in_window(run)
    if records is None:
        return None
    return spans.mean([r.attrs["host_reads"] for r in records if r.name == "fit.multireg"])
