"""Jacobi steps a fused propagation round took, by the program's count
(the `steps` of its `prop.round` spans), the mean over the rounds that
ended in the window."""
from loadbench.harness import spans


def read(run):
    records = spans.in_window(run)
    if records is None:
        return None
    return spans.mean([r.attrs["steps"] for r in records if r.name == "prop.round"])
