"""Percent of the window's wall time that the least device time of its
clicks' work fills (`harness/work.py`: each scan's bytes, each Jacobi
step's bytes, at the chip's peaks)."""
from loadbench.harness import roofline, work


def read(run):
    least = work.window_least_seconds(run)
    return roofline.share(least, run.seconds) if least > 0 else None
