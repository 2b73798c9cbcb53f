"""Jacobi steps a propagating click took (`PropagationResult.n_iter`, read
from the session's ranker), the mean over the window's clicks."""


def read(run):
    steps = [c.steps for c in run.clicks if c.steps is not None and run.in_window(c.t_next)]
    return sum(steps) / len(steps) if steps else None
