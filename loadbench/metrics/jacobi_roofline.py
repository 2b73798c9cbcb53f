"""Percent of the Jacobi step's roofline: the least time of the window's
steps (`PropagationResult.n_iter` of each propagating click, each step's
bytes by `roofline.jacobi_step_bytes`) over the traced device time of
`jacobi_kernel`."""
from loadbench.harness import roofline, work


def read(run):
    if run.trace is None:
        return None
    measured = sum(k.seconds for k in run.trace.kernels if "jacobi_kernel" in k.name)
    least = work.jacobi_seconds(run, work.jacobi_steps(run))
    return roofline.share(least, measured) if least > 0 else None
