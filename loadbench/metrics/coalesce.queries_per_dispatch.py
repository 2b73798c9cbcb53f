"""Queries the coalescer served over its launches in the window, batched
and solo (`QueryCoalescer.stats`); None without a coalescer or a query."""


def read(run):
    batched, solo = run.delta("coalesce.batched"), run.delta("coalesce.solo")
    dispatches = run.delta("coalesce.dispatches")
    if batched is None or dispatches + solo == 0:
        return None
    return (batched + solo) / (dispatches + solo)
