"""The median of every `next` completed in the window, across all sessions:
the time a user waits after each click, from the call until the results
are on the host."""
from loadbench.harness import stats


def read(run):
    return stats.percentile(run.window_next_ms(), 50)
