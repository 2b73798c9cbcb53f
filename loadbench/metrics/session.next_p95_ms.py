"""The 95th percentile of every `next` completed in the window, across all
sessions."""
from loadbench.harness import stats


def read(run):
    return stats.percentile(run.window_next_ms(), 95)
