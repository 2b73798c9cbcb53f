"""Clicks that all sessions completed inside the window, over the window's
seconds: a card's capacity for concurrent users."""
from loadbench.harness import stats


def read(run):
    return stats.rate(len(run.window_clicks()), run.seconds)
