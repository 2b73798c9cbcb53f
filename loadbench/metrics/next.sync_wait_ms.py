"""The wait for the card in a `next`: the mean over the window's
`session.next` spans of their wall time inside their `host.sync`
descendants (the click's own round, and any other user's work queued ahead
of it on the stream)."""
from loadbench.harness import spans


def read(run):
    parts = spans.next_parts(run)
    return None if parts is None else spans.mean([s / 1e6 for _, s, _ in parts])
