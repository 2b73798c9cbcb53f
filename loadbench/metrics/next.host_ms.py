"""The host's own part of a `next`: the mean over the window's
`session.next` spans of their wall time outside their `host.sync`
descendants."""
from loadbench.harness import spans


def read(run):
    parts = spans.next_parts(run)
    return None if parts is None else spans.mean([(w - s) / 1e6 for w, s, _ in parts])
