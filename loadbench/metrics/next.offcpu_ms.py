"""Of `next.host_ms`, the time the thread did not run: the mean over the
window's `session.next` spans of their wall time outside `host.sync` less
the thread's CPU time there (waits for the interpreter lock or a lock of
the program)."""
from loadbench.harness import spans


def read(run):
    parts = spans.next_parts(run)
    return None if parts is None else spans.mean([(w - s - c) / 1e6 for w, s, c in parts])
