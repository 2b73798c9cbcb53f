"""The host's waits for the card (the program's `host.sync` spans: reads
from the device and blocking uploads) that ended in the window, over the
window's clicks."""
from loadbench.harness import spans


def read(run):
    records = spans.in_window(run)
    clicks = len(run.window_clicks())
    if records is None or clicks == 0:
        return None
    return sum(r.name == "host.sync" for r in records) / clicks
