"""`rocchio_update` sessions: each click after round 0 ranks by the Rocchio
update of the text vector by every label so far (see `harness/point.py`)."""
from loadbench.harness import point


def readings(ctx, sessions) -> dict:
    return point.readings(ctx, sessions, rocchio=ctx.cfg["methods"]["rocchio_update"])
