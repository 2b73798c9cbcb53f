"""`plain` sessions: every click ranks by the text vector (see
`harness/point.py`)."""
from loadbench.harness import point


def readings(ctx, sessions) -> dict:
    return point.readings(ctx, sessions)
