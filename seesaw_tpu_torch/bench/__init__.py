"""Benchmark harness: simulated-user sessions over ground truth, on the
port's sessions (counterpart of `seesaw_tpu/bench`)."""

from .harness import (  # noqa: F401
    BenchRunner,
    benchmark_loop,
    fill_imdata,
    summarize_session,
    get_all_session_summaries,
)
