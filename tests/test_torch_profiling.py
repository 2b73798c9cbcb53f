"""The port's profiling hooks (`seesaw_tpu_torch.utils.profiling`): two
cases of tests/test_profiling.py on `torch.profiler`. A trace directory is
written (the Chrome trace and the wall-time note), a nested trace is a
no-op, and a named span works with and without a trace. On the CPU the
trace holds the host's ops; on a card it also holds the kernels
(`chip_smoke.py` phase 12g reads K1's name there). The spans themselves:
tests/test_torch_tracing.py."""
import json

import torch

from seesaw_tpu_torch.utils.profiling import annotate, device_trace


def test_device_trace_writes_artifacts(tmp_path):
    d = tmp_path / "trace"
    with device_trace(d) as out:
        assert out == d
        with annotate("unit-span"):
            x = torch.ones(128, 128)
            float((x @ x).sum())
        # nested use is a no-op, not an error
        with device_trace(d) as inner:
            assert inner is None
    assert (d / "trace_meta.txt").read_text().startswith("wall_seconds=")
    events = json.loads((d / "trace.json").read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "unit-span" in names and "aten::mm" in names


def test_annotate_without_trace():
    with annotate("no-trace-span"):
        assert float(torch.ones(3).sum()) == 3.0

