"""The port's profiling hooks (`seesaw_tpu_torch.utils.profiling`): the three
cases of tests/test_profiling.py on `torch.profiler`. A trace directory is
written (the Chrome trace and the wall-time note), a nested trace is a
no-op, a named span works with and without a trace, and SEESAW_PROFILE_DIR
gates the tracing. On the CPU the trace holds the host's ops; on a card it
also holds the kernels (`chip_smoke.py` phase 12g reads K1's name there)."""
import json

import torch

from seesaw_tpu_torch.utils.profiling import annotate, device_trace, maybe_trace_from_env


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


def test_env_gate(tmp_path, monkeypatch):
    monkeypatch.delenv("SEESAW_PROFILE_DIR", raising=False)
    with maybe_trace_from_env() as out:
        assert out is None
    monkeypatch.setenv("SEESAW_PROFILE_DIR", str(tmp_path / "envtrace"))
    with maybe_trace_from_env() as out:
        assert out is not None
        float(torch.ones(4).sum())
    assert (tmp_path / "envtrace" / "trace_meta.txt").exists()
    assert (tmp_path / "envtrace" / "trace.json").exists()
