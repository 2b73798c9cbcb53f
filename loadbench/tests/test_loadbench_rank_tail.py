"""The readers of the ranking tail's spans: on a tiny traced run of the knn
mix `prop.rank_ms` reads a time and `prop.rank_graph_share` a share (0 on
the CPU, where the tail runs eagerly); the share reads None where no
`prop.rank` span carries `graph`, and both read None without spans."""
from __future__ import annotations

import math

import pytest

from loadbench.harness import runner
from loadbench.tests import tiny

CELL = "seesaw10m-int8-knn5.knnprop-x4"
READERS = ["prop.rank_ms", "prop.rank_graph_share"]


def _view(t_close: float):
    return runner.RunView(cell=None, setup_s=0.0, t_open=0.0, t_close=t_close, clicks=[],
                          counters={}, inputs=None, graph_raw=None)


@pytest.fixture(scope="module")
def traced():
    result, _ = tiny.run(tiny.cell(CELL, users=2), seed=2**33 + 7, traced=True)
    return result["metrics"]


def test_read_numbers_in_a_traced_run(traced):
    assert math.isfinite(traced["prop.rank_ms"]["value"]) and traced["prop.rank_ms"]["value"] > 0
    assert traced["prop.rank_graph_share"]["value"] == 0.0  # no graphs on the CPU


def test_share_is_none_without_the_graph_attribute(monkeypatch):
    """Spans of a program without the graph path (the attribute absent) give
    no share; the time is read all the same."""
    from seesaw_tpu_torch.utils import profiling

    records = [profiling.SpanRecord("prop.rank", i, None, i, 1, 0, 2_000_000, 0, 0, {})
               for i in (1, 2)]
    monkeypatch.setattr(profiling, "spans", lambda t0=None, t1=None: records)
    view = _view(1e12)
    assert runner.read_metric("prop.rank_graph_share", view) is None
    assert runner.read_metric("prop.rank_ms", view) == pytest.approx(2.0)
    records[1] = records[1]._replace(attrs={"graph": 1})
    assert runner.read_metric("prop.rank_graph_share", view) == pytest.approx(100.0)


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans(name, monkeypatch):
    assert runner.read_metric(name, _view(1e-9)) is None  # a window with no spans
    from seesaw_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")  # a program that records none
    assert runner.read_metric(name, _view(1e12)) is None
