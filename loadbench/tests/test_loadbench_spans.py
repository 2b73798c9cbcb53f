"""The readers of the program's spans: on a tiny traced run of the knn
mix each reads a number; without spans (no trace over the window, or a
program that records none) each reads None."""
from __future__ import annotations

import math

import pytest

from loadbench.harness import runner
from loadbench.tests import tiny

CELL = "seesaw10m-int8-knn5.knnprop-x4"
READERS = ["host.syncs_per_click", "next.host_ms", "next.sync_wait_ms", "next.offcpu_ms",
           "prop.steps_per_round"]


@pytest.fixture(scope="module")
def traced():
    result, _ = tiny.run(tiny.cell(CELL, users=2), seed=2**33 + 5, traced=True)
    return result["metrics"]


@pytest.mark.parametrize("name", READERS)
def test_reads_a_number_in_a_traced_run(traced, name):
    v = traced[name]["value"]
    assert math.isfinite(v) and v >= 0
    if name == "host.syncs_per_click":
        assert v >= 0.9  # a click reads its ranked result at least


def test_steps_agree_with_the_clicks(traced):
    """The program's count of a round's steps and the harness's, read from
    the ranker, are of the same rounds."""
    assert traced["prop.steps_per_round"]["value"] == pytest.approx(
        traced["prop.steps_per_click"]["value"], rel=0.25)


@pytest.mark.parametrize("name", READERS)
def test_none_without_spans(name, monkeypatch):
    view = runner.RunView(cell=None, setup_s=0.0, t_open=0.0, t_close=1e-9, clicks=[],
                          counters={}, inputs=None, graph_raw=None)
    assert runner.read_metric(name, view) is None  # a window with no spans
    from seesaw_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")  # a program that records none
    view.t_close = 1e12
    assert runner.read_metric(name, view) is None
