"""The `multi_reg` cell on the CPU at a tiny size: its files, `correct` on a
sound run and on runs with the fit broken, the readers of the fit's spans,
and the program building the graph's X'LX once under concurrent sessions."""
from __future__ import annotations

import ast
import json
import math
import threading

import pytest

from loadbench.harness import runner
from loadbench.harness.cell import BENCH_DIR, load_cell
from loadbench.tests import tiny

CELL = "seesaw10m-bf16-knn8.multireg-x4"
READERS = ["fit.ms", "fit.iters_per_fit", "fit.syncs_per_fit"]


def test_files():
    cell = load_cell(CELL)
    from seesaw_tpu_torch import configs

    assert cell.method == "multi_reg" and cell.chips == 1
    assert cell.config["methods"]["multi_reg"] == configs._method_configs["multi_reg"]
    assert cell.config["graph"] == load_cell("seesaw10m-int8-knn5.knnprop-x4").config["graph"]
    knn = json.loads((BENCH_DIR / "traffic" / "knnprop-x4.json").read_text())
    assert cell.traffic["session_clicks"] == knn["session_clicks"]
    assert set(cell.limits) == {"bad_results", "rank_gap"}
    assert {m["name"] for m in cell.end_to_end} == {"clicks_per_s", "setup_s"}
    assert {*READERS, "scan_roofline", "device.idle_share", "click_mfu"} == {
        m["name"] for m in cell.per_layer}


@pytest.fixture(scope="module")
def traced():
    # two users and a 4 s window, so that fits end inside it on a loaded CPU
    return tiny.run(tiny.cell(CELL, users=2), seed=2**33 + 17, traced=True, seconds=4.0)


def test_sound_run_is_correct(traced):
    result, values = traced
    assert result["failed"] == 0 and result["attempted"] > 0
    assert values["checked_clicks"] > 0
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("name", READERS)
def test_fit_readers_read_a_traced_run(traced, name):
    v = traced[0]["metrics"][name]["value"]
    assert math.isfinite(v) and v > 0


def _no_fit(mp):
    """The fit skipped: every click ranks by the text vector."""
    from seesaw_tpu_torch.learners import multi_reg
    from seesaw_tpu_torch.ops.lbfgs import LBFGSResult

    def skipped(fun, x0, **kw):
        return LBFGSResult(x=x0, f=fun(x0).detach(), n_iter=0, converged=True,
                           diverged=False, host_syncs=0)
    mp.setattr(multi_reg, "lbfgs_minimize", skipped)


def _no_query_term(mp):
    """The objective without its query term."""
    from seesaw_tpu_torch.learners import multi_reg

    orig = multi_reg.multi_reg_loss

    def broken(*args, **kw):
        return orig(*args[:-1], 0.0, **kw)
    mp.setattr(multi_reg, "multi_reg_loss", broken)


@pytest.mark.parametrize("fault", [_no_fit, _no_query_term], ids=["no_fit", "no_query_term"])
def test_broken_fit_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    result, _ = tiny.run(tiny.cell(CELL, users=2), seed=4_000_000_007, seconds=4.0)
    gap = result["checks"]["rank_gap"]
    assert not result["correct"] and gap["value"] > gap["limit"], result["checks"]


def _record(name, t0, t1, **attrs):
    from seesaw_tpu_torch.utils.profiling import SpanRecord

    return SpanRecord(name, 0, None, 0, 0, t0, t1, 0, 0, attrs)


@pytest.mark.parametrize("name,want", [("fit.ms", 3.0), ("fit.iters_per_fit", 20.0),
                                       ("fit.syncs_per_fit", 95.0)])
def test_fit_readers_on_records(name, want, monkeypatch):
    from seesaw_tpu_torch.utils import profiling

    records = [_record("fit.multireg", 0, 2_000_000, rows=0, deferred=0, iters=16, host_reads=80),
               _record("fit.multireg", 5_000_000, 9_000_000, rows=24, deferred=1, iters=24,
                       host_reads=110),
               _record("fit.xlx", 0, 50_000_000, rows=8, slots=3),
               _record("host.sync", 1, 2, site="lbfgs")]
    monkeypatch.setattr(profiling, "spans", lambda t0, t1: [r for r in records if t0 <= r.t1 <= t1])
    view = runner.RunView(cell=None, setup_s=0.0, t_open=0.0, t_close=0.01, clicks=[],
                          counters={}, inputs=None, graph_raw=None)
    assert runner.read_metric(name, view) == pytest.approx(want)
    view.t_open = 0.02  # a window with no fit in it
    view.t_close = 0.03
    assert runner.read_metric(name, view) is None


def test_one_build_of_a_key_under_concurrent_callers(monkeypatch):
    """Four callers of one key get the one build; a caller of another key
    builds while that build is still running."""
    from seesaw_tpu_torch.loops import graph_based

    monkeypatch.setattr(graph_based, "_wm_cache", {})
    builds, release, other_built = [], threading.Event(), threading.Event()

    def build(opts, use_cache, X_vectors, device):
        builds.append(opts.knn_path)
        if opts.knn_path == "a":
            assert release.wait(30)
        else:
            other_built.set()
        return object()
    monkeypatch.setattr(graph_based, "_build_weights", build)
    opts = graph_based.WeightMatrixOptions(knn_path="a", knn_k=8, edist=0.1)
    start, got = threading.Barrier(4), [None] * 4

    def caller(i):
        start.wait()
        got[i] = graph_based.lookup_weights(opts)
    threads = [threading.Thread(target=caller, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for _ in range(3000):  # until a's build has begun
        if builds:
            break
        threading.Event().wait(0.01)
    graph_based.lookup_weights(opts.model_copy(update={"knn_path": "b"}))
    assert other_built.is_set()
    release.set()
    for t in threads:
        t.join(30)
    assert builds.count("a") == 1 and builds.count("b") == 1
    assert all(g is got[0] for g in got) and got[0] is not None


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "harness" / "multi_reg_reference.py",
                 BENCH_DIR / "checks" / "multi_reg.py"):
        names = set()
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names.update(a.name.split(".")[0] for a in node.names)
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
        assert names <= {"__future__", "numpy", "torch", "loadbench"}, (path.name, names)
