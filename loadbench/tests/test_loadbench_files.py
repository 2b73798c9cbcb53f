"""Every file of the benchmark parses and keeps to the allowed names, and
every name BENCHMARK.json gives leads to its file."""
from __future__ import annotations

import json
import math

import pytest

from loadbench.harness.cell import BENCH_DIR, NAME, ROOT, UNIT, load_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
ONE_LINE = 200


def _line(text: str) -> bool:
    return 1 <= len(text) <= ONE_LINE and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["loadbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "configs").glob("*.json"))
                         + sorted((BENCH_DIR / "traffic").glob("*.json"))
                         + sorted((BENCH_DIR / "limits").glob("*.json")),
                         ids=lambda p: f"{p.parent.name}/{p.name}")
def test_data_file_parses(path):
    data = json.loads(path.read_text())
    assert NAME.match(path.stem)
    if path.parent.name in ("configs", "traffic"):
        assert data["name"] == path.stem


def test_configs():
    names = set()
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] not in names
        names.add(c["name"])
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"] == f"loadbench/configs/{c['name']}.json"
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["source"] == c["source"] and data["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    assert names == {w["config"] for w in BENCH["workloads"]}


def test_workloads():
    seen = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["name"] == f"{w['config']}.{w['traffic']}" and NAME.match(w["name"])
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))
        assert w["chips"] in (1, 4) and _line(w["why"])
        cell = load_cell(w["name"], BENCH)
        assert cell.limits, f"{w['name']} has no limits file"
        assert cell.method in cell.config["methods"]
        assert any(m["name"] == "setup_s" for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize("group", ["end_to_end", "per_layer"])
def test_metrics(group):
    names = {m["name"] for g in ("end_to_end", "per_layer") for m in BENCH[g]}
    assert len(names) == len(BENCH["end_to_end"]) + len(BENCH["per_layer"])
    cells = {w["name"] for w in BENCH["workloads"]}
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH[group]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").exists()
        assert set(m.get("workloads", [])) <= cells
        if group == "end_to_end":
            assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                              "workloads"}
            assert m["source"] in ("device_trace", "program_span", "program_counter",
                                   "host_clock")
            assert _line(m["layer"]) and m["moves"] in e2e


def test_layers_are_named_alike():
    """Metrics of one layer give the same layer, letter for letter."""
    layers = {m["layer"] for m in BENCH["per_layer"]}
    assert len({lay.split(":")[0] for lay in layers}) == len(layers)


def test_limits_have_readings():
    for path in (BENCH_DIR / "limits").glob("*.json"):
        for name, lim in json.loads(path.read_text()).items():
            assert {"limit", "lower", "upper"} <= set(lim), (path.name, name)
            assert lim["lower"] <= lim["limit"], (path.name, name)
            assert lim["upper"] is None or lim["limit"] < lim["upper"], (path.name, name)


def _nb_clicks(rate: float, found: int, batch: int, n: int, cap: int) -> list:
    """The clicks to accept `found` images at `rate` a shown image, `batch` a
    click: the negative binomial's quantiles at (i + 0.5) / n, at most `cap`."""
    out = []
    for i in range(n):
        images = found
        while sum(math.comb(images, j) * rate**j * (1 - rate)**(images - j)
                  for j in range(found, images + 1)) < (i + 0.5) / n:
            images += 1
        out.append(min(-(-images // batch), cap))
    return out


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "traffic").glob("*.json")),
                         ids=lambda p: p.name)
def test_session_lengths_follow_the_accept_rate(path):
    """A mix's session lengths are the quantiles of its accept rate, at the
    configurations' batch of 3."""
    t = json.loads(path.read_text())
    assert {json.loads(p.read_text())["session"]["batch_size"]
            for p in (BENCH_DIR / "configs").glob("*.json")} == {3}
    lengths = t["session_clicks"]
    assert sorted(lengths) == _nb_clicks(t["accept_rate"], t["found_target"], 3,
                                         len(lengths), t["max_clicks"])
