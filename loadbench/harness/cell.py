"""A cell's files, found by name.

A cell is `<config>.<mix>`: `BENCHMARK.json` names it under `workloads`, its
configuration is `loadbench/configs/<config>.json`, its traffic mix
`loadbench/traffic/<mix>.json`, the limits of its correctness check
`loadbench/limits/<cell>.json`, and each metric it reports is read by
`loadbench/metrics/<metric>.py`. Nothing here names a cell: a later cell or
metric is added by adding files and entries.
"""
from __future__ import annotations

import json
import re
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent  # loadbench/
ROOT = BENCH_DIR.parent  # the checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    chips: int
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list

    @property
    def method(self) -> str:
        return self.traffic["method"]


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, benchmark: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json (read from the checkout's root when
    `benchmark` is None) with its files."""
    if benchmark is None:
        benchmark = load_json(ROOT / "BENCHMARK.json")
    entries = [w for w in benchmark["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    w = entries[0]
    for part in (w["config"], w["traffic"]):
        if not NAME.match(part):
            raise ValueError(f"bad name {part!r}")
    config = load_json(BENCH_DIR / "configs" / f"{w['config']}.json")
    traffic = load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json")
    limits_path = BENCH_DIR / "limits" / f"{name}.json"
    limits = load_json(limits_path) if limits_path.exists() else {}
    return Cell(
        name=name, config=config, traffic=traffic, limits=limits, chips=int(w["chips"]),
        end_to_end=[m for m in benchmark["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in benchmark["per_layer"] if _reports(m, name)],
    )
