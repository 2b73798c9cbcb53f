"""Tiny cells for the benchmark's CPU tests: a configuration and a mix from
their files, cut to a size a test run holds (the widths too: these are no
benchmark configurations). A cell of BENCHMARK.json keeps its limits; a mix
that has no cell yet is held to limits of its own, set here from tiny CPU
runs of the program (below them) and of its control (above them)."""
from __future__ import annotations

import json
import time

from loadbench.harness import runner
from loadbench.harness.cell import BENCH_DIR, ROOT, Cell, load_json

TINY_LIMITS = {  # mixes with no cell yet: (sound tiny readings, control's)
    "seesaw10m-bf16.plain-x16": {"rank_gap": 1.0},  # <= 0.07; >= 1.6 (fp8)
    "seesaw10m-bf16.rocchio-x8": {"rank_gap": 1.0, "qvec_err": 1e-4},  # 0.03, 1.5e-7; 1.7, 0.034
    "seesaw10m-int8-knn5.plain-x16": {"rank_gap": 3.0},  # <= 0.73; >= 5.4 (int4)
}


def cell(name: str, *, n_tiles: int = 8192, dim: int = 64, users: int | None = None,
         **traffic) -> Cell:
    config, mix = name.split(".", 1)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    path = BENCH_DIR / "limits" / f"{name}.json"
    if path.exists():
        limits = load_json(path)
    else:
        limits = {"bad_results": {"limit": 0}}
        limits.update({k: {"limit": v} for k, v in TINY_LIMITS[name].items()})
    reports = (lambda m: "workloads" not in m or name in m["workloads"])
    t = dict(load_json(BENCH_DIR / "traffic" / f"{mix}.json"), warm_seconds=0.2,
             warm_clicks=2, **traffic)
    if users is not None:
        t["users"] = users
    return Cell(name=name,
                config=dict(load_json(BENCH_DIR / "configs" / f"{config}.json"),
                            n_tiles=n_tiles, dim=dim),
                traffic=t, limits=limits, chips=1,
                end_to_end=[m for m in bench["end_to_end"] if reports(m)],
                per_layer=[m for m in bench["per_layer"] if reports(m)])


def run(c, *, seed: int = 12345, seconds: float = 1.5, traced: bool = False,
        control: str | None = None):
    """One CPU run: (result, numbers compared)."""
    return runner.run(c, seed=seed, seconds=seconds, traced=traced, device="cpu",
                      t_start=time.perf_counter(), log=lambda m: None, control=control)
