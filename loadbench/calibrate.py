"""Readings for the limits of a cell's correctness check, on the card.

    python loadbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 6 --out calib.jsonl

For each seed, in one process: the cell's set-up, a short window at its
load, and the numbers compared, as a run of `run.py` reads them (the lower
readings); for the control seeds also the control's, the reference put in
the program's place in the precision the configuration names below its own
(`control_precision`; the upper readings). One JSON line a seed.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from loadbench.harness import runner
    from loadbench.harness.cell import load_cell
    from seesaw_tpu_torch.loops import graph_based

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "a") as out:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            ctl = cell.config["control_precision"] if seed in controls else None
            result, values = runner.run(cell, seed=seed, seconds=args.seconds, traced=False,
                                        device="cuda:0", t_start=t0, control=ctl,
                                        log=lambda m: print(m, file=sys.stderr))
            row = {"workload": cell.name, "seed": seed, "readings": values,
                   "metrics": result["metrics"], "attempted": result["attempted"],
                   "failed": result["failed"], "run_s": time.perf_counter() - t0}
            print(json.dumps(row), flush=True)
            out.write(json.dumps(row) + "\n")
            out.flush()
            # each seed's graph weights are the program's cache's; drop them
            graph_based._wm_cache.clear()
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
