"""The benchmark of seesaw_tpu_torch: one run of one cell on one card.

    python loadbench/run.py --workload <config>.<mix> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` the
`breakdown`, and last `checks`, each number compared with its limit; the
same numbers close standard error. Exits 2 without a card (or with fewer
than the cell needs), 1 when the program or a file is missing or a module
of JAX or the JAX package was loaded, printing no result then.

The port's kernel builds live in `build/seesaw_tpu_torch/` of the checkout,
and the caches of PyTorch's extensions and of Triton in `build/loadbench/`,
fixed paths, so that only the first run in a checkout builds.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "loadbench"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))

    import torch

    from loadbench.harness.cell import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"loadbench: needs {cell.chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import seesaw_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"loadbench: the program is missing: {e}", file=sys.stderr)
        return 1
    from loadbench.harness import runner

    def log(msg):
        print(f"loadbench: {msg}", file=sys.stderr, flush=True)

    result, values = runner.run(cell, seed=args.seed, seconds=args.seconds,
                                traced=bool(args.trace), device="cuda:0", t_start=T_START,
                                log=log)
    found = runner.forbidden_modules()
    if found:
        print(f"loadbench: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 1
    log("readings: " + json.dumps({k: v for k, v in values.items()
                                   if k not in result["checks"]}))
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
