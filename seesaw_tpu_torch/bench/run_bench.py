"""Run benchmark sessions from yaml config files, through the port.

    python -m seesaw_tpu_torch.bench.run_bench --root_dir <root> \
        --output_dir <dir> [--num_workers 1] [--dryrun] \
        [--dryrun_max_iter 3] [--device cuda|cpu] config.yaml [...]

The twin of `scripts/run_bench.py`, with the same yaml (`variants`,
`datasets`, `shared_session_params`, `shared_bench_params`) and flags.
Sessions run on `--device` (default `cuda`; without a card the command fails
unless `--device cpu` is given). With `--num_workers N > 1` the sessions run
in N worker processes started by `spawn` (a forked child of a process that
has touched CUDA cannot use the card); each worker loads its own copy of
every index it serves onto the device, so the device must hold N x the
index's bytes. A session that raises is reported on stderr and skipped, as
in the JAX script; its directory keeps the summary without a result.
"""
import argparse
import math
import multiprocessing
import os
import random
import string
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import torch


def _run_one(args_tuple) -> dict:
    """One session in this process: its output directory (None if it
    raised), the process id and device, and the frame-max scan's launches
    during the session (counted only where the kernel ran on the card)."""
    root_dir, results_dir, device, cfg = args_tuple
    from ..ops.fused_scoring import fused_frame_max
    from .harness import BenchRunner

    br = BenchRunner(root_dir, results_dir, redirect_output=True, device=device)
    b, p = cfg
    before = fused_frame_max.launches
    try:
        out = br.run_loop(b, p)
    except Exception as e:
        print(f"bench run failed: {e!r}", file=sys.stderr)
        out = None
    return {"output_dir": out, "pid": os.getpid(), "device": device,
            "fused_frame_max_launches": fused_frame_max.launches - before}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--root_dir", required=True)
    parser.add_argument("--output_dir", required=True)
    parser.add_argument("--num_workers", type=int, default=1,
                        help="worker processes (spawn); each holds its own copy of the index")
    parser.add_argument("--dryrun", action="store_true")
    parser.add_argument("--dryrun_max_iter", type=int, default=3)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("configs", nargs="+")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to run on the CPU")

    from ..configs import expand_configs, load_yaml_config
    from ..dataset import GlobalDataManager
    from .configs import generate_benchmark_configs, get_param_hash
    from .harness import get_all_session_summaries

    gdm = GlobalDataManager(args.root_dir)
    all_cfgs = []
    for path in args.configs:
        yl = load_yaml_config(path)
        base_configs = expand_configs(yl["variants"])
        bench_template = dict(yl["shared_bench_params"])
        max_classes = math.inf
        if args.dryrun:
            bench_template["n_batches"] = args.dryrun_max_iter
            bench_template["max_results"] = args.dryrun_max_iter
            max_classes = 1
        cfgs = generate_benchmark_configs(
            gdm,
            datasets=yl["datasets"],
            base_configs=base_configs,
            s_template=yl["shared_session_params"],
            b_template=bench_template,
            max_classes_per_dataset=max_classes,
        )
        print(f"generated {len(cfgs)} configs from {path}")
        all_cfgs.extend(cfgs)

    # no duplicate (name, dataset, category, params)
    seen = set()
    for b, p in all_cfgs:
        key = (b.name, p.index_spec.d_name, b.ground_truth_category,
               get_param_hash(p.model_dump_json()))
        assert key not in seen, f"duplicate config {key}"
        seen.add(key)

    exp = "".join(random.choice(string.ascii_letters) for _ in range(10))
    results_dir = f"{args.output_dir}/bench_{exp}/"
    os.makedirs(results_dir, exist_ok=True)
    print(f"writing results to {results_dir}")

    work = [(args.root_dir, results_dir, str(device), cfg) for cfg in all_cfgs]
    random.shuffle(work)
    t0 = time.time()
    if args.num_workers <= 1 or args.dryrun:
        runs = [_run_one(w) for w in work]
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(args.num_workers, mp_context=ctx) as pool:
            runs = list(pool.map(_run_one, work))
    print(f"done in {time.time() - t0:.1f}s; summarizing...")
    for pid in sorted({r["pid"] for r in runs}):
        mine = [r for r in runs if r["pid"] == pid]
        print(f"process {pid}: {len(mine)} sessions on {mine[0]['device']}, "
              f"{sum(r['output_dir'] is None for r in mine)} failed, frame-max kernel "
              f"launches {sum(r['fused_frame_max_launches'] for r in mine)}")
    df = get_all_session_summaries(results_dir, force_recompute=True)
    print(df.head(20))
    print(f"results in {results_dir}")
    return results_dir, runs


if __name__ == "__main__":
    main()
