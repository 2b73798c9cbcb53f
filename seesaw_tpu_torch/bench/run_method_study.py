"""Offline method-comparison metric study on the synthetic graded corpus
(`bench.study`), through the port on one device.

    python -m seesaw_tpu_torch.bench.run_method_study [--out <prefix>] \
        [--n-images 600] [--n-pos 24] [--instances-per-tier 3] \
        [--n-batches 40] [--methods plain,log_reg2,...] [--seeds 0,1] \
        [--workdir <dir>] [--device cuda|cpu]

The twin of `scripts/run_method_study.py`, with the same flags and outputs:
  <out>.json     — method means / per-tier breakdown / win-tie-loss tables
  <out>.parquet  — the raw per-session metrics frame
The corpus's index and kNN graph are built, and its sessions run, on
`--device` (default `cuda`; without a card the command fails unless
`--device cpu` is given).
"""
import argparse
import json
import os
import tempfile
import time

import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="docs/method_study",
                    help="output prefix (writes <out>.json and <out>.parquet)")
    ap.add_argument("--n-images", type=int, default=600)
    ap.add_argument("--n-pos", type=int, default=24)
    ap.add_argument("--instances-per-tier", type=int, default=3)
    ap.add_argument("--n-batches", type=int, default=40)
    ap.add_argument("--methods", default=None,
                    help="comma-separated subset of methods")
    ap.add_argument("--seeds", default="0,1",
                    help="comma-separated corpus seeds; one dataset each")
    ap.add_argument("--workdir", default=None,
                    help="keep corpus+sessions here (default: temp dir)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")

    import pandas as pd

    from .study import STUDY_METHODS, build_study_corpus, run_study, study_tables

    methods = tuple(args.methods.split(",")) if args.methods else STUDY_METHODS
    workdir = args.workdir or tempfile.mkdtemp(prefix="method_study_")
    root = os.path.join(workdir, "root")
    results = os.path.join(workdir, "results")

    t0 = time.time()
    seeds = [int(s) for s in args.seeds.split(",")]
    categories = {}
    frames = []
    for seed in seeds:
        dname = f"study{seed}"
        print(f"[study] building corpus {dname} under {root} on {device}", flush=True)
        _, _, cats = build_study_corpus(
            root, device=device, n_images=args.n_images, n_pos_per_cat=args.n_pos,
            instances_per_tier=args.instances_per_tier, seed=seed, dataset_name=dname,
        )
        categories.update(cats)
        print(f"[study] {dname} ready ({time.time() - t0:.1f}s); "
              f"running {len(methods)} methods x {len(cats)} categories", flush=True)
        frames.append(run_study(
            root, os.path.join(results, dname), device=device, methods=methods,
            n_batches=args.n_batches, dataset_name=dname,
        ))

    df = pd.concat(frames, ignore_index=True)
    tables = study_tables(df, categories)
    tables["config"] = dict(
        n_images=args.n_images, n_pos_per_cat=args.n_pos,
        instances_per_tier=args.instances_per_tier,
        n_batches=args.n_batches, methods=list(methods), seeds=seeds,
        wall_s=round(time.time() - t0, 1),
    )

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(f"{args.out}.json", "w") as f:
        json.dump(tables, f, indent=2)
    df.drop(columns=["session_params", "bench_params"], errors="ignore") \
        .to_parquet(f"{args.out}.parquet")

    print(f"[study] wrote {args.out}.json ({time.time() - t0:.1f}s total)")
    print(json.dumps(tables["overall"], indent=2))


if __name__ == "__main__":
    main()
