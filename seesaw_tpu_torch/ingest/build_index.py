"""Build a multiscale (and optionally coarse) index for a dataset, and
optionally its exact kNN graph, on one device.

    python -m seesaw_tpu_torch.ingest.build_index --dataset_path <ds> \
        [--model clip-vit-b32[:<artifact dir>]] [--knn_k 32] [--coarse_name coarse] \
        [--tiling device|host] [--device cuda|cpu] [--force]

The index is written in the format both packages load (`info.json` names
the JAX class). The default device is `cuda`; without a card the command
fails unless `--device cpu` is given.
"""
import argparse

import torch

from ..dataset import SeesawDataset
from .pipeline import create_coarse_index, create_multiscale_index


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--index_name", default="multiscale")
    parser.add_argument("--model", default="clip-vit-b32",
                        help="model spec, e.g. clip-vit-b32[:artifact_dir] or hash-64")
    parser.add_argument("--tile_size", type=int, default=224)
    parser.add_argument("--min_tile_size", type=int, default=224)
    parser.add_argument("--batch_size", type=int, default=256)
    parser.add_argument("--tiling", choices=("device", "host"), default="device",
                        help="make the tiles on the device (default) or on host threads")
    parser.add_argument("--knn_k", type=int, default=0,
                        help="also build the exact kNN graph with this k")
    parser.add_argument("--coarse_name", default=None,
                        help="also derive a coarse index under this name")
    parser.add_argument("--limit", type=int, default=None)
    parser.add_argument("--force", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to build on the CPU")

    ds = SeesawDataset(args.dataset_path)
    idx = create_multiscale_index(
        ds, args.index_name, args.model, device=device,
        tile_size=args.tile_size, min_tile_size=args.min_tile_size,
        batch_size=args.batch_size, force=args.force, tiling=args.tiling,
        build_knn_graph=args.knn_k or None, limit=args.limit,
    )
    print(f"built index {args.index_name}: {idx.vectors.shape} vectors")
    if args.coarse_name:
        coarse = create_coarse_index(ds, args.coarse_name, from_index=args.index_name,
                                     device=device, force=args.force)
        print(f"built coarse index {args.coarse_name}: {coarse.vectors.shape}")


if __name__ == "__main__":
    main()
