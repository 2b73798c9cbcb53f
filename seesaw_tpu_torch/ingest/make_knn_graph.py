"""Build the exact kNN graph of an index on one device, and optionally its
diversified (factored) variant.

    python -m seesaw_tpu_torch.ingest.make_knn_graph --dataset_path <ds> \
        [--index_name multiscale] [--graph_name ""] [--n_neighbors 32] \
        [--k_intra 0] [--device cuda|cpu]

The graph is saved as `forward.parquet` under the index's `knn_graph/`
directory, the format both packages read. With `--k_intra N` the graph is
also factored (`knn_graph.factor_neighbors`: the nearest vector of each
other image plus up to N of the same image) and saved beside it with the
suffix `_factored`. The default device is `cuda`; without a card the
command fails unless `--device cpu` is given.
"""
import argparse
from pathlib import Path

import torch

from ..dataset import SeesawDataset
from ..knn_graph import KNNGraph, factor_neighbors


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--dataset_path", required=True)
    parser.add_argument("--index_name", default="multiscale")
    parser.add_argument("--graph_name", default="")
    parser.add_argument("--n_neighbors", type=int, default=32)
    parser.add_argument("--block_size", type=int, default=None)
    parser.add_argument("--k_intra", type=int, default=0,
                        help="also save the factored graph with this many same-image neighbours")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("no CUDA device: pass --device cpu to build on the CPU")

    ds = SeesawDataset(args.dataset_path)
    idx = ds.load_index(args.index_name, device=device)
    g = KNNGraph.build(idx.vectors, n_neighbors=args.n_neighbors,
                       block_size=args.block_size, device=device)
    out = idx.get_knng_path(args.graph_name)
    g.save(out)
    print(f"built kNN graph k={g.k} over {g.nvecs} vectors -> {out}")
    if args.k_intra:
        fout = Path(str(out).rstrip("/") + "_factored")
        factor_neighbors(g, idx.meta.dbidx, k_intra=args.k_intra).save(fout)
        print(f"factored (k_intra={args.k_intra}) -> {fout}")


if __name__ == "__main__":
    main()
