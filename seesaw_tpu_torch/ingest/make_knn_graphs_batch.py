"""Batch-build kNN graphs for a dataset and its per-category subsets, on
one device or over every visible card.

    python -m seesaw_tpu_torch.ingest.make_knn_graphs_batch --root R \
        --dataset lvis [--index multiscale] [--n_neighbors 10] [--knng_name ""] \
        [--categories catA catB | --all_categories] [--full] \
        [--factored_k_intra N] [--device cuda|cpu] [--sharded]

The twin of `scripts/make_knn_graphs_batch.py` (the reference's
`scripts/make_knn_graphs_lvis.py`): for each requested (dataset, index,
category) the exact kNN graph (`KNNGraph.build` on `--device`, default
`cuda`; without a card the command fails unless `--device cpu` is given) of
the whole index or of the category's subset, saved under the index's
`knn_graph/` path of the dataset or subset. Per-category subsets (the LVIS
flow: one graph per qgt column) are created from the category's positive
frames. With `--factored_k_intra N` the diversified graph
(`knn_graph.factor_neighbors`) is saved beside each as `<name>_factored`.
`--sharded` builds over a mesh of every visible card (`parallel.mesh.
make_mesh`, the ring build of `parallel.sharded_graph`). `build_one` also
takes a mesh that spans processes: every process builds its shards' part,
gets the whole graph, and the process of rank 0 writes it.
"""
import argparse
from pathlib import Path

import numpy as np
import torch


def build_one(ds, index_name: str, *, knng_name: str, n_neighbors: int, device,
              k_intra: int = 0, mesh=None):
    from ..knn_graph import KNNGraph, factor_neighbors

    idx = ds.load_index(index_name, device=device, options={})
    # subset indices carry no on-disk path; the graph lives under the
    # dataset/subset directory so per-category graphs don't collide
    out = Path(ds.path) / "indices" / index_name / "knn_graph" / knng_name
    g = KNNGraph.build(idx.vectors, n_neighbors=n_neighbors, device=device, mesh=mesh)
    if mesh is not None and mesh.rank != 0:
        return  # a process mesh's graph is replicated: rank 0 writes it
    g.save(out)
    print(f"{ds.dataset_name}/{index_name}: {g.nvecs} vectors k={g.k} -> {out}")
    if k_intra:
        # diversified variant (reference process_lvis_graphs / factor_neighbors):
        # 1 nearest vector per distinct other frame + k_intra within-frame
        fg = factor_neighbors(g, idx.meta.dbidx, k_intra=k_intra)
        fout = Path(str(out).rstrip("/") + "_factored")
        fg.save(fout)
        print(f"  factored (k_intra={k_intra}) -> {fout}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--index", default="multiscale")
    ap.add_argument("--n_neighbors", type=int, default=10)
    ap.add_argument("--knng_name", default="")
    ap.add_argument("--categories", nargs="*", default=None,
                    help="build per-category subset graphs for these qgt columns")
    ap.add_argument("--all_categories", action="store_true",
                    help="one subset graph per qgt column (the LVIS flow)")
    ap.add_argument("--full", action="store_true",
                    help="also build the whole-dataset graph")
    ap.add_argument("--sharded", action="store_true",
                    help="build over a mesh of every visible card")
    ap.add_argument("--factored_k_intra", type=int, default=0,
                    help="also write the diversified '<name>_factored' graph "
                         "(1 nearest per other frame + this many within-frame)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to build on the CPU")
    mesh = None
    if args.sharded:
        from ..parallel.mesh import make_mesh

        if not torch.cuda.is_available():
            ap.error("--sharded builds over the visible cards, and there is none")
        mesh = make_mesh()
        device = mesh.primary

    from ..dataset import GlobalDataManager

    gdm = GlobalDataManager(args.root)
    ds = gdm.get_dataset(args.dataset)

    if args.full or not (args.categories or args.all_categories):
        build_one(ds, args.index, knng_name=args.knng_name,
                  n_neighbors=args.n_neighbors, device=device,
                  k_intra=args.factored_k_intra, mesh=mesh)

    categories = args.categories or []
    if args.all_categories:
        categories = list(ds.load_qgt().columns.values)

    for cat in categories:
        qgt = ds.load_qgt()
        members = np.asarray(qgt.index[qgt[cat].fillna(0) > 0])
        if members.size < 2:
            print(f"skipping {cat!r}: {members.size} positive frames")
            continue
        sub_name = f"cat_{cat}"
        try:
            sub = ds.load_subset(sub_name)
        except Exception:
            sub = ds.create_named_subset(sub_name, members)
        build_one(sub, args.index, knng_name=args.knng_name,
                  n_neighbors=min(args.n_neighbors, members.size - 1),
                  device=device, k_intra=args.factored_k_intra, mesh=mesh)


if __name__ == "__main__":
    main()
