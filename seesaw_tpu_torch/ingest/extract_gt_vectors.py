"""Extract CLIP vectors for every ground-truth box of a dataset, on one
device.

    python -m seesaw_tpu_torch.ingest.extract_gt_vectors --root R --dataset D \
        --output_path OUT [--model clip-vit-b32[:<artifact dir>]] [--padding 60] \
        [--limit N] [--batch_size 256] [--device cuda|cpu]

The twin of `scripts/extract_gt_vectors.py` (the reference's
`scripts/extract_gt_vectors.py`): each labeled image is decoded once on host
threads, each ground-truth box is padded by `padding` and grown to the best
in-bounds square of at least 160 pixels, the crop is preprocessed, and the
crops are encoded by the image tower of the registry's model on `--device`
(default `cuda`; without a card the command fails unless `--device cpu` is
given) in batches of `batch_size`; the last batch is as short as it is.
Output: <out>/gt_vectors.parquet with dbidx, category, box coords and the
unit-norm vector.
"""
import argparse
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch


def crop_patches(ds, box_table, *, padding: int, target: int,
                 min_side: int = 160, n_threads: int = 8):
    """Decode each labeled image once, crop each gt box as the reference
    does (pad by `padding`, then the best in-bounds SQUARE of at least
    min_side — the reference's `preproc_utils.gt_patch_preprocessor`),
    preprocess to (target, target, 3) float32. Returns (patches,
    row_indices)."""
    import PIL.Image

    from ..box_utils import BoundingBoxBatch, BoxBatch
    from ..models.preprocess import preprocess_image

    by_img = {}
    for i in range(len(box_table)):
        by_img.setdefault(int(box_table.dbidx[i]), []).append(i)

    def one_image(item):
        dbidx, rows = item
        try:
            im = PIL.Image.open(ds.file_path(dbidx)).convert("RGB")
        except Exception as e:  # unreadable image: skip its boxes
            print(f"warning: skipping dbidx={dbidx}: {e!r}")
            return [], []
        W, H = im.size
        xyxy = np.clip(
            box_table.boxes[rows],
            [0, 0, 0, 0], [W, H, W, H],
        ).astype(np.float64)
        bb = BoundingBoxBatch.from_boxbatch(
            BoxBatch.from_xyxy(xyxy), np.full(len(rows), W), np.full(len(rows), H)
        )
        squares = bb.pad(padding).best_square_box(
            min_side=min(min_side, W, H)
        ).to_xyxy()
        patches, kept = [], []
        for i, box in zip(rows, squares):
            crop = im.crop(tuple(box))
            if crop.size[0] < 2 or crop.size[1] < 2:
                continue
            patches.append(preprocess_image(crop, target))
            kept.append(i)
        return patches, kept

    all_patches, all_rows = [], []
    with ThreadPoolExecutor(n_threads) as pool:
        for patches, kept in pool.map(one_image, sorted(by_img.items())):
            all_patches.extend(patches)
            all_rows.extend(kept)
    patches = (np.stack(all_patches) if all_patches
               else np.zeros((0, target, target, 3), np.float32))
    return patches, np.array(all_rows, np.int64)


def encode_batched(embedding, patches: np.ndarray, batch_size: int, *, device) -> np.ndarray:
    """Unit vectors of `patches` through `embedding`'s image tower on
    `device`, `batch_size` crops a call."""
    n = patches.shape[0]
    out = np.empty((n, embedding.dim), dtype=np.float32)
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        batch = torch.from_numpy(patches[lo:hi]).to(device)
        vecs = embedding.encode_image_batch(batch)
        out[lo:hi] = vecs.cpu().numpy() if isinstance(vecs, torch.Tensor) else vecs
    norms = np.maximum(np.linalg.norm(out, axis=1, keepdims=True), 1e-6)
    return out / norms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--root", required=True)
    ap.add_argument("--dataset", required=True)
    ap.add_argument("--model", default="clip-vit-b32")
    ap.add_argument("--output_path", required=True)
    ap.add_argument("--padding", type=int, default=60)
    ap.add_argument("--limit", type=int, default=None)
    ap.add_argument("--batch_size", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA device: pass --device cpu to run on the CPU")

    import pandas as pd

    from ..dataset import GlobalDataManager
    from ..labeldb import BoxTable
    from ..models.registry import load_embedding
    from ..utils.transactional import transactional_folder

    gdm = GlobalDataManager(args.root)
    ds = gdm.get_dataset(args.dataset)
    box_table, _ = ds.load_ground_truth()
    if args.limit:
        keep = box_table.dbidx < args.limit
        box_table = BoxTable(
            dbidx=box_table.dbidx[keep], boxes=box_table.boxes[keep],
            description=[d for d, k in zip(box_table.description, keep) if k],
            marked_accepted=box_table.marked_accepted[keep],
        )

    embedding = load_embedding(args.model, device)
    target = getattr(getattr(embedding, "cfg", None), "image_size", 224)
    patches, rows = crop_patches(ds, box_table, padding=args.padding, target=target)
    vectors = encode_batched(embedding, patches, args.batch_size, device=device)

    df = pd.DataFrame(
        {
            "dbidx": box_table.dbidx[rows],
            "category": [box_table.description[i] for i in rows],
            "x1": box_table.boxes[rows, 0],
            "y1": box_table.boxes[rows, 1],
            "x2": box_table.boxes[rows, 2],
            "y2": box_table.boxes[rows, 3],
            "vectors": list(vectors),
        }
    )
    with transactional_folder(args.output_path, force=True) as tmp:
        df.to_parquet(Path(tmp) / "gt_vectors.parquet")
    print(f"wrote {len(df)} gt vectors to {args.output_path}/gt_vectors.parquet")
    return df


if __name__ == "__main__":
    main()
