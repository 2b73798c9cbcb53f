"""Dataset layer: on-disk image datasets, ground truth, subsets.

The port's own copy of `seesaw_tpu/dataset.py`. Layout:

    <dataset>/
      file_meta.parquet          # file_path per dbidx (row ordinal)
      images/                    # image files (symlink or dir)
      ground_truth/
        box_data.parquet         # dbidx, x1,y1,x2,y2, category
        qgt.parquet              # wide 0/1/NaN matrix: row=dbidx, col=category
      indices/<index_name>/      # saved index artifacts (info.json, ...)
      subsets/<name>/            # named subset datasets (meta.json -> parent)

Subsets are views over the parent: original dbidx values are preserved; the
subset's index is the parent index restricted to member images. Indices load
through the port's loader (`indices.loader.load_index`) onto an explicit
device.
"""
from __future__ import annotations

import json
import os
from pathlib import Path
from typing import List, Optional

import numpy as np
import pandas as pd

from .indices.interface import AccessMethod
from .labeldb import BoxTable
from .runtime.bitmap import BitMap, FrozenBitMap
from .utils.transactional import transactional_folder

IMAGE_EXTENSIONS = (".jpg", ".jpeg", ".png", ".gif", ".webp", ".bmp")


def list_image_paths(image_dir: str) -> List[str]:
    out = []
    for root, _dirs, files in os.walk(image_dir, followlinks=True):
        for f in files:
            if f.lower().endswith(IMAGE_EXTENSIONS):
                full = os.path.join(root, f)
                out.append(os.path.relpath(full, image_dir))
    return sorted(out)


def infer_qgt_from_boxes(box_table: BoxTable, categories: List[str], num_files: int) -> pd.DataFrame:
    """0/1 matrix (num_files x categories) from box presence."""
    qgt = pd.DataFrame(
        np.zeros((num_files, len(categories)), dtype=np.float32), columns=categories
    )
    for cat in categories:
        sel = [d for d, desc in zip(box_table.dbidx, box_table.description) if desc == cat]
        if sel:
            qgt.loc[np.unique(sel), cat] = 1.0
    return qgt


class SeesawDataset:
    def __init__(self, dataset_path: str):
        self.path = str(Path(dataset_path).resolve())
        self.dataset_name = os.path.basename(self.path)
        file_meta = pd.read_parquet(f"{self.path}/file_meta.parquet")
        self.file_meta = file_meta
        self.paths = file_meta["file_path"].values
        self.dbidxs = (
            file_meta["dbidx"].values.astype(np.int64)
            if "dbidx" in file_meta.columns
            else np.arange(len(self.paths), dtype=np.int64)
        )
        self._path_by_dbidx = dict(zip(self.dbidxs.tolist(), self.paths.tolist()))
        self.image_root = os.path.realpath(f"{self.path}/images")

    # -- construction ------------------------------------------------------
    @staticmethod
    def create(
        output_path: str,
        image_src: Optional[str] = None,
        paths: Optional[List[str]] = None,
        force: bool = False,
    ) -> "SeesawDataset":
        with transactional_folder(output_path, force=force) as tmp:
            if image_src is not None:
                image_src = str(Path(image_src).resolve())
                os.symlink(image_src, f"{tmp}/images")
                if not paths:
                    paths = list_image_paths(image_src)
            else:
                os.makedirs(f"{tmp}/images", exist_ok=True)
                paths = paths or []
            df = pd.DataFrame(
                {"dbidx": np.arange(len(paths), dtype=np.int64), "file_path": paths}
            )
            df.to_parquet(f"{tmp}/file_meta.parquet")
        return SeesawDataset(output_path)

    def size(self) -> int:
        return len(self.paths)

    def __repr__(self):
        return f"{type(self).__name__}({self.dataset_name}, n={self.size()})"

    # -- urls / files ------------------------------------------------------
    def get_urls(self, idxbatch) -> List[str]:
        return [
            os.path.normpath(f"/{self.image_root}/{self._path_by_dbidx[int(i)]}")
            for i in idxbatch
        ]

    def file_path(self, dbidx: int) -> str:
        return os.path.join(self.image_root, self._path_by_dbidx[int(dbidx)])

    # -- indices -----------------------------------------------------------
    def index_path(self, index_name: str) -> str:
        return f"{self.path}/indices/{index_name}"

    def list_indices(self) -> List[str]:
        p = Path(f"{self.path}/indices")
        return sorted(x.name for x in p.iterdir()) if p.exists() else []

    def load_index(self, index_name: str, *, device,
                   options: Optional[dict] = None) -> AccessMethod:
        from .indices.loader import load_index

        return load_index(self.index_path(index_name), device=device, options=options)

    # -- ground truth ------------------------------------------------------
    def ground_truth_path(self) -> str:
        return f"{self.path}/ground_truth"

    def save_ground_truth(self, box_table: BoxTable, qgt: Optional[pd.DataFrame] = None):
        gt = Path(self.ground_truth_path())
        gt.mkdir(parents=True, exist_ok=True)
        df = pd.DataFrame(
            {
                "dbidx": box_table.dbidx,
                "x1": box_table.boxes[:, 0],
                "y1": box_table.boxes[:, 1],
                "x2": box_table.boxes[:, 2],
                "y2": box_table.boxes[:, 3],
                "category": box_table.description,
            }
        )
        df.to_parquet(gt / "box_data.parquet")
        if qgt is None:
            cats = sorted(set(d for d in box_table.description if d is not None))
            qgt = infer_qgt_from_boxes(box_table, cats, self.size())
        assert qgt.shape[0] == self.size()
        qgt.to_parquet(gt / "qgt.parquet")

    def load_ground_truth(self) -> tuple[BoxTable, pd.DataFrame]:
        gt = Path(self.ground_truth_path())
        df = pd.read_parquet(gt / "box_data.parquet")
        table = BoxTable(
            dbidx=df["dbidx"].values.astype(np.int32),
            boxes=df[["x1", "y1", "x2", "y2"]].values.astype(np.float32),
            description=df["category"].astype(object).tolist(),
            marked_accepted=np.ones(len(df), dtype=bool),
        )
        return table, self.load_qgt()

    def load_qgt(self) -> pd.DataFrame:
        return pd.read_parquet(Path(self.ground_truth_path()) / "qgt.parquet")

    def load_eval_categories(self) -> List[str]:
        cats_file = Path(self.ground_truth_path()) / "categories.json"
        if cats_file.exists():
            return json.loads(cats_file.read_text())
        return list(self.load_qgt().columns)

    def load_ground_truth_boxes(self, category: str) -> BoxTable:
        table, _ = self.load_ground_truth()
        keep = np.array([d == category for d in table.description], dtype=bool)
        return BoxTable(
            dbidx=table.dbidx[keep],
            boxes=table.boxes[keep],
            description=[d for d, k in zip(table.description, keep) if k],
            marked_accepted=table.marked_accepted[keep],
        )

    # -- subsets -----------------------------------------------------------
    def create_named_subset(self, subset_name: str, dbidxs) -> "SeesawDatasetSubset":
        subset_path = f"{self.path}/subsets/{subset_name}"
        members = FrozenBitMap(dbidxs)
        with transactional_folder(subset_path) as tmp:
            json.dump({"parent": self.path}, open(f"{tmp}/meta.json", "w"))
            mask = members.contains_many(self.dbidxs.astype(np.uint32))
            sub = self.file_meta[mask]
            assert len(sub) > 0
            sub.to_parquet(f"{tmp}/file_meta.parquet")
        return self.load_subset(subset_name)

    def load_subset(self, subset_name: str) -> "SeesawDatasetSubset":
        return SeesawDatasetSubset(self, f"{self.path}/subsets/{subset_name}")

    def leave_one_out(self, excluded_dbidx: int) -> "LeaveOneOutSubset":
        return LeaveOneOutSubset(self, excluded_dbidx)


class SeesawDatasetSubset:
    """A dbidx-preserving view over a parent dataset (reference
    `dataset.py:379-435`). Indices are the parent's restricted to members."""

    def __init__(self, parent: SeesawDataset, path: str):
        self.parent = parent
        self.path = str(Path(path).resolve())
        self.dataset_name = f"{parent.dataset_name}/{os.path.basename(path)}"
        file_meta = pd.read_parquet(f"{self.path}/file_meta.parquet")
        self.file_meta = file_meta
        self.paths = file_meta["file_path"].values
        self.dbidxs = file_meta["dbidx"].values.astype(np.int64)
        self.members = FrozenBitMap(self.dbidxs)
        self.image_root = parent.image_root

    def size(self) -> int:
        return len(self.paths)

    def get_urls(self, idxbatch):
        return self.parent.get_urls(idxbatch)

    def file_path(self, dbidx: int) -> str:
        return self.parent.file_path(dbidx)

    def load_index(self, index_name: str, *, device,
                   options: Optional[dict] = None) -> AccessMethod:
        full = self.parent.load_index(index_name, device=device, options=options)
        return full.subset(BitMap(self.dbidxs))

    def load_ground_truth(self):
        table, qgt = self.parent.load_ground_truth()
        mask = self.members.contains_many(table.dbidx.astype(np.uint32))
        sub_table = BoxTable(
            dbidx=table.dbidx[mask],
            boxes=table.boxes[mask],
            description=[d for d, k in zip(table.description, mask) if k],
            marked_accepted=table.marked_accepted[mask],
        )
        return sub_table, qgt.loc[self.dbidxs]

    def load_qgt(self) -> pd.DataFrame:
        return self.parent.load_qgt().loc[self.dbidxs]

    def load_ground_truth_boxes(self, category: str) -> BoxTable:
        table = self.parent.load_ground_truth_boxes(category)
        mask = self.members.contains_many(table.dbidx.astype(np.uint32))
        return BoxTable(
            dbidx=table.dbidx[mask],
            boxes=table.boxes[mask],
            description=[d for d, k in zip(table.description, mask) if k],
            marked_accepted=table.marked_accepted[mask],
        )

    def load_subset(self, subset_name: str):
        raise NotImplementedError("nested subsets not supported")


class LeaveOneOutSubset:
    """All of the parent dataset except one image (reference
    `dataset.py:438-469`): used by analysis flows that score a query image
    against a database that must not contain it."""

    def __init__(self, parent: SeesawDataset, excluded_dbidx: int):
        self.parent = parent
        self.excluded_dbidx = int(excluded_dbidx)
        self.image_root = parent.image_root
        keep = parent.dbidxs != self.excluded_dbidx
        self.file_meta = parent.file_meta[keep]
        self.paths = parent.paths[keep]
        self.dbidxs = parent.dbidxs[keep]
        self.dataset_name = f"{parent.dataset_name}/loo_{self.excluded_dbidx}"

    def size(self) -> int:
        return len(self.dbidxs)

    def list_indices(self):
        return self.parent.list_indices()

    def get_urls(self, idxbatch):
        return self.parent.get_urls(idxbatch)

    def file_path(self, dbidx: int) -> str:
        return self.parent.file_path(dbidx)

    def load_index(self, index_name: str, *, device,
                   options: Optional[dict] = None) -> AccessMethod:
        full = self.parent.load_index(index_name, device=device, options=options)
        return full.subset(BitMap(self.dbidxs))

    def load_ground_truth(self):
        table, qgt = self.parent.load_ground_truth()
        keep = table.dbidx != self.excluded_dbidx
        sub_table = BoxTable(
            dbidx=table.dbidx[keep],
            boxes=table.boxes[keep],
            description=[d for d, k in zip(table.description, keep) if k],
            marked_accepted=table.marked_accepted[keep],
        )
        return sub_table, qgt.loc[self.dbidxs]

    def load_subset(self, subset_name: str):
        raise NotImplementedError("nested subsets not supported")


class GlobalDataManager:
    """Root directory manager: <root>/data/<dataset>, <root>/models/<model>
    (reference `dataset_manager.py:6-35`)."""

    def __init__(self, root: str):
        self.root = str(Path(root).resolve())
        self.data_root = f"{self.root}/data"
        self.model_root = f"{self.root}/models"
        for p in (self.data_root, self.model_root):
            Path(p).mkdir(parents=True, exist_ok=True)

    def list_datasets(self) -> List[str]:
        return sorted(
            x.name for x in Path(self.data_root).iterdir() if x.is_dir()
        )

    def get_dataset(self, name: str) -> SeesawDataset:
        return SeesawDataset(f"{self.data_root}/{name}")

    def create_dataset(self, name: str, image_src=None, paths=None, force=False) -> SeesawDataset:
        return SeesawDataset.create(
            f"{self.data_root}/{name}", image_src=image_src, paths=paths, force=force
        )

    def get_model_path(self, name: str) -> str:
        return f"{self.model_root}/{name}"
