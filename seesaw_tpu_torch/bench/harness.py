"""Simulated-user benchmark harness, over the port's sessions.

Counterpart of `seesaw_tpu/bench/harness.py`, the reference's bench
protocol (`seesaw/seesaw_bench.py:238-452,457-563`) without Ray:
`fill_imdata` plays the labeler from ground-truth boxes, `benchmark_loop`
drives a full session (set_text -> next -> label -> update_state -> refine)
with the same stopping rules (n_batches, max_results, max_feedback,
no-repeat assertion), and `BenchRunner` wraps one (BenchParams,
SessionParams) run into a session output directory with summary.json. Its
sessions open through the port's `make_session` on the runner's `device`.
`summary.json` keeps the pydantic schema of `BenchSummary`, field for field
the JAX package's, so each package reads the other's results. Parallelism
across configs is a process pool (`bench.run_bench`).
"""
from __future__ import annotations

import copy
import json
import os
import random
import string
import sys
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path
from typing import List

import numpy as np
import torch

from ..basic_types import (
    BenchParams,
    BenchResult,
    BenchSummary,
    Box,
    Imdata,
    SessionParams,
    is_image_accepted,
)
from ..dataset import GlobalDataManager
from ..labeldb import BoxTable
from ..runtime.bitmap import BitMap, FrozenBitMap
from ..session import Session, make_session
from .search_terms import category2query

# ObjectNet confusion-class pairs for textual-feedback benchmarks — the
# hand-curated near-miss category per target (reference `seesaw_bench.py:
# 186-235` objnet_dict; benchmark protocol data). Callers may extend/override.
CONFUSION_CLASSES: dict = {
    "measuring cup": "drinking cup",
    "nut for a screw": "screw",
    "toy": "weight (exercise)",
    "tablecloth": "blanket",
    "skirt": "shorts",
    "can opener": "canned food",
    "document folder (closed)": "binder (closed)",
    "coffee grinder": "coffee machine",
    "nail (fastener)": "screw",
    "tape measure": "ruler",
    "power bar": "chocolate",
    "table knife": "butcher's knife",
    "spray bottle": "glue container",
    "nightstand": "drawer (open)",
    "laptop charger": "cellphone charger",
    "pillow": "throw pillow",
    "soap dispenser": "mouthwash",
    "portable heater": "fan",
    "tongs": "wrench",
    "dishrag or hand towel": "tablecloth",
    "squeegee": "dust pan",
    "letter opener": "table knife",
    "eraser (white board)": "floss container",
    "air freshener": "deodorant",
    "power cable": "usb cable",
    "bread knife": "butcher's knife",
    "hairclip": "comb",
    "scrub brush": "hair brush",
    "mixing / salad bowl": "plate",
    "drinking cup": "wine glass",
    "multitool": "wrench",
    "placemat": "napkin",
    "removable blade": "table knife",
    "sugar container": "salt shaker",
    "travel case": "suitcase",
    "tarp": "trash bag",
    "cellphone": "phone (landline)",
    "flour container": "sugar container",
    "peeler": "razor",
    "water filter": "bucket",
    "blouse": "dress shirt",
    "night light": "light bulb",
    "trash bin": "clothes hamper",
    "squeeze bottle": "water bottle",
    "extension cable": "usb cable",
    "bookend": "book (closed)",
    "flashlight": "air freshener",
    "monitor": "tv",
    "coffee table": "tablet / ipad",
    "bottle stopper": "chess piece",
}


def fill_imdata(imdata: Imdata, box_table: BoxTable, b: BenchParams) -> Imdata:
    """Simulate the user labeling one image from ground truth: positives =
    gt boxes of the target category (marked accepted); with textual feedback,
    the confusion class's boxes are added as rejected boxes with their
    description."""
    imdata = imdata.model_copy()
    sel = box_table.dbidx == imdata.dbidx
    boxes: List[Box] = []
    if sel.any():
        rows = np.where(sel)[0]
        for i in rows:
            desc = box_table.description[i] if box_table.description else None
            accepted = bool(box_table.marked_accepted[i])
            if b.box_drop_prob > 0 and random.random() < b.box_drop_prob:
                continue
            boxes.append(
                Box(
                    x1=float(box_table.boxes[i, 0]),
                    y1=float(box_table.boxes[i, 1]),
                    x2=float(box_table.boxes[i, 2]),
                    y2=float(box_table.boxes[i, 3]),
                    description=desc,
                    marked_accepted=accepted,
                )
            )
    imdata.boxes = boxes
    return imdata


def _feedback_table(box_table: BoxTable, b: BenchParams, annotation_fun) -> BoxTable:
    """Restrict gt boxes to what the simulated user would draw: target
    category accepted; confusion category (textual feedback mode) rejected."""
    target = b.ground_truth_category
    confusion = CONFUSION_CLASSES.get(target) if b.provide_textual_feedback else None

    keep, accepted, descs = [], [], []
    for i, cat in enumerate(box_table.description):
        if cat == target:
            keep.append(i)
            accepted.append(True)
            descs.append(annotation_fun(cat))
        elif confusion is not None and cat == confusion:
            keep.append(i)
            accepted.append(False)
            descs.append(annotation_fun(cat))
    keep = np.array(keep, dtype=np.int64)
    return BoxTable(
        dbidx=box_table.dbidx[keep] if len(keep) else np.zeros(0, np.int32),
        boxes=box_table.boxes[keep] if len(keep) else np.zeros((0, 4), np.float32),
        description=descs,
        marked_accepted=np.array(accepted, dtype=bool),
    )


def benchmark_loop(
    *,
    session: Session,
    subset: FrozenBitMap,
    box_table: BoxTable,
    b: BenchParams,
    p: SessionParams,
) -> dict:
    def annotation_fun(cat: str) -> str:
        term = category2query(p.index_spec.d_name, cat)
        return b.query_template.format(term)

    feedback = _feedback_table(box_table, b, annotation_fun)
    positives = FrozenBitMap(
        feedback.dbidx[feedback.marked_accepted]
        if len(feedback)
        else []
    )
    assert positives.intersection(subset) == BitMap(positives.to_array()), "index mismatch"

    max_results = (
        min(len(positives), b.max_results) if b.max_results is not None else len(positives)
    )

    total_results = 0
    total_seen = 0
    seen_dbidxs = BitMap()

    session.set_text(b.qstr)
    latencies: List[float] = []
    for batch_num in range(1, b.n_batches + 1):
        start_time = time.time()
        idxbatch = np.asarray(session.next())

        for idx in idxbatch:
            assert int(idx) in subset, "returned a dbidx outside the subset"
            assert int(idx) not in seen_dbidxs, "returned a repeated dbidx"
            seen_dbidxs.add(int(idx))

        if len(idxbatch) == 0:
            break

        s = copy.deepcopy(session.get_state())
        last_batch = s.gdata[-1]
        for j, imdata in enumerate(last_batch):
            last_batch[j] = fill_imdata(imdata, feedback, b)

        session.update_state(s)
        batch_pos = np.array([is_image_accepted(imdata) for imdata in last_batch])
        total_results += int(batch_pos.sum())
        total_seen += int(idxbatch.shape[0])

        if total_results >= max_results:
            break
        if batch_num == b.n_batches:
            break
        if b.max_feedback is None or (batch_num + 1) * p.batch_size <= b.max_feedback:
            session.refine()
            latencies.append(time.time() - start_time)

    return dict(nfound=int(total_results), nseen=int(total_seen), latencies=latencies)


class BenchRunner:
    def __init__(
        self,
        seesaw_root: str,
        results_dir: str,
        redirect_output: bool = True,
        *,
        device,
    ):
        """Sessions load their index onto `device` (one copy per process and
        device, through the loader's cache)."""
        assert os.path.isdir(results_dir)
        self.device = torch.device(device)
        self.gdm = GlobalDataManager(seesaw_root)
        self.results_dir = results_dir
        random.seed(int(f"{time.time_ns()}{os.getpid()}"))
        self.redirect_output = redirect_output

    def ready(self) -> bool:
        return True

    def run_loop(self, b: BenchParams, p: SessionParams) -> str:
        start = time.time()
        suffix = "".join(random.choice(string.ascii_lowercase) for _ in range(10))
        timestamp = time.strftime("%Y%m%d-%H%M%S")
        output_dir = f"{self.results_dir}/session_{timestamp}_{suffix}"
        os.mkdir(output_dir)
        summary = BenchSummary(
            bench_params=b,
            output_dir=output_dir,
            session_params=p,
            timestamp=timestamp,
            result=None,
        )
        output_path = f"{output_dir}/summary.json"

        def closure():
            json.dump(summary.model_dump(), open(output_path, "w"), indent=3)
            ret = make_session(self.gdm, p, b=b, device=self.device)
            ds = ret["dataset"]
            box_table, qgt = ds.load_ground_truth()
            gtseries = qgt[b.ground_truth_category]

            run_info = benchmark_loop(
                session=ret["session"],
                box_table=box_table,
                subset=FrozenBitMap(ds.dbidxs if hasattr(ds, "dbidxs") else
                                    np.arange(ds.size())),
                b=b,
                p=p,
            )
            latencies = run_info.pop("latencies")
            session = ret["session"]
            summary.result = BenchResult(
                ntotal=int((np.asarray(gtseries) > 0).sum()),
                nimages=int(np.asarray(gtseries).shape[0]),
                session=session.get_state(),
                run_info=run_info,
                method_stats=session.get_method_stats(),
                total_time=time.time() - start,
                latencies=latencies,
            )
            json.dump(summary.model_dump(), open(output_path, "w"), indent=3)

        if self.redirect_output:
            with open(f"{output_dir}/output.log", "w") as log:
                with redirect_stdout(log), redirect_stderr(log):
                    try:
                        closure()
                    except Exception as e:
                        print(f"exception={e!r}", file=sys.stderr)
                        raise
        else:
            closure()
        return output_dir


def summarize_session(res: BenchResult) -> dict:
    """Flatten one session into hit positions + counters (reference
    `seesaw_bench.py:457-483`)."""
    curr_idx = 0
    hit_indices, dbidxs, accepted = [], [], []
    for batch in res.session.gdata:
        for imdata in batch:
            dbidxs.append(imdata.dbidx)
            acc = is_image_accepted(imdata)
            accepted.append(acc)
            if acc:
                hit_indices.append(curr_idx)
            curr_idx += 1
    return dict(
        hit_indices=np.array(hit_indices, dtype=np.int32),
        dbidxs=np.array(dbidxs, dtype=np.int32),
        accepted=np.array(accepted, dtype=np.int32),
        nseen=curr_idx,
        nimages=res.nimages,
        ntotal=res.ntotal,
        total_time=res.total_time,
        method_stats=res.method_stats,
        latencies=res.latencies,
    )


def process_single_result(result_path: str) -> dict:
    obj = json.loads(open(f"{result_path}/summary.json").read())
    bs = BenchSummary(**obj)
    b, s = bs.bench_params, bs.session_params
    res = dict(
        dataset=s.index_spec.d_name,
        index_name=s.index_spec.i_name,
        subset_name=s.index_spec.c_name,
        category=b.ground_truth_category,
        variant=b.name,
        sample_id=b.sample_id,
        n_batches=b.n_batches,
        batch_size=s.batch_size,
        max_results=b.max_results,
        session_params=s.model_dump_json(),
        bench_params=b.model_dump_json(),
        has_result=bs.result is not None,
        session_path=result_path,
    )
    if bs.result is not None:
        res.update(summarize_session(bs.result))
    return res


def get_all_session_summaries(base_dir: str, force_recompute: bool = False):
    """All sessions under base_dir as a dataframe (cached to parquet)."""
    import pandas as pd

    sumpath = f"{base_dir}/summary.parquet"
    if os.path.exists(sumpath) and not force_recompute:
        return pd.read_parquet(sumpath)
    rows = []
    for p in Path(base_dir).glob("**/summary.json"):
        try:
            rows.append(process_single_result(str(p.parent)))
        except Exception as e:
            print(f"skipping {p}: {e!r}")
    df = pd.DataFrame(rows)
    # parquet stores the per-session arrays as list columns (pyarrow);
    # dropping them would make the CACHED load unusable for add_metrics
    # (hit_indices drives every ranking metric). Only method_stats (free-form
    # dict) is json-encoded.
    flat = df.copy()
    for c in ("hit_indices", "dbidxs", "accepted", "latencies"):
        if c in flat.columns:
            flat[c] = flat[c].apply(
                lambda a: None if not isinstance(a, (list, np.ndarray))
                else np.asarray(a).tolist()
            )
    if "method_stats" in flat.columns:
        flat["method_stats"] = flat["method_stats"].apply(
            lambda m: json.dumps(m) if isinstance(m, dict) else None
        )
    try:
        flat.to_parquet(sumpath)
    except Exception:
        pass
    return df
