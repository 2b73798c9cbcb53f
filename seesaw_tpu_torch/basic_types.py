"""Wire-protocol and session-state types (pydantic).

The port's own copy of `seesaw_tpu/basic_types.py`, so that the port
imports nothing of the JAX package. The types are the contract between the
session, the loops, the benchmark harness and the web frontend, so they stay
field for field the same as the JAX package's. Index dispatch on the
`info.json` constructor string lives in `indices.loader`.
"""
from __future__ import annotations

from typing import List, Literal, Optional

from pydantic import BaseModel


class Box(BaseModel):
    x1: float
    y1: float
    x2: float
    y2: float
    description: Optional[str] = None
    marked_accepted: bool = False


class Annotation(BaseModel):
    box: Box
    description: Optional[str] = None
    marked_accepted: bool = False


class ActivationData(BaseModel):
    box: Box
    score: float


class Interval(BaseModel):
    start_ms: int
    end_ms: int


class Imdata(BaseModel):
    url: str
    dbidx: int
    # None means unlabeled (neutral); [] means labeled with *no* boxes (negative).
    boxes: Optional[List[Box]] = None
    activations: Optional[List[ActivationData]] = None
    timing: List[Interval] = []


def is_image_accepted(imdata: Imdata) -> bool:
    if imdata.boxes is None:
        return False
    return any(b.marked_accepted for b in imdata.boxes)


class IndexSpec(BaseModel):
    d_name: str
    i_name: str
    # ground-truth category; selects the per-category subset (LVIS benchmark).
    c_name: Optional[str] = None


StartPolicy = Literal[
    "from_start",
    "after_first_batch",
    "after_first_negative",
    "after_first_positive",
    "after_first_positive_and_negative",
    "after_first_reversal",
]


class SessionParams(BaseModel):
    index_spec: IndexSpec
    interactive: str
    pass_ground_truth: Optional[bool] = False  # testing only
    annotation_category: Optional[str] = None
    interactive_options: Optional[dict] = None
    batch_size: int
    index_options: Optional[dict] = {"use_vec_index": True}
    aug_larger: Literal["greater", "adjacent", "all"] = "all"
    agg_method: Optional[Literal["avg_score", "avg_vector", "plain_score"]] = "avg_score"
    aug_weight: Optional[Literal["level_max", "cont_weighted"]] = "level_max"
    shortlist_size: Optional[int] = None
    method_config: Optional[dict] = None
    image_vector_strategy: Optional[Literal["matched", "computed"]] = None
    other_params: Optional[dict] = None
    start_policy: Optional[StartPolicy] = "from_start"


class LogEntry(BaseModel):
    logger: Literal["server", "client"]
    message: str
    time: float
    seen: int
    accepted: int
    other_fields: Optional[dict] = None


class SessionState(BaseModel):
    params: SessionParams
    gdata: List[List[Imdata]]
    timing: List[float]
    reference_categories: List[str]
    query_string: Optional[str] = None
    action_log: List[LogEntry] = []


class BenchParams(BaseModel):
    name: str
    sample_id: Optional[str] = None  # for hparam tuning
    ground_truth_category: str
    qstr: str
    provide_textual_feedback: bool = False
    n_batches: int  # max number of feedback rounds
    max_results: Optional[int] = None  # stop once this many positives found
    max_feedback: Optional[int] = None
    box_drop_prob: float = 0.0
    query_template: str = "a {}"  # CLIP prompt template


class BenchResult(BaseModel):
    nimages: int
    ntotal: int
    session: SessionState
    run_info: dict
    total_time: float
    method_stats: Optional[dict] = None
    latencies: Optional[List[float]] = None


class BenchSummary(BaseModel):
    bench_params: BenchParams
    session_params: SessionParams
    timestamp: str
    output_dir: Optional[str] = None
    result: Optional[BenchResult] = None

