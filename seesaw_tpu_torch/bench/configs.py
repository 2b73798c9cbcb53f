"""Benchmark config product: yaml variants x datasets x categories.

The port's own copy of `seesaw_tpu/bench/configs.py`, over the port's
`configs` and `dataset`. Mirrors the reference's generator
(`seesaw/seesaw_bench.py:620-684`): for every dataset's evaluation category
and every expanded variant, build the (BenchParams, SessionParams) pair;
lvis-style per-category subsets flow through index_spec.c_name.
"""
from __future__ import annotations

import hashlib
import math
from typing import List, Tuple

from ..basic_types import BenchParams, SessionParams
from ..configs import get_session_params
from ..dataset import GlobalDataManager
from .search_terms import category2query


def get_bench_params(b_template: dict, name, sample_id, dataset, category) -> BenchParams:
    term = category2query(dataset, category)
    qstr = b_template.get("query_template", "a {}").format(term)
    return BenchParams(
        **{
            **b_template,
            "qstr": qstr,
            "ground_truth_category": category,
            "name": name,
            "sample_id": sample_id,
        }
    )


def get_param_hash(payload: str) -> str:
    return hashlib.sha256(payload.encode()).hexdigest()[:16]


def generate_benchmark_configs(
    gdm: GlobalDataManager,
    datasets,
    base_configs: List[dict],
    s_template: dict,
    b_template: dict,
    max_classes_per_dataset: float = math.inf,
) -> List[Tuple[BenchParams, SessionParams]]:
    ans = []
    avail = set(gdm.list_datasets())
    for ddict in datasets:
        if isinstance(ddict, dict):
            dataset_name = ddict["name"]
            cats = ddict.get("categories", [])
            default_c_name = ddict.get("subset", None)
        else:
            dataset_name, cats, default_c_name = ddict, [], None

        assert dataset_name in avail, f"dataset {dataset_name!r} not found"
        ds = gdm.get_dataset(dataset_name)
        classes = ds.load_eval_categories()
        if not cats:
            cats = classes

        for i, category in enumerate(cats):
            assert category in classes
            if i == max_classes_per_dataset:
                break
            for config in base_configs:
                c_name = (
                    default_c_name
                    if default_c_name is not None
                    else (category if dataset_name == "lvis" else None)
                )
                index_meta = dict(
                    d_name=dataset_name,
                    i_name=config.get("index_name", s_template.get("index_name", "multiscale")),
                    c_name=c_name,
                )
                s = get_session_params(s_template, config=config, index_meta=index_meta)
                if s.interactive_options is None:
                    # variant keys beyond SessionParams fields become the
                    # method options (yaml flattens them at variant level)
                    extra = {
                        k: v for k, v in config.items()
                        if k not in SessionParams.model_fields
                        and k not in ("name", "sample_id", "index_name", "max_samples")
                    }
                    from ..configs import get_default_config

                    base = get_default_config(s.interactive) or {}
                    base.update(extra)
                    s.interactive_options = base
                b = get_bench_params(
                    b_template,
                    name=config["name"],
                    sample_id=config.get("sample_id"),
                    dataset=dataset_name,
                    category=category,
                )
                ans.append((b, s))
    return ans
