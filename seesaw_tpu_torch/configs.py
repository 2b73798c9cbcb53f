"""Config system: method defaults, template merging, grid/random expansion.

The port's own copy of `seesaw_tpu/configs.py`: typed pydantic
SessionParams as the core; python dict method defaults; YAML experiment
files whose variants support `{choose: [...]}` random/grid sampling and
shared-template merging. The server can boot session params from a yaml
variant by name. Only `load_yaml_config` reads a file, and only it imports
`yaml` (PyYAML), so the rest of the port runs where PyYAML is absent.
"""
from __future__ import annotations

import copy
import math
import random
from typing import List, Optional


from .basic_types import SessionParams

_method_configs = {
    "plain": {},
    "random": {},
    "rocchio_update": {
        "rocchio_alpha": 1.0,
        "rocchio_beta": 0.75,
        "rocchio_gamma": 0.25,
    },
    "log_reg2": {
        "reg_lambda": 10.0,
        "scale": "centered",
        "fit_intercept": True,
        "class_weights": "balanced",
        "max_iter": 100,
    },
    "multi_reg": {
        "matrix_options": {"knn_path": "", "knn_k": 8, "edist": 0.1},
        "label_loss_type": "ce_loss",
        "rank_loss_margin": 0.0,
        "pos_weight": "balanced",
        "reg_data_lambda": 0.1,
        "reg_norm_lambda": 10.0,
        "reg_query_lambda": 1.0,
        "max_iter": 100,
        "verbose": False,
    },
    "multi_reg_neg": {
        "reg_norm_lambda": 10.0,
        "reg_query_lambda": 1.0,
        "max_iter": 100,
        "discount_neg": True,
        "verbose": False,
    },
    "knn_prop2": {
        "matrix_options": {"knn_path": "", "knn_k": 5, "edist": 0.1},
        "normalize_scores": True,
        "normalize_epsilon": 0.1,
        "sigmoid_before_propagate": True,
        "calib_a": 10.0,
        "calib_b": -5.0,
        "prior_weight": 1.0,
    },
    "pseudo_lr": {
        "label_prop_params": {
            "matrix_options": {"knn_path": "", "knn_k": 5, "edist": 0.1},
            "normalize_scores": True,
            "normalize_epsilon": 0.1,
            "sigmoid_before_propagate": True,
            "calib_a": 10.0,
            "calib_b": -5.0,
            "prior_weight": 1.0,
        },
        "log_reg_params": {"reg_lambda": 10.0, "max_iter": 100},
        "switch_over": True,
        "real_sample_weight": 5.0,
        "sample_size": 100,
    },
    "active_search": {
        "matrix_options": {"knn_path": "", "knn_k": 5, "edist": 0.1},
        "gamma": {"mode": "fixed", "value": 0.1},
        "reward_horizon": 10,
        "adjust_horizon": False,
        "max_steps": 100,
        "pruning_on": False,
        "implementation": "vectorized",
    },
    "lknn": {
        "matrix_options": {"knn_path": "", "knn_k": 5, "edist": 0.1},
        "gamma": 0.1,
        "use_clip_as_gamma": False,
    },
    "textual": {
        "mode": "linear",
        "image_loss_weight": 0.5,
        "vector_box_min_iou": 0.2,
        "num_warmup_steps": 4,
        "rounds": 4,
        "label_margin": 0.1,
        "rank_margin": 0.1,
    },
}


def get_default_config(method: str) -> Optional[dict]:
    return copy.deepcopy(_method_configs.get(method))


# UI mode-name aliases (reference `configs.py:57-60`: 'default' -> 'plain')
modes = {"default": "plain"}


def make_session_params(mode: str, dataset: str, index: str) -> SessionParams:
    mode = modes.get(mode, mode)
    cfg = get_default_config(mode)
    assert cfg is not None, f"unknown method {mode!r}"
    return SessionParams(
        index_spec={"d_name": dataset, "i_name": index},
        interactive=mode,
        interactive_options=cfg,
        method_config=cfg,
        agg_method="avg_score",
        aug_larger="all",
        shortlist_size=40,
        batch_size=3,
    )


def get_session_params(s_template: dict, config: dict, index_meta: dict) -> SessionParams:
    """Merge shared template + variant + index spec into SessionParams,
    keeping only recognized fields (extra variant keys flow through
    interactive_options untouched)."""
    merged = {**copy.deepcopy(s_template), **copy.deepcopy(config)}
    merged["index_spec"] = {**merged.get("index_spec", {}), **index_meta}
    fields = set(SessionParams.model_fields.keys())
    return SessionParams(**{k: v for k, v in merged.items() if k in fields})


# -- {choose: [...]} expansion ----------------------------------------------
def space_size(base_config: dict) -> int:
    szs = []
    for v in base_config.values():
        if isinstance(v, dict) and set(v.keys()) == {"choose"} and isinstance(v["choose"], list):
            szs.append(len(v["choose"]))
        elif isinstance(v, dict):
            szs.append(space_size(v))
        else:
            szs.append(1)
    return math.prod(szs)


def sample_config(base_config: dict) -> dict:
    cfg = {}
    for k, v in base_config.items():
        if isinstance(v, dict) and set(v.keys()) == {"choose"}:
            cfg[k] = random.choice(v["choose"])
        elif isinstance(v, dict):
            cfg[k] = sample_config(v)
        else:
            cfg[k] = v
    return cfg


def _freeze(obj):
    if isinstance(obj, dict):
        return tuple(sorted((k, _freeze(v)) for k, v in obj.items()))
    if isinstance(obj, list):
        return tuple(_freeze(v) for v in obj)
    return obj


def generate_method_configs(base_config: dict, max_trials: int) -> List[dict]:
    total = space_size(base_config)
    limit = min(max_trials, total)
    seen = {}
    while len(seen) < limit:
        cfg = sample_config(base_config)
        seen[_freeze(cfg)] = cfg
    ans = []
    for i, cfg in enumerate(seen.values()):
        cfg = copy.deepcopy(cfg)
        cfg["sample_id"] = f"sample_{i:02d}" if len(seen) > 1 else None
        ans.append(cfg)
    return ans


def expand_configs(variants: List[dict]) -> List[dict]:
    out = []
    for var in variants:
        out.extend(generate_method_configs(var, max_trials=var.get("max_samples", 1)))
    return out


def load_yaml_config(config_path: str) -> dict:
    import yaml

    with open(config_path) as f:
        return yaml.safe_load(f)


def get_session_params_from_yaml(
    config_name: str,
    dataset: str,
    index: str,
    annotation_category: Optional[str] = None,
    *,
    config_path: str,
) -> SessionParams:
    config = load_yaml_config(config_path)
    s_template = config.get("shared_session_params", {})
    variants = expand_configs(config.get("variants", []))
    matches = [v for v in variants if v.get("name") == config_name]
    assert len(matches) == 1, f"expected exactly one variant named {config_name!r}"
    ans = matches[0]
    index_meta = dict(d_name=dataset, i_name=index, c_name=None)
    params = get_session_params(s_template, ans, index_meta=index_meta)
    params.annotation_category = annotation_category
    return params
