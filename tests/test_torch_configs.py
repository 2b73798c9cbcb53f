"""The port's copy of the config system (`seesaw_tpu_torch.configs`)
against `seesaw_tpu.configs`: method defaults, template merging, yaml
variants and `{choose: [...]}` expansion give equal SessionParams and
configs (sampling from the same seed of the global `random` stream)."""
import random

import pytest
import yaml

from seesaw_tpu import configs as jc
from seesaw_tpu_torch import configs as tc

BASE = {
    "a": {"choose": [1, 2, 3]},
    "b": "fixed",
    "nested": {"c": {"choose": [True, False]}, "d": {"choose": ["x", "y", "z"]}},
}
VARIANTS = [
    {"name": "plain_v", "interactive": "plain", "index_name": "multiscale"},
    {"name": "rocchio_v", "interactive": "rocchio_update", "index_name": "multiscale",
     "rocchio_alpha": 1.0, "rocchio_beta": {"choose": [0.5, 0.7, 0.9]},
     "rocchio_gamma": {"choose": [0.1, 0.2]}, "max_samples": 4},
    {"name": "co_plain", "interactive": "plain", "agg_method": "avg_score",
     "index_options": {"coalesce_ms": 25}},
]


def _dump(p):
    return p.model_dump()


@pytest.mark.parametrize("mode", sorted(jc._method_configs) + ["default"])
def test_make_session_params(mode):
    assert _dump(tc.make_session_params(mode, "d", "i")) == \
        _dump(jc.make_session_params(mode, "d", "i"))


def test_get_session_params_merge():
    args = ({"batch_size": 3, "shortlist_size": 40},
            {"interactive": "plain", "agg_method": "avg_vector", "unknown_key": 1},
            {"d_name": "ds", "i_name": "idx", "c_name": None})
    assert _dump(tc.get_session_params(*args)) == _dump(jc.get_session_params(*args))


def test_sample_and_expand_with_one_seed():
    assert tc.space_size(BASE) == jc.space_size(BASE) == 18
    for seed in range(3):
        random.seed(seed)
        want = [jc.sample_config(BASE) for _ in range(5)]
        random.seed(seed)
        got = [tc.sample_config(BASE) for _ in range(5)]
        assert got == want
    random.seed(7)
    want = jc.expand_configs(VARIANTS)
    random.seed(7)
    got = tc.expand_configs(VARIANTS)
    assert got == want and sum(v["name"] == "rocchio_v" for v in got) == 4
    random.seed(3)
    want = jc.generate_method_configs(BASE, max_trials=100)
    random.seed(3)
    assert tc.generate_method_configs(BASE, max_trials=100) == want


@pytest.mark.parametrize("name", ["plain_v", "co_plain"])
def test_session_params_from_yaml(tmp_path, name):
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump({
        "shared_session_params": {"batch_size": 2, "shortlist_size": 15},
        "variants": VARIANTS,
    }))
    kw = dict(config_path=str(path))
    random.seed(0)
    want = jc.get_session_params_from_yaml(name, "synth", "multiscale", "dog", **kw)
    random.seed(0)
    got = tc.get_session_params_from_yaml(name, "synth", "multiscale", "dog", **kw)
    assert _dump(got) == _dump(want)
    assert got.annotation_category == "dog" and got.batch_size == 2


def test_only_the_file_reader_imports_yaml():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(tc))
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any("yaml" in ast.dump(n) for n in top)
