"""The port's bench harness (`seesaw_tpu_torch.bench`) and its copies of
`metrics`, `analysis` and `user_analysis`, held against the JAX package on
the CPU.

One synthetic root (tests/synth.py) serves both packages; each side opens
its sessions through its own `make_session` (the JAX side with
`use_pallas`, so its scan runs the Pallas kernel in interpret mode).

Tolerances: run_info, dbidxs round by round, hit indices and every
summary column equal (the sessions are the same: tests/test_torch_session.py
holds their scores); the copies' tables exactly equal (the same numpy and
pandas code on the same frames).
"""
import json
import math
import random
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synth import CATEGORY, QSTR, build_synthetic_root  # noqa: E402
from test_analysis import _fake_session, _stats_frame  # noqa: E402

import seesaw_tpu.analysis as j_analysis  # noqa: E402
import seesaw_tpu.basic_types as jbt  # noqa: E402
import seesaw_tpu.bench.configs as j_bconf  # noqa: E402
import seesaw_tpu.bench.harness as j_harness  # noqa: E402
import seesaw_tpu.bench.search_terms as j_terms  # noqa: E402
import seesaw_tpu.configs as j_configs  # noqa: E402
import seesaw_tpu.metrics as j_metrics  # noqa: E402
import seesaw_tpu.user_analysis as j_user  # noqa: E402
import seesaw_tpu_torch.analysis as t_analysis  # noqa: E402
import seesaw_tpu_torch.basic_types as tbt  # noqa: E402
import seesaw_tpu_torch.bench.configs as t_bconf  # noqa: E402
import seesaw_tpu_torch.bench.harness as t_harness  # noqa: E402
import seesaw_tpu_torch.bench.search_terms as t_terms  # noqa: E402
import seesaw_tpu_torch.configs as t_configs  # noqa: E402
import seesaw_tpu_torch.metrics as t_metrics  # noqa: E402
import seesaw_tpu_torch.user_analysis as t_user  # noqa: E402
from seesaw_tpu.dataset import GlobalDataManager as JaxGDM  # noqa: E402
from seesaw_tpu.runtime.bitmap import FrozenBitMap as JFrozen  # noqa: E402
from seesaw_tpu.session import make_session as jax_make_session  # noqa: E402
from seesaw_tpu_torch.dataset import GlobalDataManager as TorchGDM  # noqa: E402
from seesaw_tpu_torch.runtime.bitmap import FrozenBitMap as TFrozen  # noqa: E402
from seesaw_tpu_torch.session import make_session as torch_make_session  # noqa: E402

OPTIONS = {
    "plain": {},
    "log_reg2": dict(class_weights="balanced", scale="centered", reg_lambda=5.0,
                     fit_intercept=False, max_iter=50),
    "knn_prop2": dict(matrix_options=dict(knn_path="", knn_k=5, edist=0.5),
                      normalize_scores=True, normalize_epsilon=0.1,
                      sigmoid_before_propagate=True, calib_a=2.0, calib_b=-0.5,
                      prior_weight=1.0),
}
SUMMARY_ARRAYS = ("hit_indices", "dbidxs", "accepted")
SUMMARY_SCALARS = ("dataset", "index_name", "subset_name", "category", "variant",
                   "n_batches", "batch_size", "max_results", "has_result", "nseen",
                   "nimages", "ntotal")


@pytest.fixture(autouse=True)
def _interpret_attention(monkeypatch):
    monkeypatch.setenv("SEESAW_FUSED_ATTN_INTERPRET", "1")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("bench_root")
    build_synthetic_root(str(r))
    return str(r)


def _params(bt, method, n_batches=8):
    p = bt.SessionParams(
        index_spec=bt.IndexSpec(d_name="synth", i_name="multiscale"),
        interactive=method, batch_size=3, shortlist_size=20,
        interactive_options=OPTIONS[method], index_options={"use_pallas": True},
    )
    b = bt.BenchParams(name=method, ground_truth_category=CATEGORY, qstr=QSTR,
                       n_batches=n_batches, max_results=10)
    return b, p


def _benchmark_loop(side, root, method):
    if side == "jax":
        bt, harness, frozen = jbt, j_harness, JFrozen
        b, p = _params(bt, method)
        ret = jax_make_session(JaxGDM(root), p, b=b)
    else:
        bt, harness, frozen = tbt, t_harness, TFrozen
        b, p = _params(bt, method)
        ret = torch_make_session(TorchGDM(root), p, b=b, device="cpu")
    ds, session = ret["dataset"], ret["session"]
    box_table, _ = ds.load_ground_truth()
    run_info = harness.benchmark_loop(session=session, subset=frozen(ds.dbidxs),
                                      box_table=box_table, b=b, p=p)
    rounds = [[im.dbidx for im in batch] for batch in session.get_state().gdata]
    return run_info, rounds


@pytest.mark.parametrize("method", ["plain", "log_reg2", "knn_prop2"])
def test_benchmark_loop_matches_jax(root, method):
    want_info, want_rounds = _benchmark_loop("jax", root, method)
    got_info, got_rounds = _benchmark_loop("torch", root, method)
    assert got_rounds == want_rounds
    assert (got_info["nfound"], got_info["nseen"]) == (want_info["nfound"], want_info["nseen"])
    assert len(got_info["latencies"]) == len(want_info["latencies"])
    assert want_info["nfound"] > 0


@pytest.fixture(scope="module")
def results(root, tmp_path_factory):
    """One results directory per package, each with a `plain` and a
    `log_reg2` BenchRunner session."""
    out = {}
    for side in ("jax", "torch"):
        d = tmp_path_factory.mktemp(f"bench_results_{side}")
        if side == "jax":
            runner, bt = j_harness.BenchRunner(root, str(d), redirect_output=True), jbt
        else:
            runner, bt = t_harness.BenchRunner(root, str(d), redirect_output=True,
                                               device="cpu"), tbt
        for method in ("plain", "log_reg2"):
            runner.run_loop(*_params(bt, method))
        out[side] = str(d)
    return out


def _assert_summary_equal(got: dict, want: dict):
    for k in SUMMARY_SCALARS:
        assert got[k] == want[k], k
    for k in SUMMARY_ARRAYS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert json.loads(got["session_params"]) == json.loads(want["session_params"])
    assert json.loads(got["bench_params"]) == json.loads(want["bench_params"])


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_summary_json_reads_in_both_packages(results, writer):
    """A summary.json written by either package's BenchRunner is read by
    the other's `process_single_result` to the same row, and the two
    packages' sessions give the same rows."""
    other = "torch" if writer == "jax" else "jax"
    for sdir in sorted(Path(results[writer]).glob("session_*")):
        by_jax = j_harness.process_single_result(str(sdir))
        by_torch = t_harness.process_single_result(str(sdir))
        assert by_jax["has_result"] and by_jax["nseen"] > 0
        _assert_summary_equal(by_torch, by_jax)
        twin = next(p for p in Path(results[other]).glob("session_*")
                    if j_harness.process_single_result(str(p))["variant"] == by_jax["variant"])
        twin_row = t_harness.process_single_result(str(twin))
        for k in ("hit_indices", "dbidxs"):
            np.testing.assert_array_equal(twin_row[k], by_jax[k], err_msg=k)


def test_session_summaries_parquet_round_trip(results):
    """`get_all_session_summaries` caches its frame as parquet with the
    per-session arrays as list columns; the cached load gives the same
    metrics, and the JAX package reads the port's cache."""
    d = results["torch"]
    fresh = t_harness.get_all_session_summaries(d, force_recompute=True)
    assert Path(d, "summary.parquet").exists()
    cached = t_harness.get_all_session_summaries(d)
    by_jax = j_harness.get_all_session_summaries(d)
    cols = ["variant", "nfound", "ndcg_score", "average_precision", "reciprocal_rank",
            "rank_first", "rank_tenth"]
    key = ["variant"]
    want = t_analysis.add_metrics(fresh)[cols].sort_values(key).reset_index(drop=True)
    for frame in (cached, by_jax):
        got = t_analysis.add_metrics(frame)[cols].sort_values(key).reset_index(drop=True)
        pd.testing.assert_frame_equal(got, want)
    for c in SUMMARY_ARRAYS:
        for a, b in zip(fresh.sort_values("variant")[c], cached.sort_values("variant")[c]):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


def test_generate_benchmark_configs_matches_jax(root):
    variants = [
        {"name": "plain", "interactive": "plain"},
        {"name": "lr", "interactive": "log_reg2", "max_samples": 2,
         "reg_lambda": {"choose": [1.0, 5.0, 9.0]}},
        {"name": "knn", "interactive": "knn_prop2", "index_name": "multiscale"},
    ]
    s_template = {"batch_size": 3, "shortlist_size": 20, "index_name": "multiscale",
                  "agg_method": "avg_score"}
    b_template = {"n_batches": 6, "max_results": 5, "query_template": "a {}"}
    out = {}
    for side, conf, bconf, gdm in (("jax", j_configs, j_bconf, JaxGDM(root)),
                                   ("torch", t_configs, t_bconf, TorchGDM(root))):
        random.seed(0)  # `choose` samples from the random module's state
        cfgs = bconf.generate_benchmark_configs(
            gdm, datasets=["synth", {"name": "synth", "categories": [CATEGORY]}],
            base_configs=conf.expand_configs(variants), s_template=s_template,
            b_template=b_template, max_classes_per_dataset=math.inf)
        out[side] = [(b.model_dump(), p.model_dump()) for b, p in cfgs]
    assert out["torch"] == out["jax"] and len(out["jax"]) >= 6
    assert t_bconf.get_param_hash("x") == j_bconf.get_param_hash("x")
    for ds, cat in (("bdd", "motor"), ("objectnet", "bills (money)"), ("lvis", "a_b(c)"),
                    ("dota", "small-vehicle"), ("coco", "mouse"), ("other", "thing")):
        assert t_terms.category2query(ds, cat) == j_terms.category2query(ds, cat)


# -- the copies of metrics, analysis and user_analysis ----------------------
def _hits():
    rng = np.random.default_rng(0)
    return [np.sort(rng.choice(60, size=n, replace=False)) for n in (0, 1, 5, 14)]


METRIC_CASES = {
    "average_precision": lambda m, h: [m.average_precision(x, npositive=12, max_results=mr)
                                       for x in h for mr in (None, 5, 30)],
    "average_reciprocal_gap": lambda m, h: [m.average_reciprocal_gap(x, npositive=12)
                                            for x in h],
    "ndcg_score": lambda m, h: [m.ndcg_score(x, nseen=60, npositive=14) for x in h if len(x)],
    "normalizedAP": lambda m, h: [m.normalizedAP(x, nseen=60, npositive=14, max_results=10)
                                  for x in h],
    "rank_kth": lambda m, h: [m.rank_kth(x, ntotal=12, ks=np.array([1, 2, 3, 10, 13]))
                              .tolist() for x in h],
    "compute_metrics": lambda m, h: [m.compute_metrics(hit_indices=x, batch_size=3, nseen=60,
                                                       ntotal=14, max_results=10)
                                     for x in h if len(x)],
}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metrics_copy_matches_jax(case):
    fn = METRIC_CASES[case]
    got, want = fn(t_metrics, _hits()), fn(j_metrics, _hits())
    assert json.dumps(got, default=repr) == json.dumps(want, default=repr)


def _sbs(a):
    stats = _stats_frame()
    mid = stats[stats.variant == "baseline"].assign(
        variant="multiscale",
        average_precision=lambda d: np.minimum(d.average_precision * 1.15, 1.0))
    stats = pd.concat([stats, mid], ignore_index=True)
    return a.side_by_side_comparison(stats, baseline_variant="baseline",
                                     metric="average_precision")


ANALYSIS_CASES = {
    "add_metrics": lambda a, frame, state: a.add_metrics(frame).drop(
        columns=["session_path", "total_time", "latencies", "method_stats"]),
    "side_by_side": lambda a, frame, state: a.side_by_side(
        a.add_metrics(frame).assign(dataset="synth"), "ndcg_score"),
    "better_same_worse": lambda a, frame, state: pd.Series(a.better_same_worse(
        a.add_metrics(frame).assign(dataset="synth"), "ndcg_score", baseline="plain",
        other="log_reg2")),
    "method_means": lambda a, frame, state: a.method_means(a.add_metrics(frame)),
    "bsw_table": lambda a, frame, state: a.bsw_table(
        _sbs(a), variant="seesaw", metric="average_precision", reltol=1.05),
    "summary_breakdown": lambda a, frame, state: a.summary_breakdown(
        _sbs(a), "average_precision"),
    "comparison_table": lambda a, frame, state: a.comparison_table(
        a.summary_breakdown(_sbs(a), "average_precision"), variant="seesaw",
        baseline_variant="baseline"),
    "ablation_table": lambda a, frame, state: a.ablation_table(
        a.summary_breakdown(_sbs(a), "average_precision"),
        ["baseline", "multiscale", "seesaw"]),
    "action_log_frame": lambda a, frame, state: a.action_log_frame(state),
    "phase_durations": lambda a, frame, state: a.phase_durations(state),
    "accept_timeline": lambda a, frame, state: a.accept_timeline(state),
    "time_to_find_k": lambda a, frame, state: pd.Series(
        [a.time_to_find_k(state, k) for k in (1, 2, 50)], dtype=object),
}


@pytest.mark.parametrize("case", sorted(ANALYSIS_CASES))
def test_analysis_copy_matches_jax(results, case):
    frame = j_harness.get_all_session_summaries(results["jax"], force_recompute=True)
    frame = frame.sort_values("variant").reset_index(drop=True)
    sdir = frame[frame.variant == "plain"].session_path.iloc[0]
    obj = json.loads((Path(sdir) / "summary.json").read_text())
    fn = ANALYSIS_CASES[case]
    want = fn(j_analysis, frame, jbt.BenchSummary(**obj).result.session)
    got = fn(t_analysis, frame, tbt.BenchSummary(**obj).result.session)
    if isinstance(want, pd.Series):
        pd.testing.assert_series_equal(got, want)
    else:
        pd.testing.assert_frame_equal(got, want)
    assert len(want)


def _user_sessions():
    return [
        _fake_session("s1", "pc", "plain", [5, 10, 20], 60, path="/s/a/"),
        _fake_session("s2", "pc", "seesaw", [2, 3, 4], 30, path="/s/b/"),
        _fake_session("s3", "pc", "plain", [100], 60 * 6 + 5, path="/s/c/"),
    ]


USER_CASES = {
    "get_session_summaries": lambda u: u.get_session_summaries(_user_sessions()),
    "process_action_log": lambda u: pd.Series({
        k: repr(v)
        for k, v in u.process_action_log(_user_sessions()[0]["session"]["action_log"]).items()}),
    "compute_session_tables": lambda u: pd.concat(
        {k: v.astype(str) for k, v in u.compute_session_tables(_user_sessions()).items()}),
    "time_to_find_k_table": lambda u: u.time_to_find_k_table(
        u.compute_session_tables(_user_sessions())["accept_df"], 2),
    "bootstrap_stat": lambda u: u.bootstrap_stat(pd.Series([1.0, 2.0, 3.0, 4.0, 9.0]),
                                                 n_resamples=500),
    "find_k_intervals": lambda u: u.find_k_intervals(
        u.compute_session_tables(_user_sessions())["accept_df"], k=2),
    "get_first_time": lambda u: pd.Series(
        [u.get_first_time(_user_sessions()[0]["session"]["action_log"], m)
         for m in ("init", "task.started", "nothing")], dtype=object),
}


@pytest.mark.parametrize("case", sorted(USER_CASES))
def test_user_analysis_copy_matches_jax(case):
    want, got = USER_CASES[case](j_user), USER_CASES[case](t_user)
    if isinstance(want, pd.Series):
        pd.testing.assert_series_equal(got, want)
    else:
        pd.testing.assert_frame_equal(got, want)


def test_user_analysis_reads_saved_sessions(tmp_path):
    """`load_session_data` and `image_view_timeline` over saved session
    trees, as the JAX package reads them."""
    for i, sess in enumerate(_user_sessions()):
        d = tmp_path / f"sess{i}"
        d.mkdir()
        s = dict(sess["session"])
        s["gdata"] = [[{"url": "u", "dbidx": j, "boxes": [], "timing": [
            {"start_ms": 1000.0 * (1002 + j), "end_ms": 1000.0 * (1003 + j)}]}
            for j in range(3)]]
        (d / "summary.json").write_text(json.dumps({"session": s}))
    want = j_user.load_session_data(str(tmp_path))
    got = t_user.load_session_data(str(tmp_path))
    assert got == want and len(got) == 3
    pd.testing.assert_frame_equal(t_user.image_view_timeline(got[0]),
                                  j_user.image_view_timeline(want[0]))
