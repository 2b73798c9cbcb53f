"""The port's serving rounds as a whole, held against the JAX package:
`seesaw_tpu_torch.session.make_session` and `seesaw_tpu.session.make_session`
(index_options use_pallas=True, so the JAX side runs the Pallas scan in
interpret mode) on the same synthetic root, driven by the same simulated
user, f32 storage, on the CPU. Each side gets its parameters, boxes and data
manager from its own package.

Loops: the per-click point-based ones, and `knn_prop2` over a k=5 graph
that the JAX package builds and saves beside the index, against the JAX
default (XLA) propagation and its windowed (Pallas, interpret) one; then
`multi_reg` with each label loss over a k=8 graph, `multi_reg_neg` (the
simulated user describes each rejected image's box as a confusion class),
`pseudo_lr` (both sides draw their pseudo-label sample from numpy's global
random state, re-seeded before each session), and the batch-1 active-search
loops `active_search` (the ENS planner) and `lknn`.

Tolerances: dbidxs and activation boxes equal; activation scores rtol 1e-5
(f32 dots summed in another order), for knn_prop2 rtol 2e-5 / atol 2e-6 (the
JAX package's bar between its windowed and dense propagation), for the
fitted loops (multi_reg, multi_reg_neg, pseudo_lr) atol 2e-3: their unit
coefficients come from LBFGS solves that may take their last steps
differently on the f32 floor or at a hinge kink (tests/test_torch_multi_reg.py
traces them), which moves a coefficient, and so a score of a unit vector, by
up to ~1e-3 (`-s` prints each session's largest score difference);
LogReg2 coefficients rtol 2e-4
/ atol 2e-5, the bar the JAX package sets between its own fit paths
(tests/test_deferred_rocchio.py). The active-search loops return no
activations.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synth import QSTR, build_synthetic_root  # noqa: E402

import seesaw_tpu.basic_types as jbt  # noqa: E402
import seesaw_tpu_torch.basic_types as tbt  # noqa: E402
from seesaw_tpu.dataset import GlobalDataManager as JaxGDM  # noqa: E402
from seesaw_tpu.knn_graph import KNNGraph  # noqa: E402
from seesaw_tpu.session import make_session as jax_make_session  # noqa: E402
from seesaw_tpu_torch.dataset import GlobalDataManager as TorchGDM  # noqa: E402
from seesaw_tpu_torch.session import make_session as torch_make_session  # noqa: E402

OPTIONS = {
    "plain": {},
    "rocchio_update": dict(rocchio_alpha=1.0, rocchio_beta=0.7, rocchio_gamma=0.3),
    "log_reg2": dict(class_weights="balanced", scale="centered", reg_lambda=5.0,
                     fit_intercept=False, max_iter=50),
    "knn_prop2": dict(
        matrix_options=dict(knn_path="k5", knn_k=5, edist=0.5),
        normalize_scores=True, normalize_epsilon=0.1, sigmoid_before_propagate=True,
        calib_a=2.0, calib_b=-0.5, prior_weight=1.0,
    ),
    # seesaw_tpu/configs.py's defaults, over the test's graphs
    "multi_reg": dict(
        matrix_options=dict(knn_path="k8", knn_k=8, edist=0.5),
        label_loss_type="ce_loss", rank_loss_margin=0.0, pos_weight="balanced",
        reg_data_lambda=0.1, reg_norm_lambda=10.0, reg_query_lambda=1.0, max_iter=50,
    ),
    "multi_reg_neg": dict(reg_norm_lambda=10.0, reg_query_lambda=1.0, max_iter=50,
                          discount_neg=True),
    "pseudo_lr": dict(
        label_prop_params=dict(
            matrix_options=dict(knn_path="k5", knn_k=5, edist=0.5),
            normalize_scores=True, normalize_epsilon=0.1, sigmoid_before_propagate=True,
            calib_a=2.0, calib_b=-0.5, prior_weight=1.0,
        ),
        log_reg_params=dict(reg_lambda=10.0, max_iter=50),
        switch_over=True, real_sample_weight=5.0, sample_size=20,
    ),
    "active_search": dict(
        matrix_options=dict(knn_path="k5", knn_k=5, edist=0.5),
        gamma=dict(mode="fixed", value=0.15), reward_horizon=5, adjust_horizon=False,
        pruning_on=False, implementation="vectorized",
    ),
    "lknn": dict(matrix_options=dict(knn_path="k5", knn_k=5, edist=0.5), gamma=0.15,
                 use_clip_as_gamma=False),
}
ROUNDS = 6
BATCH1_ROUNDS = 12  # the active-search loops return one image a round
CONFUSION = "a cat"  # the simulated user's description of a rejected box


def _params(bt, method, d_name, **options):
    batch = 1 if method in ("active_search", "lknn") else 3
    return bt.SessionParams(
        index_spec=bt.IndexSpec(d_name=d_name, i_name="multiscale"),
        interactive=method, batch_size=batch, shortlist_size=20,
        interactive_options=dict(OPTIONS[method], **options),
        index_options={"use_pallas": True},
    )


def _label(session, is_pos, gt_boxes, Box, confusion=False):
    """Simulated user: accept planted positives with their box, reject the
    rest (with `confusion`, by a rejected box over the top-left quadrant
    described CONFUSION)."""
    state = session.get_state()
    for imdata in state.gdata[-1]:
        if is_pos[imdata.dbidx]:
            x1, y1, x2, y2 = gt_boxes[imdata.dbidx]
            imdata.boxes = [Box(x1=x1, y1=y1, x2=x2, y2=y2, marked_accepted=True)]
        elif confusion:
            imdata.boxes = [Box(x1=0.0, y1=0.0, x2=112.0, y2=112.0, description=CONFUSION,
                                marked_accepted=False)]
        else:
            imdata.boxes = []
    session.update_state(state)


def _drive(session, is_pos, gt_boxes, Box, rounds=ROUNDS, confusion=False):
    session.set_text(QSTR)
    out = []
    for _ in range(rounds):
        dbidxs = [int(i) for i in session.next()]
        acts = session.acc_activations[-1] or []
        params = getattr(getattr(session.loop, "model", None), "params_", None)
        out.append(dict(
            dbidxs=dbidxs,
            boxes=np.array([[a["x1"], a["y1"], a["x2"], a["y2"]] for a in acts]),
            scores=np.array([a["score"] for a in acts], np.float32),
            params=None if params is None else np.array(params),
        ))
        _label(session, is_pos, gt_boxes, Box, confusion=confusion)
        session.refine()
    return out


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_session")
    gdm, ds, info = build_synthetic_root(str(root), dataset_name="tsess")
    idx = ds.load_index("multiscale", options={})
    for k in (5, 8):
        KNNGraph.build(idx.vectors, n_neighbors=k).save(idx.get_knng_path(name=f"k{k}"))
    table, _ = ds.load_ground_truth()
    gt_boxes = {int(d): b for d, b in zip(table.dbidx, table.boxes)}
    return str(root), info["is_pos"], gt_boxes


def _compare_sessions(root, is_pos, gt_boxes, method, score_tol, jax_options=None,
                      options=None):
    options = options or {}
    s_jax = jax_make_session(
        JaxGDM(root), _params(jbt, method, "tsess", **options, **(jax_options or {})))["session"]
    s_torch = torch_make_session(
        TorchGDM(root), _params(tbt, method, "tsess", **options), device="cpu")["session"]
    batch1 = method in ("active_search", "lknn")
    kw = dict(rounds=BATCH1_ROUNDS if batch1 else ROUNDS,
              confusion=method == "multi_reg_neg")
    np.random.seed(0)  # pseudo_lr's sample: the same stream for both sides
    want = _drive(s_jax, is_pos, gt_boxes, jbt.Box, **kw)
    np.random.seed(0)
    got = _drive(s_torch, is_pos, gt_boxes, tbt.Box, **kw)
    worst = 0.0
    for r, (g, w) in enumerate(zip(got, want)):
        assert g["dbidxs"] == w["dbidxs"], f"round {r}"
        assert len(g["dbidxs"]) == (1 if batch1 else 3)
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        np.testing.assert_allclose(g["scores"], w["scores"], **score_tol)
        worst = max(worst, float(np.abs(g["scores"] - w["scores"]).max(initial=0.0)))
        if w["params"] is not None:
            np.testing.assert_allclose(g["params"], w["params"], rtol=2e-4, atol=2e-5)
    print(f"{method}: max activation score diff {worst!r}")  # pytest -s
    assert s_torch.seen.to_array().tolist() == s_jax.seen.to_array().tolist()
    assert s_torch.accepted.to_array().tolist() == s_jax.accepted.to_array().tolist()
    if method != "plain":  # feedback found positives beyond the first batch
        assert len(s_torch.accepted) > 0
    return s_torch


@pytest.mark.parametrize("method", ["plain", "rocchio_update", "log_reg2"])
def test_session_matches_jax(synth_root, method):
    _compare_sessions(*synth_root, method, dict(rtol=1e-5, atol=1e-6))


@pytest.mark.parametrize("windowed", [False, True])
def test_knn_prop2_session_matches_jax(synth_root, windowed):
    """The JAX session propagates eagerly (XLA gather, or the windowed
    Pallas SpMV in interpret mode); the port's ranks each staged round
    fused. Same images, seen and accepted sets every round."""
    s = _compare_sessions(*synth_root, "knn_prop2", dict(rtol=2e-5, atol=2e-6),
                          jax_options=dict(windowed=True) if windowed else None)
    res = s.loop.state.knn_model.last_result
    assert res is not None and res.converged and res.host_reads == 1


FIT_TOL = dict(rtol=0, atol=2e-3)


@pytest.mark.parametrize("loss", ["ce_loss", "pairwise_rank_loss", "pairwise_logistic_loss"])
def test_multi_reg_session_matches_jax(synth_root, loss):
    """The 'seesaw' method: each feedback round's fit runs inside the next
    query (the deferred round) on both sides."""
    s = _compare_sessions(*synth_root, "multi_reg", FIT_TOL,
                          options=dict(label_loss_type=loss))
    assert s.index.last_fit is not None and s.index.last_fit["n_iter"] > 0


def test_multi_reg_neg_session_matches_jax(synth_root):
    s = _compare_sessions(*synth_root, "multi_reg_neg", FIT_TOL)
    assert s.loop.confusion_vec is not None  # the confusion head was fit


def test_pseudo_lr_session_matches_jax(synth_root):
    s = _compare_sessions(*synth_root, "pseudo_lr", FIT_TOL)
    assert s.loop.knn_based.state.knn_model.last_result is not None  # propagation ran


@pytest.mark.parametrize("method", ["active_search", "lknn"])
def test_active_search_session_matches_jax(synth_root, method):
    s = _compare_sessions(*synth_root, method, dict(rtol=0, atol=0))
    assert len(s.seen) == BATCH1_ROUNDS


def test_port_session_has_base_attributes(synth_root):
    """The port's Session is its own class, written after the JAX one; both
    constructors must leave the same instance attributes."""
    root = synth_root[0]
    s_jax = jax_make_session(JaxGDM(root), _params(jbt, "rocchio_update", "tsess"))["session"]
    s_torch = torch_make_session(TorchGDM(root), _params(tbt, "rocchio_update", "tsess"),
                                 device="cpu")["session"]
    assert sorted(vars(s_torch)) == sorted(vars(s_jax))


def test_port_session_imports_no_jax(synth_root):
    """CPU sessions through the port (log_reg2, multi_reg, lknn and
    knn_prop2), in a fresh process that imports only `seesaw_tpu_torch`,
    never import jax, flax or any module of the JAX package."""
    root = synth_root[0]
    code = textwrap.dedent(f"""
        import sys
        from seesaw_tpu_torch import Box, GlobalDataManager, IndexSpec, SessionParams
        from seesaw_tpu_torch.session import make_session
        options = dict(
            log_reg2=dict(fit_intercept=False, max_iter=20),
            multi_reg=dict(matrix_options=dict(knn_path="k8", knn_k=8, edist=0.5),
                           label_loss_type="pairwise_rank_loss", reg_data_lambda=0.1,
                           reg_norm_lambda=10.0, reg_query_lambda=1.0, max_iter=20),
            lknn=dict(matrix_options=dict(knn_path="k5", knn_k=5, edist=0.5), gamma=0.15,
                      use_clip_as_gamma=False),
            knn_prop2=dict(matrix_options=dict(knn_path="k5", knn_k=5, edist=0.5),
                           normalize_scores=True, normalize_epsilon=0.1,
                           sigmoid_before_propagate=True, calib_a=2.0,
                           calib_b=-0.5, prior_weight=1.0),
        )
        for method, opts in options.items():
            p = SessionParams(
                index_spec=IndexSpec(d_name="tsess", i_name="multiscale"),
                interactive=method, batch_size=1 if method == "lknn" else 3,
                shortlist_size=20, interactive_options=opts,
            )
            s = make_session(GlobalDataManager({root!r}), p, device="cpu")["session"]
            s.set_text("a dog")
            for _ in range(3):
                assert len(s.next()) == p.batch_size
                st = s.get_state()
                for j, im in enumerate(st.gdata[-1]):
                    im.boxes = ([Box(x1=0, y1=0, x2=112, y2=112, marked_accepted=True)]
                                if j == 0 else [])
                s.update_state(st)
                s.refine()
        bad = [m for m in sys.modules
               if m in ("jax", "flax") or m == "seesaw_tpu" or m.startswith("seesaw_tpu.")]
        assert not bad, bad
        print("ok")
    """)
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
