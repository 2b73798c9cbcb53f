"""The port's serving rounds as a whole, held against the JAX package:
`seesaw_tpu_torch.session.make_session` and `seesaw_tpu.session.make_session`
(index_options use_pallas=True, so the JAX side runs the Pallas scan in
interpret mode) on the same synthetic root, driven by the same simulated
user, f32 storage, on the CPU. Each side gets its parameters, boxes and data
manager from its own package.

Loops: the per-click point-based ones, and `knn_prop2` over a k=5 graph
that the JAX package builds and saves beside the index, against the JAX
default (XLA) propagation and its windowed (Pallas, interpret) one.

Tolerances: dbidxs and activation boxes equal; activation scores rtol 1e-5
(f32 dots summed in another order), for knn_prop2 rtol 2e-5 / atol 2e-6 (the
JAX package's bar between its windowed and dense propagation); LogReg2
coefficients rtol 2e-4 / atol 2e-5, the bar the JAX package sets between its
own fit paths (tests/test_deferred_rocchio.py).
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
}
ROUNDS = 6


def _params(bt, method, d_name, **options):
    return bt.SessionParams(
        index_spec=bt.IndexSpec(d_name=d_name, i_name="multiscale"),
        interactive=method, batch_size=3, shortlist_size=20,
        interactive_options=dict(OPTIONS[method], **options),
        index_options={"use_pallas": True},
    )


def _label(session, is_pos, gt_boxes, Box):
    """Simulated user: accept planted positives with their box, reject the
    rest."""
    state = session.get_state()
    for imdata in state.gdata[-1]:
        if is_pos[imdata.dbidx]:
            x1, y1, x2, y2 = gt_boxes[imdata.dbidx]
            imdata.boxes = [Box(x1=x1, y1=y1, x2=x2, y2=y2, marked_accepted=True)]
        else:
            imdata.boxes = []
    session.update_state(state)


def _drive(session, is_pos, gt_boxes, Box):
    session.set_text(QSTR)
    rounds = []
    for _ in range(ROUNDS):
        dbidxs = [int(i) for i in session.next()]
        acts = session.acc_activations[-1]
        params = getattr(getattr(session.loop, "model", None), "params_", None)
        rounds.append(dict(
            dbidxs=dbidxs,
            boxes=np.array([[a["x1"], a["y1"], a["x2"], a["y2"]] for a in acts]),
            scores=np.array([a["score"] for a in acts], np.float32),
            params=None if params is None else np.array(params),
        ))
        _label(session, is_pos, gt_boxes, Box)
        session.refine()
    return rounds


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_session")
    gdm, ds, info = build_synthetic_root(str(root), dataset_name="tsess")
    idx = ds.load_index("multiscale", options={})
    KNNGraph.build(idx.vectors, n_neighbors=5).save(idx.get_knng_path(name="k5"))
    table, _ = ds.load_ground_truth()
    gt_boxes = {int(d): b for d, b in zip(table.dbidx, table.boxes)}
    return str(root), info["is_pos"], gt_boxes


def _compare_sessions(root, is_pos, gt_boxes, method, score_tol, jax_options=None):
    s_jax = jax_make_session(
        JaxGDM(root), _params(jbt, method, "tsess", **(jax_options or {})))["session"]
    s_torch = torch_make_session(
        TorchGDM(root), _params(tbt, method, "tsess"), device="cpu")["session"]
    want = _drive(s_jax, is_pos, gt_boxes, jbt.Box)
    got = _drive(s_torch, is_pos, gt_boxes, tbt.Box)
    for r, (g, w) in enumerate(zip(got, want)):
        assert g["dbidxs"] == w["dbidxs"], f"round {r}"
        assert len(g["dbidxs"]) == 3
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        np.testing.assert_allclose(g["scores"], w["scores"], **score_tol)
        if w["params"] is not None:
            np.testing.assert_allclose(g["params"], w["params"], rtol=2e-4, atol=2e-5)
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


def test_port_session_has_base_attributes(synth_root):
    """The port's Session is its own class, written after the JAX one; both
    constructors must leave the same instance attributes."""
    root = synth_root[0]
    s_jax = jax_make_session(JaxGDM(root), _params(jbt, "rocchio_update", "tsess"))["session"]
    s_torch = torch_make_session(TorchGDM(root), _params(tbt, "rocchio_update", "tsess"),
                                 device="cpu")["session"]
    assert sorted(vars(s_torch)) == sorted(vars(s_jax))


def test_port_session_imports_no_jax(synth_root):
    """CPU sessions through the port (log_reg2 and knn_prop2), in a fresh
    process that imports only `seesaw_tpu_torch`, never import jax, flax or
    any module of the JAX package."""
    root = synth_root[0]
    code = textwrap.dedent(f"""
        import sys
        from seesaw_tpu_torch import Box, GlobalDataManager, IndexSpec, SessionParams
        from seesaw_tpu_torch.session import make_session
        options = dict(
            log_reg2=dict(fit_intercept=False, max_iter=20),
            knn_prop2=dict(matrix_options=dict(knn_path="k5", knn_k=5, edist=0.5),
                           normalize_scores=True, normalize_epsilon=0.1,
                           sigmoid_before_propagate=True, calib_a=2.0,
                           calib_b=-0.5, prior_weight=1.0),
        )
        for method, opts in options.items():
            p = SessionParams(
                index_spec=IndexSpec(d_name="tsess", i_name="multiscale"),
                interactive=method, batch_size=3, shortlist_size=20,
                interactive_options=opts,
            )
            s = make_session(GlobalDataManager({root!r}), p, device="cpu")["session"]
            s.set_text("a dog")
            for _ in range(3):
                assert len(s.next()) == 3
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
