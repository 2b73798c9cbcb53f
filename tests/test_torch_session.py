"""The port's per-click serving round as a whole, held against the JAX
package: `seesaw_tpu_torch.session.make_session` and
`seesaw_tpu.session.make_session` (index_options use_pallas=True, so the JAX
side runs the Pallas scan in interpret mode) on the same synthetic root,
driven by the same simulated user, f32 storage, on the CPU.

Tolerances: dbidxs and activation boxes equal; activation scores rtol 1e-5
(f32 dots summed in another order); LogReg2 coefficients rtol 2e-4 / atol
2e-5, the bar the JAX package sets between its own fit paths
(tests/test_deferred_rocchio.py).
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synth import QSTR, build_synthetic_root  # noqa: E402

from seesaw_tpu.basic_types import Box, IndexSpec, SessionParams  # noqa: E402
from seesaw_tpu.dataset import GlobalDataManager  # noqa: E402
from seesaw_tpu.session import make_session as jax_make_session  # noqa: E402
from seesaw_tpu_torch.session import make_session as torch_make_session  # noqa: E402

OPTIONS = {
    "plain": {},
    "rocchio_update": dict(rocchio_alpha=1.0, rocchio_beta=0.7, rocchio_gamma=0.3),
    "log_reg2": dict(class_weights="balanced", scale="centered", reg_lambda=5.0,
                     fit_intercept=False, max_iter=50),
}
ROUNDS = 6


def _params(method, d_name):
    return SessionParams(
        index_spec=IndexSpec(d_name=d_name, i_name="multiscale"),
        interactive=method, batch_size=3, shortlist_size=20,
        interactive_options=OPTIONS[method], index_options={"use_pallas": True},
    )


def _label(session, is_pos, gt_boxes):
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


def _drive(session, is_pos, gt_boxes):
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
        _label(session, is_pos, gt_boxes)
        session.refine()
    return rounds


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_session")
    gdm, ds, info = build_synthetic_root(str(root), dataset_name="tsess")
    table, _ = ds.load_ground_truth()
    gt_boxes = {int(d): b for d, b in zip(table.dbidx, table.boxes)}
    return str(root), info["is_pos"], gt_boxes


@pytest.mark.parametrize("method", ["plain", "rocchio_update", "log_reg2"])
def test_session_matches_jax(synth_root, method):
    root, is_pos, gt_boxes = synth_root
    gdm = GlobalDataManager(root)
    p = _params(method, "tsess")
    s_jax = jax_make_session(gdm, p)["session"]
    s_torch = torch_make_session(gdm, p, device="cpu")["session"]
    want = _drive(s_jax, is_pos, gt_boxes)
    got = _drive(s_torch, is_pos, gt_boxes)
    for r, (g, w) in enumerate(zip(got, want)):
        assert g["dbidxs"] == w["dbidxs"], f"round {r}"
        assert len(g["dbidxs"]) == 3
        np.testing.assert_array_equal(g["boxes"], w["boxes"])
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-5, atol=1e-6)
        if w["params"] is not None:
            np.testing.assert_allclose(g["params"], w["params"], rtol=2e-4, atol=2e-5)
    assert s_torch.seen.to_array().tolist() == s_jax.seen.to_array().tolist()
    assert s_torch.accepted.to_array().tolist() == s_jax.accepted.to_array().tolist()
    if method != "plain":  # feedback found positives beyond the first batch
        assert len(s_torch.accepted) > 0


def test_port_session_has_base_attributes(synth_root):
    """The port's Session constructor mirrors the JAX one instead of calling
    it; both must leave the same instance attributes, so the inherited
    methods find everything they read."""
    root = synth_root[0]
    gdm = GlobalDataManager(root)
    p = _params("rocchio_update", "tsess")
    s_jax = jax_make_session(gdm, p)["session"]
    s_torch = torch_make_session(gdm, p, device="cpu")["session"]
    assert sorted(vars(s_torch)) == sorted(vars(s_jax))


def test_port_session_imports_no_jax(synth_root):
    """A CPU session through the port, in a fresh process, never imports
    jax (or flax)."""
    root = synth_root[0]
    code = textwrap.dedent(f"""
        import sys
        from seesaw_tpu.basic_types import IndexSpec, SessionParams
        from seesaw_tpu.dataset import GlobalDataManager
        from seesaw_tpu_torch.session import make_session
        p = SessionParams(
            index_spec=IndexSpec(d_name="tsess", i_name="multiscale"),
            interactive="log_reg2", batch_size=3, shortlist_size=20,
            interactive_options=dict(fit_intercept=False, max_iter=20),
        )
        s = make_session(GlobalDataManager({root!r}), p, device="cpu")["session"]
        s.set_text("a dog")
        for _ in range(3):
            assert len(s.next()) == 3
            st = s.get_state()
            for j, im in enumerate(st.gdata[-1]):
                im.boxes = []
            s.update_state(st)
            s.refine()
        bad = [m for m in ("jax", "flax") if m in sys.modules]
        assert not bad, bad
        print("ok")
    """)
    repo = Path(__file__).resolve().parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=repo,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")
