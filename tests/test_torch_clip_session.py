"""The CLIP serving slice as a whole: an index whose `info.json` names
`clip-custom:<artifact dir>` loads its model through each package's
registry, and a JAX `Session` and a port `Session` on the CPU take the same
text query through the text tower and run the same rounds.

The artifact is written as `scripts/convert_clip_checkpoint.py` writes one
(params.npz + info.json, no vocab: the hash tokenizer), from the JAX init of
a tiny config whose towers are kernel-eligible (64-wide heads) and whose
embed_dim is the synthetic index's dim. The JAX side reaches its Pallas
attention in interpret mode. Tolerances: the text vector 1e-5 (unit vector
through 2 f32 layers); dbidxs equal every round; scores as
tests/test_torch_session.py.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synth import DIM, QSTR, build_synthetic_root  # noqa: E402
from test_torch_session import _drive, _params  # noqa: E402

import seesaw_tpu.basic_types as jbt  # noqa: E402
import seesaw_tpu_torch.basic_types as tbt  # noqa: E402
from seesaw_tpu.dataset import GlobalDataManager as JaxGDM  # noqa: E402
from seesaw_tpu.models import clip as J  # noqa: E402
from seesaw_tpu.session import make_session as jax_make_session  # noqa: E402
from seesaw_tpu_torch.dataset import GlobalDataManager as TorchGDM  # noqa: E402
from seesaw_tpu_torch.models.clip import ClipEmbedding  # noqa: E402
from seesaw_tpu_torch.session import make_session as torch_make_session  # noqa: E402

CFG = J.ClipConfig(embed_dim=DIM, image_size=32, patch_size=16, vision_width=128,
                   vision_layers=1, vision_heads=2, vocab_size=99, context_length=16,
                   text_width=128, text_layers=2, text_heads=2)


@pytest.fixture(scope="module")
def clip_root(tmp_path_factory):
    artifact = tmp_path_factory.mktemp("clip_artifact")
    J.save_params_npz(J.init_params(CFG, seed=3), str(artifact / "params.npz"))
    info = dict(J.config_to_info(CFG), variant="custom")
    (artifact / "info.json").write_text(json.dumps(info))

    root = tmp_path_factory.mktemp("clip_session")
    gdm, ds, meta = build_synthetic_root(str(root), dataset_name="csess")
    index_info = Path(ds.index_path("multiscale")) / "info.json"
    spec = json.loads(index_info.read_text())
    spec["model"] = f"clip-custom:{artifact}"
    index_info.write_text(json.dumps(spec))
    table, _ = ds.load_ground_truth()
    gt_boxes = {int(d): b for d, b in zip(table.dbidx, table.boxes)}
    return str(root), meta["is_pos"], gt_boxes


@pytest.mark.parametrize("method", ["rocchio_update", "log_reg2"])
def test_clip_session_matches_jax(clip_root, monkeypatch, method):
    monkeypatch.setenv("SEESAW_FUSED_ATTN_INTERPRET", "1")
    root, is_pos, gt_boxes = clip_root
    s_jax = jax_make_session(JaxGDM(root), _params(jbt, method, "csess"))["session"]
    s_torch = torch_make_session(TorchGDM(root), _params(tbt, method, "csess"),
                                 device="cpu")["session"]
    emb = s_torch.index.embedding
    assert isinstance(emb, ClipEmbedding) and emb.device.type == "cpu" and emb.dim == DIM

    want_vec = s_jax.index.string2vec(QSTR)
    got_vec = s_torch.index.string2vec(QSTR)
    np.testing.assert_allclose(got_vec, want_vec, atol=1e-5)

    want = _drive(s_jax, is_pos, gt_boxes, jbt.Box)
    got = _drive(s_torch, is_pos, gt_boxes, tbt.Box)
    for r, (g, w) in enumerate(zip(got, want)):
        assert g["dbidxs"] == w["dbidxs"], f"round {r}"
        np.testing.assert_allclose(g["scores"], w["scores"], rtol=1e-5, atol=1e-6)
        if w["params"] is not None:
            np.testing.assert_allclose(g["params"], w["params"], rtol=2e-4, atol=2e-5)
    assert s_torch.seen.to_array().tolist() == s_jax.seen.to_array().tolist()
