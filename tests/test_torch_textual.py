"""The port's textual feedback (`seesaw_tpu_torch.models.online_model`,
`seesaw_tpu_torch.loops.textual`) against the JAX package on the CPU: the
OnlineModel in both modes on the same weights and feedback vectors, and
whole `textual` sessions on chip_smoke.py phase 4's synthetic root (the
root of phase 8d), driven by `utils.rounds.drive_textual_session`, whose
simulated user attaches descriptions to its boxes (accepted boxes "a dog",
rejected ones "a cat", as the JAX bench's `provide_textual_feedback` user
labels the target and its confusion class).

Weights: the JAX `init_params`, carried to the port by
`convert.clip_params_from_arrays`. Tolerances: losses rtol 1e-5 and the
trained tensors (scorer weights, `text_projection`) atol 1e-6 (f32 sums in
another order through Adam's steps); scores rtol 1e-5; dbidxs equal every
round.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

sys.path.insert(0, str(Path(__file__).resolve().parent))
from synth import QSTR  # noqa: E402

from chip_smoke import write_synthetic_root  # noqa: E402

import seesaw_tpu.basic_types as jbt  # noqa: E402
import seesaw_tpu_torch.basic_types as tbt  # noqa: E402
from seesaw_tpu.dataset import GlobalDataManager as JaxGDM  # noqa: E402
from seesaw_tpu.models import clip as J  # noqa: E402
from seesaw_tpu.models.online_model import OnlineModel as JaxOnlineModel  # noqa: E402
from seesaw_tpu.session import make_session as jax_make_session  # noqa: E402
from seesaw_tpu_torch.convert import clip_params_from_arrays  # noqa: E402
from seesaw_tpu_torch.dataset import GlobalDataManager as TorchGDM  # noqa: E402
from seesaw_tpu_torch.models import clip as T  # noqa: E402
from seesaw_tpu_torch.models.online_model import OnlineModel, deduplicate_strings  # noqa: E402
from seesaw_tpu_torch.session import make_session as torch_make_session  # noqa: E402
from seesaw_tpu_torch.utils.rounds import drive_textual_session  # noqa: E402

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
PARAM_TOL = dict(rtol=1e-5, atol=1e-6)
SCORE_TOL = dict(rtol=1e-5, atol=1e-6)
LINEAR = dict(mode="linear", rounds=10, num_warmup_steps=4, image_loss_weight=0.5,
              rank_margin=0.1)
FINETUNE = dict(mode="finetune", rounds=12, num_warmup_steps=2, lr=5e-3,
                weight_decay=0.01, image_loss_weight=0.5, rank_margin=0.1,
                label_margin=0.1)
ROUNDS = 5


@pytest.fixture(scope="module")
def embeddings():
    jemb = J.ClipEmbedding(variant="test")
    cfg = T.VARIANTS["test"]
    temb = T.ClipEmbedding(
        cfg=cfg, dtype=None, device="cpu",
        params=clip_params_from_arrays(jax.tree.map(np.asarray, jemb.params), cfg))
    return jemb, temb


def make_feedback(emb, rng, n=24):
    """tests/test_textual.py's feedback: half the vectors near 'a dog'
    (accepted, described), half near 'a cat' (rejected, described), and a
    few without a description."""
    vdog, vcat = emb.from_string(string="a dog"), emb.from_string(string="a cat")
    vecs, acc, ann = [], [], []
    for i in range(n):
        dog = i % 2 == 0
        v = (vdog if dog else vcat) + 0.4 * rng.normal(size=emb.dim)
        vecs.append(v / np.linalg.norm(v))
        acc.append(dog)
        ann.append("" if i % 5 == 4 else ("a dog" if dog else "a cat"))
    return np.stack(vecs).astype(np.float32), np.array(acc), np.array(ann, dtype=object)


def test_deduplicate_strings():
    d = deduplicate_strings(["a", "b", "a", "c", "b"])
    assert d["strings"] == ["a", "b", "c"]
    assert d["indices"].tolist() == [0, 1, 0, 2, 1]


def test_linear_mode_matches_jax(embeddings):
    jemb, temb = embeddings
    vecs, acc, ann = make_feedback(jemb, np.random.default_rng(0))
    want = JaxOnlineModel(jemb, LINEAR)
    want.update(vecs, acc, ann, target_string="a dog")
    got = OnlineModel(temb, LINEAR, device="cpu")
    got.update(vecs, acc, ann, target_string="a dog")
    assert got.scorer_names == want.scorer_names == ["a dog", "a cat"]
    assert len(got.losses) == len(want.losses) == 14
    np.testing.assert_allclose(got.losses, want.losses, **LOSS_TOL)
    for k in ("w", "b", "ls"):
        np.testing.assert_allclose(got.scorer_params[k].numpy(), want.scorer_params[k],
                                   **PARAM_TOL, err_msg=k)
    scores = got.score_vecs(vecs)
    assert scores.device.type == "cpu" and scores.dtype == torch.float32
    np.testing.assert_allclose(scores.numpy(), want.score_vecs(vecs), **SCORE_TOL)
    np.testing.assert_allclose(got.get_lookup_vec("a cat"), want.get_lookup_vec("a cat"),
                               **PARAM_TOL)


def test_finetune_mode_matches_jax(embeddings):
    jemb, temb = embeddings
    vecs, acc, ann = make_feedback(jemb, np.random.default_rng(1))
    want = JaxOnlineModel(jemb, FINETUNE)
    want.update(vecs, acc, ann, target_string="a dog")
    got = OnlineModel(temb, FINETUNE, device="cpu")
    base = got.text_projection.clone()
    got.update(vecs, acc, ann, target_string="a dog")
    assert len(got.losses) == len(want.losses) == 14
    np.testing.assert_allclose(got.losses, want.losses, **LOSS_TOL)
    assert got.losses[-1] < got.losses[0]
    assert not torch.equal(got.text_projection, base)
    np.testing.assert_allclose(got.text_projection.numpy(), want.text_projection,
                               **PARAM_TOL)
    np.testing.assert_allclose(got.encode_string("a dog"), want.encode_string("a dog"),
                               **SCORE_TOL)
    np.testing.assert_allclose(got.score_vecs(vecs).numpy(), want.score_vecs(vecs),
                               **SCORE_TOL)
    # the embedding's own projection is untouched
    torch.testing.assert_close(temb.model.text.projection.weight.T, base, rtol=0, atol=0)


def test_reset_restores_the_embeddings_projection(embeddings):
    _, temb = embeddings
    vecs, acc, ann = make_feedback(temb, np.random.default_rng(2))
    model = OnlineModel(temb, dict(FINETUNE, rounds=5), device="cpu")
    base = model.encode_string("a dog")
    np.testing.assert_allclose(base, temb.from_string(string="a dog"), atol=1e-6)
    model.update(vecs, acc, ann, target_string="a dog")
    assert not np.array_equal(model.encode_string("a dog"), base)
    model.reset()
    np.testing.assert_allclose(model.encode_string("a dog"), base, rtol=0, atol=0)


def _params(bt, mode):
    opts = LINEAR if mode == "linear" else FINETUNE
    return bt.SessionParams(
        index_spec=bt.IndexSpec(d_name="smoke", i_name="multiscale"),
        interactive="textual", batch_size=3, shortlist_size=20,
        interactive_options=dict(opts, vector_box_min_iou=0.1),
        index_options={"use_pallas": True},
    )


@pytest.fixture(scope="module")
def smoke_root(tmp_path_factory):
    """chip_smoke.py phase 4's root: 80 images whose positives hold a tile
    near the text embedding of "a dog" under the `clip-custom:` artifact
    (64-wide heads, seeded weights) that its info.json names."""
    root = tmp_path_factory.mktemp("textual") / "root"
    _, gt, _ = write_synthetic_root(root)
    return str(root), gt


@pytest.mark.parametrize("mode", ["linear", "finetune"])
def test_textual_session_matches_jax(smoke_root, monkeypatch, mode):
    """Same dbidxs and activation scores every round, same model losses."""
    monkeypatch.setenv("SEESAW_FUSED_ATTN_INTERPRET", "1")
    root, gt = smoke_root
    s_jax = jax_make_session(JaxGDM(root), _params(jbt, mode))["session"]
    s_torch = torch_make_session(TorchGDM(root), _params(tbt, mode), device="cpu")["session"]
    want = drive_textual_session(s_jax, gt, ROUNDS, text=QSTR, box_type=jbt.Box)
    got = drive_textual_session(s_torch, gt, ROUNDS, text=QSTR, box_type=tbt.Box)
    for r, ((gd, gs), (wd, ws)) in enumerate(zip(got, want)):
        assert gd == wd, f"round {r}"
        np.testing.assert_allclose(gs, ws, **SCORE_TOL, err_msg=f"round {r}")
    assert s_torch.loop._updated and s_jax.loop._updated
    np.testing.assert_allclose(s_torch.loop.model.losses, s_jax.loop.model.losses, **LOSS_TOL)
    assert s_torch.accepted.to_array().tolist() == s_jax.accepted.to_array().tolist()
    assert len(s_torch.accepted) > 1  # feedback found positives past the first batch


def test_box_batches_match_jax():
    """The 'computed' strategy's geometry: best square crops, padding and
    intersections, against the JAX package's box batches."""
    from seesaw_tpu import box_utils as JB
    from seesaw_tpu_torch import box_utils as TB

    rng = np.random.default_rng(4)
    x1, y1 = rng.uniform(0, 80, size=(2, 12))
    w, h = rng.uniform(1, 60, size=(2, 12))
    xyxy = np.stack([x1, y1, np.minimum(x1 + w, 96), np.minimum(y1 + h, 80)], axis=1)
    jb = JB.BoundingBoxBatch.from_boxbatch(JB.BoxBatch.from_xyxy(xyxy), 96, 80)
    tb = TB.BoundingBoxBatch.from_boxbatch(TB.BoxBatch.from_xyxy(xyxy), 96, 80)
    for min_side in (0, 32, 64, 200):
        np.testing.assert_array_equal(tb.best_square_box(min_side=min_side).to_xyxy(),
                                      jb.best_square_box(min_side=min_side).to_xyxy())
    np.testing.assert_array_equal(tb.pad(5.0).to_xyxy(), jb.pad(5.0).to_xyxy())
    other = xyxy[::-1].copy()
    np.testing.assert_array_equal(
        tb.intersection(TB.BoxBatch.from_xyxy(other)).to_xyxy(),
        jb.intersection(JB.BoxBatch.from_xyxy(other)).to_xyxy())
    np.testing.assert_array_equal(tb.area(), jb.area())
    with pytest.raises(ValueError):
        TB.Segment.from_x1x2(x1=np.array([2.0]), x2=np.array([1.0]))


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    """4 random 96 x 80 PNG images as a dataset both packages open."""
    import PIL.Image

    from seesaw_tpu.dataset import GlobalDataManager as JGDM

    rng = np.random.default_rng(0)
    img_dir = tmp_path_factory.mktemp("imgs")
    for i in range(4):
        arr = (rng.random((80, 96, 3)) * 255).astype(np.uint8)
        PIL.Image.fromarray(arr).save(img_dir / f"i{i}.png")
    root = tmp_path_factory.mktemp("image_root") / "root"
    JGDM(str(root)).create_dataset("cimg", image_src=str(img_dir))
    return str(root)


def test_compute_box_vectors_matches_jax(embeddings, image_root):
    from types import SimpleNamespace

    from seesaw_tpu.loops.textual import compute_box_vectors as jax_compute
    from seesaw_tpu_torch.loops.textual import compute_box_vectors

    jemb, temb = embeddings
    boxes = [(10, 10, 50, 40, "a cat", False), (5, 5, 60, 90, "a dog", True)]
    want = jax_compute(SimpleNamespace(embedding=jemb), JaxGDM(image_root).get_dataset("cimg"),
                       1, [jbt.Box(x1=a, y1=b, x2=c, y2=d, description=s, marked_accepted=m)
                           for a, b, c, d, s, m in boxes])
    got = compute_box_vectors(SimpleNamespace(embedding=temb),
                              TorchGDM(image_root).get_dataset("cimg"), 1,
                              [tbt.Box(x1=a, y1=b, x2=c, y2=d, description=s, marked_accepted=m)
                               for a, b, c, d, s, m in boxes])
    assert got[0].shape == (2, temb.dim)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    assert list(got[1]) == list(want[1]) == ["a cat", "a dog"]
    assert list(got[2]) == list(want[2]) == [False, True]


def test_computed_strategy_loop(embeddings, image_root):
    """'computed' strategy end to end on the port: refine embeds square
    crops around the labeled boxes, and the linear model ranks the index."""
    from seesaw_tpu_torch.convert import index_from_arrays
    from seesaw_tpu_torch.indices.meta import VectorMeta
    from seesaw_tpu_torch.loops.textual import TextualFeedback

    _, temb = embeddings
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(8, temb.dim)).astype(np.float32)
    meta, order = VectorMeta.from_arrays(
        np.repeat(np.arange(4), 2), np.ones(8, np.int32),
        np.tile(np.array([[0, 0, 48, 40], [48, 40, 96, 80]], np.float32), (4, 1)))
    idx = index_from_arrays(vecs[order], meta, device="cpu", embedding=temb)
    p = tbt.SessionParams(
        index_spec=tbt.IndexSpec(d_name="cimg", i_name="ms"), interactive="textual",
        batch_size=2, shortlist_size=4, image_vector_strategy="computed",
        interactive_options=dict(mode="linear", rounds=4, num_warmup_steps=1,
                                 image_loss_weight=0.5, rank_margin=0.1))
    loop = TextualFeedback(TorchGDM(image_root), idx.new_query(), p)
    loop.state.curr_str = "a dog"
    loop.set_text_vec(idx.string2vec("a dog"))
    loop.q.label_db.put(0, [tbt.Box(x1=10, y1=10, x2=50, y2=40, description="a cat",
                                    marked_accepted=False)])
    loop.q.label_db.put(1, [tbt.Box(x1=5, y1=5, x2=60, y2=60, description="a dog",
                                    marked_accepted=True)])
    loop.refine()
    assert loop._updated and len(loop.model.losses) == 5
    out = loop.next_batch()
    assert len(out["dbidxs"]) == 2
