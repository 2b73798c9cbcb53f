"""The port's CLIP fine-tuning (`seesaw_tpu_torch.models.clip_finetune`)
against the JAX package's (`seesaw_tpu.models.clip_finetune`) on the CPU,
on the same weights (the JAX init, carried over by
`convert.clip_params_from_arrays`) and the same numpy inputs. The JAX side
reaches its Pallas attention forward and backward in interpret mode.

Tolerances:
- the loss on the same features: 1e-6;
- the grouped optimizer against optax on identical gradients: rtol 1e-5,
  atol 1e-6 (f32 Adam arithmetic in another order: ~1e-5 of one step of
  lr 0.02-0.1);
- `CLIPFineTuner`, f32: per-step losses rtol 2e-5 (the towers' f32 sums in
  another order, through the updates); tuned parameters atol 1e-5, except
  the attention layers' k_proj biases: their gradient is zero up to
  rounding (softmax is unchanged by a shift common to every key), and Adam
  turns that rounding noise into steps of up to about lr each, so they are
  held within 2 lr per step;
- bf16 (the config of tests/test_clip_finetune.py:132-139 as it is):
  per-step losses rtol 2e-2 (bf16 rounds each dense layer's inputs and
  outputs, 2^-8 relative, at other places in the two frameworks); frozen
  parameters bit-identical in both dtypes.
"""
import dataclasses
import random

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from seesaw_tpu.models import clip as J
from seesaw_tpu.models import clip_finetune as JF
from seesaw_tpu_torch.convert import clip_arrays_from_state_dict, clip_params_from_arrays
from seesaw_tpu_torch.models import clip as T
from seesaw_tpu_torch.models import clip_finetune as TF
from seesaw_tpu_torch.models.registry import load_embedding
from seesaw_tpu_torch.ops import attention
from seesaw_tpu_torch.utils.rounds import drive_finetune

# tests/test_clip_finetune.py:132-135: 64-wide heads in both towers
KERNEL_CFG = dict(vision_width=128, vision_heads=2, text_width=128, text_heads=2,
                  embed_dim=32)
OPT = {"opt_config": {"": {"lr": 1e-3}, "vision/layer_0": None,
                      "text/projection": {"lr": 1e-2, "weight_decay": 0.1}},
       "warmup": 2}


def _embeddings(dtype):
    jcfg = dataclasses.replace(J.VARIANTS["test"], **KERNEL_CFG,
                               dtype=getattr(jnp, dtype))
    jemb = J.ClipEmbedding(cfg=jcfg, dtype=None)
    tcfg = dataclasses.replace(T.VARIANTS["test"], **KERNEL_CFG,
                               dtype=getattr(torch, dtype))
    temb = T.ClipEmbedding(cfg=tcfg, dtype=None, device="cpu", params=clip_params_from_arrays(
        jax.tree.map(np.asarray, jemb.params), tcfg))
    return jemb, temb


def _pairs(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(n, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    toks = rng.integers(1, cfg.vocab_size, size=(n, cfg.context_length)).astype(np.int32)
    return px, toks


def _leaves(tree):
    return {"/".join(p.key for p in path): np.asarray(a)
            for path, a in jax.tree_util.tree_leaves_with_path(tree)}


def test_contrastive_loss_matches_jax():
    rng = np.random.default_rng(0)
    img, txt = (rng.normal(size=(6, 16)).astype(np.float32) for _ in range(2))
    want = JF.clip_contrastive_loss(jnp.asarray(img), jnp.asarray(txt), jnp.asarray(2.0))
    got = TF.clip_contrastive_loss(torch.from_numpy(img), torch.from_numpy(txt),
                                   torch.tensor(2.0))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6, atol=1e-6)
    eye = torch.eye(4)
    assert (TF.clip_contrastive_loss(eye, eye, torch.tensor(2.0))
            < TF.clip_contrastive_loss(eye, eye.flip(0), torch.tensor(2.0)))


@pytest.mark.parametrize("opt_config", [
    {"text/projection": {"lr": 1e-3}},
    {"": {"lr": 1e-3}, "vision/layer_0": None, "text/projection": {"lr": 1e-2}},
    {"vision": {"lr": 1e-3}, "vision/layer_1/mlp": {"lr": 1e-4}, "logit_scale": {"lr": 1.0}},
])
def test_prefix_labels_match_jax(opt_config):
    """Each state-dict name's flax path gets the group the JAX labeler gives
    the same leaf."""
    params = J.init_params(dataclasses.replace(J.VARIANTS["test"], **KERNEL_CFG), seed=0)
    want = {path: JF._prefix_label(path, opt_config) for path in _leaves(params)}
    with torch.device("meta"):
        model = T.ClipModel(dataclasses.replace(T.VARIANTS["test"], **KERNEL_CFG))
    got = {T.flax_path(n): TF._prefix_label(T.flax_path(n), opt_config)
           for n, _ in model.named_parameters()}
    assert got == want


def test_grouped_optimizer_matches_optax():
    """5 steps on the same gradients, warmup 3 (the first step's lr is 0),
    three groups (one with weight decay) and a frozen one."""
    rng = np.random.default_rng(1)
    tree = {"text": {"projection": {"kernel": rng.normal(size=(4, 3))},
                     "layer_0": {"w": rng.normal(size=(5,))}},
            "vision": {"a": rng.normal(size=(2, 2)), "b": rng.normal(size=(3,))},
            "logit_scale": np.float64(2.0)}
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)
    opt_config = {"text": {"lr": 0.1, "weight_decay": 0.1}, "text/projection": {"lr": 0.05},
                  "vision": {"lr": 0.02}, "vision/b": None}
    tx = JF.make_grouped_optimizer(tree, opt_config, warmup_steps=3)
    jparams = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jparams)
    named = {k: torch.tensor(v) for k, v in _leaves(tree).items()}
    opt = TF.make_grouped_optimizer(named, opt_config, warmup_steps=3)
    # vision/b maps to None, logit_scale to no prefix
    assert {k for k, p in named.items() if not p.requires_grad} == {"vision/b", "logit_scale"}
    for step in range(5):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for k, g in _leaves(grads).items():
            if named[k].requires_grad:
                named[k].grad = torch.from_numpy(g.copy())
        opt.step()
        opt.zero_grad()
        for k, want in _leaves(jparams).items():
            np.testing.assert_allclose(named[k].detach().numpy(), want, rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k} step {step}")
        if step == 0:  # lr 0: nothing moved
            for k, a in _leaves(tree).items():
                np.testing.assert_array_equal(named[k].detach().numpy(), a)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_finetuner_matches_jax(monkeypatch, dtype):
    monkeypatch.setenv("SEESAW_FUSED_ATTN_INTERPRET", "1")
    jemb, temb = _embeddings(dtype)
    source = temb.state_dict()
    px, toks = _pairs(temb.cfg, 16)
    want = JF.CLIPFineTuner(jemb, OPT).fit(px, toks, epochs=2, batch_size=6, seed=1)
    got = TF.CLIPFineTuner(temb, OPT, device="cpu").fit(px, toks, epochs=2, batch_size=6,
                                                        seed=1)
    assert len(got.losses) == len(want.losses) == 4  # 16 // 6 steps an epoch
    assert np.isfinite(got.losses).all()
    np.testing.assert_allclose(got.losses, want.losses,
                               rtol=2e-5 if dtype == "float32" else 2e-2)
    tuned = _leaves(clip_arrays_from_state_dict(got.model.state_dict()))
    wanted = _leaves(jax.tree.map(lambda a: np.asarray(a, np.float32), want.params))
    assert tuned.keys() == wanted.keys()
    steps = len(got.losses)
    for path, a in tuned.items():
        b = wanted[path]
        if path.startswith("vision/layer_0/"):  # frozen
            np.testing.assert_array_equal(a, b, err_msg=path)
            np.testing.assert_array_equal(a, _leaves(jemb.params)[path], err_msg=path)
        elif dtype == "float32":
            bar = 2 * 1e-3 * steps if path.endswith("k_proj/bias") else 1e-5
            np.testing.assert_allclose(a, b, rtol=0, atol=bar, err_msg=path)
    # the source embedding is unchanged
    for k, v in temb.state_dict().items():
        torch.testing.assert_close(v, source[k], rtol=0, atol=0)


def test_default_config_trains_the_projection_only():
    _, temb = _embeddings("float32")
    tuner = TF.CLIPFineTuner(temb, {"lr": 1e-2}, device="cpu")
    trains = [n for n, p in tuner.model.named_parameters() if p.requires_grad]
    assert trains == ["text.projection.weight"]
    before = tuner.state_dict()
    tuner.fit(*_pairs(temb.cfg, 8), batch_size=8)
    after = tuner.state_dict()
    for k in before:
        assert torch.equal(before[k], after[k]) == (k != "text.projection.weight"), k


def test_tuning_leaves_the_registry_embedding_unchanged():
    emb = load_embedding("clip-test", "cpu")
    before = emb.state_dict()
    tuner = TF.CLIPFineTuner(emb, {"opt_config": {"": {"lr": 1e-2}}}, device="cpu")
    tuner.fit(*_pairs(emb.cfg, 8), batch_size=4)
    assert load_embedding("clip-test", "cpu") is emb
    assert not any(p.requires_grad for p in emb.model.parameters())
    for k, v in emb.state_dict().items():
        torch.testing.assert_close(v, before[k], rtol=0, atol=0)
    key = "text.projection.weight"
    assert not torch.equal(tuner.state_dict()[key], before[key])


def test_to_embedding_preserves_custom_cfg():
    _, temb = _embeddings("bfloat16")
    tuner = TF.CLIPFineTuner(temb, {"opt_config": {"": {"lr": 1e-3}}}, device="cpu")
    px, toks = _pairs(temb.cfg, 8)
    tuner.fit(px, toks, epochs=4, batch_size=8)
    assert tuner.losses[-1] < tuner.losses[0]
    out = tuner.to_embedding()
    assert out.cfg == temb.cfg and out.cfg.dtype == torch.bfloat16
    feats = out.encode_image_batch(torch.from_numpy(px))
    assert feats.shape == (8, temb.cfg.embed_dim) and bool(torch.isfinite(feats).all())
    for k, v in out.state_dict().items():
        torch.testing.assert_close(v, tuner.state_dict()[k], rtol=0, atol=0)


def test_drive_finetune_on_the_cpu():
    _, temb = _embeddings("float32")
    before = attention.pair_attention.launches, attention.pair_attention_bwd.launches
    out = drive_finetune(temb, {"opt_config": {"": {"lr": 1e-3}}, "warmup": 1},
                         device="cpu", batch=6, steps=3, warmup_steps=1,
                         generator=torch.Generator().manual_seed(0))
    assert len(out["losses"]) == 4 and len(out["step_ms"]) == 3
    assert np.isfinite(out["losses"]).all() and out["losses"][-1] < out["losses"][0]
    # the CPU runs the plain versions: no kernel launch
    assert out["fwd_launches"] == out["bwd_launches"] == [0] * 4
    assert (attention.pair_attention.launches,
            attention.pair_attention_bwd.launches) == before


def test_sample_search_space_matches_jax():
    space = {"lr": {"loguniform": [1e-5, 1e-2]}, "bs": {"choose": [8, 16]},
             "nested": {"wd": {"choose": [0.0, 0.1]}}, "fixed": 7}
    for seed in range(3):
        assert (TF.sample_search_space(space, random.Random(seed))
                == JF.sample_search_space(space, random.Random(seed)))


@pytest.mark.parametrize("seed", [0, 1])
def test_successive_halving_matches_jax(tmp_path, seed):
    def evaluate(cfg, budget):
        return abs(cfg["x"] - 3.0) / budget + cfg["lr"]

    space = {"x": {"choose": [0.0, 1.0, 2.9, 5.0]}, "lr": {"loguniform": [1e-4, 1e-2]}}
    kw = dict(n_trials=6, rungs=[1, 2, 4], eta=2, seed=seed)
    want = JF.successive_halving_search(space, evaluate, **kw)
    got = TF.successive_halving_search(space, evaluate, **kw,
                                       checkpoint_dir=str(tmp_path))
    assert got == want
    calls = []
    again = TF.successive_halving_search(space, lambda c, b: calls.append(1), **kw,
                                         checkpoint_dir=str(tmp_path))
    assert again == want and not calls  # every evaluation replayed from the checkpoint
