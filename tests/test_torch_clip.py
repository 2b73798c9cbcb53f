"""The port's CLIP (`seesaw_tpu_torch.models.clip`) against the JAX package's
flax CLIP on the same weights and inputs, on the CPU.

Weights: the JAX `init_params`, carried to the port by
`convert.clip_params_from_arrays`. Configs: the kernel-eligible ones of
tests/test_pallas_attention.py (vision: width 128, 2 heads; text: width 128,
2 heads, so head_dim 64) and `VARIANTS["test"]` (head_dim 12: the einsum
path in both packages). Where the JAX side should reach the Pallas kernel
(K5) it runs in interpret mode (`SEESAW_FUSED_ATTN_INTERPRET=1`, as the JAX
package's own tests); the "einsum" cases hold the port against the JAX
einsum path (`fused_attention=False` there). On the CPU the port's
attention takes its plain version.

Tolerance: f32 atol/rtol 1e-4, the bar of the JAX package's own wiring
tests (f32 sums in another order through a few layers); the unit
embeddings of `ClipEmbedding` 1e-5; parameters moved through files exactly.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from seesaw_tpu.models import clip as J
from seesaw_tpu.models.tokenizer import HashTokenizer as JaxHashTokenizer
from seesaw_tpu_torch.convert import clip_params_from_arrays
from seesaw_tpu_torch.models import clip as T
from seesaw_tpu_torch.models.tokenizer import HashTokenizer

# tests/test_pallas_attention.py:140-144 and :79-83
VISION_CFG = dict(embed_dim=32, image_size=32, patch_size=16, vision_width=128,
                  vision_layers=2, vision_heads=2, vocab_size=99, context_length=12,
                  text_width=32, text_layers=1, text_heads=4)
TEXT_CFG = dict(embed_dim=32, image_size=32, patch_size=16, vision_width=48,
                vision_layers=1, vision_heads=4, vocab_size=99, context_length=16,
                text_width=128, text_layers=2, text_heads=2)
BOTH_CFG = dict(VISION_CFG, text_width=128, text_layers=2, text_heads=2, context_length=16)
CONFIGS = {"vision": VISION_CFG, "text": TEXT_CFG, "both": BOTH_CFG,
           "test": J.config_to_info(J.VARIANTS["test"])}
TOL = dict(atol=1e-4, rtol=1e-4)


def _cfgs(name, jax_path="kernel"):
    info = CONFIGS[name]
    jcfg = J.ClipConfig(**info, fused_attention=(jax_path == "kernel"))
    return jcfg, T.ClipConfig(**info)


@pytest.fixture(scope="module")
def weights():
    """name -> (JAX params, port state dict) from the JAX init."""
    out = {}
    for name in CONFIGS:
        params = J.init_params(J.ClipConfig(**CONFIGS[name]), seed=0)
        tree = jax.tree.map(np.asarray, params)
        out[name] = params, clip_params_from_arrays(tree, T.ClipConfig(**CONFIGS[name]))
    return out


@pytest.fixture
def jax_kernel(monkeypatch):
    monkeypatch.setenv("SEESAW_FUSED_ATTN_INTERPRET", "1")


def _port_model(tcfg, sd):
    m = T.ClipModel(tcfg)
    m.load_state_dict(sd)
    return m.eval()


def _inputs(cfg, seed, B=3):
    rng = np.random.default_rng(seed)
    px = rng.normal(size=(B, cfg.image_size, cfg.image_size, 3)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size - 1, size=(B, cfg.context_length)).astype(np.int32)
    # an EOT (the largest id) at a different place in each row, zero after it
    for i, n in enumerate(rng.integers(2, cfg.context_length, size=B)):
        toks[i, n] = cfg.vocab_size - 1
        toks[i, n + 1:] = 0
    return px, toks


@pytest.mark.parametrize("tower,jax_path", [
    ("vision", "kernel"), ("vision", "einsum"), ("text", "kernel"), ("text", "einsum"),
])
def test_attention_module_matches_jax(weights, jax_kernel, tower, jax_path):
    jcfg, tcfg = _cfgs(tower, jax_path)
    params, sd = weights[tower]
    width, heads = (jcfg.vision_width, jcfg.vision_heads) if tower == "vision" else (
        jcfg.text_width, jcfg.text_heads)
    causal = tower == "text"
    x = np.random.default_rng(1).normal(size=(3, 11, width)).astype(np.float32)
    mask = jnp.triu(jnp.full((11, 11), -jnp.inf), k=1) if causal else None
    want = J.MultiHeadAttention(width, heads, fused=jcfg.fused_attention, causal=causal).apply(
        {"params": params[tower]["layer_0"]["self_attn"]}, jnp.asarray(x), mask)
    module = getattr(_port_model(tcfg, sd), tower).layer_0.self_attn
    with torch.no_grad():
        got = module(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name,jax_path", [
    ("vision", "kernel"), ("vision", "einsum"), ("test", "einsum"),
])
def test_vision_tower_matches_jax(weights, jax_kernel, name, jax_path):
    jcfg, tcfg = _cfgs(name, jax_path)
    params, sd = weights[name]
    px, _ = _inputs(jcfg, 3)
    want = J.VisionTower(jcfg).apply({"params": params["vision"]}, jnp.asarray(px))
    with torch.no_grad():
        got = _port_model(tcfg, sd).vision(torch.from_numpy(px))
    assert got.dtype == torch.float32 and got.shape == (3, jcfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name,jax_path", [
    ("text", "kernel"), ("text", "einsum"), ("test", "einsum"),
])
def test_text_tower_matches_jax(weights, jax_kernel, name, jax_path):
    jcfg, tcfg = _cfgs(name, jax_path)
    params, sd = weights[name]
    _, toks = _inputs(jcfg, 9)
    text = J.TextTower(jcfg)
    want = text.apply({"params": params["text"]}, jnp.asarray(toks))
    want_pre = text.apply({"params": params["text"]}, jnp.asarray(toks),
                          return_preprojection=True)
    model = _port_model(tcfg, sd)
    with torch.no_grad():
        got = model.text(torch.from_numpy(toks))
        got_pre = model.encode_text_preproj(torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(got_pre.numpy(), np.asarray(want_pre), **TOL)


@pytest.mark.parametrize("name", ["both", "test"])
def test_clip_model_matches_jax(weights, jax_kernel, name):
    jcfg, tcfg = _cfgs(name)
    params, sd = weights[name]
    px, toks = _inputs(jcfg, 4)
    want = J.ClipModel(jcfg).apply({"params": params}, jnp.asarray(px), jnp.asarray(toks))
    with torch.no_grad():
        got = _port_model(tcfg, sd)(torch.from_numpy(px), torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("name,vision_calls,text_calls", [
    ("vision", 2, 0), ("text", 0, 2), ("both", 2, 2), ("test", 0, 0),
])
def test_attention_gate(weights, monkeypatch, name, vision_calls, text_calls):
    """The kernel's entry point is called exactly where the JAX package
    reaches its Pallas kernel: head_dim 64, even heads, L <= 384."""
    calls, kernel_entry = [], T.pair_attention

    def counting(q, k, v, *, causal=False, heads=None):
        calls.append(causal)
        return kernel_entry(q, k, v, causal=causal, heads=heads)

    monkeypatch.setattr(T, "pair_attention", counting)
    _, tcfg = _cfgs(name)
    px, toks = _inputs(tcfg, 5)
    model = _port_model(tcfg, weights[name][1])
    with torch.no_grad():
        model.encode_image(torch.from_numpy(px))
        assert calls == [False] * vision_calls
        model.encode_text(torch.from_numpy(toks))
    assert calls == [False] * vision_calls + [True] * text_calls


@pytest.mark.parametrize("name", ["both", "test"])
def test_embedding_matches_jax(weights, jax_kernel, name):
    jcfg, tcfg = _cfgs(name)
    params, sd = weights[name]
    want = J.ClipEmbedding(params=params, cfg=jcfg,
                           tokenizer=JaxHashTokenizer(jcfg.context_length, jcfg.vocab_size))
    got = T.ClipEmbedding(name, device="cpu", params=sd, cfg=tcfg,
                          tokenizer=HashTokenizer(tcfg.context_length, tcfg.vocab_size))
    assert got.dim == want.dim == jcfg.embed_dim
    strings = ["a photo of a dog", "two cats on a red couch", "x"]
    v = got.from_string(string=strings[0])
    assert v.shape == (jcfg.embed_dim,) and got.from_string(string=strings[0]) is v
    np.testing.assert_allclose(v, want.from_string(string=strings[0]), atol=1e-5)
    np.testing.assert_allclose(got.from_string(str_list=strings),
                               want.from_string(str_list=strings), atol=1e-5)
    rng = np.random.default_rng(6)
    for hw in [(32, 32), (48, 64), (100, 40)]:
        img = (rng.random(hw + (3,)) * 255).astype(np.uint8)
        g = got.from_raw(img)
        assert g.shape == (1, jcfg.embed_dim)
        np.testing.assert_allclose(g, want.from_raw(img), atol=1e-5)
    px, _ = _inputs(jcfg, 7, B=4)
    np.testing.assert_allclose(got.from_image(preprocessed_image=px),
                               want.from_image(preprocessed_image=px), atol=1e-5)
    batch = got.encode_image_batch(torch.from_numpy(px))
    assert isinstance(batch, torch.Tensor) and batch.shape == (4, jcfg.embed_dim)
    np.testing.assert_allclose(batch.numpy(), np.asarray(want.encode_image_batch(jnp.asarray(px))),
                               **TOL)


def test_params_npz_both_ways(weights, tmp_path):
    """The JAX package's params.npz loads in the port, and the port's loads
    in the JAX package, bit for bit."""
    params, sd = weights["both"]
    jcfg, tcfg = _cfgs("both")
    J.save_params_npz(params, str(tmp_path / "jax.npz"))
    got = T.load_checkpoint(str(tmp_path / "jax.npz"), tcfg)
    assert set(got) == set(sd)
    for k in sd:
        torch.testing.assert_close(got[k], sd[k], rtol=0, atol=0)
    T.save_params_npz(sd, str(tmp_path / "port.npz"))
    back = J.load_checkpoint(str(tmp_path / "port.npz"), jcfg)
    want = jax.tree_util.tree_leaves_with_path(params)
    flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(want)
    for path, leaf in want:
        np.testing.assert_array_equal(np.asarray(flat[path]), np.asarray(leaf))


def test_params_check_the_config(weights):
    params, _ = weights["test"]
    tree = jax.tree.map(np.asarray, params)
    with pytest.raises(ValueError, match="do not match"):
        clip_params_from_arrays(tree, T.ClipConfig(**CONFIGS["both"]))


def test_init_params_layout(weights):
    """The port's random init has the JAX init's names and shapes, is the
    same for the same generator seed, and loads into the model."""
    _, tcfg = _cfgs("both")
    _, sd = weights["both"]
    a = T.init_params(tcfg, torch.Generator().manual_seed(0))
    b = T.init_params(tcfg, torch.Generator().manual_seed(0))
    c = T.init_params(tcfg, torch.Generator().manual_seed(1))
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in sd.items()}
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["vision.layer_0.mlp.fc1.weight"], c["vision.layer_0.mlp.fc1.weight"])
    assert torch.equal(a["text.final_layer_norm.weight"], torch.ones(tcfg.text_width))
    _port_model(tcfg, a)


def test_configs_match_jax():
    for name, jcfg in J.VARIANTS.items():
        tcfg = T.VARIANTS[name]
        assert T.config_to_info(tcfg) == J.config_to_info(jcfg)
        assert tcfg.grid == jcfg.grid
    info = J.config_to_info(J.VARIANTS["vit-l14"])
    assert T.config_to_info(T.config_from_info(info)) == info
    hf = {"projection_dim": 768,
          "text_config": {"hidden_size": 768, "num_attention_heads": 12},
          "vision_config": {"hidden_size": 1024, "patch_size": 14, "num_hidden_layers": 24}}
    assert T.config_to_info(T.config_from_hf(hf)) == J.config_to_info(J.config_from_hf(hf))
    np.testing.assert_array_equal(T.CLIP_MEAN, J.CLIP_MEAN)
    np.testing.assert_array_equal(T.CLIP_STD, J.CLIP_STD)
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(T.quick_gelu(torch.from_numpy(x)).numpy(),
                               np.asarray(J.quick_gelu(jnp.asarray(x))), atol=1e-6)


# -- checkpoints from HF transformers (the golden test's route) --------------
@pytest.fixture(scope="module")
def hf_artifact(tmp_path_factory):
    pytest.importorskip("transformers")
    from transformers import CLIPConfig, CLIPModel, CLIPTokenizer

    from seesaw_tpu.models.bpe_train import write_artifacts

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from test_tokenizer_parity import CORPUS

    d = tmp_path_factory.mktemp("hf_ckpt")
    vocab_path, merges_path = write_artifacts(d, CORPUS, n_merges=200)
    tok = CLIPTokenizer(str(vocab_path), str(merges_path), model_max_length=16)
    cfg = CLIPConfig(
        projection_dim=32,
        text_config=dict(hidden_size=128, intermediate_size=512, num_hidden_layers=2,
                         num_attention_heads=2, vocab_size=tok.vocab_size,
                         max_position_embeddings=16, hidden_act="quick_gelu",
                         bos_token_id=tok.bos_token_id, eos_token_id=tok.eos_token_id),
        vision_config=dict(hidden_size=128, intermediate_size=512, num_hidden_layers=2,
                           num_attention_heads=2, image_size=32, patch_size=16,
                           hidden_act="quick_gelu"),
    )
    torch.manual_seed(0)
    hf = CLIPModel(cfg).eval()
    hf.save_pretrained(d, safe_serialization=True)
    torch.save(hf.state_dict(), d / "state_dict.pt")

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    from convert_clip_checkpoint import convert

    out = tmp_path_factory.mktemp("artifact")
    convert(str(d), str(out), variant="custom")
    return d, out


def test_registry_loads_artifact(hf_artifact, jax_kernel):
    """An artifact dir (params.npz + info.json + BPE vocab) through both
    registries: the same unit embeddings for strings and images."""
    from seesaw_tpu.models.registry import load_embedding as jax_load
    from seesaw_tpu_torch.models.registry import _cache, load_embedding
    from seesaw_tpu_torch.models.tokenizer import BpeTokenizer

    _, artifact = hf_artifact
    name = f"clip-custom:{artifact}"
    got, want = load_embedding(name, "cpu"), jax_load(name)
    assert isinstance(got.tokenizer, BpeTokenizer) and got.dim == 32
    assert load_embedding(name, torch.device("cpu")) is got
    assert (name, "cpu") in _cache
    for s in ["a photo of a dog", "the quick brown fox", "café straße 123"]:
        np.testing.assert_allclose(got.from_string(string=s), want.from_string(string=s),
                                   atol=1e-5, err_msg=s)
    img = (np.random.default_rng(0).random((48, 64, 3)) * 255).astype(np.uint8)
    np.testing.assert_allclose(got.from_image(image=img), want.from_image(image=img),
                               atol=1e-5)


def test_torch_state_dict_checkpoint(hf_artifact):
    """A torch file of an HF CLIPModel state dict loads as the JAX package
    loads it."""
    d, artifact = hf_artifact
    info = J.config_from_info(json.loads((artifact / "info.json").read_text()))
    tcfg = T.config_from_info(T.config_to_info(info))
    got = T.load_checkpoint(str(d / "state_dict.pt"), tcfg)
    want = clip_params_from_arrays(
        jax.tree.map(np.asarray, J.load_checkpoint(str(d / "state_dict.pt"), info)), tcfg)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
