"""The port's checkpoint converter (`python -m
seesaw_tpu_torch.models.convert_checkpoint`) against the JAX package's
`scripts/convert_clip_checkpoint.py`, on a tiny HF CLIP state dict and
`config.json` that the test writes itself (seeded numpy weights; nothing
is downloaded).

The state dict is written twice: as `model.safetensors`, by hand (an
8-byte little-endian header length, a JSON header, the raw buffer), and as
`pytorch_model.bin` through `torch.save`. Both conversions must give the
JAX converter's params.npz bit for bit; the artifact then loads through
both packages' registries as `clip-custom:<dir>`, whose text and image
embeddings agree at 1e-5 (unit vectors through 2 f32 layers, summed in
another order; 12-wide heads take the einsum path in both).
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from seesaw_tpu_torch.models import convert_checkpoint as cc

REPO = Path(__file__).resolve().parent.parent
HF_CONFIG = {
    "projection_dim": 8,
    "vision_config": {"image_size": 32, "patch_size": 16, "hidden_size": 24,
                      "num_hidden_layers": 2, "num_attention_heads": 2},
    "text_config": {"vocab_size": 128, "max_position_embeddings": 16, "hidden_size": 16,
                    "num_hidden_layers": 2, "num_attention_heads": 2},
}


def hf_state_dict(seed=0) -> dict:
    """Every tensor of a HF `CLIPModel.state_dict()` for HF_CONFIG, as f32
    numpy arrays of seeded normals."""
    rng = np.random.default_rng(seed)
    v, t = HF_CONFIG["vision_config"], HF_CONFIG["text_config"]
    shapes = {"logit_scale": (), "visual_projection.weight": (8, v["hidden_size"]),
              "text_projection.weight": (8, t["hidden_size"])}
    W, p = v["hidden_size"], v["patch_size"]
    shapes.update({
        "vision_model.embeddings.patch_embedding.weight": (W, 3, p, p),
        "vision_model.embeddings.class_embedding": (W,),
        "vision_model.embeddings.position_embedding.weight": ((v["image_size"] // p) ** 2 + 1, W),
        "text_model.embeddings.token_embedding.weight": (t["vocab_size"], t["hidden_size"]),
        "text_model.embeddings.position_embedding.weight": (t["max_position_embeddings"],
                                                           t["hidden_size"]),
    })
    for ln, width in (("vision_model.pre_layrnorm", W), ("vision_model.post_layernorm", W),
                      ("text_model.final_layer_norm", t["hidden_size"])):
        shapes[f"{ln}.weight"] = shapes[f"{ln}.bias"] = (width,)
    for tower, cfg in (("vision_model", v), ("text_model", t)):
        w = cfg["hidden_size"]
        for i in range(cfg["num_hidden_layers"]):
            pre = f"{tower}.encoder.layers.{i}"
            for name in ("layer_norm1", "layer_norm2"):
                shapes[f"{pre}.{name}.weight"] = shapes[f"{pre}.{name}.bias"] = (w,)
            for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
                shapes[f"{pre}.self_attn.{name}.weight"] = (w, w)
                shapes[f"{pre}.self_attn.{name}.bias"] = (w,)
            shapes[f"{pre}.mlp.fc1.weight"], shapes[f"{pre}.mlp.fc1.bias"] = (4 * w, w), (4 * w,)
            shapes[f"{pre}.mlp.fc2.weight"], shapes[f"{pre}.mlp.fc2.bias"] = (w, 4 * w), (w,)
    return {k: np.asarray(rng.normal(size=s) * 0.2, np.float32) for k, s in sorted(shapes.items())}


def write_safetensors(path: Path, sd: dict, bf16: tuple = ()):
    """The safetensors layout by hand; tensors named in `bf16` are stored as
    BF16 (their f32 values must be exact in bf16)."""
    header, chunks, off = {}, [], 0
    for name, a in sd.items():
        if name in bf16:
            raw = (a.astype("<f4").view("<u4") >> 16).astype("<u2").tobytes()
            dtype = "BF16"
        else:
            raw, dtype = a.astype("<f4").tobytes(), "F32"
        header[name] = {"dtype": dtype, "shape": list(a.shape),
                        "data_offsets": [off, off + len(raw)]}
        chunks.append(raw)
        off += len(raw)
    header["__metadata__"] = {"format": "pt"}
    blob = json.dumps(header).encode()
    path.write_bytes(len(blob).to_bytes(8, "little") + blob + b"".join(chunks))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    sd = hf_state_dict()
    dirs = {}
    for fmt in ("safetensors", "bin"):
        d = tmp_path_factory.mktemp(f"hf_{fmt}")
        (d / "config.json").write_text(json.dumps(HF_CONFIG))
        if fmt == "safetensors":
            write_safetensors(d / "model.safetensors", sd)
        else:
            torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, d / "pytorch_model.bin")
        dirs[fmt] = d
    return sd, dirs


def _jax_convert(hf_dir: Path, out: Path):
    spec = importlib.util.spec_from_file_location(
        "convert_clip_checkpoint", REPO / "scripts" / "convert_clip_checkpoint.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.convert(str(hf_dir), str(out), "custom")


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_convert_matches_jax_converter(checkpoints, tmp_path, fmt):
    _, dirs = checkpoints
    got_dir = cc.convert(str(dirs[fmt]), str(tmp_path / "port"), "custom")
    want_dir = _jax_convert(dirs["bin"], tmp_path / "jax")
    got, want = _npz(got_dir / "params.npz"), _npz(want_dir / "params.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    info_g = json.loads((got_dir / "info.json").read_text())
    info_w = json.loads((want_dir / "info.json").read_text())
    assert {k: v for k, v in info_g.items() if k != "source"} == \
        {k: v for k, v in info_w.items() if k != "source"}


def test_artifact_loads_in_both_registries(checkpoints, tmp_path):
    from seesaw_tpu.models.registry import load_embedding as j_load
    from seesaw_tpu_torch.models.clip import ClipEmbedding
    from seesaw_tpu_torch.models.registry import load_embedding as t_load

    _, dirs = checkpoints
    out = cc.convert(str(dirs["safetensors"]), str(tmp_path / "art"), "custom")
    name = f"clip-custom:{out}"
    t_emb, j_emb = t_load(name, "cpu"), j_load(name)
    assert isinstance(t_emb, ClipEmbedding) and t_emb.dim == j_emb.dim == 8
    strings = ["a dog", "two cats on a couch"]
    np.testing.assert_allclose(t_emb.from_string(str_list=strings),
                               j_emb.from_string(str_list=strings), atol=1e-5)
    px = np.random.default_rng(0).normal(size=(2, 32, 32, 3)).astype(np.float32)
    np.testing.assert_allclose(t_emb.from_image(preprocessed_image=px),
                               j_emb.from_image(preprocessed_image=px), atol=1e-5)


def test_safetensors_reader(tmp_path):
    """F32 and BF16 tensors, a scalar, and the metadata entry."""
    sd = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
          "b": np.array([1.5, -2.0, 0.25], np.float32), "s": np.array(3.0, np.float32)}
    write_safetensors(tmp_path / "m.safetensors", sd, bf16=("b",))
    got = cc.read_safetensors(tmp_path / "m.safetensors")
    assert sorted(got) == ["a", "b", "s"]
    for k, v in sd.items():
        assert got[k].dtype == np.float32 and got[k].shape == v.shape
        np.testing.assert_array_equal(got[k], v)


def test_cli_copies_vocabulary(checkpoints, tmp_path):
    _, dirs = checkpoints
    src = tmp_path / "hf"
    src.mkdir()
    for f in ("config.json", "pytorch_model.bin"):
        (src / f).write_bytes((dirs["bin"] / f).read_bytes())
    (src / "vocab.json").write_text("{}")
    (src / "merges.txt").write_text("#version: 0.2\n")
    out = subprocess.run(
        [sys.executable, "-m", "seesaw_tpu_torch.models.convert_checkpoint", str(src),
         str(tmp_path / "out"), "--variant", "custom"],
        cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)), capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert f"clip-custom:{tmp_path / 'out'}" in out.stdout
    for f in ("params.npz", "info.json", "vocab.json", "merges.txt"):
        assert (tmp_path / "out" / f).exists()
    assert json.loads((tmp_path / "out" / "info.json").read_text())["variant"] == "custom"
