"""Convert a Hugging Face CLIP checkpoint directory to a CLIP artifact.

    python -m seesaw_tpu_torch.models.convert_checkpoint <hf_dir> <out_dir> [--variant vit-b32]

Input: a directory as `CLIPModel.save_pretrained` writes it (config.json and
model.safetensors or pytorch_model*.bin), with the tokenizer files
(vocab.json, merges.txt) beside them. Output: <out_dir>/params.npz (the
flax tree with flat '/'-joined keys), info.json (the architecture's sizes
and the variant) and the copied vocabulary: the artifact that both
packages' registries load as `clip-<variant>:<out_dir>`
(`ClipEmbedding.from_artifact`). The port's twin of
`scripts/convert_clip_checkpoint.py`, with no flax: the conversion is
`models.clip`'s `config_from_hf` and `convert_hf_state_dict`, and
`model.safetensors` is read directly (an 8-byte little-endian header length,
a JSON header of dtype, shape and data offsets, then the raw buffer), so no
safetensors package is needed.
"""
from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np

from .clip import (_flatten, _state_dict_from_flat, config_from_hf, config_to_info,
                   convert_hf_state_dict, save_params_npz)

_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
                       "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1", "BOOL": "?"}


def read_safetensors(path) -> dict:
    """{name: numpy array} of a .safetensors file; BF16 is widened to f32."""
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    n = int.from_bytes(raw[:8].tobytes(), "little")
    header = json.loads(raw[8:8 + n].tobytes())
    base = 8 + n
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        lo, hi = spec["data_offsets"]
        buf = raw[base + lo:base + hi]
        if spec["dtype"] == "BF16":
            a = (buf.view("<u2").astype(np.uint32) << 16).view(np.float32)
        elif spec["dtype"] in _SAFETENSORS_DTYPES:
            a = buf.view(_SAFETENSORS_DTYPES[spec["dtype"]])
        else:
            raise ValueError(f"{path}: tensor {name!r} has unsupported dtype {spec['dtype']}")
        out[name] = np.array(a).reshape(spec["shape"])
    return out


def load_hf_state_dict(hf_dir: Path) -> dict:
    """The checkpoint's HF state dict as numpy arrays."""
    st = hf_dir / "model.safetensors"
    if st.exists():
        return read_safetensors(st)
    bins = sorted(hf_dir.glob("pytorch_model*.bin"))
    if not bins:
        raise FileNotFoundError(f"no model.safetensors or pytorch_model*.bin in {hf_dir}")
    import torch

    sd = {}
    for b in bins:
        part = torch.load(b, map_location="cpu", weights_only=True)
        sd.update({k: v.float().numpy() for k, v in part.items()})
    return sd


def convert(hf_dir: str, out_dir: str, variant: str = "vit-b32") -> Path:
    hf_dir, out = Path(hf_dir), Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    cfg = config_from_hf(json.loads((hf_dir / "config.json").read_text()))
    # a "clip." prefix wraps the keys in some exports
    sd = {k.removeprefix("clip."): v for k, v in load_hf_state_dict(hf_dir).items()}
    params = _state_dict_from_flat(_flatten(convert_hf_state_dict(sd, cfg)), cfg)
    save_params_npz(params, str(out / "params.npz"))

    info = config_to_info(cfg)
    info["variant"] = variant
    info["source"] = str(hf_dir)
    (out / "info.json").write_text(json.dumps(info, indent=2))

    for name in ("vocab.json", "merges.txt"):
        src = hf_dir / name
        if src.exists():
            shutil.copy(src, out / name)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("hf_dir")
    ap.add_argument("out_dir")
    ap.add_argument("--variant", default="vit-b32")
    args = ap.parse_args(argv)
    out = convert(args.hf_dir, args.out_dir, args.variant)
    print(f"wrote {out} (load with model spec 'clip-{args.variant}:{out}')")


if __name__ == "__main__":
    main()
