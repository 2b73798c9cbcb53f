"""CLIP in PyTorch: ViT image tower + causal text tower.

Counterpart of `seesaw_tpu/models/clip.py`, with the same architecture and
numerics: quick-GELU, pre-LN transformer blocks whose layer norms run in f32
(eps 1e-5) before a cast to the compute dtype, dense layers with f32
parameters that compute in `ClipConfig.dtype`, EOT pooling at the first
argmax of the token ids, projection heads. Pixels come in NHWC, as in the
JAX package. The patch embedding is an unfold plus a matmul (no cuDNN
convolution, so no TF32 by default); callers that compare f32 numbers set
`torch.backends.cuda.matmul.allow_tf32 = False` and
`torch.backends.cudnn.allow_tf32 = False`, as `chip_smoke.py` does.

Attention goes through `ops.attention.pair_attention` (the hand-written
kernel on a CUDA tensor) where the JAX package reaches its Pallas kernel:
head_dim 64, an even number of heads, L <= 384 and no mask or the causal
one. Elsewhere (for example the `test` variant, head_dim 12) the einsum
path runs, in both packages.

Parameters are a torch state dict whose names mirror the flax tree
(`vision.layer_0.self_attn.q_proj.weight` for
`vision/layer_0/self_attn/q_proj/kernel`, `flax_path`); `load_checkpoint`,
`save_params_npz`, `convert.clip_params_from_arrays` and
`convert.clip_arrays_from_state_dict` convert between the two, so the JAX
package's `params.npz` loads here and this package's saves load there.
`ClipEmbedding.trainable_copy` gives the fine-tuning code
(`models.clip_finetune`) a model of its own, and the towers train through
the attention kernels' autograd Function. `init_params`
draws its own random weights from a `torch.Generator`: they are not flax's
numbers for the same seed.
"""
from __future__ import annotations

import copy
import dataclasses
import json
import math
import pathlib
from collections.abc import Mapping
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import pair_attention


@dataclasses.dataclass(frozen=True)
class ClipConfig:
    embed_dim: int = 512
    # vision
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    # text
    vocab_size: int = 49408
    context_length: int = 77
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    # numerics
    dtype: Any = torch.float32

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size


VARIANTS = {
    "vit-b32": ClipConfig(),
    "vit-b16": ClipConfig(patch_size=16),
    "vit-l14": ClipConfig(
        embed_dim=768, patch_size=14, vision_width=1024, vision_layers=24,
        vision_heads=16, text_width=768, text_layers=12, text_heads=12,
    ),
    # tiny variant for tests
    "test": ClipConfig(
        embed_dim=16, image_size=32, patch_size=16, vision_width=24,
        vision_layers=2, vision_heads=2, vocab_size=128, context_length=16,
        text_width=16, text_layers=2, text_heads=2,
    ),
}

# CLIP preprocessing constants
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class Dense(nn.Linear):
    """A linear layer with f32 parameters that computes in `dtype` (flax
    Dense with param_dtype f32)."""

    def __init__(self, in_features: int, out_features: int, *, bias: bool = True,
                 dtype=torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x):
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    """Layer norm in f32, eps 1e-5; the output stays f32."""

    def __init__(self, width: int):
        super().__init__(width, eps=1e-5)

    def forward(self, x):
        return F.layer_norm(x.to(torch.float32), self.normalized_shape, self.weight,
                            self.bias, self.eps)


def causal_mask(L: int, device) -> torch.Tensor:
    """(L, L) f32: -inf above the diagonal (key > query), 0 elsewhere."""
    return torch.triu(torch.full((L, L), float("-inf"), device=device), diagonal=1)


class MultiHeadAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32,
                 causal: bool = False):
        super().__init__()
        self.width, self.heads, self.dtype = width, heads, dtype
        # causal=True promises that `mask`, where given, is the causal mask:
        # the kernel builds it from the indices instead
        self.causal = causal
        self.q_proj, self.k_proj, self.v_proj, self.out_proj = (
            Dense(width, width, dtype=dtype) for _ in range(4)
        )

    def forward(self, x, mask=None):
        B, L, _ = x.shape
        head_dim = self.width // self.heads
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        # seesaw_tpu/models/clip.py:110-111, the Pallas kernel's gate
        if ((mask is None or self.causal) and head_dim == 64
                and self.heads % 2 == 0 and L <= 384):
            out = pair_attention(q, k, v, heads=self.heads, causal=self.causal)
            return self.out_proj(out)
        if self.causal and mask is None:
            mask = causal_mask(L, x.device)

        def split(t):
            return t.reshape(B, L, self.heads, head_dim).transpose(1, 2)

        q, k, v = split(q), split(k), split(v)
        # f32 softmax whatever the compute dtype
        logits = torch.einsum("bhqd,bhkd->bhqk", q, k).to(torch.float32)
        logits = logits / math.sqrt(head_dim)
        if mask is not None:
            logits = logits + mask
        w = torch.softmax(logits, dim=-1).to(self.dtype)
        out = torch.einsum("bhqk,bhkd->bhqd", w, v)
        out = out.transpose(1, 2).reshape(B, L, self.width)
        return self.out_proj(out)


class MLP(nn.Module):
    def __init__(self, width: int, dtype=torch.float32):
        super().__init__()
        self.fc1 = Dense(width, 4 * width, dtype=dtype)
        self.fc2 = Dense(4 * width, width, dtype=dtype)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class ResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32,
                 causal: bool = False):
        super().__init__()
        self.dtype = dtype
        self.layer_norm1 = LayerNorm(width)
        self.layer_norm2 = LayerNorm(width)
        self.self_attn = MultiHeadAttention(width, heads, dtype=dtype, causal=causal)
        self.mlp = MLP(width, dtype=dtype)

    def forward(self, x, mask=None):
        x = x + self.self_attn(self.layer_norm1(x).to(self.dtype), mask)
        return x + self.mlp(self.layer_norm2(x).to(self.dtype))


class VisionTower(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        c = self.cfg = cfg
        self.patch_embedding = Dense(c.patch_size * c.patch_size * 3, c.vision_width,
                                     bias=False, dtype=c.dtype)
        self.class_embedding = nn.Parameter(torch.zeros(c.vision_width))
        self.position_embedding = nn.Parameter(
            torch.zeros(c.grid * c.grid + 1, c.vision_width))
        self.pre_layernorm = LayerNorm(c.vision_width)
        for i in range(c.vision_layers):
            self.add_module(f"layer_{i}", ResidualBlock(
                c.vision_width, c.vision_heads, dtype=c.dtype))
        self.post_layernorm = LayerNorm(c.vision_width)
        self.projection = Dense(c.vision_width, c.embed_dim, bias=False, dtype=c.dtype)

    def forward(self, pixels):
        """pixels: (B, H, W, 3) normalized. Returns (B, embed_dim) f32,
        not normalized."""
        c = self.cfg
        B, H, W, C = pixels.shape
        p = c.patch_size
        if H != c.image_size or W != c.image_size or C != 3:
            raise ValueError(f"expected (B, {c.image_size}, {c.image_size}, 3) pixels, "
                             f"got {tuple(pixels.shape)}")
        g = H // p
        # non-overlapping p x p patches, each flattened as (row, column,
        # channel): the flax kernel's (kh, kw, in) order
        patches = (pixels.to(c.dtype).reshape(B, g, p, g, p, C)
                   .permute(0, 1, 3, 2, 4, 5).reshape(B, g * g, p * p * C))
        x = self.patch_embedding(patches)
        cls = self.class_embedding.to(c.dtype).expand(B, 1, c.vision_width)
        x = torch.cat([cls, x], dim=1) + self.position_embedding.to(c.dtype)
        x = self.pre_layernorm(x).to(c.dtype)
        for i in range(c.vision_layers):
            x = getattr(self, f"layer_{i}")(x)
        pooled = self.post_layernorm(x[:, 0])
        return self.projection(pooled.to(c.dtype)).to(torch.float32)


class TextTower(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        c = self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.zeros(c.vocab_size, c.text_width))
        self.position_embedding = nn.Parameter(torch.zeros(c.context_length, c.text_width))
        for i in range(c.text_layers):
            self.add_module(f"layer_{i}", ResidualBlock(
                c.text_width, c.text_heads, dtype=c.dtype, causal=True))
        self.final_layer_norm = LayerNorm(c.text_width)
        self.projection = Dense(c.text_width, c.embed_dim, bias=False, dtype=c.dtype)

    def forward(self, tokens, eot_positions=None, return_preprojection: bool = False):
        """tokens: (B, L) int. Pools at eot_positions (default: the first
        argmax of the ids, the OpenAI convention: EOT has the largest id).
        return_preprojection=True returns the pooled features before the
        projection head."""
        c = self.cfg
        tokens = tokens.long()
        L = tokens.shape[1]
        x = self.token_embedding[tokens].to(c.dtype)
        x = x + self.position_embedding[:L].to(c.dtype)
        # causal layers: the kernel masks from the indices, the einsum path
        # builds the mask itself
        for i in range(c.text_layers):
            x = getattr(self, f"layer_{i}")(x)
        x = self.final_layer_norm(x)
        if eot_positions is None:
            eot_positions = torch.argmax(tokens, dim=1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot_positions]
        if return_preprojection:
            return pooled.to(torch.float32)
        return self.projection(pooled.to(c.dtype)).to(torch.float32)


class ClipModel(nn.Module):
    def __init__(self, cfg: ClipConfig):
        super().__init__()
        self.cfg = cfg
        self.vision = VisionTower(cfg)
        self.text = TextTower(cfg)
        self.logit_scale = nn.Parameter(torch.tensor(math.log(1 / 0.07)))

    def encode_image(self, pixels):
        return self.vision(pixels)

    def encode_text(self, tokens, eot_positions=None):
        return self.text(tokens, eot_positions)

    def encode_text_preproj(self, tokens):
        return self.text(tokens, None, return_preprojection=True)

    def forward(self, pixels, tokens):
        img = self.encode_image(pixels)
        txt = self.encode_text(tokens)
        img = img / torch.linalg.norm(img, dim=-1, keepdim=True)
        txt = txt / torch.linalg.norm(txt, dim=-1, keepdim=True)
        return torch.exp(self.logit_scale) * img @ txt.T


# ---------------------------------------------------------------------------
# parameters: flax tree (numpy) <-> torch state dict
# ---------------------------------------------------------------------------
_LAYER_NORMS = {"layer_norm1", "layer_norm2", "pre_layernorm", "post_layernorm",
                "final_layer_norm"}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _state_dict_from_flat(flat, cfg: ClipConfig) -> dict:
    sd = {}
    for path, a in flat:
        a = np.asarray(a, dtype=np.float32)
        *mods, leaf = path
        if leaf == "kernel":
            # flax (in, out) -> torch (out, in); the patch conv's
            # (kh, kw, in, out) -> (out, kh * kw * in)
            a = a.reshape(-1, a.shape[-1]).T
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        sd[".".join([*mods, leaf])] = torch.from_numpy(np.array(a, order="C"))
    with torch.device("meta"):
        want = ClipModel(cfg).state_dict()
    if set(sd) != set(want):
        raise ValueError(f"parameters do not match the config: missing "
                         f"{sorted(set(want) - set(sd))[:5]}, unexpected "
                         f"{sorted(set(sd) - set(want))[:5]}")
    bad = [k for k in sd if sd[k].shape != want[k].shape]
    if bad:
        raise ValueError(f"parameter shapes do not match the config: {bad[:5]}")
    return sd


def flax_path(name: str) -> str:
    """State-dict name -> the JAX package's flax path, '/'-joined (the key of
    its params.npz, and the string its optimizer prefixes match):
    `text.projection.weight` -> `text/projection/kernel`, a layer norm's
    weight -> `.../scale`, `logit_scale` as it is."""
    *mods, leaf = name.split(".")
    if leaf == "weight":
        leaf = "scale" if mods[-1] in _LAYER_NORMS else "kernel"
    return "/".join([*mods, leaf])


def cpu_state_dict(model: nn.Module) -> dict:
    """A model's parameters as an f32 CPU state dict of copies."""
    return {k: v.detach().to("cpu", torch.float32, copy=True)
            for k, v in model.state_dict().items()}


def _npz_arrays(sd: Mapping) -> dict:
    """State dict -> flat {"vision/layer_0/.../kernel": array} in the flax
    layout (the keys of the JAX package's params.npz)."""
    flat = {}
    for name, t in sd.items():
        a = t.detach().to(torch.float32).cpu().numpy()
        path = flax_path(name)
        if path.endswith("patch_embedding/kernel"):
            p = math.isqrt(a.shape[1] // 3)
            a = a.T.reshape(p, p, 3, a.shape[0])
        elif path.endswith("/kernel"):
            a = a.T
        flat[path] = np.array(a, order="C")
    return flat


def convert_hf_state_dict(sd: dict, cfg: ClipConfig) -> dict:
    """Map a HF `CLIPModel.state_dict()` (arrays) to the flax params tree of
    numpy arrays that the JAX package's `convert_hf_state_dict` returns."""

    def t(x):
        return np.asarray(x, dtype=np.float32)

    def lin(prefix):
        return {"kernel": t(sd[f"{prefix}.weight"]).T, "bias": t(sd[f"{prefix}.bias"])}

    def ln(prefix):
        return {"scale": t(sd[f"{prefix}.weight"]), "bias": t(sd[f"{prefix}.bias"])}

    def block(prefix):
        return {
            "layer_norm1": ln(f"{prefix}.layer_norm1"),
            "layer_norm2": ln(f"{prefix}.layer_norm2"),
            "self_attn": {name: lin(f"{prefix}.self_attn.{name}")
                          for name in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "mlp": {"fc1": lin(f"{prefix}.mlp.fc1"), "fc2": lin(f"{prefix}.mlp.fc2")},
        }

    vision = {
        # torch conv weight (out, in, kh, kw) -> flax (kh, kw, in, out)
        "patch_embedding": {"kernel": t(
            sd["vision_model.embeddings.patch_embedding.weight"]).transpose(2, 3, 1, 0)},
        "class_embedding": t(sd["vision_model.embeddings.class_embedding"]),
        "position_embedding": t(sd["vision_model.embeddings.position_embedding.weight"]),
        "pre_layernorm": ln("vision_model.pre_layrnorm"),
        "post_layernorm": ln("vision_model.post_layernorm"),
        "projection": {"kernel": t(sd["visual_projection.weight"]).T},
    }
    for i in range(cfg.vision_layers):
        vision[f"layer_{i}"] = block(f"vision_model.encoder.layers.{i}")
    text = {
        "token_embedding": t(sd["text_model.embeddings.token_embedding.weight"]),
        "position_embedding": t(sd["text_model.embeddings.position_embedding.weight"]),
        "final_layer_norm": ln("text_model.final_layer_norm"),
        "projection": {"kernel": t(sd["text_projection.weight"]).T},
    }
    for i in range(cfg.text_layers):
        text[f"layer_{i}"] = block(f"text_model.encoder.layers.{i}")
    return {"vision": vision, "text": text, "logit_scale": t(sd["logit_scale"])}


def config_from_hf(hf_cfg: dict) -> ClipConfig:
    """Derive a ClipConfig from an HF CLIP config.json dict."""
    tc, vc = hf_cfg["text_config"], hf_cfg["vision_config"]
    return ClipConfig(
        embed_dim=hf_cfg.get("projection_dim", 512),
        image_size=vc.get("image_size", 224),
        patch_size=vc.get("patch_size", 32),
        vision_width=vc.get("hidden_size", 768),
        vision_layers=vc.get("num_hidden_layers", 12),
        vision_heads=vc.get("num_attention_heads", 12),
        vocab_size=tc.get("vocab_size", 49408),
        context_length=tc.get("max_position_embeddings", 77),
        text_width=tc.get("hidden_size", 512),
        text_layers=tc.get("num_hidden_layers", 12),
        text_heads=tc.get("num_attention_heads", 8),
    )


_CONFIG_FIELDS = (
    "embed_dim", "image_size", "patch_size", "vision_width", "vision_layers",
    "vision_heads", "vocab_size", "context_length", "text_width",
    "text_layers", "text_heads",
)


def config_to_info(cfg: ClipConfig) -> dict:
    return {f: getattr(cfg, f) for f in _CONFIG_FIELDS}


def config_from_info(info: dict) -> ClipConfig:
    return ClipConfig(**{f: int(info[f]) for f in _CONFIG_FIELDS if f in info})


def init_params(cfg: ClipConfig, generator: torch.Generator) -> dict:
    """Random f32 CPU state dict: dense and patch weights normal with std
    1/sqrt(fan_in), biases 0, layer norms 1 and 0, embeddings normal (0.02;
    text positions 0.01), logit_scale log(1/0.07). The distributions follow
    flax's initializers (untruncated); the numbers are this generator's."""
    with torch.device("meta"):
        shapes = {k: v.shape for k, v in ClipModel(cfg).state_dict().items()}
    sd = {}
    for name, shape in shapes.items():
        *mods, leaf = name.split(".")
        if name == "logit_scale":
            sd[name] = torch.tensor(math.log(1 / 0.07))
        elif mods[-1] in _LAYER_NORMS:
            sd[name] = torch.ones(shape) if leaf == "weight" else torch.zeros(shape)
        elif leaf == "bias":
            sd[name] = torch.zeros(shape)
        elif leaf == "weight":
            sd[name] = torch.randn(shape, generator=generator) / math.sqrt(shape[1])
        else:
            std = 0.01 if name == "text.position_embedding" else 0.02
            sd[name] = torch.randn(shape, generator=generator) * std
    return sd


def load_checkpoint(path: str, cfg: ClipConfig) -> dict:
    """State dict from a flat '/'-keyed params.npz (the JAX package's
    `save_params_npz`; a directory means its params.npz) or from a torch file
    holding an HF CLIPModel state dict."""
    p = pathlib.Path(path)
    if p.is_dir():
        p = p / "params.npz"
    if p.suffix == ".npz":
        with np.load(p) as z:
            return _state_dict_from_flat(
                [(tuple(k.split("/")), z[k]) for k in z.files], cfg)
    sd = torch.load(p, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = {k: v.numpy() for k, v in sd.items()}
    return _state_dict_from_flat(_flatten(convert_hf_state_dict(sd, cfg)), cfg)


def save_params_npz(params: Mapping, path: str):
    """Write a state dict as the JAX package's flat params.npz."""
    np.savez(path, **_npz_arrays(params))


# ---------------------------------------------------------------------------
# Embedding wrapper (XEmbedding contract)
# ---------------------------------------------------------------------------
class ClipEmbedding:
    """XEmbedding backed by the PyTorch CLIP on `device`. Caches the
    embeddings of single strings."""

    def __init__(
        self,
        variant: str = "vit-b32",
        *,
        device,
        checkpoint: Optional[str] = None,
        dtype=torch.float32,
        params: Optional[dict] = None,
        tokenizer=None,
        cfg: Optional[ClipConfig] = None,
    ):
        """params: a state dict (`init_params`, `load_checkpoint`,
        `convert.clip_params_from_arrays`); else the checkpoint's; else
        `init_params` from a generator seeded with 0."""
        if cfg is None:
            cfg = VARIANTS[variant]
        if dtype is not None and dtype != cfg.dtype:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        self.cfg = cfg
        self.variant = variant
        self.device = torch.device(device)
        if params is None:
            params = (load_checkpoint(checkpoint, cfg) if checkpoint is not None
                      else init_params(cfg, torch.Generator().manual_seed(0)))
        with torch.device("meta"):
            model = ClipModel(cfg)
        model.load_state_dict(params, assign=True)
        self.model = model.to(self.device).eval().requires_grad_(False)
        if tokenizer is None:
            from .tokenizer import default_tokenizer

            tokenizer = default_tokenizer(cfg.context_length, cfg.vocab_size)
        self.tokenizer = tokenizer
        self._string_cache: dict = {}

    @property
    def dim(self) -> int:
        return self.cfg.embed_dim

    def state_dict(self) -> dict:
        """The model's parameters as an f32 CPU state dict of copies, which
        `ClipEmbedding(params=..., cfg=..., dtype=None)` takes back."""
        return cpu_state_dict(self.model)

    def trainable_copy(self, device) -> ClipModel:
        """A copy of the model on `device` whose parameters require grad.
        This embedding's own model stays frozen and unchanged: the registry
        shares it with every session on its device."""
        with torch.device("meta"):
            model = ClipModel(self.cfg)
        model.load_state_dict({k: v.detach().to(device, copy=True)
                               for k, v in self.model.state_dict().items()}, assign=True)
        return model.requires_grad_(True)

    def replica(self, device) -> "ClipEmbedding":
        """This embedding on `device`: itself there, else a frozen copy of
        the model on `device` sharing the tokenizer (the data-parallel
        extraction's tower per device)."""
        device = torch.device(device)
        if device == self.device:
            return self
        with torch.device("meta"):
            model = ClipModel(self.cfg)
        model.load_state_dict({k: v.detach().to(device, copy=True)
                               for k, v in self.model.state_dict().items()}, assign=True)
        out = copy.copy(self)
        out.device = device
        out.model = model.eval().requires_grad_(False)
        out._string_cache = {}
        return out

    def from_string(self, *, string: str = None, str_list=None) -> np.ndarray:
        """Unit (D,) for `string` (cached), or (n, D) for `str_list` (not
        cached)."""
        if string is not None:
            if string in self._string_cache:
                return self._string_cache[string]
            out = self.from_string(str_list=[string])[0]
            self._string_cache[string] = out
            return out
        tokens = np.stack([self.tokenizer.encode(s) for s in (str_list or [])])
        with torch.no_grad():
            out = self.model.encode_text(torch.from_numpy(tokens).to(self.device))
        out = out.cpu().numpy()
        return out / np.linalg.norm(out, axis=-1, keepdims=True)

    def from_image(self, *, preprocessed_image=None, image=None) -> np.ndarray:
        if preprocessed_image is None:
            from .preprocess import preprocess_image

            preprocessed_image = preprocess_image(image, self.cfg.image_size)
        px = np.asarray(preprocessed_image, dtype=np.float32)
        if px.ndim == 3:
            px = px[None]
        out = self.encode_image_batch(torch.from_numpy(px).to(self.device)).cpu().numpy()
        return out / np.linalg.norm(out, axis=-1, keepdims=True)

    def encode_image_batch(self, pixels: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized pixels on the model's device -> (B, D) f32
        embeddings there, not normalized."""
        with torch.no_grad():
            return self.model.encode_image(pixels)

    def from_raw(self, data) -> np.ndarray:
        if isinstance(data, str):
            return self.from_string(string=data)
        return self.from_image(image=data)

    @staticmethod
    def from_artifact(path: str, *, device, dtype=torch.float32) -> "ClipEmbedding":
        """Load a converted checkpoint directory (params.npz + info.json +
        vocab.json/merges.txt), as `scripts/convert_clip_checkpoint.py`
        writes it."""
        from .tokenizer import default_tokenizer

        p = pathlib.Path(path)
        info = json.loads((p / "info.json").read_text())
        cfg = config_from_info(info)
        if dtype is not None:
            cfg = dataclasses.replace(cfg, dtype=dtype)
        tok = default_tokenizer(cfg.context_length, cfg.vocab_size, vocab_dir=p)
        return ClipEmbedding(
            variant=info.get("variant", "vit-b32"), device=device,
            params=load_checkpoint(str(p / "params.npz"), cfg), tokenizer=tok,
            dtype=None, cfg=cfg,
        )
