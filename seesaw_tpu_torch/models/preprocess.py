"""CLIP image preprocessing.

Counterpart of `seesaw_tpu/models/preprocess.py`: bicubic resize so the
short side equals the target, center crop, scale to [0, 1], normalize with
the CLIP mean and std.

- `preprocess_image`: the PIL host path for one-off images (serving).
- `normalize_pixels`: the same normalization on a tensor of [0, 1] pixels,
  on its device.

The batched on-device resize (`resize_batch_jax`) feeds only the ingest
pipeline and comes with it.
"""
from __future__ import annotations

import numpy as np
import torch

from .clip import CLIP_MEAN, CLIP_STD


def preprocess_image(image, target: int = 224) -> np.ndarray:
    """PIL image or HWC uint8 array -> (target, target, 3) float32 normalized."""
    from PIL import Image

    if not isinstance(image, Image.Image):
        image = Image.fromarray(np.asarray(image))
    if image.mode != "RGB":
        image = image.convert("RGB")
    w, h = image.size
    # torchvision T.Resize semantics: short side == target, long side
    # truncated — int(target * long / short), not rounded
    if w <= h:
        nw, nh = target, int(target * h / w)
    else:
        nw, nh = int(target * w / h), target
    image = image.resize((nw, nh), Image.BICUBIC)
    left, top = (nw - target) // 2, (nh - target) // 2
    image = image.crop((left, top, left + target, top + target))
    arr = np.asarray(image, dtype=np.float32) / 255.0
    return (arr - CLIP_MEAN) / CLIP_STD


def normalize_pixels(pixels01: torch.Tensor) -> torch.Tensor:
    """[0, 1] float pixels (..., 3) -> CLIP-normalized, on their device."""
    mean = torch.from_numpy(CLIP_MEAN).to(pixels01.device)
    std = torch.from_numpy(CLIP_STD).to(pixels01.device)
    return (pixels01 - mean) / std
