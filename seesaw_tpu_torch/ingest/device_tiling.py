"""On-device multiscale tiling: the pyramid + strided grids as torch ops.

Counterpart of `seesaw_tpu/ingest/device_tiling.py`. Geometry for a given
image size is static, so per size a `TilePlan` is made on the host (levels,
per-level shapes, tile boxes and zoom levels: the same math as
`tiling.pyramid_levels` / `strided_tiles`), and `tile_images` turns decoded
uint8 images on a device into all their CLIP-normalized tiles there: /255,
one antialiased bilinear resize per level, the four shifted grids as
reshapes of each copy, and the CLIP mean / std. Only the raw image crosses
from the host; the tiles feed the ViT batches where they are.

Every level is resized by `F.interpolate(..., mode="bilinear",
antialias=True, align_corners=False)`, up or down: that computes
`jax.image.resize(..., antialias=True)`'s function (a triangle kernel
widened by the scale when shrinking), to 4.2e-5 on random [0, 1] pixels;
without antialias, torch parts from it by up to 0.56 when shrinking
(tests/test_torch_ingest.py::test_antialias_is_what_matches_jax).
"""
from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.preprocess import normalize_pixels
from .tiling import pyramid_levels


@dataclass(frozen=True)
class GridSpec:
    shift_y: int
    shift_x: int
    nh: int
    nw: int


@dataclass(frozen=True)
class LevelSpec:
    zoom_level: int
    sf: float  # scale factor
    th: int  # scaled height
    tw: int  # scaled width
    grids: Tuple[GridSpec, ...]


@dataclass(frozen=True, eq=False)  # id-hash: one cached instance per size
class TilePlan:
    """Static tiling layout for one (height, width) image size."""

    height: int
    width: int
    tile_size: int
    levels: Tuple[LevelSpec, ...]
    boxes: np.ndarray  # (T, 4) float32, original-image pixels
    zoom_level: np.ndarray  # (T,) int32
    scale_factor: np.ndarray  # (T,) float32
    max_zoom_level: int

    @property
    def n_tiles(self) -> int:
        return self.boxes.shape[0]


@functools.lru_cache(maxsize=256)
def make_plan(height: int, width: int, tile_size: int = 224,
              factor: float = 0.5, min_tile_size: int = 224) -> TilePlan:
    """Host-side geometry, matching tiling.generate_multiscale_tiling."""
    size = min(width, height)
    factors = pyramid_levels(size, factor=factor, abs_min=tile_size)
    stride = tile_size // 2

    levels: List[LevelSpec] = []
    boxes_acc, zoom_acc, sf_acc = [], [], []
    n = len(factors)
    for lvl_idx, sf in enumerate(factors):
        zoom_level = lvl_idx + 1
        effective = tile_size / sf
        if effective < min_tile_size and lvl_idx != n - 1:
            continue
        tw = max(math.floor(width * sf), tile_size)
        th = max(math.floor(height * sf), tile_size)
        grids = []
        lvl_boxes = []
        # shift order matches tiling.strided_tiles: (x-shift i, y-shift j)
        for i in (0, 1):
            for j in (0, 1):
                sy, sx = stride * j, stride * i
                nh = (th - sy) // tile_size
                nw = (tw - sx) // tile_size
                if nh <= 0 or nw <= 0:
                    continue
                grids.append(GridSpec(shift_y=sy, shift_x=sx, nh=nh, nw=nw))
                jj, ii = np.meshgrid(np.arange(nw), np.arange(nh))
                x1 = (jj.reshape(-1) * tile_size + sx).astype(np.float32)
                y1 = (ii.reshape(-1) * tile_size + sy).astype(np.float32)
                lvl_boxes.append(np.stack([x1, y1, x1 + tile_size, y1 + tile_size], 1))
        if not grids:
            continue
        levels.append(LevelSpec(zoom_level=zoom_level, sf=sf, th=th, tw=tw,
                                grids=tuple(grids)))
        b = np.concatenate(lvl_boxes) / sf  # back to original pixels
        boxes_acc.append(b.astype(np.float32))
        zoom_acc.append(np.full(b.shape[0], zoom_level, dtype=np.int32))
        sf_acc.append(np.full(b.shape[0], sf, dtype=np.float32))

    zoom = np.concatenate(zoom_acc)
    return TilePlan(
        height=height, width=width, tile_size=tile_size, levels=tuple(levels),
        boxes=np.concatenate(boxes_acc), zoom_level=zoom,
        scale_factor=np.concatenate(sf_acc), max_zoom_level=int(zoom.max()),
    )


def tile_images(plan: TilePlan, imgs_u8: torch.Tensor) -> torch.Tensor:
    """uint8 (B, H, W, 3) images of the plan's size -> (B * T, ts, ts, 3)
    CLIP-normalized f32 tiles on the images' device, image-major, each
    image's tiles in the plan's order."""
    B = imgs_u8.shape[0]
    ts = plan.tile_size
    x = imgs_u8.permute(0, 3, 1, 2).to(torch.float32) / 255.0  # (B, 3, H, W)
    out = []
    for lvl in plan.levels:
        scaled = F.interpolate(x, size=(lvl.th, lvl.tw), mode="bilinear",
                               antialias=True, align_corners=False)
        for g in lvl.grids:
            sub = scaled[:, :, g.shift_y:g.shift_y + g.nh * ts,
                         g.shift_x:g.shift_x + g.nw * ts]
            out.append(sub.reshape(B, 3, g.nh, ts, g.nw, ts)
                       .permute(0, 2, 4, 3, 5, 1)
                       .reshape(B, g.nh * g.nw, ts, ts, 3))
    tiles = torch.cat(out, dim=1).reshape(B * plan.n_tiles, ts, ts, 3)
    return normalize_pixels(tiles)


def build_tiler(plan: TilePlan):
    """uint8 (H, W, 3) image tensor -> (T, ts, ts, 3) normalized tiles on
    its device."""
    return lambda img_u8: tile_images(plan, img_u8[None])


def build_batch_tiler(plan: TilePlan, batch: int):
    """uint8 (batch, H, W, 3) tensor -> (batch * T, ts, ts, 3) normalized
    tiles on its device."""

    def run(imgs_u8):
        if imgs_u8.shape[0] != batch:
            raise ValueError(f"{imgs_u8.shape[0]} images for a tiler of {batch}")
        return tile_images(plan, imgs_u8)

    return run


def tile_on_device(img_u8: np.ndarray, tile_size: int = 224, factor: float = 0.5,
                   min_tile_size: int = 224, *, device):
    """(plan, tiles on `device`) for one decoded RGB image."""
    h, w = img_u8.shape[:2]
    plan = make_plan(h, w, tile_size, factor, min_tile_size)
    img = torch.from_numpy(np.ascontiguousarray(img_u8)).to(device)
    return plan, build_tiler(plan)(img)
