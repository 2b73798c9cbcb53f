"""Multiscale image pyramid + strided tiling (host side).

The port's own copy of `seesaw_tpu/ingest/tiling.py` (PIL and numpy only):
a geometric pyramid of downscaled copies (factor 0.5, short side never below
the tile size), each copy cut into tile_size tiles at all four half-stride
shifts; tile boxes are mapped back to original-image pixels and tagged with
their zoom level (1 = most zoomed in / largest copy ... max = whole image at
tile_size). Tiling is array reshaping: zero-copy views via stride tricks.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

import numpy as np
import PIL.Image


def rescale(im: PIL.Image.Image, scale: float, min_size: int) -> PIL.Image.Image:
    w, h = im.size
    tw = max(math.floor(w * scale), min_size)
    th = max(math.floor(h * scale), min_size)
    return im.resize((tw, th), resample=PIL.Image.BILINEAR)


def pyramid_levels(size: int, factor: float, abs_min: int) -> List[float]:
    """Geometric scale factors, DESCENDING: largest copy first (snapped up
    to the factor grid anchored at abs_min — may upscale), ending at the
    copy whose short side == abs_min. zoom_level = position + 1, so level 1
    is the most zoomed-in copy and the max level is the whole-image copy.
    """
    assert factor < 1.0
    inv = 1.0 / factor
    end_size = abs_min
    start_size = max(size, abs_min)
    start_scale = start_size / size
    end_scale = end_size / size
    ntimes = math.ceil(math.log(start_scale / end_scale) / math.log(inv))
    start_size = math.ceil(math.exp(ntimes * math.log(inv) + math.log(abs_min)))
    start_scale = start_size / size
    return np.geomspace(start=start_scale, stop=end_scale, num=ntimes + 1,
                        endpoint=True).tolist()


def _grid_tiles(arr: np.ndarray, tile_size: int, shift_y: int, shift_x: int):
    """Non-overlapping tile grid of the shifted array, as views + boxes."""
    sub = arr[shift_y:, shift_x:]
    h, w = sub.shape[:2]
    nh, nw = h // tile_size, w // tile_size
    if nh == 0 or nw == 0:
        return (
            np.zeros((0, tile_size, tile_size, arr.shape[2]), dtype=arr.dtype),
            np.zeros((0, 4), dtype=np.float32),
        )
    sub = sub[: nh * tile_size, : nw * tile_size]
    tiles = (
        sub.reshape(nh, tile_size, nw, tile_size, -1)
        .transpose(0, 2, 1, 3, 4)
        .reshape(nh * nw, tile_size, tile_size, -1)
    )
    jj, ii = np.meshgrid(np.arange(nw), np.arange(nh))
    x1 = (jj.reshape(-1) * tile_size + shift_x).astype(np.float32)
    y1 = (ii.reshape(-1) * tile_size + shift_y).astype(np.float32)
    boxes = np.stack([x1, y1, x1 + tile_size, y1 + tile_size], axis=1)
    return tiles, boxes


def strided_tiles(arr: np.ndarray, tile_size: int):
    """All four half-stride shifted grids (reference `strided_tiling`)."""
    stride = tile_size // 2
    all_tiles, all_boxes = [], []
    for i in (0, 1):
        for j in (0, 1):
            t, b = _grid_tiles(arr, tile_size, shift_y=stride * j, shift_x=stride * i)
            all_tiles.append(t)
            all_boxes.append(b)
    return np.concatenate(all_tiles), np.concatenate(all_boxes)


@dataclass
class TileSet:
    tiles: np.ndarray  # (T, ts, ts, 3) uint8
    boxes: np.ndarray  # (T, 4) float32, original-image pixels
    zoom_level: np.ndarray  # (T,) int32, 1-based (1 = most zoomed in)
    scale_factor: np.ndarray  # (T,) float32
    max_zoom_level: int


def generate_multiscale_tiling(
    im: PIL.Image.Image,
    tile_size: int = 224,
    factor: float = 0.5,
    min_tile_size: int = 224,
) -> TileSet:
    if im.mode != "RGB":
        im = im.convert("RGB")
    size = min(im.size)
    factors = pyramid_levels(size, factor=factor, abs_min=tile_size)

    tiles_acc, boxes_acc, zoom_acc, sf_acc = [], [], [], []
    # zoom_level counts up from the largest copy (finest detail) to the
    # whole-image copy; filter copies whose effective tile (in original
    # pixels) is below min_tile_size, always keeping the most zoomed-out.
    n = len(factors)
    for lvl_idx, sf in enumerate(factors):
        zoom_level = lvl_idx + 1
        # effective tile size in original-image pixels; drop levels whose
        # tiles are smaller than min_tile_size, always keeping the most
        # zoomed-out copy (reference's "keep largest at least")
        effective = tile_size / sf
        is_last = lvl_idx == n - 1
        if effective < min_tile_size and not is_last:
            continue
        scaled = rescale(im, scale=sf, min_size=tile_size)
        arr = np.asarray(scaled)
        t, b = strided_tiles(arr, tile_size)
        if t.shape[0] == 0:
            continue
        tiles_acc.append(t)
        boxes_acc.append(b / sf)  # back to original pixels
        zoom_acc.append(np.full(t.shape[0], zoom_level, dtype=np.int32))
        sf_acc.append(np.full(t.shape[0], sf, dtype=np.float32))

    tiles = np.concatenate(tiles_acc)
    return TileSet(
        tiles=tiles,
        boxes=np.concatenate(boxes_acc).astype(np.float32),
        zoom_level=np.concatenate(zoom_acc),
        scale_factor=np.concatenate(sf_acc),
        max_zoom_level=int(np.concatenate(zoom_acc).max()),
    )
