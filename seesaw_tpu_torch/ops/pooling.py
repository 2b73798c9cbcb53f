"""Windowed kernel application (pooling) over spatial maps.

Counterpart of `seesaw_tpu/ops/pooling.py`: apply an arbitrary kernel to
every (kernel_size x kernel_size) window at the given stride, optionally
centering the window grid when the input does not divide evenly. Used for
dense patch embeddings (224-kernel, 112-stride sliding CLIP); `avg_pool2d`
is the parity oracle. The kernel is `torch.vmap`ped over the batch of
windows.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def _window_grid(h: int, w: int, k: int, stride: int, center: bool):
    iis = list(range(0, h - k + 1, stride))
    jjs = list(range(0, w - k + 1, stride))
    if center and iis and jjs:
        off_h = (h - (iis[-1] + k)) // 2
        off_w = (w - (jjs[-1] + k)) // 2
        iis = [i + off_h for i in iis]
        jjs = [j + off_w for j in jjs]
    return iis, jjs


def manual_pooling(
    x: torch.Tensor,
    kernel: Callable[[torch.Tensor], torch.Tensor],
    kernel_size: int,
    stride: Optional[int] = None,
    center: bool = False,
) -> torch.Tensor:
    """Apply ``kernel`` to each window of x (..., H, W).

    The kernel maps (..., k, k) -> (...); the output is (..., nH, nW)."""
    stride = stride or kernel_size
    h, w = x.shape[-2:]
    iis, jjs = _window_grid(h, w, kernel_size, stride, center)
    windows = torch.stack([
        torch.stack([x[..., i:i + kernel_size, j:j + kernel_size] for j in jjs])
        for i in iis
    ])  # (nH, nW, ..., k, k)
    flat = windows.reshape((-1,) + windows.shape[2:])
    out = torch.vmap(kernel)(flat)  # (nH * nW, ...)
    out = out.reshape((len(iis), len(jjs)) + out.shape[1:])
    # the window grid to the trailing axes: (..., nH, nW)
    return out.permute(tuple(range(2, out.dim())) + (0, 1))


def sliding_window(
    x: torch.Tensor,
    kernel: Callable[[torch.Tensor], torch.Tensor],
    kernel_size: int,
    stride: Optional[int] = None,
    center: bool = False,
) -> torch.Tensor:
    """manual_pooling for (1, C, H, W) inputs: the windows are one batch
    for the kernel."""
    if x.dim() != 4 or x.shape[0] != 1:
        raise ValueError(f"expected (1, C, H, W), got {tuple(x.shape)}")
    return manual_pooling(x[0], kernel, kernel_size, stride, center)[None]


def avg_pool2d(x: torch.Tensor, kernel_size: int, stride: Optional[int] = None) -> torch.Tensor:
    """Plain average pooling over (..., H, W)."""
    stride = stride or kernel_size
    return manual_pooling(x, lambda win: win.mean(dim=(-2, -1)), kernel_size, stride)
