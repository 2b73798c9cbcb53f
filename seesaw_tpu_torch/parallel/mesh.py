"""A device mesh in one process: an ordered list of devices, one a shard.

Counterpart of `seesaw_tpu/parallel/mesh.py`. JAX runs one program over a
`jax.sharding.Mesh` from one controller; here one process holds a list of
per-shard tensors, each on its shard's device, and issues every shard's
launches in turn. The collectives that the JAX package's `shard_map` code
uses are plain functions over such lists:

- `all_gather`: the shards' parts concatenated onto each shard's device;
- `pmax` / `psum`: the max / sum of per-shard scalars, on each device;
- `rotate`: the ring step of `ppermute` (shard i takes shard i+1's part).

None of them reads the host, so the shards' work overlaps across devices.
A mesh may name one device several times (`make_mesh(devices=[...])`):
the tests put S shards on the CPU that way, and one card can hold every
shard of a check. A copy onto a device is made once per distinct device,
never once per shard; parts already on a device move nowhere.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """The shards' devices, in shard order, along the axis "data"."""

    devices: tuple[torch.device, ...]
    axis_name: str = AXIS

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def primary(self) -> torch.device:
        """Shard 0's device: where merged results and host-facing state live."""
        return self.devices[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each device once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: int | None = None, *, devices: Sequence | None = None) -> Mesh:
    """The first `n_devices` visible CUDA devices (all of them by default),
    asserting that there are enough, as the JAX package does; or the
    explicit `devices`, which may repeat a device."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} devices given")
        return Mesh(tuple(_indexed(d) for d in devices))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else n_devices
    assert have >= n >= 1, f"need {n} CUDA devices, have {have}"
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)))


def _indexed(device) -> torch.device:
    """`device` with its index: "cuda" names the current CUDA device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def replicate(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """`x` on each shard's device: one copy per distinct device."""
    on = {d: x.to(d) for d in mesh.distinct}
    return [on[d] for d in mesh.devices]


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int = 0) -> list[torch.Tensor]:
    """The shards' parts concatenated along `dim` (tiled), on each shard's
    device: one concatenation per distinct device."""
    on = {d: torch.cat([p.to(d) for p in parts], dim=dim) for d in mesh.distinct}
    return [on[d] for d in mesh.devices]


def pmax(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise max over the shards' tensors, on each shard's device."""
    on = {d: torch.stack([p.to(d) for p in parts]).amax(dim=0) for d in mesh.distinct}
    return [on[d] for d in mesh.devices]


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise sum over the shards' tensors, on each shard's device."""
    on = {d: torch.stack([p.to(d) for p in parts]).sum(dim=0) for d in mesh.distinct}
    return [on[d] for d in mesh.devices]


def rotate(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One ring step: shard i takes shard (i + 1) % S's part, as
    `ppermute(perm=[(i, (i - 1) % S)])` sends it."""
    S = mesh.size
    return [parts[(i + 1) % S].to(mesh.devices[i]) for i in range(S)]


def gather_to(device, parts: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
    """The shards' parts concatenated along `dim` on one device."""
    return torch.cat([p.to(device) for p in parts], dim=dim)


def split_rows(mesh: Mesh, x: torch.Tensor, rows: int, fill=0) -> list[torch.Tensor]:
    """(N, ...) -> S parts of `rows` rows each (S * rows >= N), part i on
    shard i's device, the tail past N filled with `fill`. A part that lies
    whole inside `x` on its own device is a view, not a copy."""
    N = x.shape[0]
    out = []
    for i, dev in enumerate(mesh.devices):
        lo, hi = min(i * rows, N), min((i + 1) * rows, N)
        if hi - lo == rows:
            out.append(x[lo:hi].to(dev))
        else:
            part = torch.full((rows, *x.shape[1:]), fill, dtype=x.dtype, device=dev)
            part[:hi - lo] = x[lo:hi].to(dev)
            out.append(part)
    return out
