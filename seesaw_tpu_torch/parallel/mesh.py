"""A device mesh: the shards' devices, in one process or across processes.

Counterpart of `seesaw_tpu/parallel/mesh.py`. A mesh is an ordered list of
S shards along the axis "data". The collectives that the JAX package's
`shard_map` code uses are plain functions over lists of per-shard tensors,
each on its shard's device:

- `all_gather`: the shards' parts concatenated, on each shard's device;
- `pmax` / `psum`: the max / sum of the shards' tensors, on each device;
- `rotate`: the ring step of `ppermute` (shard i takes shard i+1's part);
- `gather_to`: the shards' parts concatenated on one device, replicated;
- `split_rows` / `replicate`: a host-given array's parts, or copies.

**In one process** (`make_mesh(n)`, `make_mesh(devices=[...])`) the process
holds every shard, as JAX's single controller does, and issues every
shard's launches in turn. None of the collectives reads the host, so the
shards' work overlaps across devices. A mesh may name one device several
times: the tests put S shards on the CPU that way, and one card can hold
every shard of a check. A copy onto a device is made once per distinct
device, never once per shard; parts already on a device move nowhere.

**Across processes** (`make_mesh(devices=local, group=...)` after
`multihost.init_multihost`, JAX's multi-controller global mesh; only an
explicit `group` makes one) every process of a `torch.distributed` group
holds the same number of shards and runs the same program on its own. The
SPMD contract:

- *Same calls in the same order.* Every process calls the same mesh
  functions in the same order with the same host inputs (query vectors,
  click ids, labels, seeds). A process that skips a collective hangs the
  others.
- *Shard numbering.* The S shards are numbered globally in rank order:
  process r holds shards [r * L, (r + 1) * L) (`local_shards`), L being
  its devices' count. A process holds only its own shards' parts, so every
  list of parts above has L entries, in `local_shards` order.
- *Results.* What JAX returns replicated (`out_specs=P()`) is replicated
  here too: `all_gather`, `pmax`, `psum` and `gather_to` give every
  process the same values, on its own devices; `mesh.primary` is the
  process's first local device. The merged query result, the kNN arrays,
  the propagated scores and the fine-tune step's gradients land there.
- *Backend and buffer device.* The group's backend is the caller's choice
  (`init_multihost(backend=)`). Each collective runs on that backend's own
  transport for its buffers: the card for NCCL, host memory for gloo
  (whose all_gather and point-to-point carry host tensors only). The copies
  to and from that transport happen only in `_stage`, `_land` and
  `gather_to`; no computation moves off the card. A backend with no known transport
  raises.
- *Deduplication.* Each function issues one `torch.distributed` call (or a
  batch of point-to-point ops), however many distinct devices the process
  holds, so every process makes the same sequence of calls.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

AXIS = "data"


@dataclass(frozen=True)
class Mesh:
    """This process's shards' devices, in shard order, along the axis
    "data"; with a process `group`, the mesh spans every process of it."""

    devices: tuple[torch.device, ...]
    axis_name: str = AXIS
    group: Optional[Any] = None  # a torch.distributed group, or None: one process
    rank: int = 0  # this process's rank in the group
    world: int = 1  # processes in the group

    def __post_init__(self):
        if not self.devices:
            raise ValueError("a mesh needs at least one device")

    @property
    def size(self) -> int:
        """S: the shards of every process."""
        return len(self.devices) * self.world

    @property
    def local_shards(self) -> range:
        """The global ids of the shards this process holds."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)

    @property
    def shard_ranks(self) -> tuple[int, ...]:
        """The rank that holds each shard, in shard order."""
        return tuple(s // len(self.devices) for s in range(self.size))

    @property
    def primary(self) -> torch.device:
        """This process's first shard's device: where merged results and
        host-facing state live."""
        return self.devices[0]

    @property
    def distinct(self) -> tuple[torch.device, ...]:
        """Each of this process's devices once, in order of first appearance."""
        return tuple(dict.fromkeys(self.devices))


def make_mesh(n_devices: int | None = None, *, devices: Sequence | None = None,
              group=None) -> Mesh:
    """The first `n_devices` visible CUDA devices (all of them by default),
    asserting that there are enough, as the JAX package does; or the
    explicit `devices`, which may repeat a device. With a `group` of
    `torch.distributed`, these are this process's shards of a mesh that
    spans every process of the group; its devices default to this
    process's own card (`torch.cuda.current_device()`). Without a group the
    mesh is in-process, whether or not a process group exists."""
    if devices is None and group is not None:
        if not torch.cuda.is_available():
            raise ValueError("a process mesh with no devices given holds this process's card, "
                             "and there is none: pass devices=")
        devices = [torch.device("cuda", torch.cuda.current_device())]
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"n_devices={n_devices} but {len(devices)} devices given")
        local = tuple(_indexed(d) for d in devices)
    else:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = have if n_devices is None else n_devices
        assert have >= n >= 1, f"need {n} CUDA devices, have {have}"
        local = tuple(torch.device("cuda", i) for i in range(n))
    if group is None:
        return Mesh(local)
    mesh = Mesh(local, group=group, rank=dist.get_rank(group), world=dist.get_world_size(group))
    _transport(mesh)  # a backend with no known transport raises here
    return mesh


def require_in_process(mesh: Optional[Mesh], what: str) -> None:
    """Raise if `mesh` spans processes: `what` serves requests in one
    process, and a process mesh needs every process to make the same calls."""
    if mesh is not None and mesh.group is not None:
        raise ValueError(f"{what} keeps the in-process mesh: a mesh that spans "
                         f"{mesh.world} processes runs only as SPMD programs")


def _indexed(device) -> torch.device:
    """`device` with its index: "cuda" names the current CUDA device."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


# -- the transport of a process mesh's collectives ---------------------------
def _transport(mesh: Mesh) -> torch.device:
    """The device a process mesh's collective buffers live on: the primary
    card for NCCL, host memory for gloo."""
    backend = dist.get_backend(mesh.group)
    if backend == "gloo":
        return torch.device("cpu")
    if backend == "nccl":
        if mesh.primary.type != "cuda":
            raise ValueError(f"NCCL carries CUDA tensors, and the mesh's primary is "
                             f"{mesh.primary}")
        return mesh.primary
    raise ValueError(f"no transport known for the {backend!r} backend: use nccl or gloo")


def _stage(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """`x` on the transport, contiguous: the one copy into a collective
    (device -> host for gloo)."""
    return x.to(_transport(mesh)).contiguous()


def _land(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """A collective's result on each of this process's shards' devices: the
    one copy out of it (host -> device for gloo), once per distinct device."""
    on = {d: x.to(d) for d in mesh.distinct}
    return [on[d] for d in mesh.devices]


def _gathered(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """Every process's parts concatenated along `dim` in global shard
    order, on the transport: the local concatenation, then one
    `all_gather` of equal chunks in rank order."""
    local = torch.cat([_stage(mesh, p) for p in parts], dim=dim).contiguous()
    chunks = [torch.empty_like(local) for _ in range(mesh.world)]
    dist.all_gather(chunks, local, group=mesh.group)
    return torch.cat(chunks, dim=dim)


def _reduced(mesh: Mesh, parts: Sequence[torch.Tensor], op) -> torch.Tensor:
    """The local reduction of the parts, then one `all_reduce` with `op`."""
    stacked = torch.stack([_stage(mesh, p) for p in parts])
    local = (stacked.amax(dim=0) if op == dist.ReduceOp.MAX else stacked.sum(dim=0)).contiguous()
    dist.all_reduce(local, op=op, group=mesh.group)
    return local


# -- the collectives ----------------------------------------------------------
def replicate(mesh: Mesh, x: torch.Tensor) -> list[torch.Tensor]:
    """`x` (the same host input in every process) on each of this
    process's shards' devices: one copy per distinct device."""
    on = {d: x.to(d) for d in mesh.distinct}
    return [on[d] for d in mesh.devices]


def all_gather(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int = 0) -> list[torch.Tensor]:
    """The shards' parts concatenated along `dim` (tiled) in shard order, on
    each shard's device: one concatenation per distinct device."""
    if mesh.group is not None:
        return _land(mesh, _gathered(mesh, parts, dim))
    on = {d: torch.cat([p.to(d) for p in parts], dim=dim) for d in mesh.distinct}
    return [on[d] for d in mesh.devices]


def pmax(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise max over the shards' tensors, on each shard's device."""
    if mesh.group is not None:
        return _land(mesh, _reduced(mesh, parts, dist.ReduceOp.MAX))
    on = {d: torch.stack([p.to(d) for p in parts]).amax(dim=0) for d in mesh.distinct}
    return [on[d] for d in mesh.devices]


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """The elementwise sum over the shards' tensors, on each shard's device.
    Across processes each adds its own parts first, then the processes'
    sums add."""
    if mesh.group is not None:
        return _land(mesh, _reduced(mesh, parts, dist.ReduceOp.SUM))
    on = {d: torch.stack([p.to(d) for p in parts]).sum(dim=0) for d in mesh.distinct}
    return [on[d] for d in mesh.devices]


def rotate(mesh: Mesh, parts: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """One ring step: shard i takes shard (i + 1) % S's part, as
    `ppermute(perm=[(i, (i - 1) % S)])` sends it. Across processes the moves
    inside a process stay local, and each process's first part goes to the
    previous rank (the first process's to the last) by one batch of
    point-to-point ops."""
    if mesh.group is None:
        S = mesh.size
        return [parts[(i + 1) % S].to(mesh.devices[i]) for i in range(S)]
    n = len(parts)
    out = [parts[j + 1].to(mesh.devices[j]) for j in range(n - 1)]
    first = _stage(mesh, parts[0])
    incoming = first
    if mesh.world > 1:
        incoming = torch.empty_like(first)
        peer = lambda r: dist.get_global_rank(mesh.group, r % mesh.world)  # noqa: E731
        ops = [dist.P2POp(dist.isend, first, peer(mesh.rank - 1), mesh.group),
               dist.P2POp(dist.irecv, incoming, peer(mesh.rank + 1), mesh.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    out.append(incoming.to(mesh.devices[n - 1]))
    return out


def gather_to(mesh: Mesh, parts: Sequence[torch.Tensor], dim: int = 0,
              device=None) -> torch.Tensor:
    """The shards' parts concatenated along `dim` in shard order on one
    device (the primary by default), in every process."""
    device = mesh.primary if device is None else device
    if mesh.group is not None:
        return _gathered(mesh, parts, dim).to(device)
    return torch.cat([p.to(device) for p in parts], dim=dim)


def split_rows(mesh: Mesh, x: torch.Tensor, rows: int, fill=0) -> list[torch.Tensor]:
    """(N, ...) -> this process's parts of `rows` rows each (S * rows >= N),
    shard s's part on its device, the tail past N filled with `fill`. A
    part that lies whole inside `x` on its own device is a view, not a
    copy; no other process's rows move."""
    N = x.shape[0]
    out = []
    for s, dev in zip(mesh.local_shards, mesh.devices):
        lo, hi = min(s * rows, N), min((s + 1) * rows, N)
        if hi - lo == rows:
            out.append(x[lo:hi].to(dev))
        else:
            part = torch.full((rows, *x.shape[1:]), fill, dtype=x.dtype, device=dev)
            part[:hi - lo] = x[lo:hi].to(dev)
            out.append(part)
    return out
