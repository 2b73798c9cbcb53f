"""Multi-process initialization, the global mesh and the ingest fan-out.

Counterpart of `seesaw_tpu/parallel/multihost.py`. The JAX package joins
hosts with `jax.distributed`, after which `jax.devices()` spans them and
one global mesh runs every `shard_map` program as SPMD. Here
`torch.distributed` joins the processes (NCCL between CUDA devices, gloo on
the CPU or where processes share a card), with the coordinator, the world
size and the rank given explicitly: nothing on a machine announces a
cluster. The global mesh is then `parallel.mesh.make_mesh(devices=local,
group=dist.group.WORLD)`, one mesh over every process's devices (the SPMD
contract in `parallel.mesh`'s docstring), and `shutdown_multihost` leaves
the group. The ingest fan-out needs no mesh:
each process ingests a disjoint contiguous range of the corpus
(`ingest_file_range`), and the per-process vector files concatenate into
the single-process index.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist


def init_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    *,
    backend: Optional[str] = None,
) -> Tuple[int, int]:
    """Join the process group at `coordinator_address` ('host:port', or a
    'tcp://' / 'file://' URL) as rank `process_id` of `num_processes`.
    The backend defaults to NCCL when CUDA is available, gloo otherwise.
    Returns (world size, rank)."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend=backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id))
    return dist.get_world_size(), dist.get_rank()


def shutdown_multihost() -> None:
    """Leave the process group (`destroy_process_group`)."""
    dist.destroy_process_group()


def ingest_file_range(
    n_files: int,
    process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> Tuple[int, int]:
    """This process's disjoint [lo, hi) slice of the corpus for the ingest
    fan-out. Contiguous ranges keep the global row order: concatenating the
    per-process vector files reproduces the single-process index. Without
    arguments, the rank and world size of the initialized process group."""
    if process_index is None or process_count is None:
        process_index, process_count = dist.get_rank(), dist.get_world_size()
    per = -(-n_files // process_count)
    lo = min(process_index * per, n_files)
    return lo, min(lo + per, n_files)
