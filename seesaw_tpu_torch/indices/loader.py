"""Index loading for the port: `info.json` dispatch to the PyTorch classes.

Counterpart of `seesaw_tpu.indices.interface.AccessMethod.load`. The JAX
package writes its own class path into `info.json`'s constructor string;
here that string maps to the port's class, so both packages read the same
on-disk index unchanged. Loads are memoized per (path, options, device) in a
cache of this package's own, so a process that loads one root through both
packages never gets the JAX index back from this loader.
"""
from __future__ import annotations

import json
from pathlib import Path

import torch

from seesaw_tpu.runtime.cache import LocalCache

from .multiscale import MultiscaleIndex

CONSTRUCTORS = {
    "seesaw_tpu.indices.multiscale.MultiscaleIndex": MultiscaleIndex,
    "seesaw_tpu_torch.indices.multiscale.MultiscaleIndex": MultiscaleIndex,
}

index_cache = LocalCache()


def load_index(index_path: str, *, device, options: dict | None = None):
    """Load (or return the shared, already loaded) index at `index_path`
    onto `device`."""
    index_path = str(Path(index_path))
    device = torch.device(device)
    key = json.dumps(
        [index_path, str(device), options or {}], sort_keys=True, default=repr
    )

    def init():
        info = json.loads((Path(index_path) / "info.json").read_text())
        cons = CONSTRUCTORS.get(info["constructor"])
        if cons is None:
            raise NotImplementedError(
                f"index constructor {info['constructor']!r} is not ported"
            )
        return cons.from_path(index_path, device=device, **(options or {}))

    return index_cache.get_or_initialize(key, init)
