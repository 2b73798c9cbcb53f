"""Loop method registry: name -> class, for the loops the port has so far
(counterpart of `seesaw_tpu/loops/registry.py`)."""
from __future__ import annotations

from .point_based import LogReg2, Plain, RandomResults, RocchioUpdate

REGISTRY = {
    "plain": Plain,
    "log_reg2": LogReg2,
    "rocchio_update": RocchioUpdate,
    "random": RandomResults,
}


def available_methods():
    return sorted(REGISTRY)


def build_loop_from_params(gdm, q, params):
    cls = REGISTRY.get(params.interactive)
    if cls is None:
        raise ValueError(
            f"unknown or not yet ported interactive method {params.interactive!r}; "
            f"available: {available_methods()}"
        )
    return cls.from_params(gdm, q, params)
