"""Loop method registry: name -> class (counterpart of
`seesaw_tpu/loops/registry.py`, with the same eleven methods)."""
from __future__ import annotations

from .active_search import ActiveSearch, LKNNSearch
from .graph_based import KnnProp2
from .multi_reg import MultiReg
from .multi_reg_neg import MultiRegNeg
from .point_based import LogReg2, Plain, RandomResults, RocchioUpdate
from .pseudo_lr import PseudoLR
from .textual import TextualFeedback

REGISTRY = {
    "plain": Plain,
    "log_reg2": LogReg2,
    "rocchio_update": RocchioUpdate,
    "random": RandomResults,
    "knn_prop2": KnnProp2,
    "pseudo_lr": PseudoLR,
    "multi_reg": MultiReg,
    "multi_reg_neg": MultiRegNeg,
    "active_search": ActiveSearch,
    "lknn": LKNNSearch,
    "textual": TextualFeedback,
}


def available_methods():
    return sorted(REGISTRY)


def build_loop_from_params(gdm, q, params):
    cls = REGISTRY.get(params.interactive)
    if cls is None:
        raise ValueError(
            f"unknown interactive method {params.interactive!r}; "
            f"available: {available_methods()}"
        )
    return cls.from_params(gdm, q, params)
