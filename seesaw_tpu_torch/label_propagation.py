"""LabelPropagation: host wrapper over the device Jacobi run.

Counterpart of `seesaw_tpu/label_propagation.py`: construct with a weight
structure and reg_lambda, call `fit_transform` with labeled ids and values,
prior (reg) values and an optional warm start. The bounds check matches the
reference's invariant: scores stay within [min(0, prior_min),
max(1, prior_max)].

With a `mesh` of several devices the graph is row-sharded over them once
(`parallel.sharded_graph.shard_graph`, cached with the weights) and each
run is `parallel.sharded_graph.propagate_on_mesh`; the scores come back on
the mesh's primary device, which is this propagation's `device`. Over a
mesh that spans processes each process holds its own row blocks, and
every process gets the same scores, steps and converged flag.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .knn_graph import SymmetricWeights
from .ops.propagation import PropagationResult, propagate


def check_prior_bounds(scores: np.ndarray, prior) -> None:
    """Propagated scores stay within [min(0, prior min), max(1, prior max)]."""
    prior = prior.cpu().numpy() if isinstance(prior, torch.Tensor) else np.asarray(prior)
    lo = min(0.0, float(prior.min(initial=0.0)))
    hi = max(1.0, float(prior.max(initial=1.0)))
    assert (scores >= lo - 1e-5).all(), "scores must stay within prior bounds"
    assert (scores <= hi + 1e-5).all(), "scores must stay within prior bounds"


class LabelPropagation:
    def __init__(
        self,
        weights: SymmetricWeights,
        *,
        reg_lambda: float,
        device=None,
        max_iter: int = 300,
        epsilon: float = 1e-5,
        verbose: int = 0,
        dispatch_iters: Optional[int] = 100,
        mesh=None,
    ):
        assert reg_lambda >= 0
        self.weights = weights
        self.n = weights.nvecs
        # a one-device mesh takes the single-device path
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        if device is None:
            if mesh is None:
                raise ValueError("LabelPropagation needs a device or a mesh")
            device = mesh.primary
        self.device = torch.device(device)
        self.reg_lambda = reg_lambda
        self.max_iter = max_iter
        self.epsilon = epsilon
        # steps per segment: the host reads (steps, done) once per segment
        self.dispatch_iters = dispatch_iters
        self.verbose = verbose
        # the most recent run's PropagationResult (None before the first)
        self.last_result: Optional[PropagationResult] = None

    def graph(self):
        """(nbr, w, degree) on this propagation's device (one copy per device,
        shared by every session over the same weights)."""
        return self.weights.device_arrays(self.device)

    def mesh_graph(self):
        """The weights row-sharded over the mesh, made once per mesh."""
        from .parallel.sharded_graph import shard_graph

        key = ("mesh", self.mesh)
        w = self.weights
        g = w._device_cache.get(key)
        if g is None:
            g = w._device_cache[key] = shard_graph(self.mesh, w.nbr, w.w, w.degree)
        return g

    def fit_transform_device(self, *, labels, is_labeled, reg_values, start) -> torch.Tensor:
        """`fit_transform` with all state already on the device: one
        segmented propagation, device scores out, its PropagationResult
        kept in `last_result`. No bounds check (the ranker applies it when
        a host consumer reads the scores)."""
        opts = dict(reg_lambda=float(self.reg_lambda), max_iter=self.max_iter,
                    epsilon=self.epsilon, dispatch_iters=self.dispatch_iters)
        if self.mesh is not None:
            from .parallel.sharded_graph import propagate_on_mesh

            res = propagate_on_mesh(self.mesh_graph(), reg_values, labels, is_labeled,
                                    start, **opts)
        else:
            res = propagate(*self.graph(), reg_values, labels, is_labeled, start, **opts)
        self.last_result = res
        if self.verbose and not res.converged:
            print(f"warning: propagation did not converge after {res.n_iter} iters")
        return res.scores

    def fit_transform(
        self,
        *,
        label_ids: np.ndarray,
        label_values: np.ndarray,
        reg_values: Optional[np.ndarray] = None,
        start_value: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Host arrays in, bounds-checked host scores out."""
        if reg_values is None:
            assert self.reg_lambda == 0
            reg_values = np.zeros(self.n, dtype=np.float32)
        reg_values = np.asarray(reg_values, dtype=np.float32)
        assert reg_values.shape[0] == self.n
        labels = np.zeros(self.n, dtype=np.float32)
        is_labeled = np.zeros(self.n, dtype=bool)
        ids = np.asarray(label_ids).reshape(-1).astype(np.int64)
        labels[ids] = np.asarray(label_values, dtype=np.float32).reshape(-1)
        is_labeled[ids] = True
        start = reg_values if start_value is None else np.asarray(start_value, np.float32)

        def t(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        out = self.fit_transform_device(
            labels=t(labels), is_labeled=t(is_labeled), reg_values=t(reg_values),
            start=t(start),
        ).cpu().numpy()
        check_prior_bounds(out, reg_values)
        return out
