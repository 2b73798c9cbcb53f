"""Gaussian mixture with label-seeded initialization (research extra).

Counterpart of `seesaw_tpu/research/mixture.py` (the reference's
`seesaw/research/mixture.py:144-240`): full-covariance EM where the first
center is seeded from the labeled positives' mean and the rest by k-means++
D² sampling — the semi-supervised "find the positive cluster" experiment.
The EM loop runs a fixed number of iterations of torch ops on the model's
device, with no host read inside the loop: batched einsum covariance
updates, responsibilities by logsumexp, and log-determinants and
Mahalanobis distances from a Cholesky factor of each (SPD) covariance,
where the JAX package's jitted `fori_loop` takes `inv` and `slogdet`.
`cholesky_ex` and `solve_triangular` check nothing on the host, as
`linalg.inv` and `slogdet` on a CUDA tensor would (a device-host sync each).
`gen_data` and `kmeans_plusplus` are the JAX package's numpy.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch


def gen_data(n_classes: int = 3, n_dim: int = 2, n_samples: int = 1000,
             normalize: bool = False, seed: int = 0):
    """Synthetic mixture draw: returns (X (n,d), labels (n,), class_probs,
    mus, covs). Class 0 is the least popular (reference convention)."""
    rng = np.random.default_rng(seed)
    mus = rng.normal(scale=2.0, size=(n_classes, n_dim))
    class_probs = np.sort(rng.dirichlet(np.ones(n_classes)))
    cats = rng.choice(n_classes, size=n_samples, p=class_probs)
    X = mus[cats] + rng.normal(size=(n_samples, n_dim))
    if normalize:
        X = X / np.linalg.norm(X, axis=1, keepdims=True)
    covs = np.stack([np.eye(n_dim)] * n_classes)
    return X.astype(np.float32), cats, class_probs, mus, covs


def kmeans_plusplus(X: np.ndarray, center0: np.ndarray, n_clusters: int,
                    seed: int = 0) -> np.ndarray:
    """D²-sampling seeding with a FIXED first center (the labeled-positive
    mean) — the rest chosen proportionally to squared distance."""
    rng = np.random.default_rng(seed)
    centers = [np.asarray(center0, dtype=np.float64)]
    d2 = ((X - centers[0]) ** 2).sum(axis=1)
    for _ in range(1, n_clusters):
        total = d2.sum()
        if total <= 0:
            idx = rng.integers(0, X.shape[0])
        else:
            idx = rng.choice(X.shape[0], p=d2 / total)
        centers.append(X[idx].astype(np.float64))
        d2 = np.minimum(d2, ((X - centers[-1]) ** 2).sum(axis=1))
    return np.stack(centers).astype(np.float32)


def _log_norm_and_mahalanobis(X, mus, covs):
    """(k,) log normalization and (n, k) squared Mahalanobis distances."""
    d = X.shape[1]
    L = torch.linalg.cholesky_ex(covs).L  # (k, d, d) lower
    logdet = 2.0 * torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)
    log_norm = -0.5 * (d * math.log(2 * math.pi) + logdet)
    diff = (X[None, :, :] - mus[:, None, :]).transpose(1, 2)  # (k, d, n)
    z = torch.linalg.solve_triangular(L, diff, upper=False)  # L z = x - mu
    return log_norm, (z * z).sum(dim=1).T


def em_steps(X, mus, covs, log_pz, *, n_iters: int, reg: float = 1e-6):
    """`n_iters` EM iterations on X's device. Returns the final (mus, covs,
    log_pz) and the mean log-likelihood of the last E-step, all tensors
    (-inf for n_iters = 0)."""
    n, d = X.shape
    eye = reg * torch.eye(d, dtype=X.dtype, device=X.device)[None]
    ll = torch.full((), -math.inf, dtype=X.dtype, device=X.device)
    for _ in range(n_iters):
        # E-step
        log_norm, m = _log_norm_and_mahalanobis(X, mus, covs)
        log_joint = log_pz[None, :] + (log_norm[None, :] - 0.5 * m)
        log_px = torch.logsumexp(log_joint, dim=1)
        resp = torch.exp(log_joint - log_px[:, None])  # (n, k)
        # M-step
        nk = resp.sum(dim=0)  # (k,)
        log_pz = torch.log(nk / n)
        w = resp / torch.clamp_min(nk[None, :], 1e-12)  # (n, k) column-normalized
        mus = torch.einsum("nk,nd->kd", w, X)
        diff = X[None, :, :] - mus[:, None, :]
        covs = torch.einsum("kn,kni,knj->kij", w.T, diff, diff) + eye
        ll = log_px.mean()
    return mus, covs, log_pz, ll


class MixtureModel:
    """Full-covariance GMM on `device`; fit() seeds center 0 from labeled
    positives."""

    def __init__(self, n_components: int, seed: int = 0, *, device):
        self.n_components = n_components
        self.seed = seed
        self.device = torch.device(device)
        self.mus = self.covs = self.log_pz = None

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a, np.float32), device=self.device)

    def fit(self, X: np.ndarray,
            Xys: Optional[Tuple[np.ndarray, np.ndarray]] = None,
            max_iters: int = 100) -> float:
        X = np.asarray(X, np.float32)
        d = X.shape[1]
        if Xys is not None:
            X2, ys = Xys
            center0 = np.asarray(X2)[np.asarray(ys) > 0].mean(axis=0)
            allX = np.concatenate([X, np.asarray(X2, np.float32)])
        else:
            center0 = X.mean(axis=0)
            allX = X
        mus0 = kmeans_plusplus(allX, center0, self.n_components, seed=self.seed)
        covs0 = np.stack([np.eye(d, dtype=np.float32)] * self.n_components)
        log_pz0 = np.full(self.n_components, -math.log(self.n_components),
                          dtype=np.float32)
        mus, covs, log_pz, ll = em_steps(
            self._t(X), self._t(mus0), self._t(covs0), self._t(log_pz0),
            n_iters=max_iters,
        )
        self.mus, self.covs, self.log_pz = (t.cpu().numpy() for t in (mus, covs, log_pz))
        return float(ll)

    def _log_joint(self, X) -> torch.Tensor:
        log_norm, m = _log_norm_and_mahalanobis(self._t(X), self._t(self.mus),
                                                self._t(self.covs))
        return self._t(self.log_pz)[None, :] + log_norm[None, :] - 0.5 * m

    def log_px(self, X: np.ndarray) -> np.ndarray:
        """Per-point log likelihood under the fitted mixture."""
        return torch.logsumexp(self._log_joint(X), dim=1).cpu().numpy()

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        """Responsibilities p(z | x) (n, k)."""
        lj = self._log_joint(X)
        return torch.exp(lj - torch.logsumexp(lj, dim=1, keepdim=True)).cpu().numpy()
