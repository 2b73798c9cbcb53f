"""Offline CLIP fine-tuning: contrastive training and hyperparameter search.

Counterpart of `seesaw_tpu/models/clip_finetune.py`: a symmetric
contrastive loss over (image, text) pairs, per-parameter-group optimizer
configuration by prefix of the flax path (`text/projection/kernel`; each
group with its own lr and weight decay, unlisted groups frozen), a warmup
schedule, and a successive-halving random search.

The optimizer is `torch.optim.AdamW` made to step as optax's `adamw` does:
the group's weight decay passed explicitly (torch's default is 1e-2, optax's
0 here), and a warmup schedule evaluated at the count of updates before the
step, so the first step's lr is 0 while Adam's moments still take its
gradient. Frozen parameters get `requires_grad=False`: the JAX step computes
every gradient and zeroes the frozen ones (`optax.set_to_zero`), the port
computes only what trains, which gives the same update. With the default
`{"text/projection": ...}` config no backward runs through any attention
layer.

The towers are a trainable copy of the embedding's model
(`ClipEmbedding.trainable_copy`), on the tuner's device: the registry's
embedding, shared by every session on that device, is never changed. On a
CUDA device every attention layer's forward and backward are the
hand-written kernels (`ops.attention`).
"""
from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Callable, Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .clip import ClipEmbedding, cpu_state_dict, flax_path


def clip_contrastive_loss(image_feats: torch.Tensor, text_feats: torch.Tensor,
                          logit_scale: torch.Tensor) -> torch.Tensor:
    """Symmetric InfoNCE over a batch of aligned (image, text) pairs."""
    img = image_feats / torch.linalg.norm(image_feats, dim=-1, keepdim=True)
    txt = text_feats / torch.linalg.norm(text_feats, dim=-1, keepdim=True)
    logits = torch.exp(logit_scale) * img @ txt.T
    labels = torch.arange(logits.shape[0], device=logits.device)
    li = F.cross_entropy(logits, labels)
    lt = F.cross_entropy(logits.T, labels)
    return (li + lt) / 2.0


def _prefix_label(path_str: str, opt_config: Dict[str, Optional[dict]]) -> str:
    """Longest configured prefix wins; unmatched params are frozen, as are
    params whose longest prefix maps to None."""
    best, best_len = "frozen", -1
    for prefix, cfg in opt_config.items():
        if path_str.startswith(prefix) and len(prefix) > best_len:
            best = prefix if cfg is not None else "frozen"
            best_len = len(prefix)
    return best


def warmup_factor(count: int, warmup_steps: int) -> float:
    """optax's linear warmup to 1 over `warmup_steps` updates, then 1
    (`warmup_constant_schedule(0, 1, n)`), at the pre-increment count."""
    return min(count / warmup_steps, 1.0) if warmup_steps > 0 else 1.0


class ScheduledAdamW:
    """`torch.optim.AdamW` over parameter groups (each a dict with `params`,
    `lr` and `weight_decay`) whose lr is the group's lr times
    `schedule(count)`, count = the updates made so far. That is optax's
    `adamw` with a schedule for its lr, and also `chain(adamw(lr),
    scale_by_schedule(s))`: scaling the whole AdamW update equals scaling
    its lr, weight decay included."""

    def __init__(self, groups: List[dict], schedule: Callable[[int], float]):
        groups = [dict(g, base_lr=g["lr"]) for g in groups if g["params"]]
        self.optimizer = (torch.optim.AdamW(groups, betas=(0.9, 0.999), eps=1e-8)
                          if groups else None)
        self.schedule = schedule
        self.count = 0

    def step(self):
        if self.optimizer is not None:
            f = self.schedule(self.count)
            for g in self.optimizer.param_groups:
                g["lr"] = g["base_lr"] * f
            self.optimizer.step()
        self.count += 1

    def zero_grad(self):
        if self.optimizer is not None:
            self.optimizer.zero_grad(set_to_none=True)


def make_grouped_optimizer(named_params: Mapping[str, torch.Tensor],
                           opt_config: Dict[str, Optional[dict]],
                           warmup_steps: int = 0) -> ScheduledAdamW:
    """AdamW with one group per configured prefix of the parameters' flax
    paths (`named_params`: path -> parameter), each with its `lr` and
    `weight_decay` (default 0.0) and a linear warmup of `warmup_steps`.
    Parameters that no configured prefix takes are frozen: their
    `requires_grad` is switched off."""
    labels = {name: _prefix_label(name, opt_config) for name in named_params}
    groups = []
    for prefix, cfg in opt_config.items():
        if cfg is None:
            continue
        groups.append({"params": [p for n, p in named_params.items() if labels[n] == prefix],
                       "lr": float(cfg["lr"]),
                       "weight_decay": float(cfg.get("weight_decay", 0.0))})
    for name, p in named_params.items():
        p.requires_grad_(labels[name] != "frozen")
    return ScheduledAdamW(groups, lambda c: warmup_factor(c, warmup_steps))


def _batch(a, sel: np.ndarray, device: torch.device) -> torch.Tensor:
    """Rows `sel` of a numpy array or a tensor, as a tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a[torch.from_numpy(sel).to(a.device)].to(device)
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)[sel])).to(device)


class CLIPFineTuner:
    """Contrastive fine-tuning of a trainable copy of `embedding`'s towers on
    `device`, on (pixels NHWC normalized, tokens) pairs."""

    def __init__(self, embedding: ClipEmbedding, config: dict, *, device):
        self.embedding = embedding
        self.config = dict(config)
        self.device = torch.device(device)
        self.model = embedding.trainable_copy(self.device)
        opt_config = self.config.get("opt_config") or {
            "text/projection": {"lr": self.config.get("lr", 5e-5), "weight_decay": 0.0}
        }
        self.optimizer = make_grouped_optimizer(
            {flax_path(n): p for n, p in self.model.named_parameters()}, opt_config,
            warmup_steps=self.config.get("warmup", 0))
        self.losses: List[float] = []

    def loss(self, pixels: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        img = self.model.encode_image(pixels)
        txt = self.model.encode_text(tokens)
        return clip_contrastive_loss(img, txt, self.model.logit_scale)

    def train_step(self, pixels: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
        """One update on a batch already on the device; returns the loss
        before the update (a 0-d tensor, not synchronized)."""
        loss = self.loss(pixels, tokens)
        loss.backward()
        self.optimizer.step()
        self.optimizer.zero_grad()
        return loss.detach()

    def fit(self, pixels, tokens, *, epochs: int = 1, batch_size: int = 32, seed: int = 0):
        """Epochs over a numpy `default_rng(seed)` permutation of the pairs,
        in full batches (the remainder is dropped; a batch larger than the
        data shrinks to it). pixels and tokens: numpy arrays or tensors."""
        n = pixels.shape[0]
        if n == 0:
            raise ValueError("fit called with zero pairs")
        batch_size = min(batch_size, n)
        rng = np.random.default_rng(seed)
        for _ in range(epochs):
            order = rng.permutation(n)
            for lo in range(0, n - batch_size + 1, batch_size):
                sel = order[lo:lo + batch_size]
                loss = self.train_step(_batch(pixels, sel, self.device),
                                       _batch(tokens, sel, self.device))
                self.losses.append(float(loss))
        return self

    def eval_loss(self, pixels, tokens) -> float:
        sel = np.arange(pixels.shape[0])
        with torch.no_grad():
            return float(self.loss(_batch(pixels, sel, self.device),
                                   _batch(tokens, sel, self.device)))

    def state_dict(self) -> dict:
        """The tuned parameters as an f32 CPU state dict of copies."""
        return cpu_state_dict(self.model)

    def to_embedding(self) -> ClipEmbedding:
        return ClipEmbedding(
            variant=self.embedding.variant,
            # the variant alone would rebuild the default config
            cfg=self.embedding.cfg,
            # None keeps cfg.dtype (the constructor's f32 default would not)
            dtype=None,
            params=self.state_dict(),
            tokenizer=self.embedding.tokenizer,
            device=self.device,
        )


def sample_search_space(space: dict, rng: random.Random) -> dict:
    """{k: {'choose': [...]}} or {'loguniform': [lo, hi]} leaves."""
    out = {}
    for k, v in space.items():
        if isinstance(v, dict) and "choose" in v:
            out[k] = rng.choice(v["choose"])
        elif isinstance(v, dict) and "loguniform" in v:
            lo, hi = v["loguniform"]
            out[k] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        elif isinstance(v, dict):
            out[k] = sample_search_space(v, rng)
        else:
            out[k] = v
    return out


def successive_halving_search(
    space: dict,
    make_and_eval: Callable[[dict, int], float],
    *,
    n_trials: int = 8,
    rungs: List[int] = (1, 2, 4),
    eta: int = 2,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
):
    """Serial ASHA-style search: sample configs, train each for rung[0]
    budget, keep the best 1/eta fraction per rung at increasing budget.
    make_and_eval(config, budget_units) -> validation loss (lower better).
    Returns (best_config, best_loss, history).

    With checkpoint_dir, search state (history + survivors) persists to
    search_state.json after every trial, and a restarted search resumes past
    completed (config, budget) evaluations."""
    rng = random.Random(seed)
    trials = [sample_search_space(space, rng) for _ in range(n_trials)]
    history = []
    done = {}
    state_path = Path(checkpoint_dir) / "search_state.json" if checkpoint_dir else None
    if state_path and state_path.exists():
        history = json.loads(state_path.read_text())["history"]
        done = {
            (json.dumps(h["config"], sort_keys=True), h["budget"]): h["loss"]
            for h in history
        }

    def save_state():
        if state_path:
            state_path.parent.mkdir(parents=True, exist_ok=True)
            state_path.write_text(json.dumps({"history": history}))

    survivors = trials
    scored = []
    for rung in rungs:
        scored = []
        for cfg in survivors:
            key = (json.dumps(cfg, sort_keys=True), rung)
            if key in done:
                loss = done[key]
            else:
                loss = make_and_eval(cfg, rung)
                history.append({"config": cfg, "budget": rung, "loss": loss})
                done[key] = loss
                save_state()
            scored.append((loss, cfg))
        scored.sort(key=lambda t: t[0])
        keep = max(1, len(scored) // eta)
        survivors = [cfg for _, cfg in scored[:keep]]
    # the final rung's winner: a min over all history would mix budgets
    best_loss, best_cfg = scored[0]
    return best_cfg, best_loss, history
