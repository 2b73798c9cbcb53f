"""Online textual-feedback model: per-string linear scorers, or fine-tuning
of the text tower's projection.

Counterpart of `seesaw_tpu/models/online_model.py`:

- mode='linear': one linear scorer per distinct description string (weight
  initialized from the string's CLIP embedding, plus a bias and a logit
  scale). Scores are the softmax over scorers; training = description
  cross-entropy (image -> its annotated string) + a pairwise hinge rank loss
  on the target string's log-softmax score, AdamW with two learning-rate
  groups and a linear warmup that scales the whole update.
- mode='finetune': the text tower is frozen up to the final projection;
  only `text_projection` trains, with a multi-margin label loss + the rank
  loss.

The model resets per session and update, and caches each string's pooled
text features before the projection, so only the trainable tail
recomputes. `text_projection` is the flax (in, out) kernel, the transpose
of the port's `Dense.weight`. Everything trains and scores on `device`, the
session's; the embedding's own model is only read.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .clip import ClipEmbedding
from .clip_finetune import ScheduledAdamW, warmup_factor


def deduplicate_strings(strings: List[str]):
    s2id: Dict[str, int] = {}
    ids = []
    for s in strings:
        if s not in s2id:
            s2id[s] = len(s2id)
        ids.append(s2id[s])
    id2s = [None] * len(s2id)
    for s, i in s2id.items():
        id2s[i] = s
    return {"strings": id2s, "indices": np.array(ids)}


def _hinge_rank_loss(scores: torch.Tensor, marked_accepted: torch.Tensor, margin: float):
    """Mean hinge over (pos, neg) pairs; 0 when one side is empty."""
    pos = marked_accepted
    npos = pos.sum()
    n = scores.shape[0]
    have_both = (npos > 0) & (npos < n)
    diff = scores[:, None] - scores[None, :]  # pos_i - neg_j where paired
    pair = pos[:, None] & (~pos)[None, :]
    losses = torch.where(pair, torch.clamp(margin - diff, min=0.0), 0.0)
    denom = torch.clamp(pair.sum(), min=1)
    return torch.where(have_both, losses.sum() / denom, 0.0), have_both


def _adamw_loop(params: List[dict], warmup: int, n_steps: int, loss_fn, losses: list):
    opt = ScheduledAdamW(params, lambda c: warmup_factor(c, warmup))
    for _ in range(n_steps):
        loss = loss_fn()
        loss.backward()
        opt.step()
        opt.zero_grad()
        losses.append(float(loss.detach()))


class OnlineModel:
    def __init__(self, embedding: ClipEmbedding, config: dict, *, device):
        self.embedding = embedding
        self.config = dict(config)
        self.mode = self.config["mode"]
        if self.mode not in ("linear", "finetune"):
            raise ValueError(f"unknown OnlineModel mode {self.mode!r}")
        self.device = torch.device(device)
        self.losses: list = []
        self._preproj_cache: Dict[str, torch.Tensor] = {}
        self._target_string: Optional[str] = None
        self.reset()

    # -- plumbing ----------------------------------------------------------
    def _base_projection(self) -> torch.Tensor:
        """The embedding's projection as the flax (in, out) kernel, f32 on
        this model's device (a copy)."""
        w = self.embedding.model.text.projection.weight.detach()
        return w.T.to(self.device, torch.float32, copy=True)

    def reset(self):
        """Reset the trainable state."""
        self.scorer_names: List[str] = []
        self.scorer_params: Optional[dict] = None
        self.text_projection = self._base_projection()

    def encode_string(self, s: str) -> np.ndarray:
        """Unit embedding through the current (possibly tuned) projection."""
        out = self._encode_preprojection([s]) @ self.text_projection
        return (out / torch.linalg.norm(out, dim=1, keepdim=True))[0].cpu().numpy()

    def _encode_preprojection(self, strings: List[str]) -> torch.Tensor:
        """(n, text_width) f32 pooled text features before the projection,
        on this model's device, cached per string (the frozen part of the
        tower)."""
        missing = [s for s in dict.fromkeys(strings) if s not in self._preproj_cache]
        if missing:
            emb = self.embedding
            toks = np.stack([emb.tokenizer.encode(s) for s in missing])
            with torch.no_grad():
                out = emb.model.encode_text_preproj(torch.from_numpy(toks).to(emb.device))
            for s, v in zip(missing, out.to(self.device, torch.float32)):
                self._preproj_cache[s] = v
        return torch.stack([self._preproj_cache[s] for s in strings])

    # -- scoring -----------------------------------------------------------
    def score_vecs(self, imagevecs) -> torch.Tensor:
        """(N,) f32 score of the target string (scorer/string 0) for each
        row of `imagevecs` (a tensor or numpy array), on this model's
        device."""
        X = torch.as_tensor(imagevecs, dtype=torch.float32).to(self.device)
        if self.mode == "linear":
            if self.scorer_params is None or not self.scorer_names:
                raise RuntimeError("score_vecs before update")
            p = self.scorer_params
            logits = X @ p["w"].T * torch.exp(p["ls"]) + p["b"]
            if logits.shape[1] > 1:
                return torch.softmax(logits, dim=1)[:, 0]
            return logits[:, 0]
        # finetune: cosine against the tuned target-string vector
        if self._target_string is None:
            raise RuntimeError("score_vecs before update")
        v = torch.from_numpy(self.encode_string(self._target_string)).to(self.device)
        return X @ v

    def get_lookup_vec(self, s: str) -> np.ndarray:
        if self.mode == "linear" and self.scorer_params is not None and s in self.scorer_names:
            return self.scorer_params["w"][self.scorer_names.index(s)].cpu().numpy()
        return self.encode_string(s)

    # -- training ----------------------------------------------------------
    def update(self, imagevecs: np.ndarray, marked_accepted: np.ndarray,
               annotations: np.ndarray, target_string: str):
        if not imagevecs.shape[0] == marked_accepted.shape[0] == annotations.shape[0]:
            raise ValueError("imagevecs, marked_accepted and annotations differ in length")
        if target_string == "":
            raise ValueError("empty target string")
        self._target_string = target_string
        self.reset()

        has_desc = np.array([a != "" and a is not None for a in annotations], dtype=bool)
        desc_vecs = imagevecs[has_desc]
        desc_strs = list(np.asarray(annotations, dtype=object)[has_desc])

        d = deduplicate_strings([target_string] + desc_strs)
        strings = d["strings"]
        string_ids = d["indices"][1:]  # per annotated vec, its string id

        if self.mode == "linear":
            init_w = torch.stack([self._normalized_string_vec(s) for s in strings])
            self.scorer_names = list(strings)
            self._train_linear(init_w, desc_vecs, string_ids, imagevecs, marked_accepted)
        else:
            pre = self._encode_preprojection(strings)
            self._train_finetune(pre, desc_vecs, string_ids, imagevecs, marked_accepted)
        return self.losses

    def _normalized_string_vec(self, s: str) -> torch.Tensor:
        out = self._encode_preprojection([s]) @ self._base_projection()
        return (out / torch.linalg.norm(out, dim=1, keepdim=True))[0]

    def _tensors(self, desc_vecs, string_ids, all_vecs, marked_accepted):
        dev = self.device
        return (torch.from_numpy(np.asarray(desc_vecs, np.float32)).to(dev),
                torch.from_numpy(np.asarray(string_ids, np.int64)).to(dev),
                torch.from_numpy(np.asarray(all_vecs, np.float32)).to(dev),
                torch.from_numpy(np.asarray(marked_accepted, bool)).to(dev))

    def _train_linear(self, init_w, desc_vecs, string_ids, all_vecs, marked_accepted):
        cfg = self.config
        S = init_w.shape[0]
        w = init_w.clone().requires_grad_()
        b = torch.zeros(S, device=self.device, requires_grad=True)
        ls = torch.zeros(S, device=self.device, requires_grad=True)
        dv, sid, av, acc = self._tensors(desc_vecs, string_ids, all_vecs, marked_accepted)
        n_desc = dv.shape[0]
        image_w = cfg.get("image_loss_weight", 0.5)
        margin = cfg.get("rank_margin", 0.1)
        warmup = cfg.get("num_warmup_steps", 4)

        def logits_of(X):
            return X @ w.T * torch.exp(ls) + b

        def loss_fn():
            if n_desc > 0 and S > 1:
                logp = F.log_softmax(logits_of(dv), dim=1)
                l1 = -logp[torch.arange(n_desc, device=self.device), sid].mean()
            else:
                l1 = 0.0
            lg = logits_of(av)
            ranking = F.log_softmax(lg, dim=-1)[:, 0] if S > 1 else lg[:, 0]
            l2, _ = _hinge_rank_loss(ranking, acc, margin)
            return (1.0 - image_w) * l1 + image_w * l2

        groups = [dict(params=[w], lr=0.001, weight_decay=0.0),
                  dict(params=[b, ls], lr=0.002, weight_decay=0.0)]
        _adamw_loop(groups, warmup, cfg.get("rounds", 10) + warmup, loss_fn, self.losses)
        self.scorer_params = {"w": w.detach(), "b": b.detach(), "ls": ls.detach()}

    def _train_finetune(self, pre, desc_vecs, string_ids, all_vecs, marked_accepted):
        cfg = self.config
        P = self.text_projection.clone().requires_grad_()
        dv, sid, av, acc = self._tensors(desc_vecs, string_ids, all_vecs, marked_accepted)
        S = pre.shape[0]
        n_desc = dv.shape[0]
        image_w = cfg.get("image_loss_weight", 0.5)
        rank_margin = cfg.get("rank_margin", 0.1)
        label_margin = cfg.get("label_margin", 0.1)
        warmup = cfg.get("num_warmup_steps", 0)

        def loss_fn():
            feats = pre @ P
            feats = feats / torch.linalg.norm(feats, dim=1, keepdim=True)
            if n_desc > 0 and S > 1:
                scores = dv @ feats.T  # (n, S)
                s_t = scores[torch.arange(n_desc, device=self.device), sid]
                viol = torch.clamp(label_margin - s_t[:, None] + scores, min=0.0)
                not_t = torch.arange(S, device=self.device)[None, :] != sid[:, None]
                l1 = (torch.where(not_t, viol, 0.0).sum(dim=1) / S).mean()
            else:
                l1 = 0.0
            rank_scores = (av @ feats.T)[:, 0]
            l2, _ = _hinge_rank_loss(rank_scores, acc, rank_margin)
            return (1.0 - image_w) * l1 + image_w * l2

        groups = [dict(params=[P], lr=cfg.get("lr", 5e-4),
                       weight_decay=cfg.get("weight_decay", 0.0))]
        _adamw_loop(groups, warmup, cfg.get("rounds", 10) + warmup, loss_fn, self.losses)
        self.text_projection = P.detach()
