"""How `correct` is decided: what the timed path showed, against the plain
reference (`reference.py`), once the window has closed.

Every click of every session is checked for results that cannot be right
(`bad_results`: a frame shown twice in a session, a short batch, an id out
of range). A sample of sessions, drawn from the seed among those that
finished a click in the window, with the session of the most clicks among
them, is replayed click by click: the exclusions and the labels of each
click are what the program showed and the user said before it, and the
method's check (`loadbench/checks/<method>.py`) computes its readings. A
control computes the same readings with the reference, in a lower
precision, in the program's place (`precision`); the benchmark's own runs do
not run it.
"""
from __future__ import annotations

import importlib.util
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import inputs as inp
from .cell import BENCH_DIR
from .reference import Ranker

EXACT = "exact"


@dataclass
class Context:
    cfg: dict
    traffic: dict
    seed: int
    inputs: inp.IndexInputs
    ranker: Ranker
    graph_raw: tuple | None  # (dst, dist) on the device, where the config has a graph
    precision: str

    @property
    def device(self):
        return self.inputs.V.device

    def text_vector(self, s) -> np.ndarray:
        return inp.query_vector(self.seed, s.user, s.session, self.inputs.dim)

    def excluded(self, frames) -> torch.Tensor:
        m = torch.zeros(self.inputs.n_frames, dtype=torch.bool, device=self.device)
        if len(frames):
            m[torch.as_tensor(np.asarray(frames, dtype=np.int64), device=self.device)] = True
        return m


def bad_results(sessions, batch: int, n_frames: int) -> int:
    """Clicks that showed a short batch, an id out of range, or a frame
    already shown in the session."""
    bad = 0
    for s in sessions:
        seen = set()
        for c in s.clicks:
            ids = [int(x) for x in c.shown]
            if (len(ids) != batch or len(set(ids)) != len(ids) or seen.intersection(ids)
                    or any(x < 0 or x >= n_frames for x in ids)):
                bad += 1
            seen.update(ids)
    return bad


def sample(sessions, window, seed: int, n: int):
    """`n` sessions drawn from the seed among those with a click finished
    in the window, and the one of them with the most clicks."""
    t_open, t_close = window
    live = [s for s in sessions if any(t_open <= c.t_end <= t_close for c in s.clicks)]
    if not live:
        return []
    longest = max(range(len(live)), key=lambda i: (len(live[i].clicks), -i))
    rng = inp.host_rng(seed, 3)
    picks = set(rng.choice(len(live), size=min(n, len(live)), replace=False).tolist())
    picks.add(longest)
    return [live[i] for i in sorted(picks)]


def method_check(method: str):
    """The module `loadbench/checks/<method>.py`."""
    path = BENCH_DIR / "checks" / f"{method}.py"
    spec = importlib.util.spec_from_file_location(f"loadbench_check_{method}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def readings(cfg, traffic, seed, index_inputs, graph_raw, sessions, window,
             precision: str = EXACT) -> dict:
    """Every number compared, by name, with the seconds the check took under
    `check_s`."""
    t0 = time.perf_counter()
    s = cfg["session"]
    ctx = Context(cfg, traffic, seed, index_inputs,
                  Ranker(index_inputs.tile_boxes, index_inputs.tile_zoom,
                         shortlist=int(s["shortlist_size"]), topk=int(s["batch_size"]),
                         device=index_inputs.V.device),
                  graph_raw, precision)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        picked = sample(sessions, window, seed, int(traffic["check_sessions"]))
        out = {"bad_results": bad_results(sessions, int(s["batch_size"]),
                                          index_inputs.n_frames)}
        out.update(method_check(traffic["method"]).readings(ctx, picked))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["checked_clicks"] = sum(len(x.clicks) for x in picked)
    out["check_s"] = time.perf_counter() - t0
    return out


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every number that has a
    limit; a number without one, or a limit without its number, fails."""
    shown, ok = {}, True
    for name, lim in limits.items():
        v = values.get(name)
        shown[name] = {"value": v, "limit": lim["limit"]}
        if v is None or not v <= lim["limit"]:
            ok = False
    if not limits:
        ok = False
    return ok, shown
