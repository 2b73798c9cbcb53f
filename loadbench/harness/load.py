"""The load: closed-loop simulated users, one thread each, through the
port's `Session` as the web server's threads use it.

Rewritten from `seesaw_tpu_torch/utils/rounds.py` `drive_concurrent_sessions`.
A click is one `next`, one label round, one `update_state` and one
`refine`. A session ends after `max_clicks` clicks or once its user has
accepted `found_target` images, and a new session with a new text query
takes the thread; its round 0 (the session made, the text set, the first
`next`) counts as a click. There is no think time. So that every seed gives
the same work in another order, the mix fixes how many clicks each session
takes to find its results (`session_clicks`, taken in turn, each user from
its own place in the list), and the seed draws which images are accepted
(`inputs.accept_schedule`).

The threads start together and run until every one has finished
`warm_clicks` clicks and `warm_seconds` have passed; then the window opens.
Every session stays active until the window closes, after which each
thread finishes the click it is in and stops. A `next` is timed from the
call until its results are on the host; no device-wide synchronize sits
inside a user's clock. The calls into each layer are `loadbench.*`
annotations, which a traced run records with their threads.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from types import SimpleNamespace

import numpy as np
import torch

from . import inputs

SPAN_PREFIX = "loadbench."


@dataclass
class Click:
    user: int
    session: int
    k: int  # the click's position in its session (0 = round 0)
    t_start: float  # perf_counter seconds
    t_next: float  # when next's results were on the host
    t_end: float
    shown: np.ndarray  # dbidxs
    accepted: np.ndarray  # the user's verdict on each shown image
    qvec: np.ndarray | None = None  # the refined query the next ran with
    steps: int | None = None  # Jacobi steps, where the next propagated

    @property
    def next_ms(self) -> float:
        return (self.t_next - self.t_start) * 1e3


@dataclass
class SessionLog:
    user: int
    session: int
    clicks: list = field(default_factory=list)
    final_scores: torch.Tensor | None = None  # knn: the last propagated scores


def span(name: str):
    """A `loadbench.<name>` annotation, recorded with its thread in a trace
    (a cheap no-op outside one)."""
    return torch.profiler.record_function(SPAN_PREFIX + name)


class QueryEmbedding:
    """The text tower's stand-in: the query string names (user, session),
    and its vector is the seed's (`inputs.query_vector`)."""

    def __init__(self, seed: int, dim: int):
        self.seed, self.dim = seed, dim

    @staticmethod
    def text(user: int, session: int) -> str:
        return f"loadbench query {user} {session}"

    def from_string(self, string: str):
        *_, u, s = string.split()
        return inputs.query_vector(self.seed, int(u), int(s), self.dim)


def label_state(session, accepted, user_box):
    """The client's state after the user marked the last batch: an
    accepted image gets the user's box, marked accepted; a rejected one no
    box."""
    from seesaw_tpu_torch.basic_types import Box

    state = session.get_state()
    x1, y1, x2, y2 = (float(c) for c in user_box)
    for im, a in zip(state.gdata[-1], accepted):
        im.boxes = [Box(x1=x1, y1=y1, x2=x2, y2=y2, marked_accepted=True)] if a else []
    return state


class Load:
    """`users` threads of `traffic["method"]` sessions over `served`."""

    def __init__(self, served, params, *, seed: int, traffic: dict, cell_config: dict):
        self.served, self.params, self.seed = served, params, seed
        self.users = int(traffic["users"])
        self.max_clicks = int(traffic["max_clicks"])
        self.found_target = int(traffic["found_target"])
        self.lengths = [int(x) for x in traffic["session_clicks"]]
        self.user_box = traffic["user_box"]
        self.method = traffic["method"]
        self.batch = int(cell_config["session"]["batch_size"])
        self.sessions: list[SessionLog] = []
        self.errors: list[BaseException] = []
        self.stop = threading.Event()
        self._done = [0] * self.users  # clicks each thread finished
        self._lock = threading.Lock()
        self._threads = []
        self._dataset = SimpleNamespace(get_urls=lambda b: [f"b://{int(i)}" for i in b])

    # -- a user -------------------------------------------------------------
    def _session(self, u: int, j: int):
        from seesaw_tpu_torch.session import Session

        log = SessionLog(u, j)
        with self._lock:
            self.sessions.append(log)
        turn = (u * len(self.lengths)) // self.users + j
        length = min(self.lengths[turn % len(self.lengths)], self.max_clicks)
        draws = inputs.accept_schedule(self.seed, u, j, length, self.batch, self.found_target)
        found = 0
        ranker = None
        for k in range(length):
            t0 = time.perf_counter()
            if k == 0:
                with span("set_text"):
                    s = Session(None, self._dataset, self.served, self.params)
                    s.set_text(QueryEmbedding.text(u, j))
                if self.method == "knn_prop2":
                    ranker = s.loop.state.knn_model
            last = ranker.last_result if ranker is not None else None
            with span("next"):
                shown = np.asarray(s.next(), dtype=np.int64)
            t1 = time.perf_counter()
            click = Click(u, j, k, t0, t1, 0.0, shown,
                          draws[k * self.batch:k * self.batch + len(shown)])
            if self.method == "rocchio_update":
                click.qvec = np.array(s.loop.curr_vec, dtype=np.float32).reshape(-1)
            if ranker is not None and ranker.last_result is not last:
                click.steps = int(ranker.last_result.n_iter)
            with span("label"):
                state = label_state(s, click.accepted, self.user_box)
            with span("update_state"):
                s.update_state(state)
            with span("refine"):
                s.refine()
            click.t_end = time.perf_counter()
            log.clicks.append(click)
            found += int(click.accepted.sum())
            with self._lock:
                self._done[u] += 1
            if self.stop.is_set() or found >= self.found_target:
                break
        if ranker is not None and ranker.last_result is not None:
            log.final_scores = ranker.last_result.scores.clone()

    def _user(self, u: int):
        try:
            j = 0
            while not self.stop.is_set():
                self._session(u, j)
                j += 1
        except BaseException as e:  # noqa: BLE001 - reported by the run, with the others'
            self.errors.append(e)
            self.stop.set()

    # -- the run ------------------------------------------------------------
    def start(self):
        self._threads = [threading.Thread(target=self._user, args=(u,), daemon=True)
                         for u in range(self.users)]
        for t in self._threads:
            t.start()

    def warm(self, clicks: int, seconds: float, timeout: float = 600.0):
        """Wait until every thread has finished `clicks` clicks and
        `seconds` have passed."""
        t0 = time.perf_counter()
        while True:
            if self.errors:
                return
            with self._lock:
                low = min(self._done)
            waited = time.perf_counter() - t0
            if low >= clicks and waited >= seconds:
                return
            if waited > timeout:
                raise TimeoutError("the load did not warm up")
            time.sleep(0.01)

    def finish(self, timeout: float = 120.0):
        """Stop every thread after its click and wait for it."""
        self.stop.set()
        for t in self._threads:
            t.join(timeout)
        alive = [t for t in self._threads if t.is_alive()]
        if alive:
            raise TimeoutError(f"{len(alive)} users did not stop")

    def clicks(self):
        return [c for s in self.sessions for c in s.clicks]
