"""Per-user session state and registry.

Counterpart of `seesaw_tpu/web/session_manager.py` over the port's
`make_session`: every session of a manager loads its index onto the
manager's `device`. `WebSession` runs all of a user's operations serially
under a per-session lock; `SessionManager` holds the sessions and reaps
those idle longer than the cookie's lifetime. A server answers requests in
one process, so an index over a mesh that spans processes raises.
"""
from __future__ import annotations

import json
import os
import random
import string
import threading
import time
from typing import Dict, Optional

import torch

from ..basic_types import SessionParams
from ..dataset import GlobalDataManager
from ..parallel.mesh import require_in_process
from ..session import make_session
from .common import (
    AppState,
    ResetReq,
    SaveResp,
    SessionReq,
    Worker,
    g_queries,
    generate_task_list,
)


def generate_id() -> str:
    return "".join(
        random.choice(string.ascii_letters + "0123456789") for _ in range(32)
    )


class WebSession:
    def __init__(self, root_dir: str, save_path: str, session_id: str,
                 worker: Optional[Worker] = None, *, device):
        self.device = torch.device(device)
        self.session_id = session_id
        self.root_dir = root_dir
        self.save_path = save_path
        self.worker = worker
        self.gdm = GlobalDataManager(root_dir)
        self.session = None
        self._lock = threading.Lock()

    # -- serialized entry point -------------------------------------------
    def call(self, method: str, *args, **kwargs):
        with self._lock:
            return getattr(self, method)(*args, **kwargs)

    def _reset_dataset(self, s: SessionParams):
        res = make_session(self.gdm, s, device=self.device)
        require_in_process(getattr(res["session"].index, "mesh", None), "the session server")
        self.session = res["session"]

    def next_task(self, body: SessionReq) -> AppState:
        if self.session:
            self.session._log("next_task")
            self.save(body)
        params = self.worker.next_session()
        self._reset_dataset(params)
        return self.getstate()

    def getstate(self) -> AppState:
        return AppState(
            indices=None,
            default_params=None,
            worker_state=self.worker.get_state() if self.worker else None,
            session=self.session.get_state() if self.session else None,
        )

    def reset(self, r: ResetReq) -> AppState:
        if r.config is not None:
            self._reset_dataset(r.config)
        return self.getstate()

    def next(self, body: SessionReq) -> AppState:
        state = body.client_data.session if body.client_data else None
        if state is not None:
            self.session.update_state(state)
            self.session.refine()
        self.session.next()
        return self.getstate()

    def text(self, key: str) -> AppState:
        self.session.set_text(key=key)
        self.session.next()
        return self.getstate()

    def save(self, body: Optional[SessionReq] = None) -> SaveResp:
        if self.session is None:
            return SaveResp(path="")
        if body and body.client_data and body.client_data.session:
            self.session.update_state(body.client_data.session)
        self.session._log("save")
        if self.session.params.other_params is None:
            self.session.params.other_params = {}
        qkey = self.session.params.other_params.get("qkey", None)
        self.session.params.other_params["session_id"] = self.session_id
        save_time = time.strftime("%Y%m%d-%H%M%S")
        self.session.params.other_params["save_time"] = save_time
        if qkey not in g_queries:
            qkey = "other"
        output_path = (
            f"{self.save_path}/session_{self.session_id}/qkey_{qkey}/saved_{save_time}"
        )
        os.makedirs(output_path, exist_ok=True)
        with open(f"{output_path}/summary.json", "w") as f:
            json.dump(self.getstate().model_dump(), f)
        return SaveResp(path=output_path)

    def sleep(self) -> float:
        start = time.time()
        time.sleep(10)
        return time.time() - start

    def test(self) -> bool:
        return True


class SessionManager:
    # matches the session cookie's Max-Age: a session no client can still
    # address is reaped server-side too (each live Session pins host state
    # plus a device-resident exclusion mask — cookie-less probes hitting
    # /user_session would otherwise grow the map without bound)
    SESSION_TTL_S = 7200.0

    def __init__(self, root_dir: str, save_path: str, *, device):
        self.device = torch.device(device)
        self.root_dir = root_dir
        self.save_path = save_path
        self.sessions: Dict[str, WebSession] = {}
        self._last_access: Dict[str, float] = {}
        self._lock = threading.Lock()

    def ready(self) -> bool:
        return True

    def _reap_expired_locked(self):
        now = time.time()
        dead = [
            sid for sid, t in self._last_access.items()
            if now - t > self.SESSION_TTL_S
        ]
        for sid in dead:
            self.sessions.pop(sid, None)
            self._last_access.pop(sid, None)

    def _new_session(self, task_list) -> str:
        session_id = generate_id()
        worker = Worker(session_id=session_id, task_list=task_list) if task_list else None
        ws = WebSession(self.root_dir, self.save_path, session_id, worker,
                        device=self.device)
        with self._lock:
            self._reap_expired_locked()
            self.sessions[session_id] = ws
            self._last_access[session_id] = time.time()
        return session_id

    def new_worker(self, mode: str) -> str:
        return self._new_session(generate_task_list(mode))

    def new_session(self) -> str:
        return self._new_session([])

    def session_exists(self, session_id: str) -> bool:
        return session_id in self.sessions

    def end_session(self, session_id: str):
        with self._lock:
            self.sessions.pop(session_id, None)
            self._last_access.pop(session_id, None)

    def get_session(self, session_id: str) -> Optional[WebSession]:
        ws = self.sessions.get(session_id)
        if ws is not None:
            self._last_access[session_id] = time.time()
        return ws
