"""HTTP server exposing the session API.

Counterpart of `seesaw_tpu/web/app.py`: the same endpoint set, JSON
schemas, cookie-based session routing and static-file containment, on the
stdlib threaded HTTP server, with every session's index (and `/explore`'s
map) on the server's explicit `device`. Each request runs on a thread of
its own; a session's requests are serialized by WebSession's lock. Dataset
image files are served directly, so the frontend needs nothing else.
"""
from __future__ import annotations

import json
import mimetypes
import os
import threading
import traceback
import urllib.parse
from http import HTTPStatus
from http.cookies import SimpleCookie
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..basic_types import SessionParams, SessionState
from ..configs import get_session_params_from_yaml
from .common import (
    AppState,
    ResetReq,
    SessionInfoReq,
    SessionReq,
    g_queries,
    session_params,
)
from .session_manager import SessionManager


def get_image_reference_data(dataset, *, annotation_category, idxbatch):
    """Imdata rows prefilled with a category's ground-truth boxes — the
    re-annotation seed (reference `seesaw_app.py:175-198`)."""
    from ..labeldb import LabelDB

    bd = dataset.load_ground_truth_boxes(annotation_category)

    if idxbatch is None or len(idxbatch) == 0:
        idxbatch = np.unique(bd.dbidx).tolist()

    label_db = LabelDB()
    label_db.fill(bd)
    urls = dataset.get_urls(idxbatch)
    from ..basic_types import Imdata

    return [
        Imdata(url=url, dbidx=int(dbidx),
               boxes=label_db.get(int(dbidx), format="box"),
               activations=None, timing=[])
        for url, dbidx in zip(urls, idxbatch)
    ]


class SeesawServer:
    def __init__(self, root_dir: str, save_path: str, *, device,
                 config_path: Optional[str] = None,
                 serve_files_root: Optional[str] = None):
        self.device = torch.device(device)
        self.manager = SessionManager(root_dir, save_path, device=self.device)
        self.root_dir = root_dir
        self.config_path = config_path
        # static file serving is CONTAINED to these roots — never '/': the
        # data root plus each dataset's image dir (create_dataset symlinks
        # images/ to the user's source directory, so the resolved image
        # root usually lies OUTSIDE the data root). An explicit
        # serve_files_root overrides the list entirely.
        self._serve_root_override = (
            os.path.realpath(serve_files_root) if serve_files_root else None
        )
        self._serve_roots_cache: list = []
        # /explore state: the fitted Visualizer is mutated per request (query
        # overlay), so all of _explore runs under a lock; the cache is bounded
        # since each entry holds a full frame-vector copy
        self._explore_cache: dict = {}
        self._explore_cache_max = 4
        self._explore_lock = threading.Lock()
        self.log_requests = bool(os.environ.get("SEESAW_WEB_LOG"))

    @property
    def serve_files_root(self) -> str:
        """The primary serve root (override or data root)."""
        return self._serve_root_override or os.path.realpath(self.root_dir)

    def serve_roots(self, refresh: bool = False) -> list:
        if self._serve_root_override:
            return [self._serve_root_override]
        if refresh or not self._serve_roots_cache:
            roots = [os.path.realpath(self.root_dir)]
            data = Path(self.root_dir) / "data"
            if data.is_dir():
                for d in data.iterdir():
                    img = d / "images"
                    if img.is_dir():
                        roots.append(os.path.realpath(str(img)))
            self._serve_roots_cache = roots
        return self._serve_roots_cache

    # ------------------------------------------------------------------ #
    def handle(self, method: str, path: str, query: dict, body: Optional[dict],
               cookies: dict) -> tuple:
        """Returns (status, payload_dict, set_cookie or None)."""
        session_id = cookies.get("session_id")

        def need_handle():
            if session_id is None:
                return None, (404, {"detail": "this API requires a session_id"})
            h = self.manager.get_session(session_id)
            if h is None:
                return None, (404, {"detail": f"unknown session_id={session_id}"})
            return h, None

        if path == "/ping" or path == "/test":
            if path == "/test" and session_id:
                h, err = need_handle()
                if err:
                    return (*err, None)
                return 200, h.call("test"), None
            return 200, True, None

        if path == "/user_session":
            mode = query["mode"]
            dataset = query["dataset"]
            index = query["index"]
            annotation_category = query.get("annotation_category")
            new_cookie = None
            if session_id is None or not self.manager.session_exists(session_id):
                session_id = self.manager.new_session()
                new_cookie = session_id
            h = self.manager.get_session(session_id)
            if new_cookie is not None:
                if mode.startswith("yaml_"):
                    assert self.config_path, "server started without a yaml config"
                    params = get_session_params_from_yaml(
                        mode[len("yaml_"):], dataset, index, annotation_category,
                        config_path=self.config_path,
                    )
                else:
                    params = session_params(mode, dataset, index)
                h.call("_reset_dataset", params)
            return 200, h.call("getstate").model_dump(), new_cookie

        if path == "/session":
            mode = query["mode"]
            new_cookie = None
            if session_id is None or not self.manager.session_exists(session_id):
                session_id = self.manager.new_worker(mode)
                new_cookie = session_id
            h = self.manager.get_session(session_id)
            return 200, h.call("getstate").model_dump(), new_cookie

        if path == "/explore":
            # embedding-map explorer for a dataset index (embedding_plot.py):
            # frame-pooled vectors -> PCA + k-means -> standalone HTML
            return self._explore(query)

        if path == "/annotate":
            # re-annotation entry (reference seesaw_app.py:204-243): a dummy
            # frontend-compatible session prefilled with a category's ground
            # truth, to be edited and saved via /session_end
            dataset = query["dataset"]
            category = query["category"]
            pathfile = query["pathfile"].rstrip("/")
            save_file = Path(pathfile) / "summary.json"
            if save_file.exists():
                return 400, {"detail": f"{save_file} already exists"}, None

            from ..dataset import GlobalDataManager

            gdm = GlobalDataManager(self.root_dir)
            ds = gdm.get_dataset(dataset)

            idxs = []
            yamlfile = Path(pathfile) / "paths.yaml"
            if yamlfile.exists():
                import yaml

                paths = yaml.safe_load(yamlfile.read_text())
                path2dbidx = {p: i for i, p in enumerate(ds.paths)}
                for p in paths:
                    if p not in path2dbidx:
                        return 400, {"detail": f"unknown path {p}"}, None
                    idxs.append(path2dbidx[p])

            from ..basic_types import IndexSpec

            params = SessionParams(
                annotation_category=category,
                interactive="plain",  # dummy, not used in annotation mode
                batch_size=max(len(idxs), 1),
                index_spec=IndexSpec(d_name=dataset, i_name="multiscale"),
            )
            gdata = get_image_reference_data(
                ds, annotation_category=category, idxbatch=idxs
            )
            session = SessionState(
                params=params, gdata=[gdata], timing=[], reference_categories=[]
            )
            state = AppState(
                indices=None, worker_state=None, session=session,
                default_params=session.params, save_path=pathfile,
            )
            return 200, state.model_dump(), None

        if path == "/session_info":
            req = SessionInfoReq(**(body or {})) if body else SessionInfoReq(path=query["path"])
            summary_path = Path(req.path) / "summary.json"
            all_info = json.loads(summary_path.read_text())
            if "bench_params" in all_info:  # saved benchmark result
                session = all_info["result"]["session"]
            elif "session" in all_info:  # saved web session / AppState
                session = all_info["session"]
            else:
                session = all_info

            annotation_category = query.get("annotation_category")
            save_path = req.path.rstrip("/")
            if annotation_category is not None:
                # reconstruct-from-saved-JSON re-annotation: refill gdata
                # with the category's current ground truth for the same
                # dbidxs (reference seesaw_app.py:246-288)
                import random
                import string

                rid = "".join(random.choice(string.ascii_lowercase) for _ in range(10))
                save_path = f"{save_path}_annot_{rid}"
                session["params"]["annotation_category"] = annotation_category
                from ..dataset import GlobalDataManager

                gdm = GlobalDataManager(self.root_dir)
                ds = gdm.get_dataset(session["params"]["index_spec"]["d_name"])
                idxs = [
                    int(elt["dbidx"]) for r in session["gdata"] for elt in r
                ]
                new_gdata = get_image_reference_data(
                    ds, annotation_category=annotation_category, idxbatch=idxs
                )
                session["gdata"] = [[g.model_dump() for g in new_gdata]]

            state = AppState(
                indices=None, worker_state=None,
                session=session, default_params=session["params"],
                save_path=save_path,
            )
            return 200, state.model_dump(), None

        if path == "/task_description":
            code = query["code"]
            sdesc = g_queries[code]
            return 200, {
                "urls": [], "neg_urls": [], "description": sdesc.model_dump(),
            }, None

        if path == "/session_end":
            if session_id is not None and self.manager.session_exists(session_id):
                h = self.manager.get_session(session_id)
                # the final round's labels ride in the posted AppState —
                # save() folds them in via update_state (the reference saves
                # the posted body too, seesaw_app.py:304-311)
                h.call("save", SessionReq(**body) if body else None)
                self.manager.end_session(session_id)
                return 200, {"token": session_id}, None
            if body:
                # annotation flow: no live session — the edited AppState is
                # posted back and persisted at its save_path (reference
                # seesaw_app.py:326-337)
                state = SessionReq(**body).client_data
                if state.save_path:
                    out = Path(state.save_path)
                    out.mkdir(parents=True, exist_ok=True)
                    (out / "summary.json").write_text(
                        json.dumps(state.model_dump())
                    )
            return 200, {"token": None}, None

        # -- session-scoped forwards --------------------------------------
        h, err = need_handle()
        if err:
            return (*err, None)

        if path == "/getstate":
            return 200, h.call("getstate").model_dump(), None
        if path == "/reset":
            return 200, h.call("reset", ResetReq(**(body or {}))).model_dump(), None
        if path == "/next":
            return 200, h.call("next", SessionReq(**body)).model_dump(), None
        if path == "/text":
            return 200, h.call("text", query["key"]).model_dump(), None
        if path == "/save":
            req = SessionReq(**body) if body else None
            return 200, h.call("save", req).model_dump(), None
        if path == "/next_task":
            req = SessionReq(**body) if body else SessionReq(client_data=AppState())
            return 200, h.call("next_task", req).model_dump(), None
        if path == "/sleep":
            return 200, h.call("sleep"), None

        return 404, {"detail": f"unknown endpoint {path}"}, None

    # ------------------------------------------------------------------ #
    def _explore(self, query: dict) -> tuple:
        with self._explore_lock:
            return self._explore_locked(query)

    def _explore_locked(self, query: dict) -> tuple:
        dataset = query["dataset"]
        index = query.get("index", "multiscale")
        k = int(query.get("clusters", 12))
        qstr = query.get("q")

        # the index's info.json mtime keys the cache so a rebuilt index
        # (ingest.pipeline rewrites the folder transactionally) invalidates
        # the fitted map instead of serving stale dbidxs forever
        info = Path(self.root_dir) / "data" / dataset / "indices" / index / "info.json"
        try:
            stamp = info.stat().st_mtime_ns
        except OSError:
            stamp = 0
        cache_key = (dataset, index, k, stamp)
        html = self._explore_cache.get(cache_key)
        if html is None:
            from ..dataset import GlobalDataManager
            from ..embedding_plot import Visualizer

            gdm = GlobalDataManager(self.root_dir)
            ds = gdm.get_dataset(dataset)
            idx = ds.load_index(index, device=self.device, options={})
            # frame-pooled mean vector per image keeps the map one-point-per-image
            starts = idx.meta.frame_starts
            vectors = idx.vectors_for_rows(np.arange(idx.meta.n_vectors))
            sums = np.add.reduceat(vectors, starts[:-1], axis=0)
            counts = np.diff(starts)[:, None]
            vz = Visualizer(sums / counts, dbidx=idx.meta.frame_dbidx, device=self.device)
            vz.fit_projection()
            vz.assign_clusters(k=min(k, len(vz.vectors)))
            while len(self._explore_cache) >= self._explore_cache_max:
                self._explore_cache.pop(next(iter(self._explore_cache)))
            self._explore_cache[cache_key] = html = (vz, ds)
        vz, ds = html

        vz.queries = []  # per-request overlay; never carry a stale query over
        if qstr:
            idx = ds.load_index(index, device=self.device, options={})
            if getattr(idx, "embedding", None):
                vz.add_query(qstr, idx.string2vec(qstr))

        import tempfile

        with tempfile.NamedTemporaryFile("r", suffix=".html") as f:
            vz.write_html(f.name, urls=ds.get_urls(vz.dbidx),
                          title=f"{dataset}/{index} embedding map")
            page = Path(f.name).read_text()
        return 200, {"__html__": page}, None

    def serve(self, host: str = "127.0.0.1", port: int = 8000) -> ThreadingHTTPServer:
        server = _make_http_server(self, host, port)
        t = threading.Thread(target=server.serve_forever, daemon=True)
        t.start()
        return server


def _make_http_server(app: SeesawServer, host: str, port: int) -> ThreadingHTTPServer:
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):
            pass

        def _send_json(self, status: int, payload, set_cookie: Optional[str]):
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            if set_cookie:
                self.send_header(
                    "Set-Cookie", f"session_id={set_cookie}; Max-Age=7200; Path=/"
                )
            self.end_headers()
            self.wfile.write(data)

        def _cookies(self) -> dict:
            c = SimpleCookie(self.headers.get("Cookie", ""))
            return {k: v.value for k, v in c.items()}

        def _dispatch(self, method):
            parsed = urllib.parse.urlparse(self.path)
            query = {k: v[0] for k, v in urllib.parse.parse_qs(parsed.query).items()}
            body = None
            length = int(self.headers.get("Content-Length") or 0)
            if length:
                raw = self.rfile.read(length)
                try:
                    body = json.loads(raw) if raw else None
                except json.JSONDecodeError:
                    body = None
            cookies = self._cookies()
            try:
                status, payload, cookie = app.handle(
                    method, parsed.path, query, body, cookies
                )
                if app.log_requests:
                    print(f"[web] {method} {self.path} session="
                          f"{cookies.get('session_id')} -> {status}", flush=True)
                if isinstance(payload, dict) and "__html__" in payload:
                    data = payload["__html__"].encode()
                    self.send_response(status)
                    self.send_header("Content-Type", "text/html; charset=utf-8")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                    return
                self._send_json(status, payload, cookie)
            except Exception as e:
                # reference ErrorLoggingRoute convention (seesaw_app.py:34-56):
                # log the url, cookie and request body alongside the traceback
                print(f"[web] EXCEPTION {method} {self.path} session="
                      f"{cookies.get('session_id')} body={body!r}", flush=True)
                traceback.print_exc()
                self._send_json(500, {"detail": repr(e)}, None)

        def do_POST(self):
            self._dispatch("POST")

        def do_GET(self):
            parsed = urllib.parse.urlparse(self.path)
            if parsed.path in ("/ping",):
                return self._send_json(200, True, None)
            if parsed.path in ("/", "/index.html"):
                page = Path(__file__).parent / "static" / "index.html"
                data = page.read_bytes()
                self.send_response(HTTPStatus.OK)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            # static file serving for dataset images: the url path IS the
            # absolute file path (dataset.get_urls), CONTAINED to the serve
            # roots (commonpath, not a string prefix: '<root>/../x' traversal
            # and '<root>X' siblings must both fail)
            fpath = os.path.normpath(os.path.join("/", parsed.path))

            def contained_in(roots):
                for root in roots:
                    try:
                        if os.path.commonpath([fpath, root]) == root:
                            return True
                    except ValueError:
                        pass
                return False

            contained = contained_in(app.serve_roots()) or contained_in(
                app.serve_roots(refresh=True)  # datasets created after boot
            )
            if contained and os.path.isfile(fpath):
                ctype = mimetypes.guess_type(fpath)[0] or "application/octet-stream"
                with open(fpath, "rb") as f:
                    data = f.read()
                self.send_response(HTTPStatus.OK)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            else:
                self._dispatch("GET")

    return ThreadingHTTPServer((host, port), Handler)
