"""The port's session web server (`seesaw_tpu_torch.web`) on the CPU.

The flows of `tests/test_web.py` and `tests/test_protocol_replay.py` (the
Vue frontend's request sequences) against `SeesawServer(device="cpu")` on a
`tests/synth.py` root, and one parity test: the same scripted client
against the JAX package's `SeesawServer` and the port's, on one root, must
get equal dbidxs every round and equal state JSON apart from timing fields
(activation scores within rtol 1e-5: f32 dots of 32 terms summed in
another order).
"""
import copy
import glob
import json
import subprocess
import sys
import threading
import urllib.error
import urllib.parse
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

from synth import CATEGORY, QSTR, build_synthetic_root

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_web_root")
    # named 'bdd' so that the user-study task list (g_queries) resolves
    build_synthetic_root(str(root), dataset_name="bdd")
    save = tmp_path_factory.mktemp("torch_web_save")

    from seesaw_tpu_torch.web.app import SeesawServer

    app = SeesawServer(str(root), str(save), device="cpu")
    httpd = app.serve(port=0)
    yield f"http://127.0.0.1:{httpd.server_address[1]}", app
    httpd.shutdown()


class Client:
    """Issues requests shaped like the Vue app's fetch() calls."""

    def __init__(self, base):
        self.base = base
        self.cookie = None

    def request(self, method, path, body=None, raw_empty=False):
        data = None
        if method == "POST":
            data = b"" if (body is None and raw_empty) else (
                json.dumps(body).encode() if body is not None else b"null"
            )
        req = urllib.request.Request(self.base + path, data=data, method=method,
                                     headers={"Content-Type": "application/json"})
        if self.cookie:
            req.add_header("Cookie", f"session_id={self.cookie}")
        with urllib.request.urlopen(req, timeout=60) as resp:
            sc = resp.headers.get("Set-Cookie")
            if sc and "session_id=" in sc:
                self.cookie = sc.split("session_id=")[1].split(";")[0]
            return json.loads(resp.read())

    def post(self, path, body=None):
        return self.request("POST", path, body, raw_empty=body is None)


def _text(c):
    return c.request("POST", f"/text?key={urllib.parse.quote(QSTR)}", body={})


def _assert_appstate(d):
    for key in ("indices", "worker_state", "default_params", "session"):
        assert key in d, f"AppState missing {key}"


def test_ping(server):
    base, _ = server
    with urllib.request.urlopen(base + "/ping") as r:
        assert json.loads(r.read()) is True


def test_full_session_flow(server):
    base, _ = server
    c = Client(base)
    state = c.post("/user_session?mode=plain&dataset=bdd&index=multiscale")
    assert c.cookie is not None and state["session"] is not None
    sess = _text(c)["session"]
    assert sess["query_string"] == QSTR
    assert len(sess["gdata"]) == 1 and len(sess["gdata"][0]) == 3  # default batch_size
    batch = sess["gdata"][0]
    batch[0]["boxes"] = [dict(x1=0, y1=0, x2=50, y2=50, description=None,
                              marked_accepted=True)]
    for im in batch[1:]:
        im["boxes"] = []
    sess2 = c.post("/next", {"client_data": {"session": sess}})["session"]
    assert len(sess2["gdata"]) == 2
    assert sess2["gdata"][0][0]["boxes"][0]["marked_accepted"] is True
    seen = [im["dbidx"] for b in sess2["gdata"] for im in b]
    assert len(seen) == len(set(seen))
    resp = c.post("/save", {"client_data": {"session": sess2}})
    assert resp["path"]
    assert c.post("/session_info", {"path": resp["path"]})["session"]["query_string"] == QSTR
    c.post("/session_end")
    with pytest.raises(urllib.error.HTTPError):
        c.post("/getstate")


def test_task_description(server):
    out = Client(server[0]).post("/task_description?code=dg")
    assert out["description"]["qstr"] == "dogs"


def test_getstate_requires_cookie(server):
    with pytest.raises(urllib.error.HTTPError) as ei:
        Client(server[0]).post("/getstate")
    assert ei.value.code == 404


def test_box_feedback_drives_multi_reg(server):
    """A drawn box with a description flows through /next into MultiReg."""
    c = Client(server[0])
    c.post("/user_session?mode=multi_reg&dataset=bdd&index=multiscale")
    sess = _text(c)["session"]
    batch = sess["gdata"][0]
    batch[0]["boxes"] = [dict(x1=10.0, y1=12.0, x2=90.0, y2=80.0,
                              description="a drawn feedback box", marked_accepted=True)]
    for im in batch[1:]:
        im["boxes"] = []
    sess2 = c.post("/next", {"client_data": {"session": sess}})["session"]
    assert len(sess2["gdata"]) == 2
    b = sess2["gdata"][0][0]["boxes"][0]
    assert b["x1"] == 10.0 and b["y2"] == 80.0 and b["description"] == "a drawn feedback box"
    seen = [im["dbidx"] for bt in sess2["gdata"] for im in bt]
    assert len(seen) == len(set(seen)) and len(sess2["gdata"][1]) > 0


def test_explore_endpoint_and_overlay(server):
    """/explore serves the embedding-map page; a query overlay shows once
    and is not carried to the next request."""
    base, _ = server
    with urllib.request.urlopen(base + "/explore?dataset=bdd&clusters=4") as r:
        assert "text/html" in r.headers["Content-Type"]
        page = r.read().decode()
    assert "embedding map" in page and "const D = " in page
    q = urllib.parse.quote(QSTR)
    with urllib.request.urlopen(base + f"/explore?dataset=bdd&clusters=4&q={q}") as r:
        assert QSTR in r.read().decode()
    with urllib.request.urlopen(base + "/explore?dataset=bdd&clusters=4") as r:
        assert QSTR not in r.read().decode()


def test_concurrent_sessions_isolated(server):
    base, _ = server

    def drive(i):
        c = Client(base)
        c.post("/user_session?mode=plain&dataset=bdd&index=multiscale")
        sess = _text(c)["session"]
        for im in sess["gdata"][0]:
            im["boxes"] = []
        state2 = c.post("/next", {"client_data": {"session": sess}})
        return c.cookie, [im["dbidx"] for b in state2["session"]["gdata"] for im in b]

    with ThreadPoolExecutor(4) as ex:
        results = list(ex.map(drive, range(4)))
    assert len({r[0] for r in results}) == 4
    for _, seen in results:
        assert len(seen) == len(set(seen))


def test_concurrent_next_over_shared_coalescing_index(tmp_path):
    """Sessions made from a yaml variant with index_options={coalesce_ms}
    share one CoalescingIndex; simultaneous /next requests coalesce without
    deadlock and each session keeps its no-repeat contract."""
    from seesaw_tpu_torch.web.app import SeesawServer
    from seesaw_tpu_torch.web.coalesce import CoalescingIndex

    root = tmp_path / "root"
    root.mkdir()
    build_synthetic_root(str(root), dataset_name="co")
    cfg = tmp_path / "conf.yaml"
    cfg.write_text(
        "shared_session_params:\n  batch_size: 3\n  shortlist_size: 20\n"
        "variants:\n  - name: co_plain\n    interactive: plain\n"
        "    agg_method: avg_score\n    aug_larger: all\n"
        "    index_options:\n      coalesce_ms: 25\n"
    )
    app = SeesawServer(str(root), str(tmp_path / "save"), device="cpu",
                       config_path=str(cfg))
    httpd = app.serve(port=0)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        clients, states = [], []
        for _ in range(3):
            c = Client(base)
            c.post("/user_session?mode=yaml_co_plain&dataset=co&index=multiscale")
            states.append(_text(c))
            clients.append(c)
        sessions = [app.manager.get_session(c.cookie).session for c in clients]
        assert sessions[0].index is sessions[1].index is sessions[2].index
        assert isinstance(sessions[0].index, CoalescingIndex)
        errors, seen = [], [set() for _ in clients]

        def drive(i):
            try:
                st = states[i]
                for _ in range(3):
                    for im in st["session"]["gdata"][-1]:
                        assert im["dbidx"] not in seen[i]
                        seen[i].add(im["dbidx"])
                        im["boxes"] = []
                    st = clients[i].post("/next", {"client_data": st})
            except Exception as e:  # pragma: no cover
                errors.append(e)

        threads = [threading.Thread(target=drive, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        httpd.shutdown()
    assert not errors, errors
    assert all(len(s) == 9 for s in seen)
    stats = sessions[0].index._coalescer.stats
    assert stats["batched"] + stats["solo"] >= 9, stats


def test_static_serving_contained_to_root(server):
    base, app = server
    from seesaw_tpu_torch.dataset import GlobalDataManager

    ds = GlobalDataManager(app.root_dir).get_dataset("bdd")
    fpath = Path(ds.file_path(int(ds.dbidxs[0])))
    fpath.parent.mkdir(parents=True, exist_ok=True)
    fpath.write_bytes(b"fakejpegbytes")
    url = ds.get_urls([ds.dbidxs[0]])[0]
    with urllib.request.urlopen(base + urllib.parse.quote(url)) as resp:
        assert resp.status == 200 and resp.read() == b"fakejpegbytes"
    for bad in ("/etc/passwd",
                urllib.parse.quote(str(app.serve_files_root)) + "/../../etc/passwd"):
        try:
            with urllib.request.urlopen(base + bad) as resp:
                assert "detail" in json.loads(resp.read()), f"served {bad}!"
        except urllib.error.HTTPError as e:
            assert e.code in (404, 400)


def test_session_end_saves_final_labels(server):
    base, app = server
    c = Client(base)
    c.post("/user_session?mode=plain&dataset=bdd&index=multiscale")
    state = _text(c)
    for im in state["session"]["gdata"][-1]:
        im["boxes"] = [dict(x1=0.0, y1=0.0, x2=50.0, y2=50.0, marked_accepted=True)]
    sid = c.cookie
    assert c.post("/session_end", {"client_data": state})["token"] == sid
    paths = glob.glob(f"{app.manager.save_path}/session_{sid}/**/summary.json", recursive=True)
    assert paths, "no summary written"
    gdata = json.loads(Path(paths[-1]).read_text())["session"]["gdata"]
    assert any(im["boxes"] for batch in gdata for im in batch if im["boxes"])


def test_user_session_flow(server):
    """mounted(/user_session) -> text() -> next() -> reset() -> reset(cfg)."""
    c = Client(server[0])
    state = c.request("POST", "/user_session?mode=plain&dataset=bdd&index=multiscale",
                      raw_empty=True)
    _assert_appstate(state)
    state = _text(c)
    _assert_appstate(state)
    assert state["session"]["query_string"] == QSTR and len(state["session"]["gdata"][0]) > 0
    for im in state["session"]["gdata"][0]:
        im["boxes"] = []
    state2 = c.request("POST", "/next", body={"client_data": state})
    _assert_appstate(state2)
    assert len(state2["session"]["gdata"]) == 2
    _assert_appstate(c.request("POST", "/reset", body={"config": None}))
    state4 = c.request("POST", "/reset", body={"config": dict(state2["session"]["params"])})
    _assert_appstate(state4)
    assert state4["session"]["gdata"] == []


def test_worker_task_flow(server):
    """mounted(/session) -> next_task() -> GET task_description -> end."""
    c = Client(server[0])
    state = c.request("POST", "/session?mode=plain", raw_empty=True)
    _assert_appstate(state)
    ws = state["worker_state"]
    assert ws["current_task_index"] == -1 and ws["task_list"][0]["qkey"] == "pc"
    state2 = c.request("POST", "/next_task", body={"client_data": state})
    _assert_appstate(state2)
    assert state2["worker_state"]["current_task_index"] == 0
    assert state2["session"] is not None
    notif = c.request("GET", f"/task_description?code={ws['task_list'][1]['qkey']}")
    assert notif["description"]["qstr"] == "dogs" and "neg_urls" in notif
    assert "token" in c.request("POST", "/session_end", body={"client_data": state2})


def test_session_end_null_body(server):
    assert Client(server[0]).request("POST", "/session_end", body=None) == {"token": None}


@pytest.mark.parametrize("placement", ["query", "body"])
def test_session_info(server, placement):
    """/session_info with ?path= (mounted) or a JSON body (load_session)."""
    c = Client(server[0])
    c.request("POST", "/user_session?mode=plain&dataset=bdd&index=multiscale", raw_empty=True)
    path = c.request("POST", "/save", body={"client_data": _text(c)})["path"]
    c2 = Client(server[0])
    if placement == "query":
        state = c2.request("POST", "/session_info?" + urllib.parse.urlencode({"path": path}),
                           raw_empty=True)
    else:
        state = c2.request("POST", "/session_info", body={"path": path})
    _assert_appstate(state)
    assert state["session"]["query_string"] == QSTR


def test_annotate_via_query_params(server, tmp_path):
    c = Client(server[0])
    pathfile = tmp_path / "annot"
    pathfile.mkdir()
    state = c.request("POST", "/annotate?" + urllib.parse.urlencode(
        dict(dataset="bdd", category=CATEGORY, pathfile=str(pathfile))), raw_empty=True)
    _assert_appstate(state)
    assert state["save_path"] == str(pathfile)
    assert state["session"]["params"]["annotation_category"] == CATEGORY


def test_annotator_edit_sequences_and_timing(server):
    """Edits to an earlier round's boxes round-trip, flip the accept
    counters, and Imdata.timing persists across rounds and into the save."""
    c = Client(server[0])
    c.request("POST", "/user_session?mode=plain&dataset=bdd&index=multiscale", raw_empty=True)
    state = _text(c)
    first = state["session"]["gdata"][-1][0]
    first["boxes"] = [dict(x1=10.0, y1=10.0, x2=60.0, y2=60.0, description="a dog",
                           marked_accepted=True)]
    first["timing"] = [dict(start_ms=1000, end_ms=2500)]
    for im in state["session"]["gdata"][-1][1:]:
        im["boxes"] = []
    state = c.request("POST", "/next", body={"client_data": state})
    assert state["session"]["action_log"][-1]["accepted"] == 1
    prev = state["session"]["gdata"][0][0]
    assert prev["timing"] == [dict(start_ms=1000, end_ms=2500)]
    prev["boxes"] = [dict(x1=30.0, y1=35.0, x2=95.5, y2=120.25, description="edited dog",
                          marked_accepted=False)]
    prev["timing"] = prev["timing"] + [dict(start_ms=9000, end_ms=9900)]
    for im in state["session"]["gdata"][-1]:
        im["boxes"] = []
    state = c.request("POST", "/next", body={"client_data": state})
    back = state["session"]["gdata"][0][0]
    assert back["boxes"] == [dict(x1=30.0, y1=35.0, x2=95.5, y2=120.25,
                                  description="edited dog", marked_accepted=False)]
    assert len(back["timing"]) == 2
    assert state["session"]["action_log"][-1]["accepted"] == 0
    resp = c.request("POST", "/save", body={"client_data": state})
    saved = json.loads((Path(resp["path"]) / "summary.json").read_text())
    assert saved["session"]["gdata"][0][0]["timing"][0]["start_ms"] == 1000


# -- parity with the JAX package's server ------------------------------------
def _script(base, mode):
    """/user_session, /text, /next x 3 with boxes (accept the first image,
    reject the rest), /getstate, /session_end. Returns (dbidxs per round,
    the /getstate JSON)."""
    c = Client(base)
    c.post(f"/user_session?mode={mode}&dataset=bdd&index=multiscale")
    state = _text(c)
    rounds = []
    for _ in range(3):
        batch = state["session"]["gdata"][-1]
        rounds.append([im["dbidx"] for im in batch])
        for j, im in enumerate(batch):
            im["boxes"] = ([dict(x1=0.0, y1=0.0, x2=112.0, y2=112.0, description=None,
                                 marked_accepted=True)] if j == 0 else [])
        state = c.post("/next", {"client_data": state})
    rounds.append([im["dbidx"] for im in state["session"]["gdata"][-1]])
    final = c.post("/getstate")
    c.post("/session_end")
    return rounds, final


def _split_state(state):
    """State JSON without its timing fields (round times, log times), and
    its activation scores apart."""
    s = copy.deepcopy(state)
    s["session"].pop("timing")
    for e in s["session"]["action_log"]:
        e.pop("time")
    scores = []
    for batch in s["session"]["gdata"]:
        for im in batch:
            for a in im["activations"] or []:
                scores.append(a.pop("score"))
    return s, np.array(scores, np.float64)


@pytest.mark.parametrize("mode", ["plain", "rocchio_update"])
def test_parity_with_the_jax_server(tmp_path, mode):
    from seesaw_tpu.web.app import SeesawServer as JaxServer
    from seesaw_tpu_torch.web.app import SeesawServer as TorchServer

    build_synthetic_root(str(tmp_path / "root"), dataset_name="bdd")
    out = {}
    for name, app in (
        ("jax", JaxServer(str(tmp_path / "root"), str(tmp_path / "save_jax"))),
        ("torch", TorchServer(str(tmp_path / "root"), str(tmp_path / "save_torch"),
                              device="cpu")),
    ):
        httpd = app.serve(port=0)
        try:
            out[name] = _script(f"http://127.0.0.1:{httpd.server_address[1]}", mode)
        finally:
            httpd.shutdown()
    (j_rounds, j_state), (t_rounds, t_state) = out["jax"], out["torch"]
    assert t_rounds == j_rounds
    j, j_scores = _split_state(j_state)
    t, t_scores = _split_state(t_state)
    assert t == j
    np.testing.assert_allclose(t_scores, j_scores, rtol=1e-5)


def test_serve_cli(tmp_path):
    """`python -m seesaw_tpu_torch.web.serve` defaults to cuda and refuses
    to start without a GPU; `--device cpu` serves."""
    import torch

    build_synthetic_root(str(tmp_path / "root"), dataset_name="bdd")
    args = [sys.executable, "-m", "seesaw_tpu_torch.web.serve", "--seesaw_root",
            str(tmp_path / "root"), "--save_path", str(tmp_path / "save"),
            "--host", "127.0.0.1", "--port", "0"]
    if not torch.cuda.is_available():
        out = subprocess.run(args, cwd=REPO, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "--device cpu" in out.stderr
    proc = subprocess.Popen(args + ["--device", "cpu"], cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        assert "listening on 127.0.0.1:" in line, (line, proc.stderr.read())
        port = int(line.rsplit(":", 1)[1])
        c = Client(f"http://127.0.0.1:{port}")
        c.post("/user_session?mode=plain&dataset=bdd&index=multiscale")
        assert len(_text(c)["session"]["gdata"][0]) == 3
    finally:
        proc.terminate()
        proc.wait(timeout=30)
