"""The port's `multi_reg` against the float64 plain reference
(`tests/plain_multi_reg.py`), on the CPU, on seeded data at a small size:
D = 32, 4,000 tiles in 500 frames of 8, a k = 8 window-local kNN graph.

The tiles are made so that every term of the objective moves the fit: 8
coordinates vary slowly along the rows (the graph's neighbours are near
rows, so the Laplacian term barely charges them) and 24 are independent
noise of standard deviation 2 (charged about 4 a unit), rounded to bf16 as
the index stores them.

Held: X'LX from the padded table (host and chunked row-function paths)
against the reference's sum over pairs; the objective and its gradient at
fixed points; `RegFit`'s fitted vector against the reference's minimiser
(`FIT_GAP`); a whole `Session` of `multi_reg` against the reference's
frames, click by click; each term of the objective dropped in turn, and
the fit skipped, fails `FIT_GAP`; the fit's spans; XLX built once a
process under concurrent sessions.
"""
from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import plain_multi_reg as P
from loadbench.harness.reference import Ranker
from seesaw_tpu_torch import configs, knn_graph
from seesaw_tpu_torch.basic_types import Box, IndexSpec, SessionParams
from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex
from seesaw_tpu_torch.knn_graph import KNNGraph, rbf_kernel, symmetrize_weights
from seesaw_tpu_torch.learners import multi_reg as T
from seesaw_tpu_torch.loops import graph_based
from seesaw_tpu_torch.ops.lbfgs import LBFGSResult
from seesaw_tpu_torch.session import Session
from seesaw_tpu_torch.utils import profiling
from seesaw_tpu_torch.utils.rounds import TILES, _BOXES, _ZOOM, uniform_meta

N_FRAMES, D, BUILT_K, WINDOW = 500, 32, 10, 40
N = N_FRAMES * TILES
OPTIONS = configs._method_configs["multi_reg"]
KNN_K, EDIST = OPTIONS["matrix_options"]["knn_k"], OPTIONS["matrix_options"]["edist"]
LAMBDAS = {k: OPTIONS[k] for k in ("reg_data_lambda", "reg_norm_lambda", "reg_query_lambda")}
USER_BOX = [0.0, 0.0, 112.0, 112.0]

# 1 - cos(program's w, reference's w). The port's LBFGS runs in f32 and
# stops where its line search can no longer lower f: f of 10-100 has an f32
# floor of about 1e-6-1e-5, and the objective's curvature is at least ~0.5
# in every direction (the query and norm terms), so w may lie |dw| ~ 6e-3
# from the minimiser, 1 - cos ~ |dw|^2 / 2 ~ 2e-5 (1.5e-6 is the most seen
# on these data); a term dropped moves it by 3.7e-3 or more.
FIT_GAP = 2e-5


def _pair_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """A distance that depends on the unordered pair only, its RBF weight
    at edist 0.1 uniform in [0.1, 1)."""
    lo, hi = np.minimum(a, b).astype(np.uint64), np.maximum(a, b).astype(np.uint64)
    h = (lo * np.uint64(1000003) + hi) * np.uint64(2654435761) % np.uint64(1 << 32)
    return (-EDIST * np.log(h / float(1 << 32) * 0.9 + 0.1)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(20)
    X = rng.normal(size=(N, D)) * 2.0
    X[:, :8] = np.cumsum(rng.normal(size=(N, 8)) * 0.1, axis=0)
    X[:, :8] /= X[:, :8].std(axis=0)
    X = torch.tensor(X, dtype=torch.float32).to(torch.bfloat16)
    # forward lists: BUILT_K distinct neighbours a row, 97% within +-WINDOW
    # rows, nearest first
    off = rng.integers(1, WINDOW + 1, size=(N, 3 * BUILT_K)) * rng.choice([-1, 1], (N, 3 * BUILT_K))
    cand = np.clip(np.arange(N)[:, None] + off, 0, N - 1)
    far = rng.random(cand.shape) >= 0.97
    cand[far] = rng.integers(0, N, size=int(far.sum()))
    dst = np.zeros((N, BUILT_K), np.int32)
    dist = np.zeros((N, BUILT_K), np.float32)
    for i in range(N):
        c = np.array([j for j in dict.fromkeys(cand[i].tolist()) if j != i][:BUILT_K])
        d = _pair_distance(np.full(c.size, i), c)
        order = np.argsort(d, kind="stable")
        dst[i], dist[i] = c[order], d[order]
    q = rng.normal(size=D)
    A = P.laplacian_form(lambda ids: X[ids].to(P.F64), N, torch.from_numpy(dst[:, :KNN_K]),
                         torch.from_numpy(dist[:, :KNN_K]), EDIST)
    return SimpleNamespace(X=X, dst=dst, dist=dist, q=torch.tensor(q / np.linalg.norm(q)), A=A)


def _labels(data, n_frames: int, seed: int):
    rng = np.random.default_rng(seed)
    frames = rng.choice(N_FRAMES, n_frames, replace=False)
    rows, y, sw = P.labelled_rows(frames, rng.random(n_frames) < 0.3, _BOXES, USER_BOX)
    return data.X[torch.from_numpy(rows)].float(), y, sw


def _regfit(data) -> T.RegFit:
    return T.RegFit(device="cpu", xlx=data.A.float(), qvec=data.q.numpy().astype(np.float32),
                    label_loss_type="ce_loss", **LAMBDAS)


@pytest.mark.parametrize("path", ["host", "rows"])
def test_xlx_matches_reference(data, path, monkeypatch):
    weights = symmetrize_weights(KNNGraph(data.dst, data.dist).restrict_k(k=KNN_K),
                                 rbf_kernel(EDIST))
    if path == "host":
        got = weights.xlx(data.X.float().numpy())
    else:  # the device path's row chunks, a ragged last one among them
        monkeypatch.setattr(knn_graph, "XLX_CHUNK_ROWS", 768)
        X = data.X.float()
        got = weights.xlx(lambda ids: X[ids], device="cpu").numpy()
    ref = data.A.numpy()
    assert np.abs(got - ref).max() <= 2e-6 * np.abs(ref).max()


@pytest.mark.parametrize("n_frames", [0, 3, 15])
def test_objective_and_gradient_match(data, n_frames):
    X, y, sw = _labels(data, n_frames, seed=n_frames)
    loss = _regfit(data).objective(X, y.float(), sw.float())
    obj = P.Objective(X, y, sw, data.q, data.A, **LAMBDAS)
    gen = torch.Generator().manual_seed(n_frames)
    for w in (data.q, data.q + 0.3 * torch.randn(D, generator=gen, dtype=P.F64),
              1.7 * torch.randn(D, generator=gen, dtype=P.F64)):
        wf = w.float().requires_grad_(True)
        f = loss(wf)
        (g,) = torch.autograd.grad(f, wf)
        ref_g = obj.gradient(w)
        assert float(f.detach()) == pytest.approx(obj.value(w), rel=2e-6)
        assert float((g.double() - ref_g).abs().max()) <= 2e-6 * float(ref_g.abs().max())


@pytest.mark.parametrize("n_frames", [0, 3, 15, 36])
def test_fit_matches_reference(data, n_frames):
    X, y, sw = _labels(data, n_frames, seed=100 + n_frames)
    w, res = _regfit(data).solve(X, y.float(), sw.float())
    assert not res.diverged
    ref = P.fit(X, y, sw, data.q, data.A, LAMBDAS)
    assert 1 - float(w.double() @ ref) <= FIT_GAP


def _drop(term: str):
    """`multi_reg_loss` with one term taken out."""
    orig = T.multi_reg_loss

    def broken(w, X, y, sw, valid, qh, xlx, margin, pw, ld, ln, lq, **kw):
        X = torch.zeros_like(X) if term == "label" else X
        ld, ln, lq = (0.0 if term == t else v for t, v in
                      (("data", ld), ("norm", ln), ("query", lq)))
        return orig(w, X, y, sw, valid, qh, xlx, margin, pw, ld, ln, lq, **kw)
    return broken


def _no_fit(fun, x0, **kw):
    return LBFGSResult(x=x0, f=fun(x0).detach(), n_iter=0, converged=True, diverged=False,
                       host_syncs=0)


@pytest.mark.parametrize("fault", ["label", "data", "norm", "query", "no_fit"])
def test_broken_fit_fails_the_bound(data, fault, monkeypatch):
    if fault == "no_fit":
        monkeypatch.setattr(T, "lbfgs_minimize", _no_fit)
    else:
        monkeypatch.setattr(T, "multi_reg_loss", _drop(fault))
    X, y, sw = _labels(data, 15, seed=115)
    w, _ = _regfit(data).solve(X, y.float(), sw.float())
    ref = P.fit(X, y, sw, data.q, data.A, LAMBDAS)
    assert 1 - float(w.double() @ ref) > FIT_GAP


def _index(data, tmp_path):
    q = data.q.numpy().astype(np.float32)
    idx = MultiscaleIndex.from_device_arrays(
        embedding=SimpleNamespace(from_string=lambda string=None: q), V=data.X,
        valid=torch.ones(N_FRAMES, TILES, dtype=torch.bool),
        boxes=torch.from_numpy(_BOXES).repeat(N_FRAMES, 1),
        zoom=torch.from_numpy(_ZOOM).repeat(N_FRAMES), meta=uniform_meta(N_FRAMES),
        path=str(tmp_path))
    KNNGraph(data.dst, data.dist).save(idx.get_knng_path(""))
    return idx


def _session(idx) -> Session:
    return Session(None, SimpleNamespace(get_urls=lambda b: [f"b://{int(i)}" for i in b]), idx,
                   _params())


def _params():
    return SessionParams(index_spec=IndexSpec(d_name="plain", i_name="multi_reg"),
                         interactive="multi_reg", batch_size=3, shortlist_size=40,
                         interactive_options=dict(OPTIONS))


def _label(s: Session, accepted):
    state = s.get_state()
    for im, a in zip(state.gdata[-1], accepted):
        im.boxes = [Box(x1=0.0, y1=0.0, x2=112.0, y2=112.0, marked_accepted=True)] if a else []
    return state


def test_session_shows_the_reference_frames(data, tmp_path, monkeypatch):
    """Ten clicks of one session: the label-free fit of round 0 and the
    deferred fits after it, each scan and ranking, against the reference's
    fit of the same labels and its ranking under the same exclusions."""
    monkeypatch.setattr(graph_based, "_wm_cache", {})
    idx = _index(data, tmp_path)
    s = _session(idx)
    s.set_text("a query")
    ranker = Ranker(_BOXES, _ZOOM, shortlist=40, topk=3, device="cpu")
    V = data.X.to(P.F64)
    rng = np.random.default_rng(7)
    frames, accepted = [], []
    for click in range(10):
        shown = [int(x) for x in s.next()]
        rows, y, sw = P.labelled_rows(frames, accepted, _BOXES, USER_BOX)
        w = P.fit(V[torch.from_numpy(rows)], y, sw, data.q, data.A, LAMBDAS)
        excluded = torch.zeros(N_FRAMES, dtype=torch.bool)
        excluded[frames] = True
        want = ranker.rank(V @ w, excluded)[2].tolist()
        assert shown == want, f"click {click}"
        verdict = (rng.random(3) < 0.3).tolist()
        s.update_state(_label(s, verdict))
        s.refine()
        frames += shown
        accepted += verdict


def test_fit_spans_count_each_fit(data, tmp_path, monkeypatch):
    """`fit.multireg`: one span a fit, deferred 0 for round 0's host fit and
    1 for the fits inside the query, with the LBFGS's own counts; one
    `fit.xlx` span for the session's XLX."""
    monkeypatch.setattr(graph_based, "_wm_cache", {})
    idx = _index(data, tmp_path)
    t0 = time.perf_counter_ns()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        s = _session(idx)
        s.set_text("a query")
        fits = []
        for click in range(3):
            s.next()
            if idx.last_fit is not None:
                fits.append(idx.last_fit)
            s.update_state(_label(s, [click == 1, False, True]))
            s.refine()
    records = profiling.spans(t0)
    spans = [r for r in records if r.name == "fit.multireg"]
    assert [r.attrs["deferred"] for r in spans] == [0, 1, 1]
    assert [r.attrs["rows"] for r in spans] == [0, 24, 48]
    assert len(fits) == 2
    for r, fit in zip(spans[1:], fits):
        assert (r.attrs["iters"], r.attrs["host_reads"]) == (fit["n_iter"], fit["host_syncs"])
        assert r.attrs["host_reads"] > r.attrs["iters"] > 0
    xlx = [r for r in records if r.name == "fit.xlx"]
    assert len(xlx) == 1 and xlx[0].attrs == {"rows": N, "slots": xlx[0].attrs["slots"]}
    assert xlx[0].attrs["slots"] >= KNN_K


def test_xlx_built_once_under_concurrent_sessions(data, tmp_path, monkeypatch):
    """Four sessions that start together build the index's XLX once; the
    others wait for it and take the same matrix."""
    monkeypatch.setattr(graph_based, "_wm_cache", {})
    idx = _index(data, tmp_path)
    built, orig = [], knn_graph.SymmetricWeights.xlx

    def counted(self, *a, **kw):
        built.append(threading.get_ident())
        return orig(self, *a, **kw)
    monkeypatch.setattr(knn_graph.SymmetricWeights, "xlx", counted)
    start = threading.Barrier(4)
    loops = [None] * 4

    def user(i):
        start.wait()
        loops[i] = _session(idx).loop
    threads = [threading.Thread(target=user, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(built) == 1
    assert all(loop.xlx is loops[0].xlx for loop in loops)
