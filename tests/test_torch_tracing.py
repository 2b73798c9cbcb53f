"""The port's spans (`seesaw_tpu_torch.utils.profiling.annotate`) on the
click path: off, nothing is recorded and nothing is built; under
`torch.profiler`, a `knn_prop2` click records its layers nested under one
request, with the round's counts, on the profiler's timeline too. CPU,
tiny sizes."""
import sys
import threading
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import profile

from seesaw_tpu_torch.basic_types import Box, IndexSpec, SessionParams
from seesaw_tpu_torch.loops.graph_based import seed_weights
from seesaw_tpu_torch.session import Session
from seesaw_tpu_torch.utils import profiling
from seesaw_tpu_torch.utils import rounds as R

MATRIX = dict(knn_path="", knn_k=8, edist=0.1)
ROUND_CHILDREN = {"index.exclusion", "prop.stage", "prop.dispatch", "host.sync"}


def _index(tmp_path):
    gen = torch.Generator().manual_seed(0)
    idx = R.device_index(2048, 32, "bfloat16", device="cpu", generator=gen,
                         path=str(tmp_path))
    seed_weights(idx, MATRIX, R.window_local_graph(idx.meta.n_vectors, 8, "cpu", gen))
    return idx


def _session(idx):
    params = SessionParams(
        index_spec=IndexSpec(d_name="tracing", i_name="tiny"), interactive="knn_prop2",
        batch_size=3, shortlist_size=40,
        interactive_options=dict(matrix_options=MATRIX, **R.KNNPROP_OPTIONS))
    dataset = SimpleNamespace(get_urls=lambda b: [f"b://{int(i)}" for i in b])
    return Session(None, dataset, idx, params)


def _feedback(s):
    """Accept the first image shown, reject the others."""
    state = s.get_state()
    for k, im in enumerate(state.gdata[-1]):
        im.boxes = [Box(x1=0.0, y1=0.0, x2=8.0, y2=8.0, marked_accepted=True)] if k == 0 else []
    s.update_state(state)
    s.refine()


def _by_request(records):
    out = {}
    for r in records:
        out.setdefault(r.request, []).append(r)
    return out


@pytest.fixture(scope="module")
def click(tmp_path_factory):
    """Round 0 and one propagating click of a tiny session, traced. The
    segment is cut to 2 steps, so the round resumes."""
    s = _session(_index(tmp_path_factory.mktemp("tracing")))
    ranker = s.loop.state.knn_model
    ranker.lp.dispatch_iters = 2
    t0 = time.perf_counter_ns()
    with profile() as prof:
        s.set_text("a tiny query")
        s.next()
        _feedback(s)
        s.next()
        _feedback(s)
    names = {e.name for e in prof.events() if e.is_user_annotation}
    return SimpleNamespace(records=profiling.spans(t0), result=ranker.last_result,
                           profiler_names=names)


def test_off_records_nothing_and_builds_nothing(monkeypatch):
    """With no trace running, `annotate` hands back one shared no-op that
    touches neither the clock nor the profiler, and a profiler started
    later sees none of the spans opened before it."""
    t0 = time.perf_counter_ns()

    def built(*args, **kwargs):
        raise AssertionError("a RecordFunction was built")

    monkeypatch.setattr(profiling, "time", None)  # a clock read raises
    monkeypatch.setattr(torch.profiler, "record_function", built)
    with profiling.annotate("off.outer", n=1) as sp:
        sp.set(k=2)
        sp.set_elapsed_us("wait_us")
        with profiling.host_sync("off.inner") as inner:
            assert inner is sp
    monkeypatch.undo()
    assert profiling.spans(t0) == []
    with profiling.annotate("off.before"):
        with profile() as prof:
            torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "off.before" not in names and "off.outer" not in names
    assert [r for r in profiling.spans(t0) if r.name.startswith("off.")] == []


def test_click_spans_nest_under_one_request(click):
    """`session.next` > `index.rank` > `prop.round` > {exclusion, stage,
    dispatch, host.sync}, all under the root's request id, each interval
    inside its parent's."""
    nexts = [r for r in click.records if r.name == "session.next"]
    assert len(nexts) == 2 and all(r.parent is None and r.request == r.id for r in nexts)
    root = nexts[1]
    tree = _by_request(click.records)[root.id]
    by_id = {r.id: r for r in tree}
    (rank,) = [r for r in tree if r.name == "index.rank"]
    (prop_round,) = [r for r in tree if r.name == "prop.round"]
    assert rank.parent == root.id and prop_round.parent == rank.id
    children = {r.name for r in tree if r.parent == prop_round.id}
    assert ROUND_CHILDREN | {"prop.resume"} <= children
    for r in tree:
        if r.parent is not None:
            p = by_id[r.parent]
            assert p.t0 <= r.t0 <= r.t1 <= p.t1 and p.thread == r.thread
    # round 0 ranks the prior: nothing is staged
    assert {r.name for r in _by_request(click.records)[nexts[0].id]} == {
        "session.next", "index.rank", "index.exclusion", "host.sync"}


def test_round_counts_are_the_rankers(click):
    """The round's `steps` and `converged` are its PropagationResult's; its
    segments are the fused one and the resumed ones (one host read each);
    the profiler holds the same names as user annotations."""
    (prop_round,) = [r for r in click.records if r.name == "prop.round"]
    res = click.result
    assert prop_round.attrs["steps"] == res.n_iter > 2
    assert prop_round.attrs["converged"] == res.converged
    assert prop_round.attrs["segments"] == res.host_reads - 1
    (stage,) = [r for r in click.records if r.name == "prop.stage"]
    assert stage.attrs["clicks"] == 3 * R.TILES  # every tile of the 3 images shown
    (excl,) = [r for r in click.records
               if r.name == "index.exclusion" and r.parent == prop_round.id]
    assert excl.attrs["rebuilt"] in (0, 1) and excl.attrs["lock_wait_us"] >= 0
    assert {r.name for r in click.records} <= click.profiler_names


def _sites(records, uploads: bool):
    return sorted(r.attrs["site"] for r in records if r.name == "host.sync"
                  and r.attrs["site"].startswith("upload.") == uploads)


def test_host_syncs_are_the_clicks_reads(click):
    """A propagating click's reads (`host.sync` spans but the uploads) are
    its PropagationResult's host reads: the packed result, each resumed
    segment, the re-ranked result; it uploads its clicks and exclusions.
    Round 0 reads the prior's gap and its result, and uploads its query."""
    reqs = _by_request(click.records)
    roots = [r for r in click.records if r.parent is None]
    first, second = [r for r in roots if r.name == "session.next"]
    (text,) = [r for r in roots if r.name == "session.set_text"]
    clicks = [r for root in roots if root.t0 >= second.t0 for r in reqs[root.id]]
    assert _sites(clicks, False) == sorted(
        ["format_result"] * 2 + ["propagate"] * (click.result.host_reads - 2))
    uploads = _sites(clicks, True)
    assert uploads.count("upload.clicks") == 2 and uploads.count("upload.labeled") == 1
    assert "upload.exclusion" in uploads
    round0 = reqs[text.id] + reqs[first.id]
    assert _sites(round0, False) == ["format_result", "normalize_scores"]
    assert "upload.query" in _sites(round0, True)


def test_threads_keep_their_own_requests(tmp_path):
    """Two users' sessions in two threads: every span's parent and request
    are of its own thread, and each thread's clicks are roots of their own."""
    idx = _index(tmp_path)
    sessions = [_session(idx) for _ in range(2)]
    for s in sessions:
        s.set_text("a tiny query")
        s.next()
        _feedback(s)
    go = threading.Barrier(2)

    def user(s):
        go.wait(timeout=30)
        for _ in range(2):
            s.next()
            _feedback(s)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    t0 = time.perf_counter_ns()
    try:
        with profile():
            threads = [threading.Thread(target=user, args=(s,)) for s in sessions]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    records = profiling.spans(t0)
    by_id = {r.id: r for r in records}
    assert len({r.thread for r in records}) == 2
    for r in records:
        root = by_id[r.request]
        assert root.thread == r.thread and root.parent is None
        if r.parent is not None:
            assert by_id[r.parent].thread == r.thread
            assert by_id[r.parent].request == r.request
    for thread in {r.thread for r in records}:
        assert sum(r.name == "session.next" for r in records if r.thread == thread) == 2


def test_kernel_launch_is_an_operator_too():
    """A launch's span is a user annotation and an operator of the trace
    (the kind the profiler ties a launched kernel to)."""
    with profile() as prof:
        with profiling.kernel_launch("ops.tracing_test", steps=2):
            torch.ones(2).sum()
    kinds = sorted(e.is_user_annotation() for e in prof.profiler.kineto_results.events()
                   if e.name() == "ops.tracing_test")
    assert kinds == [False, True]


def test_buffer_keeps_the_newest_and_counts_the_dropped():
    buf = profiling.SpanBuffer(capacity=4)
    for i in range(6):
        buf.append(profiling.SpanRecord(f"s{i}", i, None, i, 0, 10 * i, 10 * i + 5,
                                        0, 0, {}))
    assert [r.name for r in buf.between()] == ["s2", "s3", "s4", "s5"]
    assert buf.dropped == 2
    assert [r.name for r in buf.between(30, 45)] == ["s3", "s4"]
