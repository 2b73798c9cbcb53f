"""The rate, percentile, spread and roofline arithmetic, over all requests
and the whole window."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from loadbench.harness import reference, roofline, stats, trace, work
from loadbench.harness.load import Click
from loadbench.harness.runner import RunView, read_metric


@pytest.mark.parametrize("p", [0, 5, 50, 95, 99, 100])
def test_percentile_is_numpys(p):
    xs = np.random.default_rng(p).exponential(size=257)
    assert stats.percentile(xs.tolist(), p) == pytest.approx(np.percentile(xs, p))


def test_percentile_of_nothing():
    assert stats.percentile([], 50) is None


def _click(t_start, t_next, t_end, steps=None, k=1):
    return Click(0, 0, k, t_start, t_next, t_end, np.arange(3), np.zeros(3, bool), steps=steps)


def _view(clicks, counters=None, method="plain", n=8000, dim=64, summary=None, graph=None):
    inputs = SimpleNamespace(V=torch.zeros(n, dim, dtype=torch.bfloat16), row_scale=None,
                             n=n, dim=dim, index_bytes=lambda: n * dim * 2)
    cell = SimpleNamespace(method=method)
    return RunView(cell=cell, setup_s=12.5, t_open=10.0, t_close=20.0, clicks=clicks,
                   counters=counters or {}, inputs=inputs, graph_raw=graph, trace=summary)


def test_slices_count_each_time_once():
    times = [0.0, 4.9, 5.0, 9.99, 10.0, 11.0, 12.0, -1.0, 12.5]
    assert stats.slices(times, 0.0, 12.0, 5.0) == [2, 2, 3]
    assert stats.slices([], 0.0, 1.0, 5.0) == [0]


def test_window_counts_what_completed_inside_it():
    clicks = [_click(9.0, 9.5, 9.9), _click(9.8, 10.1, 10.2), _click(15, 15.2, 15.4),
              _click(19.9, 19.95, 20.1)]
    v = _view(clicks)
    assert read_metric("clicks_per_s", v) == pytest.approx(2 / 10.0)
    nexts = [c.next_ms for c in clicks[1:]]  # the nexts that ended in the window
    assert read_metric("next_p50_ms", v) == pytest.approx(np.percentile(nexts, 50))
    assert read_metric("session.next_p95_ms", v) == pytest.approx(np.percentile(nexts, 95))
    assert read_metric("setup_s", v) == 12.5


def test_counters_over_the_window():
    v = _view([_click(11, 11.1, 11.2, steps=4), _click(12, 12.1, 12.2, steps=6),
               _click(9, 9.1, 9.2, steps=100)],
              counters={"coalesce.batched": (10, 40), "coalesce.solo": (2, 12),
                        "coalesce.dispatches": (5, 15)})
    assert read_metric("coalesce.queries_per_dispatch", v) == pytest.approx((30 + 10) / (10 + 10))
    assert read_metric("prop.steps_per_click", v) == pytest.approx(5.0)


def test_least_seconds_and_click_mfu():
    n, dim = 8000, 64
    ib = n * dim * 2
    v = _view([], counters={"k1_launches": (0, 7), "coalesce.dispatches": (0, 3),
                            "coalesce.batched": (0, 20)}, n=n, dim=dim)
    solo = 7 * ib / roofline.PEAK_BYTES_PER_S
    batch = (3 * ib + 4 * n * 20) / roofline.PEAK_BYTES_PER_S
    assert work.window_least_seconds(v) == pytest.approx(solo + batch)
    assert read_metric("click_mfu", v) == pytest.approx(100 * (solo + batch) / 10.0)


def test_roofline_bound_picks_the_larger():
    assert roofline.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert roofline.least_seconds(0, 989e12, "bfloat16") == pytest.approx(1.0)
    assert roofline.share(1.0, 4.0) == pytest.approx(25.0)
    assert roofline.share(1.0, 0.0) is None


def test_scan_roofline_from_kernels():
    n, dim = 8000, 64
    ib = n * dim * 2
    K = trace.Kernel
    summary = trace.TraceSummary(window_s=10.0, busy_s=1.0, kernels=[
        K("frame_max_kernel<1>", 2 * ib / roofline.PEAK_BYTES_PER_S, None),
        K("elementwise", 1.0, "aten::add"),
    ])
    v = _view([], n=n, dim=dim, summary=summary)
    assert read_metric("scan_roofline", v) == pytest.approx(50.0)
    assert read_metric("device.idle_share", v) == pytest.approx(90.0)
    batch = (2 * ib + 4 * n * 5) / roofline.PEAK_BYTES_PER_S  # 2 batches of 5 queries
    summary.kernels.append(K("cutlass_gemm_bf16", 2 * batch, "aten::mm"))
    v = _view([], n=n, dim=dim, summary=summary,
              counters={"coalesce.dispatches": (3, 5), "coalesce.batched": (10, 15)})
    assert read_metric("scan_roofline", v) == pytest.approx(50.0)


def test_jacobi_roofline_and_edges():
    dst = torch.tensor([[1, 2], [0, 2], [0, 0], [2, 2]], dtype=torch.int32)
    dist = torch.zeros(4, 2)
    # pairs {0,1}, {0,2}, {1,2}, {2,3}: 4 undirected edges, stored both ways
    assert work.stored_edges((dst, dist)) == 8
    g = reference.Graph(dst, dist + 0.1, 0.1)
    assert g.edges == 8
    step = roofline.jacobi_step_bytes(4, 8) / roofline.PEAK_BYTES_PER_S
    summary = trace.TraceSummary(window_s=10.0, busy_s=1.0, kernels=[
        trace.Kernel("jacobi_kernel<2>", 10 * step, None)])
    v = _view([_click(11, 11.1, 11.2, steps=3), _click(12, 12.1, 12.2, steps=2)],
              method="knn_prop2", n=4, dim=8, summary=summary, graph=(dst, dist))
    assert read_metric("jacobi_roofline", v) == pytest.approx(50.0)


def test_idle_gaps_by_host_span():
    spans = [("loadbench.next", 0, 50), ("loadbench.refine", 60, 100)]
    assert trace._open_span_at([10, 55, 70], spans) == ["loadbench.next", "host idle",
                                                        "loadbench.refine"]
    assert trace._union([(5, 7), (0, 2), (1, 3)]) == [[0, 3], [5, 7]]


@pytest.mark.parametrize("clicks", [9, 17, 24, 34])
def test_every_seed_gets_the_same_work(clicks):
    """A session of `clicks` clicks finds its 22nd result in its last click,
    whatever the seed; the seed only moves which images are accepted."""
    from loadbench.harness import inputs

    rows = [inputs.accept_schedule(seed, 3, 5, clicks, 3, 22)
            for seed in (0, 1, 2**31 + 5, 2**62 + 9)]
    for a in rows:
        found = np.cumsum(a.reshape(clicks, 3).sum(axis=1))
        assert found[-1] == 22 and (clicks == 1 or found[-2] < 22)
    assert len({a.tobytes() for a in rows}) == len(rows)


def test_short_kernel_names():
    assert trace.short_name("void (anonymous namespace)::frame_max_kernel<1>(unsigned char "
                            "const*, int const*)") == "(anonymous namespace)::frame_max_kernel<1>"
    assert trace.short_name("Memcpy DtoD (Device -> Device)") == "Memcpy DtoD "


KNN_CONFIG = "seesaw10m-int8-knn5"


@pytest.mark.parametrize("change", [{}, {"local_share": 0.0}, {"window": 8, "local_share": 1.0},
                                    {"built_k": 5}, {"weight_min": 0.5}],
                         ids=["as-configured", "uniform", "narrow", "no-restriction", "heavier"])
def test_graph_pattern_follows_the_config(change, monkeypatch):
    """The graph's pattern comes from the configuration's `graph` alone: its
    locality, the draws a row keeps its nearest of, and their weights."""
    from loadbench.harness import inputs
    from loadbench.harness.cell import BENCH_DIR, load_json

    cfg = load_json(BENCH_DIR / "configs" / f"{KNN_CONFIG}.json")
    g = dict(cfg["graph"], **change)
    k = int(cfg["methods"]["knn_prop2"]["matrix_options"]["knn_k"])
    n = 100_000
    monkeypatch.setattr(inputs, "GRAPH_BLOCK_ROWS", 30_000)
    dst, dist = inputs.knn_graph(n, g, k, 2**33 + 1, "cpu")
    rows = torch.arange(n)[:, None]
    assert dst.shape == dist.shape == (n, k) and dst.dtype == torch.int32
    assert bool((dst != rows).all())
    # distinct neighbours, nearest first; a row repeats one only where its
    # draws hold fewer than k distinct ones (built_k = k), after them
    srt = torch.sort(dst, dim=1).values
    distinct = (srt[:, 1:] != srt[:, :-1]).all(dim=1)
    assert distinct.double().mean().item() >= (1.0 if g["built_k"] > 2 * k else 0.98)
    assert bool((dist[distinct, 1:] >= dist[distinct, :-1]).all())
    gap = (dst.long() - rows).abs()
    near = (torch.minimum(gap, n - gap) <= g["window"]).double().mean().item()
    # the far draws land in the window by chance, ~ 2 * window / n
    assert near == pytest.approx(g["local_share"] + 2 * g["window"] / n, abs=0.01)
    w = torch.exp(-dist.double() / g["weight_edist"])
    assert float(w.min()) >= g["weight_min"] - 1e-6 and float(w.max()) < 1.0
    if 2 * g["window"] > 10 * g["built_k"]:  # draws that seldom repeat
        # the k nearest of built_k uniform weights: the mean of the top k
        # order statistics of built_k draws from [weight_min, 1)
        top = 1 - (np.arange(1, k + 1) / (g["built_k"] + 1)).mean()
        want = g["weight_min"] + (1 - g["weight_min"]) * top
        assert float(w.mean()) == pytest.approx(want, abs=0.01)
    again, _ = inputs.knn_graph(n, g, k, 2**33 + 1, "cpu")  # the seed fixes it
    assert torch.equal(again, dst)


def test_every_seed_runs_the_same_graph_in_another_order(monkeypatch):
    """Seeds differ only by a cyclic shift of the graph's row ids, so every
    seed gives the program the same degrees (and padded width) to work on."""
    from loadbench.harness import inputs
    from loadbench.harness.cell import BENCH_DIR, load_json

    cfg = load_json(BENCH_DIR / "configs" / f"{KNN_CONFIG}.json")
    k = int(cfg["methods"]["knn_prop2"]["matrix_options"]["knn_k"])
    n = 50_000
    monkeypatch.setattr(inputs, "GRAPH_BLOCK_ROWS", 20_000)
    seeds = (2**33 + 1, 4_400_007_919, 7)
    shifts = [inputs.graph_shift(s, n) for s in seeds]
    assert len(set(shifts)) == len(seeds)
    made = [inputs.knn_graph(n, cfg["graph"], k, s, "cpu") for s in seeds]
    assert not torch.equal(made[0][0], made[1][0])
    back = [(torch.roll((d.long() - s) % n, -s, dims=0), torch.roll(w, -s, dims=0))
            for (d, w), s in zip(made, shifts)]
    for d, w in back[1:]:
        assert torch.equal(d, back[0][0]) and torch.equal(w, back[0][1])
    other = dict(cfg["graph"], draw=cfg["graph"]["draw"] + 1)
    assert not torch.equal(inputs.knn_graph(n, other, k, seeds[0], "cpu")[0], made[0][0])
