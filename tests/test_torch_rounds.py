"""The deployment-shaped serving rounds (`seesaw_tpu_torch.utils.rounds`)
and the round profiler, driven on the CPU at a small size: 512 frames x 8
tiles x 32 dims instead of 1.25M x 8 x 512, and a 4096 x 32 graph instead of
10M x 32. The CUDA kernel path of the same rounds runs in `chip_smoke.py`."""
import json

import numpy as np
import pytest
import torch

from seesaw_tpu_torch.utils import profile_round
from seesaw_tpu_torch.utils import rounds as R

N_VECTORS, DIM = 4096, 32


@pytest.mark.parametrize("method,dtype", [
    ("rocchio_update", "bfloat16"), ("log_reg2", "bfloat16"), ("rocchio_update", "int8"),
])
def test_device_index_rounds(method, dtype):
    gen = torch.Generator().manual_seed(0)
    idx = R.device_index(N_VECTORS, DIM, dtype, device="cpu", generator=gen)
    assert idx.vectors is None and idx.device_dtype == dtype
    assert idx._V.shape == (N_VECTORS, DIM) and idx.n_frames == N_VECTORS // R.TILES
    params = R.session_params(method, batch_size=3, shortlist_size=50)
    rng = np.random.default_rng(0)
    next_ms, round_ms, syncs = R.drive_session(idx, params, 4, rng)
    assert len(next_ms) == len(round_ms) == 4
    assert all(0 < n <= r for n, r in zip(next_ms, round_ms))
    if method == "log_reg2":
        assert all(s >= 2 for s in syncs)  # at least one iteration's two reads
    else:
        assert syncs == []


def test_profile_round_on_cpu(tmp_path, capsys):
    out = tmp_path / "tables.txt"
    rc = profile_round.main([
        "--device", "cpu", "--n-vectors", str(N_VECTORS), "--dim", str(DIM),
        "--rounds", "2", "--out", str(out),
    ])
    assert rc == 0
    recs = [json.loads(line.split("] ", 1)[1])
            for line in capsys.readouterr().out.splitlines() if line.startswith("[cpu] ")]
    assert [r["loop"] for r in recs] == ["rocchio_update", "log_reg2", "knn_prop2"]
    for r in recs:
        assert r["rounds"] == 2 and len(r["round_ms"]) == 2
        spans = profile_round.KNN_SPANS if r["loop"] == "knn_prop2" else profile_round.SPANS
        assert set(r["host_span_ms_per_round"]) == set(spans)
        assert "busy_ms_per_round" not in r  # no device events on the CPU
    assert r["iters"] and r["host_reads"] == [1] * len(r["iters"])
    assert "session.next" in out.read_text() and "knnprop.rank" in out.read_text()


def test_window_local_graph():
    """bench.py's generator: 97% of neighbours within +-400 rows, the rest
    uniform; weights in [0.1, 1.0); degree the row sum."""
    gen = torch.Generator().manual_seed(1)
    g = R.window_local_graph(20_000, 32, "cpu", gen)
    assert g.nbr.shape == g.w.shape == (20_000, 32) and g.nbr.dtype == torch.int32
    assert 0 <= int(g.nbr.min()) and int(g.nbr.max()) < 20_000
    rows = torch.arange(20_000)[:, None]
    far = ((g.nbr - rows).abs() > 400).float().mean().item()
    assert 0.02 < far < 0.04  # the uniform 3%, less those that land near
    assert 0.1 <= float(g.w.min()) and float(g.w.max()) < 1.0
    torch.testing.assert_close(g.degree, g.w.sum(dim=1))


@pytest.mark.parametrize("graph", ["window-local", "uniform"])
def test_converging_eps_stops_segment_at_its_work_step(graph):
    """The timed segment's eps (chip_smoke phase 3, compare_spmv_builds): a
    SEGMENT_STEPS-step run from f stops at step SEGMENT_WORK, on either
    graph; the uniform graph has no locality."""
    from seesaw_tpu_torch.ops import spmv

    gen = torch.Generator().manual_seed(2)
    n = 4096
    if graph == "uniform":
        nbr, w, degree = R.uniform_graph(n, 32, "cpu", gen)
        rows = torch.arange(n)[:, None]
        assert ((nbr - rows).abs() > 400).float().mean().item() > 0.7
        assert 0.1 <= float(w.min()) and float(w.max()) < 1.0
        torch.testing.assert_close(degree, w.sum(dim=1))
    else:
        g = R.window_local_graph(n, 32, "cpu", gen)
        nbr, w, degree = g.nbr, g.w, g.degree
    f = torch.rand(n, generator=gen)
    step_args = (nbr, w, degree + 1.0, torch.rand(n, generator=gen),
                 (torch.rand(n, generator=gen) < 0.3).float(), torch.rand(n, generator=gen) < 0.01)
    eps = R.converging_eps(f, step_args)
    state = spmv.new_state("cpu")
    spmv.jacobi_step_plain(f.clone(), torch.empty_like(f), *step_args, state, eps,
                           R.SEGMENT_STEPS)
    assert state[[spmv.ITERS, spmv.DONE]].tolist() == [R.SEGMENT_WORK, 1]


@pytest.mark.parametrize("warm_start", [False, True])
def test_knnprop_rounds(warm_start):
    """rank -> labels -> update at 4096 x 32: every round after the first
    ranks a staged round fused, in one host read, and never repeats an
    image."""
    gen = torch.Generator().manual_seed(0)
    idx = R.device_index(N_VECTORS, DIM, "int8", device="cpu", generator=gen)
    ranker = R.knnprop_ranker(R.window_local_graph(N_VECTORS, 32, "cpu", gen), "cpu",
                              warm_start=warm_start)
    out = R.drive_knnprop_rounds(idx, ranker, 6)
    assert len(out["round_ms"]) == 6
    assert out["propagated"] == [False] + [True] * 5
    assert all(0 < i < 100 for i in out["iters"])
    assert out["host_reads"] == [1] * 5
    assert ranker.last_result.converged


@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
def test_chunked_device_xlx_matches_numpy(dtype, monkeypatch):
    """`SymmetricWeights.xlx` over an index's device rows (`rows_f32`),
    summed in row chunks that do not divide N, against the numpy xlx of the
    same rows at 4096 x 32 (chip_smoke phase 9b checks the same at 200k
    rows on the card). Tolerance: rtol 1e-5 / atol 1e-5 x max|XLX|, f32 sums
    of 131k products in another order."""
    from seesaw_tpu_torch import knn_graph
    from seesaw_tpu_torch.knn_graph import SymmetricWeights

    monkeypatch.setattr(knn_graph, "XLX_CHUNK_ROWS", 1000)
    gen = torch.Generator().manual_seed(3)
    idx = R.device_index(N_VECTORS, DIM, dtype, device="cpu", generator=gen)
    g = R.window_local_graph(N_VECTORS, 32, "cpu", gen)
    got = g.xlx(idx.rows_f32, device="cpu")
    X = idx.rows_f32(torch.arange(N_VECTORS)).numpy()
    want = SymmetricWeights(g.nbr.numpy(), g.w.numpy(), g.degree.numpy()).xlx(X)
    assert got.shape == (DIM, DIM) and got.dtype == torch.float32
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("loss", ["ce_loss", "pairwise_rank_loss"])
def test_multireg_device_rounds(tmp_path, loss):
    """chip_smoke phase 9b at 4096 x 32: the graph cached under the device
    index's path, the XLX matrix from the device rows, then MultiReg
    sessions whose every feedback round fits inside the query."""
    gen = torch.Generator().manual_seed(4)
    idx = R.device_index(N_VECTORS, DIM, "bfloat16", device="cpu", generator=gen,
                         path=str(tmp_path / "index"))
    opts = R.LOOP_OPTIONS["multi_reg"]["matrix_options"]
    xlx, seconds = R.multireg_xlx(idx, R.window_local_graph(N_VECTORS, R.MULTIREG_GRAPH_K,
                                                            "cpu", gen), opts)
    assert xlx.shape == (DIM, DIM) and seconds > 0
    params = R.session_params("multi_reg", batch_size=3, shortlist_size=50,
                              label_loss_type=loss)
    next_ms, round_ms, syncs = R.drive_session(idx, params, 4, np.random.default_rng(0))
    assert len(round_ms) == 4
    assert syncs and all(s >= 2 for s in syncs)  # a deferred fit in the feedback rounds
    assert not (tmp_path / "index").exists()  # the graph came from the cache


def test_profile_round_multi_reg_on_cpu(tmp_path, capsys):
    """`--loops multi_reg`: the graph cached and its XLX made first, then
    traced sessions whose feedback rounds fit inside the query."""
    rc = profile_round.main([
        "--device", "cpu", "--n-vectors", str(N_VECTORS), "--dim", str(DIM),
        "--rounds", "3", "--loops", "multi_reg", "--out", str(tmp_path / "t.txt"),
    ])
    assert rc == 0
    (rec,) = [json.loads(line.split("] ", 1)[1])
              for line in capsys.readouterr().out.splitlines() if line.startswith("[cpu] ")]
    assert rec["loop"] == "multi_reg" and len(rec["round_ms"]) == 3
    assert rec["lbfgs_host_syncs"]
    assert set(rec["host_span_ms_per_round"]) == set(profile_round.SPANS)
