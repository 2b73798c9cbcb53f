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
