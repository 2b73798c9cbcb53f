"""The deployment-shaped serving rounds (`seesaw_tpu_torch.utils.rounds`)
and the round profiler, driven on the CPU at a small size: 512 frames x 8
tiles x 32 dims instead of 1.25M x 8 x 512. The CUDA kernel path of the same
rounds runs in `chip_smoke.py`."""
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
    assert [r["loop"] for r in recs] == ["rocchio_update", "log_reg2"]
    for r in recs:
        assert r["rounds"] == 2 and len(r["round_ms"]) == 2
        assert set(r["host_span_ms_per_round"]) == set(profile_round.SPANS)
        assert "busy_ms_per_round" not in r  # no device events on the CPU
    assert "session.next" in out.read_text()
