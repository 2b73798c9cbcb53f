"""The port's multi-device dry run (`seesaw_tpu_torch.parallel.dryrun`),
the twin of `__graft_entry__.dryrun_multichip`, on the CPU.

At 4 shards each part holds its mesh result against one device with the
tolerances stated in the module (f32 rtol / atol 1e-5; kNN distances
2e-6; the Adam step within two steps of its learning rate); here the
figures it returns are checked too, and the command line runs in a fresh
process that imports nothing of JAX.
"""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from seesaw_tpu_torch.parallel.dryrun import dryrun_multichip

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_on_cpu(n):
    out = dryrun_multichip(n, "cpu")
    assert out["n_devices"] == n and out["device"] == "cpu"
    assert out["a_retrieval"]["frames_per_shard"] == -(-(256 * n + 7) // n)
    b = out["b_finetune"]
    assert np.isfinite(b["loss"]) and abs(b["loss"] - b["loss_one_device"]) <= 1e-5
    assert out["c_graph"]["propagation_steps"] > 1
    assert out["d_ingest_encode"]["tiles"] == 3 * n + 1
    assert len(out["e_knn_prop2"]["rounds"]) == 3
    assert out["f_coalesced"]["stats"]["batched"] >= 2
    # the CPU takes every kernel's plain version: no launches
    assert all(v == 0 for part in ("a_retrieval", "c_graph", "e_knn_prop2")
               for v in out[part]["launches"].values())


def test_dryrun_command_line():
    code = textwrap.dedent("""
        import runpy, sys
        sys.argv = ["dryrun", "--n-devices", "4", "--device", "cpu"]
        try:
            runpy.run_module("seesaw_tpu_torch.parallel.dryrun", run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, e.code
        bad = [m for m in sys.modules
               if m == "jax" or m == "seesaw_tpu" or m.startswith("seesaw_tpu.")]
        assert not bad, bad
    """)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["dryrun"]["n_devices"] == 4


def test_dryrun_over_processes(tmp_path):
    """`--processes 2 --devices-per-process 2`: two gloo processes of one
    4-shard mesh run every part, each holding it against one device; both
    return the same replicated results, equal to the in-process 4-shard
    run's (the fine-tune step's parameters within 2e-4 and its loss within
    1e-6 relative: its gradients add in another order)."""
    import os

    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "seesaw_tpu_torch.parallel.dryrun", "--processes", "2",
         "--devices-per-process", "2", "--device", "cpu", "--params-out",
         str(tmp_path / "procs.npz")], cwd=REPO, capture_output=True, text=True, timeout=300,
        env=env)
    assert proc.returncode == 0, proc.stderr
    ranks = json.loads(proc.stdout.strip().splitlines()[-1])["dryrun"]["ranks"]
    assert [(r["rank"], r["processes"], r["n_devices"]) for r in ranks] == [(0, 2, 4), (1, 2, 4)]
    one = dryrun_multichip(4, "cpu", params_out=tmp_path / "one.npz")
    for r in ranks:
        assert r["a_retrieval"] == ranks[0]["a_retrieval"]
        assert r["e_knn_prop2"]["rounds"] == one["e_knn_prop2"]["rounds"]
        assert r["c_graph"]["propagation_steps"] == one["c_graph"]["propagation_steps"]
        assert r["b_finetune"]["loss"] == ranks[0]["b_finetune"]["loss"]
        np.testing.assert_allclose(r["b_finetune"]["loss"], one["b_finetune"]["loss"], rtol=1e-6)
        assert r["f_coalesced"]["stats"]["batched"] >= 2
    with np.load(tmp_path / "procs.npz") as a, np.load(tmp_path / "one.npz") as b:
        assert a.files == b.files
        assert max(float(np.abs(a[k] - b[k]).max()) for k in a.files) <= 2e-4
