"""`correct` at a size a test run holds, on the CPU: a sound run of each mix
passes its cell's limits; the control (the reference in the program's
place, one precision below the configuration's) fails them; and so does a
run with the timed path broken underneath, once for each fault the cell can
have. One chip, so no cell has an exchange between chips to leave out."""
from __future__ import annotations

import numpy as np
import pytest

from loadbench.harness import judge
from loadbench.tests import tiny

CELLS = ["seesaw10m-int8-knn5.knnprop-x4", "seesaw10m-bf16.rocchio-x8",
         "seesaw10m-bf16.plain-x16", "seesaw10m-int8-knn5.plain-x16"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, values = tiny.run(tiny.cell(name, users=4), seed=2**33 + 17)
    assert result["failed"] == 0 and result["attempted"] > 0
    assert result["correct"], result["checks"]


def test_sound_run_over_a_uniform_graph_is_correct():
    """A graph pattern changed in the configuration alone runs and judges."""
    c = tiny.cell(CELLS[0], users=4)
    c.config["graph"] = dict(c.config["graph"], local_share=0.0)
    result, _ = tiny.run(c, seed=2**34 + 3)
    assert result["failed"] == 0 and result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    c = tiny.cell(name, users=4)
    _, values = tiny.run(c, seed=3_000_000_019, control=c.config["control_precision"])
    ok, shown = judge.verdict(values["control"], c.limits)
    assert not ok, shown


# -- faults of the timed path -------------------------------------------------
def _rocchio_unchanged(mp):
    """The refine's update never reaches the query: q stays the text vector."""
    from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex

    orig = MultiscaleIndex._query_rocchio

    def broken(self, dv, **kw):
        dv.beta = dv.gamma = 0.0
        return orig(self, dv, **kw)
    mp.setattr(MultiscaleIndex, "_query_rocchio", broken)


def _rocchio_half_mean(mp):
    """The class means over half of the labelled rows."""
    from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex

    orig = MultiscaleIndex._query_rocchio

    def broken(self, dv, **kw):
        dv.pos_rows = dv.pos_rows[: (len(dv.pos_rows) + 1) // 2]
        dv.neg_rows = dv.neg_rows[: (len(dv.neg_rows) + 1) // 2]
        return orig(self, dv, **kw)
    mp.setattr(MultiscaleIndex, "_query_rocchio", broken)


def _jacobi_unchanged(mp):
    """A Jacobi step that returns its state unchanged and says it is done."""
    from seesaw_tpu_torch.ops import propagation, spmv

    def broken(f_in, f_out, *args, **kw):
        state = args[6]
        f_out.copy_(f_in)
        state[spmv.DONE] = 1
        state[spmv.ITERS] += 1
    mp.setattr(propagation, "jacobi_step", broken)


def _batch_half(mp):
    """Half of a coalesced batch scanned; the rest handed its results."""
    from seesaw_tpu_torch.web.coalesce import QueryCoalescer

    orig = QueryCoalescer._run_chunk

    def broken(self, chunk, *args):
        half = max(1, len(chunk) // 2)
        orig(self, chunk[:half], *args)
        for i, r in enumerate(chunk[half:]):
            r.result = chunk[i % half].result
    mp.setattr(QueryCoalescer, "_run_chunk", broken)


def _answer_altered(mp):
    """The first frame of every answer swapped for its neighbour where the
    result is made."""
    from seesaw_tpu_torch.indices.multiscale import MultiscaleIndex

    orig = MultiscaleIndex._host_result

    def broken(self, host, k):
        out = orig(self, host, k)
        d = out["dbidxs"].copy()
        d[0] = (d[0] + 1) % self.n_frames
        out["dbidxs"] = d.astype(np.int64)
        return out
    mp.setattr(MultiscaleIndex, "_host_result", broken)


FAULTS = [
    ("seesaw10m-int8-knn5.knnprop-x4", _jacobi_unchanged),
    ("seesaw10m-int8-knn5.knnprop-x4", _answer_altered),
    ("seesaw10m-bf16.rocchio-x8", _rocchio_unchanged),
    ("seesaw10m-bf16.rocchio-x8", _rocchio_half_mean),
    ("seesaw10m-bf16.rocchio-x8", _answer_altered),
    ("seesaw10m-bf16.plain-x16", _batch_half),
    ("seesaw10m-bf16.plain-x16", _answer_altered),
    ("seesaw10m-int8-knn5.plain-x16", _batch_half),
    ("seesaw10m-int8-knn5.plain-x16", _answer_altered),
]


@pytest.mark.parametrize("name,fault", FAULTS,
                         ids=[f"{n.split('.')[1]}-{n.split('.')[0][-4:]}-{f.__name__[1:]}"
                              for n, f in FAULTS])
def test_broken_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result, _ = tiny.run(tiny.cell(name, users=4), seed=4_000_000_007)
    assert not result["correct"], result["checks"]
