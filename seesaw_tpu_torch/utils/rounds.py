"""Deployment-shaped serving rounds over an index built on the device.

The per-click round as the JAX package's bench drives it (`bench.py`
bench_session_rounds): a frame-major matrix of tile vectors made on the
device from a seeded generator, 8 tiles per frame in `bench.py` build_db's
box and zoom pattern, `MultiscaleIndex.from_device_arrays` with no host
mirror, and a Session driven by a simulated user who accepts about 30% of
the results. `chip_smoke.py` and `utils/profile_round.py` drive it on the
card; the tests drive it on the CPU at a small size.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from seesaw_tpu.basic_types import Box, IndexSpec, SessionParams
from seesaw_tpu.indices.meta import VectorMeta

from ..indices.multiscale import MultiscaleIndex
from ..ops import fused_scoring
from ..session import Session
from .profiling import annotate

TILES = 8
_IMG = 224.0
_BOXES = np.array([
    [0, 0, _IMG / 2, _IMG / 2], [_IMG / 2, 0, _IMG, _IMG / 2],
    [0, _IMG / 2, _IMG / 2, _IMG], [_IMG / 2, _IMG / 2, _IMG, _IMG],
    [0, 0, _IMG, _IMG / 2], [0, _IMG / 2, _IMG, _IMG], [0, 0, _IMG / 2, _IMG],
    [0, 0, _IMG, _IMG],
], dtype=np.float32)
_ZOOM = np.array([1, 1, 1, 1, 2, 2, 2, 3], dtype=np.int32)

LOOP_OPTIONS = {
    "rocchio_update": dict(rocchio_alpha=1.0, rocchio_beta=0.7, rocchio_gamma=0.3),
    "log_reg2": dict(class_weights="balanced", scale="centered", reg_lambda=5.0,
                     fit_intercept=False, max_iter=50),
}


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_index(n_vectors: int, dim: int, dtype: str, *, device,
                 generator: torch.Generator) -> MultiscaleIndex:
    """(n_vectors, dim) bf16 (or int8 with per-row scales) matrix of random
    tile vectors made on `device`, all tiles valid; host metadata only."""
    dev = torch.device(device)
    F = n_vectors // TILES
    n = F * TILES
    if dtype == "int8":
        V = torch.randint(-127, 128, (n, dim), dtype=torch.int8, device=dev,
                          generator=generator)
        row_scale = (torch.rand(n, device=dev, generator=generator) * 0.5 + 0.5) / 127.0
    elif dtype == "bfloat16":
        V = torch.randn(n, dim, dtype=torch.bfloat16, device=dev, generator=generator)
        row_scale = None
    else:
        raise ValueError(f"unknown dtype {dtype!r}")
    meta = VectorMeta(
        dbidx=np.repeat(np.arange(F, dtype=np.int32), TILES),
        zoom_level=np.tile(_ZOOM, F),
        boxes=np.tile(_BOXES, (F, 1)),
        frame_dbidx=np.arange(F, dtype=np.int32),
        frame_starts=np.arange(0, (F + 1) * TILES, TILES, dtype=np.int32),
        frame_id=np.repeat(np.arange(F, dtype=np.int32), TILES),
    )
    rng = np.random.default_rng(0)
    emb = SimpleNamespace(
        from_string=lambda string=None: rng.normal(size=dim).astype(np.float32))
    return MultiscaleIndex.from_device_arrays(
        embedding=emb, V=V,
        valid=torch.ones(F, TILES, dtype=torch.bool, device=dev),
        boxes=torch.from_numpy(_BOXES).to(dev).repeat(F, 1),
        zoom=torch.from_numpy(_ZOOM).to(dev).repeat(F),
        meta=meta, row_scale=row_scale,
    )


def session_params(method: str, *, batch_size: int, shortlist_size: int) -> SessionParams:
    return SessionParams(
        index_spec=IndexSpec(d_name="bench", i_name="synth"),
        interactive=method, batch_size=batch_size, shortlist_size=shortlist_size,
        interactive_options=LOOP_OPTIONS[method],
    )


def drive_session(idx: MultiscaleIndex, params: SessionParams, rounds: int,
                  rng: np.random.Generator):
    """Run `rounds` clicks (next, label, update_state, refine). Returns the
    host-clock ms of each `next` and each whole round (each ending in a
    device sync) and the LBFGS host syncs of each LogReg2 fit. On a CUDA
    index every round must launch the fused kernel. The labeling,
    update_state and refine steps are named spans in a profiler trace."""
    dataset = SimpleNamespace(get_urls=lambda b: [f"b://{int(i)}" for i in b])
    s = Session(None, dataset, idx, params)
    s.set_text("a benchmark query")
    next_ms, round_ms, syncs = [], [], []
    for r in range(rounds):
        before = fused_scoring.fused_frame_max.launches
        t0 = time.perf_counter()
        dbidxs = s.next()
        sync(idx.device)
        t1 = time.perf_counter()
        if idx.device.type == "cuda" and fused_scoring.fused_frame_max.launches <= before:
            raise AssertionError(f"round {r}: the query did not launch the kernel")
        if len(dbidxs) != params.batch_size:
            raise AssertionError(f"round {r}: {len(dbidxs)} results")
        if idx.last_fit is not None:
            syncs.append(idx.last_fit["host_syncs"])
            idx.last_fit = None
        with annotate("round.label"):
            state = s.get_state()
            for im in state.gdata[-1]:
                im.boxes = ([Box(x1=0.0, y1=0.0, x2=112.0, y2=112.0, marked_accepted=True)]
                            if rng.random() < 0.3 else [])
        with annotate("round.update_state"):
            s.update_state(state)
        with annotate("round.refine"):
            s.refine()
        sync(idx.device)
        t2 = time.perf_counter()
        next_ms.append((t1 - t0) * 1e3)
        round_ms.append((t2 - t0) * 1e3)
    flat = [int(x) for b in s.acc_indices for x in b]
    if len(flat) != len(set(flat)):
        raise AssertionError("the session repeated a dbidx")
    return next_ms, round_ms, syncs
