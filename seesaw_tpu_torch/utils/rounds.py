"""Deployment-shaped serving rounds over an index built on the device.

The per-click round as the JAX package's bench drives it (`bench.py`
bench_session_rounds): a frame-major matrix of tile vectors made on the
device from a seeded generator, 8 tiles per frame in `bench.py` build_db's
box and zoom pattern, `MultiscaleIndex.from_device_arrays` with no host
mirror, and a Session driven by a simulated user who accepts about 30% of
the results.

The KnnProp2 graph round as `bench.py` bench_graph_10M drives it
(`_drive_knnprop_rounds`): a window-local kNN graph made on the device
(`window_local_graph`), a `LabelPropagationRanker2` with the configured
options, and rank -> simulated labels -> `ranker.update` per round, each
feedback round fused into the next ranking.

`chip_smoke.py` and `utils/profile_round.py` drive these on the card; the
tests drive them on the CPU at a small size.
"""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import torch

from ..basic_types import Box, IndexSpec, SessionParams
from ..indices.meta import VectorMeta
from ..indices.multiscale import MultiscaleIndex
from ..knn_graph import SymmetricWeights
from ..loops.knn_methods import LabelPropagationRanker2
from ..ops import fused_scoring, spmv
from ..ops.propagation import DeferredPropagation
from ..runtime.bitmap import BitMap
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
                 generator: torch.Generator, embedding=None) -> MultiscaleIndex:
    """(n_vectors, dim) bf16 (or int8 with per-row scales) matrix of random
    tile vectors made on `device`, all tiles valid; host metadata only. The
    text query goes through `embedding` (a `ClipEmbedding` whose `dim` is
    `dim`), or by default through a stub that returns seeded random
    vectors."""
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
    if embedding is None:
        rng = np.random.default_rng(0)
        embedding = SimpleNamespace(
            from_string=lambda string=None: rng.normal(size=dim).astype(np.float32))
    return MultiscaleIndex.from_device_arrays(
        embedding=embedding, V=V,
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
                  rng: np.random.Generator, text: str = "a benchmark query"):
    """Set the text query `text`, then run `rounds` clicks (next, label,
    update_state, refine). Returns the
    host-clock ms of each `next` and each whole round (each ending in a
    device sync) and the LBFGS host syncs of each LogReg2 fit. On a CUDA
    index every round must launch the fused kernel. The labeling,
    update_state and refine steps are named spans in a profiler trace."""
    dataset = SimpleNamespace(get_urls=lambda b: [f"b://{int(i)}" for i in b])
    s = Session(None, dataset, idx, params)
    s.set_text(text)
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


# seesaw_tpu/configs.py "knn_prop2" ranker options (the graph comes apart)
KNNPROP_OPTIONS = dict(normalize_scores=True, normalize_epsilon=0.1,
                       sigmoid_before_propagate=True, calib_a=10.0, calib_b=-5.0,
                       prior_weight=1.0)


def knnprop_ranker(weights: SymmetricWeights, device, *, warm_start: bool = False,
                   ) -> LabelPropagationRanker2:
    return LabelPropagationRanker2(weights=weights, device=device,
                                   warm_start=warm_start, **KNNPROP_OPTIONS)


def window_local_graph(n: int, K: int, device, generator: torch.Generator,
                       *, window: int = 400, local_share: float = 0.97) -> SymmetricWeights:
    """The (n, K) graph of `bench.py` _make_window_local_edges, made on
    `device`: 97% of the neighbours uniform within +-400 rows of their row
    (clipped to the ends), 3% uniform over all rows, weights uniform in
    [0.1, 1.0), degree = row sum. Rows may repeat a neighbour or list
    themselves, as there."""
    dev = torch.device(device)
    base = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    nbr = torch.randint(-window, window + 1, (n, K), dtype=torch.int32, device=dev,
                        generator=generator)
    nbr += base
    nbr.clamp_(0, n - 1)
    far = torch.rand(n, K, device=dev, generator=generator) >= local_share
    nbr[far] = torch.randint(0, n, (int(far.sum()),), dtype=torch.int32, device=dev,
                             generator=generator)
    del far
    w = torch.rand(n, K, device=dev, generator=generator) * 0.9 + 0.1
    return SymmetricWeights(nbr=nbr, w=w, degree=w.sum(dim=1))


def drive_knnprop_rounds(idx: MultiscaleIndex, ranker: LabelPropagationRanker2,
                         rounds: int, *, seed: int = 0, batch_size: int = 3,
                         shortlist_size: int = 50) -> dict:
    """`rounds` KnnProp2 serving rounds through the loop's pieces: rank by
    the ranker's scores (a staged round runs fused inside the ranking) ->
    the simulated user labels the batch's first tiles, 30% accepted ->
    `ranker.update`. Returns per-round host-clock ms (each round ends in a
    device sync), and for the rounds whose ranking propagated: Jacobi
    iterations, host reads and kernel launches. On a CUDA index every such
    round must launch the Jacobi kernel."""
    rng = np.random.default_rng(seed)
    qvec = rng.normal(size=idx.dim).astype(np.float32)
    ranker.set_base_scores(idx.score_device(qvec / np.linalg.norm(qvec)))
    meta = idx.meta
    returned = BitMap()
    out = dict(round_ms=[], propagated=[], iters=[], host_reads=[], launches=[])
    for r in range(rounds):
        before = spmv.jacobi_step.launches
        t0 = time.perf_counter()
        scores = ranker.current_scores_any()
        fused = isinstance(scores, DeferredPropagation)
        with annotate("knnprop.rank"):
            res = idx.rank_by_scores(scores, topk=batch_size,
                                     shortlist_size=shortlist_size, exclude=returned,
                                     agg_method="avg_score", aug_larger="all")
        got = [int(d) for d in res["dbidxs"]]
        if len(got) != batch_size:
            raise AssertionError(f"round {r}: {len(got)} results")
        returned.update(got)
        with annotate("knnprop.update"):
            rows = meta.frame_starts[np.searchsorted(meta.frame_dbidx, got)]
            ranker.update(rows, (rng.random(len(rows)) < 0.3).astype(np.float64))
        sync(idx.device)
        out["round_ms"].append((time.perf_counter() - t0) * 1e3)
        out["propagated"].append(fused)
        if fused:
            launched = spmv.jacobi_step.launches - before
            if idx.device.type == "cuda" and launched == 0:
                raise AssertionError(f"round {r}: the round did not launch the kernel")
            res_p = ranker.last_result
            out["iters"].append(res_p.n_iter)
            out["host_reads"].append(res_p.host_reads)
            out["launches"].append(launched)
    if len(returned) != rounds * batch_size:
        raise AssertionError("the rounds repeated a dbidx")
    return out
