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

A textual session (`drive_textual_session`) whose simulated user attaches
descriptions to its boxes, as the JAX package's bench user does with
`provide_textual_feedback` (`seesaw_tpu/bench/harness.py:128-150`): the
target's boxes accepted and described, a confusion class rejected and
described.

CLIP fine-tuning (`drive_finetune`): `CLIPFineTuner` steps on a batch of
seeded pixels and token rows made on the device, with host-clock times and
the attention kernels' launches per step.

A Jacobi segment as the serving path launches it (`segment_ms`): one call
of SEGMENT_STEPS steps from fresh buffers, at an eps at which the run stops
at its SEGMENT_WORK-th step (`converging_eps`), on the window-local graph
or on one without locality (`uniform_graph`).

`chip_smoke.py` and `utils/profile_round.py` drive these on the card, and
`utils/compare_spmv_builds.py` the Jacobi segment; the tests drive them on
the CPU at a small size.
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
from ..loops.graph_based import get_weights_from_index, seed_weights
from ..loops.knn_methods import LabelPropagationRanker2
from ..models.clip_finetune import CLIPFineTuner
from ..ops import attention, fused_scoring, spmv
from ..ops.propagation import DeferredPropagation
from ..runtime.bitmap import BitMap
from ..session import Session
from .profiling import annotate, profiled_ms

TILES = 8
_IMG = 224.0
_BOXES = np.array([
    [0, 0, _IMG / 2, _IMG / 2], [_IMG / 2, 0, _IMG, _IMG / 2],
    [0, _IMG / 2, _IMG / 2, _IMG], [_IMG / 2, _IMG / 2, _IMG, _IMG],
    [0, 0, _IMG, _IMG / 2], [0, _IMG / 2, _IMG, _IMG], [0, 0, _IMG / 2, _IMG],
    [0, 0, _IMG, _IMG],
], dtype=np.float32)
_ZOOM = np.array([1, 1, 1, 1, 2, 2, 2, 3], dtype=np.int32)

# the graph the multi_reg sessions regularize with (`window_local_graph`,
# cached under the index's path by `multireg_xlx`)
MULTIREG_GRAPH_K = 32
LOOP_OPTIONS = {
    "rocchio_update": dict(rocchio_alpha=1.0, rocchio_beta=0.7, rocchio_gamma=0.3),
    "log_reg2": dict(class_weights="balanced", scale="centered", reg_lambda=5.0,
                     fit_intercept=False, max_iter=50),
    # seesaw_tpu/configs.py's "multi_reg", over the MULTIREG_GRAPH_K graph
    "multi_reg": dict(matrix_options=dict(knn_path="", knn_k=MULTIREG_GRAPH_K, edist=0.1),
                      label_loss_type="ce_loss", rank_loss_margin=0.0,
                      pos_weight="balanced", reg_data_lambda=0.1, reg_norm_lambda=10.0,
                      reg_query_lambda=1.0, max_iter=100),
}


def sync(device: torch.device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_index(n_vectors: int, dim: int, dtype: str, *, device,
                 generator: torch.Generator, embedding=None,
                 path: str | None = None) -> MultiscaleIndex:
    """(n_vectors, dim) bf16 (or int8 with per-row scales) matrix of random
    tile vectors made on `device`, all tiles valid; host metadata only. The
    text query goes through `embedding` (a `ClipEmbedding` whose `dim` is
    `dim`), or by default through a stub that returns seeded random
    vectors. `path` names the index directory, under which `multireg_xlx`
    caches a graph."""
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
        meta=meta, row_scale=row_scale, path=path,
    )


def session_params(method: str, *, batch_size: int, shortlist_size: int,
                   **options) -> SessionParams:
    """LOOP_OPTIONS[method], with `options` over them."""
    return SessionParams(
        index_spec=IndexSpec(d_name="bench", i_name="synth"),
        interactive=method, batch_size=batch_size, shortlist_size=shortlist_size,
        interactive_options=dict(LOOP_OPTIONS[method], **options),
    )


def multireg_xlx(idx: MultiscaleIndex, weights: SymmetricWeights,
                 matrix_options: dict) -> tuple[torch.Tensor, float]:
    """Cache `weights` as the graph that `matrix_options` names under the
    index's path (`loops.graph_based.seed_weights`), then make and cache the
    index's XLX matrix as a MultiReg session does, from the index's device
    rows in row chunks. Returns (XLX, host-clock seconds ending in a device
    sync); later sessions over the index take both from the cache."""
    seed_weights(idx, matrix_options, weights)
    sync(idx.device)
    t0 = time.perf_counter()
    xlx = get_weights_from_index(idx, matrix_options, xlx_matrix=True, X_vectors=idx.rows_f32)
    sync(idx.device)
    return xlx, time.perf_counter() - t0


def drive_session(idx: MultiscaleIndex, params: SessionParams, rounds: int,
                  rng: np.random.Generator, text: str = "a benchmark query"):
    """Set the text query `text`, then run `rounds` clicks (next, label,
    update_state, refine). Returns the host-clock ms of each `next` and each
    whole round (each ending in a device sync) and the LBFGS host syncs of
    each deferred fit (LogReg2, MultiReg). On a CUDA index every round must
    launch the fused kernel. The labeling, update_state and refine steps
    are named spans in a profiler trace. For multi_reg, the graph must be
    cached first (`multireg_xlx`)."""
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


def uniform_graph(n: int, K: int, device, generator: torch.Generator):
    """(nbr, w, degree) of an (n, K) graph without locality: neighbours
    uniform over all rows, weights uniform in [0.1, 1.0)."""
    nbr = torch.randint(0, n, (n, K), dtype=torch.int32, device=device, generator=generator)
    w = torch.rand(n, K, device=device, generator=generator) * 0.9 + 0.1
    return nbr, w, w.sum(dim=1)


# the serving path's segment (`label_propagation` dispatch_iters), timed
# with an eps at which the run converges at its SEGMENT_WORK-th step
SEGMENT_STEPS, SEGMENT_WORK = 100, 3


def converging_eps(f: torch.Tensor, step_args, work: int = SEGMENT_WORK) -> float:
    """An eps at which a run from f stops at its `work`-th step: the
    geometric mean of the plain steps' max squares `work` - 1 and `work`."""
    bufs, deltas = (f.clone(), torch.empty_like(f)), []
    for k in range(work):
        spmv.jacobi_step_plain(bufs[k % 2], bufs[(k + 1) % 2], *step_args,
                               spmv.new_state(f.device), 0.0)
        deltas.append(float(((bufs[(k + 1) % 2] - bufs[k % 2]) ** 2).max()))
    return (deltas[-2] * deltas[-1]) ** 0.5


def segment_ms(step, f: torch.Tensor, step_args, eps: float, reps: int = 5) -> dict:
    """A SEGMENT_STEPS-step segment from f through `step` (a Jacobi entry
    with `jacobi_step`'s signature and a `launches` count), fresh buffers
    and state each time: host ms (clock around the call and a synchronize)
    and device ms (`profiled_ms`), means over `reps` runs after a first
    run; that first run's buffers and state (`out`), steps, done flag and
    launches."""
    def fresh():
        return f.clone(), torch.empty_like(f), spmv.new_state(f.device)

    sets = [fresh() for _ in range(2 * reps + 1)]
    before = step.launches
    step(*sets[0][:2], *step_args, sets[0][2], eps, SEGMENT_STEPS)
    sync(f.device)
    launches = step.launches - before
    host = []
    for fa, fb, st in sets[1:reps + 1]:
        t0 = time.perf_counter()
        step(fa, fb, *step_args, st, eps, SEGMENT_STEPS)
        sync(f.device)
        host.append((time.perf_counter() - t0) * 1e3)
    dev_ms = profiled_ms(lambda: [step(fa, fb, *step_args, st, eps, SEGMENT_STEPS)
                                  for fa, fb, st in sets[reps + 1:]], reps)
    steps, done = sets[0][2][[spmv.ITERS, spmv.DONE]].tolist()
    return dict(device_ms=dev_ms, host_ms=sum(host) / reps, steps=steps, done=done,
                launches=launches, out=sets[0])


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


TEXTUAL_CONFUSION = "a cat"  # the simulated user's description of a rejected box


def drive_textual_session(session: Session, gt: dict, rounds: int, *, text: str,
                          box_type=Box):
    """Set the text query `text`, then `rounds` clicks. The simulated user
    gives each image with a ground-truth box (`gt`: dbidx -> (x1, y1, x2,
    y2)) that box, accepted and described `text`, and every other image a
    rejected box over its top-left quadrant described TEXTUAL_CONFUSION.
    `box_type` is the Box class of the session's package. Returns each
    round's dbidxs and activation scores."""
    session.set_text(text)
    out = []
    for _ in range(rounds):
        dbidxs = [int(i) for i in session.next()]
        out.append((dbidxs, np.array([a["score"] for a in session.acc_activations[-1]],
                                     np.float32)))
        state = session.get_state()
        for im in state.gdata[-1]:
            b = gt.get(im.dbidx)
            if b is not None:
                x1, y1, x2, y2 = (float(c) for c in b)
                im.boxes = [box_type(x1=x1, y1=y1, x2=x2, y2=y2, description=text,
                                     marked_accepted=True)]
            else:
                im.boxes = [box_type(x1=0.0, y1=0.0, x2=_IMG / 2, y2=_IMG / 2,
                                     description=TEXTUAL_CONFUSION,
                                     marked_accepted=False)]
        session.update_state(state)
        session.refine()
    return out


def finetune_batch(cfg, batch: int, *, device, generator: torch.Generator):
    """(pixels (B, S, S, 3) f32, tokens (B, context) int64) made on `device`:
    normal pixels; token ids in [1, vocab - 1) with the EOT id (vocab - 1,
    the largest) at a random position >= 1 of each row and zeros after it."""
    dev = torch.device(device)
    px = torch.randn(batch, cfg.image_size, cfg.image_size, 3, device=dev,
                     generator=generator)
    L = cfg.context_length
    tok = torch.randint(1, cfg.vocab_size - 1, (batch, L), device=dev, generator=generator)
    eot = torch.randint(1, L, (batch, 1), device=dev, generator=generator)
    pos = torch.arange(L, device=dev)[None, :]
    tok = torch.where(pos < eot, tok, 0)
    tok = torch.where(pos == eot, cfg.vocab_size - 1, tok)
    return px, tok


def drive_finetune(embedding, config: dict, *, device, batch: int, steps: int,
                   warmup_steps: int = 0, generator: torch.Generator) -> dict:
    """`warmup_steps + steps` `CLIPFineTuner.train_step`s on one batch of
    `finetune_batch` pairs on `device`. Returns the loss of every step, the
    host-clock ms of the timed steps (each ending in a device
    sync), the attention kernels' launches per step (forward and backward),
    and the peak device memory (GB) of the timed steps on a CUDA device."""
    dev = torch.device(device)
    tuner = CLIPFineTuner(embedding, config, device=dev)
    px, tok = finetune_batch(embedding.cfg, batch, device=dev, generator=generator)
    out = dict(losses=[], step_ms=[], fwd_launches=[], bwd_launches=[], peak_gb=None)
    for step in range(warmup_steps + steps):
        if step == warmup_steps and dev.type == "cuda":
            sync(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        fwd, bwd = attention.pair_attention.launches, attention.pair_attention_bwd.launches
        t0 = time.perf_counter()
        loss = tuner.train_step(px, tok)
        sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        out["losses"].append(float(loss))
        out["fwd_launches"].append(attention.pair_attention.launches - fwd)
        out["bwd_launches"].append(attention.pair_attention_bwd.launches - bwd)
        if step >= warmup_steps:
            out["step_ms"].append(ms)
    if dev.type == "cuda":
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    return out
