"""The fused KnnProp2 round's ranking tail (`ops.rank_tail`): the one tail
function equals the composition it replaced (`rank_padded`, then the
packing of `_format_result` with the step count and converged flag) bit for
bit; on the CPU a round runs it eagerly and captures nothing; the graph
cache's key separates what a captured graph depends on. On a card, graph
replays from several threads equal the eager tail bit for bit."""
import threading
import time
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import profile

from seesaw_tpu_torch.basic_types import Box, IndexSpec, SessionParams
from seesaw_tpu_torch.loops.graph_based import seed_weights
from seesaw_tpu_torch.ops.rank_tail import TailGraphs, rank_padded, rank_tail, tail_key
from seesaw_tpu_torch.ops.spmv import DONE, ITERS, new_state
from seesaw_tpu_torch.session import Session
from seesaw_tpu_torch.utils import profiling
from seesaw_tpu_torch.utils import rounds as R

T = 4
RANK = dict(shortlist_size=12, topk=5, agg_method="avg_score", max_zoom=3)
TILE_BOXES = [[0, 0, 112, 112], [112, 0, 224, 112], [0, 0, 224, 224], [0, 112, 224, 224]]
TILE_ZOOM = [1, 1, 2, 3]


def _tail_inputs(seed: int, *, n_frames: int, ragged: bool, device="cpu", round_seed=None):
    """A tiny index's ranking arrays and one round's inputs (drawn from
    `round_seed` where given). Scores take six values, so frames and tiles
    tie; some frames are excluded and two more ride in as new exclusions,
    padded with -1."""
    gen = torch.Generator().manual_seed(seed)
    counts = (torch.randint(1, T + 1, (n_frames,), generator=gen) if ragged
              else torch.full((n_frames,), T))
    valid = torch.arange(T)[None, :] < counts[:, None]
    starts = torch.cumsum(counts, 0) - counts
    exact = starts[:, None] + torch.arange(T)[None, :]
    pad_rows = torch.where(valid, exact, 0).reshape(-1) if ragged else None
    n = int(counts.sum())
    boxes = torch.tensor(TILE_BOXES, dtype=torch.float32).repeat(n_frames, 1)
    boxes = boxes + torch.randint(0, 3, boxes.shape, generator=gen).float() * 8.0
    zoom = torch.tensor(TILE_ZOOM).repeat(n_frames)
    if round_seed is not None:
        gen = torch.Generator().manual_seed(round_seed)
    scores = torch.randint(0, 6, (n,), generator=gen).float() / 4.0
    excluded = torch.rand(n_frames, generator=gen) < 0.2
    new_ids = torch.full((8,), -1, dtype=torch.int64)
    new_ids[:2] = torch.randint(0, n_frames, (2,), generator=gen)
    state = new_state("cpu")
    state[ITERS], state[DONE] = 7, 1
    arrays = dict(pad_rows=pad_rows, valid=valid, boxes=boxes, zoom=zoom)
    to = (lambda t: None if t is None else t.to(device))
    return ({k: to(v) for k, v in arrays.items()},
            tuple(to(t) for t in (scores, excluded, new_ids, state)))


@pytest.mark.parametrize("ragged", [False, True], ids=["uniform", "ragged"])
@pytest.mark.parametrize("aug_larger", ["all", "greater", "adjacent"])
@pytest.mark.parametrize("aug_weight", ["level_max", "cont_weighted"])
def test_tail_equals_the_composition(aug_weight, aug_larger, ragged):
    """`rank_tail` packs bit for bit what `rank_padded` and the packing of
    the fused round's `_format_result(res, n_iter.float(), done.float())`
    made, and returns the same new mask."""
    arrays, (scores, excluded, new_ids, state) = _tail_inputs(3, n_frames=40, ragged=ragged)
    rank = dict(RANK, aug_larger=aug_larger, aug_weight=aug_weight)
    packed, mask = rank_tail(scores, excluded, new_ids, state, **arrays, **rank)

    res, want_mask = rank_padded(scores, arrays["pad_rows"], arrays["valid"], arrays["boxes"],
                                 arrays["zoom"], excluded, new_ids, **rank)
    parts = [res.frame_ids, res.act_boxes.reshape(-1), res.act_scores, res.n_valid.reshape(1),
             state[ITERS].float().reshape(-1), (state[DONE] != 0).float().reshape(-1)]
    want = torch.cat([p.to(torch.float64) for p in parts])
    assert packed.dtype == torch.float64 and packed.shape == (6 * RANK["topk"] + 3,)
    assert torch.equal(packed.view(torch.int64), want.view(torch.int64))
    assert torch.equal(mask, want_mask)
    assert packed[-2:].tolist() == [7.0, 1.0]
    assert int(res.n_valid) > 0 and not torch.equal(mask, excluded)


MATRIX = dict(knn_path="", knn_k=8, edist=0.1)


def test_cpu_round_runs_eager(tmp_path):
    """A traced `knn_prop2` click on a CPU index ranks eagerly: its
    `prop.rank` span says `graph` 0 and `captured` 0, under `prop.dispatch`,
    and the index's tail counts no capture and no replay."""
    gen = torch.Generator().manual_seed(0)
    idx = R.device_index(2048, 32, "bfloat16", device="cpu", generator=gen, path=str(tmp_path))
    seed_weights(idx, MATRIX, R.window_local_graph(idx.meta.n_vectors, 8, "cpu", gen))
    params = SessionParams(
        index_spec=IndexSpec(d_name="tail", i_name="tiny"), interactive="knn_prop2",
        batch_size=3, shortlist_size=40,
        interactive_options=dict(matrix_options=MATRIX, **R.KNNPROP_OPTIONS))
    dataset = SimpleNamespace(get_urls=lambda b: [f"b://{int(i)}" for i in b])
    s = Session(None, dataset, idx, params)
    t0 = time.perf_counter_ns()
    with profile():
        s.set_text("a tiny query")
        s.next()
        for _ in range(2):
            state = s.get_state()
            for k, im in enumerate(state.gdata[-1]):
                im.boxes = ([Box(x1=0.0, y1=0.0, x2=8.0, y2=8.0, marked_accepted=True)]
                            if k == 0 else [])
            s.update_state(state)
            s.refine()
            s.next()
    records = profiling.spans(t0)
    by_id = {r.id: r for r in records}
    ranks = [r for r in records if r.name == "prop.rank"]
    assert len(ranks) == 2
    for r in ranks:
        assert r.attrs["graph"] == 0 and r.attrs["captured"] == 0
        assert by_id[r.parent].name == "prop.dispatch"
    tail = idx._rank_tail
    assert (tail.captures, tail.replays, tail.eager) == (0, 0, 2)


def test_key_separates_shapes_and_options():
    """Two indexes of different frame counts, and two shortlist sizes over
    one index, key different graphs; the same shapes and options key one."""
    keys = {}
    for n_frames in (40, 48):
        arrays, (scores, excluded, _, _) = _tail_inputs(1, n_frames=n_frames, ragged=False)
        for shortlist in (12, 20):
            rank = dict(RANK, shortlist_size=shortlist, aug_larger="all",
                        aug_weight="level_max")
            keys[n_frames, shortlist] = tail_key(scores, excluded, arrays["valid"],
                                                 arrays["pad_rows"], **rank)
            again = _tail_inputs(2, n_frames=n_frames, ragged=False)
            assert tail_key(again[1][0], again[1][1], again[0]["valid"], None,
                            **rank) == keys[n_frames, shortlist]
    assert len(set(keys.values())) == 4
    arrays, (scores, excluded, _, _) = _tail_inputs(1, n_frames=40, ragged=True)
    ragged = tail_key(scores, excluded, arrays["valid"], arrays["pad_rows"],
                      **dict(RANK, shortlist_size=12, aug_larger="all",
                             aug_weight="level_max"))
    assert ragged not in keys.values()


@pytest.mark.cuda
def test_cuda_replays_equal_eager_across_threads():
    """Four threads, 50 rounds each, through one index's tail on the card:
    every replay's packed result and mask equal the eager tail's over the
    same inputs bit for bit; one graph is captured and every round after
    the capture replays it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a CUDA graph has no CPU mode")
    dev = torch.device("cuda")
    arrays, _ = _tail_inputs(5, n_frames=20000, ragged=True, device=dev)
    rank = dict(RANK, aug_larger="all", aug_weight="level_max")
    tail = TailGraphs(**arrays)
    rounds = [_tail_inputs(5, n_frames=20000, ragged=True, device=dev, round_seed=100 + i)[1]
              for i in range(8)]
    wrong, errors = [], []

    def user(u):
        try:
            for r in range(50):
                inputs = rounds[(u + r) % len(rounds)]
                packed, mask = tail(*inputs, **rank)
                want, want_mask = rank_tail(*inputs, **arrays, **rank)
                if not (torch.equal(packed.view(torch.int64), want.view(torch.int64))
                        and torch.equal(mask, want_mask)):
                    wrong.append((u, r))
        except Exception as e:  # reported below, with the thread's round
            errors.append(e)

    threads = [threading.Thread(target=user, args=(u,)) for u in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert not errors and not wrong
    assert (tail.captures, tail.replays, tail.eager) == (1, 200, 0)
