"""The per-click query program: score, distinct-frame top-k, augmentation.

PyTorch counterpart of `seesaw_tpu/ops/frame_scoring.py` (single query).
The index stores vectors frame-major padded: frame f owns rows
[f*T, (f+1)*T) of V, invalid rows masked by `valid` (F, T). Then

    fmax      = masked max over each frame's tile scores, excluded -> -inf
    shortlist = top-k frames by fmax
    adjusted  = zoom-level augmentation over the shortlisted frames' tiles
    result    = top-k frames by adjusted score + each frame's top tile

Tie order follows the JAX package: `jax.lax.top_k` puts the lower index
first on equal values and `argmax` takes the first maximum. `torch.topk`
promises no tie order, so top-k here is a stable descending sort.

Scores of a whole matrix are computed in row chunks so that a 10M-row bf16
or int8 index is never copied to f32 at once.

The batch programs (`query_program_batch*`) serve Q concurrent sessions'
queries in one (N, D) @ (D, Q) scan, each with its own exclusion mask; the
ranking tail runs over a leading Q axis. On a CUDA matrix the scan is one
library product with f32 output (`torch.mm(..., out_dtype=float32)` for
bf16, `torch._int_mm` for int8), as JAX computes it with one XLA
`dot_general`; on a CPU matrix it is `scoring_matmat_plain`, the row-chunked
f32 route of `scoring_matvec`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

NEG_INF = float("-inf")
_CHUNK_ROWS = 1 << 20  # rows per f32 upcast in scoring_matvec
_INT8_EXACT_D = (1 << 24) // (127 * 127)  # int8 dots stay exact in f32 up to here


def topk_first(x: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last axis with ties broken by lower index first, as
    `jax.lax.top_k` does."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def pairwise_iou_cont(boxes: torch.Tensor):
    """(..., T, 4) boxes -> (..., T, T) IoU and containment of the row box in
    the column box."""
    lt = torch.maximum(boxes[..., :, None, :2], boxes[..., None, :, :2])
    rb = torch.minimum(boxes[..., :, None, 2:], boxes[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    union = area[..., :, None] + area[..., None, :] - inter
    one = torch.ones((), dtype=boxes.dtype, device=boxes.device)
    iou = torch.where(union > 0, inter / torch.where(union > 0, union, one), 0.0)
    a_row = area[..., :, None]
    cont = torch.where(a_row > 0, inter / torch.where(a_row > 0, a_row, one), 0.0)
    return iou, cont


def augment_tile_scores(
    boxes: torch.Tensor,  # (B, T, 4)
    zoom: torch.Tensor,  # (B, T) int
    scores: torch.Tensor,  # (B, T) f32
    valid: torch.Tensor,  # (B, T) bool
    *,
    aug_larger: str = "all",
    aug_weight: str = "level_max",
    agg_method: str = "avg_score",
    max_zoom: int = 8,
) -> torch.Tensor:
    """Per-tile augmented scores for B frames at once (the JAX version runs
    one frame and is vmapped). Same semantics: tile i joins every valid tile j
    of its frame with IoU > 0, filtered by `aug_larger`; 'level_max' averages
    over zoom levels the score of the joined tile with the highest IoU
    (first on ties), 'cont_weighted' weights joined scores by a softmax over
    containment; 'plain_score' skips augmentation. Invalid tiles -> -inf."""
    if agg_method == "plain_score":
        return torch.where(valid, scores, NEG_INF)

    iou, cont = pairwise_iou_cont(boxes)
    join = (iou > 0.0) & valid[:, :, None] & valid[:, None, :]
    zi, zj = zoom[:, :, None], zoom[:, None, :]
    if aug_larger == "greater":
        join = join & (zj >= zi)
    elif aug_larger == "adjacent":
        join = join & (zj == zi)
    elif aug_larger != "all":
        raise ValueError(f"unknown aug_larger {aug_larger!r}")

    if aug_weight == "level_max":
        level_sum = torch.zeros_like(scores)
        level_cnt = torch.zeros_like(scores)
        for lvl in range(1, max_zoom + 1):
            join_l = join & (zj == lvl)
            any_l = join_l.any(dim=2)
            best_j = torch.where(join_l, iou, NEG_INF).argmax(dim=2)  # first max
            picked = torch.gather(scores, 1, best_j)
            level_sum = level_sum + torch.where(any_l, picked, 0.0)
            level_cnt = level_cnt + any_l.to(scores.dtype)
        adjusted = level_sum / torch.clamp(level_cnt, min=1.0)
        adjusted = torch.where(level_cnt > 0, adjusted, NEG_INF)
    elif aug_weight == "cont_weighted":
        logits = torch.where(join, cont, NEG_INF)
        m = logits.amax(dim=2, keepdim=True)
        shift = torch.where(torch.isfinite(m), m, 0.0)
        e = torch.where(join, torch.exp(logits - shift), 0.0)
        denom = e.sum(dim=2, keepdim=True)
        w = e / torch.where(denom > 0, denom, 1.0)
        adjusted = (w * torch.where(join, scores[:, None, :], 0.0)).sum(dim=2)
        adjusted = torch.where(join.any(dim=2), adjusted, NEG_INF)
    else:
        raise ValueError(f"unknown aug_weight {aug_weight!r}")

    return torch.where(valid, adjusted, NEG_INF)


class QueryResult(NamedTuple):
    """Top-k frames with activation data, all tensors on the index's device.

    frame_ids: (k,) int64 frame ordinals (-1 past the end of valid results)
    frame_scores: (k,) f32 augmented frame scores
    act_boxes: (k, 4) f32 top-tile box per frame
    act_scores: (k,) f32 top-tile augmented score
    n_valid: () int64 number of usable rows
    """

    frame_ids: torch.Tensor
    frame_scores: torch.Tensor
    act_boxes: torch.Tensor
    act_scores: torch.Tensor
    n_valid: torch.Tensor


def pack_result(res: QueryResult, *extras: torch.Tensor) -> torch.Tensor:
    """A result (+ extra tensors, flattened) as one f64 buffer for ONE host
    read, exact for f32 values and for ids below 2^53: ids, boxes, top-tile
    scores, the count, then the extras, (6k+1+...,); a batch's result (a
    leading Q axis on every field) gives one such row per query."""
    lead = res.frame_ids.shape[:-1]
    parts = [res.frame_ids, res.act_boxes.reshape(*lead, -1), res.act_scores,
             res.n_valid.reshape(*lead, 1)] + [e.reshape(*lead, -1) for e in extras]
    return torch.cat([p.to(torch.float64) for p in parts], dim=-1)


def quantize_query(qvec: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 query quantization, in the JAX package's order:
    clip(round(q / qmax * 127), -127, 127) with qmax = max|q| + 1e-12.
    Returns (int8 values as f32, scale qmax / 127). `torch.round` rounds half
    to even, as `jnp.round` does."""
    qmax = qvec.abs().max() + 1e-12
    q_i8 = torch.clamp(torch.round(qvec / qmax * 127.0), -127, 127)
    return q_i8, qmax / 127.0


def quantize_queries(qvecs: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """`quantize_query` for each row of (Q, D) queries, by the row's own max.
    Returns (int8 values as f32 (Q, D), scales (Q,))."""
    qmax = qvecs.abs().amax(dim=1, keepdim=True) + 1e-12
    q_i8 = torch.clamp(torch.round(qvecs / qmax * 127.0), -127, 127)
    return q_i8, (qmax / 127.0)[:, 0]


def _f32_product(vectors: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """vectors @ q in f32 for q (D,) or (D, Q), the matrix upcast in row
    chunks so that it is never copied to f32 whole."""
    if not vectors.shape[0]:
        return torch.zeros(0, *q.shape[1:], device=vectors.device)
    return torch.cat([vectors[i:i + _CHUNK_ROWS].to(torch.float32) @ q
                      for i in range(0, vectors.shape[0], _CHUNK_ROWS)])


def scoring_matvec(
    vectors: torch.Tensor, qvec: torch.Tensor, row_scale: torch.Tensor | None = None
) -> torch.Tensor:
    """V @ q in f32. bf16 multiplies by the bf16-rounded query with f32
    accumulation; int8 takes an exact integer dot with the quantized query
    and returns (acc * qmax/127) * row_scale, the JAX package's order."""
    qvec = qvec.to(torch.float32)
    if vectors.dtype == torch.int8:
        if vectors.shape[1] > _INT8_EXACT_D:
            raise ValueError(
                f"int8 scoring needs D <= {_INT8_EXACT_D} for an exact f32 dot"
            )
        q_in, scale = quantize_query(qvec)
    else:
        if row_scale is not None:
            raise ValueError(
                f"row_scale is only meaningful for int8 vectors (got {vectors.dtype})"
            )
        q_in, scale = qvec.to(vectors.dtype).to(torch.float32), None
    out = _f32_product(vectors, q_in)
    if scale is not None:
        out = out * scale
        if row_scale is not None:
            out = out * row_scale
    return out


def _matmat_operands(vectors, qvecs, row_scale):
    """(queries as the product's operand values in f32, per-query int8
    scales or None), with scoring_matvec's checks."""
    qvecs = qvecs.to(torch.float32)
    if qvecs.dim() != 2 or qvecs.shape[1] != vectors.shape[1]:
        raise ValueError(f"qvecs must be (Q, {vectors.shape[1]}), got {tuple(qvecs.shape)}")
    if vectors.dtype == torch.int8:
        if vectors.shape[1] > _INT8_EXACT_D:
            raise ValueError(f"int8 scoring needs D <= {_INT8_EXACT_D} for an exact dot")
        return quantize_queries(qvecs)
    if row_scale is not None:
        raise ValueError(f"row_scale is only meaningful for int8 vectors (got {vectors.dtype})")
    return qvecs.to(vectors.dtype).to(torch.float32), None


def _int8_product(vectors: torch.Tensor, q_i8: torch.Tensor) -> torch.Tensor:
    """(N, Q) int32 V @ q_i8^T on the card by `torch._int_mm`, which wants
    more than 16 rows and inner and output widths that are multiples of 8:
    Q is padded with zero queries and the padding dropped. The queries go in
    column-major, the layout cuBLAS reads fastest."""
    N, D = vectors.shape
    Q = q_i8.shape[0]
    if N <= 16 or D % 8:
        raise ValueError(f"the int8 batch scan needs > 16 rows and D % 8 == 0 (got {N} x {D})")
    q_pad = torch.zeros(-(-Q // 8) * 8, D, dtype=torch.int8, device=vectors.device)
    q_pad[:Q] = q_i8.to(torch.int8)
    return torch._int_mm(vectors, q_pad.T)[:, :Q]


def scoring_matmat_plain(vectors, qvecs, row_scale=None) -> torch.Tensor:
    """Plain version of `scoring_matmat`: the row-chunked f32 route of
    `scoring_matvec`, one column per query (int8 dots are exact in f32)."""
    q_in, scale = _matmat_operands(vectors, qvecs, row_scale)
    out = _f32_product(vectors, q_in.T)
    if scale is not None:
        out = out * scale[None, :]
        if row_scale is not None:
            out = out * row_scale[:, None]
    return out


def scoring_matmat(vectors, qvecs, row_scale=None) -> torch.Tensor:
    """(N, D) @ (D, Q) multi-query scores in f32: the matrix is read once for
    Q concurrent sessions' queries. Column q equals `scoring_matvec(vectors,
    qvecs[q], row_scale)` up to the order of the sums (int8: exactly; each
    query is quantized by its own max; out = (acc * qmax_q/127) * row_scale,
    the JAX package's order). A CPU matrix takes the plain version."""
    if vectors.device.type == "cpu":
        return scoring_matmat_plain(vectors, qvecs, row_scale)
    q_in, scale = _matmat_operands(vectors, qvecs, row_scale)
    if vectors.dtype == torch.int8:
        out = _int8_product(vectors, q_in).to(torch.float32).mul_(scale[None, :])
        return out.mul_(row_scale[:, None]) if row_scale is not None else out
    if vectors.dtype == torch.bfloat16:  # f32 output: bf16 would round every score
        return torch.mm(vectors, q_in.to(torch.bfloat16).T, out_dtype=torch.float32)
    return vectors @ q_in.T


class DeferredVector:
    """Marker base for query vectors that the index resolves inside the query
    itself, with no host round trip between refine and query."""


class DeferredLogistic(DeferredVector):
    """Deferred logistic-probe fit: labeled-row gather + centering + LBFGS
    (`learners.logistic_regression._fit_ce_rows`) run inside the query over
    the fitted coefficient (`MultiscaleIndex._query_logistic`). Built by
    `LogisticRegression.deferred_fit_rows`; the fit rides back in the query
    result ('fit') and is applied with `apply_fit_result`."""

    __slots__ = (
        "prows", "y", "sw", "n_real", "pos_weight", "reg_weight",
        "anchor", "params0", "fit_intercept", "max_iter", "has_anchor",
        "center", "model",
    )

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


class DeferredMultiReg(DeferredVector):
    """Deferred multi-regularized 'seesaw' fit: labeled-row gather +
    centering + the 4-term LBFGS objective (`learners.multi_reg.RegFit`, the
    `model`, holds its options) run inside the query over the fitted
    coefficient (`MultiscaleIndex._query_multireg`). Built by
    `RegFit.deferred_fit_rows`."""

    __slots__ = ("prows", "y", "sw", "model")

    def __init__(self, **kw):
        for k in self.__slots__:
            setattr(self, k, kw[k])


class DeferredRocchio(DeferredVector):
    """q = alpha*q0 + beta*mean(pos rows) - gamma*mean(neg rows), resolved on
    the device inside the query (`MultiscaleIndex._query_rocchio`)."""

    __slots__ = ("q0", "pos_rows", "neg_rows", "alpha", "beta", "gamma")

    def __init__(self, q0, pos_rows, neg_rows, alpha, beta, gamma):
        self.q0 = np.asarray(q0, np.float32).reshape(-1)
        self.pos_rows = np.asarray(pos_rows, np.int64).reshape(-1)
        self.neg_rows = np.asarray(neg_rows, np.int64).reshape(-1)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.gamma = float(gamma)


def _rank_frames(
    scores: torch.Tensor,  # (F*T,) f32 per-tile scores
    valid: torch.Tensor,
    boxes: torch.Tensor,
    zoom: torch.Tensor,
    excluded: torch.Tensor,
    **rank,
) -> QueryResult:
    """Ranking tail over full per-tile scores: shortlist by frame max,
    augment, final top-k (`_rank_frames_batch` for one query)."""
    res = _rank_frames_batch(scores[:, None], valid, boxes, zoom, excluded[None], **rank)
    return QueryResult(*(field[0] for field in res))


def _rank_frames_batch(
    scores: torch.Tensor,  # (F*T, Q) f32 per-tile scores, one column a query
    valid: torch.Tensor,  # (F, T)
    boxes: torch.Tensor,
    zoom: torch.Tensor,
    excluded: torch.Tensor,  # (Q, F)
    *,
    shortlist_size: int,
    topk: int,
    aug_larger: str,
    aug_weight: str,
    agg_method: str,
    max_zoom: int,
) -> QueryResult:
    """The ranking tail of Q queries at once (JAX vmaps it over Q); every
    field of the result has a leading Q axis."""
    F, T = valid.shape
    Q = scores.shape[1]
    s = torch.where(valid[:, :, None], scores.view(F, T, Q), NEG_INF)  # (F, T, Q)
    fmax = torch.where(excluded, NEG_INF, s.amax(dim=1).T)  # (Q, F)
    short_scores, short_fids = topk_first(fmax, shortlist_size)  # (Q, S)
    short_valid = short_scores > NEG_INF

    qi = torch.arange(Q, device=valid.device)[:, None]
    rows = short_fids[..., None] * T + torch.arange(T, device=valid.device)
    tile_valid = valid[short_fids] & short_valid[..., None]  # (Q, S, T)
    t_scores = torch.where(tile_valid, s[short_fids, :, qi], NEG_INF)
    return _augment_and_topk(
        t_scores, boxes[rows], zoom[rows], tile_valid, short_fids, short_valid,
        topk=topk, shortlist_size=shortlist_size, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method, max_zoom=max_zoom,
    )


def _augment_and_topk(
    t_scores, t_boxes, t_zoom, tile_valid, short_fids, short_valid,
    *, topk, shortlist_size, aug_larger, aug_weight, agg_method, max_zoom,
) -> QueryResult:
    """Shortlist -> QueryResult tail shared by every query formulation, over
    (B, T) tiles or (Q, B, T) for Q queries (the fields then lead with Q)."""
    lead = t_scores.shape[:-1]  # (B,) or (Q, B)
    T = t_scores.shape[-1]
    aug = augment_tile_scores(
        t_boxes.reshape(-1, T, 4), t_zoom.reshape(-1, T), t_scores.reshape(-1, T),
        tile_valid.reshape(-1, T), aug_larger=aug_larger, aug_weight=aug_weight,
        agg_method=agg_method, max_zoom=max_zoom,
    ).view(*lead, T)
    frame_score = aug.amax(dim=-1)
    top_tile = aug.argmax(dim=-1, keepdim=True)  # first max, the pandas head(1) convention
    act_box = torch.gather(t_boxes, -2, top_tile[..., None].expand(*lead, 1, 4)).squeeze(-2)
    act_score = torch.gather(aug, -1, top_tile).squeeze(-1)

    frame_score = torch.where(short_valid, frame_score, NEG_INF)
    final_scores, final_pos = topk_first(frame_score, min(topk, shortlist_size))
    ok = final_scores > NEG_INF
    return QueryResult(
        frame_ids=torch.where(ok, torch.gather(short_fids, -1, final_pos), -1),
        frame_scores=final_scores,
        act_boxes=torch.gather(act_box, -2, final_pos[..., None].expand(*final_pos.shape, 4)),
        act_scores=torch.gather(act_score, -1, final_pos),
        n_valid=ok.sum(dim=-1),
    )


def apply_new_exclusions(excluded: torch.Tensor, new_ids: torch.Tensor) -> torch.Tensor:
    """Merge newly excluded frame ordinals (padded with -1) into the (F,)
    mask, or each row of (Q, M) ordinals into its row of (Q, F) masks.
    Returns a NEW tensor: the input may be the index's shared base mask or a
    session's published mask, which must not change in place."""
    F = excluded.shape[-1]
    slot = torch.where(new_ids >= 0, new_ids, F)  # -1 padding -> scratch slot
    upd = torch.zeros(*excluded.shape[:-1], F + 1, dtype=torch.bool, device=excluded.device)
    upd.scatter_(-1, slot, True)
    return excluded | upd[..., :F]


def query_program(
    vectors, valid, boxes, zoom, qvec, qvec2, excluded, row_scale=None, *,
    shortlist_size: int, topk: int, aug_larger: str = "all",
    aug_weight: str = "level_max", agg_method: str = "avg_score", max_zoom: int = 8,
) -> QueryResult:
    """The full per-click query over all tile scores (optionally minus a
    second query's scores)."""
    scores = scoring_matvec(vectors, qvec, row_scale)
    if qvec2 is not None:
        scores = scores - scoring_matvec(vectors, qvec2, row_scale)
    return _rank_frames(
        scores, valid, boxes, zoom, excluded,
        shortlist_size=shortlist_size, topk=topk, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method, max_zoom=max_zoom,
    )


def query_program_incr(
    vectors, valid, boxes, zoom, qvec, qvec2, excluded, new_excluded_ids,
    row_scale=None, **kw,
) -> tuple[QueryResult, torch.Tensor]:
    """query_program after merging the click's new exclusions; returns
    (result, updated mask)."""
    excluded = apply_new_exclusions(excluded, new_excluded_ids)
    res = query_program(
        vectors, valid, boxes, zoom, qvec, qvec2, excluded, row_scale, **kw
    )
    return res, excluded


def rank_frames_from_scores(
    scores, valid, boxes, zoom, excluded, *, shortlist_size: int, topk: int,
    aug_larger: str = "all", aug_weight: str = "level_max",
    agg_method: str = "avg_score", max_zoom: int = 8,
) -> QueryResult:
    """Ranking tail over externally produced per-tile scores in the padded
    layout (graph loops: propagated label scores)."""
    return _rank_frames(
        scores, valid, boxes, zoom, excluded,
        shortlist_size=shortlist_size, topk=topk, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method, max_zoom=max_zoom,
    )


def rank_frames_from_scores_incr(
    scores, valid, boxes, zoom, excluded, new_excluded_ids, **kw,
) -> tuple[QueryResult, torch.Tensor]:
    """rank_frames_from_scores after merging the click's new exclusions;
    returns (result, updated mask)."""
    excluded = apply_new_exclusions(excluded, new_excluded_ids)
    return rank_frames_from_scores(scores, valid, boxes, zoom, excluded, **kw), excluded


def rank_from_frame_max(
    vectors: torch.Tensor,  # (F*T, D)
    valid: torch.Tensor,  # (F, T)
    boxes: torch.Tensor,  # (F*T, 4)
    zoom: torch.Tensor,  # (F*T,)
    qvec: torch.Tensor,  # (D,)
    fmax: torch.Tensor,  # (F,) per-frame max score, -inf = excluded
    row_scale: torch.Tensor | None = None,  # (F*T,) int8 per-row scales
    frame_scale: torch.Tensor | None = None,  # (F,) int8 per-frame scales
    *,
    shortlist_size: int,
    topk: int,
    tile_bound: int,
    aug_larger: str = "all",
    aug_weight: str = "level_max",
    agg_method: str = "avg_score",
    max_zoom: int = 8,
) -> QueryResult:
    """Shortlist tail after the fused scan: top frames by `fmax`, rescore
    only their B*T tiles exactly, augment, final top-k."""
    T = tile_bound
    short_scores, short_fids = topk_first(fmax, shortlist_size)
    short_valid = short_scores > NEG_INF

    rows = short_fids[:, None] * T + torch.arange(T, device=fmax.device)[None, :]
    flat = rows.reshape(-1)
    tile_valid = valid[short_fids] & short_valid[:, None]
    if frame_scale is not None:
        t_scale = frame_scale[short_fids].repeat_interleave(T)
    elif row_scale is not None:
        t_scale = row_scale[flat]
    else:
        t_scale = None
    t_scores = scoring_matvec(vectors[flat], qvec, t_scale).reshape(shortlist_size, T)
    t_scores = torch.where(tile_valid, t_scores, NEG_INF)
    return _augment_and_topk(
        t_scores, boxes[rows], zoom[rows], tile_valid, short_fids, short_valid,
        topk=topk, shortlist_size=shortlist_size, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method, max_zoom=max_zoom,
    )


def query_program_batch(
    vectors, valid, boxes, zoom, qvecs, excluded, row_scale=None, *,
    shortlist_size: int, topk: int, aug_larger: str = "all",
    aug_weight: str = "level_max", agg_method: str = "avg_score", max_zoom: int = 8,
    plain: bool = False,
) -> QueryResult:
    """Q concurrent sessions' queries in one (N, D) @ (D, Q) scan, each with
    its own exclusion mask: qvecs (Q, D), excluded (Q, F). Every field of the
    result has a leading Q axis. `plain` takes `scoring_matmat_plain` on any
    device (a CPU matrix always does)."""
    scan = scoring_matmat_plain if plain else scoring_matmat
    return _rank_frames_batch(
        scan(vectors, qvecs, row_scale), valid, boxes, zoom, excluded,
        shortlist_size=shortlist_size, topk=topk, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method, max_zoom=max_zoom,
    )


def query_program_batch_framescale(
    vectors, valid, boxes, zoom, qvecs, excluded, frame_scale, *,
    shortlist_size: int, topk: int, aug_larger: str = "all",
    aug_weight: str = "level_max", agg_method: str = "avg_score", max_zoom: int = 8,
    plain: bool = False,
) -> QueryResult:
    """Batch query over an int8 matrix with per-frame scales (F,): the tile
    max is taken over the integer dots before dequantization (a max commutes
    with one positive scale a frame), then (fmax * qmax/127) * frame_scale,
    the JAX package's order. The shortlisted frames' tiles are rescored
    exactly (`rank_from_frame_max_batch`). On the card the dots are int32
    from `torch._int_mm`; the plain version (`plain`, or a CPU matrix) sums
    them in f32, where they are exact."""
    if vectors.dtype != torch.int8:
        raise ValueError(f"the frame-scale program needs int8 vectors (got {vectors.dtype})")
    F, T = valid.shape
    q_in, scale = _matmat_operands(vectors, qvecs, None)
    Q = q_in.shape[0]
    if plain or vectors.device.type == "cpu":
        acc, low = _f32_product(vectors, q_in.T), NEG_INF
    else:
        acc, low = _int8_product(vectors, q_in), -(2 ** 31) + 1
    fmax_i = acc.reshape(F, T, Q).masked_fill(~valid[:, :, None], low).amax(dim=1)  # (F, Q)
    fmax = (fmax_i.to(torch.float32) * scale[None, :]) * frame_scale[:, None]
    fmax = torch.where(excluded.T | ~valid.any(dim=1)[:, None], NEG_INF, fmax).T
    return rank_from_frame_max_batch(
        vectors, valid, boxes, zoom, qvecs, fmax, frame_scale,
        shortlist_size=shortlist_size, topk=topk, tile_bound=T, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method, max_zoom=max_zoom,
    )


def rank_from_frame_max_batch(
    vectors: torch.Tensor,  # (F*T, D)
    valid: torch.Tensor,  # (F, T)
    boxes: torch.Tensor,
    zoom: torch.Tensor,
    qvecs: torch.Tensor,  # (Q, D)
    fmax: torch.Tensor,  # (Q, F) per-frame max score, -inf = excluded
    frame_scale: torch.Tensor | None = None,  # (F,) int8 per-frame scales
    *,
    shortlist_size: int,
    topk: int,
    tile_bound: int,
    aug_larger: str = "all",
    aug_weight: str = "level_max",
    agg_method: str = "avg_score",
    max_zoom: int = 8,
) -> QueryResult:
    """`rank_from_frame_max` for Q queries at once, over an f32 / bf16
    matrix or an int8 one with per-frame scales: each query's shortlisted
    tiles are rescored against it in f32 (int8: exact integer dots,
    (acc * qmax/127) * frame scale, `scoring_matvec`'s order)."""
    T = tile_bound
    Q = qvecs.shape[0]
    short_scores, short_fids = topk_first(fmax, shortlist_size)  # (Q, S)
    short_valid = short_scores > NEG_INF
    rows = short_fids[..., None] * T + torch.arange(T, device=fmax.device)  # (Q, S, T)
    flat = rows.reshape(Q, -1)
    tile_valid = valid[short_fids] & short_valid[..., None]
    q_in, scale = _matmat_operands(vectors, qvecs, None)
    t_scores = torch.bmm(vectors[flat].to(torch.float32), q_in[:, :, None])[..., 0]
    if scale is not None:
        t_scores = t_scores * scale[:, None]
        if frame_scale is not None:
            t_scores = t_scores * frame_scale[short_fids].repeat_interleave(T, dim=-1)
    t_scores = torch.where(tile_valid, t_scores.reshape(rows.shape), NEG_INF)
    return _augment_and_topk(
        t_scores, boxes[rows], zoom[rows], tile_valid, short_fids, short_valid,
        topk=topk, shortlist_size=shortlist_size, aug_larger=aug_larger,
        aug_weight=aug_weight, agg_method=agg_method, max_zoom=max_zoom,
    )


def query_program_batch_incr(
    vectors, valid, boxes, zoom, qvecs, excluded, new_ids, row_scale=None, **kw,
) -> tuple[QueryResult, torch.Tensor]:
    """query_program_batch after merging each session's new exclusions
    (new_ids (Q, M), -1 padded); returns (results, updated (Q, F) masks)."""
    excluded = apply_new_exclusions(excluded, new_ids)
    return query_program_batch(
        vectors, valid, boxes, zoom, qvecs, excluded, row_scale, **kw), excluded


def query_program_batch_framescale_incr(
    vectors, valid, boxes, zoom, qvecs, excluded, new_ids, frame_scale, **kw,
) -> tuple[QueryResult, torch.Tensor]:
    """query_program_batch_framescale after merging each session's new
    exclusions; returns (results, updated (Q, F) masks)."""
    excluded = apply_new_exclusions(excluded, new_ids)
    return query_program_batch_framescale(
        vectors, valid, boxes, zoom, qvecs, excluded, frame_scale, **kw), excluded


def score_frames_max(vectors, valid, qvec, row_scale=None) -> torch.Tensor:
    """Max tile score per frame (no exclusion)."""
    F, T = valid.shape
    scores = scoring_matvec(vectors, qvec, row_scale)
    return torch.where(valid, scores.reshape(F, T), NEG_INF).amax(dim=1)


def score_vectors(vectors, qvec, row_scale=None) -> torch.Tensor:
    """Raw per-vector scores V @ q."""
    return scoring_matvec(vectors, qvec, row_scale)
