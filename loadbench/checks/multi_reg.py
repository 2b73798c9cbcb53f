"""`multi_reg` sessions: SeeSaw's own method, a query vector fitted to every
label so far over the kNN graph's Laplacian, then the scan and the ranking
tail.

The reference (`harness/multi_reg_reference.py`) symmetrises the raw kNN
lists itself at the configuration's `knn_k` and `edist` and sums X'LX over
the whole index in float64; for each replayed click it fits the vector from
the session's text vector and the labels given before the click (round 0:
none), scans the whole index with it (`reference.tile_scores`) and ranks the
frames under the session's exclusions. Reading: `rank_gap` (see
`harness/point.py`). The control fits, scans and ranks on rows, queries and
X'LX rounded to the precision below the configuration's.
"""
from __future__ import annotations

import torch

from loadbench.harness import multi_reg_reference as mr
from loadbench.harness import reference as ref

GROUP = 16  # fitted vectors scanned at once


def readings(ctx, sessions) -> dict:
    m = ctx.cfg["methods"]["multi_reg"]
    mo = m["matrix_options"]
    inputs, exact = ctx.inputs, ctx.precision == "exact"
    dst, dist = ctx.graph_raw
    k = int(mo["knn_k"])

    def form(precision):
        return mr.laplacian_form(inputs.V, inputs.row_scale, dst[:, :k], dist[:, :k],
                                 float(mo["edist"]), precision)

    A = form("exact")
    A_c = A if exact else form(ctx.precision)
    fitted, control, excluded, shown = [], [], [], []
    for s in sessions:
        q0 = torch.as_tensor(ctx.text_vector(s))
        frames, accepted = [], []
        for c in s.clicks:
            args = (frames, accepted, ctx.traffic["user_box"])
            fitted.append(mr.fit(*mr.labelled(inputs, *args), q0, A, m))
            if not exact:
                control.append(mr.fit(*mr.labelled(inputs, *args, ctx.precision), q0, A_c, m,
                                      ctx.precision))
            excluded.append(list(frames))
            shown.append(c.shown)
            frames += [int(x) for x in c.shown]
            accepted += [bool(a) for a in c.accepted]
    del A, A_c
    gaps = []
    for lo in range(0, len(fitted), GROUP):
        S = ref.tile_scores(inputs.V, inputs.row_scale, torch.stack(fitted[lo:lo + GROUP]))
        Sc = None if exact else ref.tile_scores(inputs.V, inputs.row_scale,
                                                torch.stack(control[lo:lo + GROUP]),
                                                ctx.precision)
        for i in range(S.shape[1]):
            excl = ctx.excluded(excluded[lo + i])
            got = shown[lo + i] if exact else ctx.ranker.rank(Sc[:, i], excl)[2].cpu().numpy()
            gaps.append(ref.rank_gap(ctx.ranker, S[:, i], excl, got))
        del S, Sc
    return {"rank_gap": max(gaps) if gaps else None}
