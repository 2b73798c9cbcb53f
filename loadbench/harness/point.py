"""The check of the point-based loops (`plain`, `rocchio_update`): each
click's query vector, the scan and the ranking tail.

For each replayed click the reference works out the query (the session's
text vector, or for Rocchio the update of it by the labels given so far),
scans the whole index with it and ranks the frames under the session's
exclusions. Readings: `rank_gap`, the largest shortfall of a shown frame
against the reference's choice in units of the mean step between its
shortlisted frames; for Rocchio `qvec_err`, the largest difference between
the query the program ran and the reference's, relative to the largest
entry of the reference's.
"""
from __future__ import annotations

import torch

from . import reference as ref

GROUP = 16  # queries scanned at once


def readings(ctx, sessions, rocchio: dict | None = None) -> dict:
    inputs, exact = ctx.inputs, ctx.precision == "exact"
    V, scale = inputs.V, inputs.row_scale
    user_box = ctx.traffic["user_box"]
    queries, control_q, excluded, shown, qerr = [], [], [], [], []
    for s in sessions:
        q0 = ctx.text_vector(s)
        before, frames, accepted = [], [], []
        for c in s.clicks:
            q, qc = torch.as_tensor(q0, dtype=ref.F64), None
            if rocchio is not None and c.k > 0:
                pos, neg = ref.labelled_rows(frames, accepted, inputs.tile_boxes, user_box)
                args = (q0, V, scale, pos, neg, rocchio["rocchio_alpha"],
                        rocchio["rocchio_beta"], rocchio["rocchio_gamma"])
                q = ref.rocchio(*args).cpu()
                got = (torch.as_tensor(c.qvec, dtype=ref.F64) if exact
                       else ref.rocchio(*args, precision=ctx.precision).cpu())
                qerr.append(float((got - q).abs().max() / q.abs().max()))
                qc = got
            elif rocchio is not None:
                got = torch.as_tensor(c.qvec, dtype=ref.F64) if exact else q
                qerr.append(float((got - q).abs().max() / q.abs().max()))
            queries.append(q)
            control_q.append(q if qc is None else qc)
            excluded.append(list(before))
            shown.append(c.shown)
            before += [int(x) for x in c.shown]
            frames += [int(x) for x in c.shown]
            accepted += [bool(a) for a in c.accepted]
    gaps = []
    for lo in range(0, len(queries), GROUP):
        Q = torch.stack(queries[lo:lo + GROUP])
        S = ref.tile_scores(V, scale, Q)
        Sc = None if exact else ref.tile_scores(V, scale, torch.stack(control_q[lo:lo + GROUP]),
                                                ctx.precision)
        for i in range(Q.shape[0]):
            excl = ctx.excluded(excluded[lo + i])
            got = shown[lo + i] if exact else ctx.ranker.rank(Sc[:, i], excl)[2].cpu().numpy()
            gaps.append(ref.rank_gap(ctx.ranker, S[:, i], excl, got))
        del S, Sc
    out = {"rank_gap": max(gaps) if gaps else None}
    if rocchio is not None:
        out["qvec_err"] = max(qerr) if qerr else None
    return out
