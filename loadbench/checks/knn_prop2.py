"""`knn_prop2` sessions: ranking by labels propagated over the kNN graph.

The reference symmetrises the raw kNN lists itself at the configuration's
`knn_k` and `edist`, makes each session's prior from its own scan of the
text vector, and for each replayed click propagates every label given so
far (once any tile is labelled negative, as the method does; before that the
prior ranks) and ranks the frames under the session's exclusions.
Readings: `rank_gap` (see `harness/point.py`) and `prop_err`, the largest
difference over all rows between the program's scores after a session's
last click and the reference's, taken against the reference's answer and
the iterates a step before and after it (the stopping rule can land a step
apart in f32 and f64).
"""
from __future__ import annotations

import torch

from loadbench.harness import reference as ref


def readings(ctx, sessions) -> dict:
    m = ctx.cfg["methods"]["knn_prop2"]
    prop = ctx.cfg["propagation"]
    exact = ctx.precision == "exact"
    inputs = ctx.inputs
    dst, dist = ctx.graph_raw
    graph = ref.Graph(dst[:, :m["matrix_options"]["knn_k"]], dist[:, :m["matrix_options"]["knn_k"]],
                      float(m["matrix_options"]["edist"]))
    n = inputs.n
    dev = inputs.V.device
    run = dict(lam=float(m["prior_weight"]), eps=float(prop["epsilon"]),
               max_iter=int(prop["max_iter"]))

    def prior(q, precision):
        s = ref.tile_scores(inputs.V, inputs.row_scale, q[None], precision)[:, 0]
        return ref.prior(s, m["normalize_epsilon"], m["calib_a"], m["calib_b"])

    gaps, errs = [], []
    for s in sessions:
        q0 = torch.as_tensor(ctx.text_vector(s))
        pri = prior(q0, "exact")
        pri_c = pri if exact else prior(q0, ctx.precision)
        lab = torch.zeros(n, dtype=ref.F64, device=dev)
        is_lab = torch.zeros(n, dtype=torch.bool, device=dev)
        negatives, before = False, []
        near = answer = None
        for c in s.clicks:
            excl = ctx.excluded(before)
            if negatives:
                near, scores, _ = ref.propagate(graph, pri, lab, is_lab, **run)
            else:
                near, scores = None, pri
            if exact:
                got, answer = c.shown, None
            else:
                answer = (ref.propagate(graph, pri_c, lab, is_lab, dtype=torch.bfloat16, **run)[1]
                          if negatives else pri_c)
                got = ctx.ranker.rank(answer, excl)[2].cpu().numpy()
            gaps.append(ref.rank_gap(ctx.ranker, scores, excl, got))
            pos, neg = ref.labelled_rows(c.shown, c.accepted, inputs.tile_boxes,
                                         ctx.traffic["user_box"])
            if len(pos):
                lab[torch.as_tensor(pos, device=dev)] = 1.0
            if len(neg):
                lab[torch.as_tensor(neg, device=dev)] = 0.0
                negatives = True
            is_lab[torch.as_tensor(list(pos) + list(neg), dtype=torch.int64, device=dev)] = True
            before += [int(x) for x in c.shown]
        final = s.final_scores if exact else answer
        if near is not None and final is not None:
            final = final.to(ref.F64)
            errs.append(min(float((final - h).abs().max()) for h in near))
    return {"rank_gap": max(gaps) if gaps else None, "prop_err": max(errs) if errs else None}
