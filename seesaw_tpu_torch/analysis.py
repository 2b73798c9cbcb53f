"""Benchmark/session analysis: metrics frames, method comparisons, timing.

The port's own copy of `seesaw_tpu/analysis.py`, over the port's
`basic_types` and `metrics`. Covers the reference's analysis layer
(`figures.py:79-229`, `user_data_analysis.py:27-247`) minus plotting:
per-session ranking metrics from bench summaries, side-by-side method
pivots with better/same/worse counts, and action-log timing extraction for
user sessions.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import pandas as pd

from .basic_types import SessionState
from .metrics import compute_metrics


def add_metrics(summary_df: pd.DataFrame) -> pd.DataFrame:
    """Attach AP/nDCG/ranks to a bench summary frame (one row per session,
    as produced by bench.harness.get_all_session_summaries)."""
    rows = []
    for _, r in summary_df.iterrows():
        if not r.get("has_result", False) or r.get("ntotal", 0) == 0:
            rows.append({})
            continue
        m = compute_metrics(
            hit_indices=np.asarray(r["hit_indices"]),
            batch_size=r.get("batch_size", 1),
            nseen=int(r["nseen"]),
            ntotal=int(r["ntotal"]),
            max_results=r.get("max_results"),
        )
        rows.append(m)
    return pd.concat([summary_df.reset_index(drop=True), pd.DataFrame(rows)], axis=1)


def side_by_side(
    metrics_df: pd.DataFrame,
    metric: str,
    variant_col: str = "variant",
    key_cols: List[str] = ("dataset", "category"),
) -> pd.DataFrame:
    """Pivot: one row per (dataset, category), one column per variant."""
    return metrics_df.pivot_table(
        index=list(key_cols), columns=variant_col, values=metric, aggfunc="mean"
    )


def better_same_worse(
    metrics_df: pd.DataFrame,
    metric: str,
    baseline: str,
    other: str,
    tol: float = 1e-6,
    variant_col: str = "variant",
    key_cols: List[str] = ("dataset", "category"),
) -> dict:
    """Per-query win/tie/loss counts of `other` vs `baseline` (reference
    `figures.py:79-229` comparison tables)."""
    piv = side_by_side(metrics_df, metric, variant_col, key_cols)
    both = piv[[baseline, other]].dropna()
    diff = both[other] - both[baseline]
    return {
        "better": int((diff > tol).sum()),
        "same": int((diff.abs() <= tol).sum()),
        "worse": int((diff < -tol).sum()),
        "mean_delta": float(diff.mean()) if len(diff) else float("nan"),
        "n": int(len(diff)),
    }


def method_means(metrics_df: pd.DataFrame, metrics: List[str] = ("reciprocal_rank", "ndcg_score", "average_precision"),
                 variant_col: str = "variant") -> pd.DataFrame:
    """Mean metric per method over all sessions (the reference's sweep table)."""
    return metrics_df.groupby(variant_col)[list(metrics)].mean()


def side_by_side_comparison(
    stats: pd.DataFrame, *, baseline_variant: str, metric: str
) -> pd.DataFrame:
    """Long-form merge of every variant's per-query metric against a baseline
    variant, with ratio/delta columns (reference `figures.py:201-227`)."""
    v1 = stats[["dataset", "category", "variant", metric]].copy()
    v2 = (
        stats[stats.variant == baseline_variant][["dataset", "category", metric]]
        .rename(columns={metric: "base"})
    )
    sbs = v1.merge(v2, on=["dataset", "category"], how="left")
    return sbs.assign(ratio=sbs[metric] / sbs.base, delta=sbs[metric] - sbs.base)


def bsw_table(sbs: pd.DataFrame, *, variant: str, metric: str, reltol: float) -> pd.DataFrame:
    """Per-dataset better/same/worse counts of variant vs baseline at a
    relative tolerance (reference `figures.py:229-246`)."""
    invtol = 1.0 / reltol
    rows = sbs[sbs.variant == variant].assign(
        better=lambda d: d[metric] > reltol * d.base,
        worse=lambda d: d[metric] < invtol * d.base,
        same=lambda d: d[metric].between(invtol * d.base, reltol * d.base),
    )
    bsw = rows.groupby("dataset")[["better", "same", "worse"]].sum()
    bsw = bsw.assign(total=bsw.sum(axis=1))
    return pd.concat([bsw, bsw.sum().rename("total").to_frame().T])


def summary_breakdown(sbs: pd.DataFrame, metric: str) -> pd.DataFrame:
    """Mean metric per variant, split by baseline-difficulty bucket
    ('.1' hard < 0.1 < '.3' < 0.3 < '1.'), with per-bucket query counts —
    the paper's breakdown table (reference `figures.py:248-283`)."""
    part = sbs.base.map(lambda x: "1." if x > 0.3 else ".3" if x > 0.1 else ".1")
    sbs = sbs.assign(part=part)
    totals = (
        sbs.groupby(["part", "dataset", "variant"])[metric].mean().reset_index()
        .groupby(["part", "variant"])[metric].mean().unstack(level=0)
    )
    counts = (
        sbs.groupby(["part", "dataset", "variant"]).size().rename("cats").reset_index()
        .groupby(["part", "variant"]).cats.sum().unstack(level=0)
    )
    example_variant = sbs.variant.iloc[0]
    tr = totals.transpose()
    tr = tr.assign(counts=counts.transpose()[example_variant])
    return tr[["counts"] + [c for c in tr.columns if c != "counts"]].transpose()


def comparison_table(tot_res: pd.DataFrame, *, variant: str, baseline_variant: str) -> pd.DataFrame:
    """baseline vs this-work vs ratio rows over the breakdown buckets
    (reference `figures.py:298-309`)."""
    t = tot_res.transpose()
    t = t.assign(ratio=t[variant] / t[baseline_variant])
    t = t[["counts", baseline_variant, variant, "ratio"]].rename(
        columns={baseline_variant: "baseline", variant: "this work"}
    )
    return t.transpose()


def ablation_table(tot_res: pd.DataFrame, variants_list: List[str]) -> pd.DataFrame:
    """Stacked-ablation rows (semantic embedding -> + multiscale -> +
    feedback fusion) with per-bucket deltas (reference `figures.py:311-345`)."""
    base, inter, sys_ = variants_list
    t = tot_res.transpose()[[base, inter, sys_]].rename(
        columns={
            base: "semantic embedding",
            inter: "+ multiscale search",
            sys_: "+ feedback fusion",
        }
    ).transpose()
    deltas = t.diff().iloc[1:].rename(columns=lambda c: f"{c} delta")
    merged = pd.concat([t, deltas], axis=1)
    cols = []
    for c in t.columns:
        cols.append(c)
        if f"{c} delta" in merged.columns:
            cols.append(f"{c} delta")
    return merged[cols]


def rel_plot(sbs: pd.DataFrame, *, variant: str, metric: str, out_path: str,
             jitter: float = 0.01, seed: int = 0):
    """Scatter of per-query baseline vs variant metric on log-log axes with
    the y=x diagonal — the paper's comparison plot (reference
    `figures.py:437-513`), matplotlib instead of bokeh. Saves to out_path."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = sbs[sbs.variant == variant].dropna(subset=["base", metric])
    rng = np.random.default_rng(seed)
    x = rows.base.values * (1 + rng.uniform(-jitter, jitter, len(rows)))
    y = rows[metric].values * (1 + rng.uniform(-jitter, jitter, len(rows)))
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.scatter(x, y, s=12, alpha=0.6)
    lims = [min(x.min(initial=1e-3), y.min(initial=1e-3)) * 0.8, 1.1]
    ax.plot(lims, lims, "k--", lw=1)
    ax.set_xscale("log")
    ax.set_yscale("log")
    ax.set_xlabel(f"baseline {metric}")
    ax.set_ylabel(f"{variant} {metric}")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


# -- action-log timing ------------------------------------------------------
def action_log_frame(state: SessionState) -> pd.DataFrame:
    """Flatten a session's action log into a frame with per-event deltas."""
    rows = [
        dict(logger=e.logger, message=e.message, time=e.time, seen=e.seen,
             accepted=e.accepted)
        for e in state.action_log
    ]
    df = pd.DataFrame(rows)
    if len(df):
        df = df.sort_values("time").reset_index(drop=True)
        df["delta"] = df["time"].diff().fillna(0.0)
    return df


def phase_durations(state: SessionState) -> pd.DataFrame:
    """Durations of matched start/end phases (next.start->next.end,
    refine.start->refine.end)."""
    df = action_log_frame(state)
    out = []
    for phase in ("next", "refine"):
        starts = df[df.message == f"{phase}.start"].time.values
        ends = df[df.message == f"{phase}.end"].time.values
        n = min(len(starts), len(ends))
        for s, e in zip(starts[:n], ends[:n]):
            out.append(dict(phase=phase, start=s, duration=e - s))
    return pd.DataFrame(out)


def accept_timeline(state: SessionState) -> pd.DataFrame:
    """Cumulative accepted count over server events — time-to-find-k data
    (reference user-study analysis)."""
    df = action_log_frame(state)
    if not len(df):
        return df
    t0 = df.time.iloc[0]
    return pd.DataFrame(
        dict(elapsed=df.time - t0, accepted=df.accepted, seen=df.seen)
    )


def time_to_find_k(state: SessionState, k: int) -> Optional[float]:
    tl = accept_timeline(state)
    if not len(tl):
        return None
    hit = tl[tl.accepted >= k]
    return float(hit.elapsed.iloc[0]) if len(hit) else None
