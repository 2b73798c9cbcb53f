"""Session-log / user-study analysis.

The port's own copy of `seesaw_tpu/user_analysis.py`, the host-side
analogue of the reference's `seesaw/user_data_analysis.py:27-347`: load saved session
JSON trees, summarize each session from its action log, extract seen/accepted
timelines (with the study's 6-minute censoring convention), per-image view
times, and bootstrap confidence intervals for time-to-find-k — the data
behind the user-study figures (`figures/query_latency.R`).
"""
from __future__ import annotations

import glob
import json
import math
import os
from typing import List, Optional

import numpy as np
import pandas as pd

START_MESSAGE = "task.started"
END_MESSAGE = "task.end"
IMAGE_START_MESSAGE = "selection.start"
IMAGE_LOAD_MESSAGE = "image_loaded"
IMAGE_END_MESSAGE = "selection.end"
CENSOR_S = 60 * 6  # study sessions are censored at 6 minutes


def load_session_data(base_dir: str) -> List[dict]:
    """All summary.json files under base_dir, with their directory attached."""
    acc = []
    for path in sorted(glob.glob(base_dir + "/**/summary.json", recursive=True)):
        try:
            with open(path) as f:
                obj = json.load(f)
        except json.JSONDecodeError:
            obj = {}
        obj["session_path"] = path[: -len("summary.json")]
        acc.append(obj)
    return acc


def get_first_time(action_log: List[dict], message: str) -> Optional[float]:
    for ent in action_log:
        if ent["message"] == message:
            return ent["time"]
    return None


def get_session_summary(sess: dict) -> dict:
    session = sess["session"]
    action_log = session.get("action_log", [])
    params = session["params"]
    other_params = params.get("other_params") or {}

    task_started = None
    for msg in (START_MESSAGE, "set_text"):
        task_started = get_first_time(action_log, msg)
        if task_started is not None:
            break

    ans = {
        "session_path": sess.get("session_path"),
        "init_time": get_first_time(action_log, "init"),
        "task_started": task_started,
        "last_time": action_log[-1]["time"] if action_log else None,
        **other_params,
    }
    ans.setdefault("session_id", (params.get("other_params") or {}).get("session_id"))
    return ans


def get_session_summaries(sessions: List[dict], latest_only: bool = True) -> pd.DataFrame:
    df = pd.DataFrame([get_session_summary(s) for s in sessions])
    if latest_only and {"session_id", "qkey", "init_time"} <= set(df.columns):
        df = (
            df.sort_values("last_time", ascending=False)
            .groupby(["session_id", "qkey", "init_time"], dropna=False)
            .head(n=1)
            .reset_index(drop=True)
        )
    return df


def process_action_log(log: List[dict]) -> dict:
    """Timelines between task.started and task.end: cumulative seen/accepted
    vs elapsed time, plus per-image viewing durations keyed by the selection
    entries' other_fields."""
    start_entry = end_entry = None
    im_start_entry = None
    per_image_times: dict = {}
    seen_so_far = accepted_so_far = -1
    seen_timeline, accepted_timeline = [], []
    start_time = None

    for entry in log:
        if end_entry is not None:
            break
        if start_entry is None:
            if entry["message"] != START_MESSAGE:
                continue
            start_entry = entry
            start_time = entry["time"]

        msg = entry["message"]
        if msg == IMAGE_START_MESSAGE:
            im_start_entry = entry
        elif msg == IMAGE_END_MESSAGE and im_start_entry is not None:
            key = tuple((im_start_entry.get("other_fields") or {}).values())
            delta = entry["time"] - im_start_entry["time"]
            per_image_times[key] = per_image_times.get(key, 0.0) + delta
            im_start_entry = None
        elif msg == END_MESSAGE:
            end_entry = entry

        if len(per_image_times) > seen_so_far:
            seen_so_far = len(per_image_times)
            seen_timeline.append(
                {"seen": seen_so_far, "elapsed_time": entry["time"] - start_time}
            )
        if entry.get("accepted", 0) > accepted_so_far:
            accepted_so_far = entry["accepted"]
            accepted_timeline.append(
                {"accepted": accepted_so_far, "elapsed_time": entry["time"] - start_time}
            )

    return {
        "accepted_timeline": accepted_timeline,
        "seen_timeline": seen_timeline,
        "per_image_times": per_image_times,
        "start_entry": start_entry,
        "end_entry": end_entry,
    }


def image_view_timeline(sess: dict) -> "pd.DataFrame":
    """Per-image VIEW timeline from the frontend-recorded `Imdata.timing`
    intervals (reference `user_data_analysis.py:159-189` linear_gdata):
    one row per image with fine-grained start/end seconds relative to task
    start, accept flag, and the running accepted count — the input the
    user-study time-to-find analysis prefers over action-log granularity.
    Only the FIRST interval per image counts (reference semantics); images
    never opened in the detail view (no timing) are skipped."""
    from .basic_types import Imdata, is_image_accepted

    summary = get_session_summary(sess)
    session = sess["session"]
    task_started = summary.get("task_started") or 0.0

    rows = [dict(i=-1, j=-1, start_s=0.0, end_s=0.0, accepted=False)]
    for i, batch in enumerate(session.get("gdata", [])):
        for j, r in enumerate(batch):
            acc = is_image_accepted(Imdata(**r))
            for t in r.get("timing") or []:
                rows.append(dict(
                    i=i, j=j,
                    start_s=t["start_ms"] / 1000.0 - task_started,
                    end_s=t["end_ms"] / 1000.0 - task_started,
                    accepted=acc,
                ))
                break  # only the first interval per image
    df = pd.DataFrame(rows)
    df = df.sort_values("start_s").reset_index(drop=True)
    df = df.assign(total_accepted=df.accepted.cumsum())
    for k, v in summary.items():
        if np.isscalar(v) or v is None:
            df[k] = v
    return df


def process_session(sess: dict, filter_paths=None) -> List[dict]:
    summary = get_session_summary(sess)
    if filter_paths and os.path.normpath(summary["session_path"]) not in filter_paths:
        return []
    log_results = process_action_log(sess["session"].get("action_log", []))
    if not (log_results["start_entry"] and log_results["end_entry"]):
        return []
    summary["task_duration_s"] = (
        log_results["end_entry"]["time"] - log_results["start_entry"]["time"]
    )
    summary["total_images_accepted"] = log_results["end_entry"].get("accepted", 0)
    summary["total_images_seen"] = len(log_results["seen_timeline"])
    summary.update(log_results)
    return [summary]


def compute_session_tables(sessions: List[dict], filter_paths=None, max_accepted: int = 10) -> dict:
    """adf (one row per finished session), accept_df / seen_df (timeline rows
    tagged with session metadata; timed-out sessions censored at 6 min by
    padding accepted counts up to max_accepted)."""
    all_summaries = [
        s for sess in sessions for s in process_session(sess, filter_paths)
    ]
    adf = pd.DataFrame(all_summaries)
    accept_rows, seen_rows = [], []
    for s in all_summaries:
        duration = s["task_duration_s"]
        tags = {
            "session_id": s.get("session_id"),
            "qkey": s.get("qkey"),
            "mode": s.get("mode"),
            "session_path": s.get("session_path"),
            "duration": duration,
        }
        ent = None
        for ent_base in s["accepted_timeline"]:
            ent = {**ent_base, **tags}
            accept_rows.append(ent)
        if duration >= CENSOR_S and ent is not None:
            for i in range(ent["accepted"] + 1, max_accepted + 1):
                accept_rows.append({**ent, "accepted": i, "elapsed_time": CENSOR_S})
        for ent_base in s["seen_timeline"]:
            seen_rows.append({**ent_base, **tags})
    return {
        "adf": adf,
        "accept_df": pd.DataFrame(accept_rows),
        "seen_df": pd.DataFrame(seen_rows),
    }


def time_to_find_k_table(accept_df: pd.DataFrame, k: int) -> pd.DataFrame:
    """Per (qkey, mode): elapsed time at which the k-th accept happened, one
    row per session (censored sessions carry CENSOR_S)."""
    rows = accept_df[accept_df.accepted == k]
    return rows[["qkey", "mode", "session_id", "elapsed_time", "duration"]].reset_index(
        drop=True
    )


def bootstrap_stat(ser: pd.Series, confidence_level: float = 0.95, n_resamples: int = 10000,
                   seed: int = 0) -> pd.DataFrame:
    """Bootstrap CI of the median (the reference's user-study statistic)."""
    rng = np.random.default_rng(seed)
    vals = np.asarray(ser, dtype=float)
    samp = rng.choice(vals, size=(n_resamples, vals.shape[0]), replace=True)
    medians = np.median(samp, axis=1)
    q0 = (1 - confidence_level) / 2.0
    q1 = 1.0 - q0
    assert math.isclose(q1 - q0, confidence_level)
    lo, hi = np.quantile(medians, q=[q0, q1])
    return pd.DataFrame(
        [
            {
                "lower": lo,
                "med": float(np.median(vals)),
                "mean": float(vals.mean()),
                "high": hi,
                "confidence_level": confidence_level,
                "n": vals.shape[0],
            }
        ]
    )


def find_k_intervals(accept_df: pd.DataFrame, k: int = 10,
                     confidence_level: float = 0.95) -> pd.DataFrame:
    """Per-(qkey, mode) median time-to-find-k with bootstrap CI — the data
    behind the reference's find10_interval.parquet / query_latency figure."""
    t = time_to_find_k_table(accept_df, k)
    out = []
    for (qkey, mode), gp in t.groupby(["qkey", "mode"], dropna=False):
        stat = bootstrap_stat(gp.elapsed_time, confidence_level)
        stat.insert(0, "qkey", qkey)
        stat.insert(1, "mode", mode)
        out.append(stat)
    return pd.concat(out, ignore_index=True) if out else pd.DataFrame()
