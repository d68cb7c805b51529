"""The program's own spans and counters beside a traced stretch.

The port records them in `fsnerf_tpu_torch.utils.profiling`: while a torch
profiler runs, each `train.step` span (one a training step, its attrs step,
k, refresh, hold, weight_reg and mode) is kept in memory and opens a
`user_annotation` of the same name in the profiler's trace; the counters
(`rows_computed`, `rows_valid`, `capture_s`, ...) are snapshotted at each
log boundary before the logger, whose hook starts and stops the harness's
profiler, sees it. So the last snapshot before the profiler started and the
last one before it stopped bracket the traced stretch, and the i-th
`train.step` annotation of the trace is the i-th `train.step` span recorded
between them.

A step's device events are found by each event's `correlation` arg: the
runtime call that launched it (for a replay, the `cudaGraphLaunch`) lies
inside the step's annotation on the trace's clock. Where that leaves a
step with no event (a trace that links graph kernels to no launch), every
device event goes to the latest step whose annotation began before it
(stream order).

Every reader here returns None where the program keeps no such record
(`record` missing) or the pairing fails.
"""

from __future__ import annotations

import bisect
from typing import List, Optional

from .trace import busy_us

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def program_record() -> Optional[dict]:
    """fsnerf_tpu_torch.utils.profiling.record(), or None where the
    program has no such function."""
    try:
        from fsnerf_tpu_torch.utils import profiling
    except ImportError:
        return None
    record = getattr(profiling, "record", None)
    return record() if callable(record) else None


def bracket(prof, rec: dict):
    """(first, last): the counter snapshots that bracket the stretch `prof`
    traced, or None."""
    t0_ns = prof._t0 * 1e9
    t1_ns = (prof._t0 + prof.wall_s) * 1e9
    before = [s for s in rec["snapshots"] if s["t_ns"] <= t0_ns]
    inside = [s for s in rec["snapshots"] if t0_ns < s["t_ns"] <= t1_ns]
    if not before or not inside:
        return None
    return before[-1], inside[-1]


def step_spans(prof, rec: dict):
    """[(span, annotation)] of the stretch's train.step spans, paired in
    order with the trace's train.step annotations; None where the counts
    differ or nothing was recorded."""
    ends = bracket(prof, rec)
    if ends is None:
        return None
    a, b = ends[0]["t_ns"], ends[1]["t_ns"]
    spans = sorted((s for s in rec["spans"]
                    if s["name"] == "train.step" and a <= s["t0_ns"] <= b),
                   key=lambda s: s["t0_ns"])
    notes = sorted((e for e in prof.host if e.get("cat") == "user_annotation"
                    and e["name"] == "train.step"), key=lambda e: e["ts"])
    if not spans or len(spans) != len(notes):
        return None
    return list(zip(spans, notes))


def attribute(device: List[dict], host: List[dict], notes: List[dict]):
    """(how, per-step device events): each device event given to the step
    annotation (of `notes`, sorted) inside which its launch lies
    ("correlation"), or where that leaves a step with none, to the latest
    step begun before it ("stream order"); (None, None) where a step still
    has none."""
    starts = [n["ts"] for n in notes]
    ends = [n["ts"] + n["dur"] for n in notes]
    launched = {e["args"]["correlation"]: e["ts"] for e in host
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    per = [[] for _ in notes]
    for e in device:
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t < ends[i]:
            per[i].append(e)
    if all(per):
        return "correlation", per
    per = [[] for _ in notes]
    for e in device:
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0:
            per[i].append(e)
    if all(per):
        return "stream order", per
    return None, None


def steps(ctx: dict):
    """(how, [(attrs, device events)]) of the traced stretch's steps, or
    None."""
    if ctx.get("kind") != "train":
        return None
    rec = program_record()
    if rec is None:
        return None
    pairs = step_spans(ctx["prof"], rec)
    if pairs is None:
        return None
    how, per = attribute(ctx["prof"].device, ctx["prof"].host,
                         [n for _, n in pairs])
    if how is None:
        return None
    return how, [(s["attrs"], evs) for (s, _), evs in zip(pairs, per)]


def busy_within(device: List[dict], a: float, b: float) -> float:
    """Device busy time (the union of the events) inside [a, b)."""
    clipped = [{"ts": max(e["ts"], a),
                "dur": min(e["ts"] + e["dur"], b) - max(e["ts"], a)}
               for e in device if e["ts"] < b and e["ts"] + e["dur"] > a]
    return busy_us(clipped)


def union(intervals) -> List[tuple]:
    """The union of [a, b) intervals, as sorted disjoint pieces."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out
