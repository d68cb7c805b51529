"""Tracing and profiling of the port (port of fsnerf_tpu/utils/profiling.py).

  * span(name, **attrs): a context manager around a stretch of host code.
    Off (the default) it is one check and a shared null context. It is on
    while a torch profiler records, or inside recording(): it then keeps
    {id, parent, name, attrs, t0_ns, t1_ns} (time.perf_counter_ns, taken
    outside the annotation's own enter and exit) in a bounded ring, and
    opens torch.profiler.record_function(name), so every span is a
    `user_annotation` event of the profiler's trace, on the clock the
    device events share. The trace's annotations carry only the name:
    a reader pairs them, in order, with the spans of that name that
    record() holds for the same stretch.
  * Counters, always on, plain host numbers changed by host arithmetic at a
    step's dispatch, a capture or a log boundary: `rows_computed` (MLP rows
    the train steps compute), `rows_valid` (the rows among them that carry
    a sample, read from the state's device accumulator where the loop
    already waits on the card), `captures` and `capture_s` (each CUDA-graph
    capture's seconds) and `warmup_steps` (the eager first step of each
    kind on the card).
  * snapshot(step, k): the counters at a log boundary of train(), taken
    before the logger sees it, into a bounded ring.
  * record(): the spans, the snapshots and the counters.
  * trace(log_dir): a torch.profiler trace of the block into
    <log_dir>/trace.json and its spans and snapshots into
    <log_dir>/spans.jsonl.

The spans the loop and the step open: `train.step` (train/step.py::
TrainStep.replay and __call__; attrs step, k, refresh, hold, weight_reg,
mode) and `train.boundary` (train/loop.py::train; attrs step, ladder,
swap, log).

Do not stop one profiler and start another inside a span: torch ends the
span's annotation under the second session, in memory the first one
freed. The loop therefore calls its caller's hooks (the logger, which may
drive a profiler, validation, checkpoints) outside its spans.

The JAX package's enable_compilation_cache has no counterpart: the port
has no compiled programs to cache (its kernels are built once by
ops/kernels/build.py, and a CUDA graph lives only in its process).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import time

import torch

SPAN_RING = 65_536          # spans kept; the oldest are dropped and counted
SNAPSHOT_RING = 4_096       # counter snapshots kept
CAPTURE_RING = 4_096        # capture seconds kept

_profiler_enabled = torch._C._autograd._profiler_enabled

# the first record_function of a process resolves its operators (~1 ms):
# done here, with no profiler, so that no span pays it
with torch.profiler.record_function("fsnerf.profiling.warm"):
    pass


class _State:
    def __init__(self, ring: int):
        self.spans = collections.deque(maxlen=ring)
        self.dropped = 0
        self.snapshots = collections.deque(maxlen=SNAPSHOT_RING)
        self.counters = {"rows_computed": 0, "rows_valid": 0.0,
                         "captures": 0,
                         "capture_s": collections.deque(maxlen=CAPTURE_RING),
                         "warmup_steps": 0}
        self.stack = []         # ids of the open spans
        self.ids = itertools.count(1)
        self.switch = 0         # recording() depth


_S = _State(SPAN_RING)


class _NullSpan:
    """The span when tracing is off: enters and exits, records nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "attrs", "id", "parent", "t0", "_rf")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def set(self, **attrs) -> None:
        """Add attributes found out inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        self.id = next(_S.ids)
        self.parent = _S.stack[-1] if _S.stack else None
        _S.stack.append(self.id)
        self.t0 = time.perf_counter_ns()
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._rf.__exit__(*exc)
        finally:
            t1 = time.perf_counter_ns()
            _S.stack.pop()
            if len(_S.spans) == _S.spans.maxlen:
                _S.dropped += 1
            _S.spans.append({"id": self.id, "parent": self.parent,
                             "name": self.name, "attrs": self.attrs,
                             "t0_ns": self.t0, "t1_ns": t1})
        return False


def span(name: str, **attrs):
    """A span around the block (see the module's docstring); `as s` gives
    an object whose set(**attrs) adds attributes inside the block."""
    if not (_S.switch or _profiler_enabled()):
        return _NULL
    return _Span(name, attrs)


@contextlib.contextmanager
def recording():
    """Record spans inside the block without a profiler (they open no
    annotation that any trace keeps)."""
    _S.switch += 1
    try:
        yield
    finally:
        _S.switch -= 1


def count(name: str, n=1) -> None:
    """Add n to the counter `name`."""
    _S.counters[name] += n


def count_capture(seconds: float) -> None:
    """One CUDA-graph capture of `seconds`."""
    _S.counters["captures"] += 1
    _S.counters["capture_s"].append(seconds)


def counters() -> dict:
    """The counters now (capture_s as a list)."""
    c = dict(_S.counters)
    c["capture_s"] = list(c["capture_s"])
    return c


def snapshot(step: int, k: int) -> None:
    """Keep the counters at a log boundary: step, the ladder's K."""
    c = dict(_S.counters)
    del c["capture_s"]
    _S.snapshots.append({"t_ns": time.perf_counter_ns(), "step": int(step),
                         "k": int(k), "counters": c})


def record() -> dict:
    """{spans, dropped, snapshots, counters}: the spans the ring holds
    (oldest first), how many it dropped, the counter snapshots and the
    counters now."""
    return {"spans": list(_S.spans), "dropped": _S.dropped,
            "snapshots": list(_S.snapshots), "counters": counters()}


def reset(ring: int = SPAN_RING) -> None:
    """Forget every span, snapshot and count; keep `ring` spans from now."""
    global _S
    _S = _State(ring)


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU activity, and the card's
    where there is one) and write <log_dir>/trace.json, viewable in
    Perfetto or chrome://tracing, and <log_dir>/spans.jsonl: one JSON
    object a line, each span and snapshot taken in the block ("type"
    "span" or "snapshot"), then the counters ("type" "counters"). Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    t0 = time.perf_counter_ns()
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    rec = record()
    with open(os.path.join(log_dir, "spans.jsonl"), "w") as fh:
        for s in rec["spans"]:
            if s["t0_ns"] >= t0:
                fh.write(json.dumps({"type": "span", **s}) + "\n")
        for s in rec["snapshots"]:
            if s["t_ns"] >= t0:
                fh.write(json.dumps({"type": "snapshot", **s}) + "\n")
        fh.write(json.dumps({"type": "counters", "dropped": rec["dropped"],
                             **rec["counters"]}) + "\n")
