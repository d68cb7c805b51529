"""Reading a torch.profiler trace of a steady sub-window.

`Profiled` runs the profiler over a stretch of the run (CPU and CUDA
activities), exports the Chrome trace to a temporary file, reads it and
deletes it. The device's events are its kernels, copies and fills; busy
time is the length of the union of their intervals (a frozen copy of the
port's profile script's `busy_us`), and the idle gaps between them are
named by the host event that overlaps each most.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from typing import List, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "python_function",
             "user_annotation")


def busy_us(events) -> float:
    """Length of the union of [ts, ts + dur) over device events."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    total, end = 0.0, -float("inf")
    for a, b in spans:
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def gaps(events) -> List[Tuple[float, float]]:
    """The idle intervals between the union's pieces, [(start, end)]."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    out, end = [], None
    for a, b in spans:
        if end is not None and a > end:
            out.append((end, a))
        end = b if end is None else max(end, b)
    return out


class Profiled:
    """The profiler over a stretch of the run, from construction to
    `stop()` (which the caller calls after a synchronize); then `device`
    (device events), `host` (host events) and `wall_s` (host clock over
    the stretch)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        self.wall_s = time.perf_counter() - self._t0
        self._prof.stop()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as fh:
                ev = json.load(fh)["traceEvents"]
        finally:
            os.remove(path)
        self.device = [e for e in ev if e.get("cat") in DEVICE_CATS
                       and "dur" in e]
        self.host = [e for e in ev if e.get("cat") in HOST_CATS
                     and "dur" in e]

    def kernel_us(self, names) -> float:
        """Summed device time of the events whose names hold any of
        `names`."""
        return sum(e["dur"] for e in self.device
                   if any(n in e["name"] for n in names))

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time and the longest idle
        gaps, each named by the host event overlapping it most, in
        seconds."""
        per = {}
        for e in self.device:
            per[e["name"]] = per.get(e["name"], 0.0) + e["dur"]
        ops = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        idle = sorted(gaps(self.device), key=lambda g: g[0] - g[1])[:top]
        named = []
        for a, b in idle:
            best, over = "host: no event", 0.0
            for h in self.host:
                o = min(b, h["ts"] + h["dur"]) - max(a, h["ts"])
                if o > over:
                    best, over = h["name"], o
            named.append([best[:120], (b - a) / 1e6])
        return {"device_ops": [[n[:120], us / 1e6] for n, us in ops],
                "idle_gaps": named}
