"""Profiling and tracing hooks (port of fsnerf_tpu/utils/profiling.py).

  * trace(): context manager capturing a torch.profiler trace (host and
    device timelines) into a directory, as a Chrome trace.
  * Throughput: wall-clock rays/sec and steps/sec counter with a warmup
    skip.
  * log_compile_time(): one-off helper timing a callable's first call
    against its steady state. The port compiles nothing when it runs: what
    a first call pays for on the card is the CUDA graph captures of a
    graphed train chunk (train/step.py::StepGraph.capture_s has each
    graph's own seconds).

The JAX package's enable_compilation_cache has no counterpart: the port
has no compiled programs to cache (its kernels are built once by
ops/kernels/build.py, and a CUDA graph lives only in its process).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Optional

import torch


def _sync() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block with torch.profiler (CPU activity, and the card's
    where there is one) and write <log_dir>/trace.json, viewable in
    Perfetto or chrome://tracing. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class Throughput:
    """Rolling rays/sec and steps/sec counter.

    Usage:
        tp = Throughput(batch_size=1024, warmup_steps=10)
        for ...: train_step(); tp.tick()
        print(tp.summary())

    The host clock measures what was enqueued unless the caller
    synchronizes: tick after work that waits on the device, or read the
    summary after torch.cuda.synchronize().
    """

    def __init__(self, batch_size: int, warmup_steps: int = 10):
        self.batch_size = batch_size
        self.warmup_steps = warmup_steps
        self.steps = 0
        self._t0: Optional[float] = None

    def tick(self, n_steps: int = 1) -> None:
        self.steps += n_steps
        if self._t0 is None and self.steps >= self.warmup_steps:
            self._t0 = time.perf_counter()
            self._steps_at_t0 = self.steps

    @property
    def counted_steps(self) -> int:
        return 0 if self._t0 is None else self.steps - self._steps_at_t0

    def summary(self) -> dict:
        if self._t0 is None or self.counted_steps == 0:
            return {"steps_per_sec": 0.0, "rays_per_sec": 0.0}
        dt = time.perf_counter() - self._t0
        sps = self.counted_steps / dt
        return {"steps_per_sec": sps, "rays_per_sec": sps * self.batch_size}


def log_compile_time(fn: Callable, *args) -> dict:
    """(compile_s, steady_s): the seconds of fn's first call and of a
    second one, each ended by a device synchronize. On the card the first
    call of a graphed chunk captures its graphs."""
    t0 = time.perf_counter()
    fn(*args)
    _sync()
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn(*args)
    _sync()
    steady_s = time.perf_counter() - t0
    return {"compile_s": compile_s, "steady_s": steady_s}
