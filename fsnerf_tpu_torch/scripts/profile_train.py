"""Where a training step's time goes on the card: trains `--warmup` steps of
the default config (or of hierarchical sampling, 64 + 128 samples; or of
SiNeRF) on a procedural scene (so the grid and the compaction K reach their
steady state), then profiles `--steps` more with torch.profiler.

    python -m fsnerf_tpu_torch.scripts.profile_train [--dataset lattice] \
        [--hw 800] [--warmup 1000] [--steps 30] [--out DIR] \
        [--strategy occgrid|hierarchical] [--model nerf|sinerf]

Prints the wall time per step of `--steps` steps without the profiler and
with it (the profiler's host-side tracing slows dispatch), the device's
busy time per step (the union of kernel and copy intervals in the trace)
and its idle share against the unprofiled wall time, the train kernels' and
the other kernels' device time per step, the grid-refresh steps inside the
profiled window (all cells before `warmup_steps`, one of `update_parts`
parts after) with the time of one refresh of each kind (CUDA events; none
under hierarchical, which never refreshes the grid), and writes the Chrome
trace to <out>/train_trace.json.gz.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
import itertools
import json
import os
import time

import torch

from .lattice_gate import card_name

_TRAIN_KERNELS = ("mlp_train_fwd_kernel", "mlp_train_bwd_rows_kernel",
                  "siren_fwd_", "siren_bwd_rows",  # both forwards, row passes
                  "dw_gemm_kernel", "dw_reduce_kernel")


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=["sphere", "lattice"],
                    default="lattice")
    ap.add_argument("--hw", type=int, default=800)
    ap.add_argument("--warmup", type=int, default=1000)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--out", default="chiprun_out")
    ap.add_argument("--strategy", choices=["occgrid", "hierarchical"],
                    default="occgrid")
    ap.add_argument("--model", choices=["nerf", "sinerf"], default="nerf")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from torch.profiler import ProfilerActivity, profile

    from ..cli import scene_class
    from ..config import Config, DataConfig, ModelConfig
    from ..core.models import make_model
    from ..data.pool import pool_from_images
    from ..train.loop import CompactionController, train
    from ..train.step import (GeneratorDraws, make_train_step,
                              maybe_update_grid, resolve_update_interval)

    dev = torch.device("cuda")
    cfg = Config(data=DataConfig(dataset=args.dataset, n_imgs=8,
                                 white_bkgd=True),
                 model=ModelConfig(model=args.model))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train,
                                                n_iters=args.warmup))
    hier = args.strategy == "hierarchical"
    if hier:
        cfg = cfg.replace(sampling=dataclasses.replace(
            cfg.sampling, strategy="hierarchical", n_samples=64, n_fine=128))
    scene = scene_class(args.dataset)(n_imgs=8, hw=args.hw)
    model = make_model(cfg, torch.bfloat16, torch.Generator().manual_seed(0),
                       dev)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=dev)
    state = train(model, cfg, pool, scene, log_every=100)
    # the ladder's K for the warmed-up grid's valid-sample count
    _, m = make_train_step(model, cfg, state.optimizer, pool, scene)(state)
    k = CompactionController(cfg).target(float(m["n_valid_mean"]))
    step_cfg = cfg.replace(sampling=dataclasses.replace(cfg.sampling,
                                                        n_compact=k))
    step = make_train_step(model, step_cfg, state.optimizer, pool, scene)
    for _ in range(5):
        state, m = step(state)

    def timed_steps():
        nonlocal state, m
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            state, m = step(state)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / args.steps

    def refresh_ms(at_step):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        draws = GeneratorDraws(state.generator)
        maybe_update_grid(model, cfg, state.grid, at_step, draws, dev)
        torch.cuda.synchronize()
        a.record()
        maybe_update_grid(model, cfg, state.grid, at_step, draws, dev)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    wall_ms = timed_steps()
    s_cfg, first = cfg.sampling, state.step
    window = range(first, first + args.steps)
    refreshes = [] if hier else [
        (k, "all" if k < s_cfg.warmup_steps else "part")
        for k in window if k % resolve_update_interval(s_cfg, k) == 0]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        profiled_ms = timed_steps()
    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "train_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fh:
        trace = json.load(fh)
    with gzip.open(path + ".gz", "wt") as fh:
        json.dump(trace, fh)
    os.remove(path)
    dev_events = [e for e in trace["traceEvents"]
                  if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
                  and "dur" in e]
    per_kernel = {}
    for e in dev_events:
        per_kernel[e["name"]] = per_kernel.get(e["name"], 0.0) + e["dur"]
    n = args.steps
    busy = busy_us(dev_events) / 1e3 / n
    ours = {k: v / 1e3 / n for k, v in per_kernel.items()
            if any(t in k for t in _TRAIN_KERNELS)}
    others = sorted(((v / 1e3 / n, k) for k, v in per_kernel.items()
                     if not any(t in k for t in _TRAIN_KERNELS)),
                    reverse=True)
    launches = sum(1 for e in dev_events if e.get("cat") == "kernel") / n
    print(json.dumps({
        "card": card_name(), "dataset": args.dataset, "hw": args.hw,
        "strategy": args.strategy, "model": args.model,
        "warmup_steps": args.warmup, "profiled_steps": n,
        "n_compact": step_cfg.sampling.n_compact,
        "n_valid_mean": float(m["n_valid_mean"]),
        "wall_ms_per_step": wall_ms, "profiled_wall_ms_per_step": profiled_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": 1.0 - busy / wall_ms,
        "train_kernels_ms_per_step": sum(ours.values()),
        "device_kernels_per_step": launches,
        "profiled_steps_from": first,
        "refreshes_in_window": refreshes,
        "refresh_all_cells_ms": None if hier else refresh_ms(0),
        "refresh_one_part_ms": None if hier else refresh_ms(next(
            k for k in itertools.count(s_cfg.warmup_steps)
            if k % resolve_update_interval(s_cfg, k) == 0))}))
    for k, v in sorted(ours.items(), key=lambda kv: -kv[1]):
        print(f"  {v:8.4f} ms/step  {k[:110]}")
    print("  other device work, top 15:")
    for v, k in others[:15]:
        print(f"  {v:8.4f} ms/step  {k[:110]}")
    print(f"  other device work in all (the above included): "
          f"{len(others)} kernel names, "
          f"{sum(v for v, _ in others):.4f} ms/step")


if __name__ == "__main__":
    main()
