"""Where a training step's time goes on the card, graphed and eager: trains
to step `--warmup` of the default config (or of hierarchical sampling,
64 + 128 samples; or of SiNeRF) on a procedural scene with train() (so the
grid and the compaction K reach their steady state), then runs the window
of `--steps` steps from there again and again from one saved state: by
CUDA-graph replays (make_train_chunk, train()'s path on the card) and by
eager steps (the loop the replays are bitwise equal to), in turns, eager,
graphed, graphed, eager for each of `--pairs` pairs.

    python -m fsnerf_tpu_torch.scripts.profile_train [--dataset lattice] \
        [--hw 800] [--warmup 1070] [--steps 64] [--pairs 2] [--out DIR] \
        [--strategy occgrid|hierarchical] [--model nerf|sinerf]

Each run restores the saved state in place (weights, Adam's moments, the
grid, the generator, both step counters), so every run does the same work
(its last loss is printed and must agree bitwise across runs), and times
the window twice: without the profiler (the wall time per step, and the
host's ms per step to enqueue it, before the synchronize) and under
torch.profiler (the device's busy time per step, the union of kernel and
copy intervals in the trace, its idle share against the unprofiled wall,
kernels and graph launches per step, the train kernels' and the other
device work's ms per step). Before the turns the graphed window runs twice
untimed, so every step kind in it has had its eager warm-up and its
capture. Also prints the grid-refresh steps inside the window (all cells
before `warmup_steps`, one of `update_parts` parts after), the capture
seconds of each graph and the peak device memory (allocated, and reserved,
which counts the graphs' pools), then times one all-cell
and one part refresh with CUDA events (none under hierarchical, which
never refreshes the grid), lists the device records (kernels, copies,
memsets, by name) whose count per step differs between the last graphed
and the last eager run, and writes the last graphed run's Chrome trace to
<out>/train_trace.json.gz.
"""

from __future__ import annotations

import argparse
import dataclasses
import gzip
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


class Snapshot:
    """A training state's tensors, restored in place (a captured graph
    keeps reading the same storage)."""

    def __init__(self, state):
        self.state = state
        self.step = state.step
        self.tensors = [(t, t.detach().clone()) for t in self._tensors()]
        self.generator = state.generator.get_state()

    def _tensors(self):
        s = self.state
        out = [p.data for p in s.model.parameters()] + [s.step_t]
        for st in s.optimizer.state.values():
            out += [v for v in st.values() if isinstance(v, torch.Tensor)]
        g = s.grid
        return out + [g.occs, g.occ_q, g.od_q, g.binaries, g.thre]

    def restore(self):
        with torch.no_grad():
            for live, saved in self.tensors:
                live.copy_(saved)
        self.state.generator.set_state(self.generator)
        self.state.step = self.step


def record_counts(trace: dict, n: int) -> dict:
    """Device records per step by (category, name) in a Chrome trace of n
    steps."""
    out = {}
    for e in trace["traceEvents"]:
        if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            key = (e["cat"], e["name"][:100])
            out[key] = out.get(key, 0.0) + 1.0 / n
    return out


def trace_numbers(trace: dict, n: int) -> dict:
    """Device busy and kernel ms per step, kernels and graph launches per
    step, from an exported Chrome trace of n steps."""
    ev = trace["traceEvents"]
    dev = [e for e in ev if e.get("cat") in ("kernel", "gpu_memcpy",
                                             "gpu_memset") and "dur" in e]
    per_kernel = {}
    for e in dev:
        per_kernel[e["name"]] = per_kernel.get(e["name"], 0.0) + e["dur"]
    ours = {k: v / 1e3 / n for k, v in per_kernel.items()
            if any(t in k for t in _TRAIN_KERNELS)}
    others = sorted(((v / 1e3 / n, k) for k, v in per_kernel.items()
                     if not any(t in k for t in _TRAIN_KERNELS)),
                    reverse=True)
    return {
        "device_busy_ms_per_step": busy_us(dev) / 1e3 / n,
        "train_kernels_ms_per_step": sum(ours.values()),
        "other_device_ms_per_step": sum(v for v, _ in others),
        "kernels_per_step": sum(1 for e in dev
                                if e.get("cat") == "kernel") / n,
        "graph_launches_per_step": sum(
            1 for e in ev if e.get("cat") == "cuda_runtime"
            and e.get("name", "").startswith("cudaGraphLaunch")) / n,
        "_ours": ours, "_others": others,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dataset", choices=["sphere", "lattice"],
                    default="lattice")
    ap.add_argument("--hw", type=int, default=800)
    ap.add_argument("--warmup", type=int, default=1070)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--pairs", type=int, default=2)
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
    from ..train.step import (ALL_CELLS, GeneratorDraws, StepKind,
                              make_train_chunk, make_train_step,
                              refresh_grid)

    dev = torch.device("cuda")
    card = card_name()
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
    # the window runs at the K the ladder holds after the warmup
    ladder = CompactionController(cfg)
    ladder.load_state_dict(state.ladder)
    step_cfg = ladder.apply(cfg)
    step_fn = make_train_step(model, step_cfg, state.optimizer, pool, scene)
    n = args.steps
    chunks = {mode: make_train_chunk(step_fn, n, graphs=mode == "graphed")
              for mode in ("eager", "graphed")}
    first = state.step
    kinds = [step_fn.kind(k) for k in range(first, first + n)]
    snap = Snapshot(state)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):               # warm every kind up, then capture it
        snap.restore()
        chunks["graphed"](state)
    torch.cuda.synchronize()
    peak_gb = (torch.cuda.max_memory_allocated() / 2 ** 30,
               torch.cuda.max_memory_reserved() / 2 ** 30)

    def timed(mode):
        snap.restore()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, m = chunks[mode](state)
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        return wall * 1e3 / n, host * 1e3 / n, float(m["loss"])

    def profiled(mode):
        snap.restore()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            chunks[mode](state)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        path = os.path.join(args.out, "train_trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            trace = json.load(fh)
        os.remove(path)
        return wall * 1e3 / n, trace

    os.makedirs(args.out, exist_ok=True)
    order = ["eager", "graphed", "graphed", "eager"] * args.pairs
    runs, losses, last_trace = [], set(), {}
    for i, mode in enumerate(order):
        wall, host, loss = timed(mode)
        prof_wall, trace = profiled(mode)
        nums = trace_numbers(trace, n)
        last_trace[mode] = trace
        losses.add(loss)
        runs.append({"run": i, "mode": mode, "wall_ms_per_step": wall,
                     "host_ms_per_step": host,
                     "profiled_wall_ms_per_step": prof_wall,
                     "device_idle_share": 1.0 - nums[
                         "device_busy_ms_per_step"] / wall,
                     **{k: v for k, v in nums.items()
                        if not k.startswith("_")}})
        print(json.dumps(runs[-1]))
    with gzip.open(os.path.join(args.out, "train_trace.json.gz"),
                   "wt") as fh:
        json.dump(last_trace["graphed"], fh)

    s_cfg = cfg.sampling

    def refresh_ms(kind):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        draws = GeneratorDraws(state.generator)
        refresh_grid(model, cfg, state, kind, draws, dev)
        torch.cuda.synchronize()
        a.record()
        refresh_grid(model, cfg, state, kind, draws, dev)
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b)

    print(json.dumps({
        "card": card, "dataset": args.dataset, "hw": args.hw,
        "strategy": args.strategy, "model": args.model,
        "profiled_steps_from": first, "profiled_steps": n,
        "n_compact": step_cfg.sampling.n_compact,
        "refreshes_in_window": [
            (first + i, "all" if k.refresh == ALL_CELLS else
             f"part {k.refresh}") for i, k in enumerate(kinds)
            if k.refresh is not None],
        "capture_s": {str(k): g.capture_s
                      for k, g in step_fn.graphs.items()},
        "peak_memory_gb_allocated": peak_gb[0],
        "peak_memory_gb_reserved": peak_gb[1],
        "runs_bitwise_equal_loss": len(losses) == 1,
        "refresh_all_cells_ms": None if hier else refresh_ms(
            StepKind(ALL_CELLS)),
        "refresh_one_part_ms": None if hier else refresh_ms(
            StepKind(0))}))
    for mode in ("eager", "graphed"):
        rs = [r for r in runs if r["mode"] == mode]
        print(f"{mode} on {card}: wall ms/step "
              + " / ".join(f"{r['wall_ms_per_step']:.3f}" for r in rs)
              + ", device busy "
              + " / ".join(f"{r['device_busy_ms_per_step']:.3f}" for r in rs)
              + ", idle share "
              + " / ".join(f"{r['device_idle_share']:.3f}" for r in rs)
              + ", host ms/step "
              + " / ".join(f"{r['host_ms_per_step']:.3f}" for r in rs))
    counts = {mode: record_counts(t, n) for mode, t in last_trace.items()}
    print("device records per step that differ, graphed - eager:")
    for key in sorted(set(counts["eager"]) | set(counts["graphed"])):
        d = counts["graphed"].get(key, 0.0) - counts["eager"].get(key, 0.0)
        if abs(d) > 1e-9:
            print(f"  {d:+8.4f}  {key[0]}  {key[1]}")
    nums = trace_numbers(last_trace["graphed"], n)
    for k, v in sorted(nums["_ours"].items(), key=lambda kv: -kv[1]):
        print(f"  {v:8.4f} ms/step  {k[:110]}")
    print("  other device work, top 15:")
    for v, k in nums["_others"][:15]:
        print(f"  {v:8.4f} ms/step  {k[:110]}")
    if len(losses) != 1:
        raise SystemExit(f"the runs of one window disagree: {losses}")


if __name__ == "__main__":
    main()
