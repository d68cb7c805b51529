"""Read the training loop's spans and counters on a train cell of the
benchmark, and time what recording them costs.

    python -m tools.tracing_cost --workload nerf-8x256.occgrid-train \
        --seed 2147483901 [--seconds 51] [--rounds 8]

From the root of a checkout on a machine with an NVIDIA card. Two parts,
in one process:

  1. read: the cell's run as `python3 -m bench_h100.run ... --trace 1`
     makes it (bench_h100/harness.py::run_train), then each per-layer
     reader the manifest lists for the cell and the tracer's readers
     (READERS, bench_h100/metrics/), how the device events were given to
     the steps (bench_h100/spans.py::steps), the card's idle time split
     into the idle inside the steps' device extents and the idle outside
     them by the annotation the host was in, and the device time of the
     float64 kernels (the valid-row accumulator's add) a step.
  2. cost: a second training run of the cell from the seed; from step
     --from-step on (past the step kinds' first captures), chunks of
     --log-every steps (128: two grid refreshes each, one every 64 steps
     late in training) in rounds of four modes, the order rotated each
     round: no profiler and spans off (`plain`), spans on
     through profiling.recording() with no profiler (`recording`), the
     torch profiler with spans on (`profiled`), and the profiler with
     spans forced off (`profiled_no_spans`: span() is told no profiler
     runs). A chunk's time runs from one synchronized log boundary to the
     next; a round with a ladder swap or a capture in it is left out of
     the comparison. Each chunk is also a line on standard error.

Prints one JSON line per part, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

T_START = time.perf_counter()

READERS = ("mlp_row_fill.train", "grid_refresh_share.train",
           "host_idle_share.train", "graph_capture_ms.train")
MODES = ("plain", "recording", "profiled", "profiled_no_spans")


def idle_split(prof, per_step) -> dict:
    """The card's idle microseconds in the stretch: inside the steps'
    device extents, and outside them by the program annotation the host
    was in (the one overlapping the gap most; `none` where none does)."""
    from bench_h100 import spans
    from bench_h100.trace import gaps

    extents = spans.union(
        (min(e["ts"] for e in evs), max(e["ts"] + e["dur"] for e in evs))
        for evs in per_step)
    notes = [h for h in prof.host if h.get("cat") == "user_annotation"]
    t0 = min(e["ts"] for e in prof.device)
    t1 = max(e["ts"] + e["dur"] for e in prof.device)
    out = {"inside_steps": 0.0}
    pieces = []
    hosts = [h for h in prof.host if h.get("cat") in ("user_annotation",
                                                       "cuda_runtime",
                                                       "cpu_op")]
    for a, b in gaps(prof.device):
        for x, y in extents:            # cut out the steps' extents
            if y <= a or x >= b:
                continue
            out["inside_steps"] += min(b, y) - max(a, x)
        outside = [(a, b)]
        for x, y in extents:
            outside = [p for lo, hi in outside for p in
                       ((lo, min(hi, x)), (max(lo, y), hi)) if p[1] > p[0]]
        pieces += outside
    for a, b in pieces:
        best, over = "none", 0.0
        for h in notes:
            o = min(b, h["ts"] + h["dur"]) - max(a, h["ts"])
            if o > over:
                best, over = h["name"], o
        out[best] = out.get(best, 0.0) + (b - a)
    # the longest pieces, each with the host events overlapping it most
    out["longest"] = []
    for a, b in sorted(pieces, key=lambda p: p[0] - p[1])[:6]:
        over = sorted(((min(b, h["ts"] + h["dur"]) - max(a, h["ts"]),
                        h["name"][:60]) for h in hosts), reverse=True)[:5]
        out["longest"].append([b - a, a - t0,
                               [[n, o] for o, n in over if o > 0]])
    out["device_span_us"] = t1 - t0
    out["wall_us"] = prof.wall_s * 1e6
    return out


def read_part(c, seed, seconds, device) -> dict:
    from bench_h100 import harness, spans
    from bench_h100.trace import busy_us

    out = harness.run_train(c, seed, seconds, True, device, T_START)
    ctx = out["ctx"]
    line = {"part": "read", "workload": c["workload"]["name"],
            "seed": seed, "e2e": out["e2e"],
            "checks": harness.judged(out["numbers"], c["limits"]),
            "metrics": {m["name"]: harness.reader(m["name"]).read(ctx)
                        for m in c["per_layer"]}}
    for name in READERS:
        line["metrics"][name] = harness.reader(name).read(ctx)
    found = spans.steps(ctx)
    prof = ctx["prof"]
    line["device_busy_us"] = busy_us(prof.device)
    if found is not None:
        how, per = found
        line["grouped_by"] = how
        line["steps"] = len(per)
        line["kinds"] = sorted({json.dumps(a, sort_keys=True)
                                for a, _ in per})
        line["idle_us"] = idle_split(prof, [evs for _, evs in per])
        f64 = [sum(e["dur"] for e in evs if "double" in e["name"])
               for _, evs in per]
        line["float64_us_a_step"] = statistics.median(f64)
        line["step_device_us"] = statistics.median(
            busy_us(evs) for _, evs in per)
        line["last_kernels_of_a_step"] = [
            [e["name"][:100], e["dur"]]
            for e in sorted(per[0][1], key=lambda e: e["ts"])[-8:]]
    rec = spans.program_record()
    line["counters"] = {k: v for k, v in rec["counters"].items()
                        if k != "capture_s"}
    line["capture_ms"] = [1e3 * s for s in rec["counters"]["capture_s"]]
    line["dropped"] = rec["dropped"]
    # the captures and eager warm-ups inside the measured window: the
    # counters' snapshots at its first and last log boundary
    at = {s["step"]: s["counters"] for s in rec["snapshots"]}
    first = c["traffic"]["setup_steps"]
    a, b = at.get(first), at.get(first + out["attempted"])
    if a and b:
        line["window"] = {
            "s": out["window_s"], "captures": b["captures"] - a["captures"],
            "capture_s": sum(rec["counters"]["capture_s"][
                a["captures"]:b["captures"]]),
            "warmup_steps": b["warmup_steps"] - a["warmup_steps"]}
    return line


class Turns:
    """The logger of the cost part: from `from_step`, one mode a chunk
    in rotated rounds; raises harness.WindowClosed after `rounds`."""

    def __init__(self, from_step, rounds, device):
        self.from_step, self.device = from_step, device
        self.plan = [MODES[(r + i) % len(MODES)] for r in range(rounds)
                     for i in range(len(MODES))]
        self.chunks = []
        self.mode = self.prof = None

    def _enter(self, mode):
        from torch.profiler import ProfilerActivity, profile

        from fsnerf_tpu_torch.utils import profiling

        self.mode = mode
        if mode == "recording":
            self.rec = profiling.recording()
            self.rec.__enter__()
        if mode.startswith("profiled"):
            if mode == "profiled_no_spans":
                profiling._profiler_enabled = lambda: False
            self.prof = profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA])
            self.prof.start()

    def _leave(self):
        import torch

        from fsnerf_tpu_torch.utils import profiling

        if self.mode == "recording":
            self.rec.__exit__(None, None, None)
        if self.prof is not None:
            self.prof.stop()
            self.prof = None
            profiling._profiler_enabled = \
                torch._C._autograd._profiler_enabled

    def log(self, step, metrics):
        import sys

        from bench_h100 import harness
        from fsnerf_tpu_torch.utils import profiling

        harness.sync(self.device)
        now = time.perf_counter()
        c = profiling.counters()
        if self.mode is not None:
            self.chunks.append({"mode": self.mode, "from": self.step,
                                "to": step, "s": now - self.t0,
                                "k": metrics["n_compact"],
                                "captures": c["captures"] - self.captures,
                                "swap": metrics["n_compact"] != self.k})
            print("chunk", json.dumps(self.chunks[-1]), file=sys.stderr,
                  flush=True)
            self._leave()
        if step < self.from_step:
            return
        if not self.plan:
            raise harness.WindowClosed
        self._enter(self.plan.pop(0))
        self.k, self.captures = metrics["n_compact"], c["captures"]
        harness.sync(self.device)
        self.step, self.t0 = step, time.perf_counter()


def cost_part(c, seed, rounds, from_step, log_every, device) -> dict:
    from bench_h100 import harness
    from fsnerf_tpu_torch.train.loop import train
    from fsnerf_tpu_torch.train.step import init_state, make_optimizer

    traffic = c["traffic"]
    pcfg, model, pool, scn, _, _ = harness.program_inputs(
        c, seed, device, traffic["n_iters"])
    state = init_state(model, pcfg, make_optimizer(pcfg, model), scn.aabb,
                       device)
    turns = Turns(from_step, rounds, device)
    try:
        train(model, pcfg, pool, scn, state=state, logger=turns,
              log_every=log_every)
    except harness.WindowClosed:
        pass
    n = len(MODES)
    rounds = [turns.chunks[r * n:(r + 1) * n]
              for r in range(len(turns.chunks) // n)]
    clean = [r for r in rounds
             if not any(x["captures"] or x["swap"] for x in r)]
    ms = {m: [1e3 * x["s"] / (x["to"] - x["from"]) for r in clean for x in r
              if x["mode"] == m] for m in MODES}
    # each round's mode against the same round's plain chunk
    ratios = {m: [] for m in MODES}
    for r in clean:
        rnd = {x["mode"]: x["s"] / (x["to"] - x["from"]) for x in r}
        for m, v in rnd.items():
            ratios[m].append(v / rnd["plain"])
    return {"part": "cost", "workload": c["workload"]["name"], "seed": seed,
            "rounds_clean": len(clean), "rounds": len(rounds),
            "ms_a_step_median": {m: statistics.median(v) if v else None
                                 for m, v in ms.items()},
            "over_plain_median": {m: statistics.median(v) if v else None
                                  for m, v in ratios.items()},
            "chunks": turns.chunks}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--from-step", type=int, default=1664)
    ap.add_argument("--log-every", type=int, default=128)
    ap.add_argument("--parts", default="read,cost")
    args = ap.parse_args(argv)

    import torch

    from bench_h100 import harness, run
    from fsnerf_tpu_torch.ops.kernels.build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    load_library()
    c = harness.cell(args.workload)
    card = run.power_limit()
    for part in args.parts.split(","):
        if part == "read":
            line = read_part(c, args.seed, args.seconds, device)
        else:
            line = cost_part(c, args.seed, args.rounds, args.from_step,
                             args.log_every, device)
        line["card"] = card
        print(json.dumps(line), flush=True)
        harness.release()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
