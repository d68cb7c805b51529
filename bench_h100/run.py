"""Run one cell of the port's benchmark once and print its result line.

    python3 -m bench_h100.run --workload <config>.<traffic> --seed <n> \
        --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with an NVIDIA card: loads the
kernels (built into fsnerf_tpu_torch/build/ on a checkout's first run),
makes the inputs and weights from the seed, warms up the cell's shapes,
measures for --seconds, then compares what the timed path produced with
the plain reference. The last line of standard output is one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics, or
with --trace 1 its per-layer ones), device, with --trace 1 a breakdown of
the traced sub-window, and last `checks`, each compared number with its
limit (also the last lines of standard error). Without a CUDA device, or
with fewer than the cell asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fsnerf_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")

    import torch

    from . import harness

    c = harness.cell(args.workload)
    chips = int(c["workload"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_h100: the cell {args.workload} needs {chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " (it never falls back to the CPU)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    from fsnerf_tpu_torch.ops.kernels.build import load_library

    phases = [("imports and the card", time.perf_counter())]
    load_library()
    phases.append(("kernel library", time.perf_counter()))
    run = harness.KINDS[c["traffic"]["kind"]]
    out = run(c, args.seed, args.seconds, bool(args.trace), device, T_START)
    bad = forbidden_modules()
    if bad:
        print(f"bench_h100: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    checks = harness.judged(out["numbers"], c["limits"])
    correct = all(v <= lim for v, lim in checks.values())
    if args.trace:
        metrics = harness.per_layer(c, out["ctx"])
    else:
        metrics = {m["name"]: {"value": out["e2e"][m["name"]],
                               "unit": m["unit"]} for m in c["end_to_end"]}
    device_info = {"platform": "gpu",
                   "kind": torch.cuda.get_device_name(0), "count": chips,
                   "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": bool(correct), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": device_info}
    if args.trace:
        device_info.update(harness.device_busy(out["ctx"]))
        line["breakdown"] = out["ctx"]["prof"].breakdown()
    line["card"] = power_limit()
    line["checks"] = checks
    print(f"bench_h100: {args.workload} seed {args.seed}: "
          + ", ".join(f"{k} {v!r}" for k, v in out["e2e"].items())
          + f", window {out['window_s']!r} s; set-up stages ended at "
          + ", ".join(f"{n} {t - T_START:.3f} s"
                    for n, t in phases + out["phases"]),
          file=sys.stderr)
    for name, (v, lim) in checks.items():
        print(f"check {name}: {v!r} (limit {lim!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
