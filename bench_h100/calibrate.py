"""Readings for the comparison's limits: the program's numbers over many
seeds, the control's (the reference computed with float8 operands in the
program's place) and a planted fault's (the loss over half of each step's
rays), in one process.

    python3 -m bench_h100.calibrate --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2,3] [--seconds 1]

Prints one JSON line per seed and side: {"seed", "side", numbers...}. The
benchmark's own runs never run this; it is how limits/<cell>.json was
set (PERF.md gives the readings).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import harness
from .reference import pipeline as ref


def control_train(c: dict, kept: dict, seed: int, **kw) -> dict:
    got = ref.train_steps(kept["w0"], c["config"], c["traffic"],
                          kept["views"], seed, c["traffic"]["check_steps"],
                          **kw)
    return harness.train_numbers(got, kept["want"], kept["w0"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    c = harness.cell(args.workload)
    kind = c["traffic"]["kind"]
    control = {int(s) for s in args.control_seeds.split(",") if s}
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.KINDS[kind](c, seed, args.seconds, False, dev, t0,
                                  keep=True)
        print(json.dumps({"seed": seed, "side": "program",
                          "setup_s": out["setup_s"], **out["e2e"],
                          "rows_per_ray": out.get("rows_per_ray"),
                          **out["numbers"]}), flush=True)
        if seed in control:
            kept = out["kept"]
            sides = {"control": control_train(c, kept, seed,
                                              precision="float8"),
                     "half_batch": control_train(c, kept, seed,
                                                 fault="half_batch")}
            for side, numbers in sides.items():
                print(json.dumps({"seed": seed, "side": side, **numbers}),
                      flush=True)
        del out
        harness.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
