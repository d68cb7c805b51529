"""Time the NeRF train kernels of two source trees in turns on one card:
kernel 5 (the forward, with and without its saved activations, and the
wrapper's host time per call) and kernel 6 (the backward, saved and
recompute mode) at the main path's 196,608 rows (1,024 rays x K 192),
NeRF 8x256 with seeded weights, as `chip_smoke.py` phase 5 builds them.

    python -m fsnerf_tpu_torch.scripts.train_kernel_turns \\
        --trees build/parent,. [--blocks 3] [--rows 196608]

Each measurement is a process of its own that imports `fsnerf_tpu_torch`
from one tree (its kernels built there), in the order A, B, B, A per
block, so two versions are compared on one card in one call. Prints one
JSON line per run (CUDA-event ms, host ms, the card's name and power
limit), then the mean of each tree over its runs. Refuses to run without
CUDA.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

_KEYS = ("fwd_ms", "fwd_nosave_ms", "fwd_host_ms", "bwd_ms",
         "bwd_recompute_ms")


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(rows: int, reps: int) -> dict:
    """The numbers of one run, from the `fsnerf_tpu_torch` on sys.path."""
    import torch

    from fsnerf_tpu_torch.config import Config
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import build
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    build.load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = Config()
    lay = mt.TrainLayout.from_config(cfg)
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(3), dev)
    params = mt.pack_train_params(
        model.state_dict(), lay,
        kr.enc_table(lay.n_freqs, lay.n_freqs_views, device=dev))
    g = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand((rows, 3), generator=g, device=dev) * 3.0 - 1.5
    d = torch.nn.functional.normalize(
        torch.randn((rows, 3), generator=g, device=dev), dim=-1)
    out, acts = mt.mlp_train_fwd(x, d, params, True)
    ref, _ = mt.mlp_train_fwd_reference(x, d, params)
    target = torch.rand((rows, 4), generator=g, device=dev)
    dout = (2.0 * (ref - target) / ref.numel()).contiguous()
    res = {"rgb_err": float((out[:, :3] - ref[:, :3]).abs().max()),
           "sigma_err": float((out[:, 3] - ref[:, 3]).abs().max())}
    res["fwd_ms"] = _ms(lambda: mt.mlp_train_fwd(x, d, params, True), reps)
    res["fwd_nosave_ms"] = _ms(lambda: mt.mlp_train_fwd(x, d, params),
                               reps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mt.mlp_train_fwd(x, d, params, True)
    res["fwd_host_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    res["bwd_ms"] = _ms(lambda: mt.mlp_train_bwd(x, d, dout, params, acts),
                        reps)
    res["bwd_recompute_ms"] = _ms(
        lambda: mt.mlp_train_bwd(x, d, dout, params, None), reps)
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="build/parent,.",
                    help="two source trees A,B (roots holding "
                         "fsnerf_tpu_torch/)")
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--rows", type=int, default=1024 * 192)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--worker", action="store_true",
                    help="measure the tree on PYTHONPATH once (internal)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("train_kernel_turns needs an NVIDIA GPU")
    if args.worker:
        print(json.dumps(measure(args.rows, args.reps)))
        return
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    if len(trees) != 2:
        raise SystemExit("--trees wants two trees A,B")
    runs = {t: [] for t in trees}
    for block in range(args.blocks):
        for tree in (trees[0], trees[1], trees[1], trees[0]):
            env = dict(os.environ, PYTHONPATH=tree)
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--worker",
                 "--rows", str(args.rows), "--reps", str(args.reps)],
                env=env, capture_output=True, text=True, cwd=tree)
            if proc.returncode:
                raise SystemExit(f"worker in {tree} failed:\n{proc.stdout}"
                                 f"\n{proc.stderr}")
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            runs[tree].append(res)
            print(json.dumps(dict(tree=tree, block=block, card=card,
                                  rows=args.rows, **res)), flush=True)
    for tree, rs in runs.items():
        print(json.dumps(dict(tree=tree, card=card, runs=len(rs), **{
            f"mean_{k}": sum(r[k] for r in rs) / len(rs) for k in _KEYS})))


if __name__ == "__main__":
    main()
