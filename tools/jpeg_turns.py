"""Time the port's JPEG decoder of two trees in turns, on one host:
chip_smoke.py phase 22c's 20 views at 4032x3024 (4:2:0, quality 95, PIL) decoded to
float32 by each tree's fsnerf_tpu_torch.native.decode_images in one call on
the host's threads, and phase 22d's 504x378 view pair (Huffman and SOF9 of
the same coefficients, tests/data/jpeg/view/) as 200 copies in one call.

    python -m tools.jpeg_turns --trees build/parent,. [--blocks 3] [--reps 3]

Unpack the tree to compare with into a git-ignored directory first (git
archive). Each run is a process of its own that imports the package from
one tree (PYTHONPATH), builds its loader.cpp, decodes each set once
untimed and then --reps times through decode_images, and --reps times
split into the marker parse of every file (serial, Python) and the
threads' decoding into arrays it touched before (`worker`); the trees run
A-B-B-A in each block. Prints one JSON line per run (the seconds of each)
and a summary per set and part: each tree's median over the blocks and
its median over the first tree's, with the host's CPU count and, where
nvidia-smi answers, the card's name and power limit (the card's host is
what is timed).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BIG_VIEWS, BIG_W, BIG_H = 20, 4032, 3024
VIEW_REPS = 200


def big_views(root: str) -> list:
    """chip_smoke.py's jpeg_decode_rate views, written into root."""
    from PIL import Image

    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[0:BIG_H, 0:BIG_W].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(xx / 83.0) * np.cos(yy / 61.0),
                     128 + 90 * np.cos((xx + yy) / 47.0),
                     (xx / 16 + yy / 12) % 256], -1)
    base = (base + rng.normal(0, 8, base.shape)).clip(0, 255).astype(
        np.uint8)
    files = []
    for i in range(BIG_VIEWS):
        files.append(os.path.join(root, f"im_{i:03d}.jpg"))
        Image.fromarray(np.roll(base, 97 * i, axis=1)).save(
            files[-1], quality=95, subsampling=2)
    return files


def worker(sets: dict, reps: int) -> dict:
    """{set: {"call" | "parse" | "decode": [seconds of each timed run]}}
    with this process's package: the decode_images call, and apart the
    marker parse of every file (jpeg.read_jpeg, serial) and the threads'
    decoding of the parsed files into arrays allocated and touched
    before (jpeg.decode_into)."""
    from fsnerf_tpu_torch.native import decode_images, jpeg

    out = {}
    for name, paths in sets.items():
        try:
            decode_images(paths)
        except NotImplementedError:     # a tree that does not read it
            out[name] = None
            continue
        raws = [open(p, "rb").read() for p in paths]
        out[name] = {"call": [], "parse": [], "decode": []}
        for _ in range(reps):
            t0 = time.perf_counter()
            decode_images(paths)
            out[name]["call"].append(time.perf_counter() - t0)
        jpegs = [jpeg.read_jpeg(p, r) for p, r in zip(paths, raws)]
        dst = [np.zeros((j.height, j.width, 3), np.float32) for j in jpegs]
        jpeg.decode_into(jpegs, dst, 0)
        for _ in range(reps):
            t0 = time.perf_counter()
            jpegs = [jpeg.read_jpeg(p, r) for p, r in zip(paths, raws)]
            out[name]["parse"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            jpeg.decode_into(jpegs, dst, 0)
            out[name]["decode"].append(time.perf_counter() - t0)
    return out


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no card"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trees", default="build/parent,.")
    ap.add_argument("--blocks", type=int, default=3)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        with open(args.worker) as fh:
            sets = json.load(fh)
        print(json.dumps(worker(sets, args.reps)))
        return 0
    trees = [os.path.abspath(t) for t in args.trees.split(",")]
    view = os.path.join(HERE, "tests", "data", "jpeg", "view")
    with tempfile.TemporaryDirectory() as tmp:
        sets = {"big": big_views(tmp)}
        for name in ("view_504x378.jpg", "view_504x378_arith.jpg"):
            sets[name] = [os.path.join(view, name)] * VIEW_REPS
        spec = os.path.join(tmp, "sets.json")
        with open(spec, "w") as fh:
            json.dump(sets, fh)
        runs = {t: [] for t in trees}
        for block in range(args.blocks):
            for t in trees + trees[::-1]:
                env = dict(os.environ, PYTHONPATH=t)
                res = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--worker",
                     spec, "--reps", str(args.reps)], cwd=t, env=env,
                    capture_output=True, text=True, check=True)
                got = json.loads(res.stdout.strip().splitlines()[-1])
                runs[t].append(got)
                print(json.dumps({"tree": t, "block": block, **got}),
                      flush=True)
    summary = {}
    for name in sets:
        for part in ("call", "parse", "decode"):
            med = {t: float(np.median([x for r in runs[t]
                                       for x in r[name][part]]))
                   for t in trees if runs[t][0][name] is not None}
            summary[f"{name} {part}"] = {"median_s": med, "over_first": {
                t: m / med[trees[0]] for t, m in med.items()}
                if trees[0] in med else None}
    print(json.dumps({"summary": summary, "cpus": os.cpu_count(),
                      "card": card()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
