"""Standalone density-curve comparison CLI (port of
fsnerf_tpu/utils/compare_densities.py).

Reference counterpart: src/utils/testing.py:1-33 — loads two .npz files with
a `curves` array (density-vs-depth per training iteration, e.g. NeRF vs
DS-NeRF runs) and writes an animated densities.gif.

Usage:
  python -m fsnerf_tpu_torch.utils.compare_densities a.npz b.npz \
      --out densities.gif --labels nerf dsnerf
"""

from __future__ import annotations

import argparse

import numpy as np

from .plotting import density_animate


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("run_a", help=".npz with a 'curves' array")
    p.add_argument("run_b", help=".npz with a 'curves' array")
    p.add_argument("--out", default="densities.gif")
    p.add_argument("--labels", nargs=2, default=["run A", "run B"])
    p.add_argument("--interval", type=int, default=50,
                   help="frame interval in ms")
    args = p.parse_args(argv)

    a = np.load(args.run_a)["curves"]
    b = np.load(args.run_b)["curves"]
    density_animate(a, b, labels=tuple(args.labels),
                    interval_ms=args.interval, out_path=args.out)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
