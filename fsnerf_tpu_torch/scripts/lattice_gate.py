"""The lattice n=8 quality gate on the port: the protocol of
benchmarks/ab_lattice_occgrid.py (the JAX package's "fixed" arm) run through
fsnerf_tpu_torch.

    python -m fsnerf_tpu_torch.scripts.lattice_gate [--hw 800] \
        [--iters 8000] [--seeds 0,1] [--out chiprun_out/lattice_gate.jsonl]

LatticeScene(n_imgs=8, hw) with all 8 views, the default config (white
background), `iters` steps per seed; then scene.holdout(n=3, seed=101)
rendered on the conservative view of the trained grid with n_compact 192
and query_stride 1 (held-out PSNR/SSIM), and the first training view the
same way (train-view PSNR). One JSON line per seed, with the card's name and
power limit and the wall times.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time

import numpy as np
import torch


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def render_views(model, grid, cfg, poses, hwf, near, far, dev):
    """[V, H, W, 3] frames through the ray march, at the protocol's
    n_compact 192 and query stride 1."""
    from ..cli import make_fused_render_fn
    from ..render.renderer import render_frame

    s = cfg.sampling
    fused = make_fused_render_fn(model.state_dict(), cfg, device=dev)
    frames = []
    with torch.no_grad():
        for pose in poses:
            img, _ = render_frame(
                None, torch.as_tensor(np.asarray(pose, np.float32),
                                      device=dev), hwf, near, far,
                grid=grid, n_samples=s.n_samples,
                render_step_size=s.render_step_size, white_bkgd=True,
                n_compact=192, early_stop_eps=s.early_stop_eps,
                query_stride=1, fused_render_fn=fused)
            frames.append(img)
    return torch.stack(frames)


def run_seed(seed: int, iters: int, scene, held, dev) -> dict:
    from ..config import Config, DataConfig
    from ..core.models import make_model
    from ..data.pool import pool_from_images
    from ..eval.metrics import evaluate_frames
    from ..ops import occgrid as og
    from ..train.loop import train

    cfg = Config(data=DataConfig(dataset="lattice", n_imgs=8,
                                 white_bkgd=True))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, n_iters=iters,
                                                seed=seed))
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(seed), dev)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train(model, cfg, pool, scene, log_every=2000)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    grid = og.conservative(state.grid)
    t0 = time.perf_counter()
    m = evaluate_frames(
        render_views(model, grid, cfg, held.poses, scene.hwf, scene.near,
                     scene.far, dev),
        torch.as_tensor(held.imgs, device=dev))
    mt = evaluate_frames(
        render_views(model, grid, cfg, scene.poses[:1], scene.hwf,
                     scene.near, scene.far, dev),
        torch.as_tensor(scene.imgs[:1], device=dev))
    eval_s = time.perf_counter() - t0
    return {"seed": seed, "iters": iters, "hw": scene.hwf[0],
            "heldout_psnr": float(m["psnr"]),
            "heldout_ssim": float(m["ssim"]),
            "train_view_psnr": float(mt["psnr"]),
            "train_s": train_s, "eval_s": eval_s,
            "steps_per_s": state.step / train_s,
            "final_occupancy": float(og.occupancy_fraction(state.grid))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, default=800)
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--out", default="chiprun_out/lattice_gate.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the lattice gate needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..data.synthetic import LatticeScene

    dev = torch.device("cuda")
    card = card_name()
    t0 = time.perf_counter()
    scene = LatticeScene(n_imgs=8, hw=args.hw)
    held = scene.holdout(n=3, seed=101)
    print(f"scenes built in {time.perf_counter() - t0:.1f} s on the host")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = dict(run_seed(seed, args.iters, scene, held, dev), card=card)
        print(json.dumps(rec), flush=True)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
