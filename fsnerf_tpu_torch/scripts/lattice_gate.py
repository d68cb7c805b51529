"""The lattice n=8 quality gate on the port, through fsnerf_tpu_torch.

    python -m fsnerf_tpu_torch.scripts.lattice_gate [--hw 800] \
        [--iters 8000] [--seeds 0,1] [--strategy occgrid|hierarchical] \
        [--out PATH.jsonl]

LatticeScene(n_imgs=8, hw) with all 8 views, white background, `iters`
steps per seed; then scene.holdout(n=3, seed=101) rendered for held-out
PSNR/SSIM and the first training view the same way (train-view PSNR).

occgrid: the protocol of benchmarks/ab_lattice_occgrid.py (the JAX
package's "fixed" arm): the default config, the held-out views through the
ray march on the conservative view of the trained grid with n_compact 192
and query_stride 1.

hierarchical: the protocol of benchmarks/quality_fewshot.py's hierarchical
arm (BASELINE.json config 2): n_samples 64 coarse + n_fine 128, the views
through render_frame with the eval model_fn (the fused forward MLP on the
card) for both passes and no fused fine pass.

One JSON line per seed, with the card's name and power limit, the wall
times, the training rays/s and the eval seconds per view.
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
    """[V, H, W, 3] frames by the strategy's protocol: occgrid through the
    ray march at n_compact 192 and query stride 1, hierarchical through the
    eval model_fn for both passes."""
    from ..cli import make_fused_render_fn, make_render_model_fn
    from ..render.renderer import render_frame

    s = cfg.sampling
    if s.strategy == "occgrid":
        model_fn = None
        kw = dict(grid=grid, render_step_size=s.render_step_size,
                  n_compact=192, early_stop_eps=s.early_stop_eps,
                  query_stride=1, fused_render_fn=make_fused_render_fn(
                      model.state_dict(), cfg, device=dev))
    else:
        model_fn = make_render_model_fn(model, cfg, device=dev)
        kw = dict(strategy="hierarchical", n_fine=s.n_fine)
    frames = []
    with torch.no_grad():
        for pose in poses:
            img, _ = render_frame(
                model_fn, torch.as_tensor(np.asarray(pose, np.float32),
                                          device=dev), hwf, near, far,
                n_samples=s.n_samples, white_bkgd=True, **kw)
            frames.append(img)
    return torch.stack(frames)


def run_seed(seed: int, iters: int, scene, held, dev,
             strategy: str = "occgrid") -> dict:
    from ..config import Config, DataConfig, SamplingConfig
    from ..core.models import make_model
    from ..data.pool import pool_from_images
    from ..eval.metrics import evaluate_frames
    from ..ops import occgrid as og
    from ..train.loop import train

    cfg = Config(data=DataConfig(dataset="lattice", n_imgs=8,
                                 white_bkgd=True))
    if strategy == "hierarchical":
        cfg = cfg.replace(sampling=SamplingConfig(
            strategy="hierarchical", n_samples=64, n_fine=128))
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
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    frames = render_views(model, grid, cfg, held.poses, scene.hwf,
                          scene.near, scene.far, dev)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    m = evaluate_frames(frames, torch.as_tensor(held.imgs, device=dev))
    mt = evaluate_frames(
        render_views(model, grid, cfg, scene.poses[:1], scene.hwf,
                     scene.near, scene.far, dev),
        torch.as_tensor(scene.imgs[:1], device=dev))
    rec = {"seed": seed, "iters": iters, "hw": scene.hwf[0],
           "strategy": strategy,
           "heldout_psnr": float(m["psnr"]),
           "heldout_ssim": float(m["ssim"]),
           "train_view_psnr": float(mt["psnr"]),
           "train_s": train_s, "steps_per_s": state.step / train_s,
           "train_rays_per_s": state.step * cfg.train.batch_size / train_s,
           "eval_s": eval_s, "eval_s_per_view": eval_s / len(held.poses)}
    if strategy == "occgrid":
        rec["final_occupancy"] = float(og.occupancy_fraction(state.grid))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, default=800)
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--strategy", choices=["occgrid", "hierarchical"],
                    default="occgrid")
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
        rec = dict(run_seed(seed, args.iters, scene, held, dev,
                            args.strategy), card=card)
        print(json.dumps(rec), flush=True)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
