"""The few-shot regularizer study on the port: the counterpart of
benchmarks/quality_fewshot.py, through fsnerf_tpu_torch on one NVIDIA GPU.

    python -m fsnerf_tpu_torch.scripts.fewshot_gate [--arms base,freq-0.4] \
        [--nviews 8] [--seeds 0,1] [--iters 8000] [--hw 800] \
        [--scene sphere|lattice] [--floaters] \
        [--strategy occgrid|hierarchical] [--out PATH.jsonl]

Protocol (the JAX study's): train views are `n` evenly spread views of an
8-view orbit (train_indices); with --floaters, view-inconsistent blobs are
composited into the training images only (data/synthetic.py::add_floaters,
seed 97). Held out: 3 views from another orbit seed (SphereScene(n_imgs=3,
seed=101), or the lattice's holdout(n=3, seed=101)), rendered on the
conservative view of the trained grid at n_compact 192 and query stride 1
through the eval model_fn (the fused forward MLP) and the compositing
kernel (ops/kernels/volrend.py), as the JAX study renders through its
forward MLP and XLA compositing; hierarchical renders both passes so.

Arms (arm_config): base; freq[-f] (FreeNeRF annealing over f * iters
steps, f = 0.9 by default, with the auto culling hold); occ[-a]
(occlusion regularizer, exp weight a (default 1), b 2, beta 1); wreg[-ao]
(weight regularizer, ao 1e-6 by default, l1, reg_ratio 0.5); both[-a]
(freq + occ).

One JSON line per run, with the card's name and power limit, the training
rate, the held-out PSNR/SSIM and the launches of the density kernel (grid
refresh) and the compositing kernel (eval) in that run.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .lattice_gate import card_name


def arm_config(arm: str, seed: int, iters: int, strategy: str = "occgrid",
               scene: str = "sphere"):
    """The port's Config of one arm (benchmarks/quality_fewshot.py::
    arm_config)."""
    from ..config import (Config, DataConfig, EncoderConfig, SamplingConfig,
                          TrainConfig)

    enc_kw, train_kw = {}, {}
    base_arm = arm.split("-")[0]
    value = float(arm.split("-", 1)[1]) if "-" in arm else None
    if base_arm in ("freq", "both"):
        frac = value if (base_arm == "freq" and value is not None) else 0.9
        enc_kw["freq_reg_end"] = int(frac * iters)
    if base_arm in ("occ", "both"):
        train_kw.update(occ_a=1.0 if value is None else value, occ_b=2.0,
                        occ_func="exp", beta=1.0)
    if base_arm == "wreg":
        train_kw.update(ao=1e-6 if value is None else value, reg_ratio=0.5,
                        reg="l1")
    if base_arm not in ("base", "freq", "occ", "wreg", "both"):
        raise ValueError(arm)
    samp = (dict(strategy="hierarchical", n_samples=64, n_fine=128)
            if strategy == "hierarchical" else dict(strategy="occgrid"))
    return Config(data=DataConfig(dataset=scene, white_bkgd=True),
                  encoder=EncoderConfig(**enc_kw),
                  train=TrainConfig(n_iters=iters, seed=seed, **train_kw),
                  sampling=SamplingConfig(**samp))


def train_indices(n: int, total: int = 8):
    """n evenly spread view indices out of `total` (pose-diverse few-shot)."""
    return np.round(np.linspace(0, total, n, endpoint=False)).astype(int)


def run_one(arm: str, nviews: int, seed: int, iters: int, scene, held,
            dev, scene_name: str, floaters: bool, strategy: str) -> dict:
    from ..cli import make_composite_fn, make_render_model_fn
    from ..core.models import make_model
    from ..data.pool import pool_from_images
    from ..data.synthetic import add_floaters
    from ..eval.metrics import evaluate_frames
    from ..ops import occgrid as og
    from ..ops.kernels import mlp as km
    from ..ops.kernels import volrend as kv
    from ..render.renderer import render_frame
    from ..train.loop import train

    cfg = arm_config(arm, seed, iters, strategy, scene_name)
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(seed), dev)
    idx = train_indices(nviews, len(scene.poses))
    imgs = scene.imgs[idx]
    if floaters:
        imgs = add_floaters(imgs, scene.poses[idx], scene.hwf, seed=97)
    pool = pool_from_images(imgs, scene.poses[idx], scene.hwf, device=dev)
    km.nerf_density.launches = kv.volume_render_fused.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train(model, cfg, pool, scene, log_every=2000)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    density_launches = km.nerf_density.launches

    s = cfg.sampling
    model_fn = make_render_model_fn(model, cfg, device=dev)
    kw = dict(white_bkgd=True, n_samples=s.n_samples,
              composite_fn=make_composite_fn(cfg, dev))
    if strategy == "hierarchical":
        kw.update(strategy="hierarchical", n_fine=s.n_fine)
    else:
        kw.update(grid=og.conservative(state.grid), n_compact=192,
                  query_stride=1, render_step_size=s.render_step_size,
                  early_stop_eps=s.early_stop_eps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        frames = torch.stack([render_frame(
            model_fn, torch.as_tensor(np.asarray(p, np.float32), device=dev),
            scene.hwf, scene.near, scene.far, **kw)[0] for p in held.poses])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    m = evaluate_frames(frames, torch.as_tensor(held.imgs, device=dev))
    return {"arm": arm, "nviews": nviews, "seed": seed, "iters": iters,
            "hw": scene.hwf[0], "scene": scene_name, "floaters": floaters,
            "strategy": strategy,
            "heldout_psnr": float(m["psnr"]),
            "heldout_ssim": float(m["ssim"]),
            "train_s": train_s, "steps_per_s": state.step / train_s,
            "train_rays_per_s": state.step * cfg.train.batch_size / train_s,
            "eval_s_per_view": eval_s / len(held.poses),
            "final_occupancy": float(og.occupancy_fraction(state.grid)),
            "launches": {"nerf_density": density_launches,
                         "volrend": kv.volume_render_fused.launches}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", default="base,freq,occ,both")
    ap.add_argument("--nviews", default="3,8")
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--hw", type=int, default=800)
    ap.add_argument("--scene", choices=["sphere", "lattice"],
                    default="sphere")
    ap.add_argument("--floaters", action="store_true")
    ap.add_argument("--strategy", choices=["occgrid", "hierarchical"],
                    default="occgrid")
    ap.add_argument("--out", default="out/fewshot_gate.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the few-shot gate needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..data.synthetic import LatticeScene, SphereScene

    dev = torch.device("cuda")
    card = card_name()
    t0 = time.perf_counter()
    if args.scene == "sphere":
        scene = SphereScene(n_imgs=8, hw=args.hw, white_bkgd=True)
        held = SphereScene(n_imgs=3, hw=args.hw, white_bkgd=True, seed=101)
    else:
        scene = LatticeScene(n_imgs=8, hw=args.hw, white_bkgd=True)
        held = scene.holdout(n=3, seed=101)
    print(f"scenes built in {time.perf_counter() - t0:.1f} s on the host")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for nviews in (int(n) for n in args.nviews.split(",")):
        for seed in (int(s) for s in args.seeds.split(",")):
            for arm in args.arms.split(","):
                rec = dict(run_one(arm, nviews, seed, args.iters, scene,
                                   held, dev, args.scene, args.floaters,
                                   args.strategy), card=card)
                print(json.dumps(rec), flush=True)
                with open(args.out, "a") as fh:
                    fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
