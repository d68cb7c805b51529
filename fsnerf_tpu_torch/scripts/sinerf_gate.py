"""The SiNeRF quality gate on the port: the protocol of
benchmarks/quality_study.py's `sinerf_sa` arm, through fsnerf_tpu_torch.

    python -m fsnerf_tpu_torch.scripts.sinerf_gate [--hw 800] \
        [--iters 8000] [--seeds 0,1] [--out PATH.jsonl]

SphereScene(n_imgs=9, hw) with a white background; the ray pool from the
first 8 views, the last one held out. The default config with
`--model sinerf` (the SIREN train kernels with saved activations) and
TrainConfig(seed=s, n_iters=iters). The held-out view is rendered on the
conservative view of the trained grid at n_compact 192 and query stride 1,
twice: through the eval model_fn (the SIREN forward kernel on every
compacted sample: the JAX protocol) and through the SIREN ray march.

One JSON line per seed, with the card's name and power limit, the PSNR and
SSIM of both evals, the training rays/s and the eval seconds per view.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from .lattice_gate import card_name, render_views


def run_seed(seed: int, iters: int, scene, dev) -> dict:
    from ..config import Config, DataConfig, ModelConfig
    from ..core.models import make_model
    from ..data.pool import pool_from_images
    from ..eval.metrics import evaluate_frames
    from ..ops import occgrid as og
    from ..train.loop import train

    cfg = Config(data=DataConfig(dataset="sphere", white_bkgd=True),
                 model=ModelConfig(model="sinerf"))
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, n_iters=iters,
                                                seed=seed))
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(seed), dev)
    pool = pool_from_images(scene.imgs[:-1], scene.poses[:-1], scene.hwf,
                            device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = train(model, cfg, pool, scene, log_every=1000)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    grid = og.conservative(state.grid)
    gt = torch.as_tensor(scene.imgs[-1:], device=dev)
    rec = {"seed": seed, "iters": iters, "hw": scene.hwf[0],
           "model": "sinerf", "train_s": train_s,
           "steps_per_s": state.step / train_s,
           "train_rays_per_s": state.step * cfg.train.batch_size / train_s}
    for name, march in (("kernel7", False), ("kernel2", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        frames = render_views(model, grid, cfg, scene.poses[-1:], scene.hwf,
                              scene.near, scene.far, dev, march=march)
        torch.cuda.synchronize()
        m = evaluate_frames(frames, gt)
        rec.update({f"heldout_psnr_{name}": float(m["psnr"]),
                    f"heldout_ssim_{name}": float(m["ssim"]),
                    f"eval_s_per_view_{name}": time.perf_counter() - t0})
    rec["final_occupancy"] = float(og.occupancy_fraction(state.grid))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--hw", type=int, default=800)
    ap.add_argument("--iters", type=int, default=8000)
    ap.add_argument("--seeds", default="0,1")
    ap.add_argument("--out", default="out/sinerf_gate.jsonl")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the SiNeRF gate needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    from ..data.synthetic import SphereScene

    dev = torch.device("cuda")
    card = card_name()
    t0 = time.perf_counter()
    scene = SphereScene(n_imgs=9, hw=args.hw)
    print(f"scene built in {time.perf_counter() - t0:.1f} s on the host")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = dict(run_seed(seed, args.iters, scene, dev), card=card)
        print(json.dumps(rec), flush=True)
        with open(args.out, "a") as fh:
            fh.write(json.dumps(rec) + "\n")


if __name__ == "__main__":
    main()
