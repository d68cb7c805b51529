"""Command line of the port (the train and eval paths of
fsnerf_tpu/cli.py, both sampling strategies).

Train (the default): builds `--n_imgs` views of a procedural scene, a
device-resident ray pool and a seeded NeRF (or SiNeRF), trains it for
`--n_iters` steps (train/loop.py; the MLP through the fused train kernels
on a CUDA device), then renders held-out views of the scene and prints
PSNR/SSIM and the training rates as one JSON line. occgrid renders them
through the fused ray-march kernel on the conservative view of the trained
grid; hierarchical runs the coarse pass through the fused forward MLP
(ops/kernels/mlp.py) and the fine pass through the ray march over the
sorted coarse-and-fine union (`--no_fused_render`: through the forward MLP
too).

`--model sinerf` trains and renders SiNeRF the same ways: the MLP through
the SIREN train kernels, occgrid held-out views through the SIREN ray
march, the hierarchical coarse pass through the SIREN forward kernel.

Render only (`--render_only`): loads reference-keyed weights
(`--import_torch_ckpt nn.pt`, or a seeded init when none are given),
rebuilds the occupancy grid (occgrid) with one full refresh from the
model's densities and renders held-out views the same way.

The kernels run on the card: the device is `cuda` unless `--device cpu`
asks for the CPU, where the kernels' plain versions run.

Run:  python -m fsnerf_tpu_torch.cli --dataset lattice --n_imgs 8 \
          --white_bkgd [--n_iters 8000] [--hw 800]
      python -m fsnerf_tpu_torch.cli --dataset lattice --n_imgs 8 \
          --white_bkgd --strategy hierarchical --n_samples 64 --n_fine 128
      python -m fsnerf_tpu_torch.cli --dataset sphere --model sinerf \
          --white_bkgd --hw 800 --n_iters 8000
      python -m fsnerf_tpu_torch.cli --dataset sphere --render_only \
          [--import_torch_ckpt nn.pt]

LLFF, checkpoints, in-loop validation and video are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .config import (Config, DataConfig, EncoderConfig, ModelConfig,
                     SamplingConfig, TrainConfig)
from .ops import occgrid as og
from .train.loop import COMPACT_STEP, compaction_target

HELD_OUT_VIEWS = 2


@dataclass
class Split:
    """One split's images and metadata (fsnerf_tpu/data/splitter.py)."""

    imgs: np.ndarray          # [N, H, W, 3]
    poses: np.ndarray         # [N, 4, 4]
    hwf: tuple
    near: float
    far: float
    ndc: bool
    aabb: np.ndarray
    white_bkgd: bool


def make_render_model_fn(model, cfg, step=None, device=None):
    """The eval-time model_fn when resolve_fused_kernel says so: for a NeRF
    the fused forward MLP (ops/kernels/mlp.py), for a SiNeRF the SIREN
    forward kernel (ops/kernels/siren.py) with the module answering the
    density-only calls; the weights packed once. Else the module. `step`
    anneals the FreeNeRF masks (None: no masks)."""
    from .train.step import make_masks, resolve_fused_kernel

    if device is None:
        device = next(model.parameters()).device
    pos_mask, dir_mask = ((None, None) if step is None
                          else make_masks(cfg, step, device))
    if resolve_fused_kernel(cfg, device) and cfg.model.model == "sinerf":
        from .ops.kernels.siren import make_siren_forward_fn
        forward = make_siren_forward_fn(model.state_dict(),
                                        cfg.model.n_layers, device=device)

        def siren_fn(x, d=None):
            return model(x) if d is None else forward(x, d)

        return siren_fn
    if resolve_fused_kernel(cfg, device) and cfg.model.model == "nerf":
        from .ops.kernels.mlp import make_fused_model_fn
        return make_fused_model_fn(
            model.state_dict(), n_layers=cfg.model.n_layers,
            skip=tuple(cfg.model.skip), n_freqs=cfg.encoder.n_freqs,
            n_freqs_views=cfg.encoder.n_freqs_views,
            log_space=cfg.encoder.log_space,
            density_activation=cfg.model.density_activation,
            pos_mask=pos_mask, dir_mask=dir_mask, device=device)

    def model_fn(x, d=None):
        return model(x, d, pos_mask=pos_mask, dir_mask=dir_mask)

    return model_fn


def make_fused_render_fn(state_dict, cfg, step=None, device=None):
    """The fused ray-march renderer (ops/kernels/render.py) when the config
    allows it (fused_render on; SiNeRF, or NeRF with view dirs and the skip
    feeding a trunk layer; occgrid marches the compacted samples,
    hierarchical its fine pass); None otherwise. `step` anneals the
    FreeNeRF masks."""
    if not (cfg.model.fused_render
            and cfg.model.model in ("nerf", "sinerf")
            and cfg.sampling.strategy in ("occgrid", "hierarchical")):
        return None
    if cfg.model.model == "sinerf":
        from .ops.kernels.render import make_fused_siren_ray_renderer
        return make_fused_siren_ray_renderer(
            state_dict, n_layers=cfg.model.n_layers,
            early_stop_eps=cfg.sampling.early_stop_eps, device=device)
    skip = tuple(cfg.model.skip)
    if cfg.encoder.no_dirs or (skip and max(skip) >= cfg.model.n_layers - 1):
        return None
    from .ops.kernels.render import make_fused_ray_renderer
    from .train.step import make_masks

    pos_mask, dir_mask = ((None, None) if step is None
                          else make_masks(cfg, step))
    return make_fused_ray_renderer(
        state_dict, n_layers=cfg.model.n_layers, skip=skip,
        n_freqs=cfg.encoder.n_freqs, n_freqs_views=cfg.encoder.n_freqs_views,
        log_space=cfg.encoder.log_space,
        density_activation=cfg.model.density_activation,
        early_stop_eps=cfg.sampling.early_stop_eps,
        pos_mask=pos_mask, dir_mask=dir_mask, device=device)


def derive_eval_n_compact(grid, split: Split, cfg, device=None) -> int:
    """Eval-time compaction K from the converged grid: probe up to 3 poses
    (rays subsampled to ~4096, no model evaluation), take each pose's 97th
    percentile valid-sample count and return the largest ladder target."""
    from .data.rays import get_rays, to_ndc
    from .render.renderer import count_valid_samples

    s = cfg.sampling
    k_max = int(s.n_compact) if s.n_compact else 0
    enabled = (s.adapt_compact and s.strategy == "occgrid"
               and k_max > COMPACT_STEP)
    if not enabled or len(split.poses) == 0:
        return s.n_compact
    q_stride = og.resolve_query_stride(s, split.aabb)
    n_probe = min(3, len(split.poses))
    probe_idx = [int(i * len(split.poses) / n_probe) for i in range(n_probe)]
    k = COMPACT_STEP
    for i in probe_idx:
        pose = torch.as_tensor(np.asarray(split.poses[i], np.float32),
                               device=device)
        ro, rd = get_rays(pose, split.hwf)
        ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        if split.ndc:
            ro, rd = to_ndc(ro, rd, split.hwf, 1.0)
        stride = max(1, ro.shape[0] // 4096)
        nv = count_valid_samples(
            ro[::stride], rd[::stride], grid, s.n_samples,
            render_step_size=s.render_step_size,
            early_stop_eps=s.early_stop_eps, query_stride=q_stride)
        k = max(k, compaction_target(float(torch.quantile(nv, 0.97)),
                                     k_max, s.compact_margin))
    return k


def rebuild_grid(model, cfg, aabb, device=None):
    """Occupancy grid from the model's densities: one full refresh at step
    0 with deterministic cell centres (fsnerf_tpu/cli.py, import path)."""
    s = cfg.sampling
    _, dilation = og.resolve_query_plan(s, aabb)
    grid = og.create(aabb, s.grid_resolution, s.grid_levels, dilation,
                     device=device)
    with torch.no_grad():
        return og.update(grid, lambda x: model(x)[..., 0], 0,
                         render_step_size=s.render_step_size,
                         occ_thre=s.occ_thre, ema_decay=s.ema_decay)


def evaluate_split(model, grid, split: Split, cfg, chunksize: int = 16384,
                   device=None):
    """Metrics over a split (fsnerf_tpu/cli.py::evaluate_split).

    Returns (metrics dict with the eval K, uint8 [N, H, W, 3] frames)."""
    from .eval.metrics import evaluate_frames
    from .render.renderer import make_chunk_renderer, render_frame

    s = cfg.sampling
    q_stride = og.resolve_query_stride(s, split.aabb)
    eval_k = derive_eval_n_compact(grid, split, cfg, device)
    model_fn = make_render_model_fn(model, cfg, device=device)
    chunk_renderer = make_chunk_renderer(
        model_fn, strategy=s.strategy, grid=grid, n_samples=s.n_samples,
        n_fine=s.n_fine, render_step_size=s.render_step_size,
        white_bkgd=split.white_bkgd, near=split.near, far=split.far,
        n_compact=eval_k, early_stop_eps=s.early_stop_eps,
        query_stride=q_stride,
        fused_render_fn=make_fused_render_fn(model.state_dict(), cfg,
                                             device=device))
    preds = []
    for pose in split.poses:
        img, _ = render_frame(
            model_fn, torch.as_tensor(np.asarray(pose, np.float32),
                                      device=device),
            split.hwf, split.near, split.far, strategy=s.strategy,
            ndc=split.ndc, chunksize=chunksize,
            chunk_renderer=chunk_renderer)
        preds.append(img)
    preds = torch.stack(preds)
    metrics = evaluate_frames(
        preds, torch.as_tensor(split.imgs, dtype=torch.float32,
                               device=device))
    metrics["eval_k"] = eval_k
    frames = torch.clamp(preds * 255, 0, 255).to(torch.uint8)
    return metrics, frames.cpu().numpy()


def build_split(dataset: str, n_views: int, hw: int, white_bkgd: bool,
                seed: int) -> Split:
    """Views of a procedural scene (the K-means splitter of the JAX package
    is not ported; these views come from their own seed)."""
    return split_of(scene_class(dataset)(n_imgs=n_views, hw=hw,
                                         white_bkgd=white_bkgd, seed=seed))


def scene_class(dataset: str):
    from .data.synthetic import LatticeScene, SphereScene

    return {"sphere": SphereScene, "lattice": LatticeScene}[dataset]


def split_of(scene) -> Split:
    return Split(scene.imgs, scene.poses, scene.hwf, scene.near, scene.far,
                 False, np.asarray(scene.aabb), scene.white_bkgd)


def parse_args(argv=None):
    d_enc, d_mod, d_smp = EncoderConfig(), ModelConfig(), SamplingConfig()
    d_trn, d_dat = TrainConfig(), DataConfig()
    p = argparse.ArgumentParser(
        description="Train a NeRF or SiNeRF on a procedural scene and "
                    "render its held-out views, or render them from given "
                    "weights (PyTorch + CUDA port).", allow_abbrev=False)
    p.add_argument("--dataset", choices=["sphere", "lattice"],
                   default="sphere")
    p.add_argument("--render_only", action="store_true",
                   help="skip training: render from --import_torch_ckpt "
                        "weights (or the seeded init)")
    p.add_argument("--import_torch_ckpt", default=None,
                   help="reference nn.pt state dict (default: seeded init)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu, where the kernels' "
                        "plain versions run")
    p.add_argument("--seed", type=int, default=d_trn.seed)
    p.add_argument("--hw", type=int, default=64, help="image side")
    p.add_argument("--n_imgs", type=int, default=d_dat.n_imgs,
                   help="training views")
    p.add_argument("--white_bkgd", action="store_true")
    p.add_argument("--out_dir", default="",
                   help="write metrics.jsonl of the training run here")
    p.add_argument("--model", choices=["nerf", "sinerf"],
                   default=d_mod.model)
    p.add_argument("--dtype", choices=["bfloat16", "float32"],
                   default=d_trn.dtype, help="the module's compute dtype")
    p.add_argument("--n_layers", type=int, default=d_mod.n_layers)
    p.add_argument("--d_filter", type=int, default=d_mod.d_filter)
    p.add_argument("--skip", default=",".join(map(str, d_mod.skip)))
    p.add_argument("--density_activation", default=d_mod.density_activation,
                   choices=["none", "relu", "trunc_exp"])
    p.add_argument("--fused_kernel", action="store_true", default=None,
                   help="train and render through the fused MLP kernels' "
                        "plain versions on the CPU too (default: on for "
                        "CUDA devices only)")
    p.add_argument("--no_fused_render", action="store_true",
                   help="render without the fused ray-march kernel")
    p.add_argument("--n_freqs", type=int, default=d_enc.n_freqs)
    p.add_argument("--n_freqs_views", type=int, default=d_enc.n_freqs_views)
    p.add_argument("--strategy", choices=["occgrid", "hierarchical"],
                   default=d_smp.strategy)
    p.add_argument("--n_samples", type=int, default=d_smp.n_samples,
                   help="occgrid lattice samples, or hierarchical coarse "
                        "samples")
    p.add_argument("--n_fine", type=int, default=d_smp.n_fine,
                   help="hierarchical inverse-CDF samples")
    p.add_argument("--n_compact", type=int, default=d_smp.n_compact)
    p.add_argument("--grid_resolution", type=int,
                   default=d_smp.grid_resolution)
    p.add_argument("--render_step_size", type=float,
                   default=d_smp.render_step_size)
    p.add_argument("--early_stop_eps", type=float,
                   default=d_smp.early_stop_eps)
    p.add_argument("--n_iters", type=int, default=d_trn.n_iters)
    p.add_argument("--batch_size", type=int, default=d_trn.batch_size)
    p.add_argument("--lro", type=float, default=d_trn.lro)
    return p.parse_args(argv)


def config_from_args(args) -> Config:
    cfg = Config()
    skip = tuple(int(s) for s in args.skip.split(",") if s.strip())
    return cfg.replace(
        encoder=dataclasses.replace(cfg.encoder, n_freqs=args.n_freqs,
                                    n_freqs_views=args.n_freqs_views),
        model=dataclasses.replace(
            cfg.model, model=args.model, n_layers=args.n_layers,
            d_filter=args.d_filter,
            skip=skip, density_activation=args.density_activation,
            fused_kernel=args.fused_kernel,
            fused_render=not args.no_fused_render),
        data=DataConfig(dataset=args.dataset, n_imgs=args.n_imgs,
                        white_bkgd=args.white_bkgd),
        sampling=dataclasses.replace(
            cfg.sampling, strategy=args.strategy, n_samples=args.n_samples,
            n_fine=args.n_fine, n_compact=args.n_compact,
            grid_resolution=args.grid_resolution,
            render_step_size=args.render_step_size,
            early_stop_eps=args.early_stop_eps),
        train=dataclasses.replace(
            cfg.train, n_iters=args.n_iters, batch_size=args.batch_size,
            lro=args.lro, seed=args.seed, dtype=args.dtype))


def run_training(model, cfg, hw: int, device, out_dir: str = ""):
    """Train on cfg.data.n_imgs views of the procedural scene.

    Returns (final TrainState, the scene, dict of training numbers)."""
    from .data.pool import pool_from_images
    from .train.loop import MetricsLogger, train

    scene = scene_class(cfg.data.dataset)(
        n_imgs=cfg.data.n_imgs, hw=hw, white_bkgd=cfg.data.white_bkgd,
        seed=cfg.train.seed)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf,
                            device=device)
    logger = MetricsLogger(out_dir or None)
    t0 = time.perf_counter()
    state = train(model, cfg, pool, scene, logger=logger)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    logger.close()
    return state, scene, {"steps": state.step, "train_seconds": seconds,
                          "rays_per_sec": state.step * cfg.train.batch_size
                          / seconds}


def main(argv=None) -> int:
    from .core.models import make_model
    from .utils.interop import load_state_dict_file

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("fsnerf_tpu_torch.cli: no CUDA device is available; pass "
              "--device cpu to run the kernels' plain versions on the CPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 GEMMs stay f32
    cfg = config_from_args(args)
    dtype = torch.bfloat16 if cfg.train.dtype == "bfloat16" else torch.float32
    model = make_model(cfg, dtype,
                       torch.Generator().manual_seed(args.seed), device)
    if args.import_torch_ckpt:
        model.load_state_dict(load_state_dict_file(args.import_torch_ckpt))
    if args.render_only:
        split = build_split(args.dataset, HELD_OUT_VIEWS, args.hw,
                            args.white_bkgd, args.seed + 1)
        grid = (rebuild_grid(model, cfg, split.aabb, device)
                if cfg.sampling.strategy == "occgrid" else None)
        metrics, _ = evaluate_split(model, grid, split, cfg, device=device)
    else:
        state, scene, numbers = run_training(model, cfg, args.hw, device,
                                             args.out_dir)
        held_out = split_of(scene.holdout(n=HELD_OUT_VIEWS,
                                          seed=args.seed + 1))
        metrics, _ = evaluate_split(model, og.conservative(state.grid),
                                    held_out, cfg, device=device)
        metrics.update(numbers)
    metrics["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
