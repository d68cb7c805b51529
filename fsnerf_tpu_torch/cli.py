"""Command line of the port (the flow of fsnerf_tpu/cli.py, both sampling
strategies).

Train (the default): builds the scene's train/val/test splits by seeded
K-means over camera positions (data/splitter.py: test 15%, then val 15%,
then `--n_imgs` training views) for `--dataset synthetic` (a Blender scene
under `--data_root`/synthetic/`--scene`), `llff` (`--data_root`/llff/
`--scene`, NDC rays and a 4-level occupancy grid) or the procedural
`sphere` and `lattice` scenes (`--hw` square views), a device-resident ray
pool of the training views and a seeded NeRF (or SiNeRF); trains it for
`--n_iters` steps (train/loop.py; the MLP through the fused train kernels
on a CUDA device); renders the val and test views and prints PSNR/SSIM, the
test split's as test_psnr/test_ssim, and the run's rates as one JSON line.
occgrid renders them through the fused ray-march kernel on the trained
grid, as the reference does, at the query stride that grid admits;
hierarchical runs the coarse pass through the fused forward MLP
(ops/kernels/mlp.py) and the fine pass through the ray march over the
sorted coarse-and-fine union (`--no_fused_render`: through the forward MLP
too). With `--out_dir`, the run then writes final_metrics.json, its
checkpoint, and renders the scene's camera path (the Blender orbit, the
LLFF spiral) to video/rgb_*.png and video/depth_*.png (depth through
`plasma`).

`--model sinerf` trains and renders SiNeRF the same ways: the MLP through
the SIREN train kernels, occgrid views through the SIREN ray march, the
hierarchical coarse pass through the SIREN forward kernel.

Few-shot training: `--freq_reg_end T` anneals the FreeNeRF frequency
masks over T steps, with the occupancy grid's culling hold through the
anneal (`--grid_hold_steps`, -1 = auto); `--beta` turns on the occlusion
regularizer (`--a`, `--b`, `--func`) and `--ao` the weight regularizer
(`--reg`, `--reg_ratio`, `--Td`). The grid refresh of a NeRF runs the
density kernel (ops/kernels/mlp.py::nerf_density) at the step's masks.
`--val` renders the first val view every `--val_rate` steps at the live
masks (the fused forward MLP, then the compositing kernel
ops/kernels/volrend.py) and logs its PSNR/SSIM. With `--out_dir`, the run
writes metrics.jsonl and full-state checkpoints under <out_dir>/ckpt
(every `--ckpt_every` steps and at the end; `--resume` continues from the
latest).

Render only (`--render_only`): restores the latest checkpoint under
`--out_dir`, or else loads reference-keyed weights (`--import_torch_ckpt
nn.pt`, or a seeded init when none are given) and rebuilds the occupancy
grid (occgrid) with one full refresh from the model's densities; then
renders the val and test views and, with `--out_dir`, the camera path the
same way.

The kernels run on the card: the device is `cuda` unless `--device cpu`
asks for the CPU, where the kernels' plain versions run.

Run:  python -m fsnerf_tpu_torch.cli --dataset synthetic --scene lego \
          --data_root ../datasets --n_imgs 8 --white_bkgd --out_dir out/lego
      python -m fsnerf_tpu_torch.cli --dataset llff --scene fern \
          --data_root ../datasets --out_dir out/fern
      python -m fsnerf_tpu_torch.cli --dataset lattice --n_imgs 8 \
          --white_bkgd --strategy hierarchical --n_samples 64 --n_fine 128
      python -m fsnerf_tpu_torch.cli --dataset sphere --model sinerf \
          --white_bkgd --hw 800 --n_iters 8000
      python -m fsnerf_tpu_torch.cli --dataset lattice --n_imgs 3 \
          --white_bkgd --freq_reg_end 7200 --val --out_dir out/fewshot
      python -m fsnerf_tpu_torch.cli --dataset synthetic --scene lego \
          --data_root ../datasets --out_dir out/lego --render_only
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np
import torch

from .config import (Config, DataConfig, EncoderConfig, ModelConfig,
                     SamplingConfig, TrainConfig)
from .data.splitter import Split
from .ops import occgrid as og
from .train.loop import COMPACT_STEP, compaction_target

# rays per render chunk of the val/test and path renders (the occgrid
# renderer's ceiling)
EVAL_CHUNK = 16384


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
    allows it (fused_render on; SiNeRF, or NeRF with view dirs, the skip
    feeding a trunk layer and, on the card (device None or CUDA), a width
    the NeRF march takes; occgrid marches the compacted samples,
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
    from .train.step import make_masks, nerf_kernels_take

    if not nerf_kernels_take(cfg, "cuda" if device is None else device):
        return None

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
    q_stride = og.grid_query_stride(s, split.aabb, grid)
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
    """Occupancy grid from the model's densities (the refresh's density
    function, train/step.py::make_density_fn): one full refresh at step 0
    with deterministic cell centres (fsnerf_tpu/cli.py, import path)."""
    from .train.step import make_density_fn

    s = cfg.sampling
    _, dilation = og.resolve_query_plan(s, aabb)
    grid = og.create(aabb, s.grid_resolution, s.grid_levels, dilation,
                     device=device)
    with torch.no_grad():
        return og.update(grid, make_density_fn(model, cfg, device=device), 0,
                         render_step_size=s.render_step_size,
                         occ_thre=s.occ_thre, ema_decay=s.ema_decay)


def make_composite_fn(cfg, device=None):
    """The eval-time compositing of the model's outputs: the forward kernel
    ops/kernels/volrend.py::volume_render_fused when the fused kernels are
    wanted (it reads no weights, so any architecture), else
    ops/volrend.py::volume_render."""
    from .train.step import fused_kernels_wanted

    if fused_kernels_wanted(cfg, device):
        from .ops.kernels.volrend import volume_render_fused
        return volume_render_fused
    from .ops.volrend import volume_render
    return volume_render


def render_val_view(model, cfg, grid, split: Split, step: int, device=None):
    """The first view of `split` as the in-loop validation renders it
    (fsnerf_tpu/cli.py::_val_chunk): the eval model_fn at the FreeNeRF
    masks of `step`, make_composite_fn's compositing, the live grid at the
    configured n_compact, chunks of 2 * batch_size rays, no ray march.
    Returns the image [H, W, 3]."""
    from .render.renderer import render_frame

    s = cfg.sampling
    img, _ = render_frame(
        make_render_model_fn(model, cfg, step=step, device=device),
        torch.as_tensor(np.asarray(split.poses[0], np.float32),
                        device=device),
        split.hwf, split.near, split.far, strategy=s.strategy, grid=grid,
        n_samples=s.n_samples, n_fine=s.n_fine,
        render_step_size=s.render_step_size, ndc=split.ndc,
        white_bkgd=split.white_bkgd, chunksize=2 * cfg.train.batch_size,
        n_compact=s.n_compact, early_stop_eps=s.early_stop_eps,
        query_stride=og.grid_query_stride(s, split.aabb, grid),
        composite_fn=make_composite_fn(cfg, device))
    return img


def make_val_fn(model, cfg, split: Split, device=None):
    """The train loop's val_fn(state, step) -> {"psnr", "ssim"} of
    render_val_view on the live grid against the view's image (port of
    the val_fn of fsnerf_tpu/cli.py::main); {} for an empty split."""
    from .eval.metrics import psnr, ssim

    def val_fn(state, step):
        if len(split.poses) == 0:
            return {}
        img = render_val_view(model, cfg, state.grid, split, step, device)
        gt = torch.as_tensor(split.imgs[0], dtype=torch.float32,
                             device=img.device)
        return {"psnr": float(psnr(img, gt)), "ssim": float(ssim(img, gt))}

    return val_fn


def evaluate_split(model, grid, split: Split, cfg,
                   chunksize: int = EVAL_CHUNK, device=None):
    """Metrics over a split (fsnerf_tpu/cli.py::evaluate_split).

    Returns (metrics dict with the eval K, uint8 [N, H, W, 3] frames)."""
    from .eval.metrics import evaluate_frames
    from .render.renderer import make_chunk_renderer, render_frame

    s = cfg.sampling
    q_stride = og.grid_query_stride(s, split.aabb, grid)
    eval_k = derive_eval_n_compact(grid, split, cfg, device)
    model_fn = make_render_model_fn(model, cfg, device=device)
    chunk_renderer = make_chunk_renderer(
        model_fn, strategy=s.strategy, grid=grid, n_samples=s.n_samples,
        n_fine=s.n_fine, render_step_size=s.render_step_size,
        white_bkgd=split.white_bkgd, near=split.near, far=split.far,
        n_compact=eval_k, early_stop_eps=s.early_stop_eps,
        query_stride=q_stride,
        fused_render_fn=make_fused_render_fn(model.state_dict(), cfg,
                                             device=device),
        composite_fn=make_composite_fn(cfg, device))
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
    """`n_views` views of a procedural scene drawn from their own seed (no
    K-means split): held-out views for the kernels' checks."""
    return split_of(scene_class(dataset)(n_imgs=n_views, hw=hw,
                                         white_bkgd=white_bkgd, seed=seed))


def scene_class(dataset: str):
    from .data.synthetic import LatticeScene, SphereScene

    return {"sphere": SphereScene, "lattice": LatticeScene}[dataset]


def split_of(scene) -> Split:
    return Split(scene.imgs, scene.poses, scene.hwf, scene.near, scene.far,
                 False, np.asarray(scene.aabb), scene.white_bkgd)


def make_splitter(cfg, hw: int = 64):
    """The scene's Splitter, split (fsnerf_tpu/cli.py::build_everything);
    `hw` sizes the procedural scenes."""
    from .data.splitter import Splitter

    d = cfg.data
    splitter = Splitter(
        d.dataset, d.scene, n_training_views=d.n_imgs,
        val_ratio=d.val_ratio, test_ratio=d.test_ratio,
        data_root=d.data_root, white_bkgd=d.white_bkgd, factor=d.factor,
        bd_factor=d.bd_factor, recenter=not d.no_recenter,
        seed=cfg.train.seed, downsample=d.downsample, hw=hw)
    splitter.split()
    return splitter


def build_everything(cfg, hw: int = 64, device=None):
    """(splitter, (train, val, test) Splits, seeded model, ray pool of the
    train split: NDC rays for LLFF), as fsnerf_tpu/cli.py::build_everything
    builds them."""
    from .core.models import make_model
    from .data.pool import pool_from_images

    splitter = make_splitter(cfg, hw)
    splits = splitter.get_splits()
    train_split = splits[0]
    dtype = torch.bfloat16 if cfg.train.dtype == "bfloat16" else torch.float32
    model = make_model(cfg, dtype,
                       torch.Generator().manual_seed(cfg.train.seed), device)
    pool = pool_from_images(train_split.imgs, train_split.poses,
                            train_split.hwf, ndc=train_split.ndc,
                            device=device)
    return splitter, splits, model, pool


def save_video(rgb8: np.ndarray, dep8: np.ndarray, out_dir: str):
    """Write the uint8 [T, C, H, W] rgb and depth streams as
    rgb_{i:04d}.png and depth_{i:04d}.png frames (the JAX package's
    fallback without an mp4 writer); returns the names written."""
    from .native import write_png

    os.makedirs(out_dir, exist_ok=True)
    names = []
    for i in range(rgb8.shape[0]):
        for kind, stream in (("rgb", rgb8), ("depth", dep8)):
            name = f"{kind}_{i:04d}.png"
            write_png(os.path.join(out_dir, name),
                      np.transpose(stream[i], (1, 2, 0)))
            names.append(name)
    return names


def render_camera_path(model, cfg, grid, splitter, train_split: Split,
                       device=None):
    """The scene's camera path (splitter.path_poses) rendered as the JAX
    CLI renders it: the train split's camera and bounds, the eval K from
    derive_eval_n_compact on the train split, the fused ray march
    (make_fused_render_fn) where it applies, frames quantized on the
    device. Returns the uint8 [T, C, H, W] rgb and depth streams of
    render/renderer.py::render_video."""
    from .render.renderer import render_path, render_video

    s = cfg.sampling
    frames, d_frames = render_path(
        make_render_model_fn(model, cfg, device=device), splitter.path_poses,
        train_split.hwf, train_split.near, train_split.far, device=device,
        compact_transfer=True, strategy=s.strategy, grid=grid,
        n_samples=s.n_samples, n_fine=s.n_fine,
        render_step_size=s.render_step_size, ndc=train_split.ndc,
        white_bkgd=train_split.white_bkgd, chunksize=EVAL_CHUNK,
        n_compact=derive_eval_n_compact(grid, train_split, cfg, device),
        early_stop_eps=s.early_stop_eps,
        query_stride=og.grid_query_stride(s, train_split.aabb, grid),
        fused_render_fn=make_fused_render_fn(model.state_dict(), cfg,
                                             device=device),
        composite_fn=make_composite_fn(cfg, device))
    return render_video(frames, d_frames)


def parse_args(argv=None):
    d_enc, d_mod, d_smp = EncoderConfig(), ModelConfig(), SamplingConfig()
    d_trn, d_dat = TrainConfig(), DataConfig()
    p = argparse.ArgumentParser(
        description="Train a NeRF or SiNeRF on a scene's K-means training "
                    "views and render its val and test views and camera "
                    "path, or render them from a checkpoint or given "
                    "weights (PyTorch + CUDA port).", allow_abbrev=False)
    p.add_argument("--dataset",
                   choices=["synthetic", "llff", "sphere", "lattice"],
                   default=d_dat.dataset,
                   help="a Blender scene, an LLFF scene (NDC rays, 4 grid "
                        "levels) or a procedural scene")
    p.add_argument("--scene", default=d_dat.scene,
                   help="scene directory under <data_root>/synthetic or "
                        "<data_root>/llff")
    p.add_argument("--data_root", default=d_dat.data_root)
    p.add_argument("--factor", type=int, default=d_dat.factor,
                   help="LLFF: read images_<factor>/, focal / factor")
    p.add_argument("--bd_factor", type=float, default=d_dat.bd_factor,
                   help="LLFF: scale the scene so the nearest bound sits at "
                        "1 / bd_factor")
    p.add_argument("--no_recenter", action="store_true",
                   help="LLFF: keep the poses' own frame")
    p.add_argument("--downsample", type=int, default=d_dat.downsample,
                   help="Blender: box-filter the images by this factor")
    p.add_argument("--val_ratio", type=float, default=d_dat.val_ratio)
    p.add_argument("--test_ratio", type=float, default=d_dat.test_ratio)
    p.add_argument("--render_only", action="store_true",
                   help="skip training: render from the latest checkpoint "
                        "under --out_dir, else from --import_torch_ckpt "
                        "weights (or the seeded init)")
    p.add_argument("--import_torch_ckpt", default=None,
                   help="reference nn.pt state dict (default: seeded init)")
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu, where the kernels' "
                        "plain versions run")
    p.add_argument("--seed", type=int, default=d_trn.seed)
    p.add_argument("--hw", type=int, default=64,
                   help="image side of the procedural scenes")
    p.add_argument("--n_imgs", type=int, default=d_dat.n_imgs,
                   help="training views")
    p.add_argument("--white_bkgd", action="store_true")
    p.add_argument("--out_dir", default="",
                   help="write metrics.jsonl, the checkpoints (ckpt/), "
                        "final_metrics.json and the camera path's frames "
                        "(video/) here")
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
    g = p.add_argument_group("few-shot regularization")
    g.add_argument("--freq_reg_end", type=int, default=d_enc.freq_reg_end,
                   help="FreeNeRF: steps over which the frequency masks "
                        "anneal (0 = off)")
    g.add_argument("--grid_hold_steps", type=int,
                   default=d_smp.grid_hold_steps,
                   help="keep every grid cell occupied until this step; "
                        "-1 = auto (freq_reg_end when annealing)")
    g.add_argument("--ao", type=float, default=d_trn.ao,
                   help="weight regularizer's alpha (off when not given)")
    g.add_argument("--reg_ratio", type=float, default=d_trn.reg_ratio,
                   help="the weight regularizer runs while step < "
                        "reg_ratio * Td")
    g.add_argument("--reg", choices=["l1", "l2"], default=d_trn.reg)
    g.add_argument("--Td", type=int, default=d_trn.Td)
    g.add_argument("--a", type=float, default=d_trn.occ_a,
                   help="occlusion regularizer's amplitude")
    g.add_argument("--b", type=float, default=d_trn.occ_b,
                   help="occlusion regularizer's decay")
    g.add_argument("--func", choices=["linear", "exp"],
                   default=d_trn.occ_func,
                   help="occlusion regularizer's weighting")
    g.add_argument("--beta", type=float, default=d_trn.beta,
                   help="turns the occlusion regularizer on (it gates the "
                        "term and does not scale it)")
    g = p.add_argument_group("validation and checkpoints")
    g.add_argument("--val", action="store_true",
                   help="render the first held-out view every --val_rate "
                        "steps and log its PSNR/SSIM")
    g.add_argument("--val_rate", type=int, default=d_trn.val_rate)
    g.add_argument("--ckpt_every", type=int, default=d_trn.ckpt_every,
                   help="checkpoint every this many steps under --out_dir "
                        "(0 = only at the end)")
    g.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint under "
                        "--out_dir")
    return p.parse_args(argv)


def grid_levels(dataset: str) -> int:
    """The occupancy grid's levels for a dataset: 4 for LLFF (its NDC scene
    reaches far past the base AABB), else 1 (fsnerf_tpu/config.py)."""
    return 4 if dataset == "llff" else 1


def config_from_args(args) -> Config:
    cfg = Config()
    skip = tuple(int(s) for s in args.skip.split(",") if s.strip())
    return cfg.replace(
        encoder=dataclasses.replace(cfg.encoder, n_freqs=args.n_freqs,
                                    n_freqs_views=args.n_freqs_views,
                                    freq_reg_end=args.freq_reg_end),
        model=dataclasses.replace(
            cfg.model, model=args.model, n_layers=args.n_layers,
            d_filter=args.d_filter,
            skip=skip, density_activation=args.density_activation,
            fused_kernel=args.fused_kernel,
            fused_render=not args.no_fused_render),
        data=DataConfig(dataset=args.dataset, scene=args.scene,
                        n_imgs=args.n_imgs, white_bkgd=args.white_bkgd,
                        factor=args.factor, bd_factor=args.bd_factor,
                        no_recenter=args.no_recenter,
                        data_root=args.data_root, val_ratio=args.val_ratio,
                        test_ratio=args.test_ratio,
                        downsample=args.downsample),
        sampling=dataclasses.replace(
            cfg.sampling, strategy=args.strategy, n_samples=args.n_samples,
            grid_levels=grid_levels(args.dataset),
            n_fine=args.n_fine, n_compact=args.n_compact,
            grid_resolution=args.grid_resolution,
            render_step_size=args.render_step_size,
            early_stop_eps=args.early_stop_eps,
            grid_hold_steps=args.grid_hold_steps),
        train=dataclasses.replace(
            cfg.train, n_iters=args.n_iters, batch_size=args.batch_size,
            lro=args.lro, seed=args.seed, dtype=args.dtype, ao=args.ao,
            reg_ratio=args.reg_ratio, reg=args.reg, Td=args.Td,
            occ_a=args.a, occ_b=args.b, occ_func=args.func, beta=args.beta,
            val=args.val, val_rate=args.val_rate,
            ckpt_every=args.ckpt_every, resume=args.resume))


def run_training(model, cfg, pool, train_split: Split, val_split: Split,
                 device, out_dir: str = ""):
    """Train on the train split's ray pool, validating on the first val
    view when cfg.train.val is set. With an out_dir: metrics.jsonl there,
    and checkpoints under <out_dir>/ckpt every cfg.train.ckpt_every steps
    and at the end, the run continuing from the latest one when
    cfg.train.resume is set.

    Returns (final TrainState, dict of training numbers)."""
    from .train.loop import MetricsLogger, train
    from .train.step import init_state, make_optimizer
    from .utils.checkpoint import Checkpointer

    ckpt = Checkpointer(os.path.join(out_dir, "ckpt")) if out_dir else None
    state = None
    if cfg.train.resume and ckpt is not None:
        state = ckpt.restore(init_state(model, cfg,
                                        make_optimizer(cfg, model),
                                        train_split.aabb, device))
    start = 0 if state is None else state.step
    val_fn = make_val_fn(model, cfg, val_split, device) if cfg.train.val \
        else None
    logger = MetricsLogger(out_dir or None)
    t0 = time.perf_counter()
    state = train(model, cfg, pool, train_split, state=state, logger=logger,
                  checkpointer=ckpt, val_fn=val_fn)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    logger.close()
    return state, {
        "steps": state.step, "resumed_from": start,
        "train_seconds": seconds,
        "rays_per_sec": (state.step - start) * cfg.train.batch_size
        / seconds}


def restored_grid(model, cfg, train_split: Split, out_dir: str, device):
    """The grid to render from without training, after loading the model's
    weights: the latest checkpoint's under <out_dir>/ckpt (its weights
    loaded into `model`), or else one rebuilt from the model's densities
    (occgrid; None for hierarchical). Returns (grid, the checkpoint's step
    or None)."""
    from .train.step import init_state, make_optimizer
    from .utils.checkpoint import Checkpointer

    ckpt_dir = os.path.join(out_dir, "ckpt")
    if out_dir and os.path.isdir(ckpt_dir):
        ckpt = Checkpointer(ckpt_dir)
        if ckpt.latest_step() is not None:
            state = ckpt.restore(init_state(model, cfg,
                                            make_optimizer(cfg, model),
                                            train_split.aabb, device))
            grid = state.grid if cfg.sampling.strategy == "occgrid" else None
            return grid, state.step
    grid = (rebuild_grid(model, cfg, train_split.aabb, device)
            if cfg.sampling.strategy == "occgrid" else None)
    return grid, None


def evaluate_val_test(model, grid, val_split: Split, test_split: Split, cfg,
                      device):
    """evaluate_split on the val split, and on the test split when it has
    views, its metrics under test_ keys (fsnerf_tpu/cli.py::main)."""
    metrics, _ = evaluate_split(model, grid, val_split, cfg, device=device)
    if len(test_split.imgs) > 0:
        t_metrics, _ = evaluate_split(model, grid, test_split, cfg,
                                      device=device)
        metrics.update({f"test_{k}": v for k, v in t_metrics.items()})
    return metrics


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    from .utils.interop import load_state_dict_file

    args = parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("fsnerf_tpu_torch.cli: no CUDA device is available; pass "
              "--device cpu to run the kernels' plain versions on the CPU",
              file=sys.stderr)
        return 2
    if (args.resume or args.ckpt_every) and not args.out_dir:
        print("fsnerf_tpu_torch.cli: --resume and --ckpt_every need "
              "--out_dir, where the checkpoints live", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 GEMMs stay f32
    cfg = config_from_args(args)
    t0 = time.perf_counter()
    splitter, (train_split, val_split, test_split), model, pool = \
        build_everything(cfg, args.hw, device)
    _sync(device)
    numbers = {"views": {"train": len(train_split.imgs),
                         "val": len(val_split.imgs),
                         "test": len(test_split.imgs)},
               "data_seconds": time.perf_counter() - t0}
    if args.import_torch_ckpt:
        model.load_state_dict(load_state_dict_file(args.import_torch_ckpt))
    if args.render_only:
        grid, restored = restored_grid(model, cfg, train_split, args.out_dir,
                                       device)
        numbers["restored_step"] = restored
    else:
        state, trained = run_training(model, cfg, pool, train_split,
                                      val_split, device, args.out_dir)
        grid = state.grid
        numbers.update(trained)
    t0 = time.perf_counter()
    metrics = evaluate_val_test(model, grid, val_split, test_split, cfg,
                                device)
    _sync(device)
    n_eval = len(val_split.imgs) + len(test_split.imgs)
    numbers["eval_seconds_per_view"] = (time.perf_counter() - t0) / n_eval
    if args.out_dir:
        if not args.render_only:
            with open(os.path.join(args.out_dir, "final_metrics.json"),
                      "w") as fh:
                json.dump(metrics, fh)
        t0 = time.perf_counter()
        rgb8, dep8 = render_camera_path(model, cfg, grid, splitter,
                                        train_split, device)
        seconds = time.perf_counter() - t0
        save_video(rgb8, dep8, os.path.join(args.out_dir, "video"))
        numbers.update(path_frames=len(rgb8),
                       path_frames_per_sec=len(rgb8) / seconds)
    metrics.update(numbers)
    metrics["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
