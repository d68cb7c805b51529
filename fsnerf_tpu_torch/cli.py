"""Command line of the port (the flow of fsnerf_tpu/cli.py, both sampling
strategies; the flags of fsnerf_tpu/config.py, config.py::config_parser).

Run directory. A run writes under <out_dir>/<model>/<dataset>/<scene>/
n_imgs_<n> (`--out_dir`, default ../out/): config.yaml (the run's whole
config, which `--config FILE` reads back; flags given beside it override
it), metrics.jsonl (and wandb with `--use_wandb`), the checkpoints under
ckpt/, final_metrics.json and the camera path's frames under video/.
`--debug` writes nothing (the JAX CLI renders the path all the same;
the port renders it only where it goes).

Train (the default): builds the scene's train/val/test splits by seeded
K-means over camera positions (data/splitter.py: test 15%, then val 15%,
then `--n_imgs` training views) for `--dataset synthetic` (a Blender scene
under `--data_root`/synthetic/`--scene`), `llff` (`--data_root`/llff/
`--scene`, NDC rays and a 4-level occupancy grid) or the procedural
`sphere` and `lattice` scenes (`--hw` square views), a device-resident ray
pool of the training views and a seeded NeRF (or SiNeRF); trains it for
`--n_iters` steps (train/loop.py; the MLP through the fused train kernels
on a CUDA device); renders the val and test views and prints PSNR, SSIM
and LPIPS (None without its weights, eval/lpips.py), the test split's as
test_*, and the run's rates as one JSON line. occgrid renders them through
the fused ray-march kernel on the trained grid, as the reference does, at
the query stride that grid admits; hierarchical runs the coarse pass
through the fused forward MLP (ops/kernels/mlp.py) and the fine pass
through the ray march over the sorted coarse-and-fine union
(`--no_fused_render`: through the forward MLP too). The run then renders
the scene's camera path (the Blender orbit, the LLFF spiral) to
video/rgb_*.png and video/depth_*.png (depth through `plasma`) and, with
`--use_wandb`, to wandb; a `--debug` run without wandb renders no path.

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
ops/kernels/volrend.py) and logs its PSNR/SSIM. Checkpoints are written
every `--ckpt_every` steps and at the end; `--resume` continues from the
latest (both refused with `--debug`).

Render only (`--render_only`): restores the run directory's latest
checkpoint, or else loads reference-keyed weights (`--import_torch_ckpt
nn.pt`, or a seeded init when none are given) and rebuilds the occupancy
grid (occgrid) with one full refresh from the model's densities; then
renders the val and test views and the camera path the same way.

Data-parallel (`--distributed`, one process per GPU under torchrun): the
process joins the group (parallel/mesh.py) before any CUDA call and takes
cuda:LOCAL_RANK; with more than one rank every step's rays are sharded
over the ranks (parallel/train_parallel.py), the val, test and path
frames are rendered tiled, and only rank 0 writes and prints.

Serving artifact (`--export_render DIR`, with or without --debug; rank 0
only under --distributed): after the camera path, the trained chunk
renderer of the camera path (its K and grid query stride, chunks of
min(16384, 2 * batch_size) rays, the eval model_fn: on the card the
forward MLP or SIREN forward kernel as a registered op, the plain
compositing) is exported with torch.export to DIR/renderer.pt2 and
DIR/meta.json (utils/export.py); `load_render_artifact(DIR)` and
`render_frame_exported` replay it.

Unless --debug, the train, val and test cameras are plotted to
camera_poses.html in the run directory (plotly; camera_poses.png through
matplotlib where plotly is not installed; skipped with a warning where
neither is).

The kernels run on the card: the device is `cuda` unless `--device cpu`
asks for the CPU, where the kernels' plain versions run.

Run:  python -m fsnerf_tpu_torch.cli --dataset synthetic --scene lego \
          --data_root ../datasets --n_imgs 8 --white_bkgd --out_dir out
      python -m fsnerf_tpu_torch.cli --dataset llff --scene fern \
          --data_root ../datasets --out_dir out
      python -m fsnerf_tpu_torch.cli --dataset lattice --n_imgs 8 \
          --white_bkgd --strategy hierarchical --n_samples 64 --n_fine 128
      python -m fsnerf_tpu_torch.cli --dataset sphere --model sinerf \
          --white_bkgd --hw 800 --n_iters 8000 --debug
      python -m fsnerf_tpu_torch.cli --dataset lattice --n_imgs 3 \
          --white_bkgd --freq_reg_end 7200 --val --out_dir out
      python -m fsnerf_tpu_torch.cli --dataset synthetic --scene lego \
          --data_root ../datasets --out_dir out --render_only
      python -m fsnerf_tpu_torch.cli --config out/nerf/synthetic/lego/\
n_imgs_8/config.yaml --n_iters 200
      torchrun --nproc_per_node 4 -m fsnerf_tpu_torch.cli --distributed \
          --dataset synthetic --scene lego --data_root ../datasets
      python -m fsnerf_tpu_torch.cli --dataset synthetic --scene lego \
          --data_root ../datasets --out_dir out --render_only \
          --export_render out/lego_artifact
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from .config import config_from_args, config_parser
from .data.splitter import Split
from .ops import occgrid as og
from .train.loop import COMPACT_STEP, compaction_target

# rays per render chunk of the val/test and path renders (the occgrid
# renderer's ceiling)
EVAL_CHUNK = 16384

_log = logging.getLogger(__name__)


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
    feeding a trunk layer; on the card (device None or CUDA) an
    architecture the kernels take, train/step.py::kernels_take; occgrid
    marches the compacted samples, hierarchical its fine pass); None
    otherwise. `step` anneals the FreeNeRF masks."""
    from .train.step import kernels_take, make_masks

    if not (cfg.model.fused_render
            and cfg.model.model in ("nerf", "sinerf")
            and cfg.sampling.strategy in ("occgrid", "hierarchical")
            and kernels_take(cfg, "cuda" if device is None else device)):
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


def render_val_view(model, cfg, grid, split: Split, step: int, device=None,
                    mesh=None):
    """The first view of `split` as the in-loop validation renders it
    (fsnerf_tpu/cli.py::_val_chunk): the eval model_fn at the FreeNeRF
    masks of `step`, make_composite_fn's compositing, the live grid at the
    configured n_compact, chunks of 2 * batch_size rays, no ray march;
    tiled over `mesh` when given. Returns the image [H, W, 3]."""
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
        composite_fn=make_composite_fn(cfg, device), mesh=mesh)
    return img


def make_val_fn(model, cfg, split: Split, device=None, mesh=None):
    """The train loop's val_fn(state, step) -> {"psnr", "ssim"} of
    render_val_view on the live grid against the view's image (port of
    the val_fn of fsnerf_tpu/cli.py::main); {} for an empty split. With a
    mesh every rank calls it (the render is tiled)."""
    from .eval.metrics import psnr, ssim

    def val_fn(state, step):
        if len(split.poses) == 0:
            return {}
        img = render_val_view(model, cfg, state.grid, split, step, device,
                              mesh)
        gt = torch.as_tensor(split.imgs[0], dtype=torch.float32,
                             device=img.device)
        return {"psnr": float(psnr(img, gt)), "ssim": float(ssim(img, gt))}

    return val_fn


def evaluate_split(model, grid, split: Split, cfg,
                   chunksize: int = EVAL_CHUNK, device=None, mesh=None):
    """Metrics over a split (fsnerf_tpu/cli.py::evaluate_split): PSNR,
    SSIM and LPIPS (None without its weights, eval/lpips.py), the frames
    rendered tiled over `mesh` when given.

    Returns (metrics dict with the eval K, uint8 [N, H, W, 3] frames)."""
    from .eval.lpips import load_lpips
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
        composite_fn=make_composite_fn(cfg, device), mesh=mesh)
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
                               device=device), load_lpips(device=device))
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
                       device=None, mesh=None):
    """The scene's camera path (splitter.path_poses) rendered as the JAX
    CLI renders it: the train split's camera and bounds, the eval K from
    derive_eval_n_compact on the train split, the fused ray march
    (make_fused_render_fn) where it applies, frames quantized on the
    device, tiled over `mesh` when given. Returns the uint8 [T, C, H, W]
    rgb and depth streams of render/renderer.py::render_video."""
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
        composite_fn=make_composite_fn(cfg, device), mesh=mesh)
    return render_video(frames, d_frames)


def plot_cameras(splits, out_dir: str):
    """The train, val and test cameras to <out_dir>/camera_poses.html
    (fsnerf_tpu/cli.py: plotly; camera_poses.png where only matplotlib is
    installed). Returns the plotter, or None when the plot was skipped
    (neither library: a warning)."""
    from .utils.camera3dplotter import Camera3DPlotter

    try:
        plotter = Camera3DPlotter()
        for split, name in zip(splits, ("train", "val", "test")):
            plotter.set_poses(split.poses, name)
        plotter.save_html(os.path.join(out_dir, "camera_poses.html"))
    except Exception as e:
        _log.warning("camera plot skipped: %s", e)
        return None
    return plotter


def serving_renderer(model, cfg, grid, train_split: Split, device=None):
    """The chunk renderer of the serving artifact and its chunk size
    (fsnerf_tpu/cli.py's --export_render): the camera path's (its K from
    derive_eval_n_compact on the train split, the grid's query stride),
    make_render_model_fn's model_fn, no fused ray march, the plain
    compositing; chunks of min(16384, 2 * batch_size) rays."""
    from .render.renderer import make_chunk_renderer

    s = cfg.sampling
    chunk_renderer = make_chunk_renderer(
        make_render_model_fn(model, cfg, device=device), strategy=s.strategy,
        grid=grid, n_samples=s.n_samples, n_fine=s.n_fine,
        render_step_size=s.render_step_size,
        white_bkgd=train_split.white_bkgd, near=train_split.near,
        far=train_split.far, early_stop_eps=s.early_stop_eps,
        n_compact=derive_eval_n_compact(grid, train_split, cfg, device),
        query_stride=og.grid_query_stride(s, train_split.aabb, grid))
    return chunk_renderer, min(EVAL_CHUNK, 2 * cfg.train.batch_size)


def export_renderer(model, cfg, grid, train_split: Split, step: int,
                    device=None) -> str:
    """serving_renderer exported on `device` to cfg.log.export_render
    (utils/export.py), with the model, strategy and step in its meta.json.
    Returns the artifact's directory."""
    from .utils.export import export_render_artifact

    chunk_renderer, chunksize = serving_renderer(model, cfg, grid,
                                                 train_split, device)
    return export_render_artifact(
        chunk_renderer, chunksize, cfg.log.export_render,
        hwf=train_split.hwf, near=train_split.near, far=train_split.far,
        ndc=train_split.ndc,
        extra_meta={"model": cfg.model.model,
                    "strategy": cfg.sampling.strategy, "step": int(step)},
        device=device)


def parse_args(argv=None) -> argparse.Namespace:
    """The command line's namespace (config.py::config_parser: the JAX
    package's flags, and the port's --hw and --device)."""
    return config_parser().parse_args(argv)


def run_dir(cfg) -> str:
    """The run's directory, <out_dir>/<model>/<dataset>/<scene>/
    n_imgs_<n> (fsnerf_tpu/cli.py::main)."""
    return os.path.normpath(os.path.join(
        cfg.log.out_dir, cfg.model.model, cfg.data.dataset, cfg.data.scene,
        f"n_imgs_{cfg.data.n_imgs}"))


def run_training(model, cfg, pool, train_split: Split, val_split: Split,
                 device, out_dir: str = "", mesh=None):
    """Train on the train split's ray pool, validating on the first val
    view when cfg.train.val is set. With an out_dir: metrics.jsonl there
    (and wandb with cfg.log.use_wandb), and checkpoints under <out_dir>/ckpt
    every cfg.train.ckpt_every steps and at the end, the run continuing
    from the latest one when cfg.train.resume is set. With a mesh every
    rank trains (parallel/train_parallel.py) and only rank 0 writes.

    Returns (final TrainState, its MetricsLogger, still open for the run's
    summary and videos, dict of training numbers)."""
    from .train.loop import MetricsLogger, train
    from .train.step import init_state, make_optimizer
    from .utils.checkpoint import Checkpointer

    writer = mesh is None or mesh.rank == 0
    ckpt_dir = os.path.join(out_dir, "ckpt")
    ckpt = Checkpointer(ckpt_dir) if out_dir and writer else None
    state = None
    if cfg.train.resume and out_dir and os.path.isdir(ckpt_dir):
        # every rank restores the same file
        state = Checkpointer(ckpt_dir).restore(init_state(
            model, cfg, make_optimizer(cfg, model), train_split.aabb,
            device))
    if cfg.train.import_torch_ckpt and state is not None:
        _log.warning("--import_torch_ckpt ignored: --resume found a "
                     "checkpoint, which takes precedence")
    elif cfg.train.import_torch_ckpt and cfg.sampling.strategy == "occgrid":
        # the imported weights' grid (fsnerf_tpu/cli.py's import path): one
        # full refresh of their densities, written into the fresh state's
        # grid in place, which the step graphs read
        state = init_state(model, cfg, make_optimizer(cfg, model),
                           train_split.aabb, device)
        fresh = rebuild_grid(model, cfg, train_split.aabb, device)
        og.set_occs_(state.grid, fresh.occs, fresh.thre)
    start = 0 if state is None else state.step
    val_fn = make_val_fn(model, cfg, val_split, device, mesh) \
        if cfg.train.val else None
    run_name = (f"{cfg.model.model}_{cfg.data.dataset}_img{cfg.data.n_imgs}"
                f"_layer{cfg.model.n_layers}")
    logger = MetricsLogger((out_dir or None) if writer else None,
                           use_wandb=cfg.log.use_wandb and writer,
                           run_name=run_name)
    t0 = time.perf_counter()
    state = train(model, cfg, pool, train_split, state=state, logger=logger,
                  checkpointer=ckpt, val_fn=val_fn, mesh=mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    return state, logger, {
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
                      device, mesh=None):
    """evaluate_split on the val split, and on the test split when it has
    views, its metrics under test_ keys (fsnerf_tpu/cli.py::main)."""
    metrics, _ = evaluate_split(model, grid, val_split, cfg, device=device,
                                mesh=mesh)
    if len(test_split.imgs) > 0:
        t_metrics, _ = evaluate_split(model, grid, test_split, cfg,
                                      device=device, mesh=mesh)
        metrics.update({f"test_{k}": v for k, v in t_metrics.items()})
    return metrics


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _refuse(message: str) -> int:
    print(f"fsnerf_tpu_torch.cli: {message}", file=sys.stderr)
    return 2


def main(argv=None) -> int:
    from .utils.interop import load_state_dict_file

    args = parse_args(argv)
    cfg = config_from_args(argv)
    device = torch.device(args.device)
    if (cfg.train.resume or cfg.train.ckpt_every) and cfg.log.debug:
        return _refuse("--resume and --ckpt_every need the run directory, "
                       "which --debug does not write")
    if cfg.parallel.distributed:
        # before any CUDA call: NCCL binds this process to its GPU
        from .parallel.mesh import distributed_init, local_rank
        distributed_init("gloo" if device.type == "cpu" else None)
        if device.type == "cuda":
            device = torch.device("cuda", local_rank())
    if device.type == "cuda" and not torch.cuda.is_available():
        return _refuse("no CUDA device is available; pass --device cpu to "
                       "run the kernels' plain versions on the CPU")
    mesh = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        from .parallel.mesh import make_mesh
        mesh = make_mesh(cfg.parallel.n_devices, device=device)
    writer = mesh is None or mesh.rank == 0
    out_dir = "" if cfg.log.debug else run_dir(cfg)
    if out_dir and writer:
        os.makedirs(out_dir, exist_ok=True)
        cfg.save_yaml(os.path.join(out_dir, "config.yaml"))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 GEMMs stay f32
    t0 = time.perf_counter()
    splitter, (train_split, val_split, test_split), model, pool = \
        build_everything(cfg, args.hw, device)
    _sync(device)
    numbers = {"views": {"train": len(train_split.imgs),
                         "val": len(val_split.imgs),
                         "test": len(test_split.imgs)},
               "data_seconds": time.perf_counter() - t0}
    plotter = (plot_cameras((train_split, val_split, test_split), out_dir)
               if out_dir and writer else None)
    if cfg.train.import_torch_ckpt:
        model.load_state_dict(load_state_dict_file(cfg.train.import_torch_ckpt))
    logger = None
    if cfg.log.render_only:
        grid, restored = restored_grid(model, cfg, train_split, out_dir,
                                       device)
        numbers["restored_step"] = restored
        step = restored or 0
    else:
        state, logger, trained = run_training(
            model, cfg, pool, train_split, val_split, device, out_dir, mesh)
        grid, step = state.grid, state.step
        numbers.update(trained)
        if plotter and logger.wandb:    # the reference uploads the figure
            plotter.upload_plot()
    t0 = time.perf_counter()
    metrics = evaluate_val_test(model, grid, val_split, test_split, cfg,
                                device, mesh)
    _sync(device)
    n_eval = len(val_split.imgs) + len(test_split.imgs)
    numbers["eval_seconds_per_view"] = (time.perf_counter() - t0) / n_eval
    if out_dir and writer and not cfg.log.render_only:
        with open(os.path.join(out_dir, "final_metrics.json"), "w") as fh:
            json.dump(metrics, fh)
    if logger:
        logger.log_summary(metrics)
    if out_dir or cfg.log.use_wandb:
        # the camera path, where it goes: the run directory or wandb (the
        # same on every rank, whose tiled render needs them all)
        t0 = time.perf_counter()
        rgb8, dep8 = render_camera_path(model, cfg, grid, splitter,
                                        train_split, device, mesh)
        seconds = time.perf_counter() - t0
        numbers.update(path_frames=len(rgb8),
                       path_frames_per_sec=len(rgb8) / seconds)
        if out_dir and writer:
            save_video(rgb8, dep8, os.path.join(out_dir, "video"))
        if logger:
            logger.log_video("rgb_video", rgb8)
            logger.log_video("depth_video", dep8)
    if cfg.log.export_render and writer:
        t0 = time.perf_counter()
        path = export_renderer(model, cfg, grid, train_split, step, device)
        numbers.update(export_render=path,
                       export_seconds=time.perf_counter() - t0)
        _log.info("exported the serving artifact to %s", path)
    if logger:
        logger.close()
    if not writer:
        return 0
    metrics.update(numbers)
    metrics["device"] = (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu")
    if mesh is not None:
        metrics["ranks"] = mesh.world
    print(json.dumps(metrics))
    return 0


if __name__ == "__main__":
    sys.exit(main())
