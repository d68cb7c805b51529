"""The training step (port of fsnerf_tpu/train/step.py).

One step: batch draw on the device -> samples (occgrid: lattice, occupancy
mask, compaction; hierarchical: stratified coarse bins, then inverse-CDF
fine samples) -> the MLP (the fused train kernels of
ops/kernels/mlp_train.py for NeRF or ops/kernels/siren.py for SiNeRF, or
the module) -> volume integration -> MSE
(+ regularizers) -> gradients -> Adam -> under occgrid, every
update_interval steps the occupancy-grid EMA refresh with the updated
weights (a NeRF's densities through the density kernel of
ops/kernels/mlp.py where the fused kernels are on). Nothing in a step waits
on the device: its metrics stay there as tensors.

Randomness. The JAX step splits its key into batch, render and grid keys,
and the hierarchical renderer splits the render key into the coarse
jitter's and the PDF draws'. The port's step takes the same draws from one
source (`GeneratorDraws`): by default the state's generator, or draws
handed in (the tests hand it the JAX step's own).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from ..core.encoding import freq_mask
from ..core.losses import mse, occlusion_reg, psnr_from_mse, weight_reg
from ..core.schedules import make_schedule
from ..ops import occgrid as og
from ..render.renderer import render_rays_hierarchical, render_rays_occgrid
from .state import TrainState


class GeneratorDraws:
    """The step's random draws from one torch.Generator on the training
    device: batch indices, then the render draws (occgrid: the per-ray
    phase jitter; hierarchical: the per-bin coarse jitter, then the PDF
    draws), then the per-level cell jitter of a grid refresh."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def batch_indices(self, pool, batch_size: int) -> torch.Tensor:
        return pool.sample_indices(self.generator, batch_size)

    def render_jitter(self, n_rays: int, device) -> torch.Tensor:
        """[n_rays, 1] uniform [0, 1) stratified phase."""
        return torch.rand((n_rays, 1), generator=self.generator,
                          device=device)

    def stratified_u(self, n_rays: int, n_samples: int, device):
        """[n_rays, n_samples] uniform [0, 1) per-bin coarse jitter."""
        return torch.rand((n_rays, n_samples), generator=self.generator,
                          device=device)

    def pdf_u(self, n_rays: int, n_samples: int, device):
        """[n_rays, n_samples] uniform [0, 1 - 1e-5) inverse-CDF draws (the
        JAX draw's maxval)."""
        return torch.rand((n_rays, n_samples), generator=self.generator,
                          device=device) * (1.0 - 1e-5)

    def grid_jitter(self, grid: og.OccGrid, k_cells: int):
        """Per level, [k_cells, 3] uniform [0, 1) positions in the cells."""
        return [torch.rand((k_cells, 3), generator=self.generator,
                           device=grid.occs.device)
                for _ in range(grid.levels)]


def make_optimizer(cfg, model: torch.nn.Module) -> torch.optim.Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8 outside the sqrt, as optax.adam
    with eps_root 0); the step sets the schedule's LR before each update."""
    return torch.optim.Adam(model.parameters(), lr=make_schedule(cfg)(0),
                            betas=(0.9, 0.999), eps=1e-8)


def fused_kernels_wanted(cfg, device) -> bool:
    """ModelConfig.fused_kernel with its auto mode (None) resolved: on for
    CUDA devices."""
    want = cfg.model.fused_kernel
    if want is None:
        want = torch.device(device).type == "cuda"
    return bool(want)


def nerf_kernels_take(cfg, device) -> bool:
    """Whether the NeRF MLP kernels take cfg's architecture on `device`:
    on the card the warp-specialized ones are built for the widths
    ops/kernels/render.py::KERNEL_WIDTHS and encodings up to KERNEL_MAX_ENC
    wide; on the CPU their plain versions take any width."""
    if torch.device(device).type != "cuda":
        return True
    from ..ops.kernels.mlp_train import TrainLayout

    return TrainLayout(cfg.model.n_layers, tuple(cfg.model.skip),
                       cfg.model.d_filter, cfg.encoder.n_freqs,
                       cfg.encoder.n_freqs_views).kernel_error() is None


def resolve_fused_kernel(cfg, device) -> bool:
    """fused_kernels_wanted, for an architecture the kernels take: the
    train kernels exist for view directions and a width that is a multiple
    of 32, with the plain NeRF (a raw sigma head, a skip concat feeding a
    trunk layer, and on the card nerf_kernels_take's widths) or SiNeRF
    (its ReLU sigma head is built in); other configs resolve False and run
    the module."""
    skip = tuple(cfg.model.skip)
    ok_nerf = (cfg.model.model == "nerf"
               and cfg.model.density_activation == "none"
               and (not skip or max(skip) < cfg.model.n_layers - 1)
               and nerf_kernels_take(cfg, device))
    ok = ((ok_nerf or cfg.model.model == "sinerf")
          and not cfg.encoder.no_dirs and cfg.model.d_filter % 32 == 0)
    return fused_kernels_wanted(cfg, device) and ok


def make_masks(cfg, step: int, device=None):
    """FreeNeRF annealed frequency masks at `step` (None, None = off)."""
    T = cfg.encoder.freq_reg_end
    if T <= 0:
        return None, None
    return (freq_mask(cfg.encoder.n_freqs, step, T, device),
            freq_mask(cfg.encoder.n_freqs_views, step, T, device))


def make_loss_fn(model, cfg, scene, device) -> Callable:
    """loss_fn(batch, grid, render_u, step) -> (loss, (main_mse,
    samples_per_ray, n_valid_mean)), with the fused train kernels when
    resolve_fused_kernel says so, the FreeNeRF masks and the occlusion /
    weight regularizers (beta gates the occlusion term and does not scale
    it, as in the reference).

    occgrid: render_u is the [R, 1] phase jitter or None. hierarchical:
    render_u is (u_coarse [R, n_samples], u_fine [R, n_fine]) or None; the
    loss is the fine pass's MSE plus the coarse pass's, main_mse the fine
    pass's, and the occlusion term reads the fine pass's samples."""
    s_cfg, t_cfg = cfg.sampling, cfg.train
    if s_cfg.strategy not in ("occgrid", "hierarchical"):
        raise ValueError(f"unknown sampling strategy {s_cfg.strategy!r}")
    fused = None
    if resolve_fused_kernel(cfg, device) and cfg.model.model == "sinerf":
        from ..ops.kernels.siren import make_fused_siren_model_fn
        fused = make_fused_siren_model_fn(cfg)
    elif resolve_fused_kernel(cfg, device):
        from ..ops.kernels.mlp_train import make_fused_train_model_fn
        fused = make_fused_train_model_fn(cfg, device=device)
    Ts = int(t_cfg.reg_ratio * t_cfg.Td)
    q_stride = og.resolve_query_stride(s_cfg, scene.aabb)
    # MLP-evaluated samples per ray of the hierarchical strategy
    n_hier = torch.tensor(float(s_cfg.n_samples + s_cfg.n_fine),
                          device=device)

    def loss_fn(batch, grid, render_u, step):
        rays_o, rays_d, rgb_gt = batch
        pos_mask, dir_mask = make_masks(cfg, step, device)

        def model_fn(x, d=None):
            if fused is not None and d is not None:
                return fused(model, x, d, pos_mask, dir_mask)
            return model(x, d, pos_mask=pos_mask, dir_mask=dir_mask)

        if s_cfg.strategy == "occgrid":
            out = render_rays_occgrid(
                model_fn, rays_o, rays_d, grid, s_cfg.n_samples,
                render_step_size=s_cfg.render_step_size, jitter=render_u,
                white_bkgd=cfg.data.white_bkgd, n_compact=s_cfg.n_compact,
                early_stop_eps=s_cfg.early_stop_eps, query_stride=q_stride)
            loss = main_mse = mse(out["rgb"], rgb_gt)
            # MLP-evaluated samples per ray, and the mean pre-compaction
            # valid count that drives the compaction ladder (train/loop.py)
            spr = torch.mean(torch.sum(out["mask"].to(torch.float32), dim=-1))
            nv = torch.mean(out["n_valid"])
        else:
            u_c, u_f = render_u if render_u is not None else (None, None)
            coarse, out = render_rays_hierarchical(
                model_fn, rays_o, rays_d, scene.near, scene.far,
                s_cfg.n_samples, s_cfg.n_fine, u_c, u_f,
                white_bkgd=cfg.data.white_bkgd)
            main_mse = mse(out["rgb"], rgb_gt)
            loss = main_mse + mse(coarse["rgb"], rgb_gt)
            spr = nv = n_hier
        if t_cfg.beta is not None:
            loss = loss + occlusion_reg(out["sigmas"], out["t_vals"],
                                        out["mask"], t_cfg.occ_a,
                                        t_cfg.occ_b, t_cfg.occ_func)
        if t_cfg.ao is not None and step < Ts:
            loss = loss + t_cfg.ao * weight_reg(model.named_parameters(),
                                                t_cfg.reg)
        return loss, (main_mse, spr, nv)

    return loss_fn


def render_draws(cfg, draws, n_rays: int, device):
    """The render draws of one step (None without perturb): the occgrid
    phase jitter [R, 1], or the hierarchical (coarse jitter, PDF draws)."""
    s = cfg.sampling
    if not s.perturb:
        return None
    if s.strategy == "occgrid":
        return draws.render_jitter(n_rays, device)
    return (draws.stratified_u(n_rays, s.n_samples, device),
            draws.pdf_u(n_rays, s.n_fine, device))


def resolve_update_interval(s_cfg, step: int) -> int:
    """Grid-refresh interval at `step`: update_interval, then
    update_interval_late from update_interval_late_start on (0 or equal
    keeps the early interval)."""
    early, late = s_cfg.update_interval, s_cfg.update_interval_late
    if not late or late == early:
        return early
    return late if step >= s_cfg.update_interval_late_start else early


def make_density_fn(model, cfg, pos_mask=None, device=None) -> Callable:
    """density_fn(x [N, 3]) -> sigma [N] of the grid refresh at the
    FreeNeRF mask pos_mask: for a NeRF where resolve_fused_kernel holds, the
    density kernel (ops/kernels/mlp.py::make_fused_density_fn, weights
    packed on their device; float32 sigma, as the JAX package's
    fused_density returns), else the module (a SiNeRF always: there is no
    SIREN density kernel)."""
    if resolve_fused_kernel(cfg, device) and cfg.model.model == "nerf":
        from ..ops.kernels.mlp import make_fused_density_fn
        return make_fused_density_fn(
            model.state_dict(), n_layers=cfg.model.n_layers,
            skip=tuple(cfg.model.skip), n_freqs=cfg.encoder.n_freqs,
            log_space=cfg.encoder.log_space,
            density_activation=cfg.model.density_activation,
            pos_mask=pos_mask, device=device)

    def density_fn(x):
        return model(x, pos_mask=pos_mask)[..., 0]

    return density_fn


def maybe_update_grid(model, cfg, grid: og.OccGrid, step: int, draws,
                      device=None) -> og.OccGrid:
    """The occupancy-grid EMA refresh when `step` is on the interval: the
    densities of make_density_fn at the step's FreeNeRF mask, at jittered
    cell positions, all cells during warmup and a round-robin part after;
    every cell stays occupied through the culling hold."""
    s = cfg.sampling
    if s.strategy != "occgrid":
        return grid
    interval = resolve_update_interval(s, step)
    if step % interval:
        return grid
    pos_mask, _ = make_masks(cfg, step, device)
    hold = s.grid_hold_steps
    if hold < 0:                  # auto: hold culling through the anneal
        hold = cfg.encoder.freq_reg_end or 0
    k_cells = (grid.n_cells if step < s.warmup_steps
               else grid.n_cells // s.update_parts)
    jitter = draws.grid_jitter(grid, k_cells)
    with torch.no_grad():
        return og.update(
            grid, make_density_fn(model, cfg, pos_mask, device), step,
            render_step_size=s.render_step_size, occ_thre=s.occ_thre,
            ema_decay=s.ema_decay, warmup_steps=s.warmup_steps,
            update_parts=s.update_parts, update_interval=interval,
            hold_steps=hold, jitter=jitter)


def make_train_step(model, cfg, optimizer: torch.optim.Optimizer, pool,
                    scene) -> Callable[..., Tuple[TrainState, dict]]:
    """step(state, pool=None, draws=None) -> (state, metrics): one
    optimizer update in place. metrics (loss, psnr, occupancy,
    samples_per_ray, n_valid_mean) are 0-d tensors on the device."""
    device = pool.device
    loss_fn = make_loss_fn(model, cfg, scene, device)
    schedule = make_schedule(cfg)
    default_pool = pool

    def train_step(state: TrainState, pool=None, draws=None):
        pool = default_pool if pool is None else pool
        draws = GeneratorDraws(state.generator) if draws is None else draws
        batch = pool.gather(draws.batch_indices(pool, cfg.train.batch_size))
        render_u = render_draws(cfg, draws, cfg.train.batch_size, device)
        optimizer.zero_grad(set_to_none=True)
        loss, (main_mse, spr, nv) = loss_fn(batch, state.grid, render_u,
                                            state.step)
        loss.backward()
        lr = schedule(state.step)          # optax reads the pre-update count
        for group in optimizer.param_groups:
            group["lr"] = lr
        optimizer.step()
        state.grid = maybe_update_grid(model, cfg, state.grid, state.step,
                                       draws, device)
        state.step += 1
        metrics = {
            "loss": loss.detach(),
            "psnr": psnr_from_mse(main_mse.detach()),
            "occupancy": og.occupancy_fraction(state.grid),
            "samples_per_ray": spr,
            "n_valid_mean": nv,
        }
        return state, metrics

    return train_step


def init_state(model, cfg, optimizer, aabb, device=None) -> TrainState:
    """A fresh TrainState around an initialized model: an empty grid (all
    cells occupied until the first refresh; hierarchical never refreshes
    it, as in the reference) and the generator seeded from
    cfg.train.seed."""
    _, q_dilation = og.resolve_query_plan(cfg.sampling, aabb)
    grid = og.create(aabb, cfg.sampling.grid_resolution,
                     cfg.sampling.grid_levels, q_dilation, device=device)
    gen = torch.Generator(device=device or "cpu")
    gen.manual_seed(cfg.train.seed)
    return TrainState(model, optimizer, grid, 0, gen)
