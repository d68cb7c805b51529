"""The training step (port of fsnerf_tpu/train/step.py).

One step: batch draw on the device -> samples (occgrid: lattice, occupancy
mask, compaction; hierarchical: stratified coarse bins, then inverse-CDF
fine samples) -> the MLP (the fused train kernels of
ops/kernels/mlp_train.py for NeRF or ops/kernels/siren.py for SiNeRF, or
the module) -> volume integration -> MSE
(+ regularizers) -> gradients -> Adam -> under occgrid, every
update_interval steps the occupancy-grid EMA refresh with the updated
weights (a NeRF's densities through the density kernel of
ops/kernels/mlp.py where the fused kernels are on), written into the
grid's own tensors. Nothing in a step waits on the device: its metrics
stay there as tensors.

Step kinds. What the JAX step decides on the device (its lax.cond on the
refresh, jnp.where on the weight regularizer) the port decides on the host
from the step count by the same rules (`step_kind`): the refresh (none, all
cells, or part p), its culling hold, and the weight regularizer. Each kind
is one fixed sequence of kernels, so on the card `make_train_chunk` runs a
step by replaying the CUDA graph captured for its kind (`StepGraph`): the
host does one graph launch per step, with no autograd, optimizer or launch
work, and a replay is bitwise the eager step. Everything a step reads from
its step count on the device (the FreeNeRF masks, the card's lr) comes from
the state's device counter `step_t`.

Randomness. The JAX step splits its key into batch, render and grid keys,
and the hierarchical renderer splits the render key into the coarse
jitter's and the PDF draws'. The port's step takes the same draws from one
source (`GeneratorDraws`): by default the state's generator (registered
with each graph, so a replay draws what the eager step draws), or draws
handed in (the tests hand it the JAX step's own).
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch

from ..core.encoding import freq_mask
from ..core.losses import mse, occlusion_reg, psnr_from_mse, weight_reg
from ..core.schedules import make_schedule
from ..ops import occgrid as og
from ..ops.kernels import add_launches, launch_counts
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
    with eps_root 0); the step sets the schedule's LR before each update.

    For a model on the card: capturable Adam with its lr a 0-d float32
    tensor there, which the step fills from the device schedule, so eager
    and graphed steps run the same update (its bias corrections are
    float32 on the device, as optax's are; torch's host form takes them in
    double). On the CPU torch refuses capturable: the lr is a host float."""
    lr = make_schedule(cfg)(0)
    device = next(model.parameters()).device
    if device.type == "cuda":
        return torch.optim.Adam(
            model.parameters(), betas=(0.9, 0.999), eps=1e-8,
            lr=torch.tensor(lr, dtype=torch.float32, device=device),
            capturable=True)
    return torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                            eps=1e-8)


def fused_kernels_wanted(cfg, device) -> bool:
    """ModelConfig.fused_kernel with its auto mode (None) resolved: on for
    CUDA devices."""
    want = cfg.model.fused_kernel
    if want is None:
        want = torch.device(device).type == "cuda"
    return bool(want)


def kernels_refusal(cfg, device) -> Optional[str]:
    """Why the card's kernels refuse cfg's architecture on `device`, or
    None. The NeRF and SIREN kernels take every width (packed at
    ops/kernels/render.py::kernel_width: 384 and 512 on the column-split
    trunk, 768 and every multiple of 256 above on the streamed trunk) up
    to W_max, the widest whose packed weights int32 offsets address
    (render.py::MAX_PACKED_WEIGHTS: 15,872 for a NeRF of 8 layers, skip 4,
    n_freqs 10/4; 15,360 for an 8-layer SiNeRF); the NeRF ones encodings
    up to 256 wide (a module of 193-256 units whose direction encoding is
    wider than 128 packs at 384). A wider NeRF or SiNeRF has no kernel
    (render.py::kernel_arch_error, siren.py::siren_kernel_error) and is
    refused. On the CPU their plain versions take any architecture."""
    if torch.device(device).type != "cuda":
        return None
    from ..ops.kernels.render import kernel_width

    if cfg.model.model == "sinerf":
        from ..ops.kernels.siren import siren_kernel_error

        return siren_kernel_error(kernel_width(cfg.model.d_filter),
                                  n_layers=cfg.model.n_layers)
    from ..ops.kernels.mlp_train import TrainLayout

    return TrainLayout.of_module(cfg.model.n_layers, cfg.model.skip,
                                 cfg.model.d_filter, cfg.encoder.n_freqs,
                                 cfg.encoder.n_freqs_views).kernel_error()


def kernels_take(cfg, device) -> bool:
    """Whether the MLP kernels take cfg's architecture on `device`
    (kernels_refusal gives no reason)."""
    return kernels_refusal(cfg, device) is None


def fused_architecture(cfg) -> bool:
    """The JAX package's rule (fsnerf_tpu/train/step.py::
    resolve_fused_kernel): fused train kernels exist for view directions
    with the plain NeRF (a raw sigma head, a skip concat feeding a trunk
    layer) or SiNeRF (its ReLU sigma head is built in), at any width."""
    skip = tuple(cfg.model.skip)
    ok_nerf = (cfg.model.model == "nerf"
               and cfg.model.density_activation == "none"
               and (not skip or max(skip) < cfg.model.n_layers - 1))
    return ((ok_nerf or cfg.model.model == "sinerf")
            and not cfg.encoder.no_dirs)


def resolve_fused_kernel(cfg, device) -> bool:
    """fused_kernels_wanted, for an architecture with fused kernels
    (fused_architecture) that the kernels on `device` take (kernels_take);
    other configs resolve False and run the module."""
    return (fused_kernels_wanted(cfg, device) and fused_architecture(cfg)
            and kernels_take(cfg, device))


def report_module_route(cfg, device) -> Optional[str]:
    """Print (to stderr) and return the one line that says a run on
    `device` takes the module route where the JAX package would run its
    kernels: fused kernels wanted for an architecture that has them, which
    the card's kernels refuse (kernels_refusal). None otherwise."""
    if not (fused_kernels_wanted(cfg, device) and fused_architecture(cfg)):
        return None
    why = kernels_refusal(cfg, device)
    if why is None:
        return None
    line = (f"fsnerf_tpu_torch: {cfg.model.model} width "
            f"{cfg.model.d_filter} trains and renders through the module on "
            f"{torch.device(device)}: {why}")
    print(line, file=sys.stderr, flush=True)
    return line


def make_masks(cfg, step, device=None):
    """FreeNeRF annealed frequency masks at `step`, a Python int or the
    device step counter (None, None = off)."""
    T = cfg.encoder.freq_reg_end
    if T <= 0:
        return None, None
    return (freq_mask(cfg.encoder.n_freqs, step, T, device),
            freq_mask(cfg.encoder.n_freqs_views, step, T, device))


def make_loss_fn(model, cfg, scene, device) -> Callable:
    """loss_fn(batch, grid, render_u, step_t, weight_reg_on) -> (loss,
    (main_mse, samples_per_ray, n_valid_mean)), with the fused train kernels
    when resolve_fused_kernel says so, the FreeNeRF masks at the device step
    step_t and the occlusion / weight regularizers (beta gates the occlusion
    term and does not scale it, as in the reference; the weight term is on
    where the step kind says, step < reg_ratio * Td).

    occgrid: render_u is the [R, 1] phase jitter or None. hierarchical:
    render_u is (u_coarse [R, n_samples], u_fine [R, n_fine]) or None; the
    loss is the fine pass's MSE plus the coarse pass's, main_mse the fine
    pass's, and the occlusion term reads the fine pass's samples."""
    s_cfg, t_cfg = cfg.sampling, cfg.train
    if s_cfg.strategy not in ("occgrid", "hierarchical"):
        raise ValueError(f"unknown sampling strategy {s_cfg.strategy!r}")
    fused = None
    report_module_route(cfg, device)
    if resolve_fused_kernel(cfg, device) and cfg.model.model == "sinerf":
        from ..ops.kernels.siren import make_fused_siren_model_fn
        fused = make_fused_siren_model_fn(cfg)
    elif resolve_fused_kernel(cfg, device):
        from ..ops.kernels.mlp_train import make_fused_train_model_fn
        fused = make_fused_train_model_fn(cfg, device=device)
    q_stride = og.resolve_query_stride(s_cfg, scene.aabb)
    # MLP-evaluated samples per ray of the hierarchical strategy
    n_hier = torch.tensor(float(s_cfg.n_samples + s_cfg.n_fine),
                          device=device)

    def loss_fn(batch, grid, render_u, step_t, weight_reg_on):
        rays_o, rays_d, rgb_gt = batch
        pos_mask, dir_mask = make_masks(cfg, step_t, device)

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
        if weight_reg_on:
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


ALL_CELLS = -1         # StepKind.refresh of a refresh of every cell


@dataclass(frozen=True)
class StepKind:
    """What one step runs besides its update: `refresh`, the grid refresh
    after it (None: none; ALL_CELLS; else the part refreshed), `hold`, that
    refresh's culling hold, and `weight_reg`, the weight regularizer's
    term in the loss."""

    refresh: Optional[int] = None
    hold: bool = False
    weight_reg: bool = False


def grid_hold_steps(cfg) -> int:
    """SamplingConfig.grid_hold_steps with its auto mode (< 0) resolved:
    the culling hold lasts the FreeNeRF anneal."""
    hold = cfg.sampling.grid_hold_steps
    return (cfg.encoder.freq_reg_end or 0) if hold < 0 else hold


def step_kind(cfg, step: int) -> StepKind:
    """The kind of step `step`, by the JAX step's rules: the weight
    regularizer while step < reg_ratio * Td (make_loss_fn); under occgrid
    a refresh when step is on resolve_update_interval's interval, of every
    cell before warmup_steps and of part (step // interval) %
    update_parts after, held while step < grid_hold_steps
    (fsnerf_tpu.train.step.maybe_update_grid, fsnerf_tpu.ops.occgrid.
    update)."""
    s, t = cfg.sampling, cfg.train
    wreg = t.ao is not None and step < int(t.reg_ratio * t.Td)
    if s.strategy != "occgrid":
        return StepKind(weight_reg=wreg)
    interval = resolve_update_interval(s, step)
    if step % interval:
        return StepKind(weight_reg=wreg)
    part, hold = og.refresh_plan(step, s.warmup_steps, s.update_parts,
                                 interval, grid_hold_steps(cfg))
    return StepKind(ALL_CELLS if part is None else part, hold, wreg)


def refresh_grid(model, cfg, state: TrainState, kind: StepKind, draws,
                 device=None, mesh=None) -> None:
    """The occupancy-grid EMA refresh `kind` names, in place
    (og.update_): the densities of make_density_fn at the FreeNeRF mask of
    the device step, at jittered cell positions, all cells or one part,
    every cell occupied while held. A no-op for a kind without one. With a
    `mesh` (parallel/mesh.py) the cells' densities are evaluated rank by
    rank and gathered (og.update_'s shard)."""
    if kind.refresh is None:
        return
    s, grid = cfg.sampling, state.grid
    part = None if kind.refresh == ALL_CELLS else kind.refresh
    pos_mask, _ = make_masks(cfg, state.step_t, device)
    jitter = draws.grid_jitter(grid, grid.n_cells if part is None
                               else grid.n_cells // s.update_parts)
    with torch.no_grad():
        og.update_(grid, make_density_fn(model, cfg, pos_mask, device),
                   part, kind.hold, render_step_size=s.render_step_size,
                   occ_thre=s.occ_thre, ema_decay=s.ema_decay,
                   update_parts=s.update_parts, jitter=jitter, shard=mesh)


def _end_failed_capture(generator: torch.Generator,
                        stream: torch.cuda.Stream,
                        current: torch.cuda.Stream) -> None:
    """Make the process usable again after a capture failed.

    When a capture fails, torch.cuda.graph's exit raises from capture_end
    before it takes the generators out of their capture state, and before
    it restores the current stream: torch's default CUDA generator and the
    state's would then refuse every draw outside a graph ("Offset
    increment outside graph capture"). A capture that succeeds ends that
    state, so one of a trivial op is made with the state's generator
    registered (the default one always is), on the stream the failed
    capture used, and the current stream is set back. A capture never
    advances a generator's offset (replays do), so the state's generator
    then draws what it would have drawn with no capture attempted."""
    torch.cuda.set_stream(current)
    repair = torch.cuda.CUDAGraph()
    repair.register_generator_state(generator)
    scratch = torch.zeros(1, device=stream.device)
    with torch.cuda.graph(repair, stream=stream):
        scratch.add_(1)
    torch.cuda.set_stream(current)


class StepGraph:
    """One train step of one kind captured into a CUDA graph with a memory
    pool of its own. The state's generator is registered with it, so a
    replay draws what the eager step would and advances the generator as
    far. The kernel wrappers count during the capture, which launches
    nothing: the counts it added are taken back and added at each replay.

    Every tensor the step reads or writes outside its pool must keep its
    storage: the parameters, Adam's moments, the grid, the pool, the step
    counter, and the tables the wrappers cache (which the eager warm-up
    step made). The warp-specialized kernels' tensor maps are encoded once,
    at the capture, with those pointers."""

    def __init__(self, train_step: "TrainStep", state: TrainState,
                 kind: StepKind, stream: torch.cuda.Stream):
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(state.generator)
        before = launch_counts()
        current = torch.cuda.current_stream(stream.device)
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, stream=stream):
                self.metrics = train_step.run(state, kind)
        except RuntimeError:
            _end_failed_capture(state.generator, stream, current)
            add_launches({k: before[k] - n
                          for k, n in launch_counts().items()})
            raise
        self.capture_s = time.perf_counter() - t0
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        add_launches({k: -n for k, n in self.launches.items()})

    def replay(self) -> Dict[str, torch.Tensor]:
        """Run the step once more; its metrics tensors are overwritten."""
        self.graph.replay()
        add_launches(self.launches)
        return self.metrics


class TrainStep:
    """step(state, pool=None, draws=None) -> (state, metrics): one
    optimizer update in place, eagerly. metrics (loss, psnr, occupancy,
    samples_per_ray, n_valid_mean) are 0-d tensors on the device.

    On the card `replay(state)` runs the step from the CUDA graph of its
    kind (make_train_chunk's path); `graphs` holds them, `release` frees
    them (a new ladder rung is a new TrainStep, as the JAX loop compiles a
    new program)."""

    def __init__(self, model, cfg, optimizer: torch.optim.Optimizer, pool,
                 scene):
        self.model, self.cfg, self.optimizer = model, cfg, optimizer
        self.pool = pool
        self.device = pool.device
        self.loss_fn = make_loss_fn(model, cfg, scene, self.device)
        self.schedule = make_schedule(cfg)
        self.graphs: Dict[StepKind, StepGraph] = {}
        self._warm = set()              # kinds run once eagerly
        self._stream = None             # the capture stream
        self.mesh = None                # the data-parallel group, if any

    @property
    def graphed(self) -> bool:
        """Whether `replay` can run here (a CUDA training device)."""
        return self.device.type == "cuda"

    def kind(self, step: int) -> StepKind:
        return step_kind(self.cfg, step)

    def draw(self, draws, pool):
        """The step's (batch, render draws)."""
        n = self.cfg.train.batch_size
        batch = pool.gather(draws.batch_indices(pool, n))
        return batch, render_draws(self.cfg, draws, n, self.device)

    def reduce(self, loss, main_mse, spr, nv):
        """The step's gradients and metrics as the update reads them (the
        parallel step averages them over the ranks)."""
        return loss, main_mse, spr, nv

    def run(self, state: TrainState, kind: StepKind, pool=None,
            draws=None) -> Dict[str, torch.Tensor]:
        """The device work of one step of `kind`: draws, loss, gradients,
        Adam, the refresh; it advances state.step_t, not state.step."""
        cfg = self.cfg
        pool = self.pool if pool is None else pool
        draws = GeneratorDraws(state.generator) if draws is None else draws
        batch, render_u = self.draw(draws, pool)
        self.optimizer.zero_grad(set_to_none=True)
        loss, (main_mse, spr, nv) = self.loss_fn(
            batch, state.grid, render_u, state.step_t, kind.weight_reg)
        loss.backward()
        loss, main_mse, spr, nv = self.reduce(loss.detach(),
                                              main_mse.detach(), spr, nv)
        # optax reads the pre-update count
        lr_t = None
        for group in self.optimizer.param_groups:
            if isinstance(group["lr"], torch.Tensor):     # the card's Adam
                if lr_t is None:
                    lr_t = self.schedule(state.step_t)
                group["lr"].copy_(lr_t)
            else:
                group["lr"] = self.schedule(state.step)
        self.optimizer.step()
        refresh_grid(self.model, cfg, state, kind, draws, self.device,
                     self.mesh)
        state.step_t += 1
        return {
            "loss": loss,
            "psnr": psnr_from_mse(main_mse),
            "occupancy": og.occupancy_fraction(state.grid),
            "samples_per_ray": spr,
            "n_valid_mean": nv,
        }

    def __call__(self, state: TrainState, pool=None,
                 draws=None) -> Tuple[TrainState, dict]:
        metrics = self.run(state, self.kind(state.step), pool, draws)
        state.step += 1
        return state, metrics

    def replay(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """One step from the CUDA graph of its kind; returns the graph's
        metrics tensors (overwritten by its next replay). A kind's first
        step here runs eagerly on the capture stream, the warm-up: Adam's
        moments, the wrappers' cached tables and the libraries' workspaces
        come to exist outside any graph's pool. Its second is captured,
        then replayed; a capture that fails raises."""
        kind = self.kind(state.step)
        graph = self.graphs.get(kind)
        if graph is None:
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            if kind not in self._warm:
                self._warm.add(kind)
                current = torch.cuda.current_stream(self.device)
                self._stream.wait_stream(current)
                with torch.cuda.stream(self._stream):
                    metrics = self.run(state, kind)
                current.wait_stream(self._stream)
                state.step += 1
                return metrics
            graph = self.graphs[kind] = StepGraph(self, state, kind,
                                                  self._stream)
        metrics = graph.replay()
        state.step += 1
        return metrics

    def release(self) -> None:
        """Free the graphs (and their pools, once nothing holds their
        tensors)."""
        self.graphs.clear()
        self._warm.clear()


def make_train_step(model, cfg, optimizer: torch.optim.Optimizer, pool,
                    scene) -> TrainStep:
    """The train step of `cfg` (a TrainStep, called as step(state,
    pool=None, draws=None) -> (state, metrics))."""
    return TrainStep(model, cfg, optimizer, pool, scene)


def make_train_chunk(train_step: TrainStep, n: int,
                     graphs: Optional[bool] = None) -> Callable:
    """chunk(state, pool=None, draws=None) -> (state, metrics): `n` steps
    of train_step and the last step's metrics (the JAX chunk's x[-1]); the
    port of fsnerf_tpu/train/step.py::make_train_chunk, whose lax.scan is
    one dispatch for n updates.

    graphs None: on the card each step replays the CUDA graph of its kind
    (TrainStep.replay; the metrics are copied out of the graph), on the CPU
    the steps run eagerly, as there are no graphs. graphs False runs the
    eager steps on the card too, the loop the replays are bitwise equal to;
    graphs True on the CPU raises. A graphed chunk draws from the state's
    generator with the step's own pool: pool and draws are for eager
    chunks."""
    use_graphs = train_step.graphed if graphs is None else bool(graphs)
    if use_graphs and not train_step.graphed:
        raise ValueError("CUDA graphs need a CUDA training device, not "
                         f"{train_step.device}")

    def chunk(state: TrainState, pool=None, draws=None):
        if not use_graphs:
            for _ in range(n):
                state, metrics = train_step(state, pool, draws)
            return state, metrics
        if pool is not None or draws is not None:
            raise ValueError("a graphed chunk draws from the state's "
                             "generator and reads the step's own pool")
        for _ in range(n):
            metrics = train_step.replay(state)
        return state, {k: v.clone() for k, v in metrics.items()}

    return chunk


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
