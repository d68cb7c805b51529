"""The ranks of tests/test_torch_parallel.py: spawned processes that join
a gloo group through a FileStore and run the port's data-parallel paths on
the CPU. Imports torch and fsnerf_tpu_torch only (a spawned process
imports this module, not the test file, so it never loads jax).

`run(rank, world, workdir)` reads <workdir>/payload.pt (configs, weights,
draws) and writes what it computed to <workdir>/rank<r>.pt.
"""

import os

import torch


def small_cfg(**over):
    """The parallel tests' configuration: NeRF 4x64 skip 2, n_freqs 4/2,
    grid res 16, sphere scene; `over` maps a section to field overrides."""
    from fsnerf_tpu_torch.config import (Config, DataConfig, EncoderConfig,
                                         ModelConfig, SamplingConfig,
                                         TrainConfig)
    sections = dict(
        encoder=dict(n_freqs=4, n_freqs_views=2),
        model=dict(n_layers=4, d_filter=64, skip=(2,), fused_kernel=False),
        data=dict(dataset="sphere", white_bkgd=True),
        sampling=dict(n_samples=64, n_compact=32, grid_resolution=16,
                      render_step_size=0.05, warmup_steps=3,
                      update_interval=2),
        train=dict(n_iters=5, batch_size=64, lro=5e-3, dtype="float32"))
    for k, v in over.items():
        sections[k] = {**sections[k], **v}
    cls = dict(encoder=EncoderConfig, model=ModelConfig, data=DataConfig,
               sampling=SamplingConfig, train=TrainConfig)
    return Config(**{k: cls[k](**v) for k, v in sections.items()})


class GlobalDraws:
    """Fixed draws of a whole step for every rank: the global batch's
    indices and render jitter (each rank takes its rows) and the grid
    jitter."""

    def __init__(self, idx, u, gj):
        self.idx, self.u, self.gj = idx, u, gj

    def batch_indices(self, pool, n):
        assert n == self.idx.shape[0]
        return self.idx

    def render_jitter(self, n_rays, device):
        return self.u

    def grid_jitter(self, grid, k_cells):
        assert k_cells == self.gj[0].shape[0]
        return self.gj


def sphere_density(x, radius=1.2, value=30.0):
    return torch.where(torch.linalg.norm(x, dim=-1) < radius, value, 0.0)


def make_run(cfg, sd, scene, device="cpu"):
    """(model with weights sd, optimizer, state, pool) of cfg."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.train.step import init_state, make_optimizer

    model = make_model(cfg, torch.float32, torch.Generator().manual_seed(0),
                       device)
    if sd is not None:
        model.load_state_dict(sd)
    opt = make_optimizer(cfg, model)
    state = init_state(model, cfg, opt, scene.aabb, device)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf,
                            device=device)
    return model, opt, state, pool


def render_view(model, cfg, grid, split, mesh, fused):
    """One view of `split` through the eval renderer (cli.evaluate_split's
    pieces), tiled over mesh when given; fused: the ray march's plain
    version, else the module and the compositing."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.render.renderer import render_frame

    s = cfg.sampling
    img, depth = render_frame(
        cli.make_render_model_fn(model, cfg),
        torch.as_tensor(split.poses[0]), split.hwf, split.near, split.far,
        strategy=s.strategy, grid=grid, n_samples=s.n_samples,
        n_fine=s.n_fine, render_step_size=s.render_step_size,
        white_bkgd=split.white_bkgd, chunksize=100,
        n_compact=s.n_compact, early_stop_eps=s.early_stop_eps,
        query_stride=og.grid_query_stride(s, split.aabb, grid),
        fused_render_fn=(cli.make_fused_render_fn(model.state_dict(), cfg,
                                                  device="cpu")
                         if fused else None),
        composite_fn=cli.make_composite_fn(cfg, "cpu"), mesh=mesh)
    return img, depth


def run(rank, world, workdir):
    import torch.distributed as dist

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.parallel import (distributed_init, make_mesh,
                                           replicate)
    from fsnerf_tpu_torch.parallel.train_parallel import \
        make_parallel_train_step
    from fsnerf_tpu_torch.train.loop import MetricsLogger, train

    torch.set_num_threads(1)
    p = torch.load(os.path.join(workdir, "payload.pt"), weights_only=False)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    distributed_init("gloo", store=store, rank=rank, world_size=world)
    mesh = make_mesh(world, device="cpu")
    out = {}
    scene = SphereScene(n_imgs=3, hw=16)

    # one step with the JAX parallel step's per-device draws
    cfg = small_cfg()
    model, opt, state, pool = make_run(cfg, p["sd"], scene)
    replicate(state, mesh)
    step = make_parallel_train_step(model, cfg, opt, pool, scene, mesh)
    state, m = step(state, draws=GlobalDraws(*p["jax_draws"]))
    out["step"] = {"metrics": {k: float(v) for k, v in m.items()},
                   "grads": {n: q.grad.clone()
                             for n, q in model.named_parameters()},
                   "weights": {n: q.detach().clone()
                               for n, q in model.named_parameters()},
                   "occs": state.grid.occs.clone(),
                   "thre": state.grid.thre.clone()}

    # the sharded refresh of an analytic density: every cell, then a part
    refreshed = {}
    for part, jit in (("all", p["refresh_jitter"]["all"]),
                      (1, p["refresh_jitter"][1])):
        grid = og.create(scene.aabb, 16, 2, 1)
        og.update_(grid, sphere_density, None, False, render_step_size=0.05,
                   jitter=[j.clone() for j in p["refresh_jitter"]["all"]],
                   shard=mesh)
        if part != "all":
            og.update_(grid, sphere_density, part, False,
                       render_step_size=0.05, jitter=jit, shard=mesh)
        refreshed[part] = (grid.occs.clone(), grid.thre.clone(),
                           grid.binaries.clone())
    # and of the module's densities (the stepped weights)
    from fsnerf_tpu_torch.train.step import make_density_fn
    grid = og.create(scene.aabb, 16, 1, 1)
    with torch.no_grad():
        og.update_(grid, make_density_fn(model, cfg, device="cpu"), None,
                   False, render_step_size=0.05, jitter=p["jax_draws"][2],
                   shard=mesh)
    refreshed["module"] = (grid.occs.clone(), grid.thre.clone(),
                           grid.binaries.clone())
    out["refresh"] = refreshed

    # one view rendered tiled, through the march and through the module
    held = cli.build_split("sphere", 1, 16, True, 3)
    rcfg = small_cfg(model=dict(fused_kernel=True))
    out["render"] = {fused: render_view(model, rcfg, state.grid, held, mesh,
                                        fused)
                     for fused in (True, False)}

    # train(mesh=) for 30 steps through a change of the ladder's rung
    tcfg = small_cfg(sampling=dict(n_samples=128, n_compact=128,
                                   warmup_steps=8, update_interval=4),
                     train=dict(n_iters=30, lro=1e-2, scheduler="const",
                                val=True, val_rate=15))
    model, opt, state, pool = make_run(tcfg, p["sd"], scene)
    logger = MetricsLogger(os.path.join(workdir, "log") if rank == 0
                           else None)
    vals = []

    def val_fn(s, k):
        vals.append(k)
        return cli.make_val_fn(model, tcfg, held, "cpu", mesh)(s, k)

    state = train(model, tcfg, pool, scene, logger=logger, log_every=5,
                  val_fn=val_fn, mesh=mesh)
    logger.close()
    out["train"] = {"weights": {n: q.detach().clone()
                                for n, q in model.named_parameters()},
                    "occs": state.grid.occs.clone(),
                    "generator": state.generator.get_state(),
                    "ladder": state.ladder, "step": state.step,
                    "vals": vals}
    torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
