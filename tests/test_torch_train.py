"""fsnerf_tpu_torch's training path against fsnerf_tpu: schedules, losses,
one Adam update, the ray pool, the compaction ladder, the divergence guard,
the grid-refresh interval, one whole train step from a shared state with
the JAX step's own random draws, a 5-step loss trajectory, and a tiny CLI
run on the CPU.

The JAX step runs its fused Pallas train kernel in interpret mode (as
tests/test_pallas.py does); the port's step runs the kernels' plain
versions, which is what its wrappers take for CPU tensors.
"""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from fsnerf_tpu.config import Config as JConfig
from fsnerf_tpu.config import DataConfig as JDataConfig
from fsnerf_tpu.config import EncoderConfig as JEncoderConfig
from fsnerf_tpu.config import ModelConfig as JModelConfig
from fsnerf_tpu.config import SamplingConfig as JSamplingConfig
from fsnerf_tpu.config import TrainConfig as JTrainConfig
from fsnerf_tpu.core import losses as jlosses
from fsnerf_tpu.core import schedules as jsched
from fsnerf_tpu.data.pool import pool_from_images as jpool_from_images
from fsnerf_tpu.ops import occgrid as jog
from fsnerf_tpu.train import loop as jloop
from fsnerf_tpu.train import step as jstep
from fsnerf_tpu_torch import cli
from fsnerf_tpu_torch.config import (Config, DataConfig, EncoderConfig,
                                     ModelConfig, SamplingConfig, TrainConfig)
from fsnerf_tpu_torch.core import losses, schedules
from fsnerf_tpu_torch.core.models import NeRF
from fsnerf_tpu_torch.data.pool import pool_from_images
from fsnerf_tpu_torch.data.synthetic import SphereScene
from fsnerf_tpu_torch.ops import occgrid as og
from fsnerf_tpu_torch.train import loop, step
from fsnerf_tpu_torch.utils.interop import (state_dict_from_jax,
                                            train_state_from_jax)
from torch_parity import SMALL, nerf_params_np, t


def _both(**sections):
    """The same configuration for both packages."""
    jcls = dict(encoder=JEncoderConfig, model=JModelConfig, data=JDataConfig,
                sampling=JSamplingConfig, train=JTrainConfig)
    tcls = dict(encoder=EncoderConfig, model=ModelConfig, data=DataConfig,
                sampling=SamplingConfig, train=TrainConfig)
    return (JConfig(**{k: jcls[k](**v) for k, v in sections.items()}),
            Config(**{k: tcls[k](**v) for k, v in sections.items()}))


@pytest.mark.parametrize("kind", ["const", "exp"])
def test_schedules_match_jax(kind):
    """rtol 1e-6: both evaluate in float32 (XLA's pow may differ by an
    ulp)."""
    jcfg, tcfg = _both(train=dict(scheduler=kind, n_iters=1000, lro=5e-4,
                                  decay_rate=0.1))
    js, ts = jsched.make_schedule(jcfg), schedules.make_schedule(tcfg)
    for k in (0, 1, 17, 500, 999, 1000, 4000):
        np.testing.assert_allclose(ts(k), float(js(k)), rtol=1e-6)


def test_losses_match_jax():
    """rtol 1e-6 (mse, psnr, occlusion) and 1e-5 (the weight norms sum
    ~20k terms in another order)."""
    rng = np.random.default_rng(0)
    pred, gt = rng.uniform(size=(2, 64, 3)).astype(np.float32)
    m_t = losses.mse(t(pred), t(gt))
    m_j = jlosses.mse(jnp.asarray(pred), jnp.asarray(gt))
    np.testing.assert_allclose(float(m_t), float(m_j), rtol=1e-6)
    np.testing.assert_allclose(float(losses.psnr_from_mse(m_t)),
                               float(jlosses.psnr_from_mse(m_j)), rtol=1e-6)
    sig = rng.normal(2, 3, (16, 24)).astype(np.float32)
    tv = np.sort(rng.uniform(2, 6, (16, 24)), -1).astype(np.float32)
    mask = rng.uniform(size=(16, 24)) < 0.6
    mask[3] = False                              # a ray without samples
    for func in ("linear", "exp"):
        for m in (mask, None):
            got = losses.occlusion_reg(
                t(sig), t(tv), None if m is None else torch.as_tensor(m),
                0.1, 0.7, func)
            want = jlosses.occlusion_reg(
                jnp.asarray(sig), jnp.asarray(tv),
                None if m is None else jnp.asarray(m), 0.1, 0.7, func)
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    params = nerf_params_np(1)
    model = NeRF(**SMALL)
    model.load_state_dict(state_dict_from_jax(params))
    for norm in ("l1", "l2"):
        np.testing.assert_allclose(
            float(losses.weight_reg(model.named_parameters(), norm).detach()),
            float(jlosses.weight_reg(params, norm)), rtol=1e-5)


def test_adam_update_matches_optax():
    """One update with identical gradients: parameters within rtol 1e-6 and
    an absolute 1e-5 * lr (optax evaluates the bias correction 1 - b2**t in
    float32, where 0.999 rounds to 0.99900001, torch.optim.Adam in double,
    so an update differs by up to ~7e-6 of itself); then a second update:
    both moments within rtol 1e-6 plus 1e-6 of their largest element
    (torch's lerp and optax's b1*m + (1-b1)*g round differently where two
    gradients cancel)."""
    _, tcfg = _both(train=dict(lro=5e-3, n_iters=100))
    jcfg = JConfig(train=JTrainConfig(lro=5e-3, n_iters=100))
    params = nerf_params_np(2)
    opt = jstep.make_optimizer(jcfg)
    ostate = opt.init(params)
    model = NeRF(**SMALL)
    model.load_state_dict(state_dict_from_jax(params))
    topt = step.make_optimizer(tcfg, model)
    sched = schedules.make_schedule(tcfg)
    rng = np.random.default_rng(3)
    for k in range(2):
        grads = jax.tree.map(
            lambda p: rng.normal(0, 1e-2, p.shape).astype(np.float32),
            params)
        upd, ostate = opt.update(grads, ostate, params)
        params = optax.apply_updates(params, upd)
        tg = state_dict_from_jax(grads)
        for name, p in model.named_parameters():
            p.grad = tg[name].clone()
        for group in topt.param_groups:
            group["lr"] = sched(k)
        topt.step()
        if k == 0:
            want = state_dict_from_jax(params)
            for name, p in model.named_parameters():
                np.testing.assert_allclose(p.detach().numpy(),
                                           want[name].numpy(), rtol=1e-6,
                                           atol=1e-5 * 5e-3)
    mu, nu = (state_dict_from_jax(ostate[0].mu),
              state_dict_from_jax(ostate[0].nu))
    for name, p in model.named_parameters():
        st = topt.state[p]
        for got, want in ((st["exp_avg"], mu[name]),
                          (st["exp_avg_sq"], nu[name])):
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                       atol=1e-6 * float(want.abs().max()))


def test_ray_pool_matches_jax():
    """The pool's rays (atol 1e-6, as the ray tests) and the batch gathered
    at indices drawn by the JAX pool's key."""
    scene = SphereScene(n_imgs=2, hw=10)
    jp = jpool_from_images(scene.imgs, scene.poses, scene.hwf)
    tp = pool_from_images(scene.imgs, scene.poses, scene.hwf)
    assert tp.n == jp.n == 200
    key = jax.random.key(5)
    idx = jax.random.randint(key, (32,), 0, jp.n)
    for a, b in zip(tp.gather(torch.from_numpy(np.array(idx)).long()),
                    jp.sample(key, 32)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
    g = torch.Generator().manual_seed(0)
    idx_t = tp.sample_indices(g, 1000)
    assert idx_t.min() >= 0 and idx_t.max() < tp.n
    o, d, rgb = tp.sample(torch.Generator().manual_seed(0), 1000)
    assert torch.equal(rgb, tp.rgb[idx_t]) and o.shape == d.shape == (1000, 3)


def test_compaction_controller_matches_jax():
    seq = [460.0, 300.0, 290.0, 120.0, 130.0, 118.0, 119.0, 70.0, 500.0,
           64.0, 63.0, 10.0, 10.0]
    for margin, adapt, ceiling in ((1.0, True, 192), (1.25, True, 192),
                                   (1.0, False, 192), (1.0, True, 16)):
        jcfg, tcfg = _both(sampling=dict(compact_margin=margin,
                                         adapt_compact=adapt,
                                         n_compact=ceiling))
        jc, tc = jloop.CompactionController(jcfg), \
            loop.CompactionController(tcfg)
        assert tc.enabled == jc.enabled
        for nv in seq:
            assert tc.observe(nv) == jc.observe(nv)
            assert tc.k == jc.k
            assert tc.target(nv) == jc.target(nv)
        assert tc.apply(tcfg).sampling.n_compact == \
            jc.apply(jcfg).sampling.n_compact


def test_divergence_guard_matches_jax():
    finite = [(100, 0.1, 12.0), (600, 0.01, 20.0), (700, 0.02, 25.0),
              (800, 0.2, 13.0), (900, 0.3, 12.0)]
    for halt in (False, True):
        jg, tg = (jloop.DivergenceGuard(halt_on_collapse=halt),
                  loop.DivergenceGuard(halt_on_collapse=halt))
        for k, loss, psnr in finite + [(1000, float("nan"), 5.0)]:
            m = {"loss": loss, "psnr": psnr}
            assert tg.observe(k, m) == jg.observe(k, m)
            assert (tg.tripped, tg.best_psnr) == (jg.tripped, jg.best_psnr)


def test_update_interval_and_occupancy_match_jax():
    for late, start in ((64, 1024), (0, 1024), (16, 100)):
        jcfg, tcfg = _both(sampling=dict(update_interval_late=late,
                                         update_interval_late_start=start))
        for k in (0, 15, 99, 100, 1023, 1024, 5000):
            assert step.resolve_update_interval(tcfg.sampling, k) == int(
                jstep.resolve_update_interval(jcfg.sampling, k))
    jg = jog.update(jog.create(jnp.zeros(6).at[3:].set(1.0), 8), lambda x:
                    jnp.where(x[:, 0] > 0.5, 5.0, 0.0), None, jnp.asarray(0))
    tg = og.update(og.create(np.array([0, 0, 0, 1, 1, 1], np.float32), 8),
                   lambda x: torch.where(x[:, 0] > 0.5, 5.0, 0.0), 0)
    assert float(og.occupancy_fraction(tg)) == float(
        jog.occupancy_fraction(jg)) == 0.5


class _Draws:
    """The JAX step's draws for one step, handed to the port's step."""

    def __init__(self, key, n_pool, batch, grid, k_cells):
        _, k_batch, k_render, k_grid = jax.random.split(key, 4)
        self.idx = torch.from_numpy(np.array(
            jax.random.randint(k_batch, (batch,), 0, n_pool))).long()
        self.u = t(jax.random.uniform(k_render, (batch, 1)))
        keys = jax.random.split(k_grid, grid.levels)
        self.gj = [t(jax.random.uniform(k, (k_cells, 3))) for k in keys]

    def batch_indices(self, pool, batch_size):
        return self.idx

    def render_jitter(self, n_rays, device):
        return self.u

    def grid_jitter(self, grid, k_cells):
        assert k_cells == self.gj[0].shape[0]
        return self.gj


@pytest.fixture
def jax_interpret_kernel(monkeypatch):
    """The JAX step's fused train kernel in interpret mode (128-row
    blocks), as tests/test_pallas.py runs it on the CPU."""
    import fsnerf_tpu.ops.pallas.mlp_train as jmt
    monkeypatch.setattr(jmt, "make_fused_train_model_fn", functools.partial(
        jmt.make_fused_train_model_fn, block_rows=128, interpret=True))


def jax_refresh(params, grid, key, step, jcfg, pos_mask=None):
    """The JAX package's counterpart of the port's NeRF grid refresh: its
    og.update driven by make_fused_density_fn (the density kernel, in
    interpret mode) with the step's grid key, FreeNeRF mask and hold."""
    from fsnerf_tpu.ops.pallas.mlp import make_fused_density_fn

    s = jcfg.sampling
    hold = s.grid_hold_steps
    if hold < 0:
        hold = jcfg.encoder.freq_reg_end or 0
    fn = make_fused_density_fn(
        params, n_layers=jcfg.model.n_layers, skip=tuple(jcfg.model.skip),
        n_freqs=jcfg.encoder.n_freqs, interpret=True, pos_mask=pos_mask)
    return jog.update(grid, fn, key, jnp.asarray(step),
                      render_step_size=s.render_step_size,
                      occ_thre=s.occ_thre, ema_decay=s.ema_decay,
                      warmup_steps=s.warmup_steps,
                      update_parts=s.update_parts,
                      update_interval=int(jstep.resolve_update_interval(
                          s, step)), hold_steps=hold)


def test_train_step_matches_jax(jax_interpret_kernel):
    """One whole step from the same state with the JAX step's draws: loss
    within rel 1e-3, every parameter gradient within 2e-2 of its max
    |JAX gradient|, and the grid after the step's refresh (the density
    kernel's plain version) against the JAX og.update driven by the
    density kernel on the JAX step's weights (jax_refresh): binarized
    occupancy equal, the threshold within rel 1e-5 and the EMA values
    within 1e-7 + 1e-2 * |occ| (why not bitwise: below). Then a 5-step
    loss trajectory within rel 2e-2."""
    sections = dict(
        encoder=dict(n_freqs=4, n_freqs_views=2),
        model=dict(n_layers=4, d_filter=64, skip=(2,), fused_kernel=True),
        data=dict(dataset="sphere", white_bkgd=True),
        sampling=dict(n_samples=64, n_compact=32, grid_resolution=16,
                      render_step_size=0.05, warmup_steps=3,
                      update_interval=2),
        train=dict(n_iters=5, batch_size=64, lro=5e-3, dtype="float32"))
    jcfg, tcfg = _both(**sections)
    scene = SphereScene(n_imgs=3, hw=16)
    params = nerf_params_np(12)

    from fsnerf_tpu.core.models import make_model as jmake_model
    jmodel = jmake_model(jcfg)
    jopt = jstep.make_optimizer(jcfg)
    jpool = jpool_from_images(scene.imgs, scene.poses, scene.hwf)
    js = jstep.init_state(jmodel, jcfg, jopt, scene.aabb, jax.random.key(7))
    js = js.replace(params=jax.tree.map(jnp.asarray, params),
                    opt_state=jopt.init(jax.tree.map(jnp.asarray, params)))
    jfn = jax.jit(jstep.make_train_step(jmodel, jcfg, jopt, jpool, scene))

    model = NeRF(**SMALL)
    topt = step.make_optimizer(tcfg, model)
    template = step.init_state(model, tcfg, topt, scene.aabb)
    ts = train_state_from_jax(js, model, topt, template.grid,
                              template.generator)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf)
    tfn = step.make_train_step(model, tcfg, topt, pool, scene)

    # step 0: loss, gradients and the refreshed grid
    n = js.grid.occs.shape[1]
    draws = _Draws(js.key, jpool.n, 64, ts.grid, n)
    loss_fn = jstep.make_loss_fn(jmodel, jcfg, scene)
    _, k_batch, k_render, _ = jax.random.split(js.key, 4)
    batch = jpool.sample(k_batch, 64)
    (jl, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        js.params, batch, js.grid, k_render, js.step)
    k_grid = jax.random.split(js.key, 4)[3]
    grid0 = js.grid
    js, jm = jfn(js)
    ts, tm = tfn(ts, draws=draws)
    jgrid = jax_refresh(js.params, grid0, k_grid, 0, jcfg)
    assert abs(float(tm["loss"]) - float(jl)) / float(jl) < 1e-3
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    jg = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        want = jg[name].numpy()
        err = np.abs(p.grad.numpy() - want).max() / (np.abs(want).max()
                                                      + 1e-12)
        assert err < 2e-2, (name, err)
    np.testing.assert_array_equal(ts.grid.binaries.numpy(),
                                  np.asarray(jgrid.binaries))
    # Not bitwise: the density kernel rounds the encodings and every trunk
    # activation to bf16, so a float32 sin or matmul that rounds one ulp
    # apart in XLA and in torch flips a bf16 rounding, which moves a
    # density by up to 2^-8 of one term (the same read on the CPU with the
    # port's weights on both sides); and after Adam's first step 21,219
    # weights differed by up to 1.4e-4 (Adam moves a weight by +-lr
    # whatever the size of its gradient). Largest differences read on the
    # CPU: thre 1.4e-6 relative; occs 1.0e-5 absolute, 4.7e-3 relative.
    np.testing.assert_allclose(ts.grid.thre.item(), float(jgrid.thre),
                               rtol=1e-5)
    np.testing.assert_allclose(ts.grid.occs.numpy(), np.asarray(jgrid.occs),
                               rtol=1e-2, atol=1e-7)
    assert ts.step == int(js.step) == 1

    # steps 1..4: the loss trajectory
    for k in range(1, 5):
        k_cells = n if k < 3 else n // 4
        draws = _Draws(js.key, jpool.n, 64, ts.grid, k_cells)
        js, jm = jfn(js)
        ts, tm = tfn(ts, draws=draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=2e-2)
        np.testing.assert_allclose(float(tm["n_valid_mean"]),
                                   float(jm["n_valid_mean"]), rtol=2e-2)


def test_train_loop_learns_and_logs(tmp_path):
    """The loop on the CPU: the loss falls, metrics.jsonl gets one line per
    log step, and the ladder observes at the chunk boundaries."""
    _, cfg = _both(
        encoder=dict(n_freqs=3, n_freqs_views=2),
        model=dict(n_layers=3, d_filter=32, skip=(1,), fused_kernel=True),
        data=dict(dataset="sphere", white_bkgd=True),
        sampling=dict(n_samples=32, n_compact=32, grid_resolution=8,
                      render_step_size=0.2, warmup_steps=4,
                      update_interval=4),
        train=dict(n_iters=60, batch_size=64, lro=5e-3, scheduler="const"))
    scene = SphereScene(n_imgs=3, hw=12)
    model = NeRF(n_layers=3, d_filter=32, skip=(1,), n_freqs=3,
                 n_freqs_views=2, generator=torch.Generator().manual_seed(0))
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf)
    logger = loop.MetricsLogger(str(tmp_path))
    state = loop.train(model, cfg, pool, scene, logger=logger, log_every=20)
    logger.close()
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [20, 40, 60] and state.step == 60
    assert recs[-1]["loss"] < recs[0]["loss"]
    assert all(r["n_compact"] in (16, 32) for r in recs)
    assert loop.chunk_length(20) == 20 and loop.chunk_length(100) == 100
    assert loop.chunk_length(30) == 10 and loop.chunk_length(7) == 1


def test_resolve_fused_kernel_by_device():
    _, cfg = _both()
    assert step.resolve_fused_kernel(cfg, "cuda")
    assert not step.resolve_fused_kernel(cfg, "cpu")
    on = cfg.replace(model=dataclasses.replace(cfg.model, fused_kernel=True))
    assert step.resolve_fused_kernel(on, "cpu")
    for change in (dict(density_activation="relu"), dict(skip=(7,)),
                   dict(d_filter=30_000)):
        off = cfg.replace(model=dataclasses.replace(cfg.model, **change))
        assert not step.resolve_fused_kernel(off, "cuda")
    # any width up to W_max (padded to the kernels' widths) takes them
    for width in (48, 320, 520, 1000, 1040, 2048, 4096):
        odd = cfg.replace(model=dataclasses.replace(cfg.model,
                                                    d_filter=width))
        assert step.resolve_fused_kernel(odd, "cuda")
    with pytest.raises(ValueError):
        step.make_loss_fn(None, cfg.replace(sampling=dataclasses.replace(
            cfg.sampling, strategy="uniform")), SphereScene(1, 4), "cpu")


def _arch(cfg, **change):
    """cfg with its model's and encoder's fields replaced by `change`."""
    enc = {k: v for k, v in change.items() if hasattr(cfg.encoder, k)}
    mod = {k: v for k, v in change.items() if k not in enc}
    return cfg.replace(model=dataclasses.replace(cfg.model, **mod),
                       encoder=dataclasses.replace(cfg.encoder, **enc))


@pytest.mark.parametrize("change", [dict(n_freqs=43),
                                    dict(n_freqs_views=43),
                                    dict(n_freqs=43, n_freqs_views=43)])
def test_routes_refuse_what_the_card_kernels_refuse(change, capsys):
    """On the card the NeRF MLP routes (train, density, march) resolve off
    only for what the kernels refuse by name: an encoding wider than 256
    (43 bands: 261 columns; a width past W_max likewise,
    tests/test_torch_widths.py). Such a config trains and evaluates
    through the module, and building its step prints the one line that
    says so; the compositing kernel reads no weights and stays on; the
    CPU's plain versions take it."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr
    from fsnerf_tpu_torch.ops.kernels.volrend import volume_render_fused

    _, base = _both()
    cfg = _arch(base, **change)
    assert not step.resolve_fused_kernel(cfg, "cuda")
    assert not step.kernels_take(cfg, "cuda")
    assert step.resolve_fused_kernel(_arch(cfg, fused_kernel=True), "cpu")
    with pytest.raises(ValueError, match="train kernels take widths up to"):
        mt.TrainLayout.from_config(cfg)
    with pytest.raises(ValueError, match="train kernels take widths up to"):
        mt.TrainLayout.from_config(cfg, "cuda")
    lay = mt.TrainLayout.from_config(cfg, "cpu")
    assert lay.model_width == cfg.model.d_filter
    assert lay.width == kr.nerf_kernel_width(cfg.model.d_filter, lay.dd)
    model = make_model(cfg, torch.float32, torch.Generator().manual_seed(0))
    assert cli.make_fused_render_fn(model.state_dict(), cfg,
                                    device="cuda") is None
    assert cli.make_fused_render_fn(model.state_dict(), cfg) is None
    assert cli.make_fused_render_fn(model.state_dict(), cfg,
                                    device="cpu") is not None
    assert cli.make_composite_fn(cfg, "cuda") is volume_render_fused
    x = torch.rand(5, 3)
    sigma = step.make_density_fn(model, cfg, device="cuda")(x)
    with torch.no_grad():
        torch.testing.assert_close(sigma, model(x)[..., 0], rtol=0, atol=0)
    capsys.readouterr()
    line = step.report_module_route(cfg, "cuda")
    err = capsys.readouterr().err
    assert line is not None and line in err and "through the module" in line
    assert f"width {cfg.model.d_filter}" in line
    assert step.report_module_route(cfg, "cpu") is None


@pytest.mark.parametrize("width", [32, 40, 64, 96, 128, 192, 200, 256])
def test_routes_take_the_card_kernels_widths(width, capsys):
    """Every NeRF width up to 256 resolves to the kernels on the card,
    packed at the next of render.py::KERNEL_WIDTHS, and prints nothing."""
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    _, base = _both()
    cfg = _arch(base, d_filter=width)
    assert step.resolve_fused_kernel(cfg, "cuda")
    assert step.kernels_take(cfg, "cuda")
    lay = mt.TrainLayout.from_config(cfg)
    assert (lay.width, lay.model_width) == (kr.kernel_width(width), width)
    assert lay.width in kr.KERNEL_WIDTHS
    assert not step.resolve_fused_kernel(cfg, "cpu")
    capsys.readouterr()
    assert step.report_module_route(cfg, "cuda") is None
    assert capsys.readouterr().err == ""


@pytest.mark.parametrize("change", [
    dict(n_freqs=21), dict(n_freqs=42, n_freqs_views=20),
    dict(d_filter=192, n_freqs=42, n_freqs_views=42),
    dict(d_filter=40, n_freqs=42, n_freqs_views=42),
    dict(n_freqs_views=21), dict(d_filter=200, n_freqs_views=42)])
def test_routes_take_encodings_up_to_256_wide(change):
    """Position and direction encodings up to 256 wide (42 bands) resolve
    to the kernels on the card; at widths 193-256 a direction encoding up
    to 128 wide (20 bands) packs at 256, a wider one (21 bands: 144
    columns) at 384, where the shells' shared memory takes it."""
    from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
    from fsnerf_tpu_torch.ops.kernels import render as kr

    _, base = _both()
    cfg = _arch(base, **change)
    assert step.resolve_fused_kernel(cfg, "cuda")
    lay = mt.TrainLayout.from_config(cfg, "cuda")
    assert max(lay.de, lay.dd) <= 256
    assert lay.width == (384 if cfg.model.d_filter > 192
                         and lay.dd > kr.KERNEL_MAX_DIR_AT_256
                         else kr.kernel_width(cfg.model.d_filter))


@pytest.mark.parametrize("width,takes", [
    (32, True), (40, True), (96, True), (100, True), (192, True),
    (200, True), (256, True), (320, True), (512, True), (600, True),
    (1024, True), (1100, True), (2048, True), (20_736, False)])
def test_sinerf_routes_by_width(width, takes, capsys):
    """A SiNeRF up to W_max wide (20,480 at these 4 layers: the widest
    whose packed weights int32 offsets address) resolves to the SIREN
    kernels on the card (packed at the next kernel width: 384 and 512 on
    the column-split trunk, a multiple of 256 from 768 up on the streamed
    one); wider, the kernels refuse it by name, and the module route is
    printed."""
    from fsnerf_tpu_torch.ops.kernels import siren as ks

    _, base = _both(model=dict(model="sinerf", n_layers=4, d_filter=width))
    assert step.resolve_fused_kernel(base, "cuda") == takes
    if not takes:
        assert cli.make_fused_render_fn({}, base, device="cuda") is None
    capsys.readouterr()
    line = step.report_module_route(base, "cuda")
    assert (line is None) == takes
    if not takes:
        assert "SIREN backward kernel takes widths up to W_max" in line
        assert line in capsys.readouterr().err
    assert ks.SirenLayout.from_config(base).model_width == width


def test_cli_trains_and_evaluates_small(capsys):
    """The training main path end to end at a tiny size on the CPU: train,
    then render held-out views through the ray march's plain version. The
    eval composites the live grid, dilated by a cell at this size as the
    reference's is, so the model trains long enough to be more than fog."""
    rc = cli.main(["--dataset", "sphere", "--device", "cpu", "--hw", "12",
                   "--n_imgs", "3", "--n_layers", "3", "--d_filter", "32",
                   "--skip", "1", "--n_freqs", "3", "--n_freqs_views", "2",
                   "--grid_resolution", "8", "--n_samples", "32",
                   "--n_compact", "32", "--render_step_size", "0.2",
                   "--n_iters", "150", "--batch_size", "32", "--fused_kernel",
                   "--white_bkgd", "--debug"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 150 and out["device"] == "cpu"
    assert np.isfinite(out["psnr"]) and 0.0 < out["ssim"] <= 1.0
    assert out["rays_per_sec"] > 0 and out["eval_k"] % 16 == 0
