"""fsnerf_tpu_torch's hierarchical (coarse/fine) sampling against
fsnerf_tpu: stratified bins, inverse-CDF resampling, the sorted-union merge
and its gradient, render_rays_hierarchical in its three branches, one whole
hierarchical train step from a shared state with the JAX step's own draws,
and the CLI on the CPU.

Draws: the JAX functions take keys; the port takes the draws themselves,
so each test hands the port the uniforms the JAX function draws from its
key (jax.random.uniform, the PDF draws with maxval 1 - 1e-5).
"""

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
from fsnerf_tpu.core.models import NeRF as JNeRF
from fsnerf_tpu.data.pool import pool_from_images as jpool_from_images
from fsnerf_tpu.ops import sampling as jsamp
from fsnerf_tpu.ops.pallas.render import make_fused_ray_renderer as jmarch
from fsnerf_tpu.render import renderer as jrend
from fsnerf_tpu.train import step as jstep
from fsnerf_tpu_torch import cli
from fsnerf_tpu_torch.config import (Config, DataConfig, EncoderConfig,
                                     ModelConfig, SamplingConfig, TrainConfig)
from fsnerf_tpu_torch.core.models import NeRF
from fsnerf_tpu_torch.data.pool import pool_from_images
from fsnerf_tpu_torch.data.synthetic import SphereScene
from fsnerf_tpu_torch.ops import sampling
from fsnerf_tpu_torch.ops.kernels import render as kr
from fsnerf_tpu_torch.render import renderer
from fsnerf_tpu_torch.train import step
from fsnerf_tpu_torch.utils.interop import (state_dict_from_jax,
                                            train_state_from_jax)
from torch_parity import SMALL, nerf_params_np, shell_rays, t

NEAR, FAR = 2.0, 6.0
C, F = 16, 32
PDF_MAX = 1.0 - 1e-5
ACT = "trunc_exp"


def _draws(key, n_rays):
    """The coarse jitter and PDF draws render_rays_hierarchical takes from
    `key`, as port tensors."""
    k1, k2 = jax.random.split(key)
    return (t(jax.random.uniform(k1, (n_rays, C))),
            t(jax.random.uniform(k2, (n_rays, F), maxval=PDF_MAX)))


def _pdf_inputs(n_rays=96, seed=0):
    """Sorted bins [R, C] and weights [R, C - 1]: sparse positive rays, a
    ray of zero weights (uniform PDF), a ray with one spike, and rays with
    negative weights (a raw sigma head gives them), whose CDF is not
    monotone."""
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(NEAR, FAR, (n_rays, C)), -1).astype(np.float32)
    w = rng.exponential(size=(n_rays, C - 1)).astype(np.float32)
    w *= rng.uniform(size=w.shape) < 0.5
    w[0] = 0.0
    w[1] = 0.0
    w[1, 7] = 3.0
    dip = rng.integers(0, C - 1, (16, 3))
    w[np.arange(n_rays - 16, n_rays)[:, None], dip] = -rng.uniform(
        0.3, 0.8, (16, 3))
    return bins, w


def test_stratified_samples_and_deltas_match_jax():
    """Bitwise: the same bins (jnp.linspace's formula), the same
    lower + (upper - lower) * u and the same forward differences."""
    ro, rd = shell_rays(64)
    key = jax.random.key(0)
    for k in (key, None):
        jt, jd = jsamp.stratified_samples(jnp.asarray(ro), jnp.asarray(rd),
                                          NEAR, FAR, C, k)
        u = None if k is None else t(jax.random.uniform(k, (64, C)))
        tt, td = sampling.stratified_samples(t(ro), t(rd), NEAR, FAR, C, u)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    past = np.array([[2.0, 3.0, 6.5], [2.0, 2.5, 5.0]], np.float32)
    got = sampling._deltas_from_t(t(past), FAR).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jsamp._deltas_from_t(jnp.asarray(past), FAR)))
    assert got[0, -1] == 0.0 and got[1, -1] == 1.0


def _well_posed(u, w):
    """[R, S] True where the reference's CDF bracket of the draw holds a
    probability of at least 1e-4. Below 1e-5 the reference divides by 1
    instead, so there a one-ulp change of the CDF moves a sample across the
    whole bracket: XLA's float32 cumsum and torch's sum in another order
    (they differed by up to 3.8e-6 here), and such samples (in empty bins,
    which carry no weight) are held only to the bins' span. At least 98%
    of the draws here are well posed."""
    ww = w + 1e-5
    cdf = np.asarray(jnp.cumsum(jnp.asarray(ww / ww.sum(-1, keepdims=True)),
                                axis=-1))
    cdf = np.concatenate([np.zeros((w.shape[0], 1), np.float32), cdf], -1)
    le = cdf[:, None, :] <= u[:, :, None]
    c = np.broadcast_to(cdf[:, None, :], le.shape)
    below = np.where(le, c, 0.0).max(-1)
    above = np.where(le, c[..., -1:], c).min(-1)
    return above - below >= 1e-4


def test_sample_pdf_matches_jax():
    """Random and evenly spaced draws, on rays with sparse, zero, spiked
    and negative weights; the negative ones make the CDF dip, where a
    searchsorted bracket is off by up to 3.6 in t and the reference's
    masked max/min bracket is kept. Well-posed samples (_well_posed) within
    1e-4 absolute in t (the CDFs differ by float32 rounding; largest
    difference read on the CPU 3.1e-5), every sample within the bins."""
    for seed in range(3):
        bins, w = _pdf_inputs(seed=seed)
        key = jax.random.key(3 + seed)
        for k in (key, None):
            want = np.asarray(jsamp.sample_pdf(k, jnp.asarray(bins),
                                               jnp.asarray(w), F))
            u = (np.asarray(jax.random.uniform(k, (bins.shape[0], F),
                                               maxval=PDF_MAX))
                 if k is not None else np.broadcast_to(
                     np.asarray(jnp.linspace(0.0, PDF_MAX, F)), want.shape))
            got = sampling.sample_pdf(None if k is None else t(u), t(bins),
                                      t(w), F).numpy()
            ok = _well_posed(u, w)
            assert ok.mean() > 0.95
            np.testing.assert_allclose(got[ok], want[ok], atol=1e-4, rtol=0)
            assert (got >= bins[:, :1] - 1e-6).all()
            assert (got <= bins[:, -1:] + 1e-6).all()


def test_hierarchical_samples_match_jax():
    """Sorted union of the coarse samples and the resampled ones, with its
    deltas, on positive weights of full support (every draw well posed)
    at the sample_pdf tolerance."""
    bins, _ = _pdf_inputs(seed=1)
    w_c = np.random.default_rng(2).uniform(0.1, 1.0, bins.shape).astype(
        np.float32)
    key = jax.random.key(4)
    jt, jd = jsamp.hierarchical_samples(key, jnp.asarray(bins),
                                        jnp.asarray(w_c), F, FAR)
    u = t(jax.random.uniform(key, (bins.shape[0], F), maxval=PDF_MAX))
    tt, td = sampling.hierarchical_samples(u, t(bins), t(w_c), F, FAR)
    assert tt.shape == (bins.shape[0], C + F)
    assert (torch.diff(tt, dim=-1) >= 0).all()
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4, rtol=0)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=2e-4, rtol=0)


def test_merge_sorted_union_and_its_gradient_match_jax():
    """Forward values and the vjp, bitwise, with ties between coarse and
    fine t (the coarse sample sorts first, as lax.sort's stable sort)."""
    rng = np.random.default_rng(5)
    t_c = np.sort(rng.uniform(NEAR, FAR, (32, C)), -1).astype(np.float32)
    t_new = rng.uniform(NEAR, FAR, (32, F)).astype(np.float32)
    t_new[:, :4] = t_c[:, 3:7]                          # ties
    t_cat = np.concatenate([t_c, t_new], -1)
    o_cat = rng.normal(size=(32, C + F, 4)).astype(np.float32)
    ct_t = rng.normal(size=t_cat.shape).astype(np.float32)
    ct_o = rng.normal(size=o_cat.shape).astype(np.float32)
    (jt, jo), vjp = jax.vjp(jrend._merge_sorted_union, jnp.asarray(t_cat),
                            jnp.asarray(o_cat))
    jdt, jdo = vjp((jnp.asarray(ct_t), jnp.asarray(ct_o)))
    tc, oc = t(t_cat).requires_grad_(), t(o_cat).requires_grad_()
    tt, to = renderer._merge_sorted_union(tc, oc)
    np.testing.assert_array_equal(tt.detach().numpy(), np.asarray(jt))
    np.testing.assert_array_equal(to.detach().numpy(), np.asarray(jo))
    dt, do = torch.autograd.grad((tt, to), (tc, oc), (t(ct_t), t(ct_o)))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(jdt))
    np.testing.assert_array_equal(do.numpy(), np.asarray(jdo))


def _models(seed):
    """The same float32 NeRF in both packages, with the trunc_exp density:
    sigma in [0.37, 2.7] at these weights, so no ray saturates over [2, 6]
    and every coarse bin keeps a probability well above the 1e-5 where the
    reference's inverse CDF turns discontinuous (see _well_posed)."""
    params = nerf_params_np(seed)
    kw = dict(n_freqs=4, n_freqs_views=2, density_activation=ACT)
    jmodel = JNeRF(n_layers=4, d_filter=64, skip=(2,), **kw)
    model = NeRF(n_layers=4, d_filter=64, skip=(2,), **kw)
    model.load_state_dict(state_dict_from_jax(params))
    return params, jmodel, model


def _close(got, want, keys, atol):
    for k in keys:
        np.testing.assert_allclose(got[k].detach().numpy(),
                                   np.asarray(want[k]), atol=atol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("branch", ["shared", "distinct"])
def test_render_rays_hierarchical_matches_jax(branch):
    """The float32 NeRF of both packages with the JAX renderer's draws:
    coarse and fine rgb, opacity, depth, weights and sigmas within 1e-5
    (the two float32 modules sum their matmuls in another order; largest
    difference read on the CPU 2.6e-6, a fine sigma), the coarse t within
    1e-5 (read: equal) and the fine t at sample_pdf's 1e-4 (read:
    1.0e-5)."""
    params, jmodel, model = _models(6)
    ro, rd = shell_rays(48, seed=2)
    key = jax.random.key(8)
    u_c, u_f = _draws(key, 48)
    jkw, tkw = {}, {}
    if branch == "distinct":
        params2, _, model2 = _models(7)
        jkw["coarse_model_fn"] = lambda x, d: jmodel.apply(params2, x, d)
        tkw["coarse_model_fn"] = lambda x, d: model2(x, d)
    jc, jf = jrend.render_rays_hierarchical(
        lambda x, d: jmodel.apply(params, x, d), jnp.asarray(ro),
        jnp.asarray(rd), NEAR, FAR, C, F, key=key, white_bkgd=True, **jkw)
    with torch.no_grad():
        tc, tf = renderer.render_rays_hierarchical(
            lambda x, d: model(x, d), t(ro), t(rd), NEAR, FAR, C, F, u_c, u_f,
            white_bkgd=True, **tkw)
    keys = ("rgb", "opacity", "depth", "weights", "sigmas")
    _close(tc, jc, keys + ("t_vals",), 1e-5)
    _close(tf, jf, keys, 1e-5)
    _close(tf, jf, ("t_vals",), 1e-4)           # as test_sample_pdf
    assert tf["t_vals"].shape == (48, C + F) and tf["mask"] is None


def test_render_rays_hierarchical_fused_fine_pass_matches_jax():
    """The eval path: no draws, the fine pass through the ray march (the
    port's plain version vs the interpret-mode Pallas kernel) over the
    sorted union with every sample valid, at tests/test_pallas.py's
    ray-march tolerances (rgb/opacity 7e-3, depth 3e-2; largest differences
    read on the CPU 3.2e-6 / 7.2e-7 / 3.6e-6, and 9.1e-6 in t)."""
    params, jmodel, model = _models(9)
    ro, rd = shell_rays(40, seed=3)
    arch = dict(n_layers=4, skip=(2,), n_freqs=4, n_freqs_views=2,
                density_activation=ACT, block_rows=16, chunk_s=8)
    jc, jf = jrend.render_rays_hierarchical(
        lambda x, d: jmodel.apply(params, x, d), jnp.asarray(ro),
        jnp.asarray(rd), NEAR, FAR, C, F, white_bkgd=True,
        fused_render_fn=jmarch(params, **arch, interpret=True))
    with torch.no_grad():
        tc, tf = renderer.render_rays_hierarchical(
            lambda x, d: model(x, d), t(ro), t(rd), NEAR, FAR, C, F,
            white_bkgd=True, fused_render_fn=kr.make_fused_ray_renderer(
                state_dict_from_jax(params), **arch))
    _close(tc, jc, ("rgb", "weights"), 1e-5)
    _close(tf, jf, ("rgb", "opacity"), 7e-3)
    _close(tf, jf, ("depth",), 3e-2)
    _close(tf, jf, ("t_vals",), 1e-5)


class _HierDraws:
    """The JAX hierarchical step's draws for one step: batch indices, then
    the renderer's split of the render key into coarse and PDF draws."""

    def __init__(self, key, n_pool, batch):
        _, k_batch, k_render, _ = jax.random.split(key, 4)
        self.idx = torch.from_numpy(np.array(
            jax.random.randint(k_batch, (batch,), 0, n_pool))).long()
        self.u_c, self.u_f = _draws(k_render, batch)

    def batch_indices(self, pool, batch_size):
        return self.idx

    def stratified_u(self, n_rays, n_samples, device):
        assert self.u_c.shape == (n_rays, n_samples)
        return self.u_c

    def pdf_u(self, n_rays, n_samples, device):
        assert self.u_f.shape == (n_rays, n_samples)
        return self.u_f


def test_hierarchical_train_step_matches_jax(monkeypatch):
    """One whole step from the same state with the JAX step's draws, both
    through their fused train kernels (the JAX one in interpret mode, the
    port's plain versions): loss and PSNR within rel 1e-4, every gradient
    within 2e-2 of its max |JAX gradient| (the kernels round each cotangent
    to bf16, and the two packages sum in another order), and the parameters
    after Adam within 1e-6 absolute but for under 1% of each tensor, which
    stay within 2 lr: Adam's first step moves a weight by about lr times
    the sign of its gradient, so a gradient within rounding of zero moves
    it either way. The occupancy grid is created and never refreshed.
    Largest differences read on the CPU: loss 1.5e-6 and PSNR 1.2e-6
    relative, gradients 7.6e-4 of max, parameters 2.1e-3 at 15 of 22,884
    (the rest within 1e-6)."""
    import fsnerf_tpu.ops.pallas.mlp_train as jmt
    monkeypatch.setattr(jmt, "make_fused_train_model_fn", functools.partial(
        jmt.make_fused_train_model_fn, block_rows=128, interpret=True))
    sections = dict(
        encoder=dict(n_freqs=4, n_freqs_views=2),
        model=dict(n_layers=4, d_filter=64, skip=(2,), fused_kernel=True),
        data=dict(dataset="sphere", white_bkgd=True),
        sampling=dict(strategy="hierarchical", n_samples=C, n_fine=F),
        train=dict(n_iters=5, batch_size=32, lro=5e-3, dtype="float32"))
    jcls = dict(encoder=JEncoderConfig, model=JModelConfig, data=JDataConfig,
                sampling=JSamplingConfig, train=JTrainConfig)
    tcls = dict(encoder=EncoderConfig, model=ModelConfig, data=DataConfig,
                sampling=SamplingConfig, train=TrainConfig)
    jcfg = JConfig(**{k: jcls[k](**v) for k, v in sections.items()})
    tcfg = Config(**{k: tcls[k](**v) for k, v in sections.items()})
    scene = SphereScene(n_imgs=3, hw=16)
    params = nerf_params_np(12)

    from fsnerf_tpu.core.models import make_model as jmake_model
    jmodel = jmake_model(jcfg)
    jopt = jstep.make_optimizer(jcfg)
    jpool = jpool_from_images(scene.imgs, scene.poses, scene.hwf)
    js = jstep.init_state(jmodel, jcfg, jopt, scene.aabb, jax.random.key(7))
    js = js.replace(params=jax.tree.map(jnp.asarray, params),
                    opt_state=jopt.init(jax.tree.map(jnp.asarray, params)))
    loss_fn = jstep.make_loss_fn(jmodel, jcfg, scene)
    _, k_batch, k_render, _ = jax.random.split(js.key, 4)
    (jl, (jmse, jspr, _)), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(js.params, jpool.sample(k_batch, 32),
                                js.grid, k_render, js.step)
    # the rest of the JAX step: Adam (the grid is not refreshed)
    upd, _ = jopt.update(jgrads, js.opt_state, js.params)
    jparams = optax.apply_updates(js.params, upd)

    model = NeRF(**SMALL)
    topt = step.make_optimizer(tcfg, model)
    template = step.init_state(model, tcfg, topt, scene.aabb)
    ts = train_state_from_jax(js, model, topt, template.grid,
                              template.generator)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf)
    ts, tm = step.make_train_step(model, tcfg, topt, pool, scene)(
        ts, draws=_HierDraws(js.key, jpool.n, 32))

    np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=1e-4)
    np.testing.assert_allclose(float(tm["psnr"]),
                               float(jlosses.psnr_from_mse(jmse)), rtol=1e-4)
    assert float(tm["samples_per_ray"]) == float(jspr) == C + F
    jg = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    lr = 5e-3
    for name, p in model.named_parameters():
        g = jg[name].numpy()
        err = np.abs(p.grad.numpy() - g).max() / (np.abs(g).max() + 1e-12)
        assert err < 2e-2, (name, err)
        diff = np.abs(p.detach().numpy() - want[name].numpy())
        assert diff.max() <= 2 * lr + 1e-6, name
        assert (diff > 1e-6).mean() < 1e-2, name
    assert ts.step == 1
    np.testing.assert_array_equal(ts.grid.binaries.numpy(),
                                  np.asarray(js.grid.binaries))


@pytest.mark.parametrize("extra", [[], ["--render_only", "--no_fused_render"]])
def test_cli_hierarchical_runs_small(capsys, extra):
    """The hierarchical main path at a tiny size on the CPU: train (through
    the train kernels' plain versions) and evaluate through the forward MLP
    and the ray march, or render only through the forward MLP."""
    rc = cli.main(["--dataset", "sphere", "--device", "cpu", "--hw", "12",
                   "--n_imgs", "3", "--n_layers", "3", "--d_filter", "32",
                   "--skip", "1", "--n_freqs", "3", "--n_freqs_views", "2",
                   "--strategy", "hierarchical", "--n_samples", "16",
                   "--n_fine", "32", "--n_iters", "8", "--batch_size", "32",
                   "--fused_kernel", "--white_bkgd", "--debug", *extra])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu"
    assert np.isfinite(out["psnr"]) and -1.0 <= out["ssim"] <= 1.0
    assert ("steps" in out) == (not extra)
