"""fsnerf_tpu_torch's few-shot path against fsnerf_tpu: the density kernel's
plain version (kernel 4) and the grid refresh it drives, the compositing
kernel's route (kernel 9), one occgrid train step with the few-shot recipe
on, the in-loop validation render at a mid-anneal step, add_floaters, a
checkpoint round trip and a tiny CLI run with the flags of this path.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does; the port's wrappers take their kernels' plain
versions for CPU tensors. The CUDA kernels themselves are held against the
plain versions on the card by tests/test_torch_cuda.py.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.core.encoding import freq_mask as jfreq_mask
from fsnerf_tpu.core.encoding import positional_encoding as jencode
from fsnerf_tpu.data import synthetic as jsynthetic
from fsnerf_tpu.data.pool import pool_from_images as jpool_from_images
from fsnerf_tpu.ops import occgrid as jog
from fsnerf_tpu.ops.pallas.mlp import fused_density
from fsnerf_tpu.ops.pallas.mlp import make_fused_density_fn as jdensity_fn
from fsnerf_tpu.ops.pallas.mlp import prep_params as jprep
from fsnerf_tpu.ops.pallas.volrend import volume_render_pallas
from fsnerf_tpu.train import step as jstep
from fsnerf_tpu_torch import cli
from fsnerf_tpu_torch.core.models import NeRF
from fsnerf_tpu_torch.data import synthetic
from fsnerf_tpu_torch.data.pool import pool_from_images
from fsnerf_tpu_torch.data.synthetic import SphereScene
from fsnerf_tpu_torch.ops import occgrid as og
from fsnerf_tpu_torch.ops.kernels import mlp as km
from fsnerf_tpu_torch.ops.kernels.volrend import volume_render_fused
from fsnerf_tpu_torch.train import loop, step
from fsnerf_tpu_torch.utils.checkpoint import Checkpointer
from fsnerf_tpu_torch.utils.interop import (state_dict_from_jax,
                                            train_state_from_jax)
from test_torch_train import (_both, _Draws, jax_interpret_kernel,  # noqa
                              jax_refresh)
from torch_parity import (AABB, SMALL, composite_excess, mlp_inputs,
                          nerf_params_np, sphere_density_jax,
                          sphere_density_torch, t)

ARCH = dict(n_layers=4, skip=(2,))


def _encoded_points(n, seed, masked):
    """The same float32 positional encodings for both packages (numpy)."""
    x, _, _ = mlp_inputs(n, seed=seed)
    pm = jfreq_mask(4, 7, 20) if masked else None
    return np.asarray(jencode(jnp.asarray(x.numpy()), 4, True, pm))


@pytest.mark.parametrize("act", ["none", "relu", "trunc_exp"])
@pytest.mark.parametrize("masked", [False, True])
def test_density_plain_version_matches_pallas_kernel(act, masked):
    """300 rows (not a multiple of the block), the three activations, a
    FreeNeRF mask on and off: within 1e-3 of max |sigma|, the JAX
    package's ceiling being 2e-2 (XLA's and torch's CPU matmuls sum the f32
    products in another order, which can flip the bf16 rounding of an
    activation; largest read: 2.3e-4 of max, in one row). The sigma bias
    is raised by 0.3 so that ReLU keeps some rows positive."""
    params = nerf_params_np(20)
    params["params"]["sigma"]["bias"] = params["params"]["sigma"]["bias"] \
        + np.float32(0.3)
    ex = _encoded_points(300, 21, masked)
    want = np.asarray(fused_density(jprep(params, **ARCH), jnp.asarray(ex),
                                    density_activation=act, block_rows=128,
                                    interpret=True))
    p = km.prep_params(state_dict_from_jax(params), **ARCH)
    got = km.nerf_density(km.pad_features(t(ex), p.d_enc_pad), p,
                          act).numpy()
    assert got.shape == want.shape == (300,)
    scale = np.abs(want).max()
    assert scale > 0
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-3, rtol=0)
    if act != "none":
        assert (got >= 0).all()


def test_fused_density_fn_drives_grid_update_as_jax():
    """og.update through each package's make_fused_density_fn (the JAX one
    in interpret mode) at a mid-anneal FreeNeRF mask, all cells at their
    centres: EMA values within 1e-7 + 1e-2 * |occ| and the binarized
    occupancy equal (the ceiling is tests/test_pallas.py's rtol 0.1, atol
    1e-3 and 98% of cells; why not bitwise: the positional encoding's
    float32 sin rounds one ulp apart in XLA and torch at some points, and
    the kernel rounds the encodings to bf16; largest read: 1.7e-10
    absolute, 2.8e-5 relative, in 130 of 4,096 cells)."""
    params = nerf_params_np(22)
    pm = np.asarray(jfreq_mask(4, 9, 20))
    jf = jdensity_fn(params, **ARCH, n_freqs=4, interpret=True,
                     pos_mask=jnp.asarray(pm))
    jg = jog.update(jog.create(jnp.asarray(AABB), 16), jf, None,
                    jnp.asarray(0))
    tf = km.make_fused_density_fn(state_dict_from_jax(params), **ARCH,
                                  n_freqs=4, pos_mask=t(pm))
    tg = og.update(og.create(AABB, 16), tf, 0)
    np.testing.assert_allclose(tg.occs.numpy(), np.asarray(jg.occs),
                               rtol=1e-2, atol=1e-7)
    np.testing.assert_array_equal(tg.binaries.numpy(),
                                  np.asarray(jg.binaries))
    np.testing.assert_allclose(tg.thre.item(), float(jg.thre), rtol=1e-5)


def _volrend_inputs(R=96, S=48, seed=0, masked=True):
    """tests/test_pallas.py::_volrend_inputs: raw sigmas, all-masked rays."""
    rng = np.random.default_rng(seed)
    sigmas = rng.normal(0.0, 3.0, (R, S)).astype(np.float32)
    rgbs = rng.uniform(0, 1, (R, S, 3)).astype(np.float32)
    tv = np.sort(rng.uniform(2.0, 6.0, (R, S)), -1).astype(np.float32)
    deltas = rng.uniform(1e-3, 0.1, (R, S)).astype(np.float32)
    mask = None
    if masked:
        mask = rng.uniform(size=(R, S)) > 0.3
        mask[:4] = False
    return sigmas, rgbs, tv, deltas, mask


@pytest.mark.parametrize("R,S,masked,bkgd", [
    (96, 48, True, 1.0), (96, 48, False, 0.0), (96, 48, True, 0.0),
    (37, 16, True, 0.5), (32, 16, True, [0.2, 0.5, 0.9])])
def test_volrend_route_matches_pallas_kernel(R, S, masked, bkgd):
    """The compositing kernel's route on the CPU (volume_render_fused, which
    runs volume_render there) vs volume_render_pallas in interpret mode:
    the three cases of tests/test_pallas.py::test_volrend_kernel_matches_jnp,
    R not a multiple of the block, a vector background; rtol 1e-5, atol
    1e-6, of |want| for the weights and trans_final, and of the magnitude of
    the terms for the sums over the samples (torch_parity.composite_excess:
    with the raw sigmas of these inputs a depth can cancel to 0.01 of its
    terms, and XLA and torch add them in another order: one depth read 1.3
    times a straight rtol 1e-5 + atol 1e-6 of itself; against the stated
    scales the largest read is 0.23 of the tolerance)."""
    sig, rgb, tv, dl, mask = _volrend_inputs(R, S, seed=R + S,
                                             masked=masked)
    want = volume_render_pallas(
        *map(jnp.asarray, (sig, rgb, tv, dl)),
        None if mask is None else jnp.asarray(mask), jnp.asarray(bkgd),
        block_rows=32, interpret=True)
    got = volume_render_fused(
        t(sig), t(rgb), t(tv), t(dl),
        None if mask is None else torch.as_tensor(mask), bkgd)
    for k in ("rgb", "opacity", "depth", "weights", "trans_final"):
        assert got[k].shape == want[k].shape, k
    excess = composite_excess(got, want, rgb, tv, bkgd)
    assert max(excess.values()) <= 1.0, excess


FEWSHOT = dict(
    encoder=dict(n_freqs=4, n_freqs_views=2, freq_reg_end=100),
    model=dict(n_layers=4, d_filter=64, skip=(2,), fused_kernel=True),
    data=dict(dataset="sphere", white_bkgd=True),
    sampling=dict(n_samples=64, n_compact=32, grid_resolution=16,
                  render_step_size=0.05, warmup_steps=3, update_interval=2),
    train=dict(n_iters=100, batch_size=64, lro=5e-3, dtype="float32",
               occ_a=0.1, occ_b=2.0, occ_func="exp", beta=1.0, ao=1e-6))
MID_ANNEAL = 60             # masks [1, 1, 0.4, 0] and [1, 0.2]


def test_fewshot_train_step_matches_jax(jax_interpret_kernel):
    """One occgrid step at step 60 of a 100-step FreeNeRF anneal (so the
    culling hold, auto = 100, is on), with the occlusion and weight
    regularizers, from the same state and the JAX step's draws: loss within
    rel 1e-3 and every gradient within 2e-2 of its max |JAX gradient|, as
    tests/test_torch_train.py::test_train_step_matches_jax; the refreshed
    part of the grid against jax_refresh at the step's mask: EMA values
    within 1e-7 + 5e-2 * |occ| (why not bitwise: that test; largest read
    here 1.3e-2 relative, 3.4e-6 absolute, in one of 4,096 cells; the JAX
    package's ceiling is rtol 0.1, atol 1e-3), every cell occupied in both
    and the threshold -1."""
    jcfg, tcfg = _both(**FEWSHOT)
    scene = SphereScene(n_imgs=3, hw=16)
    params = nerf_params_np(23)

    from fsnerf_tpu.core.models import make_model as jmake_model
    jmodel = jmake_model(jcfg)
    jopt = jstep.make_optimizer(jcfg)
    jpool = jpool_from_images(scene.imgs, scene.poses, scene.hwf)
    js = jstep.init_state(jmodel, jcfg, jopt, scene.aabb, jax.random.key(8))
    # a state at step 60: the step and every optax count (the schedule
    # reads its own) at 60, the Adam moments fresh
    opt_state = tuple(
        st._replace(count=jnp.asarray(MID_ANNEAL, st.count.dtype))
        if hasattr(st, "count") else st
        for st in jopt.init(jax.tree.map(jnp.asarray, params)))
    js = js.replace(params=jax.tree.map(jnp.asarray, params),
                    opt_state=opt_state,
                    step=jnp.asarray(MID_ANNEAL, js.step.dtype))
    model = NeRF(**SMALL)
    topt = step.make_optimizer(tcfg, model)
    template = step.init_state(model, tcfg, topt, scene.aabb)
    ts = train_state_from_jax(js, model, topt, template.grid,
                              template.generator)
    assert ts.step == MID_ANNEAL
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf)

    n = js.grid.occs.shape[1]
    draws = _Draws(js.key, jpool.n, 64, ts.grid, n // 4)
    _, k_batch, k_render, k_grid = jax.random.split(js.key, 4)
    loss_fn = jstep.make_loss_fn(jmodel, jcfg, scene)
    (jl, _), jgrads = jax.value_and_grad(loss_fn, has_aux=True)(
        js.params, jpool.sample(k_batch, 64), js.grid, k_render, js.step)
    grid0 = js.grid
    js, _ = jax.jit(jstep.make_train_step(jmodel, jcfg, jopt, jpool,
                                          scene))(js)
    ts, tm = step.make_train_step(model, tcfg, topt, pool, scene)(
        ts, draws=draws)
    np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=1e-3)
    jg = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    for name, p in model.named_parameters():
        want = jg[name].numpy()
        err = np.abs(p.grad.numpy() - want).max() / (np.abs(want).max()
                                                      + 1e-12)
        assert err < 2e-2, (name, err)

    jgrid = jax_refresh(js.params, grid0, k_grid, MID_ANNEAL, jcfg,
                        pos_mask=jfreq_mask(4, MID_ANNEAL, 100))
    assert float(jnp.abs(jgrid.occs).max()) > 0        # a part refreshed
    np.testing.assert_allclose(ts.grid.occs.numpy(), np.asarray(jgrid.occs),
                               rtol=5e-2, atol=1e-7)
    assert ts.grid.binaries.all() and bool(jgrid.binaries.all())
    assert ts.grid.thre.item() == float(jgrid.thre) == -1.0
    assert float(tm["occupancy"]) == 1.0


def test_val_render_matches_jax_val_chunk():
    """The validation render of one 12x12 view at step 60 of a 100-step
    anneal (cli.render_val_view: the forward MLP kernel's plain version at
    the step's masks, the compositing route) vs the JAX package's
    _val_chunk route (model.apply in bfloat16 with the masks, then
    _render_rays_dispatch) on the same grid: every pixel within 5e-3, the
    fused-MLP rgb tolerance of tests/test_pallas.py (the kernel's bf16
    rounding points are the module's up to the order of its sums; largest
    read: 3.1e-4), and the PSNR within 0.05 dB."""
    from fsnerf_tpu.core.models import make_model as jmake_model
    from fsnerf_tpu.eval.metrics import psnr as jpsnr
    from fsnerf_tpu.render.renderer import _render_rays_dispatch
    from fsnerf_tpu.render.renderer import render_frame as jrender_frame
    from fsnerf_tpu_torch.eval.metrics import psnr

    jcfg, tcfg = _both(**FEWSHOT)
    jcfg = jcfg.replace(train=dataclasses.replace(jcfg.train,
                                                  dtype="bfloat16"))
    view = SphereScene(n_imgs=1, hw=12, seed=101)
    split = cli.split_of(view)
    params = nerf_params_np(24)
    jmodel = jmake_model(jcfg)
    s = jcfg.sampling
    # the live grid: its tables at the plan's dilation, as training keeps it
    _, dil = jog.resolve_query_plan(s, view.aabb)
    jgrid = jog.update(jog.create(jnp.asarray(AABB), 16, 1, dil),
                       sphere_density_jax, None, jnp.asarray(0))
    grid = og.update(og.create(AABB, 16, 1, dil), sphere_density_torch, 0)
    pm, dm = jstep.make_masks(jcfg, jnp.asarray(MID_ANNEAL))

    def model_fn(x, d=None):
        return jmodel.apply(params, x, d, pos_mask=pm, dir_mask=dm)

    def chunk(o, d):
        out = _render_rays_dispatch(
            model_fn, o, d, key=None, white_bkgd=True, strategy="occgrid",
            grid=jgrid, n_samples=s.n_samples, n_fine=s.n_fine,
            near=view.near, far=view.far,
            render_step_size=s.render_step_size, n_compact=s.n_compact,
            early_stop_eps=s.early_stop_eps,
            query_stride=jog.resolve_query_stride(s, view.aabb))
        return out["rgb"], out["depth"]

    want, _ = jrender_frame(None, jnp.asarray(view.poses[0]), view.hwf,
                            view.near, view.far, strategy="occgrid",
                            chunksize=2 * jcfg.train.batch_size,
                            chunk_renderer=chunk)
    model = NeRF(**SMALL)
    model.load_state_dict(state_dict_from_jax(params))
    got = cli.render_val_view(model, tcfg, grid, split, MID_ANNEAL, "cpu")
    want = np.asarray(want)
    assert got.shape == want.shape == (12, 12, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=5e-3, rtol=0)
    gt = view.imgs[0]
    assert abs(float(psnr(got, t(gt))) - float(jpsnr(jnp.asarray(want),
                                                      jnp.asarray(gt)))) \
        < 0.05
    val = cli.make_val_fn(model, tcfg, split, "cpu")(
        dataclasses.replace(step.init_state(model, tcfg,
                                            step.make_optimizer(tcfg, model),
                                            view.aabb), grid=grid),
        MID_ANNEAL)
    assert val["psnr"] == pytest.approx(float(psnr(got, t(gt))))


def test_add_floaters_matches_jax():
    """Bitwise: the same numpy code on the same seed."""
    scene = synthetic.LatticeScene(n_imgs=3, hw=24)
    for seed in (0, 97):
        want = jsynthetic.add_floaters(scene.imgs, scene.poses, scene.hwf,
                                       seed=seed)
        got = synthetic.add_floaters(scene.imgs, scene.poses, scene.hwf,
                                     seed=seed)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, scene.imgs)


def _tiny_fewshot_cfg(**train):
    _, cfg = _both(
        encoder=dict(n_freqs=3, n_freqs_views=2, freq_reg_end=10),
        model=dict(n_layers=3, d_filter=32, skip=(1,), fused_kernel=True),
        data=dict(dataset="sphere", white_bkgd=True),
        sampling=dict(n_samples=32, n_compact=32, grid_resolution=8,
                      render_step_size=0.2, warmup_steps=4,
                      update_interval=4),
        train=dict(n_iters=24, batch_size=64, lro=5e-3, occ_a=0.01,
                   occ_b=2.0, occ_func="exp", beta=1.0, ao=1e-6, val=True,
                   val_rate=6, ckpt_every=12, **train))
    return cfg


def _run(cfg, scene, ckpt_dir, resume=False):
    model = NeRF(n_layers=3, d_filter=32, skip=(1,), n_freqs=3,
                 n_freqs_views=2, generator=torch.Generator().manual_seed(0))
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf)
    ckpt = Checkpointer(ckpt_dir)
    state = None
    if resume:
        state = ckpt.restore(step.init_state(
            model, cfg, step.make_optimizer(cfg, model), scene.aabb))
    held = cli.split_of(scene.holdout(n=1, seed=5))
    val_calls = []

    def val_fn(st, k):
        val_calls.append(k)
        return cli.make_val_fn(model, cfg, held, "cpu")(st, k)

    state = loop.train(model, cfg, pool, scene, state=state, log_every=6,
                       checkpointer=ckpt, val_fn=val_fn)
    return state, val_calls


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """24 CPU steps with the few-shot recipe, validation every 6 and a
    checkpoint every 12, against the same run resumed from its step-12
    checkpoint: parameters, Adam moments, the grid (EMA values, binaries,
    threshold, query tables), the generator and the ladder bitwise equal.
    Retention keeps the newest 3."""
    cfg = _tiny_fewshot_cfg()
    scene = SphereScene(n_imgs=3, hw=12)
    full, calls = _run(cfg, scene, str(tmp_path / "a"))
    assert calls == [6, 12, 18, 24] and full.step == 24
    ck = Checkpointer(str(tmp_path / "a"))
    assert ck.steps() == [12, 24]
    os.remove(ck.path(24))
    resumed, calls = _run(cfg, scene, str(tmp_path / "a"), resume=True)
    assert calls == [18, 24] and resumed.step == 24
    for a, b in zip(full.model.parameters(), resumed.model.parameters()):
        assert torch.equal(a, b)
    for a, b in zip(full.model.parameters(), resumed.model.parameters()):
        sa, sb = full.optimizer.state[a], resumed.optimizer.state[b]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), k
    for k in ("occs", "binaries", "thre", "occ_q", "od_q"):
        assert torch.equal(getattr(full.grid, k), getattr(resumed.grid, k))
    assert torch.equal(full.generator.get_state(),
                       resumed.generator.get_state())
    assert full.ladder == resumed.ladder
    for s in (36, 48):
        ck.save(resumed, s)
    assert ck.steps() == [24, 36, 48]
    ck.save(resumed, 48)                       # a saved step is kept as is
    assert ck.latest_step() == 48


def test_cli_fewshot_flags_small(tmp_path, capsys):
    """The few-shot flags end to end on the CPU at a tiny size: train with
    annealing, the occlusion and weight regularizers, validation and
    checkpoints, then resume to more steps."""
    out = str(tmp_path / "run")
    flags = ["--dataset", "sphere", "--device", "cpu", "--hw", "12",
             "--n_imgs", "3", "--n_layers", "3", "--d_filter", "32",
             "--skip", "1", "--n_freqs", "3", "--n_freqs_views", "2",
             "--grid_resolution", "8", "--n_samples", "32", "--n_compact",
             "32", "--render_step_size", "0.2", "--batch_size", "32",
             "--fused_kernel", "--white_bkgd", "--freq_reg_end", "8",
             "--grid_hold_steps", "-1", "--a", "0.01", "--b", "2",
             "--func", "exp", "--beta", "1", "--ao", "1e-6", "--reg", "l2",
             "--reg_ratio", "0.5", "--Td", "100", "--val", "--val_rate",
             "4", "--ckpt_every", "6", "--out_dir", out]
    assert cli.main(flags + ["--n_iters", "12"]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["steps"] == 12 and first["resumed_from"] == 0
    run = cli.run_dir(cli.config_from_args(flags))
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == [
        "ckpt_00000006.pt", "ckpt_00000012.pt"]
    assert cli.main(flags + ["--n_iters", "16", "--resume"]) == 0
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert second["steps"] == 16 and second["resumed_from"] == 12
    assert np.isfinite(second["psnr"])
    recs = [json.loads(line) for line in
            open(os.path.join(run, "metrics.jsonl")).read().splitlines()]
    val_steps = [r["step"] for r in recs if "val_psnr" in r]
    assert val_steps == [4, 8, 12, 16]
    assert all(np.isfinite(r["val_psnr"]) for r in recs if "val_psnr" in r)
    cfg = cli.config_from_args(flags)
    assert (cfg.encoder.freq_reg_end, cfg.train.occ_a, cfg.train.occ_b,
            cfg.train.occ_func, cfg.train.beta, cfg.train.ao, cfg.train.reg,
            cfg.train.Td, cfg.train.val_rate, cfg.train.ckpt_every) == (
        8, 0.01, 2.0, "exp", 1.0, 1e-6, "l2", 100, 4, 6)
    # --debug writes no run directory to hold the checkpoints
    assert cli.main(["--device", "cpu", "--resume", "--debug"]) == 2
