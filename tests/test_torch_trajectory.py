"""fsnerf_tpu_torch's few-shot training along a trajectory against
fsnerf_tpu's: a 4x64 NeRF on the n=3 lattice with floaters, the FreeNeRF
anneal over the run with the grid's culling hold, the occlusion and weight
regularizers, warm-up all-cell refreshes and then part refreshes.

Re-synced: at every step the port starts from the JAX state
(utils/interop.py::train_state_from_jax) with the JAX step's draws, and the
step is held at the one-step tolerances of
tests/test_torch_fewshot.py::test_fewshot_train_step_matches_jax, so every
step kind along a real run is checked without float32 noise compounding.
Free: both packages run the same steps from one shared state with the same
draws, and what stays steady is bounded.

Both sides run their module path (fused_kernel off) in float32, so no
interpret-mode kernel is needed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.core.models import make_model as jmake_model
from fsnerf_tpu.data import synthetic as jsynthetic
from fsnerf_tpu.data.pool import pool_from_images as jpool_from_images
from fsnerf_tpu.train import step as jstep
from fsnerf_tpu_torch.core.models import NeRF
from fsnerf_tpu_torch.data import synthetic
from fsnerf_tpu_torch.data.pool import pool_from_images
from fsnerf_tpu_torch.train import step
from fsnerf_tpu_torch.utils.interop import (state_dict_from_jax,
                                            train_state_from_jax)
from test_torch_train import _both, _Draws
from torch_parity import nerf_params_np

STEPS = 40
ARCH = dict(n_layers=4, d_filter=64, skip=(2,), n_freqs=6, n_freqs_views=2)
SECTIONS = dict(
    encoder=dict(n_freqs=6, n_freqs_views=2, freq_reg_end=32),
    model=dict(n_layers=4, d_filter=64, skip=(2,), fused_kernel=False),
    data=dict(dataset="lattice", white_bkgd=True),
    sampling=dict(n_samples=64, n_compact=32, grid_resolution=16,
                  render_step_size=0.05, warmup_steps=8, update_interval=2,
                  update_parts=4),
    train=dict(n_iters=STEPS, batch_size=64, lro=5e-3, dtype="float32",
               occ_a=0.1, occ_b=2.0, occ_func="exp", beta=1.0, ao=1e-6,
               Td=50, reg_ratio=0.5))


def _setup(seed):
    """Both packages' models, optimizers, pools, scene and step functions,
    and the shared initial JAX state."""
    jcfg, tcfg = _both(**SECTIONS)
    scene = synthetic.LatticeScene(n_imgs=3, hw=16)
    imgs = jsynthetic.add_floaters(scene.imgs, scene.poses, scene.hwf,
                                   seed=0)
    assert np.array_equal(imgs, synthetic.add_floaters(
        scene.imgs, scene.poses, scene.hwf, seed=0))
    jmodel = jmake_model(jcfg)
    jopt = jstep.make_optimizer(jcfg)
    jpool = jpool_from_images(imgs, scene.poses, scene.hwf)
    params = jax.tree.map(jnp.asarray, nerf_params_np(seed, **ARCH))
    js = jstep.init_state(jmodel, jcfg, jopt, scene.aabb,
                          jax.random.key(seed))
    js = js.replace(params=params, opt_state=jopt.init(params))
    jfn = jax.jit(jstep.make_train_step(jmodel, jcfg, jopt, jpool, scene))
    jgrad = jax.jit(jax.value_and_grad(jstep.make_loss_fn(jmodel, jcfg,
                                                          scene),
                                       has_aux=True))
    model = NeRF(**ARCH)
    topt = step.make_optimizer(tcfg, model)
    tfn = step.make_train_step(model, tcfg, topt, pool_from_images(
        imgs, scene.poses, scene.hwf), scene)
    return jcfg, tcfg, scene, jpool, js, jfn, jgrad, model, topt, tfn


@pytest.fixture(scope="module")
def both():
    """_setup(3) once for the file (the JAX step compiles once), torch on
    one thread: the steps' matmuls are small, and the test workers share
    the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield _setup(3)
    torch.set_num_threads(threads)


def _port_state(js, model, topt, tcfg, scene):
    template = step.init_state(model, tcfg, topt, scene.aabb)
    return train_state_from_jax(js, model, topt, template.grid,
                                template.generator)


def _draws(js, jpool, tcfg, grid, k):
    kind = step.step_kind(tcfg, k)
    n = grid.n_cells
    k_cells = n if kind.refresh in (None, step.ALL_CELLS) else \
        n // tcfg.sampling.update_parts
    return kind, _Draws(js.key, jpool.n, tcfg.train.batch_size, grid,
                        k_cells)


def _weight_gap(model, jparams) -> float:
    """max over the parameters of max |port - JAX| / max |JAX|."""
    want = state_dict_from_jax(jax.tree.map(np.asarray, jparams))
    return max(float((p.detach() - want[n]).abs().max()
                     / want[n].abs().max())
               for n, p in model.named_parameters())


def test_resynced_trajectory_matches_jax_every_step(both):
    """Every step of 40 from the JAX state with the JAX draws: the loss
    within rel 1e-3; every gradient within 2e-2 of its max |JAX gradient|;
    the FreeNeRF masks within 1e-6; after a refresh, the hold flag (the
    threshold held at -1) equal, the binaries equal, the threshold within
    rel 1e-5 and the EMA values within 1e-7 + 5e-2 * |occ| (the one-step
    test's bounds; largest reads over initial weights of seeds 0-4, float32
    module path on both sides: loss 2.6e-7 relative, gradients 9.9e-3 of
    max, EMA values 1.3e-2 relative, 5.2e-7 absolute). The run covers
    warm-up all-cell refreshes (held), part refreshes held and not, the
    weight term on and off, and steps without a refresh."""
    jcfg, tcfg, scene, jpool, js, jfn, jgrad, model, topt, tfn = both
    kinds = set()
    for k in range(STEPS):
        ts = _port_state(js, model, topt, tcfg, scene)
        assert ts.step == k
        kind, draws = _draws(js, jpool, tcfg, ts.grid, k)
        kinds.add(kind)
        _, k_batch, k_render, _ = jax.random.split(js.key, 4)
        (jl, _), jgrads = jgrad(js.params,
                                jpool.sample(k_batch, tcfg.train.batch_size),
                                js.grid, k_render, js.step)
        for a, b in zip(step.make_masks(tcfg, k),
                        jstep.make_masks(jcfg, jnp.asarray(k))):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)
        js = jfn(js)[0]
        ts, tm = tfn(ts, draws=draws)
        np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=1e-3,
                                   err_msg=f"step {k}")
        jg = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
        for name, p in model.named_parameters():
            want = jg[name].numpy()
            err = np.abs(p.grad.numpy() - want).max() / (np.abs(want).max()
                                                          + 1e-12)
            assert err < 2e-2, (k, name, err)
        if kind.refresh is not None:
            held = float(js.grid.thre) == -1.0
            assert kind.hold == held, k
            np.testing.assert_array_equal(ts.grid.binaries.numpy(),
                                          np.asarray(js.grid.binaries),
                                          err_msg=f"step {k}")
            np.testing.assert_allclose(ts.grid.thre.item(),
                                       float(js.grid.thre), rtol=1e-5)
            np.testing.assert_allclose(ts.grid.occs.numpy(),
                                       np.asarray(js.grid.occs), rtol=5e-2,
                                       atol=1e-7, err_msg=f"step {k}")
    refreshes = {(k.refresh is not None, k.refresh == step.ALL_CELLS, k.hold)
                 for k in kinds}
    assert refreshes == {(False, False, False), (True, True, True),
                         (True, False, True), (True, False, False)}
    assert {k.weight_reg for k in kinds} == {False, True}


def test_free_trajectory_stays_near_jax(both):
    """40 steps of each package from one shared state, the port handed the
    JAX draws of each step (as the JAX run made them) but not its state.
    The weights drift apart by float32 rounding (XLA's and torch's sums),
    which Adam's normalized steps then amplify; the test prints the first
    step at which they part by more than 1e-3 of their max (steps 1-7 over
    seeds 0-4). Bounded at 10x the largest read over initial weights of
    seeds 0-4 on the CPU (in brackets): the last step's loss within rel
    2.6e-4 (2.61e-5) and the weights within 0.26 of their max (0.0256); the
    last step's occupancy read equal in all five, and 10x that would ask
    for bitwise equality, which float32 drift does not promise, so it is
    bounded at ten cells of the 4,096."""
    jcfg, tcfg, scene, jpool, js, jfn, jgrad, model, topt, tfn = both
    ts = _port_state(js, model, topt, tcfg, scene)
    first_parting = None
    for k in range(STEPS):
        _, draws = _draws(js, jpool, tcfg, ts.grid, k)
        js, jm = jfn(js)
        ts, tm = tfn(ts, draws=draws)
        gap = _weight_gap(model, js.params)
        if first_parting is None and gap > 1e-3:
            first_parting = k
    print(f"free trajectory: weights part by 1e-3 of their max first at "
          f"step {first_parting}; after {STEPS} steps: weights {gap:.3g} "
          f"of max, loss {float(tm['loss']):.6g} vs {float(jm['loss']):.6g}")
    assert ts.step == int(js.step) == STEPS
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=2.6e-4)
    assert abs(float(tm["occupancy"]) - float(jm["occupancy"])) \
        <= 10 / ts.grid.n_cells
    assert gap < 0.26
