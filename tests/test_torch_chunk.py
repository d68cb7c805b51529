"""fsnerf_tpu_torch's chunked training dispatch against fsnerf_tpu: the
device form of the lr schedules, the FreeNeRF masks from a step tensor, the
in-place grid refresh, the host's plan of step kinds against the JAX step's
refresh and weight-regularizer rules, make_train_chunk against the JAX
chunk (lax.scan) with the JAX draws handed in, train() in chunks and
train_scanned against the one-step-per-iteration loop, and the profiling
trace's files.

Every JAX step here runs its XLA module path (fused_kernel off), so no test
needs an interpret-mode kernel. On the CPU a chunk is a loop of eager
steps; the CUDA graphs it replays on the card are held bitwise against the
eager loop by tests/test_torch_cuda.py.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.core import schedules as jsched
from fsnerf_tpu.core.encoding import freq_mask as jfreq_mask
from fsnerf_tpu.data.pool import pool_from_images as jpool_from_images
from fsnerf_tpu.ops import occgrid as jog
from fsnerf_tpu.train import step as jstep
from fsnerf_tpu_torch import cli
from fsnerf_tpu_torch.core import schedules
from fsnerf_tpu_torch.core.encoding import freq_mask
from fsnerf_tpu_torch.core.models import NeRF
from fsnerf_tpu_torch.data.pool import pool_from_images
from fsnerf_tpu_torch.data.synthetic import SphereScene
from fsnerf_tpu_torch.ops import occgrid as og
from fsnerf_tpu_torch.ops import kernels
from fsnerf_tpu_torch.train import loop, step
from fsnerf_tpu_torch.utils import profiling
from fsnerf_tpu_torch.utils.checkpoint import Checkpointer
from fsnerf_tpu_torch.utils.interop import train_state_from_jax
from test_torch_train import _both
from torch_parity import AABB, SMALL, nerf_params_np, sphere_density_torch, t


@pytest.mark.parametrize("kind", ["const", "exp"])
def test_device_schedules_match_jax(kind):
    """The device form (a 0-d float32 tensor from a step tensor) at steps
    0, 1, T-1, T and 2T: within rtol 1e-6 of the JAX schedule and of the
    host form (both evaluate in float32; pow may differ by an ulp)."""
    T = 1000
    jcfg, tcfg = _both(train=dict(scheduler=kind, n_iters=T, lro=5e-4,
                                  decay_rate=0.1))
    js, ts = jsched.make_schedule(jcfg), schedules.make_schedule(tcfg)
    for k in (0, 1, T - 1, T, 2 * T):
        got = ts(torch.tensor(k, dtype=torch.int64))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(js(jnp.asarray(k))),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(got), ts(k), rtol=1e-6)


def test_masks_from_a_step_tensor_match_jax():
    """freq_mask of the device step counter against the JAX freq_mask
    (float32 on both sides: within 1e-6) and bitwise the mask of the same
    Python int; make_masks of the counter likewise."""
    T = 100
    for n in (10, 4):
        for k in (0, 1, 37, T - 1, T, 2 * T):
            got = freq_mask(n, torch.tensor(k, dtype=torch.int64), T)
            np.testing.assert_allclose(
                got.numpy(), np.asarray(jfreq_mask(n, jnp.asarray(k), T)),
                rtol=0, atol=1e-6)
            assert torch.equal(got, freq_mask(n, k, T))
    _, cfg = _both(encoder=dict(n_freqs=10, n_freqs_views=4,
                                freq_reg_end=T))
    for a, b in zip(step.make_masks(cfg, torch.tensor(40)),
                    step.make_masks(cfg, 40)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("at,hold", [(0, 0), (300, 0), (5, 10)])
def test_in_place_refresh_is_bitwise_the_allocating_one(at, hold):
    """og.update_ (in place, for refresh_plan's part and hold) against
    og.update (a new grid) from the same grid and jitter, at an all-cell
    refresh, a part refresh and a held one: every grid tensor bitwise
    equal, and each keeps its storage."""
    grid = og.create(AABB, 16, 2, query_dilation=1)
    rng = np.random.default_rng(4)
    grid = og.with_occs(grid, t(rng.uniform(0, 0.02, (2, 16 ** 3))),
                        torch.tensor(0.005))
    part, held = og.refresh_plan(at, 256, 4, 16, hold)
    k = grid.n_cells if part is None else grid.n_cells // 4
    jitter = [t(rng.uniform(size=(k, 3))) for _ in range(2)]
    want = og.update(grid, sphere_density_torch, at, hold_steps=hold,
                     jitter=jitter)
    keys = ("occs", "occ_q", "od_q", "binaries", "thre")
    ptrs = {name: getattr(grid, name).data_ptr() for name in keys}
    got = og.update_(grid, sphere_density_torch, part, held, jitter=jitter)
    assert got is grid
    for name in keys:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
        assert getattr(grid, name).data_ptr() == ptrs[name], name
    assert held == (float(grid.thre) == -1.0)


class _Ones:
    """A flax-like model of constant density: its refresh sets each cell
    it touches to render_step_size."""

    def apply(self, params, x, d=None, pos_mask=None, dir_mask=None):
        return jnp.ones(x.shape[:-1] + (4,))


def test_step_kinds_follow_the_jax_rules():
    """The port's step kinds over steps 0-2,100 against what the JAX step
    does on the device: which cells its maybe_update_grid refreshes (none,
    all, or the part at resolve_update_interval's interval), whether the
    refresh held the threshold at -1 (the auto hold through the FreeNeRF
    anneal), and the weight regularizer's step < reg_ratio * Td gate."""
    sections = dict(
        encoder=dict(n_freqs=2, n_freqs_views=1, freq_reg_end=750),
        sampling=dict(grid_resolution=4),
        train=dict(ao=1e-6, Td=2400, reg_ratio=0.5))
    jcfg, tcfg = _both(**sections)
    res, parts = 4, tcfg.sampling.update_parts
    zero = jog.create(jnp.asarray(AABB), res)
    refresh = jax.jit(lambda k: jstep.maybe_update_grid(
        _Ones(), jcfg, None, zero, k, jax.random.key(0)))
    ts = int(jcfg.train.reg_ratio * jcfg.train.Td)
    seen = set()
    for k in range(2101):
        g = refresh(jnp.asarray(k, jnp.int32))
        touched = np.asarray(g.occs)[0] > 0
        if not touched.any():
            want = None
        elif touched.all():
            want = step.ALL_CELLS
        else:
            cells = np.flatnonzero(touched)
            want = int(cells[0]) // (res ** 3 // parts)
            assert len(cells) == res ** 3 // parts
        held = want is not None and float(g.thre) == -1.0
        kind = step.step_kind(tcfg, k)
        assert kind == step.StepKind(want, held, k < ts), k
        seen.add(kind)
    # the kinds of the run: all cells (held), parts 0-3 held, parts 0-3
    # with and without the weight term, no refresh with and without it
    assert len(seen) == 15


class _KeyChain:
    """The JAX steps' draws, step after step: each step splits the carried
    key as jstep.make_train_step does."""

    def __init__(self, key, n_pool, batch):
        self.key, self.n_pool, self.batch = key, n_pool, batch

    def batch_indices(self, pool, batch_size):
        self.key, k_batch, self.k_render, self.k_grid = jax.random.split(
            self.key, 4)
        return torch.from_numpy(np.array(jax.random.randint(
            k_batch, (self.batch,), 0, self.n_pool))).long()

    def render_jitter(self, n_rays, device):
        return t(jax.random.uniform(self.k_render, (self.batch, 1)))

    def grid_jitter(self, grid, k_cells):
        keys = jax.random.split(self.k_grid, grid.levels)
        return [t(jax.random.uniform(k, (k_cells, 3))) for k in keys]


def test_train_chunk_matches_the_jax_chunk():
    """The port's make_train_chunk(step, 4) against
    jax.jit(make_train_chunk(step, 4)) from one state with the JAX draws
    handed in, on the module path, through three all-cell refreshes and a
    part refresh: the last step's loss and n_valid_mean within rel 2e-2
    (test_train_step_matches_jax's trajectory tolerance), both at step 4."""
    sections = dict(
        encoder=dict(n_freqs=4, n_freqs_views=2),
        model=dict(n_layers=4, d_filter=64, skip=(2,), fused_kernel=False),
        data=dict(dataset="sphere", white_bkgd=True),
        sampling=dict(n_samples=64, n_compact=32, grid_resolution=16,
                      render_step_size=0.05, warmup_steps=3,
                      update_interval=1, update_parts=2),
        train=dict(n_iters=8, batch_size=64, lro=5e-3, dtype="float32"))
    jcfg, tcfg = _both(**sections)
    scene = SphereScene(n_imgs=3, hw=16)
    params = nerf_params_np(14)

    from fsnerf_tpu.core.models import make_model as jmake_model
    jmodel = jmake_model(jcfg)
    jopt = jstep.make_optimizer(jcfg)
    jpool = jpool_from_images(scene.imgs, scene.poses, scene.hwf)
    js = jstep.init_state(jmodel, jcfg, jopt, scene.aabb, jax.random.key(9))
    js = js.replace(params=jax.tree.map(jnp.asarray, params),
                    opt_state=jopt.init(jax.tree.map(jnp.asarray, params)))
    model = NeRF(**SMALL)
    topt = step.make_optimizer(tcfg, model)
    template = step.init_state(model, tcfg, topt, scene.aabb)
    ts = train_state_from_jax(js, model, topt, template.grid,
                              template.generator)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf)
    draws = _KeyChain(js.key, jpool.n, 64)

    js, jm = jax.jit(jstep.make_train_chunk(
        jstep.make_train_step(jmodel, jcfg, jopt, jpool, scene), 4))(
        js, jpool)
    chunk = step.make_train_chunk(
        step.make_train_step(model, tcfg, topt, pool, scene), 4)
    ts, tm = chunk(ts, draws=draws)
    assert ts.step == int(js.step) == 4 and int(ts.step_t) == 4
    for name in ("loss", "n_valid_mean"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=2e-2, err_msg=name)


def _tiny_cfg(**change):
    train = dict(n_iters=24, batch_size=64, lro=5e-3, occ_a=0.01, occ_b=2.0,
                 occ_func="exp", beta=1.0, ao=1e-6, Td=40, val=True,
                 val_rate=6, ckpt_every=12)
    train.update(change)
    _, cfg = _both(
        encoder=dict(n_freqs=3, n_freqs_views=2, freq_reg_end=10),
        model=dict(n_layers=3, d_filter=32, skip=(1,), fused_kernel=True),
        data=dict(dataset="sphere", white_bkgd=True),
        sampling=dict(n_samples=32, n_compact=32, grid_resolution=8,
                      render_step_size=0.2, warmup_steps=4,
                      update_interval=4),
        train=train)
    return cfg


def _fresh(cfg, scene):
    model = NeRF(n_layers=3, d_filter=32, skip=(1,), n_freqs=3,
                 n_freqs_views=2, generator=torch.Generator().manual_seed(0))
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf)
    return model, pool


def _step_loop(model, cfg, pool, scene, ckpt, val_fn, log_every):
    """The loop with one eager step per iteration: the ladder observing at
    the chunk boundaries, logs, validations and checkpoints where train()
    runs them."""
    state = step.init_state(model, cfg, step.make_optimizer(cfg, model),
                            scene.aabb)
    compactor = loop.CompactionController(cfg)
    t_cfg, n = cfg.train, cfg.train.n_iters
    chunk = loop.chunk_length(math.gcd(log_every, t_cfg.val_rate,
                                       t_cfg.ckpt_every))
    fn = step.make_train_step(model, compactor.apply(cfg), state.optimizer,
                              pool, scene)
    logs = []
    while state.step < n:
        state, m = fn(state)
        k = state.step
        if (k % chunk == 0 or k == n) and compactor.observe(
                float(m["n_valid_mean"])):
            fn = step.make_train_step(model, compactor.apply(cfg),
                                      state.optimizer, pool, scene)
        if k % log_every == 0 or k == n:
            logs.append({"step": k, **{a: float(v) for a, v in m.items()},
                         "n_compact": compactor.k})
        if k % t_cfg.val_rate == 0:
            logs.append({"step": k, **{f"val_{a}": v for a, v in
                                       val_fn(state, k).items()
                                       if v is not None}})
        if k % t_cfg.ckpt_every == 0:
            state.ladder = compactor.state_dict()
            ckpt.save(state, k)
    state.ladder = compactor.state_dict()
    ckpt.save(state, state.step)
    return state, logs


class _Logs:
    def __init__(self):
        self.records = []

    def log(self, k, metrics):
        self.records.append({"step": k, **metrics})


def _assert_states_equal(a, b):
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), k
    for k in ("occs", "occ_q", "od_q", "binaries", "thre"):
        assert torch.equal(getattr(a.grid, k), getattr(b.grid, k)), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step == int(a.step_t) == int(b.step_t)
    assert a.ladder == b.ladder


def test_chunked_train_is_the_step_loop(tmp_path):
    """train() dispatching chunks (eager on the CPU) against the loop of
    one step per iteration, with the few-shot recipe (anneal and hold, the
    weight term's gate inside the run, the occlusion term), the ladder,
    validation every 6 and a checkpoint every 12: the same logged metrics,
    validations, checkpoints and final state, bitwise."""
    cfg = _tiny_cfg()
    scene = SphereScene(n_imgs=3, hw=12)
    held = cli.split_of(scene.holdout(n=1, seed=5))
    runs = {}
    for name in ("chunks", "steps"):
        model, pool = _fresh(cfg, scene)
        ckpt = Checkpointer(str(tmp_path / name))
        val_fn = cli.make_val_fn(model, cfg, held, "cpu")
        if name == "chunks":
            logs = _Logs()
            state = loop.train(model, cfg, pool, scene, logger=logs,
                               log_every=6, checkpointer=ckpt, val_fn=val_fn)
            recs = [{k: v for k, v in r.items() if k != "rays_per_sec"}
                    for r in logs.records]
            recs = [{k: v for k, v in r.items() if k not in ("lr", "alpha")}
                    for r in recs]
        else:
            state, recs = _step_loop(model, cfg, pool, scene, ckpt, val_fn,
                                     6)
        runs[name] = (state, recs, ckpt)
    (a, ra, ca), (b, rb, cb) = runs["chunks"], runs["steps"]
    assert ra == rb
    assert [r["step"] for r in ra if "val_psnr" in r] == [6, 12, 18, 24]
    _assert_states_equal(a, b)
    assert ca.steps() == cb.steps() == [12, 24]
    for k in ca.steps():
        x = torch.load(ca.path(k), weights_only=True)
        y = torch.load(cb.path(k), weights_only=True)
        assert x["step"] == y["step"] and x["ladder"] == y["ladder"]
        assert torch.equal(x["generator"], y["generator"])
        for name in x["model"]:
            assert torch.equal(x["model"][name], y["model"][name])
        for name in x["grid"]:
            assert torch.equal(x["grid"][name], y["grid"][name])


def test_train_scanned_is_the_step_loop():
    """train_scanned on the CPU against its steps run one by one: n_iters
    // chunk chunks, on_chunk after each, the ladder fed each chunk's last
    n_valid_mean (the first chunk at cfg's K ceiling), the final state
    bitwise."""
    cfg = _tiny_cfg(val=False, ckpt_every=0)
    scene = SphereScene(n_imgs=3, hw=12)
    model, pool = _fresh(cfg, scene)
    calls = []
    a = loop.train_scanned(model, cfg, pool, scene, chunk=5,
                           on_chunk=lambda c, s, m: calls.append(
                               (c, s.step, float(m["loss"]))))
    assert [c[:2] for c in calls] == [(0, 5), (1, 10), (2, 15), (3, 20)]
    assert a.step == 20

    model, pool = _fresh(cfg, scene)
    b = step.init_state(model, cfg, step.make_optimizer(cfg, model),
                        scene.aabb)
    compactor = loop.CompactionController(cfg)
    fn = step.make_train_step(model, cfg, b.optimizer, pool, scene)
    losses = []
    for c in range(4):
        for _ in range(5):
            b, m = fn(b)
        losses.append(float(m["loss"]))
        if compactor.observe(float(m["n_valid_mean"])):
            fn = step.make_train_step(model, compactor.apply(cfg),
                                      b.optimizer, pool, scene)
    assert losses == [c[2] for c in calls]
    a.ladder = b.ladder = None
    _assert_states_equal(a, b)


def test_chunk_refuses_graphs_without_a_card():
    """graphs=True needs a CUDA training device."""
    cfg = _tiny_cfg()
    scene = SphereScene(n_imgs=3, hw=12)
    model, pool = _fresh(cfg, scene)
    opt = step.make_optimizer(cfg, model)
    fn = step.make_train_step(model, cfg, opt, pool, scene)
    assert not fn.graphed
    with pytest.raises(ValueError, match="CUDA graphs need"):
        step.make_train_chunk(fn, 4, graphs=True)


def test_launch_counts_and_their_replay_delta():
    """The counting wrappers by name; add_launches adds a graph's counts
    to them and takes them back with negated counts."""
    names = set(kernels.counted())
    assert {"mlp_train_fwd", "mlp_train_bwd", "nerf_density", "ray_march",
            "siren_mlp_fwd", "siren_mlp_bwd", "siren_ray_march",
            "nerf_mlp", "volume_render_fused", "dw_pass"} == names
    before = kernels.launch_counts()
    kernels.add_launches({"mlp_train_fwd": 3, "nerf_density": 2})
    after = kernels.launch_counts()
    assert after["mlp_train_fwd"] == before["mlp_train_fwd"] + 3
    assert after["nerf_density"] == before["nerf_density"] + 2
    kernels.add_launches({"mlp_train_fwd": -3, "nerf_density": -2})
    assert kernels.launch_counts() == before


def test_profiling_helpers(tmp_path):
    """trace() writes a Chrome trace of the block and, beside it,
    spans.jsonl: the block's spans, then the counters."""
    import json

    with profiling.trace(str(tmp_path / "tr")):
        with profiling.span("helpers.block", n=64):
            torch.ones(64).sum()
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0
    lines = [json.loads(x) for x in
             (tmp_path / "tr" / "spans.jsonl").read_text().splitlines()]
    spans = [x for x in lines if x["type"] == "span"]
    assert [(x["name"], x["attrs"]) for x in spans] == [
        ("helpers.block", {"n": 64})]
    assert spans[0]["t1_ns"] >= spans[0]["t0_ns"]
    assert lines[-1]["type"] == "counters" and "rows_valid" in lines[-1]
