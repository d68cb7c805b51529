"""fsnerf_tpu_torch's data-parallel layer (parallel/) against fsnerf_tpu's
and against its own single-process paths, on the CPU.

The JAX side runs its XLA module path (fused_kernel False) on a 2-device
mesh of the 8 virtual CPU devices (tests/conftest.py). The port's side runs
2 ranks over gloo: the `ranks` fixture spawns them once for the file
(tests/torch_parallel_worker.py, a FileStore under tmp_path) and each runs
every check's work: one parallel step with the JAX step's per-device
draws, the sharded refresh of an analytic density, one view rendered tiled
through the ray march and through the module, and 30 steps of
train(..., mesh=) through a change of the ladder's rung. Sizes: NeRF 4x64
skip 2, n_freqs 4/2, grid res 16, 16^2 views.
"""

import dataclasses
import json
import multiprocessing
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fsnerf_tpu.config import Config as JConfig
from fsnerf_tpu.config import DataConfig as JDataConfig
from fsnerf_tpu.config import EncoderConfig as JEncoderConfig
from fsnerf_tpu.config import ModelConfig as JModelConfig
from fsnerf_tpu.config import SamplingConfig as JSamplingConfig
from fsnerf_tpu.config import TrainConfig as JTrainConfig
from fsnerf_tpu.core.models import make_model as jmake_model
from fsnerf_tpu.data.pool import pool_from_images as jpool_from_images
from fsnerf_tpu.ops import occgrid as jog
from fsnerf_tpu.parallel.mesh import make_mesh as jmake_mesh
from fsnerf_tpu.parallel.mesh import replicate as jreplicate
from fsnerf_tpu.parallel.train_parallel import \
    make_parallel_train_step as jmake_parallel_train_step
from fsnerf_tpu.train import step as jstep
from fsnerf_tpu_torch import cli
from fsnerf_tpu_torch.data.synthetic import SphereScene
from fsnerf_tpu_torch.ops import occgrid as og
from fsnerf_tpu_torch.parallel import (Mesh, batch_sharding, make_mesh,
                                       shard_batch)
from fsnerf_tpu_torch.parallel.train_parallel import \
    make_parallel_train_step
from fsnerf_tpu_torch.train import step as tstep
from fsnerf_tpu_torch.utils.interop import state_dict_from_jax
from torch_parallel_worker import (GlobalDraws, make_run, render_view,
                                   small_cfg, sphere_density)
from torch_parity import nerf_params_np, sphere_density_jax, t

WORLD = 2
BATCH = 64
LOCAL = BATCH // WORLD
PART_STEP = 272             # (272 // 16) % 4 == 1: part 1, after warmup


def _jax_cfg():
    c = small_cfg()
    return JConfig(
        encoder=JEncoderConfig(**dataclasses.asdict(c.encoder)),
        model=JModelConfig(**dataclasses.asdict(c.model)),
        data=JDataConfig(**dataclasses.asdict(c.data)),
        sampling=JSamplingConfig(**dataclasses.asdict(c.sampling)),
        train=JTrainConfig(**dataclasses.asdict(c.train)))


def _jax_parallel_step(params):
    """One step of fsnerf_tpu's make_parallel_train_step on a 2-device mesh
    from `params`, and the per-device draws it took: (state, metrics,
    (global indices, global jitter, grid jitter))."""
    jcfg = _jax_cfg()
    scene = SphereScene(n_imgs=3, hw=16)
    jmodel = jmake_model(jcfg)
    jopt = jstep.make_optimizer(jcfg)
    jpool = jpool_from_images(scene.imgs, scene.poses, scene.hwf)
    mesh = jmake_mesh(WORLD)
    js = jstep.init_state(jmodel, jcfg, jopt, scene.aabb, jax.random.key(7))
    js = js.replace(params=jax.tree.map(jnp.asarray, params),
                    opt_state=jopt.init(jax.tree.map(jnp.asarray, params)))
    _, k_batch, k_render, k_grid = jax.random.split(js.key, 4)
    idx = np.concatenate([np.asarray(jax.random.randint(
        jax.random.fold_in(k_batch, d), (LOCAL,), 0, jpool.n))
        for d in range(WORLD)])
    u = np.concatenate([np.asarray(jax.random.uniform(
        jax.random.fold_in(k_render, d), (LOCAL, 1))) for d in range(WORLD)])
    n = js.grid.occs.shape[1]
    gj = [t(jax.random.uniform(k, (n, 3)))
          for k in jax.random.split(k_grid, js.grid.levels)]
    fn = jmake_parallel_train_step(jmodel, jcfg, jopt, jpool, scene, mesh)
    js, jm = fn(jreplicate(js, mesh))
    draws = (torch.from_numpy(idx).long(), torch.from_numpy(u), gj)
    return js, jax.device_get(jm), draws


def _refresh_jitter(n, levels):
    """The JAX update's per-level cell jitter for an all-cell and a part
    refresh, with their keys."""
    keys = {"all": jax.random.key(21), 1: jax.random.key(22)}
    sizes = {"all": n, 1: n // 4}
    jit = {p: [t(jax.random.uniform(k, (sizes[p], 3)))
               for k in jax.random.split(keys[p], levels)] for p in keys}
    return keys, jit


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 2 gloo ranks once: their results, rank 0's log, the JAX
    step's results and the payload they were given."""
    work = str(tmp_path_factory.mktemp("ranks"))
    params = nerf_params_np(12)
    js, jm, draws = _jax_parallel_step(params)
    keys, jit = _refresh_jitter(16 ** 3, 2)
    payload = {"sd": state_dict_from_jax(params), "jax_draws": draws,
               "refresh_jitter": jit}
    torch.save(payload, os.path.join(work, "payload.pt"))
    from torch_parallel_worker import run
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=run, args=(r, WORLD, work))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    assert [p.exitcode for p in procs] == [0] * WORLD
    out = [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
           for r in range(WORLD)]
    return {"out": out, "work": work, "payload": payload, "jax": (js, jm),
            "refresh_keys": keys}


def _single_step(payload):
    """The port's single-process TrainStep on the same global draws."""
    cfg = small_cfg()
    scene = SphereScene(n_imgs=3, hw=16)
    model, opt, state, pool = make_run(cfg, payload["sd"], scene)
    fn = tstep.make_train_step(model, cfg, opt, pool, scene)
    state, m = fn(state, draws=GlobalDraws(*payload["jax_draws"]))
    return model, state, m


def test_parallel_step_matches_jax(ranks):
    """The 2-rank step from the JAX parallel step's state with its
    per-device draws: loss within 1e-3 relative, psnr within 1e-3
    relative, occupancy, samples_per_ray and n_valid_mean equal, and the
    updated weights within 2.5 lr of JAX's (Adam's first step moves a
    weight by about +-lr whatever its gradient's size, so a gradient that
    is ~0 on both sides may take opposite signs; the gradients themselves
    are held in test_sharded_grads_match_single_process), with 99.9% of
    them within 1e-6 (measured: every weight within 5.6e-7, the loss
    equal)."""
    js, jm = ranks["jax"]
    got = ranks["out"][0]["step"]
    m = got["metrics"]
    assert abs(m["loss"] - float(jm["loss"])) / float(jm["loss"]) < 1e-3
    assert abs(m["psnr"] - float(jm["psnr"])) / float(jm["psnr"]) < 1e-3
    for k in ("occupancy", "samples_per_ray", "n_valid_mean"):
        assert m[k] == float(jm[k]), k
    lr = small_cfg().train.lro
    want = state_dict_from_jax(jax.tree.map(np.asarray, js.params))
    close = total = 0
    for name, w in got["weights"].items():
        d = (w - want[name]).abs()
        assert float(d.max()) <= 2.5 * lr, name
        close += int((d <= 1e-6).sum())
        total += d.numel()
    assert close >= 0.999 * total, close / total


def test_sharded_grads_match_single_process(ranks):
    """The 2 ranks' averaged gradient against the single-process
    gradient on the concatenated batch (float32, rtol 2e-4 / atol 2e-5, as
    JAX's test_sharded_grads_match_single_device), bitwise equal on the
    two ranks; loss and metrics within 1e-6 relative."""
    model, _, m = _single_step(ranks["payload"])
    a, b = (ranks["out"][r]["step"] for r in range(WORLD))
    for name, p in model.named_parameters():
        assert torch.equal(a["grads"][name], b["grads"][name]), name
        np.testing.assert_allclose(a["grads"][name].numpy(),
                                   p.grad.numpy(), rtol=2e-4, atol=2e-5,
                                   err_msg=name)
        assert torch.equal(a["weights"][name], b["weights"][name]), name
    for k, v in m.items():
        np.testing.assert_allclose(a["metrics"][k], float(v), rtol=1e-6,
                                   err_msg=k)


def test_sharded_refresh_matches_replicated_and_jax(ranks):
    """The sharded refresh of the module's densities (every cell, the
    stepped weights, 2,048 rows per rank against 4,096 in one process)
    against the replicated one: binaries equal, values within 1e-5
    relative (torch's CPU GEMM blocks 2,048 rows otherwise than 4,096:
    measured 1 cell of 4,096 apart, by 1.9e-10, 1.3e-6 relative). The step's own refresh against the
    single-process step's: binaries equal, values within 1e-5 relative +
    1e-7 (the two steps' weights differ by the rounding of the gradient
    average, the gradients by at most 4.5e-8; measured 2.8e-9). Then the
    sharded refresh of an analytic density, every cell and part 1 after
    it: bitwise the port's replicated refresh, and against the JAX update
    with shard_axes on a 2-device mesh with the same keys: binaries equal,
    values within 1e-6 relative (measured equal)."""
    model, state, _ = _single_step(ranks["payload"])
    occs, thre, binaries = ranks["out"][0]["refresh"]["module"]
    grid = og.create(np.asarray(state.grid.base_aabb), 16, 1, 1)
    with torch.no_grad():
        og.update_(grid, tstep.make_density_fn(model, small_cfg(),
                                                device="cpu"),
                   None, False, render_step_size=0.05,
                   jitter=ranks["payload"]["jax_draws"][2])
    assert torch.equal(binaries, grid.binaries)
    np.testing.assert_allclose(occs.numpy(), grid.occs.numpy(), rtol=1e-5)
    got = ranks["out"][0]["step"]
    assert torch.equal(got["occs"] > got["thre"],
                       state.grid.occs > state.grid.thre)
    np.testing.assert_allclose(got["thre"].item(), state.grid.thre.item(),
                               rtol=1e-6)
    np.testing.assert_allclose(got["occs"].numpy(), state.grid.occs.numpy(),
                               rtol=1e-5, atol=1e-7)

    jit = ranks["payload"]["refresh_jitter"]
    keys = ranks["refresh_keys"]
    aabb = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)
    grid = og.create(aabb, 16, 2, 1)
    mesh = jmake_mesh(WORLD)
    plan = (("data", WORLD),)
    jgrid = jog.create(jnp.asarray(aabb), 16, 2, 1)

    def jupdate(g, key, step):
        fn = jax.jit(jax.shard_map(
            lambda gg: jog.update(gg, sphere_density_jax, key,
                                  jnp.asarray(step),
                                  render_step_size=0.05,
                                  shard_axes=plan),
            mesh=mesh, in_specs=jax.sharding.PartitionSpec(),
            out_specs=jax.sharding.PartitionSpec(), check_vma=False))
        return fn(g)

    for part, step in (("all", 0), (1, PART_STEP)):
        og.update_(grid, sphere_density, None if part == "all" else part,
                   False, render_step_size=0.05, jitter=jit[part])
        jgrid = jupdate(jgrid, keys[part], step)
        occs, thre, binaries = ranks["out"][0]["refresh"][part]
        for r in range(WORLD):
            assert torch.equal(ranks["out"][r]["refresh"][part][0], occs)
        assert torch.equal(occs, grid.occs) and torch.equal(thre, grid.thre)
        assert torch.equal(binaries, grid.binaries)
        np.testing.assert_array_equal(binaries.numpy(),
                                      np.asarray(jgrid.binaries))
        np.testing.assert_allclose(occs.numpy(), np.asarray(jgrid.occs),
                                   rtol=1e-6)


def test_tiled_render_matches_single_process(ranks):
    """One 16^2 view rendered tiled on 2 ranks (chunks of 100 rays, so
    the march pads each chunk to whole blocks per rank) against the
    single-process render: through the ray march's plain version bitwise
    (each rank marches whole 16-ray blocks, the blocks of one process),
    and through the module and the compositing within 1e-6 in rgb and
    1e-5 in depth (the module's float32 GEMMs over a rank's 50 rows
    against 100 could round apart; measured bitwise here)."""
    cfg = small_cfg()
    scene = SphereScene(n_imgs=3, hw=16)
    model, _, state, _ = make_run(cfg, ranks["payload"]["sd"], scene)
    _, stepped, _ = _single_step(ranks["payload"])
    model.load_state_dict({n: w for n, w in
                           ranks["out"][0]["step"]["weights"].items()})
    held = cli.build_split("sphere", 1, 16, True, 3)
    grid = og.with_occs(stepped.grid, ranks["out"][0]["step"]["occs"],
                        ranks["out"][0]["step"]["thre"])
    rcfg = small_cfg(model=dict(fused_kernel=True))
    for fused in (True, False):
        img, depth = render_view(model, rcfg, grid, held, None, fused)
        for r in range(WORLD):
            timg, tdepth = ranks["out"][r]["render"][fused]
            if fused:
                assert torch.equal(timg, img) and torch.equal(tdepth, depth)
            else:
                np.testing.assert_allclose(timg.numpy(), img.numpy(),
                                           atol=1e-6)
                np.testing.assert_allclose(tdepth.numpy(), depth.numpy(),
                                           atol=1e-5)


def test_one_rank_parallel_step_is_the_train_step(tmp_path):
    """A world of one changes only the code path: 6 parallel steps
    (crossing all-cell refreshes) over a 1-rank gloo group are bitwise the
    TrainStep's: weights, Adam moments, grid and generator."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh(1, device="cpu")
        assert (mesh.world, mesh.rank, mesh.backend) == (1, 0, "gloo")
        cfg = small_cfg()
        scene = SphereScene(n_imgs=3, hw=16)
        runs = []
        for parallel in (True, False):
            model, opt, state, pool = make_run(cfg, None, scene)
            fn = (make_parallel_train_step(model, cfg, opt, pool, scene,
                                           mesh)
                  if parallel else
                  tstep.make_train_step(model, cfg, opt, pool, scene))
            for _ in range(6):
                state, m = fn(state)
            runs.append((model, opt, state, m))
        (ma, oa, sa, mta), (mb, ob, sb, mtb) = runs
        for (n, p), q in zip(ma.named_parameters(), mb.parameters()):
            assert torch.equal(p, q), n
            for k in ("exp_avg", "exp_avg_sq"):
                assert torch.equal(oa.state[p][k], ob.state[q][k]), n
        assert torch.equal(sa.grid.occs, sb.grid.occs)
        assert torch.equal(sa.grid.thre, sb.grid.thre)
        assert torch.equal(sa.generator.get_state(), sb.generator.get_state())
        assert {k: float(v) for k, v in mta.items()} == \
            {k: float(v) for k, v in mtb.items()}
    finally:
        dist.destroy_process_group()


def test_train_ranks_stay_in_lockstep(ranks):
    """30 steps of train(..., mesh=) on 2 ranks with validation at 15 and
    30: the ladder's rung changes, both ranks end bitwise equal (weights,
    grid, generator, ladder), both ran the tiled validation, and only rank
    0 wrote the log."""
    a, b = (ranks["out"][r]["train"] for r in range(WORLD))
    for name, w in a["weights"].items():
        assert torch.equal(w, b["weights"][name]), name
    assert torch.equal(a["occs"], b["occs"])
    assert torch.equal(a["generator"], b["generator"])
    assert a["ladder"] == b["ladder"] and a["step"] == b["step"] == 30
    assert a["vals"] == b["vals"] == [15, 30]
    recs = [json.loads(line) for line in open(os.path.join(
        ranks["work"], "log", "metrics.jsonl")).read().splitlines()]
    ks = [r["n_compact"] for r in recs if "n_compact" in r]
    assert len(set(ks)) > 1, ks
    assert [r["step"] for r in recs if "val_psnr" in r] == [15, 30]


def test_mesh_helpers_and_refusals():
    """make_mesh without a process group refuses, and names torchrun; the
    rows of a batch split contiguously by rank."""
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torchrun"):
        make_mesh(2)
    m = Mesh(world=4, rank=2, device=torch.device("cpu"), backend="gloo")
    assert batch_sharding(m, 64) == slice(32, 48)
    batch = (torch.arange(8.0), torch.arange(16.0).reshape(8, 2))
    got = shard_batch(batch, m)
    assert torch.equal(got[0], batch[0][4:6])
    assert torch.equal(got[1], batch[1][4:6])
    with pytest.raises(ValueError):
        m.rows(10)
