"""The port's CLI flow against fsnerf_tpu's: one LLFF train step in NDC on
a 4-level grid, the video frames of a rendered path, the Renderer facade,
and the command line end to end on the CPU over an on-disk Blender scene
and an LLFF scene (splits, training, val and test metrics in
final_metrics.json, the checkpoint, the camera path's frames, and
--render_only from that checkpoint writing the same frames).
"""

import functools
import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fsnerf_tpu.data import poses as jposes
from fsnerf_tpu.data.pool import pool_from_images as jpool_from_images
from fsnerf_tpu.data.splitter import Splitter as JSplitter
from fsnerf_tpu.ops import occgrid as jog
from fsnerf_tpu.train import step as jstep
from fsnerf_tpu_torch import cli
from fsnerf_tpu_torch.core.models import NeRF
from fsnerf_tpu_torch.data.pool import pool_from_images
from fsnerf_tpu_torch.data.splitter import Splitter
from fsnerf_tpu_torch.ops import occgrid as og
from fsnerf_tpu_torch.train import step
from fsnerf_tpu_torch.utils.interop import (state_dict_from_jax,
                                            train_state_from_jax)
from test_torch_train import _both, _Draws
from torch_parity import (AABB, SMALL, nerf_params_np, shell_rays,
                          sphere_density_jax, sphere_density_torch, t)


@pytest.fixture(scope="module")
def blender_root(tmp_path_factory):
    """A Blender-format scene of 12 RGBA 10x10 views (PIL-written)."""
    root = tmp_path_factory.mktemp("datasets")
    scene_dir = root / "synthetic" / "clilego"
    os.makedirs(scene_dir / "train")
    frames = []
    rng = np.random.default_rng(0)
    for i in range(12):
        pose = jposes.pose_from_spherical(4.0, 30.0 + 3 * i, 30.0 * i)
        img = rng.integers(0, 255, (10, 10, 4), dtype=np.uint8)
        img[..., 3] = 255
        Image.fromarray(img, "RGBA").save(scene_dir / f"train/r_{i}.png")
        frames.append({"file_path": f"train/r_{i}",
                       "transform_matrix": pose.tolist()})
    with open(scene_dir / "transforms_train.json", "w") as fh:
        json.dump({"camera_angle_x": 0.6911112, "frames": frames}, fh)
    return str(root)


@pytest.fixture(scope="module")
def llff_root(tmp_path_factory):
    """An LLFF-format scene: 14 forward-facing 12x16 views of smooth
    gradients, poses_bounds.npy in the LLFF column convention."""
    root = tmp_path_factory.mktemp("datasets")
    scene_dir = root / "llff" / "tinyfern"
    os.makedirs(scene_dir / "images_8")
    H, W, focal = 12, 16, 500.0
    rng = np.random.default_rng(7)
    rows = []
    for i in range(14):
        yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
        img = np.stack([xx / W, yy / H, np.full_like(xx, 0.5 + 0.02 * i)], -1)
        Image.fromarray((img * 255).astype(np.uint8)).save(
            scene_dir / "images_8" / f"im_{i:03d}.png")
        c2w = np.zeros((3, 5), np.float32)
        c2w[:3, 0] = [0, -1, 0]
        c2w[:3, 1] = [1, 0, 0]
        c2w[:3, 2] = [0, 0, 1]
        c2w[:3, 3] = 0.05 * rng.normal(size=3)
        c2w[:, 4] = [H * 8, W * 8, focal * 8]
        rows.append(np.concatenate([c2w.flatten(), [2.0 + 0.05 * i, 9.0]]))
    np.save(scene_dir / "poses_bounds.npy", np.stack(rows))
    return str(root)


def test_llff_ndc_train_step_matches_jax(llff_root):
    """One LLFF step in NDC with a 4-level grid on the module paths (XLA,
    torch) from the same state with the JAX step's draws: the pool's NDC
    rays within 1e-5, the loss within rel 1e-3, and the grid after the
    step's all-cell refresh of every level (EMA values within 1e-7 +
    1e-2 |occ| and the threshold within rel 1e-5, the tolerances of
    test_torch_train.py's one-step parity; the binaries equal but where
    the two EMA values straddle the threshold within rel 1e-5)."""
    sections = dict(
        encoder=dict(n_freqs=4, n_freqs_views=2),
        model=dict(n_layers=4, d_filter=64, skip=(2,), fused_kernel=False),
        data=dict(dataset="llff", scene="tinyfern", data_root=llff_root,
                  n_imgs=3),
        sampling=dict(n_samples=48, n_compact=32, grid_resolution=16,
                      grid_levels=4, render_step_size=0.05, warmup_steps=3,
                      update_interval=2),
        train=dict(n_iters=1, batch_size=64, lro=5e-3, dtype="float32"))
    jcfg, tcfg = _both(**sections)
    jsp = JSplitter("llff", "tinyfern", n_training_views=3,
                    data_root=llff_root, seed=0)
    tsp = Splitter("llff", "tinyfern", n_training_views=3,
                   data_root=llff_root, seed=0)
    jsp.split()
    tsp.split()
    jtrain, ttrain = jsp.get_splits()[0], tsp.get_splits()[0]
    assert ttrain.ndc and ttrain.poses.shape[1:] == (3, 4)

    jpool = jpool_from_images(jtrain.imgs, jtrain.poses, jtrain.hwf,
                              ndc=True)
    tpool = pool_from_images(ttrain.imgs, ttrain.poses, ttrain.hwf,
                             ndc=True)
    for a, b in ((tpool.rays_o, jpool.rays_o), (tpool.rays_d, jpool.rays_d),
                 (tpool.rgb, jpool.rgb)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)

    from fsnerf_tpu.core.models import make_model as jmake_model
    params = nerf_params_np(21)
    jmodel = jmake_model(jcfg)
    jopt = jstep.make_optimizer(jcfg)
    # jitted: the 4-level grid's query tables built op by op take seconds
    js = jax.jit(functools.partial(jstep.init_state, jmodel, jcfg, jopt,
                                   jtrain.aabb))(jax.random.key(3))
    js = js.replace(params=jax.tree.map(jnp.asarray, params),
                    opt_state=jopt.init(jax.tree.map(jnp.asarray, params)))
    jfn = jax.jit(jstep.make_train_step(jmodel, jcfg, jopt, jpool, jtrain))

    model = NeRF(**SMALL)
    topt = step.make_optimizer(tcfg, model)
    template = step.init_state(model, tcfg, topt, ttrain.aabb)
    assert template.grid.levels == 4
    ts = train_state_from_jax(js, model, topt, template.grid,
                              template.generator)
    tfn = step.make_train_step(model, tcfg, topt, tpool, ttrain)
    draws = _Draws(js.key, jpool.n, 64, ts.grid, ts.grid.n_cells)
    js, jm = jfn(js)
    ts, tm = tfn(ts, draws=draws)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    assert ts.grid.occs.shape == (4, 16 ** 3)
    occs, j_occs = ts.grid.occs.numpy(), np.asarray(js.grid.occs)
    np.testing.assert_allclose(occs, j_occs, rtol=1e-2, atol=1e-7)
    thre = ts.grid.thre.item()
    np.testing.assert_allclose(thre, float(js.grid.thre), rtol=1e-5)
    # each grid binarizes its own EMA values; the two agree but at cells
    # whose values straddle the threshold by a float rounding (here one
    # cell: 0.01000005 against the JAX 0.01, at the threshold 0.01)
    binaries, j_binaries = ts.grid.binaries.numpy(), np.asarray(
        js.grid.binaries)
    np.testing.assert_array_equal(binaries, occs > thre)
    np.testing.assert_array_equal(j_binaries, j_occs > float(js.grid.thre))
    differ = binaries != j_binaries
    np.testing.assert_allclose(occs[differ], j_occs[differ], rtol=1e-5)
    assert differ.sum() <= 4


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_render_video_matches_jax(dtype):
    """uint8 rgb and plasma depth streams bitwise equal to the JAX
    package's (matplotlib's colormap), on float frames and on the
    compact-transfer uint8 / float16 ones."""
    from fsnerf_tpu.render.renderer import render_video as jrender_video
    from fsnerf_tpu_torch.render.renderer import render_video

    rng = np.random.default_rng(4)
    frames = rng.uniform(-0.1, 1.1, (3, 7, 9, 3)).astype(np.float32)
    depth = rng.uniform(2.0, 6.0, (3, 7, 9)).astype(dtype)
    depth[0, 0, 0] = 2.0
    depth[2, 6, 8] = 6.0
    for f in (frames, (255 * np.clip(frames, 0, 1)).astype(np.uint8)):
        ours, theirs = render_video(f, depth), jrender_video(f, depth)
        for a, b in zip(ours, theirs):
            assert a.dtype == np.uint8 and a.shape == (3, 3, 7, 9)
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("strategy", ["occgrid", "hierarchical"])
def test_renderer_facade_matches_jax(strategy):
    """Renderer.from_state(...).render_rays on the same weights and grid
    (and, for occgrid, render_poses over one 6x8 view): rgb within 7e-3,
    depth within 3e-2 (the ray-march tolerances)."""
    from fsnerf_tpu.core.models import make_model as jmake_model
    from fsnerf_tpu.render.facade import Renderer as JRenderer
    from fsnerf_tpu_torch.render.facade import Renderer

    kw = dict(sampling=dict(strategy=strategy, n_samples=96, n_fine=32,
                            n_compact=48, render_step_size=0.05,
                            grid_resolution=16),
              encoder=dict(n_freqs=4, n_freqs_views=2),
              model=dict(n_layers=4, d_filter=64, skip=(2,)),
              data=dict(white_bkgd=True),
              train=dict(batch_size=32, dtype="float32"))
    jcfg, tcfg = _both(**kw)
    params = nerf_params_np(5)
    _, dil = og.resolve_query_plan(tcfg.sampling, AABB)
    tgrid = og.update(og.create(AABB, 16, 1, dil), sphere_density_torch, 0)
    jgrid = jog.update(jog.create(jnp.asarray(AABB), 16, 1, dil),
                       sphere_density_jax, None, jnp.asarray(0))
    scene = types.SimpleNamespace(near=2.0, far=6.0, ndc=False)
    model = NeRF(**SMALL)
    model.load_state_dict(state_dict_from_jax(params))
    ours = Renderer.from_state(model, types.SimpleNamespace(grid=tgrid),
                               tcfg, scene)
    theirs = JRenderer.from_state(
        jmake_model(jcfg), types.SimpleNamespace(
            params=jax.tree.map(jnp.asarray, params), grid=jgrid),
        jcfg, scene)
    ro, rd = shell_rays(48, seed=2)
    got = ours.render_rays(t(ro), t(rd))
    want = jax.jit(theirs.render_rays)(jnp.asarray(ro), jnp.asarray(rd))
    np.testing.assert_allclose(got["rgb"].numpy(), np.asarray(want["rgb"]),
                               atol=7e-3)
    np.testing.assert_allclose(got["depth"].numpy(),
                               np.asarray(want["depth"]), atol=3e-2)
    assert ours.chunksize == theirs.chunksize == 64
    if strategy == "occgrid":
        pose = jposes.pose_from_spherical(4.0, 40.0, 70.0)[None]
        hwf = (6, 8, 7.0)
        (rgb, depth), (j_rgb, j_depth) = (
            ours.render_poses(pose, hwf),
            theirs.render_poses(jnp.asarray(pose), hwf))
        assert rgb.shape == (1, 6, 8, 3) and depth.shape == (1, 6, 8)
        np.testing.assert_allclose(rgb, j_rgb, atol=7e-3)
        np.testing.assert_allclose(depth, j_depth, atol=3e-2)


SMALL_FLAGS = ["--device", "cpu", "--n_iters", "6", "--batch_size", "64",
               "--n_samples", "24", "--n_compact", "16",
               "--grid_resolution", "8", "--n_freqs", "3",
               "--n_freqs_views", "2", "--n_layers", "3", "--d_filter", "32",
               "--skip", "1", "--fused_kernel"]


def _frames(video_dir):
    return {n: open(os.path.join(video_dir, n), "rb").read()
            for n in sorted(os.listdir(video_dir))}


def _run_cli_flow(flags, out_dir, capsys):
    """main over `flags`, then --render_only from its checkpoint: the JSON
    lines, final_metrics.json and the frames of both runs, and the run
    directory under out_dir that holds them."""
    run = cli.run_dir(cli.config_from_args(flags + ["--out_dir", out_dir]))
    assert cli.main(flags + ["--out_dir", out_dir]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    with open(os.path.join(run, "final_metrics.json")) as fh:
        final = json.load(fh)
    frames = _frames(os.path.join(run, "video"))
    assert cli.main(flags + ["--out_dir", out_dir, "--render_only"]) == 0
    again = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return line, final, frames, again, run


def _check_flow(line, final, frames, again, out_dir, n_frames):
    for k in ("psnr", "ssim", "test_psnr", "test_ssim"):
        assert np.isfinite(final[k]) and final[k] == line[k]
    assert final["lpips"] is None and final["test_lpips"] is None
    assert os.listdir(os.path.join(out_dir, "ckpt"))
    assert sorted(frames) == sorted(
        [f"rgb_{i:04d}.png" for i in range(n_frames)]
        + [f"depth_{i:04d}.png" for i in range(n_frames)])
    assert line["path_frames"] == n_frames
    # the render-only run restored the final checkpoint: same metrics and
    # the same frames, byte for byte
    assert again["restored_step"] == line["steps"] == 6
    assert again["psnr"] == line["psnr"]
    assert _frames(os.path.join(out_dir, "video")) == frames


def test_cli_blender_flow_end_to_end(blender_root, tmp_path, monkeypatch,
                                     capsys):
    """--dataset synthetic: the JAX splitter's train/val/test ids, val and
    test metrics, the checkpoint, the orbit's frames (shortened to 3) and
    --render_only reproducing them."""
    from fsnerf_tpu_torch.data import blender

    orbit = blender.spherical_path
    monkeypatch.setattr(blender, "spherical_path",
                        lambda radius, theta, frames: orbit(radius, theta, 3))
    flags = ["--dataset", "synthetic", "--scene", "clilego", "--data_root",
             blender_root, "--n_imgs", "4", "--white_bkgd"] + SMALL_FLAGS
    sp = cli.make_splitter(cli.config_from_args(flags))
    jsp = JSplitter("synthetic", "clilego", n_training_views=4,
                    data_root=blender_root, white_bkgd=True, seed=42)
    jsp.split()
    for k in ("train_ids", "val_ids", "test_ids"):
        np.testing.assert_array_equal(getattr(sp, k), getattr(jsp, k))
    line, final, frames, again, out_dir = _run_cli_flow(
        flags, str(tmp_path / "out"), capsys)
    assert line["views"] == {"train": 4, "val": 1, "test": 1}
    _check_flow(line, final, frames, again, out_dir, 3)
    rgb = np.asarray(Image.open(os.path.join(out_dir, "video",
                                             "rgb_0000.png")))
    assert rgb.shape == (10, 10, 3)


def test_cli_llff_flow_end_to_end(llff_root, tmp_path, capsys):
    """--dataset llff: NDC rays, a 4-level grid (the checkpoint's), the
    JAX splitter's ids, val and test metrics, the 120-frame spiral and
    --render_only reproducing it."""
    flags = ["--dataset", "llff", "--scene", "tinyfern", "--data_root",
             llff_root, "--n_imgs", "3", "--render_step_size", "0.05"] \
        + SMALL_FLAGS
    cfg = cli.config_from_args(flags)
    assert cfg.sampling.grid_levels == 4
    sp = cli.make_splitter(cfg)
    jsp = JSplitter("llff", "tinyfern", n_training_views=3,
                    data_root=llff_root, seed=42)
    jsp.split()
    for k in ("train_ids", "val_ids", "test_ids"):
        np.testing.assert_array_equal(getattr(sp, k), getattr(jsp, k))
    line, final, frames, again, out_dir = _run_cli_flow(
        flags, str(tmp_path / "out"), capsys)
    assert line["views"] == {"train": 3, "val": 2, "test": 2}
    _check_flow(line, final, frames, again, out_dir, 120)
    from fsnerf_tpu_torch.utils.checkpoint import Checkpointer
    ckpt = Checkpointer(os.path.join(out_dir, "ckpt"))
    blob = torch.load(ckpt.path(ckpt.latest_step()), weights_only=True)
    assert blob["grid"]["occs"].shape == (4, 8 ** 3)
