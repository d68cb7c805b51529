"""The port's CPU-only utilities (fsnerf_tpu_torch/utils/{plotting,
camera3dplotter,compare_densities,chunks}.py) against their fsnerf_tpu
counterparts, on the checks of tests/test_utils.py: the same inputs give
equal arrays and the same files, byte for byte (matplotlib draws both).
Neither plotly nor wandb is installed here, so save_html writes the
matplotlib PNG, as the CLI's camera plot does."""

import os

import numpy as np
import pytest

from fsnerf_tpu.utils import camera3dplotter as jcam
from fsnerf_tpu.utils import chunks as jchunks
from fsnerf_tpu.utils import compare_densities as jcmp
from fsnerf_tpu.utils import plotting as jplot
from fsnerf_tpu_torch.utils import camera3dplotter, chunks, \
    compare_densities, plotting


def _curves(seed):
    return np.abs(np.random.default_rng(seed).normal(size=(3, 16)))


@pytest.mark.parametrize("vmax", [6.0, 2.5])
def test_apply_colormap_matches(vmax):
    depth = np.linspace(0, 6, 64).reshape(8, 8)
    got = plotting.apply_colormap(depth, vmax=vmax)
    assert got.shape == (8, 8, 4)
    assert got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_array_equal(got, jplot.apply_colormap(depth,
                                                            vmax=vmax))


def test_density_animate_writes_the_same_gif(tmp_path):
    a, b = _curves(0), _curves(1)
    out, ref = tmp_path / "densities.gif", tmp_path / "ref.gif"
    plotting.density_animate(a, b, out_path=str(out))
    jplot.density_animate(a, b, out_path=str(ref))
    assert out.stat().st_size > 0
    assert out.read_bytes() == ref.read_bytes()


def test_compare_densities_cli(tmp_path):
    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    np.savez(a, curves=np.ones((2, 8)))
    np.savez(b, curves=np.zeros((2, 8)))
    out, ref = tmp_path / "out.gif", tmp_path / "ref.gif"
    assert compare_densities.main([str(a), str(b), "--out", str(out),
                                   "--labels", "nerf", "dsnerf"]) == 0
    assert jcmp.main([str(a), str(b), "--out", str(ref), "--labels", "nerf",
                      "dsnerf"]) == 0
    assert out.exists() and out.read_bytes() == ref.read_bytes()


def test_camera_plotter_falls_back_to_png(tmp_path):
    poses = np.tile(np.eye(4)[None], (5, 1, 1))
    poses[:, :3, 3] = np.random.default_rng(2).normal(size=(5, 3))
    written = []
    for mod, name in ((camera3dplotter, "port"), (jcam, "jax")):
        p = mod.Camera3DPlotter()
        p.set_poses(poses, "train")
        p.set_poses(poses[:2] + 1.0, "val")
        p.configure_pose_markers("train", color="red")
        p.set_axes_ranges([-5, 5], [-5, 5], [-5, 5])
        written.append(p.save_html(str(tmp_path / f"{name}.html")))
        p.upload_plot()            # without wandb: nothing, no error
    port, ref = written
    assert port == str(tmp_path / "port.png")
    assert os.path.getsize(port) > 0
    with open(port, "rb") as fa, open(ref, "rb") as fb:
        assert fa.read() == fb.read()


@pytest.mark.parametrize("n,size", [(10, 3), (12, 4), (5, 8)])
def test_get_chunks_matches(n, size):
    x = np.arange(n * 2).reshape(n, 2)
    got, want = chunks.get_chunks(x, size), jchunks.get_chunks(x, size)
    assert len(got) == len(want) == -(-n // size)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
