"""The port's serving artifact (fsnerf_tpu_torch/utils/export.py) against
the live chunk renderer and against fsnerf_tpu/utils/export.py.

Each artifact is exported on the CPU, saved, loaded back in the same
process and replayed: the loaded program must reproduce the live renderer
bitwise for occgrid through the NeRF module, occgrid through the forward
MLP's op (make_fused_model_fn: the graph calls fsnerf_torch.nerf_mlp),
hierarchical, and SiNeRF through the SIREN forward's op
(make_siren_forward_fn: fsnerf_torch.siren_mlp_fwd).
render_frame_exported must match render_frame as tests/test_export.py
holds the JAX one, and the JAX package's exported frame of the same
weights and grid within tests/test_export.py's frame tolerances (rgb
1e-5, depth 1e-4; both sides float32 modules). Small sizes: 4x64 with
skip 2, n_freqs 4 / 2, a res-16 grid, chunks of 128 rays.

The card's run of the same roundtrip (kernels 3 and 7, launches counted)
is tests/test_torch_cuda.py::test_export_roundtrip_on_the_card."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.core.models import NeRF as JNeRF
from fsnerf_tpu.ops import occgrid as jog
from fsnerf_tpu.render import renderer as jrend
from fsnerf_tpu.utils import export as jexport
from fsnerf_tpu_torch.core.models import NeRF, SiNeRF
from fsnerf_tpu_torch.data.synthetic import SphereScene
from fsnerf_tpu_torch.ops import occgrid as og
from fsnerf_tpu_torch.ops.kernels.mlp import make_fused_model_fn
from fsnerf_tpu_torch.ops.kernels.siren import (make_siren_forward_fn,
                                                siren_alphas)
from fsnerf_tpu_torch.render import renderer
from fsnerf_tpu_torch.utils import export
from fsnerf_tpu_torch.utils.interop import state_dict_from_jax
from torch_parity import (AABB, SMALL, nerf_params_np, shell_rays,
                          sinerf_params_np, sphere_density_jax,
                          sphere_density_torch, t)

CHUNK = 128
OCC = dict(strategy="occgrid", n_samples=32, render_step_size=0.1,
           white_bkgd=True, n_compact=16, early_stop_eps=1e-4)
HIER = dict(strategy="hierarchical", n_samples=16, n_fine=32,
            white_bkgd=True)
# the JAX package's meta.json keys (jax_version aside)
JAX_KEYS = ("chunksize", "hwf", "near", "far", "ndc", "platforms")


@pytest.fixture(scope="module")
def scene():
    return SphereScene(n_imgs=2, hw=16)


@pytest.fixture(scope="module")
def grid():
    return og.update(og.create(AABB, resolution=16, levels=1),
                     sphere_density_torch, 0)


def _nerf(seed=0):
    """A NeRF of nerf_params_np(seed), its sigma bias raised by 10 so the
    sphere is opaque (depth lands on its surface, not clamped to near)."""
    params = nerf_params_np(seed)
    params["params"]["sigma"]["bias"] = params["params"]["sigma"]["bias"] \
        + 10.0
    model = NeRF(**SMALL)
    model.load_state_dict(state_dict_from_jax(params))
    return model


def _model_fns():
    """name -> (model_fn, the op its graph must call or None, the render
    kwargs)."""
    nerf = _nerf(1)
    siren = SiNeRF(width=64, alpha=siren_alphas(4))
    siren.load_state_dict(state_dict_from_jax(sinerf_params_np(2)))
    fused = make_fused_model_fn(nerf.state_dict(), n_layers=4, skip=(2,),
                                n_freqs=4, n_freqs_views=2)
    return {
        "occgrid_module": (lambda x, d=None: nerf(x, d), None, OCC),
        "occgrid_nerf_mlp_op": (fused, "fsnerf_torch.nerf_mlp", OCC),
        "hierarchical_module": (lambda x, d=None: nerf(x, d), None, HIER),
        "sinerf_siren_op": (make_siren_forward_fn(siren.state_dict(), 4),
                            "fsnerf_torch.siren_mlp_fwd", OCC),
    }


@pytest.fixture(scope="module")
def exported(tmp_path_factory, scene, grid):
    """name -> (live chunk renderer, artifact path, the op it must call)."""
    out = {}
    for name, (model_fn, op, kw) in _model_fns().items():
        live = renderer.make_chunk_renderer(
            model_fn, grid=grid, near=scene.near, far=scene.far, **kw)
        path = export.export_render_artifact(
            live, CHUNK, str(tmp_path_factory.mktemp(name) / "artifact"),
            hwf=scene.hwf, near=scene.near, far=scene.far, device="cpu",
            extra_meta={"model": name})
        out[name] = (live, path, op)
    return out


@pytest.mark.parametrize("name", sorted(_model_fns()))
def test_roundtrip_bitwise(exported, name):
    """The loaded program == the live renderer, bitwise; the saved graph
    calls the kernel's op where the model function does."""
    live, path, op = exported[name]
    fn, meta = export.load_render_artifact(path)
    assert meta["chunksize"] == CHUNK and meta["platforms"] == ["cpu"]
    assert meta["model"] == name
    ro, rd = shell_rays(CHUNK, seed=3)
    rgb_live, depth_live = live(t(ro), t(rd))
    rgb_art, depth_art = fn(t(ro), t(rd))
    assert torch.equal(rgb_live, rgb_art) and torch.equal(depth_live,
                                                          depth_art)
    calls = {str(n.target) for m in torch.export.load(
        os.path.join(path, "renderer.pt2")).graph_module.modules()
        if isinstance(m, torch.fx.GraphModule)
        for n in m.graph.nodes if n.op == "call_function"}
    if op is None:
        assert not any(c.startswith("fsnerf_torch.") for c in calls)
    else:
        assert f"{op}.default" in calls


def test_render_frame_exported_matches(exported, scene, grid):
    """tests/test_export.py's frame check: render_frame_exported ==
    render_frame (rgb atol 1e-5, depth 1e-4; here also bitwise, as the
    chunks are the same)."""
    live, path, _ = exported["occgrid_nerf_mlp_op"]
    rgb, depth = export.render_frame_exported(path, scene.poses[0])
    H, W, _ = scene.hwf
    assert rgb.shape == (H, W, 3) and depth.shape == (H, W)
    assert rgb.dtype == np.float32 and depth.dtype == np.float32
    rgb_ref, depth_ref = renderer.render_frame(
        None, t(scene.poses[0]), scene.hwf, scene.near, scene.far,
        chunksize=CHUNK, chunk_renderer=live)
    np.testing.assert_allclose(rgb, rgb_ref.numpy(), atol=1e-5)
    np.testing.assert_allclose(depth, depth_ref.numpy(), atol=1e-4)
    np.testing.assert_array_equal(rgb, rgb_ref.numpy())
    np.testing.assert_array_equal(depth, depth_ref.numpy())
    assert depth.max() > scene.near + 1.0


def test_render_frame_exported_compact_transfer(exported, scene):
    """compact_transfer quantizes on the device: uint8 rgb with to8b
    semantics, float16 depth (tests/test_export.py's check)."""
    _, path, _ = exported["occgrid_module"]
    loaded = export.load_render_artifact(path)
    rgb_f32, depth_f32 = export.render_frame_exported(loaded, scene.poses[1])
    rgb8, depth16 = export.render_frame_exported(loaded, scene.poses[1],
                                                 compact_transfer=True)
    assert rgb8.dtype == np.uint8 and depth16.dtype == np.float16
    np.testing.assert_array_equal(
        rgb8, (255.0 * np.clip(rgb_f32, 0, 1)).astype(np.uint8))
    np.testing.assert_allclose(depth16.astype(np.float32), depth_f32,
                               rtol=2e-3)


def test_frame_matches_the_jax_artifact(tmp_path, scene, grid):
    """The same weights (nerf_params_np, the sigma bias raised by 10 so the
    sphere is opaque and depth is not clamped to near) and the same
    analytic sphere grid exported by both packages (the JAX one on its XLA
    module path, the port's through the float32 NeRF module), each frame
    rendered by its package's render_frame_exported: within
    tests/test_export.py's 1e-5 in rgb and 1e-4 in depth, tighter than the
    ray march's 7e-3 / 3e-2 as both sides are float32 modules (read 1.2e-7
    and 1.4e-6), and meta.json carries the JAX keys with the same
    values."""
    params = nerf_params_np(4)
    params["params"]["sigma"]["bias"] = params["params"]["sigma"]["bias"] \
        + 10.0
    jm = JNeRF(**SMALL)
    jgrid = jog.update(jog.create(jnp.asarray(AABB), resolution=16,
                                  levels=1), sphere_density_jax, None,
                       jnp.asarray(0))
    jlive = jrend.make_chunk_renderer(
        lambda x, d=None: jm.apply(params, x, d), grid=jgrid,
        near=scene.near, far=scene.far, **OCC)
    jpath = jexport.export_render_artifact(
        jlive, CHUNK, str(tmp_path / "jax"), hwf=scene.hwf, near=scene.near,
        far=scene.far)
    model = NeRF(**SMALL)
    model.load_state_dict(state_dict_from_jax(params))
    tlive = renderer.make_chunk_renderer(
        lambda x, d=None: model(x, d), grid=grid, near=scene.near,
        far=scene.far, **OCC)
    tpath = export.export_render_artifact(
        tlive, CHUNK, str(tmp_path / "torch"), hwf=scene.hwf,
        near=scene.near, far=scene.far, device="cpu")
    for pose in scene.poses:
        rgb_j, dep_j = jexport.render_frame_exported(jpath, pose)
        rgb_t, dep_t = export.render_frame_exported(tpath, pose)
        assert dep_t.max() > scene.near + 1.0     # the surface, not near
        np.testing.assert_allclose(rgb_t, np.asarray(rgb_j), atol=1e-5)
        np.testing.assert_allclose(dep_t, np.asarray(dep_j), atol=1e-4)
    with open(os.path.join(jpath, "meta.json")) as fh:
        jmeta = json.load(fh)
    with open(os.path.join(tpath, "meta.json")) as fh:
        tmeta = json.load(fh)
    assert {k: tmeta[k] for k in JAX_KEYS} == {k: jmeta[k] for k in JAX_KEYS}
    assert tmeta["torch_version"] == torch.__version__


def test_cuda_artifact_refused_without_cuda(exported, tmp_path,
                                           monkeypatch):
    """A meta.json naming CUDA makes the load raise where CUDA is missing;
    the program is never moved to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, path, _ = exported["occgrid_module"]
    art = tmp_path / "cuda_artifact"
    art.mkdir()
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)
    meta["platforms"] = ["cuda"]
    (art / "meta.json").write_text(json.dumps(meta))
    with open(os.path.join(path, "renderer.pt2"), "rb") as fh:
        (art / "renderer.pt2").write_bytes(fh.read())
    with pytest.raises(RuntimeError, match="CUDA"):
        export.load_render_artifact(str(art))
    with pytest.raises(RuntimeError, match="CUDA"):
        export.render_frame_exported(str(art), np.eye(4))
