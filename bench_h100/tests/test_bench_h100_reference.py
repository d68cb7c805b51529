"""The plain reference on cases worked by hand, and against the port's
float32 module at a small size on the CPU."""

import numpy as np
import pytest
import torch

from bench_h100 import harness, scene
from bench_h100.reference import nerf, ops, sinerf


def test_composite_of_one_opaque_sample():
    sigma = torch.tensor([[0.0, 1e4, 0.0]])
    rgb = torch.tensor([[[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0]]])
    t = torch.tensor([[1.0, 2.0, 3.0]])
    delta = torch.ones(1, 3)
    mask = torch.tensor([[True, True, True]])
    color, depth = ops.composite(sigma, rgb, t, delta, mask, 1.0)
    assert torch.allclose(color, torch.tensor([[0.0, 1.0, 0.0]]))
    assert torch.allclose(depth, torch.tensor([2.0]))
    # every sample masked: the background alone
    color, depth = ops.composite(sigma, rgb, t, delta, ~mask, 1.0)
    assert torch.allclose(color, torch.ones(1, 3)) and depth.item() == 0


def test_compaction():
    t = torch.arange(8.0)[None].repeat(2, 1)
    dt = torch.ones(2)
    mask = torch.tensor([[0, 1, 0, 1, 1, 0, 0, 0],
                         [1, 1, 1, 1, 1, 1, 1, 1]], dtype=torch.bool)
    t_k, delta, m_k = ops.compact(t, dt, mask, 4)
    # three valid samples kept in order; eight spread to four, each for two
    assert t_k[0, :3].tolist() == [1.0, 3.0, 4.0] and m_k[0].tolist() == [
        True, True, True, False]
    assert t_k[1].tolist() == [0.0, 2.0, 4.0, 6.0]
    assert delta[0].tolist() == [1.0] * 4 and delta[1].tolist() == [2.0] * 4


def test_query_plan_of_the_default_sampler():
    # a 3-wide box at 128 cells, 512 samples of at least 5e-3: a stride of
    # 8 needs a dilation of 2 (nerfacc's default grid)
    assert ops.query_plan([-1.5] * 3 + [1.5] * 3, 128, 5e-3, 512) == (8, 2)


def test_tables_pool_one_cell():
    res = 8
    occs = torch.zeros(res ** 3)
    occs[(3 * res + 4) * res + 5] = 1.0
    occ, od = ops.tables(occs, res, 1)
    occ = occ.reshape(res, res, res)
    # dilated over the 3^3 window around it, and nowhere else
    assert occ[2:5, 3:6, 4:7].min() >= 1.0 and int((occ > 0).sum()) == 27
    assert occ[0, 0, 0] == 0
    # eroded over radius 2: one occupied cell leaves nothing
    assert od.abs().max() == 0


def test_fp8_control_rounds_to_three_mantissa_bits():
    x = torch.tensor([448.0, 1.0, 1.0625, -3.0])
    got = ops.Quant("float8")(x)
    assert got.tolist() == [448.0, 1.0, 1.0, -3.0]
    assert ops.Quant("float32")(x) is x


def test_nerf_reference_matches_the_port_module():
    from fsnerf_tpu_torch.core.models import NeRF

    cfg = harness.load_json("configs", "nerf-8x256")
    module = NeRF(d_filter=64, generator=torch.Generator().manual_seed(0))
    w = {n: p.detach() for n, p in module.named_parameters()}
    x, d = torch.rand(50, 3) * 2 - 1, torch.nn.functional.normalize(
        torch.randn(50, 3), dim=-1)
    args = {"n_layers": 8, "skip": (4,), "n_freqs": 10, "n_freqs_views": 4}
    q = ops.Quant()
    assert torch.allclose(nerf.forward(w, args, x, d, q), module(x, d),
                          atol=1e-5)
    assert torch.allclose(nerf.density(w, args, x, q), module(x)[..., 0],
                          atol=1e-5)
    assert cfg["model"]["skip"] == [4]


def test_sinerf_reference_matches_the_port_module():
    from fsnerf_tpu_torch.core.models import SiNeRF

    module = SiNeRF(width=64, generator=torch.Generator().manual_seed(1))
    w = {n: p.detach() for n, p in module.named_parameters()}
    x, d = torch.rand(50, 3) * 2 - 1, torch.nn.functional.normalize(
        torch.randn(50, 3), dim=-1)
    args = {"n_layers": 8}
    q = ops.Quant()
    assert torch.allclose(sinerf.forward(w, args, x, d, q), module(x, d),
                          atol=1e-5)


def test_pixel_rays_are_the_scene_cameras():
    c2w = torch.as_tensor(scene.pose(4.0311289, 60.0, 30.0))
    hwf = (16, 16, scene.focal(16, 0.6911112))
    o, d = scene.camera_rays(c2w, 16, hwf[2])
    po, pd = ops.pixel_rays(c2w, hwf, torch.arange(256))
    assert torch.equal(o, po) and torch.equal(d, pd)
    assert torch.allclose(d.norm(dim=-1), torch.ones(256))


def test_lattice_views_see_the_lattice():
    traffic = harness.load_json("traffic", "occgrid-train-8view")
    traffic.update(views=2, hw=32)
    v = scene.train_views(traffic, 5, "cpu")
    assert v["imgs"].shape == (2, 32, 32, 3)
    white = (v["imgs"] == 1.0).all(-1).float().mean()
    assert 0.2 < float(white) < 0.95      # background and lattice both seen
    again = scene.train_views(traffic, 5, "cpu")
    assert torch.equal(v["imgs"], again["imgs"])
    other = scene.train_views(traffic, 6, "cpu")
    assert not np.array_equal(v["poses"], other["poses"])
    # the same spread of heights for every seed, dealt in another order
    cz = lambda p: sorted(np.round(p[:, 2, 3], 4).tolist())  # noqa: E731
    assert cz(v["poses"]) == cz(other["poses"])


def test_the_lattice_is_the_ports_numpy_lattice():
    from fsnerf_tpu_torch.data.synthetic import (make_lattice_boxes,
                                                 render_lattice_image)

    c2w = scene.pose(4.0311289, 50.0, 120.0)
    hwf = (40, 40, scene.focal(40, 0.6911112))
    want, _ = render_lattice_image(c2w, hwf, make_lattice_boxes(7),
                                   white_bkgd=True)
    o, d = scene.camera_rays(torch.as_tensor(c2w), 40, hwf[2])
    got = scene.trace_lattice(o, d, torch.as_tensor(scene.lattice_boxes(7)),
                              True).reshape(40, 40, 3).numpy()
    assert np.array_equal(scene.lattice_boxes(7), make_lattice_boxes(7))
    close = np.abs(got - want).max(-1) < 1e-4
    assert close.mean() > 0.995        # a float32 tie at an edge may differ
