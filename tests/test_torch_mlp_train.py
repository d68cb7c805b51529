"""The train kernels' plain versions and their autograd Function
(fsnerf_tpu_torch/ops/kernels/mlp_train.py) against fsnerf_tpu's fused
Pallas train kernels (interpret mode, as tests/test_pallas.py runs them on
the CPU), with the small NeRF of tests/torch_parity.py (4x64, skip 2,
n_freqs 4/2).

Tolerances: forward rgb 5e-3 and sigma 2e-2 of max |sigma| (the fused-MLP
tolerances of tests/test_pallas.py); parameter gradients 2e-2 of each
tensor's max |JAX gradient| (both sides round every cotangent to bf16 before
its products and sum rows in another order). The saved-activations and
recompute backwards are compared bitwise.

The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.config import EncoderConfig as JEncoderConfig
from fsnerf_tpu.config import ModelConfig as JModelConfig
from fsnerf_tpu.core.encoding import freq_mask as jfreq_mask
from fsnerf_tpu.ops.pallas.mlp_train import make_fused_train_model_fn as jmake
from fsnerf_tpu_torch.config import Config, EncoderConfig, ModelConfig
from fsnerf_tpu_torch.core.models import NeRF
from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
from fsnerf_tpu_torch.ops.kernels import render as kr
from fsnerf_tpu_torch.utils.interop import state_dict_from_jax
from torch_parity import SMALL, mlp_inputs, mse_cotangent, nerf_params_np, t

ARCH = dict(n_layers=4, d_filter=64, skip=(2,))
CFG = Config().replace(model=ModelConfig(**ARCH, fused_kernel=True),
                       encoder=EncoderConfig(n_freqs=4, n_freqs_views=2))
LAYOUT = mt.TrainLayout.from_config(CFG)


def _jax_fn(save_acts):
    return jmake(JModelConfig(**ARCH), JEncoderConfig(n_freqs=4,
                                                      n_freqs_views=2),
                 block_rows=128, interpret=True, save_acts=save_acts)


def _masks(masked):
    if not masked:
        return None, None
    return (np.asarray(jfreq_mask(4, 7, 20)), np.asarray(jfreq_mask(2, 7, 20)))


def _model(seed):
    model = NeRF(**SMALL)
    model.load_state_dict(state_dict_from_jax(nerf_params_np(seed)))
    return model


@pytest.mark.parametrize("masked", [False, True])
def test_forward_matches_pallas_kernel(masked):
    """200 rows (not a multiple of the 128-row tile), FreeNeRF masks on
    and off."""
    params = nerf_params_np(0)
    x, d, _ = mlp_inputs(200, seed=1)
    pm, dm = _masks(masked)
    ref = np.asarray(_jax_fn(False)(
        params, jnp.asarray(x.numpy()), jnp.asarray(d.numpy()),
        None if pm is None else jnp.asarray(pm),
        None if dm is None else jnp.asarray(dm)))
    fn = mt.make_fused_train_model_fn(CFG)
    with torch.no_grad():
        got = fn(_model(0), x, d, None if pm is None else t(pm),
                 None if dm is None else t(dm)).numpy()
    np.testing.assert_allclose(got[:, :3], ref[:, :3], atol=5e-3)
    scale = np.abs(ref[:, 3]).max() + 1e-9
    np.testing.assert_allclose(got[:, 3] / scale, ref[:, 3] / scale,
                               atol=2e-2)


@pytest.mark.parametrize("save_acts", [True, False])
def test_grads_match_pallas_custom_vjp(save_acts):
    """Parameter gradients of an MSE loss: the port's autograd Function vs
    the JAX custom VJP, mapped through state_dict_from_jax."""
    params = nerf_params_np(2)
    x, d, target = mlp_inputs(200, seed=3)
    jfn = _jax_fn(save_acts)

    def jloss(p):
        out = jfn(p, jnp.asarray(x.numpy()), jnp.asarray(d.numpy()))
        return jnp.mean((out - jnp.asarray(target.numpy())) ** 2)

    jgrads = state_dict_from_jax(jax.tree.map(np.asarray,
                                              jax.grad(jloss)(params)))
    model = _model(2)
    out = mt.make_fused_train_model_fn(CFG, save_acts=save_acts)(model, x, d)
    torch.mean((out - target) ** 2).backward()
    for name, p in model.named_parameters():
        want = jgrads[name].numpy()
        err = np.abs(p.grad.numpy() - want).max() / (np.abs(want).max()
                                                      + 1e-12)
        assert err < 2e-2, (name, err)


def _packed(seed, masked=False):
    pm, dm = _masks(masked)
    enc = kr.enc_table(4, 2, True, None if pm is None else t(pm),
                       None if dm is None else t(dm))
    return mt.pack_train_params(_model(seed).state_dict(), LAYOUT, enc)


@pytest.mark.parametrize("masked", [False, True])
def test_saved_acts_and_recompute_grads_bitwise(masked):
    params = _packed(4, masked)
    x, d, target = mlp_inputs(150, seed=5)
    out, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    dout = mse_cotangent(out, target)
    saved = mt.mlp_train_bwd(x, d, dout, params, acts)
    recomputed = mt.mlp_train_bwd(x, d, dout, params, None)
    for a, b in zip(saved, recomputed):
        assert torch.equal(a, b)


def test_grads_are_bf16_representable():
    """The kernels round every weight and bias gradient to bf16, as the
    TPU kernel's caller does (mlp_train.py:626); Adam sees those values."""
    model = _model(6)
    x, d, target = mlp_inputs(90, seed=7)
    out = mt.make_fused_train_model_fn(CFG)(model, x, d)
    torch.sum((out - target) ** 2).backward()
    for name, p in model.named_parameters():
        assert p.grad.shape == p.shape, name
        assert torch.equal(p.grad, p.grad.bfloat16().float()), name


def test_grads_close_to_float32_autograd():
    """The bf16 kernel gradients against autograd through the float32
    module, at the JAX package's fused-vs-autodiff tolerance (0.06 of max,
    tests/test_pallas.py)."""
    x, d, target = mlp_inputs(256, seed=8)
    fused, ref = _model(8), _model(8)
    out = mt.make_fused_train_model_fn(CFG)(fused, x, d)
    torch.mean((out - target) ** 2).backward()
    torch.mean((ref(x, d) - target) ** 2).backward()
    for (name, a), (_, b) in zip(fused.named_parameters(),
                                 ref.named_parameters()):
        err = (a.grad - b.grad).abs().max() / (b.grad.abs().max() + 1e-12)
        assert err < 0.06, (name, float(err))


def test_packed_layout_round_trips():
    """grads_from_packed inverts pack_weights: unpacking the packed weights
    themselves gives back every parameter (bf16-rounded) in the module's
    orientation."""
    sd = _model(9).state_dict()
    p = _packed(9)
    back = LAYOUT.grads_from_packed(p.wpack.float(), p.bpack)
    assert len(back) == len(LAYOUT.param_names)
    for name, v in zip(LAYOUT.param_names, back):
        assert torch.equal(v, sd[name].bfloat16().float()), name
    assert p.wpack.numel() == LAYOUT.n_w and p.bpack.numel() == LAYOUT.n_b
    # the backward reads each trunk layer's h part as [in, out] rows of
    # wpack (K-major B of its input-cotangent products)
    W = LAYOUT.width
    trunk, _, _ = kr.unpack(p.wpack.float(), p.bpack, LAYOUT.n_layers,
                            LAYOUT.skip, W, LAYOUT.de, LAYOUT.dd)
    for i in range(1, LAYOUT.n_layers):
        assert torch.equal(trunk[i][0], sd[f"layers.{i}.weight"][:, :W].t()
                           .bfloat16().float()), i


@pytest.mark.parametrize("arch", [
    dict(n_layers=4, d_filter=64, skip=(2,), n_freqs=4, n_freqs_views=2),
    dict(n_layers=8, d_filter=256, skip=(4,), n_freqs=10, n_freqs_views=4)])
def test_wpack_views_match_the_packer(arch):
    """The train forward's tensor maps view wpack as [trunk_rows, W] and
    then [W + dd, W/2] (TrainLayout.wpack_views): each matrix's rows there
    hold the module's weight transposed (bf16), its padded rows zero, the
    sigma row sigma.weight; the row blocks tile each view, and wpack ends
    with the rgb head right after the branch view."""
    sd = state_dict_from_jax(nerf_params_np(14, **arch))
    lay = mt.TrainLayout(arch["n_layers"], arch["skip"], arch["d_filter"],
                         arch["n_freqs"], arch["n_freqs_views"])
    p = mt.pack_train_params(sd, lay, kr.enc_table(lay.n_freqs,
                                                   lay.n_freqs_views))
    W, Wh = lay.width, lay.width // 2
    trunk_rows, rows = lay.wpack_views()
    flat = p.wpack.float()
    end = trunk_rows * W + (W + lay.dd) * Wh
    views = {"trunk": flat[:trunk_rows * W].reshape(trunk_rows, W),
             "branch": flat[trunk_rows * W:end].reshape(W + lay.dd, Wh)}
    want = {"sigma": sd["sigma.weight"],
            "connection": sd["connection.weight"].t(),
            "branch": sd["branch.weight"][:, :W].t(),
            "branch.dir": sd["branch.weight"][:, W:].t()}
    for i in range(lay.n_layers):
        w = sd[f"layers.{i}.weight"]
        want[f"layers.{i}"] = w[:, :W].t() if i else w.t()
        if i and (i - 1) in lay.skip:
            want[f"layers.{i}.enc"] = w[:, W:].t()
    assert set(rows) == set(want)
    spans = {"trunk": [], "branch": []}
    for name, (view, row, n) in rows.items():
        block, w = views[view][row:row + n], want[name].bfloat16().float()
        assert block.shape[0] == n and n >= w.shape[0], name
        assert torch.equal(block[:w.shape[0]], w), name
        assert not block[w.shape[0]:].any(), name
        spans[view].append((row, row + n))
    for view, size in (("trunk", trunk_rows), ("branch", W + lay.dd)):
        bounds = sorted(spans[view])
        assert bounds[0][0] == 0 and bounds[-1][1] == size, view
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:])), view
    assert torch.equal(flat[end:], sd["rgb.weight"].t().bfloat16().float()
                       .reshape(-1))
    assert flat.numel() == lay.n_w


def test_weight_gradient_plan_covers_the_packed_layout():
    """The backward's weight-gradient jobs tile the packed gradient without
    gaps or overlaps and read inside the scratch rows' widths; the plan's
    128 x 256 tiles cover each job's gradient once, the tiles of one job
    next to each other (the kernel's L2 reuse of a dY block)."""
    lay = mt.TrainLayout(8, (4,), 256, 10, 4)
    jobs = mt.dw_jobs(lay)
    W, L = lay.width, lay.n_layers
    widths = {0: L * W, 1: lay.de + lay.dd + W + W // 2}
    dy_width = L * W + W + W // 2 + 16
    off = 0
    for x_src, x_col, k_in, y_col, n_out, w_off in jobs:
        assert w_off == off
        off += k_in * n_out
        assert x_col + k_in <= widths[x_src] and x_col % 8 == 0
        assert y_col + -(-n_out // 8) * 8 <= dy_width and y_col % 8 == 0
    assert off == lay.n_w == 594_560
    assert len(jobs) == 8 + 1 + 5                 # trunk, skip half, heads
    _, tiles = mt.dw_plan(tuple(jobs), "cpu")
    tiles = tiles.tolist()
    assert len(tiles) == 24
    cover = [np.zeros((j[2], j[4]), np.int64) for j in jobs]
    for j, tm, tn in tiles:
        cover[j][tm * mt.DW_TILE_M:(tm + 1) * mt.DW_TILE_M,
                 tn * mt.DW_TILE_N:(tn + 1) * mt.DW_TILE_N] += 1
    assert all((c == 1).all() for c in cover)
    order = [j for j, _, _ in tiles]
    assert order == sorted(order)
    assert mt.SPLIT_ROWS % mt.DW_BK == 0


@pytest.mark.parametrize("split_rows", [128, 4096])
def test_dw_pass_reference_matches_the_backward(split_rows):
    """The plain weight-gradient pass over the row pass's scratch
    (bwd_operands_reference) gives mlp_train_bwd_reference's weight
    gradients: bitwise with one split, within one bf16 step of each
    gradient's max over 3 splits (the f32 sums group by split)."""
    params = _packed(12)
    x, d, target = mlp_inputs(300, seed=13)
    dout = mse_cotangent(mt.mlp_train_fwd_reference(x, d, params)[0],
                         target)
    want, _ = mt.mlp_train_bwd_reference(x, d, dout, params)
    acts, xs, dy = mt.bwd_operands_reference(x, d, dout, params)
    assert acts.shape == (300, LAYOUT.n_layers * 64)
    assert xs.shape == (300, LAYOUT.de + LAYOUT.dd + 64 + 32)
    assert dy.shape == (300, LAYOUT.n_layers * 64 + 64 + 32 + 16)
    got = mt.dw_pass_reference(acts, xs, dy, mt.dw_jobs(LAYOUT), split_rows)
    assert torch.equal(mt.dw_pass(acts, xs, dy, mt.dw_jobs(LAYOUT),
                                  split_rows), got)
    if split_rows >= 300:
        assert torch.equal(got, want)
    for name, g, w in zip(LAYOUT.param_names,
                          *(LAYOUT.grads_from_packed(v, torch.zeros(
                              LAYOUT.n_b)) for v in (got, want))):
        if name.endswith("weight"):
            assert (g - w).abs().max() <= w.abs().max() / 128, name


def test_wrappers_dispatch_on_device():
    """CPU tensors run the plain versions without counting a launch; a
    device that is neither CPU nor CUDA is refused."""
    params = _packed(10)
    x, d, target = mlp_inputs(40, seed=11)
    f0, b0 = mt.mlp_train_fwd.launches, mt.mlp_train_bwd.launches
    out, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    ref, ref_acts = mt.mlp_train_fwd_reference(x, d, params, save_acts=True)
    assert torch.equal(out, ref) and torch.equal(acts, ref_acts)
    mt.mlp_train_bwd(x, d, mse_cotangent(out, target), params, acts)
    assert (mt.mlp_train_fwd.launches, mt.mlp_train_bwd.launches) == (f0, b0)
    with pytest.raises(ValueError):
        mt.mlp_train_fwd(x.to("meta"), d.to("meta"), params)
