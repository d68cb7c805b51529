"""The forward MLP's plain version and the drop-in model_fn built on it
(fsnerf_tpu_torch/ops/kernels/mlp.py) against fsnerf_tpu's fused Pallas
forward MLP (interpret mode, as tests/test_pallas.py runs it on the CPU),
with the small NeRF of tests/torch_parity.py (4x64, skip 2, n_freqs 4/2).

Both packages get the same float32 encodings, packed weights of the same
bf16 values and the same rounding points. They are not bitwise equal:
XLA's and torch's CPU matmuls sum the f32 products in another order, so a
sigma and the logit under an rgb sigmoid can differ in the last ulp. The
largest differences read on the CPU were 6.0e-8 in rgb and 1.2e-7 of max
|sigma| (trunc_exp); the tests allow 1e-6 for both, and the JAX package's
fused-MLP tolerances (rgb 5e-3, sigma 2e-2 of max) for the model_fn against
the float32 module.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.core.encoding import freq_mask as jfreq_mask
from fsnerf_tpu.core.encoding import positional_encoding as jencode
from fsnerf_tpu.ops.pallas.mlp import fused_nerf_mlp
from fsnerf_tpu.ops.pallas.mlp import make_fused_model_fn as jmake
from fsnerf_tpu.ops.pallas.mlp import prep_params as jprep
from fsnerf_tpu_torch.core.models import NeRF
from fsnerf_tpu_torch.ops.kernels import mlp as km
from fsnerf_tpu_torch.ops.kernels import render as kr
from fsnerf_tpu_torch.utils.interop import state_dict_from_jax
from torch_parity import SMALL, mlp_inputs, nerf_params_np, t

ARCH = dict(n_layers=4, skip=(2,))
TOL = 1e-6


def _encoded(n, seed, masked):
    """The same float32 encodings for both packages (numpy)."""
    x, d, _ = mlp_inputs(n, seed=seed)
    pm = dm = None
    if masked:
        pm, dm = jfreq_mask(4, 7, 20), jfreq_mask(2, 7, 20)
    return (np.asarray(jencode(jnp.asarray(x.numpy()), 4, True, pm)),
            np.asarray(jencode(jnp.asarray(d.numpy()), 2, True, dm)))


@pytest.mark.parametrize("act", ["none", "relu", "trunc_exp"])
@pytest.mark.parametrize("masked", [False, True])
def test_plain_version_matches_pallas_kernel(act, masked):
    """300 rows (not a multiple of the 128-row block), the three density
    activations, FreeNeRF masks on and off."""
    params = nerf_params_np(0)
    ex, ed = _encoded(300, 1, masked)
    want = np.asarray(fused_nerf_mlp(jprep(params, **ARCH), jnp.asarray(ex),
                                     jnp.asarray(ed), density_activation=act,
                                     block_rows=128, interpret=True))
    p = km.prep_params(state_dict_from_jax(params), **ARCH)
    got = km.nerf_mlp(km.pad_features(t(ex), p.d_enc_pad),
                      km.pad_features(t(ed), p.d_dir_pad), p, act).numpy()
    assert got.shape == (300, 4)
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=TOL, rtol=0)
    scale = np.abs(want[:, 3]).max()
    np.testing.assert_allclose(got[:, 3] / scale, want[:, 3] / scale,
                               atol=TOL, rtol=0)


def test_model_fn_matches_pallas_model_fn():
    """make_fused_model_fn of both packages on [R, S, 3] points and
    directions, with FreeNeRF masks; and against the port's float32
    module at the JAX package's fused-MLP tolerances."""
    params = nerf_params_np(3)
    x, d, _ = mlp_inputs(4 * 48, seed=2)
    x, d = x.reshape(4, 48, 3), d.reshape(4, 48, 3)
    pm, dm = np.asarray(jfreq_mask(4, 9, 20)), np.asarray(jfreq_mask(2, 9, 20))
    jf = jmake(params, **ARCH, n_freqs=4, n_freqs_views=2, interpret=True,
               pos_mask=jnp.asarray(pm), dir_mask=jnp.asarray(dm))
    want = np.asarray(jf(jnp.asarray(x.numpy()), jnp.asarray(d.numpy())))
    sd = state_dict_from_jax(params)
    tf = km.make_fused_model_fn(sd, **ARCH, n_freqs=4, n_freqs_views=2,
                                pos_mask=t(pm), dir_mask=t(dm))
    got = tf(x, d).numpy()
    assert got.shape == (4, 48, 4)
    np.testing.assert_allclose(got[..., :3], want[..., :3], atol=TOL,
                               rtol=0)
    scale = np.abs(want[..., 3]).max()
    np.testing.assert_allclose(got[..., 3] / scale, want[..., 3] / scale,
                               atol=TOL, rtol=0)
    model = NeRF(**SMALL)
    model.load_state_dict(sd)
    with torch.no_grad():
        ref = model(x, d, pos_mask=t(pm), dir_mask=t(dm)).numpy()
    np.testing.assert_allclose(got[..., :3], ref[..., :3], atol=5e-3)
    np.testing.assert_allclose(got[..., 3] / np.abs(ref[..., 3]).max(),
                               ref[..., 3] / np.abs(ref[..., 3]).max(),
                               atol=2e-2)
    with pytest.raises(ValueError):
        tf(x)                                   # rgb needs the directions


def test_packing_pads_as_the_pallas_kernel():
    """The encodings pad to round_up(d_enc, 64) / round_up(d_dir, 32), as
    mlp.py::prep_params pads them (64 / 32 at both widths here), and the
    padded weight rows are zero."""
    for n_freqs, n_views, de, dd in ((10, 4, 64, 32), (4, 2, 64, 32)):
        params = nerf_params_np(4, n_freqs=n_freqs, n_freqs_views=n_views)
        p = km.prep_params(state_dict_from_jax(params), **ARCH)
        jp = jprep(params, **ARCH)
        assert (p.d_enc_pad, p.d_dir_pad) == (jp["d_enc_pad"],
                                              jp["d_dir_pad"]) == (de, dd)
        w0 = p.wpack[:de * 64].reshape(de, 64).float()
        np.testing.assert_array_equal(
            w0.numpy(), np.asarray(jp["trunk_w"][0], np.float32))


@pytest.mark.parametrize("arch", [
    dict(n_layers=4, d_filter=64, skip=(2,), n_freqs=4, n_freqs_views=2),
    dict(n_layers=8, d_filter=256, skip=(4,), n_freqs=10, n_freqs_views=4)])
def test_kernel_views_match_the_packer(arch):
    """The forward MLP kernel's tensor maps (csrc/mlp.cu launch_mlp_w)
    view prep_params' wpack as [trunk_rows, W] (each trunk matrix, w_sigma,
    w_conn) and then [W + d_dir_pad, W/2] (w_branch_h, w_branch_d): each
    matrix's rows there hold the module's weight transposed (bf16), its
    padded rows zero, and the rgb head follows the branch view; the
    encodings' maps take [N, d_enc_pad] / [N, d_dir_pad] rows whose widths
    the kernel admits (a multiple of 64 / of 16, both up to
    KERNEL_MAX_ENC)."""
    sd = state_dict_from_jax(nerf_params_np(15, **arch))
    L, skip, W = arch["n_layers"], arch["skip"], arch["d_filter"]
    p = km.prep_params(sd, L, skip)
    de, dd, Wh = p.d_enc_pad, p.d_dir_pad, W // 2
    assert de % 64 == 0 and dd % 16 == 0 and max(de, dd) <= kr.KERNEL_MAX_ENC
    assert kr.kernel_arch_error(W, de, dd) is None
    rows = kr.trunk_rows(L, skip, W, de)
    flat = p.wpack.float()
    trunk = flat[:rows * W].reshape(rows, W)
    end = rows * W + (W + dd) * Wh
    branch = flat[rows * W:end].reshape(W + dd, Wh)

    def check(block, want):
        want = want.bfloat16().float()
        assert block.shape[0] >= want.shape[0]
        assert torch.equal(block[:want.shape[0]], want)
        assert not block[want.shape[0]:].any()

    r = 0
    for i in range(L):
        w = sd[f"layers.{i}.weight"]
        n = de if i == 0 else W
        check(trunk[r:r + n], w.t() if i == 0 else w[:, :W].t())
        r += n
        if i and (i - 1) in skip:
            check(trunk[r:r + de], w[:, W:].t())
            r += de
    check(trunk[r:r + 1], sd["sigma.weight"])
    check(trunk[r + 1:], sd["connection.weight"].t())
    assert r + 1 + W == rows
    check(branch[:W], sd["branch.weight"][:, :W].t())
    check(branch[W:], sd["branch.weight"][:, W:].t())
    assert torch.equal(flat[end:], sd["rgb.weight"].t().bfloat16().float()
                       .reshape(-1))


def test_wrapper_dispatches_on_device():
    """CPU tensors run the plain version without counting a launch; a
    device that is neither CPU nor CUDA and a wrongly padded input are
    refused."""
    p = km.prep_params(state_dict_from_jax(nerf_params_np(5)), **ARCH)
    ex, ed = _encoded(40, 6, False)
    encx, encd = km.pad_features(t(ex), 64), km.pad_features(t(ed), 32)
    before = km.nerf_mlp.launches
    got = km.nerf_mlp(encx, encd, p)
    assert torch.equal(got, km.nerf_mlp_reference(encx, encd, p))
    assert km.nerf_mlp.launches == before
    with pytest.raises(ValueError):
        km.nerf_mlp(encx.to("meta"), encd.to("meta"), p)
    with pytest.raises(ValueError):
        km.nerf_mlp(encx[:, :48], encd, p)
    with pytest.raises(ValueError):
        km.nerf_mlp(encx, encd, p, "softplus")
