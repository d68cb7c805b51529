"""fsnerf_tpu_torch's SiNeRF against fsnerf_tpu's: the module, the SIREN
train kernels' plain versions and autograd Function (kernels 7-8), the
SIREN ray march's plain version (kernel 2), one whole SiNeRF occgrid train
step from a shared state, and tiny CLI runs on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas.py does; the port's wrappers take their plain versions
for CPU tensors. Sizes: SiNeRF 4x64 with alphas (30, 1, 1, 1), a few
hundred rows, 48 rays x K 32 for the march. Each tolerance is stated beside
the largest difference read on the CPU. The CUDA kernels themselves are
held against these plain versions on the card by tests/test_torch_cuda.py.
"""

import contextlib
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.config import ModelConfig as JModelConfig
from fsnerf_tpu.core import losses as jlosses
from fsnerf_tpu.core.models import SiNeRF as JSiNeRF
from fsnerf_tpu.core.models import init_params
from fsnerf_tpu.data.pool import pool_from_images as jpool_from_images
from fsnerf_tpu.ops import occgrid as jog
from fsnerf_tpu.ops.pallas import siren as jsiren
from fsnerf_tpu.ops.pallas.render import \
    make_fused_siren_ray_renderer as jmake_march
from fsnerf_tpu.render import renderer as jrend
from fsnerf_tpu.train import step as jstep
from fsnerf_tpu.utils.torch_interop import export_torch_state_dict
from fsnerf_tpu_torch import cli
from fsnerf_tpu_torch.core import losses
from fsnerf_tpu_torch.core.models import SiNeRF, make_model
from fsnerf_tpu_torch.data.pool import pool_from_images
from fsnerf_tpu_torch.data.synthetic import SphereScene
from fsnerf_tpu_torch.ops import occgrid as og
from fsnerf_tpu_torch.ops.kernels import render as kr
from fsnerf_tpu_torch.ops.kernels import siren as ks
from fsnerf_tpu_torch.ops.kernels.fastmath import sincos_fast
from fsnerf_tpu_torch.render import renderer
from fsnerf_tpu_torch.train import step
from fsnerf_tpu_torch.utils.interop import (state_dict_from_jax,
                                            train_state_from_jax)
from test_torch_render import KW, _close, _grids
from test_torch_train import _both, _Draws
from torch_parity import (march_inputs, mlp_inputs, mse_cotangent,
                          shell_rays, sinerf_params_np, t)

ALPHAS = (30.0, 1.0, 1.0, 1.0)
JCFG = JModelConfig(model="sinerf", n_layers=4, d_filter=64)
_, CFG = _both(model=dict(model="sinerf", n_layers=4, d_filter=64,
                          fused_kernel=True))


def _model(seed, compute_dtype=torch.float32, **kw):
    model = SiNeRF(64, ALPHAS, compute_dtype=compute_dtype, **kw)
    model.load_state_dict(state_dict_from_jax(sinerf_params_np(seed, **{
        k: v for k, v in kw.items() if k == "use_viewdirs"})))
    return model


def _jax_padded(a: torch.Tensor, rows: int):
    """[N, 16] bf16 padded inputs -> the same values as a jnp bf16 array
    with `rows` rows (zeros past N), the JAX kernel's row blocking."""
    out = np.zeros((rows, a.shape[1]), np.float32)
    out[:a.shape[0]] = a.float().numpy()
    return jnp.asarray(out).astype(jnp.bfloat16)


@contextlib.contextmanager
def _one_thread():
    """torch's CPU ops on one thread (restored after): the float32 GEMMs'
    paths, and so their sums' order, depend on the thread count."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_matches_flax(dtype):
    """Full outputs, density-only calls and the Lambertian head.

    float32: the port and the flax module each within atol 1e-5 of the
    port's module evaluated in float64 on the same weights and inputs (the
    arbiter; read: 7.7e-7 and 7.9e-7), and of each other (read: 3.0e-7).
    Float32 sum order moves these outputs by at most ~3e-6 (random 2-ulp
    errors on every sum of the float64 evaluation), and rounding the first
    layer's bias to bf16 by 1.7e-2, so 1e-5 holds float32 arithmetic and
    catches a layer computed in another place or precision. torch runs on
    one thread. bfloat16: atol 8e-3, two bf16 steps of a value in [0.5, 1)
    (read: 3.9e-3 on rgb, where the two frameworks' bf16 sigmoid inputs
    differ by a rounding; 0 on sigma)."""
    jd, td = ((jnp.float32, torch.float32) if dtype == "float32"
              else (jnp.bfloat16, torch.bfloat16))
    atol = 1e-5 if dtype == "float32" else 8e-3
    x, d, _ = mlp_inputs(300, seed=1)
    for viewdirs in (True, False):
        params = sinerf_params_np(3, use_viewdirs=viewdirs)
        jm = JSiNeRF(width=64, alpha=ALPHAS, compute_dtype=jd,
                     use_viewdirs=viewdirs)
        model = SiNeRF(64, ALPHAS, compute_dtype=td, use_viewdirs=viewdirs)
        model.load_state_dict(state_dict_from_jax(params))
        xj, dj = jnp.asarray(x.numpy()), jnp.asarray(d.numpy())
        with torch.no_grad(), _one_thread():
            got = model(x, d).float().numpy()
            got_s = model(x).float().numpy()
        want = np.asarray(jm.apply(params, xj, dj), np.float32)
        want_s = np.asarray(jm.apply(params, xj), np.float32)
        np.testing.assert_allclose(got, want, atol=atol)
        np.testing.assert_allclose(got_s, want_s, atol=atol)
        assert got_s.shape == (300, 1) and (got_s >= 0).all()
        if dtype == "float32":
            arbiter = SiNeRF(64, ALPHAS, compute_dtype=torch.float64,
                             use_viewdirs=viewdirs)
            arbiter.load_state_dict(state_dict_from_jax(params))
            arbiter.double()
            with torch.no_grad():
                f64 = arbiter(x.double(), d.double()).numpy()
                f64_s = arbiter(x.double()).numpy()
            for name, a, b in (("port", got, f64), ("port", got_s, f64_s),
                               ("flax", want, f64), ("flax", want_s, f64_s)):
                np.testing.assert_allclose(
                    a, b, atol=atol, err_msg=f"{name} vs float64")


def test_state_dict_keys_and_init_scales():
    """The reference nn.pt keys (export_torch_state_dict's), the parameter
    order of the SIREN kernels' layout, and the SIREN init bounds."""
    jp = init_params(JSiNeRF(width=64, alpha=ALPHAS), jax.random.key(0))
    model = make_model(CFG, torch.float32, torch.Generator().manual_seed(0))
    assert set(model.state_dict()) == set(export_torch_state_dict(jp))
    assert tuple(n for n, _ in model.named_parameters()) == \
        ks.SirenLayout.from_config(CFG).param_names
    sd = model.state_dict()
    w0 = sd["first_layers.0.fc_layer.weight"]
    assert w0.abs().max() <= 1.0 / 3 + 1e-6 and w0.abs().max() > 0.8 / 3
    w1, bound = sd["first_layers.1.fc_layer.weight"], np.sqrt(6.0 / 64)
    assert w1.abs().max() <= bound + 1e-6 and w1.abs().max() > 0.8 * bound
    w_rgb = sd["rgb_layers.1.weight"]                  # torch default init
    assert w_rgb.abs().max() <= 1.0 / np.sqrt(32) + 1e-6
    again = make_model(CFG, torch.float32, torch.Generator().manual_seed(0))
    for k, v in again.state_dict().items():
        assert torch.equal(v, sd[k]), k


def _packed(seed):
    return ks.prep_siren_params(state_dict_from_jax(sinerf_params_np(seed)),
                                4, with_transposed=True)


def test_forward_matches_pallas_kernel():
    """300 rows (not a multiple of the 64-row JAX block): rgb atol 5e-3,
    sigma 2e-2 of max |sigma| (tests/test_pallas.py's fused-SIREN
    tolerances; read: 4.1e-4 / 1.1e-4 of max). Not bitwise: XLA's and
    torch's float32 matmuls sum in another order, and the a = 30 layer
    turns an ulp of y into a bf16 rounding flip of h downstream."""
    params = sinerf_params_np(7)
    x, d, _ = mlp_inputs(300, seed=1)
    xp, dp = ks.pad_inputs(x), ks.pad_inputs(d)
    prepped = jsiren.prep_siren_params(params, n_layers=4)
    fused = jsiren.make_fused_siren_mlp(4, ALPHAS, block_rows=64,
                                        interpret=True)
    ref = np.asarray(fused(tuple(jsiren._flat_siren(prepped, 4)),
                           _jax_padded(xp, 320), _jax_padded(dp, 320)))[:300]
    got, acts = ks.siren_mlp_fwd_reference(xp, dp, _packed(7),
                                           save_acts=True)
    np.testing.assert_allclose(got[:, :3].numpy(), ref[:, :3], atol=5e-3)
    scale = np.abs(ref[:, 3]).max() + 1e-9
    np.testing.assert_allclose(got[:, 3].numpy() / scale, ref[:, 3] / scale,
                               atol=2e-2)
    assert acts.shape == (300, 2 * 4 * 64) and acts.dtype == torch.bfloat16


@pytest.mark.parametrize("save_acts", [True, False])
def test_grads_match_pallas_custom_vjp(save_acts):
    """Parameter gradients of an MSE loss through the port's autograd
    Function against jax.grad through the interpret-mode custom VJP, in
    both backward modes, mapped by name: 2e-2 of each tensor's max |JAX
    gradient| (both round every cotangent to bf16 before its products and
    sum rows in another order; read: 6.8e-3)."""
    params = sinerf_params_np(2)
    x, d, target = mlp_inputs(200, seed=3)
    jfn = jsiren.make_fused_siren_model_fn(JCFG, block_rows=64,
                                           interpret=True,
                                           save_acts=save_acts)

    def jloss(p):
        out = jfn(p, jnp.asarray(x.numpy()), jnp.asarray(d.numpy()))
        return jnp.mean((out - jnp.asarray(target.numpy())) ** 2)

    jgrads = state_dict_from_jax(jax.tree.map(np.asarray,
                                              jax.grad(jloss)(params)))
    model = _model(2)
    out = ks.make_fused_siren_model_fn(CFG, save_acts=save_acts)(model, x, d)
    torch.mean((out - target) ** 2).backward()
    for name, p in model.named_parameters():
        want = jgrads[name].numpy()
        err = np.abs(p.grad.numpy() - want).max() / (np.abs(want).max()
                                                      + 1e-12)
        assert err < 2e-2, (name, err)


def test_saved_and_recompute_backwards():
    """Same primal output; weight gradients bf16-representable (the TPU
    kernels' operand dtype); the two modes' gradients within 1e-2 of each
    other's max (the saved factors are bf16, the recompute's f32; read:
    5.7e-3 at 2,000 rows of 8x256 on the CPU)."""
    params = _packed(4)
    x, d, target = mlp_inputs(150, seed=5)
    xp, dp = ks.pad_inputs(x), ks.pad_inputs(d)
    out, acts = ks.siren_mlp_fwd(xp, dp, params, save_acts=True)
    primal, none = ks.siren_mlp_fwd(xp, dp, params)
    assert none is None and torch.equal(out, primal)
    dout = mse_cotangent(out, target)
    saved = ks.siren_mlp_bwd(xp, dp, dout, params, acts)
    rec = ks.siren_mlp_bwd(xp, dp, dout, params, None)
    assert torch.equal(saved[0], saved[0].bfloat16().float())
    lay = params.layout
    for name, a, b in zip(lay.param_names, lay.grads_from_packed(*saved),
                          lay.grads_from_packed(*rec)):
        assert a.shape == dict(_model(4).named_parameters())[name].shape
        assert (a - b).abs().max() / (b.abs().max() + 1e-12) < 1e-2, name


def test_packed_layout_and_weight_gradient_plan():
    """grads_from_packed inverts the packing, and the backward's
    weight-gradient jobs tile the packed gradient without gaps or overlaps
    and read inside the scratch rows' widths."""
    sd = _model(9).state_dict()
    p = _packed(9)
    lay = p.layout
    back = lay.grads_from_packed(p.wpack.float(), p.bpack)
    for name, v in zip(lay.param_names, back):
        want = sd[name] if name.endswith("bias") else sd[name].bfloat16()
        assert torch.equal(v, want.float()), name
    full = ks.SirenLayout(8, 256, ks.siren_alphas(8))
    W, L, P = full.width, full.n_layers, ks.D_IN_PAD
    widths = {0: L * W, 1: 2 * P + 2 * W}
    off = 0
    for x_src, x_col, k_in, y_col, n_out, w_off in ks.dw_jobs(full):
        assert w_off == off
        off += k_in * n_out
        assert x_col + k_in <= widths[x_src] and x_col % 8 == 0
        assert y_col + -(-n_out // 8) * 8 <= L * W + 2 * W + 16
    assert off == full.n_w and len(ks.dw_jobs(full)) == 8 + 6
    assert p.wtpack.numel() == (3 * 64 + 64 + 2 * 32) * 64


@pytest.mark.parametrize("n_layers,width", [(4, 64), (8, 256), (4, 384),
                                            (4, 512)])
def test_bwd_views_match_the_packer(n_layers, width):
    """The warp-specialized backward row pass's tensor maps (csrc/siren.cu
    launch_bwd_rows_ws): w_s0, w_f and w_r0f as [in, out] blocks of wpack
    and wtpack as one [(L + 1) W, W] matrix of [out, in] rows hold the
    module's weights (bf16) where the producer streams them, at addresses
    and row strides TMA takes (multiples of 16 bytes). At the column-split
    widths 384 and 512 the producer reads each N = W matrix as two column
    halves of W / 2, whole 64-column boxes from column W / 2."""
    sd = state_dict_from_jax(sinerf_params_np(12, n_layers, width))
    p = ks.prep_siren_params(sd, n_layers, with_transposed=True)
    W, Wh, L, P = width, width // 2, n_layers, ks.D_IN_PAD
    assert p.layout.width == W
    if W in kr.SPLIT_WIDTHS:
        assert Wh % 64 == 0 and (2 * Wh) % 16 == 0
    s0 = P * W + (L - 1) * W * W             # past t_0 .. t_{L-1}
    f = s0 + W * Wh + Wh                     # past w_s0, w_s1
    views = {"w_s0": ("wpack", s0, W, Wh), "w_f": ("wpack", f, W, W),
             "w_r0f": ("wpack", f + W * W, W, Wh),
             "wt": ("wtpack", 0, (L + 1) * W, W)}
    packs = {"wpack": p.wpack.float(), "wtpack": p.wtpack.float()}
    blocks = {}
    for name, (pack, off, rows, cols) in views.items():
        assert (2 * off) % 16 == 0 and (2 * cols) % 16 == 0, name
        blocks[name] = packs[pack][off:off + rows * cols].reshape(rows, cols)
    assert p.wtpack.numel() == (L + 1) * W * W

    def w(name):
        return sd[f"{name}.weight"].bfloat16().float()

    assert torch.equal(blocks["w_s0"], w("sigma_layers.0.fc_layer").t())
    assert torch.equal(blocks["w_f"], w("fc_feature").t())
    assert torch.equal(blocks["w_r0f"],
                       w("rgb_layers.0.fc_layer")[:, :W].t())
    wt = blocks["wt"]
    for i in range(1, L):                    # dh_{i-1} = dy_i W_i^T
        assert torch.equal(wt[(i - 1) * W:i * W],
                           w(f"first_layers.{i}.fc_layer")), i
    # the heads' rows where the producer reads them: w_f^T at (L-1) W,
    # w_s0^T at L W, w_r0f^T at L W + Wh
    assert torch.equal(wt[(L - 1) * W:L * W], w("fc_feature"))
    assert torch.equal(wt[L * W:L * W + Wh], w("sigma_layers.0.fc_layer"))
    assert torch.equal(wt[L * W + Wh:],
                       w("rgb_layers.0.fc_layer")[:, :W])


def _quad_dot(v, w):
    """Per row, the kernels' order of a dot over the columns: thread q of
    the row's quad sums its columns 8 j + 2 q + e (j, then e) in float32,
    then two shuffles add (q0 + q1) + (q2 + q3)."""
    v, w = np.float32(v), np.float32(w)
    parts = []
    for q in range(4):
        acc = np.zeros(v.shape[0], np.float32)
        for j in range(v.shape[1] // 8):
            c = 8 * j + 2 * q
            acc = acc + (v[:, c] * w[c] + v[:, c + 1] * w[c + 1])
        parts.append(acc)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _warp_colsums(v):
    """The kernels' column sums of [N, C] float32 values over rows in CTA
    tiles of 128: each warp's 16 rows by a shuffle tree (row pairs h, then
    xor 4, 8, 16 over the quads), the 8 warps in order, then the tiles."""
    v = np.float32(v)
    n_pad = -(-v.shape[0] // 128) * 128
    vp = np.zeros((n_pad, v.shape[1]), np.float32)
    vp[:v.shape[0]] = v
    t = vp.reshape(-1, 8, 2, 8, v.shape[1])     # tile, warp, h, quad, col
    s = t[:, :, 0] + t[:, :, 1]                 # per thread: rows h = 0, 1
    for _ in range(3):                          # xor 4, 8, 16: quad ^ 1, 2, 4
        s = s[:, :, 0::2] + s[:, :, 1::2]
    s = s[:, :, 0]
    out = s[:, 0]
    for g in range(1, 8):
        out = out + s[:, g]
    return out.sum(0, dtype=np.float32)


@pytest.mark.parametrize("n_layers,width", [(4, 64), (8, 256), (4, 384),
                                            (4, 512)])
def test_fwd_views_match_the_packer(n_layers, width):
    """The warp-specialized forward's and march's trunk map (csrc/
    siren_common.cuh encode_siren_fwd_maps): wpack's first 16 + (L - 1) W
    rows as one [rows, W] matrix hold t_0 (its 3 real rows, zeros to 16)
    and t_1 .. t_{L-1} as [in, out] blocks where the producer streams them
    (t_0 in a 64-row stage of which the consumers read 16 rows, t_i from row
    16 + (i - 1) W); the view ends where w_s0, the first head map's block,
    begins; its rows and the x map's [N, 16] rows are multiples of 16
    bytes, as TMA takes them (at 384 and 512 read as two column halves of
    W / 2, whole 64-column boxes)."""
    sd = state_dict_from_jax(sinerf_params_np(13, n_layers, width))
    p = ks.prep_siren_params(sd, n_layers)
    W, L, P = width, n_layers, ks.D_IN_PAD
    rows = P + (L - 1) * W
    assert (2 * W) % 16 == 0 and (2 * P) % 16 == 0
    assert rows >= 64                   # the first stage lies in the map
    assert rows * W == P * W + (L - 1) * W * W   # w_s0 follows
    t_view = p.wpack.float()[:rows * W].reshape(rows, W)

    def w(i):
        return sd[f"first_layers.{i}.fc_layer.weight"].bfloat16().float()

    assert torch.equal(t_view[:3], w(0).t()) and not t_view[3:P].any()
    for i in range(1, L):
        assert torch.equal(t_view[P + (i - 1) * W:P + i * W], w(i).t()), i


def test_head_cotangents_in_the_kernels_order():
    """The register-level head cotangents of the warp-specialized row
    pass, in its order on the CPU: sigma_pre and the rgb logits as
    per-thread dots and quad sums, dys = (dsig_b w_s1) cos(ys) and dyr =
    (drgb_b w_r1^T) cos(yr) per element from the f32 cos factors, the bias
    partials as per-warp shuffle trees; held against
    siren_mlp_bwd_reference's intermediates (head_cotangents). sigma_pre
    and rgb within 1e-6 (read: ~1e-7; another f32 order), the sigma gate
    equal, dys bitwise, dyr within 1e-6 of its max (the reference's
    3-term product sums in its own order), the partials within 1e-5 of
    each column's sum of magnitudes."""
    params = _packed(13)
    x, d, target = mlp_inputs(300, seed=14)
    xp, dp = ks.pad_inputs(x), ks.pad_inputs(d)
    out, acts = ks.siren_mlp_fwd_reference(xp, dp, params, save_acts=True)
    dout = mse_cotangent(out, target)
    u = ks._unpacked(params)
    W = params.layout.width
    L = params.layout.n_layers
    hd = ks._heads(acts[:, (L - 1) * W:L * W].float(), dp.float(), u)
    hc = ks.head_cotangents(hd, dout, u)
    f32 = np.float32

    sp = _quad_dot(hd["s_s"].numpy(), u["ws1"][:, 0].numpy()) + \
        f32(u["bs1"].numpy()[0])
    want = hd["sigma_pre"][:, 0].numpy()
    np.testing.assert_allclose(sp, want, atol=1e-6 * np.abs(want).max())
    assert ((sp > 0) == (want > 0)).all()
    dsig = np.where(sp > 0, dout[:, 3].numpy(), f32(0))
    dsig_b = torch.tensor(dsig).bfloat16().float().numpy()
    cos_s = sincos_fast(hd["ys"], False, True)[1].numpy()
    dys = (dsig_b[:, None] * u["ws1"][:, 0].numpy()[None, :]) * cos_s
    assert np.array_equal(dys, hc["dys"].numpy())

    logits = np.stack([_quad_dot(hd["s_r"].numpy(), u["wr1"][:, c].numpy())
                       for c in range(3)], 1) + u["br1"].numpy()
    rgb = f32(1) / (f32(1) + np.exp(-logits))
    np.testing.assert_allclose(rgb, hd["rgb"].numpy(), atol=1e-6)
    drgb = (dout[:, :3].numpy() * rgb) * (f32(1) - rgb)
    drgb_b = torch.tensor(drgb).bfloat16().float().numpy()
    w1 = u["wr1"].numpy()
    cos_r = sincos_fast(hd["yr"], False, True)[1].numpy()
    p = (drgb_b[:, 0:1] * w1[:, 0] + drgb_b[:, 1:2] * w1[:, 1]) + \
        drgb_b[:, 2:3] * w1[:, 2]
    dyr = p * cos_r
    ref = hc["dyr"].numpy()
    np.testing.assert_allclose(dyr, ref, atol=1e-6 * np.abs(ref).max())

    for got_v, ref_v in ((dys, hc["dys"]), (dyr, hc["dyr"]),
                         (dsig[:, None], hc["dsig"]),
                         (drgb, hc["drgb"])):
        ref_v = ref_v.numpy()
        scale = np.abs(ref_v).sum(0) + 1e-30
        assert (np.abs(_warp_colsums(got_v) - ref_v.sum(0)) / scale
                ).max() < 1e-5


def test_wrappers_dispatch_on_device():
    """CPU tensors run the plain versions without counting a launch; a
    device that is neither CPU nor CUDA is refused."""
    params = _packed(10)
    x, d, target = mlp_inputs(40, seed=11)
    xp, dp = ks.pad_inputs(x), ks.pad_inputs(d)
    f0, b0 = ks.siren_mlp_fwd.launches, ks.siren_mlp_bwd.launches
    out, acts = ks.siren_mlp_fwd(xp, dp, params, save_acts=True)
    ks.siren_mlp_bwd(xp, dp, mse_cotangent(out, target), params, acts)
    assert (ks.siren_mlp_fwd.launches, ks.siren_mlp_bwd.launches) == (f0, b0)
    with pytest.raises(ValueError):
        ks.siren_mlp_fwd(xp.to("meta"), dp.to("meta"), params)
    with pytest.raises(ValueError):
        ks.siren_mlp_fwd(x, d, params)                 # not padded bf16


@pytest.mark.parametrize("sigma_bias", [0.0, 5000.0])
def test_siren_march_matches_pallas_kernel(sigma_bias):
    """The SIREN ray march's plain version through render_rays_occgrid
    against the interpret-mode Pallas kernel (block 16 x chunk 8), normal
    and saturating: rgb/opacity 7e-3, depth 3e-2 (tests/test_pallas.py;
    read: 2.4e-4 / 1.8e-3), n_valid exact. The saturating case executes
    fewer chunk steps."""
    params = sinerf_params_np(2)
    params["params"]["sigma_1"]["bias"] = \
        params["params"]["sigma_1"]["bias"] + np.float32(sigma_bias)
    jg, tg = _grids()
    ro, rd = shell_rays(48)
    kw = dict(KW, n_samples=64, n_compact=32)
    jf = jmake_march(params, n_layers=4, early_stop_eps=1e-4, block_rows=16,
                     chunk_s=8, interpret=True)
    ref = jrend.render_rays_occgrid(None, jnp.asarray(ro), jnp.asarray(rd),
                                    jg, fused_render_fn=jf, **kw)
    tf = kr.make_fused_siren_ray_renderer(state_dict_from_jax(params), 4)
    got = renderer.render_rays_occgrid(None, t(ro), t(rd), tg,
                                       fused_render_fn=tf, **kw)
    _close(got, ref)
    np.testing.assert_array_equal(got["n_valid"].numpy(),
                                  np.asarray(ref["n_valid"]))


def test_siren_march_saturation_exits_early():
    """A +5000 bias on the sigma head saturates the rays, so blocks exit
    early: fewer executed chunk steps than without it."""
    padded, bR, cs = kr.pad_for_march(*march_inputs(R=48, K=32))
    steps = []
    for bias in (0.0, 5000.0):
        sd = state_dict_from_jax(sinerf_params_np(2))
        sd["sigma_layers.1.bias"] = sd["sigma_layers.1.bias"] + bias
        steps.append(int(kr.siren_ray_march(
            *padded, ks.prep_siren_params(sd, 4), bR, cs)[1].sum()))
    assert steps[1] < steps[0]


@pytest.fixture
def jax_interpret_siren(monkeypatch):
    """The JAX step's fused SIREN kernels in interpret mode (64-row
    blocks), as tests/test_pallas.py runs them on the CPU."""
    monkeypatch.setattr(jsiren, "make_fused_siren_model_fn",
                        functools.partial(jsiren.make_fused_siren_model_fn,
                                          block_rows=64, interpret=True))


def test_train_step_matches_jax(jax_interpret_siren):
    """One whole SiNeRF occgrid step from the same state with the JAX
    step's draws: loss and PSNR within rel 1e-3, every parameter gradient
    within 2e-2 of its max |JAX gradient| (read: 5.8e-3), the parameters
    after Adam within 2 lr plus 1e-6 (Adam's first update moves a weight by
    +-lr whatever its gradient's size, so a gradient within rounding of
    zero may move it either way) with nearly all (read: 99.1%) within 1e-6,
    and the grid refreshed by each package's float32 SiNeRF on those
    weights: EMA values within 5e-4 (read: 1.9e-4; the a = 30 layer makes
    the densities move more with the weights Adam moved apart than the
    NeRF's, tests/test_torch_train.py), the threshold within rel 1e-3
    (read: 5.3e-4), and the binarized occupancy equal wherever the JAX EMA
    lies more than 5e-4 from the threshold (read: 2 of 4,096 cells differ,
    both within 8e-5 of it)."""
    lr = 5e-3
    jcfg, tcfg = _both(
        model=dict(model="sinerf", n_layers=4, d_filter=64,
                   fused_kernel=True),
        data=dict(dataset="sphere", white_bkgd=True),
        sampling=dict(n_samples=64, n_compact=32, grid_resolution=16,
                      render_step_size=0.05, warmup_steps=3,
                      update_interval=2),
        train=dict(n_iters=5, batch_size=64, lro=lr, dtype="float32"))
    scene = SphereScene(n_imgs=3, hw=16)
    params = sinerf_params_np(12)

    from fsnerf_tpu.core.models import make_model as jmake_model
    jmodel = jmake_model(jcfg)
    jopt = jstep.make_optimizer(jcfg)
    jpool = jpool_from_images(scene.imgs, scene.poses, scene.hwf)
    js = jstep.init_state(jmodel, jcfg, jopt, scene.aabb, jax.random.key(7))
    js = js.replace(params=jax.tree.map(jnp.asarray, params),
                    opt_state=jopt.init(jax.tree.map(jnp.asarray, params)))
    jfn = jax.jit(jstep.make_train_step(jmodel, jcfg, jopt, jpool, scene))

    model = make_model(tcfg, torch.float32)
    topt = step.make_optimizer(tcfg, model)
    template = step.init_state(model, tcfg, topt, scene.aabb)
    ts = train_state_from_jax(js, model, topt, template.grid,
                              template.generator)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf)
    tfn = step.make_train_step(model, tcfg, topt, pool, scene)

    draws = _Draws(js.key, jpool.n, 64, ts.grid, js.grid.occs.shape[1])
    _, k_batch, k_render, _ = jax.random.split(js.key, 4)
    (jl, _), jgrads = jax.value_and_grad(
        jstep.make_loss_fn(jmodel, jcfg, scene), has_aux=True)(
        js.params, jpool.sample(k_batch, 64), js.grid, k_render, js.step)
    js, jm = jfn(js)
    ts, tm = tfn(ts, draws=draws)
    np.testing.assert_allclose(float(tm["loss"]), float(jl), rtol=1e-3)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-3)
    np.testing.assert_allclose(float(tm["psnr"]), float(jm["psnr"]),
                               rtol=1e-3)
    jg = state_dict_from_jax(jax.tree.map(np.asarray, jgrads))
    after = state_dict_from_jax(jax.tree.map(np.asarray, js.params))
    close = total = 0
    for name, p in model.named_parameters():
        want = jg[name].numpy()
        err = np.abs(p.grad.numpy() - want).max() / (np.abs(want).max()
                                                      + 1e-12)
        assert err < 2e-2, (name, err)
        diff = np.abs(p.detach().numpy() - after[name].numpy())
        assert diff.max() <= 2 * lr + 1e-6, name
        close += int((diff <= 1e-6).sum())
        total += diff.size
    assert close / total > 0.98, close / total
    occ_t, occ_j = ts.grid.occs.numpy(), np.asarray(js.grid.occs)
    np.testing.assert_allclose(occ_t, occ_j, atol=5e-4)
    np.testing.assert_allclose(ts.grid.thre.item(), float(js.grid.thre),
                               rtol=1e-3)
    far = np.abs(occ_j - float(js.grid.thre)) > 5e-4
    np.testing.assert_array_equal(ts.grid.binaries.numpy()[far],
                                  np.asarray(js.grid.binaries)[far])
    assert ts.step == int(js.step) == 1


def test_resolve_fused_kernel_and_weight_reg():
    """SiNeRF takes the SIREN train kernels (view directions and, on the
    card, a width up to W_max, padded to the kernels' widths); the weight
    regularizer selects the same matrices as the JAX one (rtol 1e-5)."""
    assert step.resolve_fused_kernel(CFG, "cpu")
    auto = CFG.replace(model=dataclasses.replace(CFG.model,
                                                 fused_kernel=None))
    assert step.resolve_fused_kernel(auto, "cuda")
    assert not step.resolve_fused_kernel(auto, "cpu")
    for change in (dict(model=dataclasses.replace(CFG.model,
                                                  d_filter=30_000)),
                   dict(encoder=dataclasses.replace(CFG.encoder,
                                                    no_dirs=True))):
        assert not step.resolve_fused_kernel(CFG.replace(**change), "cuda")
    for width in (48, 320, 600, 1024, 1100, 2048):
        assert step.resolve_fused_kernel(
            CFG.replace(model=dataclasses.replace(CFG.model, d_filter=width)),
            "cuda")
    params = sinerf_params_np(5)
    model = _model(5)
    for norm in ("l1", "l2"):
        np.testing.assert_allclose(
            float(losses.weight_reg(model.named_parameters(), norm).detach()),
            float(jlosses.weight_reg(params, norm)), rtol=1e-5)


@pytest.mark.parametrize("extra", [
    ["--grid_resolution", "8", "--n_samples", "32", "--n_compact", "32",
     "--render_step_size", "0.2", "--n_iters", "12"],
    ["--grid_resolution", "8", "--n_samples", "32", "--render_step_size",
     "0.2", "--render_only"],
    ["--strategy", "hierarchical", "--n_samples", "16", "--n_fine", "16",
     "--n_iters", "6"]], ids=["train", "render_only", "hierarchical"])
def test_cli_sinerf_runs_small(capsys, extra):
    """The SiNeRF main paths end to end at a tiny size on the CPU (the
    kernels' plain versions)."""
    rc = cli.main(["--dataset", "sphere", "--device", "cpu", "--hw", "12",
                   "--n_imgs", "3", "--model", "sinerf", "--n_layers", "3",
                   "--d_filter", "32", "--batch_size", "32",
                   "--fused_kernel", "--white_bkgd", "--debug", *extra])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["device"] == "cpu" and np.isfinite(out["psnr"])
    assert 0.0 < out["ssim"] <= 1.0
