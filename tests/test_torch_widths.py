"""The kernels' packers at widths that are not the kernels' own: a NeRF
or SiNeRF of width W is packed at render.py::kernel_width(W) (also named
nerf_kernel_width: the next of 64, 128, 192, 256, 384, 512, and above 512
the next multiple of 256 from 768 up; 384 and 512 run the column-split
trunk on the card, 768 and up the streamed trunk; a NeRF of 193-256 units
whose direction encoding is wider than 128 packs at 384), with zero
units, and the plain versions run that padded pack as the kernels do.
Held here against fsnerf_tpu, whose Pallas kernels take any width
(interpret mode, as tests/test_pallas.py runs them on the CPU), with NeRF
4 layers, skip (2,), n_freqs 4/2 and SiNeRF 4 layers, 128 seeded rows;
the widths above 1024 (1100 packed at 1280, 2048) and NeRF 256 with
n_freqs_views 21 (packed at 384) against the JAX package's XLA module
path (core/models.py), NeRF 3 layers, skip (1,), n_freqs 4/2 and SiNeRF 3
layers, 256 seeded rows or 32 rays. The file takes ~2 min alone, most of
it the JAX side's interpret-mode traces.

Tolerances, the same as at the kernels' own widths: the forward MLP and
the train forward rgb within 5e-3, sigma within 2e-2 of max |sigma|; every
parameter gradient within 2e-2 of its max |JAX gradient|; the ray march
rgb / opacity within 7e-3, depth within 3e-2. Every padded entry of the
packed weight and bias gradients is exactly 0 (zero units: ReLU(0) = 0,
sin(a 0) = 0, and the next matrix reads them through zero rows). Against
the XLA module, which rounds nothing to bf16 (the NeRF's, in float32) or
rounds other values (the SiNeRF's, in bfloat16, whose sines see the same
bf16 operands as the kernels'), the forward and march tolerances hold;
each parameter's gradient is held within 0.06 of its JAX gradient's norm
(the JAX package's fused-vs-autodiff tolerance, tests/test_pallas.py, in
norm: the kernels' bf16 activations and cotangents move single entries of
a float32 NeRF module's gradients by up to ~0.12 of their max at 2048,
~0.06 at width 96). The train tests hand the module the bf16 values of
the weights the kernels take (and the SiNeRF's the bf16 points), so that
the comparison sees the kernels' other roundings only.

Also: the limits the kernels state (render.py::kernel_arch_error and
MAX_PACKED_WEIGHTS, siren.py::siren_kernel_error and SIREN_MMA_MAX_WIDTH)
against the shared-memory sizes of their CUDA sources, the routes of NeRF
and SiNeRF 300 / 512 / 600 / 1024 / 1100 / 2048 and above W_max on a cuda
device, and one CLI run at --d_filter 40 through the plain versions.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.config import EncoderConfig as JEncoderConfig
from fsnerf_tpu.config import ModelConfig as JModelConfig
from fsnerf_tpu.core.encoding import positional_encoding as jencode
from fsnerf_tpu.core.models import NeRF as JNeRF
from fsnerf_tpu.core.models import SiNeRF as JSiNeRF
from fsnerf_tpu.ops.pallas import siren as jsiren
from fsnerf_tpu.ops.pallas.mlp import fused_density, fused_nerf_mlp
from fsnerf_tpu.ops.pallas.mlp import prep_params as jprep
from fsnerf_tpu.ops.pallas.mlp_train import make_fused_train_model_fn as jtrain
from fsnerf_tpu.ops.pallas.render import make_fused_ray_renderer as jmarch
from fsnerf_tpu.ops.pallas.render import \
    make_fused_siren_ray_renderer as jsmarch
from fsnerf_tpu.render import renderer as jrend
from fsnerf_tpu_torch import cli
from fsnerf_tpu_torch.config import Config, EncoderConfig, ModelConfig
from fsnerf_tpu_torch.core.encoding import positional_encoding
from fsnerf_tpu_torch.core.models import NeRF, SiNeRF
from fsnerf_tpu_torch.ops.kernels import mlp as km
from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
from fsnerf_tpu_torch.ops.kernels import render as kr
from fsnerf_tpu_torch.ops.kernels import siren as ks
from fsnerf_tpu_torch.render import renderer
from fsnerf_tpu_torch.train import step
from fsnerf_tpu_torch.utils.interop import state_dict_from_jax
from test_torch_render import FUSED, KW, _close, _grids
from torch_parity import (mlp_inputs, mse_cotangent, nerf_params_np,
                          shell_rays, sinerf_params_np, t)

ARCH = dict(n_layers=4, skip=(2,))
ALPHAS = (30.0, 1.0, 1.0, 1.0)


def _rel(got, want):
    return np.abs(got - want).max() / (np.abs(want).max() + 1e-12)


def _close_out(got, want):
    """rgb within 5e-3, sigma within 2e-2 of max |sigma|."""
    np.testing.assert_allclose(got[:, :3], want[:, :3], atol=5e-3)
    scale = np.abs(want[:, 3]).max() + 1e-9
    np.testing.assert_allclose(got[:, 3] / scale, want[:, 3] / scale,
                               atol=2e-2)


@pytest.mark.parametrize("width,packed", [(40, 64), (96, 128), (200, 256),
                                          (300, 384), (512, 512), (700, 768),
                                          (1024, 1024)])
def test_forward_mlp_padded_matches_pallas(width, packed):
    """Kernel 3's plain version on the padded pack against the JAX fused
    forward MLP at the module's own width, 128 rows (one JAX block)."""
    params = nerf_params_np(1, d_filter=width)
    x, d, _ = mlp_inputs(128, seed=2)
    ex = np.asarray(jencode(jnp.asarray(x.numpy()), 4, True))
    ed = np.asarray(jencode(jnp.asarray(d.numpy()), 2, True))
    want = np.asarray(fused_nerf_mlp(jprep(params, **ARCH), jnp.asarray(ex),
                                     jnp.asarray(ed), block_rows=128,
                                     interpret=True))
    p = km.prep_params(state_dict_from_jax(params), **ARCH)
    assert (p.width, p.model_width) == (packed, width)
    got = km.nerf_mlp(km.pad_features(t(ex), p.d_enc_pad),
                      km.pad_features(t(ed), p.d_dir_pad), p)
    _close_out(got.numpy(), want)


def _train_cfg(width):
    return Config().replace(
        model=ModelConfig(n_layers=4, d_filter=width, skip=(2,),
                          fused_kernel=True),
        encoder=EncoderConfig(n_freqs=4, n_freqs_views=2))


@pytest.mark.parametrize("width", [40, 96, 300, 512, 700, 1024])
def test_train_mlp_padded_matches_pallas(width):
    """Kernels 5 and 6's plain versions on the padded pack through the
    autograd Function against the JAX custom VJP at the module's width: the
    forward, and each parameter's gradient of an MSE loss (in the module's
    shape: the padded units cut away); 128 rows, one JAX block."""
    params = nerf_params_np(3, d_filter=width)
    x, d, target = mlp_inputs(128, seed=4)
    jfn = jtrain(JModelConfig(n_layers=4, d_filter=width, skip=(2,)),
                 JEncoderConfig(n_freqs=4, n_freqs_views=2), block_rows=128,
                 interpret=True, save_acts=True)
    want_out, jgrads = _jax_out_and_grads(jfn, params, x, d, target)
    model = NeRF(d_filter=width, n_layers=4, skip=(2,), n_freqs=4,
                 n_freqs_views=2)
    model.load_state_dict(state_dict_from_jax(params))
    out = mt.make_fused_train_model_fn(_train_cfg(width))(model, x, d)
    _close_out(out.detach().numpy(), want_out)
    torch.mean((out - target) ** 2).backward()
    for name, p in model.named_parameters():
        assert p.grad.shape == p.shape, name
        assert _rel(p.grad.numpy(), jgrads[name].numpy()) < 2e-2, name


def _jax_out_and_grads(jfn, params, x, d, target):
    """A JAX model_fn's output at (x, d) and the parameters' gradients of
    the MSE loss against target, from one VJP (one trace of the kernels),
    the gradients as a torch state dict."""
    out, vjp = jax.vjp(lambda p: jfn(p, jnp.asarray(x.numpy()),
                                     jnp.asarray(d.numpy())), params)
    dout = 2.0 * (out - jnp.asarray(target.numpy())) / out.size
    grads = state_dict_from_jax(jax.tree.map(np.asarray, vjp(dout)[0]))
    return np.asarray(out), grads


def _padded_masks(pack_fn, sd):
    """(w, b) boolean masks of the padded entries of a pack: a state dict
    of ones packs to 1 in every real entry and 0 in every padded one."""
    w, b = pack_fn({k: torch.ones_like(v) for k, v in sd.items()})
    return w.float() == 0, b == 0


@pytest.mark.parametrize("width", [40, 96, 300, 512, 700])
def test_nerf_padded_gradients_are_exactly_zero(width):
    """Kernel 6's plain version in both modes: every padded entry of the
    packed dW and db is 0, the saved trunk activations' padded columns too,
    and the real entries are not all 0 (at 512, the packed width itself,
    only the encodings' rows are padded)."""
    lay = mt.TrainLayout.of_module(4, (2,), width, 4, 2)
    sd = state_dict_from_jax(nerf_params_np(5, d_filter=width))
    params = mt.pack_train_params(sd, lay, kr.enc_table(4, 2))
    wpad, bpad = _padded_masks(lambda s: kr.pack_weights(
        s, 4, (2,), lay.de, lay.dd, lay.width), sd)
    assert wpad.any() and (bpad.any() or lay.width == width)
    x, d, target = mlp_inputs(150, seed=6)
    out, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    W = lay.width
    for i in range(lay.n_layers):
        assert (acts[:, i * W + width:(i + 1) * W] == 0).all()
    dout = mse_cotangent(out, target)
    for a in (acts, None):
        dw, db = mt.mlp_train_bwd(x, d, dout, params, a)
        assert (dw[wpad] == 0).all() and (db[bpad] == 0).all()
        assert (dw[~wpad] != 0).any() and (db[~bpad] != 0).any()


def test_ray_march_padded_matches_pallas():
    """The ray march's plain version on the padded pack (width 96 at 128)
    through render_rays_occgrid against the interpret-mode Pallas march
    at width 96."""
    params = nerf_params_np(7, d_filter=96)
    jg, tg = _grids()
    ro, rd = shell_rays(32, seed=2)
    jf = jmarch(params, **FUSED, interpret=True)
    ref = jrend.render_rays_occgrid(None, jnp.asarray(ro), jnp.asarray(rd),
                                    jg, fused_render_fn=jf, **KW)
    tf = kr.make_fused_ray_renderer(state_dict_from_jax(params), **FUSED)
    got = renderer.render_rays_occgrid(None, t(ro), t(rd), tg,
                                       fused_render_fn=tf, **KW)
    _close(got, ref)


@pytest.mark.parametrize("width,packed", [(300, 384), (512, 512),
                                          (700, 768), (1024, 1024)])
def test_density_pass_padded_matches_pallas(width, packed):
    """Kernel 4's plain version on the padded pack against the JAX density
    pass (interpret mode) at the module's width: sigma within 2e-2 of max
    |sigma|, 128 rows (one JAX block)."""
    params = nerf_params_np(11, d_filter=width)
    x, _, _ = mlp_inputs(128, seed=12)
    ex = np.asarray(jencode(jnp.asarray(x.numpy()), 4, True))
    want = np.asarray(fused_density(jprep(params, **ARCH), jnp.asarray(ex),
                                    block_rows=128, interpret=True))
    p = km.prep_params(state_dict_from_jax(params), **ARCH)
    assert (p.width, p.model_width) == (packed, width)
    got = km.nerf_density(km.pad_features(t(ex), p.d_enc_pad), p).numpy()
    scale = np.abs(want).max() + 1e-9
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-2)


@pytest.mark.parametrize("width,sigma_bias", [(300, 0.0), (512, 0.0),
                                              (512, 30.0), (700, 0.0),
                                              (1024, 0.0)])
def test_ray_march_split_widths_match_pallas(width, sigma_bias):
    """The ray march's plain version at the packed widths 384 (width 300),
    512, 768 (width 700) and 1024 through render_rays_occgrid against the
    interpret-mode Pallas march at the module's width, at the march's
    blocking (16 rays x chunks of 8 samples: the card kernel runs each such
    128-row step as two 64-row halves but decides the skip per step, so the
    blocking is the one at every width). With a raised sigma bias most
    blocks exit early, and the plain version's exits agree with the TPU
    kernel's: rgb / opacity within 7e-3, depth within 3e-2. The split and
    streamed widths refuse a chunk_s that does not divide 64 only when a
    step has more than 64 rows."""
    params = nerf_params_np(13, d_filter=width)
    params["params"]["sigma"]["bias"] = (params["params"]["sigma"]["bias"]
                                         + np.float32(sigma_bias))
    jg, tg = _grids()
    ro, rd = shell_rays(32, seed=3)
    jf = jmarch(params, **FUSED, interpret=True)
    ref = jrend.render_rays_occgrid(None, jnp.asarray(ro), jnp.asarray(rd),
                                    jg, fused_render_fn=jf, **KW)
    sd = state_dict_from_jax(params)
    tf = kr.make_fused_ray_renderer(sd, **FUSED)
    got = renderer.render_rays_occgrid(None, t(ro), t(rd), tg,
                                       fused_render_fn=tf, **KW)
    _close(got, ref)
    rp = kr.prep_params(sd, **{k: FUSED[k] for k in (
        "n_layers", "skip", "n_freqs", "n_freqs_views")})
    assert rp.width == kr.kernel_width(width) and rp.width > 256
    assert kr.march_chunk_error(rp.width, 16, 8) is None
    assert kr.march_chunk_error(rp.width, 16, 6) is not None
    assert kr.march_chunk_error(rp.width, 8, 6) is None


@pytest.mark.parametrize("width,packed", [(40, 64), (100, 128), (300, 384),
                                          (512, 512), (700, 768)])
def test_siren_padded_matches_pallas(width, packed):
    """Kernels 7 and 8's plain versions on the padded pack through the
    autograd Function, in both backward modes, against the JAX SIREN
    kernels' custom VJP at the module's width (saved mode; 128 rows, two
    JAX blocks): the forward (rgb 5e-3, sigma 2e-2 of max) and each
    parameter's gradient (2e-2 of its max; the port's two modes differ by
    design within 1e-2, tests/test_torch_siren.py); the padded gradient
    entries and the saved activations' padded columns exactly 0 in both
    modes. 300 and 512 pack at the column-split widths 384 and 512, 700 at
    the streamed width 768."""
    params = sinerf_params_np(8, width=width)
    sd = state_dict_from_jax(params)
    packed_p = ks.prep_siren_params(sd, 4, with_transposed=True)
    assert (packed_p.layout.width, packed_p.layout.model_width) == \
        (packed, width)
    x, d, target = mlp_inputs(128, seed=9)
    jcfg = JModelConfig(model="sinerf", n_layers=4, d_filter=width)
    jfn = jsiren.make_fused_siren_model_fn(jcfg, block_rows=64,
                                           interpret=True, save_acts=True)
    want_out, jgrads = _jax_out_and_grads(jfn, params, x, d, target)
    cfg = Config().replace(model=ModelConfig(model="sinerf", n_layers=4,
                                             d_filter=width,
                                             fused_kernel=True))
    for save_acts in (True, False):
        model = SiNeRF(width, ALPHAS)
        model.load_state_dict(sd)
        out = ks.make_fused_siren_model_fn(cfg, save_acts=save_acts)(
            model, x, d)
        _close_out(out.detach().numpy(), want_out)
        torch.mean((out - target) ** 2).backward()
        for name, p in model.named_parameters():
            assert p.grad.shape == p.shape, name
            assert _rel(p.grad.numpy(), jgrads[name].numpy()) < 2e-2, \
                (save_acts, name)

    wpad, bpad = _padded_masks(lambda s: (lambda p: (p.wpack, p.bpack))(
        ks.prep_siren_params(s, 4)), sd)
    xp, dp = ks.pad_inputs(x), ks.pad_inputs(d)
    got, acts = ks.siren_mlp_fwd_reference(xp, dp, packed_p, save_acts=True)
    for i in range(4):                          # h_i: sin(a 0) = 0
        assert (acts[:, i * packed + width:(i + 1) * packed] == 0).all()
    dout = mse_cotangent(got, target)
    for a in (acts, None):
        dw, db = ks.siren_mlp_bwd(xp, dp, dout, packed_p, a)
        assert (dw[wpad] == 0).all() and (db[bpad] == 0).all()


@pytest.mark.parametrize("width,sigma_bias", [(300, 0.0), (512, 0.0),
                                              (512, 30.0), (1024, 0.0)])
def test_siren_ray_march_split_widths_match_pallas(width, sigma_bias):
    """Kernel 2's plain version at the packed widths 384 (width 300), 512
    and 1024 (the streamed width) through render_rays_occgrid against the
    interpret-mode Pallas SIREN march at the module's width, at the march's
    blocking (16 rays x chunks of 8 samples: the card kernel runs each such
    128-row step as two 64-row halves but decides the skip per step). With a raised sigma bias most
    blocks exit early, and the plain version's exits agree with the TPU
    kernel's: rgb / opacity within 7e-3, depth within 3e-2, n_valid
    exact."""
    params = sinerf_params_np(14, 4, width)
    params["params"]["sigma_1"]["bias"] = (params["params"]["sigma_1"]["bias"]
                                           + np.float32(sigma_bias))
    jg, tg = _grids()
    ro, rd = shell_rays(32, seed=4)
    jf = jsmarch(params, n_layers=4, early_stop_eps=1e-4, block_rows=16,
                 chunk_s=8, interpret=True)
    ref = jrend.render_rays_occgrid(None, jnp.asarray(ro), jnp.asarray(rd),
                                    jg, fused_render_fn=jf, **KW)
    sd = state_dict_from_jax(params)
    tf = kr.make_fused_siren_ray_renderer(sd, 4)
    got = renderer.render_rays_occgrid(None, t(ro), t(rd), tg,
                                       fused_render_fn=tf, **KW)
    _close(got, ref)
    np.testing.assert_array_equal(got["n_valid"].numpy(),
                                  np.asarray(ref["n_valid"]))
    assert ks.prep_siren_params(sd, 4).layout.width == kr.kernel_width(width)
    assert kr.stream_width(kr.kernel_width(width)) or \
        kr.kernel_width(width) in kr.SPLIT_WIDTHS


def test_stated_limits_fit_the_kernels_shared_memory():
    """What kernel_arch_error and siren_kernel_error take fits the kernels'
    shared memory (227 KB a block), and the next step past each limit
    does not: at every fixed NeRF kernel width the shells (a ring of 2
    stages) and kernel 6's row pass (64-row CTAs from 384 up, where a
    128-row one does not fit) with encodings at their limits; at width 256
    a direction encoding of 144, which packs at 384 instead (and fits
    there); at the streamed widths 768, 1024, 1280, 2048 and 4096 the
    streamed shells (the same bytes at every width, a 3-stage ring with
    both encodings 256 wide and not a 4-stage one) and the streamed row
    pass, where the 64-row pass's two activation buffers would not fit;
    the mma.sync SIREN kernels at their widest width and 32 past it; the
    warp-specialized SIREN forward, march and saved-mode row pass
    (siren.py::siren_smem_bytes) at every fixed width and those streamed
    ones with a ring of 2 stages or more (at 384 and 512 the column-split
    shapes, a 128-row row pass not fitting there; from 768 up the streamed
    ones, where the column-split shape would not fit). NeRF and SiNeRF 257
    and 300 pack at 384, 512 at 512; 513 at 768, 769 at 1024, 1025 and
    1100 at 1280, 2000 at 2048, all on the kernels. The streamed widths
    end at W_max, where the packed weights' element count reaches the
    2^31 - 1 that int32 offsets address: at 8 layers, skip 4, n_freqs
    10/4 a NeRF's is 15,872 and an 8-layer SiNeRF's 15,360; the next
    multiple of 256 is refused by name (and a width that is not a
    multiple of 256 above 512 is none the packers lay out)."""
    lim = kr.SMEM_LIMIT
    streamed = (768, 1024, 1280, 2048, 4096)
    for W in kr.NERF_KERNEL_WIDTHS + streamed:
        dd = kr.KERNEL_MAX_DIR_AT_256 if W == 256 else kr.KERNEL_MAX_ENC
        assert kr.kernel_arch_error(W, kr.KERNEL_MAX_ENC, dd) is None
        assert kr.shell_smem_bytes(W, kr.KERNEL_MAX_ENC, dd) <= lim
        assert mt.bwd_rows_smem_bytes(W, dd) <= lim
    for W in kr.SPLIT_WIDTHS + streamed:
        assert mt.bwd_rows(W) == 64
        assert mt.bwd_rows_smem_bytes(W, 32, rows=128) > lim
    for W in streamed:
        assert kr.stream_width(W) and not kr.stream_width(W + 128)
        enc = kr.KERNEL_MAX_ENC
        assert kr.shell_smem_bytes(W, enc, enc, 3) <= lim < \
            kr.shell_smem_bytes(W, enc, enc, 4)
        assert kr.shell_smem_bytes(W, 64, 32, 4) <= lim
        assert kr.shell_smem_bytes(W, enc, enc, 3) == \
            kr.shell_smem_bytes(1024, enc, enc, 3)
        assert mt.bwd_rows_smem_bytes(W, 32, rows=64) > lim
        assert mt.bwd_rows_smem_bytes(W, enc) == \
            mt.bwd_rows_smem_bytes(1024, 16)
    assert [kr.nerf_kernel_width(w) for w in (257, 300, 384, 385, 512, 513,
                                              700, 768, 769, 1024, 1025,
                                              1100, 2000, 2048, 2049)] \
        == [384, 384, 384, 512, 512, 768, 768, 768, 1024, 1024, 1280, 1280,
            2048, 2048, 2304]
    assert kr.kernel_arch_error(kr.nerf_kernel_width(1025), 64, 32) is None
    assert kr.kernel_arch_error(1056, 64, 32) is not None
    # a direction encoding over 128 at 256: refused there, packed at 384
    assert kr.kernel_arch_error(256, 64, 144) is not None
    assert kr.shell_smem_bytes(256, 256, 144) > lim
    assert mt.bwd_rows_smem_bytes(256, 144) > lim
    assert [kr.nerf_kernel_width(w, 144) for w in (192, 193, 256)] == \
        [192, 384, 384]
    assert kr.nerf_kernel_width(256, 128) == 256
    assert kr.kernel_arch_error(384, 64, 144) is None
    assert kr.shell_smem_bytes(384, 64, 144) <= lim
    assert mt.bwd_rows_smem_bytes(384, 144) <= lim
    assert kr.kernel_arch_error(320, 64, 32) is not None
    # W_max: the packed weights' int32 offsets
    nerf_nw = lambda W: mt.TrainLayout(8, (4,), W, 10, 4).n_w  # noqa: E731
    top = kr.widest_stream_width(nerf_nw)
    assert top == 15872 and top >= 4096
    assert nerf_nw(top) <= kr.MAX_PACKED_WEIGHTS < nerf_nw(top + 256)
    assert kr.kernel_arch_error(top, 64, 32, n_w=nerf_nw(top)) is None
    assert "W_max" in kr.kernel_arch_error(top + 256, 64, 32,
                                           n_w=nerf_nw(top + 256))
    assert ks.siren_max_width(8) == 15360
    assert ks.SirenLayout(8, 15360, ()).n_w <= kr.MAX_PACKED_WEIGHTS < \
        ks.SirenLayout(8, 15616, ()).n_w
    cfg = Config().replace(model=ModelConfig(d_filter=top,
                                             fused_kernel=True))
    assert step.resolve_fused_kernel(cfg, "cuda")
    cfg = Config().replace(model=ModelConfig(d_filter=top + 1,
                                             fused_kernel=True))
    line = step.report_module_route(cfg, "cuda")
    assert line is not None and f"width {top + 1} trains and renders " \
        "through the module" in line and "W_max" in line
    assert not step.resolve_fused_kernel(cfg, "cuda")
    for kernel, mma_top in ks.SIREN_MMA_MAX_WIDTH.items():
        assert ks.mma_smem_bytes(mma_top, kernel) <= lim
        assert ks.mma_smem_bytes(mma_top + 32, kernel) > lim
        assert ks.siren_kernel_error(mma_top, kernel) is None
        assert ks.siren_kernel_error(mma_top + 32, kernel) is not None
    siren_widths = kr.KERNEL_WIDTHS + kr.SPLIT_WIDTHS + streamed
    for kernel in ("forward", "march", "backward"):
        for W in siren_widths:
            assert ks.siren_kernel_error(W, kernel) is None
            assert ks.siren_smem_bytes(W, kernel) <= lim
            assert ks.siren_stages(W, kernel) >= 2
        assert ks.siren_smem_bytes(768, kernel, rows=64) > lim
        for W in (600, 1024, 1025, 2000):
            assert kr.stream_width(kr.kernel_width(W))
        assert ks.siren_kernel_error(15360, kernel) is None
        assert "W_max" in ks.siren_kernel_error(15616, kernel)
        assert ks.siren_kernel_error(1100, kernel) is not None
    for W in kr.SPLIT_WIDTHS:
        assert ks.siren_smem_bytes(W, "backward", rows=128) > lim
    assert ks.siren_smem_bytes(1024, "backward", 3) == \
        mt.bwd_rows_smem_bytes(1024, 16)
    assert [ks.siren_stages(W, "backward") for W in siren_widths] \
        == [4, 4, 4, 3, 4, 2, 3, 3, 3, 3, 3]
    assert [ks.siren_stages(W, "forward") for W in siren_widths] \
        == [4, 4, 4, 4, 4, 3, 4, 4, 4, 4, 4]
    assert [ks.siren_stages(W, "march") for W in streamed] == [4] * 5
    assert [kr.kernel_width(w) for w in (1, 40, 64, 65, 129, 192, 193, 256,
                                         257, 300, 512, 600, 1024, 1100)] \
        == [64, 64, 64, 128, 192, 192, 256, 256, 384, 384, 512, 768, 1024,
            1280]
    assert kr.nerf_kernel_width is kr.kernel_width


def test_cli_trains_at_width_40_through_the_plain_versions(capsys):
    """--d_filter 40 --fused_kernel on the CPU: the train kernels' and the
    march's plain versions at the padded width 64, end to end."""
    rc = cli.main(["--dataset", "sphere", "--device", "cpu", "--hw", "12",
                   "--n_imgs", "3", "--n_layers", "3", "--d_filter", "40",
                   "--skip", "1", "--n_freqs", "3", "--n_freqs_views", "2",
                   "--grid_resolution", "8", "--n_samples", "32",
                   "--n_compact", "32", "--render_step_size", "0.2",
                   "--n_iters", "10", "--batch_size", "32", "--fused_kernel",
                   "--white_bkgd", "--debug"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 10 and out["device"] == "cpu"
    assert np.isfinite(out["psnr"]) and 0.0 < out["ssim"] <= 1.0


@pytest.mark.parametrize("model,width,takes", [
    ("nerf", 300, True), ("nerf", 512, True), ("nerf", 600, True),
    ("nerf", 1024, True), ("nerf", 1100, True), ("nerf", 2048, True),
    ("nerf", 22_016, False), ("sinerf", 300, True), ("sinerf", 512, True),
    ("sinerf", 600, True), ("sinerf", 1024, True), ("sinerf", 1100, True),
    ("sinerf", 2048, True), ("sinerf", 20_736, False)])
def test_wide_routes_on_the_card(model, width, takes, capsys):
    """The routes on a cuda device, decided without a card: NeRF and
    SiNeRF 300 (packed 384), 512, 600 (packed 768), 1024, 1100 (packed
    1280) and 2048 resolve to the kernels and print nothing; past W_max of
    these 4-layer architectures (NeRF 21,760, SiNeRF 20,480: their packed
    weights' element count reaches the 2^31 - 1 that int32 offsets
    address) NeRF 22,016 and SiNeRF 20,736 take the module route and print
    its one line, naming the width and W_max; on the CPU nothing is
    printed."""
    if model == "nerf":
        cfg = _train_cfg(width)
        lay = mt.TrainLayout.of_module(4, (2,), width, 4, 2)
        top = kr.widest_stream_width(
            lambda W: mt.TrainLayout(4, (2,), W, 4, 2).n_w)
    else:
        cfg = Config().replace(model=ModelConfig(
            model="sinerf", n_layers=4, d_filter=width, fused_kernel=True))
        lay = ks.SirenLayout.from_config(cfg)
        top = ks.siren_max_width(4)
    assert (top, lay.n_w <= kr.MAX_PACKED_WEIGHTS) == (
        21_760 if model == "nerf" else 20_480, takes)
    assert step.kernels_take(cfg, "cuda") == takes
    assert step.resolve_fused_kernel(cfg, "cuda") == takes
    capsys.readouterr()
    line = step.report_module_route(cfg, "cuda")
    err = capsys.readouterr().err
    assert (line is None) == takes
    assert (lay.width, lay.model_width) == (kr.kernel_width(width), width)
    if takes:
        assert err == ""
        assert lay.width in kr.SPLIT_WIDTHS or kr.stream_width(lay.width)
    else:
        assert line in err and f"{model} width {width} trains and renders " \
            "through the module" in line and "W_max" in line
    assert step.kernels_refusal(cfg, "cpu") is None
    assert step.report_module_route(cfg, "cpu") is None


# -- widths above 1024, and NeRF 256 with a direction encoding over 128 ----
#
# Against the JAX package's XLA module path: NeRF 3 layers, skip (1,),
# n_freqs 4 / n_freqs_views (2, or 21 for a 129-wide encoding), in float32;
# SiNeRF 3 layers in bfloat16 (its sines see bf16 operands, as the
# kernels'). (module width, packed width, n_freqs_views)
WIDE_NERF = [(1100, 1280, 2), (2048, 2048, 2), (256, 384, 21)]
WIDE_SIREN = [(1100, 1280), (2048, 2048)]
ARCH3 = dict(n_layers=3, skip=(1,))


def _jnerf(width, nfv):
    return JNeRF(d_filter=width, n_freqs=4, n_freqs_views=nfv, **ARCH3)


def _jsiren(width, dtype=jnp.bfloat16):
    return JSiNeRF(width=width, alpha=(30.0, 1.0, 1.0), compute_dtype=dtype)


def _bf16_valued(tree):
    """float32 arrays holding the bf16 roundings of tree's values."""
    return jax.tree.map(
        lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)
                             .astype(jnp.float32)), tree)


def _norm_rel(got, want):
    return np.linalg.norm(got - want) / (np.linalg.norm(want) + 1e-12)


def _module_grads(jm, params, x, d, target):
    """The JAX module's output at (x, d) and the parameters' gradients of
    the MSE loss against target (float32), the gradients as a torch state
    dict."""
    jx, jd = jnp.asarray(x.numpy()), jnp.asarray(d.numpy())
    jt = jnp.asarray(target.numpy())
    out, vjp = jax.vjp(
        lambda p: jm.apply(p, jx, jd).astype(jnp.float32), params)
    grads = vjp(2.0 * (out - jt) / out.size)[0]
    return (np.asarray(out),
            state_dict_from_jax(jax.tree.map(np.asarray, grads)))


@pytest.mark.parametrize("width,packed,nfv", WIDE_NERF)
def test_wide_nerf_mlp_and_density_match_the_jax_module(width, packed, nfv):
    """Kernels 3 and 4's plain versions on the pack at `packed` against
    the float32 XLA module at the module's width, 256 rows: rgb within
    5e-3, sigma within 2e-2 of max |sigma| (the density pass's too)."""
    params = nerf_params_np(21, d_filter=width, n_freqs_views=nfv, **ARCH3)
    x, d, _ = mlp_inputs(256, seed=22)
    jm = _jnerf(width, nfv)
    jx, jd = jnp.asarray(x.numpy()), jnp.asarray(d.numpy())
    want = np.asarray(jm.apply(params, jx, jd))
    p = km.prep_params(state_dict_from_jax(params), **ARCH3)
    assert (p.width, p.model_width) == (packed, width)
    ex = km.pad_features(positional_encoding(x, 4, True), p.d_enc_pad)
    ed = km.pad_features(positional_encoding(d, nfv, True), p.d_dir_pad)
    _close_out(km.nerf_mlp(ex, ed, p).numpy(), want)
    sigma = km.nerf_density(ex, p).numpy()
    want_sigma = np.asarray(jm.apply(params, jx))[:, 0]
    scale = np.abs(want_sigma).max() + 1e-9
    np.testing.assert_allclose(sigma / scale, want_sigma / scale, atol=2e-2)


@pytest.mark.parametrize("width,packed,nfv", WIDE_NERF)
def test_wide_nerf_train_matches_the_jax_module(width, packed, nfv):
    """Kernels 5 and 6's plain versions on the pack at `packed` through
    the autograd Function against the float32 XLA module's autodiff at the
    module's width on the bf16 values of the weights the kernels take, 256
    rows: the forward (rgb 5e-3, sigma 2e-2 of max) and each parameter's
    gradient of an MSE loss within 0.06 of its norm (measured 0.016 at
    width 96, up to 0.054 here), in the module's shape; every padded entry
    of the packed gradients, in both modes, and of the saved activations
    exactly 0."""
    params = _bf16_valued(nerf_params_np(23, d_filter=width,
                                         n_freqs_views=nfv, **ARCH3))
    x, d, target = mlp_inputs(256, seed=24)
    want_out, jgrads = _module_grads(_jnerf(width, nfv), params, x, d,
                                     target)
    cfg = Config().replace(
        model=ModelConfig(d_filter=width, fused_kernel=True, **ARCH3),
        encoder=EncoderConfig(n_freqs=4, n_freqs_views=nfv))
    lay = mt.TrainLayout.from_config(cfg, "cpu")
    assert (lay.width, lay.model_width) == (packed, width)
    model = NeRF(d_filter=width, n_freqs=4, n_freqs_views=nfv, **ARCH3)
    sd = state_dict_from_jax(params)
    model.load_state_dict(sd)
    out = mt.make_fused_train_model_fn(cfg)(model, x, d)
    _close_out(out.detach().numpy(), want_out)
    torch.mean((out - target) ** 2).backward()
    for name, p in model.named_parameters():
        assert p.grad.shape == p.shape, name
        assert _norm_rel(p.grad.numpy(), jgrads[name].numpy()) < 0.06, name
    tp = mt.pack_train_params(sd, lay, kr.enc_table(4, nfv))
    wpad, bpad = _padded_masks(lambda s: kr.pack_weights(
        s, 3, (1,), lay.de, lay.dd, lay.width), sd)
    fo, acts = mt.mlp_train_fwd(x, d, tp, save_acts=True)
    for i in range(3):
        assert (acts[:, i * packed + width:(i + 1) * packed] == 0).all()
    for a in (acts, None):
        dw, db = mt.mlp_train_bwd(x, d, mse_cotangent(fo, target), tp, a)
        assert (dw[wpad] == 0).all() and (db[bpad] == 0).all()


@pytest.mark.parametrize("width,packed,nfv", WIDE_NERF)
def test_wide_nerf_march_matches_the_jax_module(width, packed, nfv):
    """The ray march's plain version on the pack at `packed` through
    render_rays_occgrid (32 rays, 16-ray blocks x 8-sample chunks) against
    the JAX package's render_rays_occgrid on the float32 XLA module at the
    module's width: rgb / opacity within 7e-3, depth within 3e-2."""
    params = nerf_params_np(25, d_filter=width, n_freqs_views=nfv, **ARCH3)
    jg, tg = _grids()
    ro, rd = shell_rays(32, seed=5)
    jm = _jnerf(width, nfv)
    ref = jrend.render_rays_occgrid(
        lambda xx, dd=None: jm.apply(params, xx, dd), jnp.asarray(ro),
        jnp.asarray(rd), jg, **KW)
    fused = dict(FUSED, n_freqs_views=nfv, **ARCH3)
    tf = kr.make_fused_ray_renderer(state_dict_from_jax(params), **fused)
    got = renderer.render_rays_occgrid(None, t(ro), t(rd), tg,
                                       fused_render_fn=tf, **KW)
    _close(got, ref)
    rp = kr.prep_params(state_dict_from_jax(params), n_freqs=4,
                        n_freqs_views=nfv, **ARCH3)
    assert (rp.width, rp.model_width) == (packed, width)
    assert kr.kernel_arch_error(rp.width, rp.d_enc_pad, rp.d_dir_pad,
                                n_w=rp.wpack.numel()) is None


@pytest.mark.parametrize("width,packed", WIDE_SIREN)
def test_wide_siren_matches_the_jax_module(width, packed):
    """Kernels 7 and 8's plain versions on the pack at `packed` through
    the autograd Function, in both backward modes, against the float32
    XLA SiNeRF module's autodiff at the module's width, on the bf16 values
    of the weights and points the kernels take (128 rows): the forward
    (rgb 5e-3, sigma 2e-2 of max) and each parameter's gradient of an MSE
    loss within 0.06 of its norm; the padded gradient entries exactly 0 in
    both modes."""
    params = _bf16_valued(sinerf_params_np(26, 3, width))
    sd = state_dict_from_jax(params)
    x, d, target = mlp_inputs(128, seed=27)
    x, d = x.bfloat16().float(), d.bfloat16().float()
    want_out, jgrads = _module_grads(_jsiren(width, jnp.float32), params, x,
                                     d, target)
    cfg = Config().replace(model=ModelConfig(model="sinerf", n_layers=3,
                                             d_filter=width,
                                             fused_kernel=True))
    for save_acts in (True, False):
        model = SiNeRF(width, (30.0, 1.0, 1.0))
        model.load_state_dict(sd)
        out = ks.make_fused_siren_model_fn(cfg, save_acts=save_acts)(
            model, x, d)
        _close_out(out.detach().numpy(), want_out)
        torch.mean((out - target) ** 2).backward()
        for name, p in model.named_parameters():
            assert _norm_rel(p.grad.numpy(), jgrads[name].numpy()) < 0.06, \
                (save_acts, name)
    params_p = ks.prep_siren_params(sd, 3, with_transposed=True)
    assert (params_p.layout.width, params_p.layout.model_width) == \
        (packed, width)
    wpad, bpad = _padded_masks(lambda s: (lambda p: (p.wpack, p.bpack))(
        ks.prep_siren_params(s, 3)), sd)
    xp, dp = ks.pad_inputs(x), ks.pad_inputs(d)
    got, acts = ks.siren_mlp_fwd_reference(xp, dp, params_p, save_acts=True)
    for a in (acts, None):
        dw, db = ks.siren_mlp_bwd(xp, dp, mse_cotangent(got, target),
                                  params_p, a)
        assert (dw[wpad] == 0).all() and (db[bpad] == 0).all()


@pytest.mark.parametrize("width,packed", WIDE_SIREN)
def test_wide_siren_march_matches_the_jax_module(width, packed):
    """Kernel 2's plain version on the pack at `packed` through
    render_rays_occgrid (32 rays) against the JAX package's
    render_rays_occgrid on the bfloat16 XLA SiNeRF module at the module's
    width: rgb / opacity within 7e-3, depth within 3e-2."""
    params = sinerf_params_np(28, 3, width)
    jg, tg = _grids()
    ro, rd = shell_rays(32, seed=6)
    jm = _jsiren(width)
    ref = jrend.render_rays_occgrid(
        lambda xx, dd=None: jm.apply(params, xx, dd).astype(jnp.float32),
        jnp.asarray(ro), jnp.asarray(rd), jg, **KW)
    sd = state_dict_from_jax(params)
    tf = kr.make_fused_siren_ray_renderer(sd, 3)
    got = renderer.render_rays_occgrid(None, t(ro), t(rd), tg,
                                       fused_render_fn=tf, **KW)
    _close(got, ref)
    assert ks.prep_siren_params(sd, 3).layout.width == packed
