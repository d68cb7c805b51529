"""The CUDA kernels of fsnerf_tpu_torch/csrc against their plain PyTorch
versions, on an NVIDIA card.

Ray march (render.cu): rgb/opacity within 7e-3, depth within 3e-2, equal
executed-step counts. Forward MLP (mlp.cu): rgb within 5e-3 and sigma
within 2e-2 of max |sigma| (tests/test_pallas.py's fused-MLP tolerances),
for the three density activations and a row count that is not a multiple
of the 128-row tile; two runs bitwise equal. Train forward/backward (mlp_train.cu): rgb within
5e-3 and sigma within 2e-2 of max |sigma| (the fused-MLP tolerances of
tests/test_pallas.py), out and acts bitwise repeatable and acts within one
bf16 step (plus 1e-3 of the largest) of the plain version's, the widths
the kernels are not built for refused, every weight and bias gradient
within 2e-2 of that tensor's max |plain gradient| (the kernels sum in another order, and each
cotangent is rounded to bf16 before its products, so a rounding flip can
move a gradient by a bf16 step); gradients bitwise repeatable and bitwise
equal between the saved-activations and recompute backwards. SIREN
forward/backward (siren.cu): rgb within 5e-3 and sigma within 2e-2 of max
|sigma|; every gradient within 1e-2 of that tensor's max |plain gradient|
in each backward mode, and the two modes within 1e-2 of each other's max
(they differ by design: the saved mode's derivative factors are bf16, the
recompute's f32); each mode bitwise repeatable. SIREN ray march (render.cu):
the ray march's tolerances and equal executed-step counts. Density pass
(mlp.cu's nerf_density_kernel): sigma within 2e-2 of max |sigma| (the
ceiling of tests/test_pallas.py::test_fused_density_matches_model), two
runs bitwise equal, at each width the warp-specialized kernel takes (64,
128, 256; the NeRF march the same, over the block x chunk shapes the
renderer admits), and both refuse width 96, where a CLI run trains through
the module instead. Compositing (volrend.cu): rgb, opacity, depth, weights
and trans_final within rtol 1e-5 and atol 1e-6 (tests/test_pallas.py's
volrend tolerance) of ops/volrend.py::volume_render, taken of |want| for
the weights and trans_final and of the magnitude of the terms for the sums
over the samples (torch_parity.composite_excess: the kernel adds them in
another order, and raw sigmas let a depth cancel far below its terms); two
runs bitwise equal.

Every test here is marked `cuda` and skips without a card. This file
imports neither jax nor fsnerf_tpu, so on the card's machine (which has no
jax) it runs without the JAX conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import pytest
import torch

from fsnerf_tpu_torch.core.encoding import positional_encoding
from fsnerf_tpu_torch.ops.kernels import mlp as km
from fsnerf_tpu_torch.ops.kernels import mlp_train as mt
from fsnerf_tpu_torch.ops.kernels import render as kr
from fsnerf_tpu_torch.ops.kernels import siren as ks
from fsnerf_tpu_torch.ops.kernels import volrend as kv
from fsnerf_tpu_torch.ops.volrend import volume_render
from fsnerf_tpu_torch.utils.interop import state_dict_from_jax
from torch_parity import (composite_excess, march_inputs, mlp_inputs,
                          mse_cotangent, nerf_params_np, sinerf_params_np)

pytestmark = pytest.mark.cuda

FULL = dict(n_layers=8, skip=(4,), n_freqs=10, n_freqs_views=4)
SMALL = dict(n_layers=4, skip=(2,), n_freqs=4, n_freqs_views=2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and the CUDA toolkit")
    return torch.device("cuda")


def _check(padded, params, bR, cs, eps=1e-4):
    got, steps = kr.ray_march(*padded, params, bR, cs, eps)
    ref, steps_ref = kr.ray_march_reference(*padded, params, bR, cs, eps)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    err = (got - ref).abs().amax(dim=0).cpu()
    assert err[:4].max() < 7e-3 and err[4] < 3e-2, err
    assert torch.equal(steps, steps_ref)
    return steps


@pytest.mark.parametrize("sigma_bias", [0.0, 5000.0])
def test_kernel_matches_plain_at_full_width(cuda, sigma_bias):
    """NeRF 8x256, skip (4,), n_freqs 10/4; the saturating bias makes
    blocks exit early."""
    sd = state_dict_from_jax(nerf_params_np(2, d_filter=256, **FULL))
    sd["sigma.bias"] = sd["sigma.bias"] + sigma_bias
    padded, bR, cs = kr.pad_for_march(*march_inputs(R=300, K=48))
    padded = tuple(p.to(cuda) for p in padded)
    steps = _check(padded, kr.prep_params(sd, **FULL, device=cuda), bR, cs)
    if sigma_bias:
        assert int(steps.sum()) < steps.numel() * 48 // cs


def test_kernel_matches_plain_small_ragged_masked(cuda):
    """A narrow model, FreeNeRF masks, ReLU density, and a ray count below
    one block (block 10 x chunk 4)."""
    sd = state_dict_from_jax(nerf_params_np(5, d_filter=64, **SMALL))
    params = kr.prep_params(
        sd, **SMALL, density_activation="relu",
        pos_mask=torch.tensor([1.0, 1.0, 0.4, 0.0]),
        dir_mask=torch.tensor([1.0, 0.5]), device=cuda)
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=3, R=10, K=12))
    assert (bR, cs) == (10, 4)
    _check(tuple(p.to(cuda) for p in padded), params, bR, cs)


def test_wrapper_counts_launches_and_validates(cuda):
    sd = state_dict_from_jax(nerf_params_np(1, d_filter=64, **SMALL))
    params = kr.prep_params(sd, **SMALL, device=cuda)
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=4, R=32, K=16))
    padded = tuple(p.to(cuda) for p in padded)
    before = kr.ray_march.launches
    kr.ray_march(*padded, params, bR, cs)
    kr.ray_march_reference(*padded, params, bR, cs)
    assert kr.ray_march.launches == before + 1
    with pytest.raises(ValueError):
        kr.ray_march(*padded, params, 32, 16)       # 512 rows > the tile
    x_strided = padded[0].transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(ValueError):
        kr.ray_march(x_strided, *padded[1:], params, bR, cs)


@pytest.mark.parametrize("width", [64, 128, 256])
@pytest.mark.parametrize("sigma_bias", [0.0, 5000.0])
@pytest.mark.parametrize("K", [12, 48, 192])
@pytest.mark.parametrize("block_rows,chunk_s", [(16, 8), (8, 8), (10, 4),
                                                (16, 2), (16, 1)])
def test_nerf_march_matches_plain_over_blocks_and_chunks(
        cuda, width, sigma_bias, K, block_rows, chunk_s):
    """The warp-specialized NeRF march at each width, over the block x
    chunk shapes pad_for_march admits (chunk_s 8 becomes 4 at K 12), in a
    normal and a saturating case: the ray-march tolerances, executed steps
    equal to the plain version's, two runs bitwise equal."""
    sd = state_dict_from_jax(nerf_params_np(21, d_filter=width, **FULL))
    sd["sigma.bias"] = sd["sigma.bias"] + sigma_bias
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=K, R=45, K=K),
                                      block_rows, chunk_s)
    assert bR == block_rows and cs == (4 if K % chunk_s else chunk_s)
    padded = tuple(p.to(cuda) for p in padded)
    params = kr.prep_params(sd, **FULL, device=cuda)
    steps = _check(padded, params, bR, cs)
    again, steps_again = kr.ray_march(*padded, params, bR, cs)
    got, _ = kr.ray_march(*padded, params, bR, cs)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(steps, steps_again)
    if sigma_bias:
        assert int(steps.sum()) < steps.numel() * (K // cs)


def test_kernels_refuse_widths_they_are_not_built_for(cuda):
    """The NeRF march and the density pass take widths 64, 128 and 256."""
    sd = state_dict_from_jax(nerf_params_np(22, d_filter=96, **SMALL))
    params = kr.prep_params(sd, **SMALL, device=cuda)
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=5, R=16, K=16))
    with pytest.raises(ValueError, match="take widths"):
        kr.ray_march(*(p.to(cuda) for p in padded), params, bR, cs)
    encx, dparams = _density_case(22, 96, SMALL, 300, cuda)
    with pytest.raises(ValueError, match="take widths"):
        km.nerf_density(encx, dparams)


def test_cli_trains_at_a_width_the_kernels_refuse(cuda, capsys):
    """--d_filter 96: the MLP routes resolve to the module on the card (no
    train, density or march kernel launches), and the run trains and
    evaluates instead of raising."""
    import json

    from fsnerf_tpu_torch import cli

    launches = (mt.mlp_train_fwd.launches, km.nerf_density.launches,
                kr.ray_march.launches)
    rc = cli.main(["--dataset", "sphere", "--hw", "32", "--n_imgs", "3",
                   "--n_layers", "4", "--d_filter", "96", "--skip", "1",
                   "--grid_resolution", "16", "--n_samples", "64",
                   "--n_iters", "20", "--batch_size", "256", "--white_bkgd"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["steps"] == 20 and out["device"] != "cpu"
    assert out["psnr"] == out["psnr"] and out["rays_per_sec"] > 0
    assert (mt.mlp_train_fwd.launches, km.nerf_density.launches,
            kr.ray_march.launches) == launches


def _train_params(seed, width, arch, cuda, pos_mask=None, dir_mask=None):
    sd = {k: v.to(cuda) for k, v in state_dict_from_jax(
        nerf_params_np(seed, d_filter=width, **arch)).items()}
    lay = mt.TrainLayout(arch["n_layers"], arch["skip"], width,
                         arch["n_freqs"], arch["n_freqs_views"])
    enc = kr.enc_table(lay.n_freqs, lay.n_freqs_views, True, pos_mask,
                       dir_mask, cuda)
    return mt.pack_train_params(sd, lay, enc)


def _check_train(params, x, d, target):
    """Kernel vs plain, forward and both backward modes, with the cotangent
    of an MSE loss; returns the kernel's saved-acts gradients."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    ref, _ = mt.mlp_train_fwd_reference(x, d, params)
    dout = mse_cotangent(ref, target)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert (out[:, :3] - ref[:, :3]).abs().max() < 5e-3
    scale = ref[:, 3].abs().max() + 1e-9
    assert ((out[:, 3] - ref[:, 3]).abs().max() / scale) < 2e-2
    saved = mt.mlp_train_bwd(x, d, dout, params, acts)
    recomputed = mt.mlp_train_bwd(x, d, dout, params, None)
    plain = mt.mlp_train_bwd_reference(x, d, dout, params)
    torch.cuda.synchronize()
    for got, again, want in zip(saved, recomputed, plain):
        assert torch.equal(got, again)              # saved == recompute
        assert torch.equal(got, got.bfloat16().float())
    lay = params.layout
    for name, g, w in zip(lay.param_names,
                          lay.grads_from_packed(*saved),
                          lay.grads_from_packed(*plain)):
        err = (g - w).abs().max() / (w.abs().max() + 1e-12)
        assert err < 2e-2, (name, float(err))
    return saved


def test_train_kernels_match_plain_at_full_width(cuda):
    """NeRF 8x256, skip (4,), n_freqs 10/4 at 8,192 + 72 rows."""
    params = _train_params(6, 256, FULL, cuda)
    x, d, target = (a.to(cuda) for a in mlp_inputs(8192 + 72, seed=1))
    _check_train(params, x, d, target)


def test_train_kernels_small_ragged_masked(cuda):
    """A narrow model, FreeNeRF masks and fewer rows than one tile."""
    params = _train_params(7, 64, SMALL, cuda,
                           torch.tensor([1.0, 1.0, 0.4, 0.0]),
                           torch.tensor([1.0, 0.5]))
    x, d, target = (a.to(cuda) for a in mlp_inputs(77, seed=2))
    _check_train(params, x, d, target)


def test_train_grads_bitwise_repeatable(cuda):
    params = _train_params(8, 256, FULL, cuda)
    x, d, target = (a.to(cuda) for a in mlp_inputs(20_000, seed=3))
    dout = mse_cotangent(mt.mlp_train_fwd(x, d, params)[0], target)
    runs = []
    for _ in range(2):
        _, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
        runs.append(mt.mlp_train_bwd(x, d, dout, params, acts))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# FreeNeRF band masks mid-anneal, for the full (10 / 4 bands) and the small
# (4 / 2) encodings
_MASKS = {"full": ([1.0] * 6 + [0.5] + [0.0] * 3, [1.0, 1.0, 0.5, 0.0]),
          "small": ([1.0, 1.0, 0.4, 0.0], [1.0, 0.5])}


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 77, 128, 8192 + 72, 196_608])
@pytest.mark.parametrize("arch", ["full", "small"])
def test_train_forward_matches_plain(cuda, arch, n, masked):
    """The forward alone (the warp-specialized wgmma trunk fed by TMA) at
    NeRF 8x256 skip 4 and 4x64 skip 2: out against the plain version (rgb
    5e-3, sigma 2e-2 of max |sigma|); out bitwise equal with and without
    save_acts; out and acts bitwise repeatable; acts within bf16 rounding
    of the plain version's, one bf16 step of each value (2^-7 of it) plus
    1e-3 of the largest activation (the products sum in another order, so
    a value near a rounding boundary or ReLU's kink can land a step off,
    and later layers move by less than that)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    width, spec = (256, FULL) if arch == "full" else (64, SMALL)
    pm, dm = ((torch.tensor(m) for m in _MASKS[arch]) if masked
              else (None, None))
    params = _train_params(11, width, spec, cuda, pm, dm)
    x, d, _ = (a.to(cuda) for a in mlp_inputs(n, seed=6))
    out, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    out2, acts2 = mt.mlp_train_fwd(x, d, params, save_acts=True)
    out_only, none = mt.mlp_train_fwd(x, d, params)
    ref, ref_acts = mt.mlp_train_fwd_reference(x, d, params, save_acts=True)
    torch.cuda.synchronize()
    assert none is None
    assert acts.shape == (-(-n // mt.ROWS) * mt.ROWS, ref_acts.shape[1])
    assert torch.isfinite(out).all()
    assert torch.equal(out, out2) and torch.equal(acts, acts2)
    assert torch.equal(out, out_only)
    assert (out[:, :3] - ref[:, :3]).abs().max() < 5e-3
    scale = ref[:, 3].abs().max() + 1e-9
    assert (out[:, 3] - ref[:, 3]).abs().max() / scale < 2e-2
    got, want = acts[:n].float(), ref_acts.float()
    excess = (got - want).abs() - (want.abs() * 2.0 ** -7
                                   + 1e-3 * want.abs().max())
    assert excess.max() <= 0, float(excess.max())


def test_train_kernels_refuse_what_they_are_not_built_for(cuda):
    """Widths other than 64, 128, 256 and encodings wider than 128 raise
    before a launch, in the forward and in both backward modes."""
    for width, spec in ((96, SMALL), (32, SMALL),
                        (256, dict(FULL, n_freqs=24))):
        params = _train_params(12, width, spec, cuda)
        x, d, target = (a.to(cuda) for a in mlp_inputs(200, seed=7))
        dout = mse_cotangent(
            mt.mlp_train_fwd_reference(x, d, params)[0], target)
        acts = torch.zeros((256, spec["n_layers"] * width),
                           dtype=torch.bfloat16, device=cuda)
        before = (mt.mlp_train_fwd.launches, mt.mlp_train_bwd.launches)
        with pytest.raises(ValueError, match="train kernels take widths"):
            mt.mlp_train_fwd(x, d, params, save_acts=True)
        with pytest.raises(ValueError, match="train kernels take widths"):
            mt.mlp_train_bwd(x, d, dout, params, None)
        with pytest.raises(ValueError, match="train kernels take widths"):
            mt.mlp_train_bwd(x, d, dout, params, acts)
        assert (mt.mlp_train_fwd.launches,
                mt.mlp_train_bwd.launches) == before


@pytest.mark.parametrize("arch", ["full", "small"])
def test_recompute_backward_is_forward_then_saved(cuda, arch):
    """The recompute-mode backward runs the forward kernel into its own acts
    stream, then the saved-mode passes: its gradients are bitwise those of
    the forward followed by the saved-mode backward, and only the backward
    wrapper counts a launch."""
    width, spec = (256, FULL) if arch == "full" else (64, SMALL)
    params = _train_params(13, width, spec, cuda)
    x, d, target = (a.to(cuda) for a in mlp_inputs(3000, seed=8))
    dout = mse_cotangent(mt.mlp_train_fwd(x, d, params)[0], target)
    f0, b0 = mt.mlp_train_fwd.launches, mt.mlp_train_bwd.launches
    recomputed = mt.mlp_train_bwd(x, d, dout, params, None)
    assert (mt.mlp_train_fwd.launches, mt.mlp_train_bwd.launches) == \
        (f0, b0 + 1)
    _, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    saved = mt.mlp_train_bwd(x, d, dout, params, acts)
    torch.cuda.synchronize()
    for a, b in zip(recomputed, saved):
        assert torch.equal(a, b)


def _dw_operands(n, widths, seed, cuda):
    """Random bf16 operands acts, xs, dy [n, width] on the card."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn((n, w), generator=g).to(torch.bfloat16).to(cuda)
                 for w in widths)


def _dw_layouts():
    """(name, jobs, (acts, xs, dy) widths): the NeRF and SIREN backwards'
    weight-gradient jobs at full and narrow width, and a set of odd jobs
    (1 to 150 output columns, 8 to 200 input columns, a job wider than
    one 256-column tile) at odd offsets."""
    full = mt.TrainLayout(8, (4,), 256, 10, 4)
    small = mt.TrainLayout(4, (2,), 64, 4, 2)
    out = []
    for name, lay in (("nerf 8x256", full), ("nerf 4x64", small)):
        W, Wh = lay.width, lay.width // 2
        out.append((name, mt.dw_jobs(lay),
                    (lay.n_layers * W, lay.de + lay.dd + W + Wh,
                     lay.n_layers * W + W + Wh + 16)))
    slay = ks.SirenLayout(8, 256, ks.siren_alphas(8))
    out.append(("siren 8x256", ks.dw_jobs(slay),
                (2 * 8 * 256, 2 * ks.D_IN_PAD + 2 * 256, 8 * 256 + 512 + 16)))
    narrow, off = [], 0
    for x_src, x_col, k_in, y_col, n_out in ((0, 8, 8, 0, 1),
                                             (1, 24, 40, 8, 3),
                                             (0, 64, 200, 16, 150),
                                             (1, 0, 16, 96, 320),
                                             (0, 136, 136, 48, 8)):
        narrow.append((x_src, x_col, k_in, y_col, n_out, off))
        off += k_in * n_out
    out.append(("narrow", narrow, (272, 64, 432)))
    return out


@pytest.mark.parametrize("layout", range(4))
def test_dw_pass_matches_plain(cuda, layout):
    """The weight-gradient pass alone (wgmma fed by TMA, then the fixed-order
    reduce) against dw_pass_reference: each job within 1e-2 of its max
    (bf16 results of f32 sums taken in another order), on a row count that
    ends in a partial split; two runs bitwise equal."""
    name, jobs, widths = _dw_layouts()[layout]
    n = 2 * mt.SPLIT_ROWS + 3 * mt.ROWS
    acts, xs, dy = _dw_operands(n, widths, layout, cuda)
    got = mt.dw_pass(acts, xs, dy, jobs)
    again = mt.dw_pass(acts, xs, dy, jobs)
    want = mt.dw_pass_reference(acts, xs, dy, jobs)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert torch.equal(got, got.bfloat16().float())
    for job in jobs:
        w_off, size = job[5], job[2] * job[4]
        g, w = got[w_off:w_off + size], want[w_off:w_off + size]
        err = float((g - w).abs().max() / (w.abs().max() + 1e-12))
        assert err < 1e-2, (name, job, err)


def test_dw_pass_validates(cuda):
    jobs = mt.dw_jobs(mt.TrainLayout(4, (2,), 64, 4, 2))
    acts, xs, dy = _dw_operands(256, (256, 144, 368), 0, cuda)
    before = mt.dw_pass.launches
    mt.dw_pass(acts, xs, dy, jobs)
    assert mt.dw_pass.launches == before + 1
    with pytest.raises(ValueError):
        mt.dw_pass(acts[:200], xs[:200], dy[:200], jobs)   # not 128 rows
    with pytest.raises(ValueError):
        mt.dw_pass(acts, xs, dy.float(), jobs)
    with pytest.raises(ValueError):
        mt.dw_pass(acts, xs, dy, jobs, split_rows=100)


def test_train_kernels_match_plain_over_splits(cuda):
    """NeRF 8x256 on rows that fill two weight-gradient splits and part of
    a third: gradients within tolerance, bitwise repeatable, saved ==
    recompute."""
    params = _train_params(10, 256, FULL, cuda)
    x, d, target = (a.to(cuda) for a in
                    mlp_inputs(2 * mt.SPLIT_ROWS + 1000, seed=5))
    saved = _check_train(params, x, d, target)
    _, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    dout = mse_cotangent(mt.mlp_train_fwd_reference(x, d, params)[0],
                         target)
    again = mt.mlp_train_bwd(x, d, dout, params, acts)
    torch.cuda.synchronize()
    for a, b in zip(saved, again):
        assert torch.equal(a, b)


def test_train_wrappers_count_launches_and_validate(cuda):
    params = _train_params(9, 64, SMALL, cuda)
    x, d, target = (a.to(cuda) for a in mlp_inputs(300, seed=4))
    dout = mse_cotangent(mt.mlp_train_fwd(x, d, params)[0], target)
    f0, b0 = mt.mlp_train_fwd.launches, mt.mlp_train_bwd.launches
    _, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
    mt.mlp_train_bwd(x, d, dout, params, acts)
    mt.mlp_train_fwd_reference(x, d, params)
    assert (mt.mlp_train_fwd.launches, mt.mlp_train_bwd.launches) == \
        (f0 + 1, b0 + 1)
    x_strided = x.t().contiguous().t()
    with pytest.raises(ValueError):
        mt.mlp_train_fwd(x_strided, d, params)
    with pytest.raises(ValueError):
        mt.mlp_train_bwd(x, d.cpu(), dout, params, acts)
    with pytest.raises(ValueError):
        mt.mlp_train_bwd(x, d, dout, params, acts[:128])


def _mlp_case(seed, width, arch, n, cuda, pos_mask=None, dir_mask=None):
    """(encx, encd, params) on the card: encodings of mlp_inputs' points
    and directions, padded as make_fused_model_fn pads them."""
    sd = state_dict_from_jax(nerf_params_np(seed, d_filter=width, **arch))
    params = km.prep_params(sd, arch["n_layers"], arch["skip"], cuda)
    x, d, _ = mlp_inputs(n, seed=seed)
    ex = positional_encoding(x, arch["n_freqs"], True, pos_mask)
    ed = positional_encoding(d, arch["n_freqs_views"], True, dir_mask)
    return (km.pad_features(ex, params.d_enc_pad).to(cuda),
            km.pad_features(ed, params.d_dir_pad).to(cuda), params)


def _check_mlp(encx, encd, params, act):
    got = km.nerf_mlp(encx, encd, params, act)
    again = km.nerf_mlp(encx, encd, params, act)
    ref = km.nerf_mlp_reference(encx, encd, params, act)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert (got[:, :3] - ref[:, :3]).abs().max() < 5e-3
    scale = ref[:, 3].abs().max() + 1e-9
    assert (got[:, 3] - ref[:, 3]).abs().max() / scale < 2e-2
    if act == "relu":
        assert (got[:, 3] >= 0).all()
    if act == "trunc_exp":
        assert (got[:, 3] > 0).all()


@pytest.mark.parametrize("act", ["none", "relu", "trunc_exp"])
def test_nerf_mlp_matches_plain_at_full_width(cuda, act):
    """NeRF 8x256, skip (4,), n_freqs 10/4 at 20,000 + 37 rows."""
    _check_mlp(*_mlp_case(11, 256, FULL, 20_037, cuda), act)


@pytest.mark.parametrize("act", ["none", "relu", "trunc_exp"])
def test_nerf_mlp_small_ragged_masked(cuda, act):
    """A narrow model, FreeNeRF masks and fewer rows than one tile."""
    _check_mlp(*_mlp_case(12, 64, SMALL, 77, cuda,
                          torch.tensor([1.0, 1.0, 0.4, 0.0]),
                          torch.tensor([1.0, 0.5])), act)


def test_nerf_mlp_wrapper_counts_launches_and_validates(cuda):
    encx, encd, params = _mlp_case(13, 64, SMALL, 300, cuda)
    before = km.nerf_mlp.launches
    km.nerf_mlp(encx, encd, params)
    km.nerf_mlp_reference(encx, encd, params)
    assert km.nerf_mlp.launches == before + 1
    with pytest.raises(ValueError):
        km.nerf_mlp(encx.float(), encd, params)
    with pytest.raises(ValueError):
        km.nerf_mlp(encx, encd.cpu(), params)
    with pytest.raises(ValueError):
        km.nerf_mlp(encx.t().contiguous().t(), encd, params)


def _siren_params(seed, n_layers, width, cuda, sigma_bias=0.0):
    sd = state_dict_from_jax(sinerf_params_np(seed, n_layers, width))
    sd["sigma_layers.1.bias"] = sd["sigma_layers.1.bias"] + sigma_bias
    return ks.prep_siren_params(sd, n_layers, with_transposed=True,
                                device=cuda)


def _siren_inputs(n, seed, cuda):
    x, d, target = mlp_inputs(n, seed=seed)
    return (ks.pad_inputs(x).to(cuda), ks.pad_inputs(d).to(cuda),
            target.to(cuda))


def _rel_errs(lay, got, want):
    return {name: float((g - w).abs().max() / (w.abs().max() + 1e-12))
            for name, g, w in zip(lay.param_names,
                                  lay.grads_from_packed(*got),
                                  lay.grads_from_packed(*want))}


def _check_siren(params, x, d, target):
    """Kernels vs plain: the forward (primal and saving), both backward
    modes against their plain versions and each other, repeatability."""
    torch.backends.cuda.matmul.allow_tf32 = False
    out, acts = ks.siren_mlp_fwd(x, d, params, save_acts=True)
    primal, no_acts = ks.siren_mlp_fwd(x, d, params)
    ref, ref_acts = ks.siren_mlp_fwd_reference(x, d, params, save_acts=True)
    torch.cuda.synchronize()
    assert no_acts is None and torch.equal(out, primal)
    assert torch.isfinite(out).all()
    assert (out[:, :3] - ref[:, :3]).abs().max() < 5e-3
    scale = ref[:, 3].abs().max() + 1e-9
    assert (out[:, 3] - ref[:, 3]).abs().max() / scale < 2e-2
    dout = mse_cotangent(ref, target)
    saved = ks.siren_mlp_bwd(x, d, dout, params, acts)
    saved2 = ks.siren_mlp_bwd(x, d, dout, params, acts)
    rec = ks.siren_mlp_bwd(x, d, dout, params, None)
    rec2 = ks.siren_mlp_bwd(x, d, dout, params, None)
    plain_saved = ks.siren_mlp_bwd_reference(x, d, dout, params, ref_acts)
    plain_rec = ks.siren_mlp_bwd_reference(x, d, dout, params, None)
    torch.cuda.synchronize()
    for a, b in zip(saved + rec, saved2 + rec2):
        assert torch.equal(a, b)                    # bitwise repeatable
    assert torch.equal(saved[0], saved[0].bfloat16().float())
    lay = params.layout
    for got, want in ((saved, plain_saved), (rec, plain_rec), (saved, rec)):
        errs = _rel_errs(lay, got, want)
        worst = max(errs, key=errs.get)
        assert errs[worst] < 1e-2, (worst, errs[worst])


def test_siren_kernels_match_plain_at_full_width(cuda):
    """SiNeRF 8x256 at 8,192 + 72 rows."""
    _check_siren(_siren_params(21, 8, 256, cuda),
                 *_siren_inputs(8192 + 72, 1, cuda))


def test_siren_kernels_small_ragged(cuda):
    """A narrow SiNeRF and fewer rows than one tile."""
    _check_siren(_siren_params(22, 4, 64, cuda), *_siren_inputs(77, 2, cuda))


def test_siren_kernels_match_plain_over_splits(cuda):
    """SiNeRF 8x256 on the weight-gradient pass over two splits and part
    of a third."""
    _check_siren(_siren_params(24, 8, 256, cuda),
                 *_siren_inputs(2 * mt.SPLIT_ROWS + 1000, 5, cuda))


def test_siren_wrappers_count_launches_and_validate(cuda):
    params = _siren_params(23, 4, 64, cuda)
    x, d, target = _siren_inputs(300, 4, cuda)
    dout = mse_cotangent(ks.siren_mlp_fwd(x, d, params)[0], target)
    f0, b0 = ks.siren_mlp_fwd.launches, ks.siren_mlp_bwd.launches
    _, acts = ks.siren_mlp_fwd(x, d, params, save_acts=True)
    ks.siren_mlp_bwd(x, d, dout, params, acts)
    ks.siren_mlp_fwd_reference(x, d, params)
    assert (ks.siren_mlp_fwd.launches, ks.siren_mlp_bwd.launches) == \
        (f0 + 1, b0 + 1)
    with pytest.raises(ValueError):
        ks.siren_mlp_fwd(x.float(), d, params)
    with pytest.raises(ValueError):
        ks.siren_mlp_bwd(x, d.cpu(), dout, params, acts)
    with pytest.raises(ValueError):
        ks.siren_mlp_bwd(x, d, dout, params, acts[:128])


def _check_siren_march(padded, params, bR, cs, eps=1e-4):
    got, steps = kr.siren_ray_march(*padded, params, bR, cs, eps)
    again, _ = kr.siren_ray_march(*padded, params, bR, cs, eps)
    ref, steps_ref = kr.siren_ray_march_reference(*padded, params, bR, cs,
                                                  eps)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all() and torch.equal(got, again)
    err = (got - ref).abs().amax(dim=0).cpu()
    assert err[:4].max() < 7e-3 and err[4] < 3e-2, err
    assert torch.equal(steps, steps_ref)
    return steps


@pytest.mark.parametrize("sigma_bias", [0.0, 5000.0])
def test_siren_march_matches_plain_at_full_width(cuda, sigma_bias):
    """SiNeRF 8x256; the saturating bias makes blocks exit early."""
    params = _siren_params(24, 8, 256, cuda, sigma_bias)
    padded, bR, cs = kr.pad_for_march(*march_inputs(R=300, K=48))
    steps = _check_siren_march(tuple(p.to(cuda) for p in padded), params,
                               bR, cs)
    if sigma_bias:
        assert int(steps.sum()) < steps.numel() * 48 // cs


def test_siren_march_small_ragged_and_counted(cuda):
    """A narrow SiNeRF, a ray count below one block (block 10 x chunk 4),
    and the launch count."""
    params = _siren_params(25, 4, 64, cuda)
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=3, R=10, K=12))
    padded = tuple(p.to(cuda) for p in padded)
    before = kr.siren_ray_march.launches
    _check_siren_march(padded, params, bR, cs)
    assert kr.siren_ray_march.launches == before + 2
    with pytest.raises(ValueError):
        kr.siren_ray_march(*padded, params, 32, 16)


def _density_case(seed, width, arch, n, cuda, pos_mask=None):
    sd = {k: v.to(cuda) for k, v in state_dict_from_jax(
        nerf_params_np(seed, d_filter=width, **arch)).items()}
    params = km.prep_params(sd, arch["n_layers"], arch["skip"])
    x, _, _ = mlp_inputs(n, seed=seed)
    ex = positional_encoding(x.to(cuda), arch["n_freqs"], True, pos_mask)
    return km.pad_features(ex, params.d_enc_pad), params


@pytest.mark.parametrize("act", ["none", "relu", "trunc_exp"])
@pytest.mark.parametrize("width,arch,n", [(256, FULL, 20_037),
                                         (64, SMALL, 77)])
def test_nerf_density_matches_plain(cuda, act, width, arch, n):
    """NeRF 8x256 at 20,000 + 37 rows and a narrow model with a FreeNeRF
    mask below one tile; the weights packed on the card."""
    pm = None if width == 256 else torch.tensor([1.0, 1.0, 0.4, 0.0],
                                                device=cuda)
    encx, params = _density_case(14, width, arch, n, cuda, pm)
    assert params.wpack.device.type == "cuda"
    got = km.nerf_density(encx, params, act)
    again = km.nerf_density(encx, params, act)
    ref = km.nerf_density_reference(encx, params, act)
    torch.cuda.synchronize()
    assert got.shape == (n,) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert (got - ref).abs().max() / (ref.abs().max() + 1e-9) < 2e-2
    if act != "none":
        assert (got >= 0).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 77, 128, 20_037, 262_144])
@pytest.mark.parametrize("act", ["none", "relu", "trunc_exp"])
@pytest.mark.parametrize("width", [64, 128, 256])
def test_nerf_density_matches_plain_at_each_width(cuda, width, act, n,
                                                 masked):
    """The warp-specialized density pass at each width of NeRF 8 layers,
    skip (4,), n_freqs 10, with and without a FreeNeRF mask: within 2e-2
    of max |sigma|, two runs bitwise equal."""
    pm = (torch.tensor([1.0] * 5 + [0.4] + [0.0] * 4, device=cuda)
          if masked else None)
    encx, params = _density_case(16, width, FULL, n, cuda, pm)
    got = km.nerf_density(encx, params, act)
    again = km.nerf_density(encx, params, act)
    ref = km.nerf_density_reference(encx, params, act)
    torch.cuda.synchronize()
    assert got.shape == (n,) and torch.isfinite(got).all()
    assert torch.equal(got, again)
    assert (got - ref).abs().max() / (ref.abs().max() + 1e-9) < 2e-2
    if act != "none":
        assert (got >= 0).all()


def test_nerf_density_wrapper_counts_launches_and_validates(cuda):
    encx, params = _density_case(15, 64, SMALL, 300, cuda)
    before = km.nerf_density.launches
    km.nerf_density(encx, params)
    km.nerf_density_reference(encx, params)
    assert km.nerf_density.launches == before + 1
    with pytest.raises(ValueError):
        km.nerf_density(encx.float(), params)
    with pytest.raises(ValueError):
        km.nerf_density(encx[:, :32].contiguous(), params)


def _volrend_case(R, S, cuda, seed=0, masked=True, view4=False):
    g = torch.Generator().manual_seed(seed)
    sig = torch.randn((R, S), generator=g) * 3.0
    rgb = torch.rand((R, S, 3), generator=g)
    tv = torch.sort(torch.rand((R, S), generator=g) * 4.0 + 2.0).values
    dl = torch.rand((R, S), generator=g) * 0.1 + 1e-3
    mask = None
    if masked:
        mask = torch.rand((R, S), generator=g) > 0.3
        mask[:4] = False                        # fully masked rays
    if view4:                                   # the MLP's [R, S, 4] output
        out4 = torch.cat([rgb, sig[..., None]], dim=-1).to(cuda)
        sig, rgb = out4[..., 3], out4[..., :3]
    else:
        sig, rgb = sig.to(cuda), rgb.to(cuda)
    return (sig, rgb, tv.to(cuda), dl.to(cuda),
            None if mask is None else mask.to(cuda))


@pytest.mark.parametrize("R,S,masked,view4,bkgd", [
    (1000, 48, True, False, 1.0), (333, 192, True, True, 0.0),
    (16384, 64, False, True, 1.0), (37, 5, True, False, [0.2, 0.5, 0.9])])
def test_volrend_matches_volume_render(cuda, R, S, masked, view4, bkgd):
    """Masked and unmasked, S below / above one warp's 32 lanes and not a
    multiple of them, the MLP's output views read in place, scalar and
    vector backgrounds."""
    args = _volrend_case(R, S, cuda, masked=masked, view4=view4)
    got = kv.volume_render_fused(*args, bkgd=bkgd)
    again = kv.volume_render_fused(*args, bkgd=bkgd)
    ref = volume_render(*args, bkgd=bkgd)
    torch.cuda.synchronize()
    for k in ("rgb", "opacity", "depth", "weights", "trans_final"):
        assert got[k].shape == ref[k].shape
        assert torch.equal(got[k], again[k]), k
    excess = composite_excess(got, ref, args[1], args[2], bkgd)
    assert max(excess.values()) <= 1.0, excess


def test_volrend_wrapper_counts_launches_and_validates(cuda):
    sig, rgb, tv, dl, mask = _volrend_case(64, 16, cuda)
    before = kv.volume_render_fused.launches
    kv.volume_render_fused(sig, rgb, tv, dl, mask)
    volume_render(sig, rgb, tv, dl, mask)
    assert kv.volume_render_fused.launches == before + 1
    with pytest.raises(ValueError):
        kv.volume_render_fused(sig, rgb, tv, dl, mask.float())
    with pytest.raises(ValueError):
        kv.volume_render_fused(sig, rgb, tv.cpu(), dl, mask)
