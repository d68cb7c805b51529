"""The CUDA kernels of fsnerf_tpu_torch/csrc against their plain PyTorch
versions, on an NVIDIA card.

Ray march (render.cu): rgb/opacity within 7e-3, depth within 3e-2, equal
executed-step counts. Forward MLP (mlp.cu): rgb within 5e-3 and sigma
within 2e-2 of max |sigma| (tests/test_pallas.py's fused-MLP tolerances),
for the three density activations, row counts that are not a multiple of
the 128-row tile and each width the warp-specialized kernel is built for
(64, 128, 192, 256, 384 and 512 on the column-split trunk, 768, 1024,
1280 and 2048 on the streamed trunk, which takes every multiple of 256
from 768 up to W_max; every width is packed at the next of them with zero
units, a pack at 1120 refused by name); two runs bitwise equal. Train
forward/backward (mlp_train.cu): rgb within 5e-3 and sigma within 2e-2 of
max |sigma| (the fused-MLP tolerances of tests/test_pallas.py), out and
acts bitwise repeatable and acts within one bf16 step (plus 1e-3 of the
largest) of the plain version's, a pack at 1120 and encodings over 256
refused, every weight and bias gradient within 2e-2 of
that tensor's max |plain gradient| (the kernels sum in another order, and
each cotangent is rounded to bf16 before its products, so a rounding flip can
move a gradient by a bf16 step); gradients bitwise repeatable and bitwise
equal between the saved-activations and recompute backwards. SIREN
forward/backward (siren.cu): rgb within 5e-3 and sigma within 2e-2 of max
|sigma|; every gradient within 1e-2 of that tensor's max |plain gradient|
in each backward mode, and the two modes within 1e-2 of each other's max
(they differ by design: the saved mode's derivative factors are bf16, the
recompute's f32); each mode bitwise repeatable; the saved mode's
warp-specialized row pass at widths 64, 128, 192 and 256 (fed the
warp-specialized forward's acts), recompute mode on the mma.sync row pass,
which refuses a packed width above 256 other than 384 and 512 by name (its
shared memory). The warp-specialized SIREN forward at widths 64, 128, 192
and 256 also holds its acts stream to the plain version's (h_i within
3e-2, factors within 0.25, each on at most 2% of the elements), bitwise
repeatable; a pack at 320 runs the mma.sync forward, a pack at 1120 is
refused by name. SIREN ray march (render.cu): the ray march's tolerances
and equal executed-step counts, bitwise repeatable, at widths 64, 128, 192
and 256 (the warp-specialized march) and a pack at 320 (the mma.sync one).
Kernels 7, 8 and 2 at the column-split widths (SiNeRF 300, packed 384, and
512): the tolerances above, recompute mode bitwise equal to saved mode
(there it runs the forward kernel, then the saved passes), the acts stream
as at the other widths (at 8 layers x 512 on at most 4% of the elements),
the march over blockings of 64 and 128 rows a step; the same at the
streamed widths (SiNeRF 700, packed 768, 1024, 1100, packed 1280, and
2048; at 8 layers on at most 12% of the acts stream's elements). Kernels
1-8 at widths that are not their own (NeRF 40, 96, 200, 300, 400, 512,
700, 1000, 1024, 1100; 256 with a 129-wide direction encoding, packed at
384; SiNeRF 40, 100, 300) and with encodings up to 256 wide, the packed
gradients' padded entries exactly 0; the NeRF train kernels' gradients
bitwise repeatable at 512, 768, 1024, 1280 and 2048 too (recompute
bitwise saved). Density pass
(mlp.cu's nerf_density_kernel): sigma within 2e-2 of max |sigma| (the
ceiling of tests/test_pallas.py::test_fused_density_matches_model), two
runs bitwise equal, at each width the warp-specialized kernel is built for
(64, 128, 192, 256, 384, 512, 768, 1024, 1280, 2048; the NeRF march the
same, over the block x chunk shapes the renderer admits), and both refuse
a pack at 1120; a CLI run at an encoding the kernels refuse trains
through the module instead and prints so. Compositing
(volrend.cu): rgb,
opacity, depth, weights and trans_final within rtol 1e-5 and atol 1e-6
(tests/test_pallas.py's volrend tolerance) of ops/volrend.py::
volume_render, taken of |want| for
the weights and trans_final and of the magnitude of the terms for the sums
over the samples (torch_parity.composite_excess: the kernel adds them in
another order, and raw sigmas let a depth cancel far below its terms); two
runs bitwise equal.

Graphed training (train/step.py::make_train_chunk): train() from CUDA-graph
replays against the same run by eager steps, bitwise (weights, Adam's
moments, every grid tensor, the generator, the logged metrics and the
kernels' launch counts), for the NeRF occgrid path, SiNeRF, the
hierarchical path, width 320 (the column-split kernels at 384), width 600
(the streamed kernels at 768), an encoding the kernels refuse, the few-shot
recipe with
its validations and a resume from a checkpoint, and train_scanned; a
ladder change that captures a new rung's graphs, and a capture that fails
raising.

The data slice: the image decoder built with g++ on the card's machine
reading the PNG writer's files exactly and tests/data/jpeg/'s JPEGs to the
pixels libjpeg-turbo gives; kernels 1 and 4 on an LLFF scene's
NDC samples and a 4-level grid against their plain versions (the
tolerances above); 40 graphed LLFF steps bitwise equal to the eager ones.

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


@pytest.mark.parametrize("width", [64, 128, 192, 256, 384, 512, 768, 1024,
                                   1280, 2048])
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


def _packed_at(params, sd, arch, width):
    """RayMarchParams or MlpParams repacked at `width` (no packer's)."""
    import dataclasses

    wpack, bpack = kr.pack_weights(
        {k: v.to(params.wpack.device) for k, v in sd.items()},
        arch["n_layers"], arch["skip"], params.d_enc_pad, params.d_dir_pad,
        width)
    return dataclasses.replace(params, wpack=wpack, bpack=bpack,
                               width=width)


def test_kernels_refuse_widths_they_are_not_built_for(cuda):
    """The NeRF march and the density pass take every width (packed at 64,
    128, 192, 256, 384, 512 or a multiple of 256 from 768 up to W_max:
    1100 packs at 1280) and refuse a pack at 1120, which is none of those,
    by name, launching nothing; at 512 and 1024 the march refuses a chunk
    of 6 samples in a step of more than 64 rows (its halves hold whole
    rays)."""
    sd = state_dict_from_jax(nerf_params_np(22, d_filter=1100, **SMALL))
    assert kr.prep_params(sd, **SMALL).width == 1280
    params = _packed_at(kr.prep_params(sd, **SMALL, device=cuda), sd, SMALL,
                        1120)
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=5, R=16, K=16))
    before = (kr.ray_march.launches, km.nerf_density.launches)
    with pytest.raises(ValueError, match="take widths up to W_max"):
        kr.ray_march(*(p.to(cuda) for p in padded), params, bR, cs)
    encx, dparams = _density_case(22, 1100, SMALL, 300, cuda)
    with pytest.raises(ValueError, match="take widths up to W_max"):
        km.nerf_density(encx, _packed_at(dparams, sd, SMALL, 1120))
    padded, _, _ = kr.pad_for_march(*march_inputs(seed=5, R=16, K=12))
    for width in (512, 1024):
        wide = kr.prep_params(state_dict_from_jax(
            nerf_params_np(22, d_filter=width, **SMALL)), **SMALL,
            device=cuda)
        with pytest.raises(ValueError, match="chunk_s must divide 64"):
            kr.ray_march(*(p.to(cuda) for p in padded), wide, 16, 6)
    assert (kr.ray_march.launches, km.nerf_density.launches) == before


def test_cli_trains_at_a_width_the_kernels_refuse(cuda, capsys):
    """--n_freqs 43 (a 261-wide point encoding, past the kernels' 256):
    the MLP routes resolve to the module on the card (no train, density,
    march or forward-MLP kernel launches), the run prints the one line
    that says so, and it trains and evaluates instead of raising."""
    import json

    from fsnerf_tpu_torch import cli

    launches = (mt.mlp_train_fwd.launches, km.nerf_density.launches,
                kr.ray_march.launches, km.nerf_mlp.launches)
    rc = cli.main(["--dataset", "sphere", "--hw", "32", "--n_imgs", "3",
                   "--n_layers", "4", "--d_filter", "64", "--skip", "1",
                   "--n_freqs", "43", "--grid_resolution", "16",
                   "--n_samples", "64", "--n_iters", "20", "--batch_size",
                   "256", "--white_bkgd", "--debug"])
    assert rc == 0
    captured = capsys.readouterr()
    out = json.loads(captured.out.strip().splitlines()[-1])
    assert out["steps"] == 20 and out["device"] != "cpu"
    assert out["psnr"] == out["psnr"] and out["rays_per_sec"] > 0
    assert "nerf width 64 trains and renders through the module" in \
        captured.err and "encodings up to 256" in captured.err
    assert (mt.mlp_train_fwd.launches, km.nerf_density.launches,
            kr.ray_march.launches, km.nerf_mlp.launches) == launches


def _train_params(seed, width, arch, cuda, pos_mask=None, dir_mask=None):
    sd = {k: v.to(cuda) for k, v in state_dict_from_jax(
        nerf_params_np(seed, d_filter=width, **arch)).items()}
    lay = mt.TrainLayout.of_module(arch["n_layers"], arch["skip"], width,
                                   arch["n_freqs"], arch["n_freqs_views"])
    enc = kr.enc_table(lay.n_freqs, lay.n_freqs_views, True, pos_mask,
                       dir_mask, cuda)
    return mt.pack_train_params(sd, lay, enc)


def _check_train(params, x, d, target, arbiter=False):
    """Kernel vs plain, forward and both backward modes, with the cotangent
    of an MSE loss; returns the kernel's saved-acts gradients. With
    `arbiter` (a streamed width, where kernel 6's bf16 rounding flips grow
    with K = W: scripts/grad_arbiter.py), a gradient over 2e-2 of its max
    is decided by the float64 arbiter instead: the kernel's worst error
    against it within 3x the plain version's (from the kernel's saved
    activations) over every tensor."""
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
    errs = {name: float((g - w).abs().max() / (w.abs().max() + 1e-12))
            for name, g, w in zip(lay.param_names,
                                  lay.grads_from_packed(*saved),
                                  lay.grads_from_packed(*plain))}
    worst = max(errs, key=errs.get)
    if arbiter and errs[worst] >= 2e-2:
        from fsnerf_tpu_torch.scripts.grad_arbiter import nerf_arbiter

        n = x.shape[0]
        arb = lay.grads_from_packed(*nerf_arbiter(x, d, dout, params,
                                                  acts[:n])[:2])
        from_acts = mt.mlp_train_bwd_reference(x, d, dout, params, acts[:n])

        def against_arbiter(grads):
            return max(float((g - a).abs().max() / (a.abs().max() + 1e-30))
                       for g, a in zip(lay.grads_from_packed(*grads), arb))

        k, p = against_arbiter(saved), against_arbiter(from_acts)
        assert k <= 3.0 * p, (worst, errs[worst], k, p)
    else:
        assert errs[worst] < 2e-2, (worst, errs[worst])
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


@pytest.mark.parametrize("width", [512, 700, 1024, 1100, 2048])
def test_split_train_grads_bitwise_repeatable(cuda, width):
    """At 512 (the column-split forward, the 64-row row pass, twice the
    bias partials), 768 (width 700), 1024, 1280 (width 1100) and 2048 (the
    streamed forward and row pass), NeRF 8 layers at 20,000 rows: two runs
    of each backward mode
    bitwise equal, saved == recompute; the acts stream bitwise repeatable,
    its padded columns 0 and every column within one bf16 step (plus 1e-3
    of the largest) of the plain version's."""
    params = _train_params(8, width, FULL, cuda)
    W = params.layout.width
    assert W == kr.nerf_kernel_width(width)
    x, d, target = (a.to(cuda) for a in mlp_inputs(20_000, seed=3))
    dout = mse_cotangent(mt.mlp_train_fwd(x, d, params)[0], target)
    runs, streams = [], []
    for _ in range(2):
        out, acts = mt.mlp_train_fwd(x, d, params, save_acts=True)
        streams.append((out, acts))
        runs.append(mt.mlp_train_bwd(x, d, dout, params, acts))
    runs.append(mt.mlp_train_bwd(x, d, dout, params, None))
    _, ref_acts = mt.mlp_train_fwd_reference(x, d, params, save_acts=True)
    torch.cuda.synchronize()
    for a, b, c in zip(*runs):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert all(torch.equal(a, b) for a, b in zip(*streams))
    acts = streams[0][1]
    for i in range(8):
        assert (acts[:, i * W + width:(i + 1) * W] == 0).all()
    got, want = acts[:20_000].float(), ref_acts.float()
    excess = (got - want).abs() - (want.abs() * 2.0 ** -7
                                   + 1e-3 * want.abs().max())
    assert excess.max() <= 0, float(excess.max())


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
    """A pack at 1120 (none of the widths the packers lay out: 1100 packs at
    1280) and a point encoding wider than 256 (43 bands: 261, padded 272)
    raise by name before a launch, in the forward and in both backward
    modes. At width 256 a direction encoding wider than 128 (21 bands:
    144), which these kernels refused there, packs at 384 and runs:
    test_nerf_kernels_at_padded_widths."""
    for width, spec, packed, match in (
            (1100, SMALL, 1120, "train kernels take widths up to W_max"),
            (64, dict(SMALL, n_freqs=43), None, "encodings up to 256")):
        params = _train_params(12, width, spec, cuda)
        if packed is not None:
            import dataclasses

            lay = dataclasses.replace(params.layout, width=packed)
            sd = {k: v.to(cuda) for k, v in state_dict_from_jax(
                nerf_params_np(12, d_filter=width, **spec)).items()}
            params = mt.pack_train_params(sd, lay, params.enc)
        assert (params.layout.width == packed) or packed is None
        x, d, target = (a.to(cuda) for a in mlp_inputs(200, seed=7))
        dout = mse_cotangent(
            mt.mlp_train_fwd_reference(x, d, params)[0], target)
        acts = torch.zeros((256, spec["n_layers"] * params.layout.width),
                           dtype=torch.bfloat16, device=cuda)
        before = (mt.mlp_train_fwd.launches, mt.mlp_train_bwd.launches)
        with pytest.raises(ValueError, match=match):
            mt.mlp_train_fwd(x, d, params, save_acts=True)
        with pytest.raises(ValueError, match=match):
            mt.mlp_train_bwd(x, d, dout, params, None)
        with pytest.raises(ValueError, match=match):
            mt.mlp_train_bwd(x, d, dout, params, acts)
        assert (mt.mlp_train_fwd.launches,
                mt.mlp_train_bwd.launches) == before
    lay = mt.TrainLayout.of_module(8, (4,), 256, 10, 21)
    assert (lay.width, lay.dd, lay.kernel_error()) == (384, 144, None)


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


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [1, 77, 128, 20_037, 393_216])
@pytest.mark.parametrize("act", ["none", "relu", "trunc_exp"])
@pytest.mark.parametrize("width", [64, 128, 192, 256, 384, 512, 768, 1024,
                                   1280, 2048])
def test_nerf_mlp_matches_plain_at_each_width(cuda, width, act, n, masked):
    """The warp-specialized forward MLP at each width of NeRF 8 layers,
    skip (4,), n_freqs 10/4 (a 32-wide direction encoding), with and
    without FreeNeRF masks, up to one validation chunk (2,048 rays x 192
    samples): rgb within 5e-3, sigma within 2e-2 of max |sigma|, two runs
    bitwise equal."""
    pm = dm = None
    if masked:
        pm = torch.tensor([1.0] * 5 + [0.4] + [0.0] * 4)
        dm = torch.tensor([1.0, 1.0, 0.5, 0.0])
    _check_mlp(*_mlp_case(17, width, FULL, n, cuda, pm, dm), act)


def test_nerf_mlp_refuses_widths_it_is_not_built_for(cuda):
    """nerf_mlp takes every width the packers lay out, as the other NeRF
    kernels (1100 packs at 1280), and refuses a pack at 1120 by name."""
    encx, encd, params = _mlp_case(18, 1100, SMALL, 300, cuda)
    assert params.width == 1280
    sd = state_dict_from_jax(nerf_params_np(18, d_filter=1100, **SMALL))
    before = km.nerf_mlp.launches
    with pytest.raises(ValueError, match="take widths up to W_max"):
        km.nerf_mlp(encx, encd, _packed_at(params, sd, SMALL, 1120))
    assert km.nerf_mlp.launches == before


def _siren_params(seed, n_layers, width, cuda, sigma_bias=0.0,
                  packed=None):
    """A seeded SiNeRF of `width` packed at `packed` (default
    render.py::kernel_width's)."""
    sd = state_dict_from_jax(sinerf_params_np(seed, n_layers, width))
    sd["sigma_layers.1.bias"] = sd["sigma_layers.1.bias"] + sigma_bias
    return ks._prep_siren_params(sd, n_layers, None, True, cuda,
                                 packed or kr.kernel_width(width))


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


@pytest.mark.parametrize("n", [77, 8_264, 2 * mt.SPLIT_ROWS + 1_000,
                               196_608])
@pytest.mark.parametrize("width", [64, 128, 192, 256])
def test_siren_saved_backward_at_each_width(cuda, width, n):
    """The warp-specialized row pass (saved mode) at each width it is built
    for, SiNeRF 8 layers, up to the main path's 196,608 rows: every
    gradient within 1e-2 of its max against the plain version, bitwise
    repeatable, saved within 1e-2 of recompute (which runs the mma.sync
    row pass)."""
    _check_siren(_siren_params(25, 8, width, cuda),
                 *_siren_inputs(n, 6, cuda))


def test_siren_width_96_runs_the_mma_row_pass(cuda):
    """Width 96, packed at 128: saved mode on the warp-specialized row
    pass, recompute mode on the mma.sync one (siren_bwd_rows_kernel), held
    as at the other widths. Above 256 the mma.sync row pass does not fit
    in shared memory: a pack at 320 (no packer's width: kernel_width packs
    300 at 384) raises by name in both modes, launching nothing."""
    params = _siren_params(26, 4, 96, cuda)
    assert params.layout.width == 128
    _check_siren(params, *_siren_inputs(1_000, 7, cuda))
    wide = _siren_params(26, 4, 320, cuda, packed=320)
    x, d, target = _siren_inputs(300, 7, cuda)
    out, acts = ks.siren_mlp_fwd(x, d, wide, save_acts=True)
    dout = mse_cotangent(out, target)
    before = ks.siren_mlp_bwd.launches
    for a in (acts, None):
        with pytest.raises(ValueError,
                           match="takes the packed widths up to 256"):
            ks.siren_mlp_bwd(x, d, dout, wide, a)
    assert ks.siren_mlp_bwd.launches == before


@pytest.mark.parametrize("n", [8_264, 196_608])
@pytest.mark.parametrize("width", [64, 128, 192, 256])
def test_siren_forward_at_each_width(cuda, width, n):
    """The warp-specialized forward (widths 64, 128, 192, 256), SiNeRF 8
    layers,
    at a ragged N and the main path's 196,608 rows: rgb within 5e-3 and
    sigma within 2e-2 of max |sigma|; the acts stream's h_i within 3e-2 and
    its factors within 0.25 (two bf16 steps at |a cos| in [16, 32)) of the
    plain version's, each on at most 2% of the elements (a rounding flip of
    h_0 at a = 30 moves the later layers by a few bf16 steps, in the
    mma.sync kernel as here: `scripts/train_kernel_turns.py --groups siren`
    reads both); out and acts bitwise repeatable, out equal with and
    without acts; one launch counted per call."""
    L = 8
    params = _siren_params(27, L, width, cuda)
    x, d, _ = _siren_inputs(n, 8, cuda)
    before = ks.siren_mlp_fwd.launches
    out, acts = ks.siren_mlp_fwd(x, d, params, save_acts=True)
    out2, acts2 = ks.siren_mlp_fwd(x, d, params, save_acts=True)
    primal, _ = ks.siren_mlp_fwd(x, d, params)
    ref, ref_acts = ks.siren_mlp_fwd_reference(x, d, params, save_acts=True)
    torch.cuda.synchronize()
    assert ks.siren_mlp_fwd.launches == before + 3
    assert acts.shape == (-(-n // ks.ROWS) * ks.ROWS, 2 * L * width)
    assert torch.equal(out, out2) and torch.equal(acts, acts2)
    assert torch.equal(out, primal) and torch.isfinite(out).all()
    assert (out[:, :3] - ref[:, :3]).abs().max() < 5e-3
    scale = ref[:, 3].abs().max() + 1e-9
    assert (out[:, 3] - ref[:, 3]).abs().max() / scale < 2e-2
    got, want = acts[:n].float(), ref_acts.float()
    for cols, tol in ((slice(0, L * width), 3e-2),
                      (slice(L * width, None), 0.25)):
        diff = (got[:, cols] - want[:, cols]).abs()
        assert diff.max() <= tol, (cols, float(diff.max()))
        assert (diff > 0).float().mean() <= 0.02, cols


def test_siren_width_96_runs_the_mma_forward_and_march(cuda):
    """Width 96 packs at 128 for the warp-specialized forward and march; a
    pack at 320 (no packer's width since the column-split kernels take 384)
    runs their mma.sync kernels (siren_fwd_kernel,
    ray_march_kernel<SirenMarch>), each launch counted, held to the same
    tolerances; the wrappers never route to the module. Width 600 (packed
    768) runs the streamed kernels: the forward, both backward modes
    (recompute mode's forward not counted) and the march, each launch
    counted. A pack at 1120 (none of the widths the packers lay out: 1100
    packs at 1280) has no SIREN kernel and raises by name in the forward,
    both backward modes and the march, launching nothing."""
    assert _siren_params(26, 4, 96, cuda).layout.width == 128
    params = _siren_params(26, 4, 320, cuda, packed=320)
    x, d, target = _siren_inputs(1_000, 7, cuda)
    f0, m0 = ks.siren_mlp_fwd.launches, kr.siren_ray_march.launches
    b0 = ks.siren_mlp_bwd.launches
    out, _ = ks.siren_mlp_fwd(x, d, params)
    ref, _ = ks.siren_mlp_fwd_reference(x, d, params)
    torch.cuda.synchronize()
    assert (out[:, :3] - ref[:, :3]).abs().max() < 5e-3
    scale = ref[:, 3].abs().max() + 1e-9
    assert (out[:, 3] - ref[:, 3]).abs().max() / scale < 2e-2
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=4, R=300, K=48))
    padded = tuple(p.to(cuda) for p in padded)
    _check_siren_march(padded, params, bR, cs)
    assert ks.siren_mlp_fwd.launches == f0 + 1
    assert kr.siren_ray_march.launches == m0 + 2
    wide = _siren_params(26, 4, 600, cuda)
    assert wide.layout.width == 768
    out, acts = ks.siren_mlp_fwd(x, d, wide, save_acts=True)
    ref, _ = ks.siren_mlp_fwd_reference(x, d, wide)
    torch.cuda.synchronize()
    assert (out[:, :3] - ref[:, :3]).abs().max() < 5e-3
    scale = ref[:, 3].abs().max() + 1e-9
    assert (out[:, 3] - ref[:, 3]).abs().max() / scale < 2e-2
    dout = mse_cotangent(ref, target)
    saved = ks.siren_mlp_bwd(x, d, dout, wide, acts)
    rec = ks.siren_mlp_bwd(x, d, dout, wide, None)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(saved, rec))
    _check_siren_march(padded, wide, bR, cs)
    assert (ks.siren_mlp_fwd.launches, ks.siren_mlp_bwd.launches,
            kr.siren_ray_march.launches) == (f0 + 2, b0 + 2, m0 + 4)
    assert _siren_params(26, 4, 1100, cuda).layout.width == 1280
    too_wide = _siren_params(26, 4, 1100, cuda, packed=1120)
    assert too_wide.layout.width == 1120
    with pytest.raises(ValueError, match="up to W_max"):
        ks.siren_mlp_fwd(x, d, too_wide)
    for acts in (None, torch.zeros((1_024, 8 * 1120), dtype=torch.bfloat16,
                                   device=cuda)):
        with pytest.raises(ValueError, match="up to W_max"):
            ks.siren_mlp_bwd(x, d, dout, too_wide, acts)
    with pytest.raises(ValueError, match="up to W_max"):
        kr.siren_ray_march(*padded, too_wide, bR, cs)
    assert (ks.siren_mlp_fwd.launches, ks.siren_mlp_bwd.launches,
            kr.siren_ray_march.launches) == (f0 + 2, b0 + 2, m0 + 4)


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


@pytest.mark.parametrize("sigma_bias", [0.0, 5000.0])
@pytest.mark.parametrize("width", [64, 128, 192, 256])
def test_siren_march_at_each_width(cuda, width, sigma_bias):
    """The warp-specialized march (widths 64, 128, 192, 256), SiNeRF 8
    layers, 300 rays (a ragged last block) x K 48: rgb/opacity within 7e-3, depth
    within 3e-2, equal executed steps, bitwise repeatable; the saturating
    bias makes blocks exit early."""
    params = _siren_params(28, 8, width, cuda, sigma_bias)
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=6, R=300, K=48))
    steps = _check_siren_march(tuple(p.to(cuda) for p in padded), params,
                               bR, cs)
    if sigma_bias:
        assert int(steps.sum()) < steps.numel() * 48 // cs


@pytest.mark.parametrize("sigma_bias", [0.0, 5000.0])
def test_siren_march_at_the_main_path_shape(cuda, sigma_bias):
    """SiNeRF 8x256 at 16,384 rays x K 192, block 16 x chunk 8 (a 128x128
    view at the eval K): as test_siren_march_at_each_width."""
    params = _siren_params(29, 8, 256, cuda, sigma_bias)
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=7, R=16_384,
                                                    K=192))
    assert (bR, cs) == (16, 8)
    steps = _check_siren_march(tuple(p.to(cuda) for p in padded), params,
                               bR, cs)
    if sigma_bias:
        assert int(steps.sum()) < steps.numel() * 192 // cs


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


def _band_mask(n_bands, cuda):
    """Bands past 20 masked off: at 2^27 and above the polynomial sine of
    the encodings (fastmath.py's, the TPU kernels') no longer holds |sin|
    <= 1, so an encoding of 42 bands is finite only so."""
    return torch.tensor([1.0] * min(n_bands, 20)
                        + [0.0] * max(n_bands - 20, 0), device=cuda)


@pytest.mark.parametrize("width,spec", [
    (40, SMALL), (96, SMALL), (200, FULL), (256, dict(FULL, n_freqs=21)),
    (192, dict(SMALL, n_freqs=42, n_freqs_views=42)),
    (256, dict(SMALL, n_freqs=42, n_freqs_views=20)), (300, FULL),
    (512, FULL), (512, dict(FULL, n_freqs=21)),
    (400, dict(SMALL, n_freqs=42, n_freqs_views=42)), (700, FULL),
    (1024, FULL), (1000, dict(SMALL, n_freqs=42, n_freqs_views=42)),
    (1100, FULL), (256, dict(FULL, n_freqs_views=21)),
    (200, dict(SMALL, n_freqs=42, n_freqs_views=42))])
def test_nerf_kernels_at_padded_widths(cuda, width, spec):
    """Kernels 1 and 3-6 at widths that are not their own (packed at the
    next of 64, 128, 192, 256, 384, 512 or a multiple of 256 from 768 up,
    with zero units: 1100 at 1280; 200 and 256 with a direction encoding
    over 128 at 384) and with encodings up to 256 wide, against their
    plain versions at the tolerances above (above 1024 a gradient over
    2e-2 decided by the float64 arbiter, _check_train); the packed weight
    and bias gradients exactly 0 in every padded entry."""
    pm, dm = _band_mask(spec["n_freqs"], cuda), \
        _band_mask(spec["n_freqs_views"], cuda)
    encx, encd, params = _mlp_case(31, width, spec, 3000, cuda, pm.cpu(),
                                   dm.cpu())
    assert params.width == kr.nerf_kernel_width(width, params.d_dir_pad)
    _check_mlp(encx, encd, params, "none")
    dens, dparams = _density_case(31, width, spec, 3000, cuda, pm)
    assert dparams.width == params.width
    got, ref = km.nerf_density(dens, dparams), \
        km.nerf_density_reference(dens, dparams)
    assert (got - ref).abs().max() / (ref.abs().max() + 1e-9) < 2e-2
    tparams = _train_params(31, width, spec, cuda, pm, dm)
    x, d, target = (a.to(cuda) for a in mlp_inputs(3000, seed=3))
    dw, db = _check_train(tparams, x, d, target, arbiter=width > 1024)
    lay = tparams.layout
    ones = {k: torch.ones_like(v) for k, v in state_dict_from_jax(
        nerf_params_np(31, d_filter=width, **spec)).items()}
    wpad, bpad = kr.pack_weights(ones, lay.n_layers, lay.skip, lay.de,
                                 lay.dd, lay.width)
    assert (dw.cpu()[wpad.float() == 0] == 0).all()
    assert (db.cpu()[bpad == 0] == 0).all()
    sd = state_dict_from_jax(nerf_params_np(31, d_filter=width, **spec))
    mparams = kr.prep_params(sd, **spec, pos_mask=pm.cpu(),
                             dir_mask=dm.cpu(), device=cuda)
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=8, R=300, K=48))
    _check(tuple(p.to(cuda) for p in padded), mparams, bR, cs)


@pytest.mark.parametrize("width", [40, 100])
def test_siren_kernels_at_padded_widths(cuda, width):
    """Kernels 7, 8 (both modes) and 2 at widths that are not their own,
    packed at 64 and 128: the tolerances above (300, packed at 384:
    test_siren_kernels_at_split_widths)."""
    params = _siren_params(32, 4, width, cuda)
    assert params.layout.width == kr.kernel_width(width)
    _check_siren(params, *_siren_inputs(3000, 9, cuda))
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=9, R=300, K=48))
    _check_siren_march(tuple(p.to(cuda) for p in padded), params, bR, cs)


@pytest.mark.parametrize("width,n_layers,n", [
    (300, 4, 3_000), (300, 8, 8_264), (512, 4, 3_000), (512, 8, 8_264),
    (512, 8, 196_608)])
def test_siren_kernels_at_split_widths(cuda, width, n_layers, n):
    """Kernels 7, 8 (both modes) and 2 at the column-split widths (SiNeRF
    300 packs at 384, 512 at 512), up to the main path's 196,608 rows:
    _check_siren's tolerances, bitwise repeatable; recompute mode bitwise
    equal to saved mode (it runs the forward kernel, then the saved
    passes); the packed gradients' padded entries exactly 0; the acts
    stream's h_i within 3e-2 and factors within 0.25 of the plain
    version's, on at most 2% of the elements at 4 layers (4% at 8: a flip
    of h_0 at a = 30 reaches more units at 512); the march (300 rays x K
    48) at blockings of 128 rows a step (two 64-row halves), 64 rows and
    16 x 4, normal and saturating, refusing a chunk_s that does not divide
    64 in a step of more than 64 rows."""
    _check_siren_wide(width, n_layers, n, cuda, kr.SPLIT_WIDTHS,
                      {4: 0.02, 8: 0.04})


@pytest.mark.parametrize("width,n_layers,n", [
    (700, 4, 3_000), (700, 8, 8_264), (1024, 4, 3_000), (1024, 8, 8_264),
    (1024, 8, 196_608), (1100, 4, 3_000), (2048, 4, 3_000),
    (2048, 8, 8_264)])
def test_siren_kernels_at_stream_widths(cuda, width, n_layers, n):
    """Kernels 7, 8 (both modes) and 2 at the streamed widths (SiNeRF 700
    packs at 768, 1024 at 1024, 1100 at 1280, 2048 at 2048:
    siren_fwd_kernel_stream,
    siren_bwd_rows_kernel_stream, siren_march_kernel_stream), up to the
    main path's 196,608 rows, as test_siren_kernels_at_split_widths holds
    the column-split ones: _check_siren's tolerances, bitwise repeatable,
    recompute mode bitwise equal to saved mode, the padded gradient
    entries exactly 0, the acts stream's h_i within 3e-2 and factors within
    0.25 of the plain version's, on at most 2% of the elements at 4 layers
    and 12% at 8 up to a packed width of 1024 (measured at 8 x 1024: 10.3%
    of h, 6.7% of the factors; the tensor cores round their f32 sums
    toward zero, so a K of 1024 flips ~4x the bf16 roundings a K of 256
    does, and each flipped unit of h_i moves the next layer's 1024 sums:
    scripts/grad_arbiter.py), above 1024 that share times K / 1024 (at 4 x
    2048 3.4% of h differ, one layer's flips growing with K as at 256 ...
    1024; against the script's float64 forward the kernel's rgb and sigma
    stay within 1.22x the plain version's error at 2048, while a layer
    flips 4x its h and 8x its factors: ROADMAP Queue 3), the march at
    three blockings, saturating, and refusing a chunk_s that does not
    divide 64 in a step of more than 64 rows."""
    _check_siren_wide(width, n_layers, n, cuda, (768, 1024, 1280, 2048),
                      {4: 0.02, 8: 0.12})


def _check_siren_wide(width, n_layers, n, cuda, widths, differ):
    """The body of the split and streamed widths' tests: `widths` the
    packed widths the case must land on, differ[L] the largest share of
    the acts stream's elements that may differ from the plain version's
    up to a packed width of 1024; above it that share times K / 1024 (the
    flips grow linearly in K, test_siren_kernels_at_stream_widths), the
    value tolerances unchanged."""
    params = _siren_params(33, n_layers, width, cuda)
    K = params.layout.width
    assert K == kr.kernel_width(width) and K in widths
    x, d, target = _siren_inputs(n, 10, cuda)
    _check_siren(params, x, d, target)
    out, acts = ks.siren_mlp_fwd(x, d, params, save_acts=True)
    ref, ref_acts = ks.siren_mlp_fwd_reference(x, d, params, save_acts=True)
    f0 = ks.siren_mlp_fwd.launches
    saved = ks.siren_mlp_bwd(x, d, mse_cotangent(ref, target), params, acts)
    rec = ks.siren_mlp_bwd(x, d, mse_cotangent(ref, target), params, None)
    torch.cuda.synchronize()
    assert ks.siren_mlp_fwd.launches == f0
    assert all(torch.equal(a, b) for a, b in zip(saved, rec))
    L = n_layers
    got, want = acts[:n].float(), ref_acts.float()
    for cols, tol in ((slice(0, L * K), 3e-2), (slice(L * K, None), 0.25)):
        diff = (got[:, cols] - want[:, cols]).abs()
        assert diff.max() <= tol, (cols, float(diff.max()))
        assert (diff > 0).float().mean() <= differ[L] * max(
            1.0, K / 1024), (cols, float((diff > 0).float().mean()))
    ones = {k: torch.ones_like(v) for k, v in state_dict_from_jax(
        sinerf_params_np(33, n_layers, width)).items()}
    mask = ks.prep_siren_params(ones, n_layers)
    wpad, bpad = mask.wpack.float() == 0, mask.bpack == 0
    assert wpad.any()
    assert (saved[0].cpu()[wpad] == 0).all()
    assert (saved[1].cpu()[bpad] == 0).all()
    padded, bR, cs = kr.pad_for_march(*march_inputs(seed=11, R=300, K=48))
    padded = tuple(p.to(cuda) for p in padded)
    assert (bR, cs) == (16, 8)
    for blocking in ((16, 8), (8, 8), (16, 4)):
        _check_siren_march(padded, params, *blocking)
    hot = _siren_params(33, n_layers, width, cuda, 5000.0)
    steps = _check_siren_march(padded, hot, bR, cs)
    assert int(steps.sum()) < steps.numel() * 48 // cs
    before = kr.siren_ray_march.launches
    with pytest.raises(ValueError, match="chunk_s must divide 64"):
        kr.siren_ray_march(*padded, params, 16, 6)
    assert kr.siren_ray_march.launches == before


@pytest.mark.parametrize("n_layers", [4, 8])
def test_siren_stages_are_the_launchers(cuda, n_layers):
    """siren.py::siren_stages, the Python mirror of the SIREN kernels'
    shared memory, picks the ring each C launcher picks, at every packed
    width; no warp-specialized instance at 320."""
    widths = kr.NERF_KERNEL_WIDTHS + (768, 1024, 1280, 2048, 15360)
    for kernel in ("forward", "march", "backward"):
        assert [ks.launcher_stages(W, kernel, n_layers)
                for W in widths] == \
            [ks.siren_stages(W, kernel, n_layers) for W in widths], kernel
        assert ks.launcher_stages(320, kernel, n_layers) == 0
        assert ks.launcher_stages(1120, kernel, n_layers) == 0


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
@pytest.mark.parametrize("width", [64, 128, 192, 256, 384, 512, 768, 1024,
                                   1280, 2048])
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


# -- the data slice: the decoder, NDC inputs of a 4-level grid, LLFF --------

def _llff_scene(root, n=10, H=36, W=48, focal=40.0):
    """An LLFF scene under root/llff/ramp written by the port's PNG writer:
    `n` forward-facing views of colour ramps with small offsets, the LLFF
    column order in poses_bounds.npy. Returns the images (uint8)."""
    import os

    import numpy as np

    from fsnerf_tpu_torch.native import write_png

    scene_dir = os.path.join(root, "llff", "ramp")
    os.makedirs(os.path.join(scene_dir, "images_8"))
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:H, 0:W]
    rows, imgs = [], []
    for i in range(n):
        img = np.stack([xx * 255 // W, yy * 255 // H,
                        np.full_like(xx, 60 + 10 * i)], -1).astype(np.uint8)
        write_png(os.path.join(scene_dir, "images_8", f"im_{i:03d}.png"),
                  img)
        imgs.append(img)
        c2w = np.zeros((3, 5), np.float32)
        c2w[:, 0], c2w[:, 1], c2w[:, 2] = [0, -1, 0], [1, 0, 0], [0, 0, 1]
        c2w[:, 3] = 0.1 * rng.normal(size=3)
        c2w[:, 4] = [H * 8, W * 8, focal * 8]
        rows.append(np.concatenate([c2w.ravel(), [2.0 + 0.1 * i, 8.0]]))
    np.save(os.path.join(scene_dir, "poses_bounds.npy"), np.stack(rows))
    return np.stack(imgs)


def _llff_cfg(root, n_iters=40):
    """The command line's config of a small LLFF run on _llff_scene (4 grid
    levels, NDC)."""
    from fsnerf_tpu_torch import cli

    return cli.config_from_args([
        "--dataset", "llff", "--scene", "ramp", "--data_root", str(root),
        "--n_imgs", "4", "--n_layers", "4", "--d_filter", "64", "--skip",
        "2", "--n_freqs", "6", "--n_freqs_views", "3", "--grid_resolution",
        "32", "--n_samples", "128", "--n_compact", "64", "--batch_size",
        "256", "--n_iters", str(n_iters), "--render_step_size", "0.005"])


def test_decoder_builds_and_reads_port_written_pngs(cuda, tmp_path):
    """The decoder compiles with g++ on this machine and reads the PNG
    writer's RGB and RGBA files exactly (each value times 1/255)."""
    import numpy as np

    from fsnerf_tpu_torch import native

    assert native.build().exists()
    rng = np.random.default_rng(0)
    for c in (3, 4):
        imgs = rng.integers(0, 256, (3, 17, 23, c), dtype=np.uint8)
        paths = [str(tmp_path / f"im{c}_{i}.png") for i in range(3)]
        for p, img in zip(paths, imgs):
            native.write_png(p, img)
        got = native.decode_images(paths)
        want = imgs.astype(np.float32) * (np.float32(1) / np.float32(255))
        assert got.dtype == np.float32 and np.array_equal(got, want)


def test_decoder_reads_the_jpeg_fixtures_bitwise(cuda):
    """The decoder, built on this machine (which has no libjpeg), reads
    tests/data/jpeg/'s JPEGs (progressive, 4:2:0 with restarts, gray,
    4:2:2, 4:4:0, RGB; widths and heights no MCU divides) to exactly the
    pixels libjpeg-turbo gives (pixels.npz) times 1/255, in one call."""
    import os

    import numpy as np

    from fsnerf_tpu_torch import native

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                        "jpeg")
    with np.load(os.path.join(root, "pixels.npz")) as npz:
        want = {n: npz[n] for n in npz.files}
    assert len(want) >= 5
    for name, px in want.items():
        got = native.decode_images([os.path.join(root, name)])[0]
        assert got.dtype == np.float32 and np.array_equal(
            got, np.multiply(px, np.float32(1) / np.float32(255),
                             dtype=np.float32)), name


def test_march_and_density_match_plain_on_ndc_samples(cuda, tmp_path):
    """Kernels 1 and 4 on an LLFF scene's NDC rays and a 4-level grid
    rebuilt from a seeded model: the ray march within the ray-march
    tolerances with equal executed steps, the density pass on every
    level's cell centres within 2e-2 of max |sigma|."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.data.rays import get_rays, to_ndc
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.sampling import (compact_samples_uniform,
                                               sample_points)
    from fsnerf_tpu_torch.render.renderer import _masked_lattice

    _llff_scene(tmp_path)
    cfg = _llff_cfg(tmp_path)
    _, (train, val, _), model, _ = cli.build_everything(cfg, device=cuda)
    assert train.ndc and cfg.sampling.grid_levels == 4
    grid = cli.rebuild_grid(model, cfg, train.aabb, cuda)
    assert grid.levels == 4
    s, m, e = cfg.sampling, cfg.model, cfg.encoder
    pose = torch.as_tensor(val.poses[0], dtype=torch.float32, device=cuda)
    ro, rd = (a.reshape(-1, 3) for a in get_rays(pose, val.hwf))
    ro, rd = to_ndc(ro, rd, val.hwf, 1.0)
    with torch.no_grad():
        t_mid, deltas, mask, n_valid = _masked_lattice(
            ro, rd, grid, s.n_samples, None, s.render_step_size,
            s.early_stop_eps, og.grid_query_stride(s, train.aabb, grid))
        t_k, d_k, m_k = compact_samples_uniform(t_mid, deltas[:, 0], mask,
                                                s.n_compact)
        perm = torch.sort(n_valid, stable=True).indices
        x = sample_points(ro, rd, t_k)
        padded, bR, cs = kr.pad_for_march(x[perm], rd[perm], t_k[perm],
                                          d_k[perm], m_k[perm])
    assert float(n_valid.mean()) > 0
    params = kr.prep_params(model.state_dict(), n_layers=m.n_layers,
                            skip=m.skip, n_freqs=e.n_freqs,
                            n_freqs_views=e.n_freqs_views, device=cuda)
    _check(padded, params, bR, cs, s.early_stop_eps)

    dparams = km.prep_params(model.state_dict(), m.n_layers, m.skip)
    idx = torch.arange(grid.n_cells, device=cuda)
    for lv in range(grid.levels):
        xc = og._cell_positions(idx, og.level_aabb(grid.base_aabb, lv),
                                grid.resolution)
        encx = km.pad_features(positional_encoding(xc, e.n_freqs, True),
                               dparams.d_enc_pad)
        got = km.nerf_density(encx, dparams)
        ref = km.nerf_density_reference(encx, dparams)
        torch.cuda.synchronize()
        assert (got - ref).abs().max() / (ref.abs().max() + 1e-9) < 2e-2, lv


def test_graphed_llff_training_is_the_eager_loop(cuda, tmp_path):
    """40 LLFF steps (NDC rays, 4 grid levels, all-cell refreshes of every
    level) from CUDA-graph replays against the eager steps, bitwise, with
    the density kernel launched 4 x 1 launches per all-cell refresh at
    res 32."""
    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.ops.kernels import launch_counts
    from fsnerf_tpu_torch.train.loop import train

    _llff_scene(tmp_path)
    cfg = _llff_cfg(tmp_path)
    out = {}
    for graphs in (None, False):
        _, (split, _, _), model, pool = cli.build_everything(cfg,
                                                             device=cuda)
        before = launch_counts()
        state = train(model, cfg, pool, split, graphs=graphs)
        torch.cuda.synchronize()
        after = launch_counts()
        out[graphs] = (state, {k: after[k] - before[k] for k in after})
    _assert_bitwise(out[None][0], out[False][0])
    assert out[None][1] == out[False][1]
    refreshes = len(range(0, 40, cfg.sampling.update_interval))
    assert out[None][1]["nerf_density"] == 4 * refreshes
    assert out[None][1]["mlp_train_fwd"] == 40


# -- graphed training: CUDA-graph replays against the eager step loop ----

def _graph_cfg(model="nerf", strategy="occgrid", width=64, samples=None,
               n_freqs=6, **train):
    """A small config that reaches every step kind within ~300 steps:
    warmup (all-cell refreshes) to step 64, then the four parts every 8
    steps, every 16 from step 192; the ladder under 64 samples (`samples`
    changes SamplingConfig fields)."""
    import dataclasses

    from fsnerf_tpu_torch.config import (Config, DataConfig, EncoderConfig,
                                         ModelConfig, SamplingConfig,
                                         TrainConfig)

    sampling = dict(n_samples=128, n_compact=64, grid_resolution=32,
                    render_step_size=0.02, warmup_steps=64,
                    update_interval=8, update_interval_late=16,
                    update_interval_late_start=192)
    if strategy == "hierarchical":
        sampling = dict(strategy="hierarchical", n_samples=32, n_fine=64)
    sampling.update(samples or {})
    cfg = Config(encoder=EncoderConfig(n_freqs=n_freqs, n_freqs_views=3),
                 model=ModelConfig(model=model, n_layers=4, d_filter=width,
                                   skip=(2,)),
                 data=DataConfig(dataset="sphere", n_imgs=4,
                                 white_bkgd=True),
                 sampling=SamplingConfig(**sampling),
                 train=TrainConfig(n_iters=300, batch_size=256, lro=5e-3))
    return cfg.replace(train=dataclasses.replace(cfg.train, **train))


class _Records:
    def __init__(self):
        self.records = []

    def log(self, k, metrics):
        self.records.append({"step": k, **{
            n: v for n, v in metrics.items() if n != "rays_per_sec"}})


def _train_run(cfg, cuda, graphs, scene=None, state=None, model=None,
               **kw):
    """train() from seeded weights; (state, logged records, the launch
    counts the run added)."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops.kernels import launch_counts
    from fsnerf_tpu_torch.train.loop import train

    scene = scene or SphereScene(n_imgs=cfg.data.n_imgs, hw=48,
                                 white_bkgd=True)
    if model is None:
        model = make_model(cfg, torch.bfloat16,
                           torch.Generator().manual_seed(0), cuda)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=cuda)
    log = _Records()
    before = launch_counts()
    state = train(model, cfg, pool, scene, state=state, logger=log,
                  log_every=20, graphs=graphs, **kw)
    torch.cuda.synchronize()
    after = launch_counts()
    return state, log.records, {k: after[k] - before[k] for k in after}


def _assert_bitwise(a, b):
    """Weights, Adam's moments and counts, every grid tensor, the
    generator and both step counters equal."""
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(pa, pb)
        sa, sb = a.optimizer.state[pa], b.optimizer.state[pb]
        for k in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(sa[k], sb[k]), k
    for k in ("occs", "occ_q", "od_q", "binaries", "thre"):
        assert torch.equal(getattr(a.grid, k), getattr(b.grid, k)), k
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.step == b.step == int(a.step_t) == int(b.step_t)


def _graph_log(caplog):
    """The rungs the loop logged as it released their graphs."""
    return [r.graphs for r in caplog.records if hasattr(r, "graphs")]


@pytest.mark.parametrize("case", ["occgrid", "sinerf", "hierarchical",
                                  "width96", "width320", "width600",
                                  "refused"])
def test_graphed_training_is_the_eager_loop(cuda, case, caplog):
    """300 steps of train() from CUDA-graph replays against the same run
    by eager steps, bitwise: the NeRF occgrid path through the warmup's
    all-cell refreshes and the four parts at both intervals, SiNeRF
    (its refresh on the module), the hierarchical path (its sorts and
    scatters), width 96 (the kernels at the packed width 128), the kernels
    at the split width 384 (320) and the streamed width 768 (600: their
    scratch allocated inside the captures) and an encoding the kernels
    refuse (43 bands, 261 wide: the module route, cuBLAS in the graphs).
    The logged metrics and
    the kernels' launch counts are the eager run's too."""
    import logging

    cfg = {"occgrid": _graph_cfg(), "sinerf": _graph_cfg("sinerf"),
           "hierarchical": _graph_cfg(strategy="hierarchical"),
           "width96": _graph_cfg(width=96),
           "width320": _graph_cfg(width=320),
           "width600": _graph_cfg(width=600),
           "refused": _graph_cfg(n_freqs=43)}[case]
    caplog.set_level(logging.INFO, logger="fsnerf_tpu_torch.train.loop")
    g, g_logs, g_launches = _train_run(cfg, cuda, graphs=None)
    rungs = _graph_log(caplog)
    e, e_logs, e_launches = _train_run(cfg, cuda, graphs=False)
    _assert_bitwise(g, e)
    assert g_logs == e_logs
    assert g_launches == e_launches
    assert rungs and not _graph_log(caplog)[len(rungs):]
    if case == "refused":
        assert not any(g_launches[k] for k in (
            "mlp_train_fwd", "nerf_density", "siren_mlp_fwd"))
    elif case == "sinerf":
        assert g_launches["siren_mlp_fwd"] == g_launches[
            "siren_mlp_bwd"] == 300
    else:
        n = 600 if case == "hierarchical" else 300
        assert g_launches["mlp_train_fwd"] == g_launches[
            "mlp_train_bwd"] == n


def test_graphed_ladder_change_recaptures(cuda, caplog):
    """A K change of the compaction ladder retires the step function and
    its graphs (logged) and captures the new rung's: more than one rung,
    each with its own K, and the run bitwise the eager one."""
    import logging

    cfg = _graph_cfg(samples=dict(n_compact=128))
    caplog.set_level(logging.INFO, logger="fsnerf_tpu_torch.train.loop")
    g, g_logs, _ = _train_run(cfg, cuda, graphs=None)
    rungs = _graph_log(caplog)
    ks = [r["n_compact"] for r in rungs]
    assert len(rungs) >= 2 and all(a != b for a, b in zip(ks, ks[1:])), ks
    assert [r["n_compact"] for r in g_logs][-1] == ks[-1]
    e, _, _ = _train_run(cfg, cuda, graphs=False)
    _assert_bitwise(g, e)


def test_graphed_capture_failure_raises(cuda, monkeypatch):
    """A step that waits on the host cannot be captured: train() raises
    on the card instead of running the eager loop."""
    from fsnerf_tpu_torch.ops import occgrid as og

    real = og.occupancy_fraction
    monkeypatch.setattr(og, "occupancy_fraction",
                        lambda grid: real(grid) + 0.0 * real(grid).item())
    with pytest.raises(RuntimeError):
        _train_run(_graph_cfg(n_iters=40), cuda, graphs=None)


def test_failed_capture_leaves_cuda_usable(cuda, monkeypatch):
    """After a failed capture (StepGraph ends the capture state of torch's
    default CUDA generator and of the state's) the process goes on: a
    default-initialized CUDA module builds, torch.rand draws on the card,
    the state's generator draws what it would have drawn had no capture
    been tried, the launch counts are those before the capture, and a
    later capture replays."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.ops.kernels import launch_counts
    from fsnerf_tpu_torch.train.step import (init_state, make_optimizer,
                                             make_train_step)

    cfg = _graph_cfg(n_iters=40)
    scene = SphereScene(n_imgs=cfg.data.n_imgs, hw=48, white_bkgd=True)
    model = make_model(cfg, torch.bfloat16, torch.Generator().manual_seed(0),
                       cuda)
    state = init_state(model, cfg, make_optimizer(cfg, model), scene.aabb,
                       cuda)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=cuda)
    step = make_train_step(model, cfg, state.optimizer, pool, scene)
    real = og.occupancy_fraction
    monkeypatch.setattr(og, "occupancy_fraction",
                        lambda grid: real(grid) + 0.0 * real(grid).item())
    for _ in range(2):                      # steps 0 (an all-cell
        step.replay(state)                  # refresh) and 1 (none): the
    ref = torch.Generator(device=cuda)      # kinds' eager warm-ups
    ref.set_state(state.generator.get_state())
    before = launch_counts()
    with pytest.raises(RuntimeError):
        step.replay(state)                  # step 2: none's capture
    assert launch_counts() == before and state.step == 2
    monkeypatch.setattr(og, "occupancy_fraction", real)
    torch.nn.Linear(8, 8, device=cuda)
    assert torch.rand(4, device=cuda).shape == (4,)
    assert torch.equal(torch.rand(64, device=cuda, generator=state.generator),
                       torch.rand(64, device=cuda, generator=ref))
    step.release()
    for _ in range(2):                      # steps 2, 3: warm-up, capture
        metrics = step.replay(state)
    torch.cuda.synchronize()
    assert list(step.graphs) == [step.kind(3)]
    assert torch.isfinite(metrics["loss"])


def test_graphed_fewshot_recipe_and_resume(cuda, tmp_path):
    """The few-shot recipe graphed (FreeNeRF anneal with the culling hold,
    the weight term's gate at step 150, the occlusion term, validation
    every 100, a checkpoint every 150) against the eager run, bitwise,
    validations included; then the run resumed from its step-150
    checkpoint, graphed, lands bitwise on the unbroken run."""
    import dataclasses

    from fsnerf_tpu_torch import cli
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.synthetic import LatticeScene
    from fsnerf_tpu_torch.train.step import init_state, make_optimizer
    from fsnerf_tpu_torch.utils.checkpoint import Checkpointer

    cfg = _graph_cfg(occ_a=0.003, occ_b=2.0, occ_func="exp", beta=1.0,
                     ao=1e-6, Td=300, val=True, val_rate=100,
                     ckpt_every=150)
    cfg = cfg.replace(encoder=dataclasses.replace(cfg.encoder,
                                                  freq_reg_end=100),
                      data=dataclasses.replace(cfg.data, dataset="lattice",
                                               n_imgs=3))
    scene = LatticeScene(n_imgs=3, hw=48, white_bkgd=True)
    held = cli.split_of(scene.holdout(n=1, seed=5))
    runs = {}
    for name, graphs in (("graphed", None), ("eager", False)):
        model = make_model(cfg, torch.bfloat16,
                           torch.Generator().manual_seed(0), cuda)
        ckpt = Checkpointer(str(tmp_path / name))
        runs[name] = _train_run(
            cfg, cuda, graphs, scene=scene, model=model, checkpointer=ckpt,
            val_fn=cli.make_val_fn(model, cfg, held, cuda)) + (ckpt,)
    (g, g_logs, g_launches, ckpt), (e, e_logs, e_launches, _) = (
        runs["graphed"], runs["eager"])
    _assert_bitwise(g, e)
    assert g_logs == e_logs and g_launches == e_launches
    assert [r["step"] for r in g_logs if "val_psnr" in r] == [100, 200, 300]
    assert ckpt.steps() == [150, 300]

    import os
    os.remove(ckpt.path(300))
    model = make_model(cfg, torch.bfloat16,
                       torch.Generator().manual_seed(0), cuda)
    state = ckpt.restore(init_state(model, cfg, make_optimizer(cfg, model),
                                    scene.aabb, cuda))
    assert state.step == int(state.step_t) == 150
    r, _, _ = _train_run(cfg, cuda, None, scene=scene, model=model,
                         state=state, checkpointer=ckpt,
                         val_fn=cli.make_val_fn(model, cfg, held, cuda))
    _assert_bitwise(r, g)


def test_graphed_train_scanned_is_the_eager_one(cuda):
    """train_scanned: 5 chunks of 60 steps graphed against eager, bitwise,
    its on_chunk metrics equal."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images
    from fsnerf_tpu_torch.data.synthetic import SphereScene
    from fsnerf_tpu_torch.train.loop import train_scanned

    cfg = _graph_cfg()
    scene = SphereScene(n_imgs=4, hw=48, white_bkgd=True)
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf, device=cuda)
    out = {}
    for graphs in (None, False):
        model = make_model(cfg, torch.bfloat16,
                           torch.Generator().manual_seed(0), cuda)
        seen = []
        state = train_scanned(model, cfg, pool, scene, chunk=60,
                              graphs=graphs, on_chunk=lambda c, s, m:
                              seen.append({k: float(v)
                                           for k, v in m.items()}))
        torch.cuda.synchronize()
        out[graphs] = (state, seen)
    _assert_bitwise(out[None][0], out[False][0])
    assert out[None][1] == out[False][1] and len(out[None][1]) == 5


@pytest.mark.parametrize("model", ["nerf", "sinerf", "nerf700",
                                   "sinerf700"])
def test_export_roundtrip_on_the_card(cuda, tmp_path, model):
    """The serving artifact (utils/export.py) exported on the card, saved
    and loaded: the saved graph calls the kernel's op, the program
    reproduces the live chunk renderer bitwise, and render_frame_exported
    reproduces render_frame bitwise, with one launch of the forward MLP
    (NeRF) or the SIREN forward (SiNeRF) per chunk replayed (at width 700
    their streamed instances at 768, through the op's fake when traced and
    its CUDA kernel when replayed); an encoding the NeRF kernel refuses
    (43 bands) fails at export."""
    from fsnerf_tpu_torch.ops import occgrid as og
    from fsnerf_tpu_torch.render.renderer import (make_chunk_renderer,
                                                  render_frame)
    from fsnerf_tpu_torch.utils import export
    from torch_parity import AABB, shell_rays, sphere_density_torch

    if not model.startswith("sinerf"):
        width = 700 if model == "nerf700" else 64
        sd = state_dict_from_jax(nerf_params_np(3, d_filter=width, **SMALL))
        sd["sigma.bias"] = sd["sigma.bias"] + 10.0
        model_fn = km.make_fused_model_fn(sd, **SMALL, device=cuda)
        wrapper, op = km.nerf_mlp, "fsnerf_torch.nerf_mlp.default"
    else:
        sd = state_dict_from_jax(sinerf_params_np(
            3, width=700 if model == "sinerf700" else 64))
        model_fn = ks.make_siren_forward_fn(sd, 4, device=cuda)
        wrapper, op = ks.siren_mlp_fwd, "fsnerf_torch.siren_mlp_fwd.default"
    grid = og.update(og.create(AABB, resolution=16, levels=1, device=cuda),
                     sphere_density_torch, 0)
    kw = dict(grid=grid, n_samples=32, render_step_size=0.1,
              white_bkgd=True, n_compact=16, near=2.0, far=6.0)
    live = make_chunk_renderer(model_fn, **kw)
    hwf, chunk = (24, 20, 30.0), 128
    path = export.export_render_artifact(live, chunk, str(tmp_path / "a"),
                                         hwf=hwf, near=2.0, far=6.0)
    calls = {str(n.target) for m in torch.export.load(
        str(tmp_path / "a" / "renderer.pt2")).graph_module.modules()
        if isinstance(m, torch.fx.GraphModule)
        for n in m.graph.nodes if n.op == "call_function"}
    assert op in calls
    fn, meta = export.load_render_artifact(path)
    assert meta["platforms"] == ["cuda"]
    assert meta["device_name"] == torch.cuda.get_device_name(cuda)
    ro, rd = (torch.from_numpy(a).to(cuda) for a in shell_rays(chunk, 5))
    want = live(ro, rd)
    before = wrapper.launches
    got = fn(ro, rd)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(got, want))

    pose = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.0, 0.6, -0.8, -3.2],
                         [0.0, 0.8, 0.6, 2.4], [0.0, 0.0, 0.0, 1.0]])
    before = wrapper.launches
    rgb, depth = export.render_frame_exported((fn, meta), pose.numpy())
    n_chunks = -(-hwf[0] * hwf[1] // chunk)
    assert wrapper.launches == before + n_chunks
    rgb_ref, depth_ref = render_frame(None, pose.to(cuda), hwf, 2.0, 6.0,
                                      chunksize=chunk, chunk_renderer=live)
    assert (rgb == rgb_ref.cpu().numpy()).all()
    assert (depth == depth_ref.cpu().numpy()).all()
    if model == "nerf":
        arch43 = dict(SMALL, n_freqs=43)
        sd43 = state_dict_from_jax(nerf_params_np(3, **arch43))
        wide = make_chunk_renderer(
            km.make_fused_model_fn(sd43, **arch43, device=cuda), **kw)
        with pytest.raises(Exception, match="encodings up to 256"):
            export.export_render_artifact(wide, chunk, str(tmp_path / "b"),
                                          hwf=hwf, near=2.0, far=6.0)
