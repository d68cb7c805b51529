"""The CUDA kernels of fsnerf_tpu_torch/csrc against their plain PyTorch
versions, on an NVIDIA card.

Ray march (render.cu): rgb/opacity within 7e-3, depth within 3e-2, equal
executed-step counts. Forward MLP (mlp.cu): rgb within 5e-3 and sigma
within 2e-2 of max |sigma| (tests/test_pallas.py's fused-MLP tolerances),
for the three density activations and a row count that is not a multiple
of the 128-row tile; two runs bitwise equal. Train forward/backward (mlp_train.cu): rgb within
5e-3 and sigma within 2e-2 of max |sigma| (the fused-MLP tolerances of
tests/test_pallas.py), every weight and bias gradient within 2e-2 of that
tensor's max |plain gradient| (the kernels sum in another order, and each
cotangent is rounded to bf16 before its products, so a rounding flip can
move a gradient by a bf16 step); gradients bitwise repeatable and bitwise
equal between the saved-activations and recompute backwards.

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
from fsnerf_tpu_torch.utils.interop import state_dict_from_jax
from torch_parity import (march_inputs, mlp_inputs, mse_cotangent,
                          nerf_params_np)

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
