"""Forward NeRF MLP on pre-encoded features: the CUDA kernels' wrappers,
their plain PyTorch versions and the drop-ins built on them (port of
fsnerf_tpu/ops/pallas/mlp.py::prep_params, fused_nerf_mlp,
make_fused_model_fn, fused_density and make_fused_density_fn).

Inputs are the positional encodings of the points and the view directions
in the reference layout [v, sin f0 v, cos f0 v, ...], computed in float32
by core/encoding.py (exact sin/cos, FreeNeRF band mask applied), cast to
bf16 and zero-padded to round_up(d_enc, 64) / round_up(d_dir, 32) columns.
The MLP runs with bf16 operands and f32 accumulation: the skip layer as
W_h h + W_e enc, bias (bf16-rounded) added in f32, ReLU, round to bf16 for
every trunk layer; sigma raw, ReLU or exp(clip(., -15, 15)); feat =
bf16(connection + bias) without activation; branch ReLU then bf16; rgb an
f32 sigmoid. Out [N, 4] float32 = rgb, sigma.

The density pass (`nerf_density`, the occupancy grid refresh's workload)
runs the trunk and the sigma head alone, with the same numerics, on the
positional encodings only. Both kernels are the warp-specialized MLP of
csrc/ws_trunk.cuh, built for the widths render.py::NERF_KERNEL_WIDTHS and
the streamed widths (a module's width is packed at the next of them,
render.py::nerf_kernel_width; 384 and 512 run the column-split trunk, 768
and every multiple of 256 above the streamed trunk, with a scratch the
wrappers allocate) and encodings and packed weights as
render.py::kernel_arch_error takes them.

`nerf_mlp` / `nerf_density` launch csrc/mlp.cu for CUDA tensors and run
`nerf_mlp_reference` / `nerf_density_reference` only for CPU tensors.
`nerf_mlp` does so as the registered op fsnerf_torch::nerf_mlp (a CPU
kernel, a CUDA kernel and a fake for tracing), which a torch.export
program keeps as a call (utils/export.py).
Weights travel packed in the ray march's walk order (render.py::
pack_weights), packed on the state dict's own device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import torch

from ...core.encoding import encoded_dim, positional_encoding
from .render import (_DENSITY_ACT, _ptr, _round_up, kernel_arch_error,
                     mlp_forward, nerf_kernel_width, pack_weights,
                     sigma_head, stream_scratch, trunk_forward, trunk_rows,
                     unpack)

@dataclass(frozen=True)
class MlpParams:
    """NeRF weights packed for nerf_mlp: wpack (bf16) and bpack (float32
    holding bf16-rounded values) as render.py::pack_weights, at the packed
    width `width` (render.py::nerf_kernel_width of the module's), with the
    encoding rows zero-padded to d_enc_pad / d_dir_pad."""

    wpack: torch.Tensor
    bpack: torch.Tensor
    n_layers: int
    skip: Tuple[int, ...]
    width: int
    d_enc: int
    d_dir: int
    d_enc_pad: int
    d_dir_pad: int
    model_width: Optional[int] = None      # the module's (None: width)

    @property
    def skip_mask(self) -> int:
        """Bit i set: trunk layer i takes the skip concat [h, enc]."""
        return sum(1 << i for i in range(1, self.n_layers)
                   if (i - 1) in self.skip)

    def to(self, device) -> "MlpParams":
        return replace(self, wpack=self.wpack.to(device),
                       bpack=self.bpack.to(device))


def prep_params(state_dict: Dict[str, torch.Tensor], n_layers: int = 8,
                skip: Sequence[int] = (4,), device=None) -> MlpParams:
    """Pack a reference-keyed NeRF state dict (core/models.py) for
    nerf_mlp and nerf_density, on the state dict's own device (no host
    round trip), then move it to `device` when one is given."""
    skip = tuple(skip)
    if skip and max(skip) >= n_layers - 1:
        raise ValueError(
            "the fused MLP needs the skip concat to feed a TRUNK layer "
            f"(skip {skip} with n_layers {n_layers} would feed the heads)")
    sd = {k: v.detach().to(torch.float32) for k, v in state_dict.items()}
    W = sd["layers.0.weight"].shape[0]
    d_enc = sd["layers.0.weight"].shape[1]
    d_dir = sd["branch.weight"].shape[1] - W
    de, dd = _round_up(d_enc, 64), _round_up(d_dir, 32)
    wpack, bpack = pack_weights(sd, n_layers, skip, de, dd)
    return MlpParams(wpack, bpack, n_layers, skip, nerf_kernel_width(W, dd),
                     d_enc, d_dir, de, dd, W).to(device)


def pad_features(feat: torch.Tensor, d_pad: int) -> torch.Tensor:
    """[N, d] float features -> [N, d_pad] bf16, zero-padded, contiguous."""
    out = torch.zeros((feat.shape[0], d_pad), dtype=torch.bfloat16,
                      device=feat.device)
    out[:, :feat.shape[1]] = feat.to(torch.bfloat16)
    return out


def _check(encx, encd, params: MlpParams, density_activation: str):
    """encd None: the density pass, which takes no view input."""
    N = encx.shape[0]
    for name, a, shape in (("encx", encx, (N, params.d_enc_pad)),
                           ("encd", encd, (N, params.d_dir_pad))):
        if a is None:
            continue
        if tuple(a.shape) != shape or a.dtype != torch.bfloat16:
            raise ValueError(f"{name}: want bfloat16 {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    if density_activation not in _DENSITY_ACT:
        raise ValueError(f"Unknown density activation: {density_activation}")


def nerf_mlp_reference(encx, encd, params: MlpParams,
                       density_activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version of the fused MLP kernel, step for step as
    fsnerf_tpu/ops/pallas/mlp.py::_kernel_body: f32 matmuls of bf16
    operands, bf16 rounding where the kernel rounds.

    Args: encx [N, d_enc_pad], encd [N, d_dir_pad] bf16 (pad_features);
    params from prep_params. Returns [N, 4] float32 (rgb, sigma)."""
    _check(encx, encd, params, density_activation)
    unpacked = unpack(params.wpack.to(torch.float32), params.bpack,
                      params.n_layers, params.skip, params.width,
                      params.d_enc_pad, params.d_dir_pad)
    rgb, sigma = mlp_forward(encx.to(torch.float32), encd.to(torch.float32),
                             density_activation, unpacked)
    return torch.cat([rgb, sigma[:, None]], dim=-1)


def nerf_mlp(encx, encd, params: MlpParams,
             density_activation: str = "none") -> torch.Tensor:
    """The fused MLP: csrc/mlp.cu's nerf_mlp_kernel for CUDA tensors
    (packed widths render.py::NERF_KERNEL_WIDTHS, d_enc_pad and d_dir_pad
    as kernel_arch_error takes them: ValueError otherwise),
    nerf_mlp_reference for CPU tensors; same arguments and return. Any N:
    the kernel predicates the rows of its last 128-row (64-row from 384
    up) tile. Counts its kernel launches in `nerf_mlp.launches`.

    Both run as the registered op `torch.ops.fsnerf_torch.nerf_mlp`, so a
    program that torch.export traces through this call keeps the call (the
    serving artifact, utils/export.py)."""
    if encx.device.type not in ("cpu", "cuda"):
        raise ValueError(f"nerf_mlp runs on cpu or cuda, not {encx.device}")
    return torch.ops.fsnerf_torch.nerf_mlp(
        encx, encd, params.wpack, params.bpack, params.n_layers,
        params.skip_mask, params.width, params.d_enc_pad, params.d_dir_pad,
        density_activation)


nerf_mlp.launches = 0


def _op_params(wpack, bpack, n_layers: int, skip_mask: int, width: int,
               d_enc_pad: int, d_dir_pad: int) -> MlpParams:
    """MlpParams from the op's arguments (d_enc and d_dir, which neither
    the kernel nor the plain version reads, set to the padded widths)."""
    skip = tuple(i - 1 for i in range(1, n_layers) if skip_mask >> i & 1)
    return MlpParams(wpack, bpack, n_layers, skip, width, d_enc_pad,
                     d_dir_pad, d_enc_pad, d_dir_pad)


@torch.library.custom_op("fsnerf_torch::nerf_mlp", mutates_args=(),
                         device_types="cpu")
def _nerf_mlp_op(encx: torch.Tensor, encd: torch.Tensor,
                 wpack: torch.Tensor, bpack: torch.Tensor, n_layers: int,
                 skip_mask: int, width: int, d_enc_pad: int, d_dir_pad: int,
                 density_activation: str) -> torch.Tensor:
    """CPU tensors: the plain version."""
    return nerf_mlp_reference(
        encx, encd, _op_params(wpack, bpack, n_layers, skip_mask, width,
                               d_enc_pad, d_dir_pad), density_activation)


@_nerf_mlp_op.register_kernel("cuda")
def _nerf_mlp_cuda(encx, encd, wpack, bpack, n_layers, skip_mask, width,
                   d_enc_pad, d_dir_pad, density_activation):
    """CUDA tensors: one launch of nerf_mlp_kernel."""
    params = _op_params(wpack, bpack, n_layers, skip_mask, width, d_enc_pad,
                        d_dir_pad)
    _check_cuda(encx, encd, params, density_activation)
    from .build import load_library

    lib = load_library()
    N = encx.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=encx.device)
    slab, ctas = stream_scratch(width, encx.device)
    err = lib.fsnerf_nerf_mlp(
        encx.data_ptr(), encd.data_ptr(), wpack.data_ptr(), bpack.data_ptr(),
        out.data_ptr(), _ptr(slab), ctas, N, n_layers, skip_mask, width,
        d_enc_pad, d_dir_pad,
        _DENSITY_ACT[density_activation],
        trunk_rows(n_layers, params.skip, width, d_enc_pad),
        torch.cuda.current_stream(encx.device).cuda_stream)
    if err:
        raise RuntimeError("nerf_mlp kernel launch failed: "
                           + lib.fsnerf_error_string(err).decode())
    nerf_mlp.launches += 1
    return out


@_nerf_mlp_op.register_fake
def _nerf_mlp_fake(encx, encd, wpack, bpack, n_layers, skip_mask, width,
                   d_enc_pad, d_dir_pad, density_activation):
    """The output's shape, after the checks the launch makes: a width the
    kernel refuses fails when a program is traced, not when it runs."""
    params = _op_params(wpack, bpack, n_layers, skip_mask, width, d_enc_pad,
                        d_dir_pad)
    if encx.device.type == "cuda":
        _check_cuda(encx, encd, params, density_activation)
    else:
        _check(encx, encd, params, density_activation)
    return encx.new_empty((encx.shape[0], 4), dtype=torch.float32)


def _check_cuda(encx, encd, params: MlpParams, density_activation: str):
    """The kernel's checks: shapes and dtypes, a width and encodings it is
    built for, contiguous tensors on one device."""
    _check(encx, encd, params, density_activation)
    err = kernel_arch_error(params.width, params.d_enc_pad, params.d_dir_pad,
                            n_w=params.wpack.numel())
    if err is not None:
        raise ValueError(f"nerf_mlp: {err}")
    for a in (encx, encd, params.wpack, params.bpack):
        if a.device != encx.device or not a.is_contiguous():
            raise ValueError("nerf_mlp needs contiguous tensors on one "
                             "device")


def make_fused_model_fn(
    state_dict: Dict[str, torch.Tensor],
    n_layers: int = 8,
    skip: Sequence[int] = (4,),
    n_freqs: int = 10,
    n_freqs_views: int = 4,
    log_space: bool = True,
    density_activation: str = "none",
    pos_mask: Optional[torch.Tensor] = None,
    dir_mask: Optional[torch.Tensor] = None,
    device=None,
):
    """model_fn(x [..., 3], dirs [..., 3]) -> [..., 4] backed by nerf_mlp,
    interchangeable with the NeRF module for rendering (it needs dirs).
    pos_mask / dir_mask: optional FreeNeRF band masks for the encodings."""
    params = prep_params(state_dict, n_layers, skip, device)
    if (params.d_enc, params.d_dir) != (encoded_dim(3, n_freqs),
                                        encoded_dim(3, n_freqs_views)):
        raise ValueError("state dict does not match n_freqs/n_freqs_views")
    dev = params.wpack.device
    pm = None if pos_mask is None else torch.as_tensor(
        pos_mask, dtype=torch.float32, device=dev)
    dm = None if dir_mask is None else torch.as_tensor(
        dir_mask, dtype=torch.float32, device=dev)

    def model_fn(x, dirs=None):
        if dirs is None:
            raise ValueError("the fused MLP computes rgb and sigma together: "
                             "it needs view directions")
        shape = x.shape[:-1]
        encx = positional_encoding(x.reshape(-1, 3).to(torch.float32),
                                   n_freqs, log_space, pm)
        encd = positional_encoding(dirs.reshape(-1, 3).to(torch.float32),
                                   n_freqs_views, log_space, dm)
        out = nerf_mlp(pad_features(encx, params.d_enc_pad),
                       pad_features(encd, params.d_dir_pad), params,
                       density_activation)
        return out.reshape(*shape, 4)

    return model_fn


def nerf_density_reference(encx, params: MlpParams,
                           density_activation: str = "none") -> torch.Tensor:
    """Plain PyTorch version of the density kernel, step for step as
    fsnerf_tpu/ops/pallas/mlp.py::_density_kernel_body: the trunk as f32
    matmuls of bf16 operands with h rounded to bf16, sigma an f32 dot plus
    the bf16-rounded bias, raw, ReLU or exp(clip(., -15, 15)).

    Args: encx [N, d_enc_pad] bf16 (pad_features); params from
    prep_params. Returns sigma [N] float32."""
    _check(encx, None, params, density_activation)
    trunk, b_trunk, hd = unpack(params.wpack.to(torch.float32), params.bpack,
                                params.n_layers, params.skip, params.width,
                                params.d_enc_pad, params.d_dir_pad)
    h = trunk_forward(encx.to(torch.float32), trunk, b_trunk)[-1]
    return sigma_head(h, hd, density_activation)


def nerf_density(encx, params: MlpParams,
                 density_activation: str = "none") -> torch.Tensor:
    """The density pass: csrc/mlp.cu's nerf_density_kernel for CUDA tensors
    (packed widths and weights as render.py::kernel_arch_error takes
    them, d_enc_pad up to KERNEL_MAX_ENC: ValueError otherwise),
    nerf_density_reference for CPU
    tensors; same
    arguments and return. Any N. Counts its kernel launches in
    `nerf_density.launches`."""
    if encx.device.type == "cpu":
        return nerf_density_reference(encx, params, density_activation)
    if encx.device.type != "cuda":
        raise ValueError(f"nerf_density runs on cpu or cuda, not "
                         f"{encx.device}")
    _check(encx, None, params, density_activation)
    err = kernel_arch_error(params.width, params.d_enc_pad,
                            n_w=params.wpack.numel())
    if err is not None:
        raise ValueError(f"nerf_density: {err}")
    for a in (encx, params.wpack, params.bpack):
        if a.device != encx.device or not a.is_contiguous():
            raise ValueError("nerf_density needs contiguous tensors on one "
                             "device")
    from .build import load_library

    lib = load_library()
    N = encx.shape[0]
    out = torch.empty(N, dtype=torch.float32, device=encx.device)
    slab, ctas = stream_scratch(params.width, encx.device)
    err = lib.fsnerf_nerf_density(
        encx.data_ptr(), params.wpack.data_ptr(), params.bpack.data_ptr(),
        out.data_ptr(), _ptr(slab), ctas, N, params.n_layers,
        params.skip_mask, params.width,
        params.d_enc_pad, _DENSITY_ACT[density_activation],
        trunk_rows(params.n_layers, params.skip, params.width,
                   params.d_enc_pad),
        torch.cuda.current_stream(encx.device).cuda_stream)
    if err:
        raise RuntimeError("nerf_density kernel launch failed: "
                           + lib.fsnerf_error_string(err).decode())
    nerf_density.launches += 1
    return out


nerf_density.launches = 0


def make_fused_density_fn(
    state_dict: Dict[str, torch.Tensor],
    n_layers: int = 8,
    skip: Sequence[int] = (4,),
    n_freqs: int = 10,
    log_space: bool = True,
    density_activation: str = "none",
    pos_mask: Optional[torch.Tensor] = None,
    device=None,
):
    """density_fn(x [..., 3]) -> sigma [...] float32 backed by
    nerf_density: the drop-in density function of occgrid.update. The
    weights are packed once, on the state dict's device; pos_mask is the
    optional FreeNeRF band mask of the positional encoding."""
    params = prep_params(state_dict, n_layers, skip, device)
    if params.d_enc != encoded_dim(3, n_freqs):
        raise ValueError("state dict does not match n_freqs")
    pm = None if pos_mask is None else torch.as_tensor(
        pos_mask, dtype=torch.float32, device=params.wpack.device)

    def density_fn(x):
        encx = positional_encoding(x.reshape(-1, 3).to(torch.float32),
                                   n_freqs, log_space, pm)
        return nerf_density(pad_features(encx, params.d_enc_pad), params,
                            density_activation).reshape(x.shape[:-1])

    return density_fn
