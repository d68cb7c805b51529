"""Forward volume compositing over precomputed densities and colours: the
CUDA kernel's wrapper (port of fsnerf_tpu/ops/pallas/volrend.py::
volume_render_pallas). Its plain version is ops/volrend.py::volume_render,
the autograd compositing of the training loss.

`volume_render_fused` launches csrc/volrend.cu for CUDA tensors and runs
`volume_render` only for CPU tensors. It is forward-only: the renderers
take it as their `composite_fn` for evaluation, never inside the loss.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..volrend import volume_render


def _per_sample(a: torch.Tensor, n_inner: int):
    """(tensor, stride): `a` [R, S, *inner] read as sample (r, s) at element
    (r S + s) * stride, its n_inner trailing elements contiguous; a
    contiguous copy where `a` is not laid out so (the [R, S, 4] output of
    the MLP is, for its rgb and sigma views)."""
    R, S = a.shape[:2]
    st = a.stride()
    inner_ok = a.dim() == 2 or st[2] == 1
    if R > 1 and S > 1 and inner_ok and st[1] >= n_inner and \
            st[0] == S * st[1]:
        return a, st[1]
    a = a.contiguous()
    return a, n_inner


def volume_render_fused(
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    t_vals: torch.Tensor,
    deltas: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    bkgd=0.0,
) -> dict:
    """Drop-in for ops/volrend.py::volume_render, forward only: sigmas,
    t_vals, deltas [R, S] and rgbs [R, S, 3] float32, optional bool mask
    [R, S], scalar or [3] bkgd -> dict(rgb [R, 3], opacity [R], depth [R],
    weights [R, S], trans_final [R]). Counts its kernel launches in
    `volume_render_fused.launches`."""
    if sigmas.device.type == "cpu":
        return volume_render(sigmas, rgbs, t_vals, deltas, mask, bkgd)
    if sigmas.device.type != "cuda":
        raise ValueError(f"volume_render_fused runs on cpu or cuda, not "
                         f"{sigmas.device}")
    R, S = sigmas.shape
    if S == 0:
        raise ValueError("volume_render_fused needs at least one sample")
    for name, a, shape in (("rgbs", rgbs, (R, S, 3)), ("t_vals", t_vals,
                                                       (R, S)),
                           ("deltas", deltas, (R, S))):
        if tuple(a.shape) != shape or a.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 {shape}, got {a.dtype} "
                             f"{tuple(a.shape)}")
    if sigmas.dtype != torch.float32:
        raise ValueError(f"sigmas: want float32, got {sigmas.dtype}")
    if mask is not None and (tuple(mask.shape) != (R, S)
                             or mask.dtype != torch.bool):
        raise ValueError(f"mask: want bool {(R, S)}, got {mask.dtype} "
                         f"{tuple(mask.shape)}")
    tensors = [sigmas, rgbs, t_vals, deltas] + ([] if mask is None
                                                else [mask])
    if any(a.device != sigmas.device for a in tensors):
        raise ValueError("volume_render_fused needs its tensors on one "
                         "device")
    sig, sig_stride = _per_sample(sigmas, 1)
    rgb, rgb_stride = _per_sample(rgbs, 3)
    t_vals, deltas = t_vals.contiguous(), deltas.contiguous()
    if mask is not None:
        mask = mask.contiguous()
    dev = sigmas.device
    stats = torch.empty((R, 8), dtype=torch.float32, device=dev)
    weights = torch.empty((R, S), dtype=torch.float32, device=dev)
    if R:
        from .build import load_library

        lib = load_library()
        err = lib.fsnerf_volrend(
            sig.data_ptr(), sig_stride, rgb.data_ptr(), rgb_stride,
            t_vals.data_ptr(), deltas.data_ptr(),
            None if mask is None else mask.data_ptr(), stats.data_ptr(),
            weights.data_ptr(), R, S,
            torch.cuda.current_stream(dev).cuda_stream)
        if err:
            raise RuntimeError("volrend kernel launch failed: "
                               + lib.fsnerf_error_string(err).decode())
        volume_render_fused.launches += 1
    trans_final = stats[:, 5]
    bkgd = torch.as_tensor(bkgd, dtype=torch.float32, device=dev)
    return {"rgb": stats[:, :3] + trans_final[:, None] * bkgd,
            "opacity": stats[:, 3],
            "depth": stats[:, 4],
            "weights": weights,
            "trans_final": trans_final}


volume_render_fused.launches = 0
