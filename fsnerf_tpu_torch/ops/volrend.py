"""Volume integration in exp/cumsum form (port of fsnerf_tpu/ops/volrend.py).

    alpha_i = 1 - exp(-sigma_i * delta_i)
    T_i     = exp(-sum_{j<i} sigma_j * delta_j)
    w_i     = T_i * alpha_i

Masked samples contribute zero optical depth, so an all-masked ray
composites to pure background with well-defined gradients. This is the
training loss's compositing (autograd) and the plain version of the
forward-only compositing kernel, ops/kernels/volrend.py::
volume_render_fused, which evaluation uses; the fused ray march composites
inside its own kernel (ops/kernels/render.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def render_weights(
    sigmas: torch.Tensor,
    deltas: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compositing weights [R, S] and trans_final [R] from raw densities."""
    od = sigmas * deltas
    if mask is not None:
        od = torch.where(mask, od, 0.0)
    alpha = 1.0 - torch.exp(-od)
    cum = torch.cumsum(od, dim=-1)
    trans = torch.exp(-(cum - od))
    return trans * alpha, torch.exp(-cum[..., -1])


def composite(
    weights: torch.Tensor,
    rgbs: torch.Tensor,
    t_vals: torch.Tensor,
    trans_final: torch.Tensor,
    bkgd=0.0,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """rgb [R, 3] (+ trans_final * bkgd), opacity [R], depth [R]."""
    rgb = torch.einsum("rs,rsc->rc", weights, rgbs)
    opacity = torch.sum(weights, dim=-1)
    depth = torch.sum(weights * t_vals, dim=-1)
    bkgd = torch.as_tensor(bkgd, dtype=rgb.dtype, device=rgb.device)
    return rgb + trans_final[:, None] * bkgd, opacity, depth


def volume_render(
    sigmas: torch.Tensor,
    rgbs: torch.Tensor,
    t_vals: torch.Tensor,
    deltas: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    bkgd=0.0,
) -> dict:
    """dict(rgb [R,3], opacity [R], depth [R], weights [R,S],
    trans_final [R])."""
    weights, trans_final = render_weights(sigmas, deltas, mask)
    rgb, opacity, depth = composite(weights, rgbs, t_vals, trans_final, bkgd)
    return {"rgb": rgb, "opacity": opacity, "depth": depth,
            "weights": weights, "trans_final": trans_final}
