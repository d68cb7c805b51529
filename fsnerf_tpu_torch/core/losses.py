"""Losses and few-shot regularizers (port of fsnerf_tpu/core/losses.py).

  * MSE and PSNR = -10 log10(mse).
  * Occlusion regularizer: mean over rays with at least one valid sample of
    sum_s w(t_s) * sigma_s, with w linear (-a t + b) or exp (a e^{-b t}).
  * Weight regularizer: sum of |W|_1 (or of per-matrix Frobenius norms for
    'l2') over weight matrices with output dim > 3 (not the rgb/sigma
    heads). Torch weights are [out, in], so the output dim is shape[0].
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import torch


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(pred - target))


def psnr_from_mse(m: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(m)


def occlusion_reg(
    sigmas: torch.Tensor,
    t_vals: torch.Tensor,
    mask: Optional[torch.Tensor],
    a: float,
    b: float,
    func: str = "linear",
) -> torch.Tensor:
    """Near-camera density penalty over [R, S] sigmas / depths / validity
    (mask None = all valid)."""
    if func == "linear":
        w = -a * t_vals + b
    elif func == "exp":
        w = a * torch.exp(-b * t_vals)
    else:
        raise ValueError(f"Unknown occlusion regularizer type: {func}")
    contrib = w * sigmas
    if mask is not None:
        contrib = torch.where(mask, contrib, 0.0)
        ray_has = torch.any(mask, dim=-1)
    else:
        ray_has = torch.ones(sigmas.shape[:-1], dtype=torch.bool,
                             device=sigmas.device)
    per_ray = torch.sum(contrib, dim=-1)
    n = torch.clamp(torch.sum(ray_has.to(torch.float32)), min=1.0)
    return torch.sum(torch.where(ray_has, per_ray, 0.0)) / n


def weight_reg(named_params: Iterable[Tuple[str, torch.Tensor]],
               norm: str = "l1") -> torch.Tensor:
    """Norm over `*.weight` matrices whose output dim (shape[0]) is > 3."""
    terms = [torch.sum(torch.abs(p)) if norm == "l1"
             else torch.sqrt(torch.sum(torch.square(p)))
             for name, p in named_params
             if name.endswith("weight") and p.ndim == 2 and p.shape[0] > 3]
    if not terms:
        return torch.zeros(())
    total = terms[0]
    for v in terms[1:]:
        total = total + v
    return total
