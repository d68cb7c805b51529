"""The occupancy-grid sampler and the volume rendering in plain torch: the
reference's own code for what the port's renderer, grid and compaction
compute. Nothing here imports the port.

The semantics are those of nerfacc's OccGridEstimator as the JAX package
and the port define them (one grid level):

* lattice: n samples at t_min + (i + u) dt inside the ray's box
  intersection, dt = (t_max - t_min) / n, or the step size where the
  segment is shorter than n steps (samples past t_max invalid);
* grid query: the finest cell holding a point; occupied where its table
  value exceeds the threshold. The occupancy table is the EMA max-pooled
  over (2r + 1)^3 cells (r the query dilation) and nudged one bf16 step
  up, the optical-depth table the EMA min-pooled over radius r + 1 with
  empty cells outside the volume, nudged one bf16 step down, and 0 where
  its z window leaves the volume. A query answers for the group of
  `stride` samples around it;
* early stop: a sample is dropped once the table's optical depth before
  it puts the transmittance at or under eps;
* compaction: a ray with more than k surviving samples keeps k of them
  evenly spaced in rank, each standing for n_valid / k steps; otherwise
  it keeps them all;
* compositing: w_i = T_i (1 - exp(-sigma_i delta_i)), T the transmittance
  before the sample, rgb = sum w c + T_final * background, depth =
  sum w t.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


class _RoundFP8(torch.autograd.Function):
    """x rounded to float8 e4m3 under a per-tensor scale (the largest
    |x| maps to the format's largest value), its cotangent rounded alike."""

    @staticmethod
    def _round(x):
        amax = x.detach().abs().amax()
        if not torch.isfinite(amax) or amax == 0:
            return x
        s = FP8_MAX / amax
        return (x * s).to(FP8).to(x.dtype) / s

    @staticmethod
    def forward(ctx, x):
        return _RoundFP8._round(x)

    @staticmethod
    def backward(ctx, g):
        return _RoundFP8._round(g)


class Quant:
    """The precision a reference matmul reads its operands in: "float32"
    (as given) or "float8" (the control)."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "float8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.precision == "float32" else _RoundFP8.apply(x)


def pixel_rays(pose: torch.Tensor, hwf, pix: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Origins and unit directions [N, 3] of pixels `pix` (row-major
    indices) of one camera."""
    H, W, f = hwf
    j = torch.div(pix, W, rounding_mode="floor").to(torch.float32)
    i = (pix % W).to(torch.float32)
    d = torch.stack([(i - W * 0.5) / f, -(j - H * 0.5) / f,
                     -torch.ones_like(i)], dim=-1)
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    d = torch.sum(d[:, None, :] * pose[:3, :3], dim=-1)
    return pose[:3, 3].expand(d.shape), d


def query_plan(aabb, res: int, step: float, n_samples: int,
               max_stride: int = 8) -> Tuple[int, int]:
    """(stride, dilation) of the grid queries: the largest stride, up to
    max_stride and dividing n_samples, at which a dilated table cannot
    miss an occupied cell, over dilations 0, 1, 2 (the smaller on a tie)."""
    ab = np.asarray(aabb, np.float64)
    ext = ab[3:] - ab[:3]
    cell = float(ext.min()) / res
    dt_max = max(step, float(np.linalg.norm(ext)) / n_samples)
    best = (0, 0)
    for r in (0, 1, 2):
        s = 1
        while s * 2 <= max_stride and n_samples % (s * 2) == 0 and (
                (s * dt_max <= r * cell) if r else (cell >= 2 * s * dt_max)):
            s *= 2
        if s > best[0]:
            best = (s, r)
    return best


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def tables(occs: torch.Tensor, res: int, r: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(occupancy table, optical-depth table) [res^3] of one level's EMA
    values [res^3] (flat index (ix * res + iy) * res + iz)."""
    v = occs.reshape(1, 1, res, res, res)
    if r > 0:
        v = F.max_pool3d(v, (2 * r + 1, 2 * r + 1, 1), 1, (r, r, 0))
    occ = _bf16(v * (1.0 + 2.0 ** -8))
    if r > 0:
        occ = F.max_pool3d(occ, (1, 1, 2 * r + 1), 1, (0, 0, r))
    e = r + 1
    pad = F.pad(occs.reshape(1, 1, res, res, res), (0, 0, e, e, e, e),
                value=0.0)
    ero = -F.max_pool3d(-pad, (2 * e + 1, 2 * e + 1, 1), 1)
    ero = _bf16(ero * (1.0 - 2.0 ** -8))
    ero = -F.max_pool3d(-ero, (1, 1, 2 * e + 1), 1, (0, 0, e))
    iz = torch.arange(res, device=occs.device)
    ero = torch.where((iz < e) | (iz >= res - e), 0.0, ero)
    return occ.reshape(-1), ero.reshape(-1)


def cell_of(x: torch.Tensor, aabb: torch.Tensor, res: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(flat cell index, inside the box) of points [..., 3]."""
    lo, hi = aabb[:3], aabb[3:]
    u = (x - lo) / (hi - lo)
    inside = torch.all((u >= 0.0) & (u < 1.0), dim=-1)
    ijk = torch.clamp((u * res).to(torch.int32), 0, res - 1).long()
    return (ijk[..., 0] * res + ijk[..., 1]) * res + ijk[..., 2], inside


def lattice(o, d, aabb, n: int, step: float, u: torch.Tensor):
    """(t [R, n], dt [R], in-box [R, n]) of the sample lattice; u [R, 1]
    the per-ray phase."""
    safe = torch.where(d.abs() > 1e-10, d, torch.where(d >= 0, 1e-10, -1e-10))
    t0, t1 = (aabb[:3] - o) / safe, (aabb[3:] - o) / safe
    t_min = torch.clamp(torch.minimum(t0, t1).amax(-1), min=0.0)
    t_max = torch.clamp(torch.maximum(t0, t1).amin(-1), max=1e10)
    hit = t_min < t_max
    t_min = torch.where(hit, t_min, 0.0)
    t_max = torch.where(hit, t_max, 1.0)
    seg = t_max - t_min
    dt = torch.where(seg > n * step, seg / n, torch.full_like(seg, step))
    i = torch.arange(n, dtype=torch.float32, device=o.device)
    t = t_min[:, None] + (i + u) * dt[:, None]
    return t, dt, hit[:, None] & (t < t_max[:, None])


def surviving(o, d, t, dt, inbox, grid: dict, step: float, stride: int,
              eps: float) -> torch.Tensor:
    """[R, n] samples that pass the grid and the early stop."""
    R, n = t.shape
    tq = t[:, stride // 2::stride]
    cell, inside = cell_of(o[:, None] + d[:, None] * tq[..., None],
                           grid["aabb"], grid["res"])
    occ = (grid["occ"][cell] > grid["thre"]) & inside
    od = torch.where(inside, grid["od"][cell], 0.0)
    occ = occ.repeat_interleave(stride, dim=1)
    od = od.repeat_interleave(stride, dim=1)
    od = torch.where(inbox, od * (dt[:, None] / step), 0.0)
    before = torch.cumsum(od, dim=-1) - od
    return inbox & occ & (torch.exp(-before) > eps)


def compact(t, dt, mask, k: int):
    """(t [R, k], delta [R, k], mask [R, k]) of each ray's kept samples."""
    R, n = t.shape
    nv = mask.sum(-1, keepdim=True)
    rank = torch.cumsum(mask.to(torch.int64), -1) - 1
    nvs = torch.clamp(nv, min=1)
    keep = mask & ((rank * k) // nvs > ((rank - 1) * k) // nvs)
    slot = torch.where(keep, torch.cumsum(keep.to(torch.int64), -1) - 1, k)
    out = torch.zeros((R, k + 1), device=t.device)
    out.scatter_(1, slot, t)
    t_k = out[:, :k]
    mask_k = torch.arange(k, device=t.device)[None, :] < torch.clamp(nv, max=k)
    delta = (dt[:, None] * torch.clamp(nv.to(torch.float32) / k, min=1.0)
             ).expand(R, k)
    return torch.where(mask_k, t_k, 0.0), delta, mask_k


def composite(sigma, rgb, t, delta, mask, bkgd: float):
    """(rgb [R, 3], depth [R]) of samples [R, S]."""
    od = torch.where(mask, sigma * delta, 0.0)
    cum = torch.cumsum(od, dim=-1)
    w = torch.exp(-(cum - od)) * (1.0 - torch.exp(-od))
    color = (w[..., None] * rgb).sum(1) + torch.exp(-cum[:, -1:]) * bkgd
    return color, (w * t).sum(-1)


def ladder_target(nv_mean: float, k_max: int, margin: float) -> int:
    """The compaction K for a mean surviving-sample count: the count
    rounded up to a multiple of 16, within [16, k_max]."""
    k = int(math.ceil(margin * max(nv_mean, 1.0) / 16.0)) * 16
    return min(max(k, 16), k_max)
