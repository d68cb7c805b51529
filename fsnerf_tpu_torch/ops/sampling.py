"""Ray sampling (port of fsnerf_tpu/ops/sampling.py): dense per-ray sample
lattices and their compaction for the occgrid strategy; stratified bins and
inverse-CDF resampling for the hierarchical strategy.

Every ray gets a fixed number of samples; out-of-grid samples are masked,
not dropped. Where JAX took a PRNG key, the port takes the draws themselves
as tensors (None gives the deterministic eval-time values).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.encoding import linspace
from ..data.rays import ray_aabb_intersect


def uniform_samples(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    aabb: torch.Tensor,
    n_samples: int,
    jitter: Optional[torch.Tensor] = None,
    near: float = 0.0,
    far: float = 1e10,
    step_size: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Interval midpoints t_i = t_min + (i + u) * dt inside the ray/AABB
    intersection, dt = (t_max - t_min) / n_samples, or `step_size` when the
    segment is shorter than n_samples * step_size (samples beyond t_max are
    masked).

    jitter: [R, 1] per-ray phase u in [0, 1) (stratified marching), or None
    for u = 0.5.

    Returns t_mid [R, S], deltas [R, S], valid [R, S] bool.
    """
    R = rays_o.shape[0]
    t_min, t_max = ray_aabb_intersect(rays_o, rays_d, aabb, near, far)
    hit = t_min < t_max
    t_min = torch.where(hit, t_min, 0.0)
    t_max = torch.where(hit, t_max, 1.0)

    seg = t_max - t_min
    dt = seg / n_samples
    if step_size is not None:
        dt = torch.where(seg > n_samples * step_size, dt,
                         torch.full_like(seg, step_size))

    idx = torch.arange(n_samples, dtype=torch.float32, device=rays_o.device)
    u = (torch.full((R, 1), 0.5, device=rays_o.device) if jitter is None
         else jitter)
    t_mid = t_min[:, None] + (idx[None, :] + u) * dt[:, None]
    deltas = dt[:, None].expand(R, n_samples)
    valid = hit[:, None] & (t_mid < t_max[:, None])
    return t_mid, deltas, valid


def stratified_samples(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float,
    far: float,
    n_samples: int,
    u: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Classic-NeRF stratified sampling in [near, far]: bin i of
    linspace(near, far, S + 1) holds t = lower_i + (upper_i - lower_i) * u.

    u: [R, S] per-bin jitter in [0, 1), or None for the bin centres.
    Returns t_vals [R, S] sorted and deltas [R, S] (the last closes to far).
    """
    R = rays_o.shape[0]
    edges = linspace(near, far, n_samples + 1, rays_o.device)
    lower, upper = edges[:-1], edges[1:]
    if u is None:
        u = torch.full((R, n_samples), 0.5, device=rays_o.device)
    t_vals = lower[None, :] + (upper - lower)[None, :] * u
    return t_vals, _deltas_from_t(t_vals, far)


def _deltas_from_t(t_vals: torch.Tensor, far: float) -> torch.Tensor:
    """Forward differences of sorted t [R, S]; the last is max(far - t, 0)."""
    last = torch.clamp(far - t_vals[..., -1:], min=0.0)
    return torch.cat([torch.diff(t_vals, dim=-1), last], dim=-1)


def sample_pdf(
    u: Optional[torch.Tensor],
    bins: torch.Tensor,
    weights: torch.Tensor,
    n_samples: int,
) -> torch.Tensor:
    """Inverse-CDF sampling of n_samples points from the piecewise-constant
    PDF over `bins` [R, B+1] (edges) with `weights` [R, B].

    u: [R, n_samples] draws in [0, 1 - 1e-5), or None for the evenly spaced
    quantiles linspace(0, 1 - 1e-5, n_samples). The brackets are the
    reference's masked max/min over le = (cdf <= u), not a searchsorted:
    with a raw sigma head the compositing weights can be negative, the CDF
    is then not monotone, and only the masked form gives the reference's
    samples. Returns samples [R, n_samples] within [bins[0], bins[-1]],
    unsorted.
    """
    R, B = weights.shape
    weights = weights + 1e-5                              # avoid nans
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros((R, 1), device=cdf.device), cdf], dim=-1)
    if u is None:
        u = linspace(0.0, 1.0 - 1e-5, n_samples, bins.device).expand(
            R, n_samples)
    # le[r, s, j] <=> cdf[r, j] <= u[r, s]; j = 0 (cdf 0) is always in, and
    # u past the whole CDF takes the last bin as the upper end
    le = cdf[:, None, :] <= u[:, :, None]                 # [R, S, B+1]
    c, b = cdf[:, None, :], bins[:, None, :]
    cdf_below = torch.amax(torch.where(le, c, 0.0), dim=-1)
    cdf_above = torch.amin(torch.where(le, c[..., -1:], c), dim=-1)
    bin_below = torch.amax(torch.where(le, b, b[..., :1]), dim=-1)
    bin_above = torch.amin(torch.where(le, b[..., -1:], b), dim=-1)
    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, 1.0, denom)
    frac = (u - cdf_below) / denom
    return bin_below + frac * (bin_above - bin_below)


def hierarchical_samples(
    u: Optional[torch.Tensor],
    t_coarse: torch.Tensor,
    weights_coarse: torch.Tensor,
    n_fine: int,
    far: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The coarse samples [R, C] and n_fine inverse-CDF samples drawn over
    the midpoints of the coarse samples (the first and last coarse weights
    dropped), sorted: (t_all [R, C + n_fine], deltas)."""
    mids = 0.5 * (t_coarse[..., 1:] + t_coarse[..., :-1])
    t_fine = sample_pdf(u, mids, weights_coarse[..., 1:-1], n_fine)
    t_all = torch.sort(torch.cat([t_coarse, t_fine], dim=-1), dim=-1).values
    return t_all, _deltas_from_t(t_all, far)


def sample_points(rays_o: torch.Tensor, rays_d: torch.Tensor,
                  t_vals: torch.Tensor) -> torch.Tensor:
    """x = o + t * d for [R, S] sample positions -> [R, S, 3]."""
    return rays_o[:, None, :] + rays_d[:, None, :] * t_vals[..., None]


def compact_samples(
    t_mid: torch.Tensor,
    deltas: torch.Tensor,
    mask: torch.Tensor,
    k: int,
    spread: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-ray compaction to `k` samples, preserving the volume integral:
    masked samples add no optical depth, so dropping them leaves it as it
    was.

    With `spread`, rays with more than k valid samples keep k of them
    evenly spaced among the valid ones, their deltas scaled by n_valid/k
    (a coarser quadrature of the same interval); without it such a ray
    keeps its first k valid samples. One stable sort keyed on the inverted
    mask moves the kept samples to the front in t order, t, deltas and the
    mask riding along.

    Args: t_mid, deltas [R, S]; mask [R, S] bool.
    Returns (t_k [R, k], deltas_k [R, k], mask_k [R, k]).
    """
    if spread:
        m = mask.to(torch.int32)
        nv = m.sum(dim=-1, keepdim=True)                      # [R, 1]
        nv_safe = torch.clamp(nv, min=1)
        rank = torch.cumsum(m, dim=-1) - 1                    # among valid
        keep = mask & ((rank * k) // nv_safe > ((rank - 1) * k) // nv_safe)
        scale = torch.clamp(nv.to(t_mid.dtype) / k, min=1.0)
        deltas = torch.where(keep, deltas * scale, deltas)
        mask = keep
    order = torch.sort((~mask).to(torch.uint8), dim=-1,
                       stable=True).indices[:, :k]
    return (torch.gather(t_mid, 1, order), torch.gather(deltas, 1, order),
            torch.gather(mask, 1, order))


def compact_samples_uniform(
    t_mid: torch.Tensor,
    dt: torch.Tensor,
    mask: torch.Tensor,
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-ray compaction of a uniformly spaced lattice to `k` samples.

    Rays with more than k valid samples keep k of them evenly spaced among
    the valid ones, their deltas scaled by n_valid/k (a coarser quadrature
    of the same interval); otherwise the compaction is exact. The kept
    samples move to the front by a stable sort on the inverted keep flag,
    so they stay in t order.

    Args: t_mid [R, S]; dt [R] per-ray spacing; mask [R, S] bool.
    Returns (t_k [R, k], deltas_k [R, k], mask_k [R, k]).
    """
    m = mask.to(torch.int32)
    nv = m.sum(dim=-1, keepdim=True)                          # [R, 1]
    nv_safe = torch.clamp(nv, min=1)
    rank = torch.cumsum(m, dim=-1) - 1
    keep = mask & ((rank * k) // nv_safe > ((rank - 1) * k) // nv_safe)
    scale = torch.clamp(nv.to(t_mid.dtype) / k, min=1.0)      # [R, 1]
    n_kept = torch.clamp(nv, max=k)

    key = (~keep).to(torch.uint8)
    order = torch.sort(key, dim=-1, stable=True).indices[:, :k]
    t_k = torch.gather(t_mid, 1, order)
    mask_k = torch.arange(k, device=t_mid.device)[None, :] < n_kept
    deltas_k = (dt[:, None] * scale).expand(t_k.shape)
    return t_k, deltas_k, mask_k
