"""Multi-level binarized occupancy grid (port of fsnerf_tpu/ops/occgrid.py).

nerfacc OccGridEstimator semantics: level l covers the base AABB scaled by
2**l about its centre and a point is classified by the finest level holding
it; the EMA update takes occs <- max(occs * decay, sigma(x) * step) at
(jittered) cell positions, all cells during warmup and a round-robin
1/update_parts slice after; binarization at occ > min(occ_thre, mean(occs)).

Query tables. fsnerf_tpu packs two bf16 tables into one uint32 and applies
their z windows at query time over a gathered z-row — a TPU single-gather
trick. The port keeps two float32 tables and applies the z window when it
builds them, so a query gathers one element from each. That is exact:
bf16 rounding is monotone and commutes with the z min/max. Kept as in the
reference:
  * occ_q: occupancy max-pooled over a (2r+1)^3 Chebyshev window
    (r = query_dilation; the cell's own occ at r = 0), nudged one bf16 ulp UP
    before rounding, so a rounding flip never hides a surface;
  * od_q: occupancy min-pooled over radius r+1 (XY outside the volume reads
    EMPTY), nudged one bf16 ulp DOWN — the early-stop optical-depth estimate
    must underestimate — and 0 wherever the z window is clipped by the
    volume boundary.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import numpy as np
import torch

# cells per density_fn call in update()
_EVAL_CHUNK = 1 << 18


@dataclass
class OccGrid:
    occs: torch.Tensor            # [L, res**3] float32 EMA occupancy values
    occ_q: Optional[torch.Tensor]  # [L, res**3] occupancy value for `> thre`
    od_q: Optional[torch.Tensor]   # [L, res**3] eroded od estimate
    binaries: torch.Tensor        # [L, res**3] bool (diagnostic)
    thre: torch.Tensor            # scalar binarization threshold
    base_aabb: torch.Tensor       # [6]
    resolution: int = 128
    levels: int = 1
    query_dilation: int = 0

    @property
    def n_cells(self) -> int:
        return self.resolution ** 3

    def replace(self, **kw) -> "OccGrid":
        return dataclasses.replace(self, **kw)


def create(aabb, resolution: int = 128, levels: int = 1,
           query_dilation: int = 0, device=None) -> OccGrid:
    """Fresh grid, fully occupied: thre starts at -1 so occs = 0 cells count
    as occupied until the first update."""
    n = resolution ** 3
    occs = torch.zeros((levels, n), dtype=torch.float32, device=device)
    occ_q, od_q = _build_query_table(occs, resolution, query_dilation)
    return OccGrid(
        occs=occs, occ_q=occ_q, od_q=od_q,
        binaries=torch.ones((levels, n), dtype=torch.bool, device=device),
        thre=torch.tensor(-1.0, dtype=torch.float32, device=device),
        base_aabb=torch.as_tensor(np.asarray(aabb, np.float32),
                                  device=device),
        resolution=resolution, levels=levels, query_dilation=query_dilation)


def _shift(vol: torch.Tensor, axis: int, step: int, fill: float):
    """vol shifted by `step` along `axis` (out[i] = vol[i + step]), with
    `fill` where that index leaves the volume."""
    out = torch.full_like(vol, fill)
    n = vol.shape[axis]
    dst = [slice(None)] * vol.ndim
    src = [slice(None)] * vol.ndim
    if step > 0:
        dst[axis], src[axis] = slice(0, n - step), slice(step, n)
    else:
        dst[axis], src[axis] = slice(-step, n), slice(0, n + step)
    out[tuple(dst)] = vol[tuple(src)]
    return out


def _dilate_xy(occs: torch.Tensor, res: int, radius: int) -> torch.Tensor:
    """Max-pool each level's [res, res, res] volume over a (2r+1)^2 window in
    (ix, iy); -inf outside the volume."""
    L = occs.shape[0]
    vol = occs.reshape(L, res, res, res)
    for axis in (1, 2):
        for _ in range(radius):
            vol = torch.maximum(vol, torch.maximum(
                _shift(vol, axis, 1, -float("inf")),
                _shift(vol, axis, -1, -float("inf"))))
    return vol.reshape(L, res ** 3)


def _erode_xy(occs: torch.Tensor, res: int, radius: int) -> torch.Tensor:
    """Min-pool each level's volume over a (2r+1)^2 window in (ix, iy);
    outside the volume is EMPTY (occ 0)."""
    L = occs.shape[0]
    vol = occs.reshape(L, res, res, res)
    for axis in (1, 2):
        for _ in range(radius):
            vol = torch.minimum(vol, torch.minimum(
                _shift(vol, axis, 1, 0.0), _shift(vol, axis, -1, 0.0)))
    return vol.reshape(L, res ** 3)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _window_z(vol: torch.Tensor, radius: int, reduce, fill: float):
    """Reduce over |dz| <= radius along iz (the last axis)."""
    out = vol
    for s in range(1, radius + 1):
        out = reduce(out, reduce(_shift(vol, 3, s, fill),
                                 _shift(vol, 3, -s, fill)))
    return out


def _build_query_table(occs: torch.Tensor, res: int, radius: int):
    """(occ_q, od_q) float32 tables with the z windows applied (see module
    docstring): the bf16 rounding of each XY-pooled value happens first,
    exactly where fsnerf_tpu rounds into its packed table."""
    L = occs.shape[0]
    er = radius + 1
    ero = _bf16(_erode_xy(occs, res, er) * (1.0 - 2.0 ** -8))
    ero = _window_z(ero.reshape(L, res, res, res), er, torch.minimum,
                    float("inf"))
    iz = torch.arange(res, device=occs.device)
    clipped = (iz < er) | (iz > res - 1 - er)
    od_q = torch.where(clipped, 0.0, ero).reshape(L, res ** 3)

    base = occs if radius <= 0 else _dilate_xy(occs, res, radius)
    dil = _bf16(base * (1.0 + 2.0 ** -8))
    if radius > 0:
        dil = _window_z(dil.reshape(L, res, res, res), radius, torch.maximum,
                        -float("inf")).reshape(L, res ** 3)
    return dil, od_q


def level_aabb(base_aabb: torch.Tensor, level: int) -> torch.Tensor:
    """AABB of `level`: base scaled by 2**level about its centre."""
    lo, hi = base_aabb[:3], base_aabb[3:]
    center = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo) * (2.0 ** level)
    return torch.cat([center - half, center + half])


def outer_aabb(grid: OccGrid) -> torch.Tensor:
    """AABB of the coarsest level — the sampling domain for rays."""
    return level_aabb(grid.base_aabb, grid.levels - 1)


def _locate(grid: OccGrid, x: torch.Tensor):
    """(flat table index, found) of the finest level holding each point."""
    res = grid.resolution
    flat = torch.zeros(x.shape[:-1], dtype=torch.int64, device=x.device)
    found = torch.zeros(x.shape[:-1], dtype=torch.bool, device=x.device)
    for lv in range(grid.levels):
        ab = level_aabb(grid.base_aabb, lv)
        lo, hi = ab[:3], ab[3:]
        norm = (x - lo) / (hi - lo)
        inb = torch.all((norm >= 0.0) & (norm < 1.0), dim=-1)
        ijk = torch.clamp((norm * res).to(torch.int32), 0, res - 1).long()
        f_l = ((lv * res + ijk[..., 0]) * res + ijk[..., 1]) * res \
            + ijk[..., 2]
        take = inb & ~found
        flat = torch.where(take, f_l, flat)
        found = found | inb
    return flat, found


def query_with_density(grid: OccGrid, x: torch.Tensor):
    """Occupancy and the eroded EMA od estimate at points x [..., 3].

    Returns (occupied [...] bool, od [...] float32); both are False/0
    outside all levels. Without query tables the occupancy reads occs
    directly and the od estimate is 0 (early stop inert)."""
    flat, found = _locate(grid, x)
    if grid.occ_q is None:
        val = grid.occs.reshape(-1)[flat]
        od = torch.zeros_like(val)
    else:
        val = grid.occ_q.reshape(-1)[flat]
        od = grid.od_q.reshape(-1)[flat]
    occ = (val > grid.thre) & found
    return occ, torch.where(found, od, 0.0)


def query(grid: OccGrid, x: torch.Tensor) -> torch.Tensor:
    """Occupancy lookup: True where the finest containing level says
    occupied; False outside all levels."""
    return query_with_density(grid, x)[0]


def _cell_positions(flat_idx: torch.Tensor, ab: torch.Tensor, res: int,
                    u=None) -> torch.Tensor:
    """World positions inside cells `flat_idx` of the level with AABB `ab`:
    cell centres when u is None, else lo + (ijk + u) / res * (hi - lo) for
    jitter u [k, 3] in [0, 1)."""
    iz = flat_idx % res
    iy = (flat_idx // res) % res
    ix = flat_idx // (res * res)
    ijk = torch.stack([ix, iy, iz], dim=-1).to(torch.float32)
    if u is None:
        u = 0.5
    lo, hi = ab[:3], ab[3:]
    return lo + (ijk + u) / res * (hi - lo)


def refresh_plan(step: int, warmup_steps: int = 256, update_parts: int = 4,
                 update_interval: int = 16, hold_steps: int = 0):
    """(part, hold) of the refresh at `step`: part None refreshes every
    cell (warmup), else the round-robin part (step // update_interval) %
    update_parts; hold keeps every cell occupied (the culling hold)."""
    part = (None if step < warmup_steps
            else (step // update_interval) % update_parts)
    return part, bool(hold_steps and step < hold_steps)


def _refreshed(grid: OccGrid, density_fn, part: Optional[int], hold: bool,
               render_step_size: float, occ_thre: float, ema_decay: float,
               update_parts: int, jitter):
    """The EMA values and threshold after one refresh (see update)."""
    res, L, n = grid.resolution, grid.levels, grid.n_cells
    dev = grid.occs.device

    def eval_level(lv: int, flat_idx: torch.Tensor) -> torch.Tensor:
        ab = level_aabb(grid.base_aabb, lv)
        u = None if jitter is None else jitter[lv]
        x = _cell_positions(flat_idx, ab, res, u)
        # row-independent, so evaluating in chunks bounds the transient
        # activations of a full-resolution refresh without changing a bit;
        # the product stays in the density's dtype, as in the reference
        return torch.cat([
            (density_fn(xc) * render_step_size).to(torch.float32)
            for xc in torch.split(x, _EVAL_CHUNK)])

    if part is None:
        idx = torch.arange(n, dtype=torch.int64, device=dev)
        new = torch.stack([eval_level(lv, idx) for lv in range(L)])
        occs = torch.maximum(grid.occs * ema_decay, new)
    else:
        k = n // update_parts
        start = part * k
        idx = start + torch.arange(k, dtype=torch.int64, device=dev)
        new = torch.stack([eval_level(lv, idx) for lv in range(L)])
        occs = grid.occs.clone()
        occs[:, start:start + k] = torch.maximum(
            grid.occs[:, start:start + k] * ema_decay, new)
    thre = torch.clamp(occs.mean(), max=occ_thre)
    if hold:
        # culling hold: every cell stays occupied while the EMA accumulates
        thre = torch.full_like(thre, -1.0)
    return occs, thre


def update(
    grid: OccGrid,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    step: int,
    render_step_size: float = 5e-3,
    occ_thre: float = 1e-2,
    ema_decay: float = 0.95,
    warmup_steps: int = 256,
    update_parts: int = 4,
    update_interval: int = 16,
    hold_steps: int = 0,
    jitter: Optional[Sequence[torch.Tensor]] = None,
) -> OccGrid:
    """One grid refresh (nerfacc update_every_n_steps semantics), as a new
    grid.

    density_fn maps [N, 3] -> [N] raw sigma; occ_eval = sigma *
    render_step_size. jitter: optional per-level [k, 3] cell jitter in
    place of the JAX key (None = cell centres); k is every cell during
    warmup, else the refreshed slice.
    """
    part, hold = refresh_plan(step, warmup_steps, update_parts,
                              update_interval, hold_steps)
    occs, thre = _refreshed(grid, density_fn, part, hold, render_step_size,
                            occ_thre, ema_decay, update_parts, jitter)
    return with_occs(grid, occs, thre)


def update_(
    grid: OccGrid,
    density_fn: Callable[[torch.Tensor], torch.Tensor],
    part: Optional[int],
    hold: bool,
    render_step_size: float = 5e-3,
    occ_thre: float = 1e-2,
    ema_decay: float = 0.95,
    update_parts: int = 4,
    jitter: Optional[Sequence[torch.Tensor]] = None,
) -> OccGrid:
    """update() in place, for the refresh refresh_plan names (part, hold):
    the new EMA values, query tables, binaries and threshold are written
    into the grid's own tensors (set_occs_), bitwise what update() returns.
    A CUDA graph that captured a step reads the tables it refreshed."""
    occs, thre = _refreshed(grid, density_fn, part, hold, render_step_size,
                            occ_thre, ema_decay, update_parts, jitter)
    return set_occs_(grid, occs, thre)


def with_occs(grid: OccGrid, occs: torch.Tensor, thre) -> OccGrid:
    """Replace the EMA occupancy values consistently: rebuilds the query
    tables and the diagnostic binaries."""
    occs = torch.as_tensor(occs, dtype=torch.float32,
                           device=grid.occs.device)
    thre = torch.as_tensor(thre, dtype=torch.float32,
                           device=grid.occs.device)
    occ_q, od_q = _build_query_table(occs, grid.resolution,
                                     grid.query_dilation)
    return grid.replace(occs=occs, occ_q=occ_q, od_q=od_q,
                        binaries=occs > thre, thre=thre)


def set_occs_(grid: OccGrid, occs: torch.Tensor,
              thre: torch.Tensor) -> OccGrid:
    """with_occs() in place: the EMA values, the query tables rebuilt from
    them, the binaries and the threshold are copied into the grid's
    existing tensors (occs and thre on the grid's device). Returns grid."""
    occ_q, od_q = _build_query_table(occs, grid.resolution,
                                     grid.query_dilation)
    grid.occs.copy_(occs)
    grid.occ_q.copy_(occ_q)
    grid.od_q.copy_(od_q)
    torch.gt(occs, thre, out=grid.binaries)
    grid.thre.copy_(thre)
    return grid


def conservative(grid: OccGrid) -> OccGrid:
    """Evaluation view of a trained grid: undilated occupancy queries with
    the od table rebuilt for radius 0 (eroded at radius 1, as the
    reference's code does)."""
    occ_q, od_q = _build_query_table(grid.occs, grid.resolution, 0)
    return grid.replace(query_dilation=0, occ_q=occ_q, od_q=od_q)


def occupancy_fraction(grid: OccGrid) -> torch.Tensor:
    """Fraction of occupied cells (diagnostic), on the grid's device."""
    return torch.mean(grid.binaries.to(torch.float32))


def auto_query_stride(aabb, resolution: int, step_size: float,
                      n_samples: int, max_stride: int = 4,
                      dilation: int = 0) -> int:
    """Largest sample stride for occupancy queries that cannot miss an
    occupied cell (host computation on the scene's static aabb): with
    dilation 0 a cell at least stride*dt_max wide always holds a queried
    sample; with dilation r the tables cover (stride/2)*dt_max <= r*cell."""
    ab = np.asarray(aabb, np.float64)
    ext = ab[3:] - ab[:3]
    cell = float(np.min(ext)) / resolution
    dt_max = max(step_size, float(np.linalg.norm(ext)) / n_samples)

    def ok(s: int) -> bool:
        if dilation > 0:
            return (s / 2) * dt_max <= dilation * cell
        return cell >= s * dt_max

    s = 1
    while s * 2 <= max_stride and ok(s * 2) and n_samples % (s * 2) == 0:
        s *= 2
    return s


def resolve_query_plan(sampling_cfg, aabb):
    """(query_stride, query_dilation) for a SamplingConfig and the scene
    aabb. query_stride 0 = auto: the dilation radius in {0, 1, 2} whose
    admissible stride is largest, ties to the smaller radius."""
    if sampling_cfg.strategy != "occgrid":
        return 1, 0
    dil_cfg = sampling_cfg.query_dilation
    if sampling_cfg.query_stride:
        return int(sampling_cfg.query_stride), int(dil_cfg or 0)
    args = (aabb, sampling_cfg.grid_resolution,
            sampling_cfg.render_step_size, sampling_cfg.n_samples)
    max_stride = int(sampling_cfg.query_max_stride or 8)
    if dil_cfg is not None:
        return auto_query_stride(*args, max_stride=max_stride,
                                 dilation=int(dil_cfg)), int(dil_cfg)
    s_best, d_best = auto_query_stride(*args, max_stride=max_stride,
                                       dilation=0), 0
    for r in (1, 2):
        s_r = auto_query_stride(*args, max_stride=max_stride, dilation=r)
        if s_r > s_best:
            s_best, d_best = s_r, r
    return s_best, d_best


def resolve_query_stride(sampling_cfg, aabb) -> int:
    """The stride half of resolve_query_plan."""
    return resolve_query_plan(sampling_cfg, aabb)[0]


def grid_query_stride(sampling_cfg, aabb, grid: Optional[OccGrid]) -> int:
    """The query stride that `grid` admits: resolve_query_plan's stride when
    the grid's tables carry the plan's dilation (a live grid, as the
    reference evaluates it), else 1. An undilated table (conservative(grid))
    admits stride 1 only: auto_query_stride's dilation-0 rule keeps a sample
    in every occupied cell, but drops the samples at a cell's edge whose
    group is queried in the next cell."""
    stride, dilation = resolve_query_plan(sampling_cfg, aabb)
    if grid is None or grid.query_dilation == dilation:
        return stride
    return 1
