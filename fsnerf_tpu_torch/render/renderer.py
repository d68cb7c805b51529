"""Ray, frame and path rendering and the path's video frames (port of
fsnerf_tpu/render/renderer.py).

occgrid: stages over dense [R, S] tensors: uniform sample lattice ->
occupancy mask -> approximate (grid-EMA) transmittance early termination ->
per-ray compaction to K samples -> either the fused ray-march kernel (after
a depth-coherence sort of the rays) or the model + volume_render.

hierarchical: stratified coarse samples in [near, far] -> model +
volume_render -> inverse-CDF fine samples from the coarse weights -> the
fine pass over the sorted coarse-and-fine union, either merging the shared
network's coarse outputs with the new samples' or marching the union
through the fused ray-march kernel.

The model is passed as `model_fn(x [..., 3], dirs [..., 3]) -> [..., 4]`
([rgb, sigma]) with weights and frequency masks already bound. Where the
model's outputs are composited outside a ray march, `composite_fn` does it:
ops/volrend.py::volume_render by default (autograd, the training loss), or
the forward-only kernel ops/kernels/volrend.py::volume_render_fused at
evaluation.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..data.rays import get_rays, to_ndc
from ..ops import occgrid as og
from ..ops.sampling import (_deltas_from_t, compact_samples_uniform,
                            hierarchical_samples, sample_pdf, sample_points,
                            stratified_samples, uniform_samples)
from ..ops.volrend import volume_render


class _MergeSortedUnion(torch.autograd.Function):
    """Sort the coarse-and-fine union by t [R, S] and permute the outputs
    [R, S, C] to match: a stable sort (the coarse sample first on a tie, as
    lax.sort), the outputs gathered by the same permutation. The backward
    scatters each cotangent back to its source slot by that permutation."""

    @staticmethod
    def forward(ctx, t_cat, o_cat):
        t_sorted, perm = torch.sort(t_cat, dim=-1, stable=True)
        ctx.save_for_backward(perm)
        return t_sorted, torch.gather(
            o_cat, 1, perm[..., None].expand(o_cat.shape))

    @staticmethod
    def backward(ctx, dt_sorted, dmerged):
        (perm,) = ctx.saved_tensors
        dt = torch.zeros_like(dt_sorted).scatter_(1, perm, dt_sorted)
        do = torch.zeros_like(dmerged).scatter_(
            1, perm[..., None].expand(dmerged.shape), dmerged)
        return dt, do


def _merge_sorted_union(t_cat: torch.Tensor, o_cat: torch.Tensor):
    """(t_sorted [R, S], outputs_sorted [R, S, C]); exact, gradients to
    both inputs by the inverse permutation."""
    return _MergeSortedUnion.apply(t_cat, o_cat)


def to8b(x: np.ndarray) -> np.ndarray:
    """Float [0,1] -> uint8."""
    return (255 * np.clip(x, 0, 1)).astype(np.uint8)


def _masked_lattice(rays_o, rays_d, grid, n_samples, jitter,
                    render_step_size, early_stop_eps, query_stride):
    """Dense sample lattice -> occupancy mask -> approximate (eroded grid
    EMA) transmittance early termination.

    Returns (t_mid, deltas, mask, n_valid); n_valid [R] float32 is the
    per-ray surviving-sample count."""
    t_mid, deltas, valid = uniform_samples(
        rays_o, rays_d, og.outer_aabb(grid), n_samples, jitter=jitter,
        step_size=render_step_size)
    R = rays_o.shape[0]
    tq = t_mid[:, query_stride // 2::query_stride] if query_stride > 1 \
        else t_mid
    occupied, occ_val = og.query_with_density(
        grid, sample_points(rays_o, rays_d, tq))

    def expand(g):
        if query_stride == 1:
            return g
        return g[..., None].expand(*g.shape, query_stride).reshape(
            R, n_samples)

    if early_stop_eps > 0:
        occupied, occ_val = expand(occupied), expand(occ_val)
        # occ_val is the ERODED EMA of sigma * render_step_size: it
        # underestimates the true optical depth, so this mask never cuts a
        # ray before its true termination
        approx_od = torch.where(valid, occ_val * (deltas / render_step_size),
                                0.0)
        cum = torch.cumsum(approx_od, dim=-1)
        visible = torch.exp(-(cum - approx_od)) > early_stop_eps
        mask = valid & occupied & visible
    else:
        mask = valid & expand(occupied)
    n_valid = mask.to(torch.float32).sum(dim=-1)
    return t_mid, deltas, mask, n_valid


def count_valid_samples(rays_o, rays_d, grid, n_samples,
                        render_step_size: float = 5e-3,
                        early_stop_eps: float = 1e-4,
                        query_stride: int = 1) -> torch.Tensor:
    """Per-ray surviving-sample count without any model evaluation."""
    return _masked_lattice(rays_o, rays_d, grid, n_samples, None,
                           render_step_size, early_stop_eps, query_stride)[3]


def render_rays_occgrid(
    model_fn: Optional[Callable],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    grid: og.OccGrid,
    n_samples: int,
    render_step_size: float = 5e-3,
    jitter: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
    n_compact: int = 0,
    early_stop_eps: float = 1e-4,
    query_stride: int = 1,
    fused_render_fn: Optional[Callable] = None,
    composite_fn: Callable = volume_render,
) -> dict:
    """Occupancy-grid-masked dense rendering of rays [R, 3].

    n_compact > 0 compacts each ray's valid samples to that many before the
    MLP runs. fused_render_fn (ops/kernels/render.py::
    make_fused_ray_renderer) runs MLP + compositing + exact early exit in
    one kernel after a stable depth-coherence sort of the rays by n_valid;
    model_fn is then unused and the result holds rgb, opacity, depth,
    trans_final and n_valid. Otherwise composite_fn composites model_fn's
    outputs.
    """
    t_mid, deltas, mask, n_valid = _masked_lattice(
        rays_o, rays_d, grid, n_samples, jitter, render_step_size,
        early_stop_eps, query_stride)
    if n_compact and n_compact < n_samples:
        t_mid, deltas, mask = compact_samples_uniform(
            t_mid, deltas[:, 0], mask, n_compact)
    x = sample_points(rays_o, rays_d, t_mid)
    bkgd = 1.0 if white_bkgd else 0.0
    if fused_render_fn is not None:
        # rays grouped by valid-sample count make ray blocks uniformly
        # shallow or deep, so the kernel's per-block exit skips more chunks;
        # stable, so ties keep their order (jnp.argsort is stable too)
        perm = torch.sort(n_valid, stable=True).indices
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(perm.numel(), device=perm.device)
        out = fused_render_fn(x[perm], rays_d[perm], t_mid[perm],
                              deltas[perm], mask[perm], bkgd)
        out = {k: v[inv] for k, v in out.items()}
        out["n_valid"] = n_valid
        return out
    dirs = rays_d[:, None, :].expand(x.shape)
    out4 = model_fn(x, dirs).to(torch.float32)
    rgbs, sigmas = out4[..., :3], out4[..., 3]
    out = composite_fn(sigmas, rgbs, t_mid, deltas, mask, bkgd)
    out.update(sigmas=sigmas, t_vals=t_mid, mask=mask, n_valid=n_valid)
    return out


def render_rays_hierarchical(
    model_fn: Optional[Callable],
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    near: float,
    far: float,
    n_coarse: int,
    n_fine: int,
    u_coarse: Optional[torch.Tensor] = None,
    u_fine: Optional[torch.Tensor] = None,
    white_bkgd: bool = False,
    coarse_model_fn: Optional[Callable] = None,
    fused_render_fn: Optional[Callable] = None,
    composite_fn: Callable = volume_render,
) -> Tuple[dict, dict]:
    """Classic-NeRF coarse/fine rendering with inverse-CDF resampling.

    u_coarse [R, n_coarse] / u_fine [R, n_fine] are the stratified and PDF
    draws (None: bin centres / evenly spaced quantiles). coarse_model_fn
    defaults to model_fn (the shared network). With the shared network the
    fine pass evaluates only the n_fine new samples and merges them with the
    coarse outputs by a sort on t (exact: a sort permutes, it never
    recomputes; gradients reach both uses). A distinct coarse_model_fn makes
    model_fn evaluate the whole union. fused_render_fn (shared network,
    eval only) marches the sorted union through the ray-march kernel with
    every sample valid; its fine dict then holds rgb, opacity, depth,
    trans_final, t_vals and mask None. composite_fn composites both passes
    otherwise (the coarse pass always). The coarse weights that drive the
    resampling carry no gradient.

    Returns (coarse, fine) dicts as render_rays_occgrid's model path.
    """
    shared = coarse_model_fn is None
    coarse_fn = coarse_model_fn or model_fn
    t_c, d_c = stratified_samples(rays_o, rays_d, near, far, n_coarse,
                                  u_coarse)
    x_c = sample_points(rays_o, rays_d, t_c)
    out4_c = coarse_fn(x_c, rays_d[:, None, :].expand(x_c.shape)).to(
        torch.float32)
    bkgd = 1.0 if white_bkgd else 0.0
    coarse = composite_fn(out4_c[..., 3], out4_c[..., :3], t_c, d_c, None,
                          bkgd)
    coarse.update(sigmas=out4_c[..., 3], t_vals=t_c, mask=None)

    w = coarse["weights"].detach()
    if not shared:
        t_f, d_f = hierarchical_samples(u_fine, t_c, w, n_fine, far)
        x_f = sample_points(rays_o, rays_d, t_f)
        out4_f = model_fn(x_f, rays_d[:, None, :].expand(x_f.shape)).to(
            torch.float32)
        sig, rgb_f = out4_f[..., 3], out4_f[..., :3]
    else:
        mids = 0.5 * (t_c[..., 1:] + t_c[..., :-1])
        t_new = sample_pdf(u_fine, mids, w[..., 1:-1], n_fine)   # [R, F]
        if fused_render_fn is not None:
            t_f = torch.sort(torch.cat([t_c, t_new], dim=-1), dim=-1).values
            fine = dict(fused_render_fn(
                sample_points(rays_o, rays_d, t_f), rays_d, t_f,
                _deltas_from_t(t_f, far),
                torch.ones_like(t_f, dtype=torch.bool), bkgd))
            fine.update(t_vals=t_f, mask=None)
            return coarse, fine
        x_new = sample_points(rays_o, rays_d, t_new)
        out4_new = model_fn(x_new, rays_d[:, None, :].expand(x_new.shape)).to(
            torch.float32)
        t_f, merged = _merge_sorted_union(
            torch.cat([t_c, t_new], dim=-1),
            torch.cat([out4_c, out4_new], dim=-2))
        rgb_f, sig = merged[..., :3], merged[..., 3]
        d_f = _deltas_from_t(t_f, far)
    fine = composite_fn(sig, rgb_f, t_f, d_f, None, bkgd)
    fine.update(sigmas=sig, t_vals=t_f, mask=None)
    return coarse, fine


def _render_rays_dispatch(model_fn, rays_o, rays_d, white_bkgd, *, strategy,
                          grid, n_samples, n_fine, near, far,
                          render_step_size, n_compact=0, early_stop_eps=1e-4,
                          query_stride=1, fused_render_fn=None,
                          composite_fn=volume_render):
    """One strategy's eval-time render of rays (no draws): the occgrid
    result, or the hierarchical fine pass."""
    if strategy == "occgrid":
        return render_rays_occgrid(
            model_fn, rays_o, rays_d, grid, n_samples,
            render_step_size=render_step_size, white_bkgd=white_bkgd,
            n_compact=n_compact, early_stop_eps=early_stop_eps,
            query_stride=query_stride, fused_render_fn=fused_render_fn,
            composite_fn=composite_fn)
    if strategy != "hierarchical":
        raise ValueError(f"unknown sampling strategy {strategy!r}")
    _, fine = render_rays_hierarchical(
        model_fn, rays_o, rays_d, near, far, n_samples, n_fine,
        white_bkgd=white_bkgd, fused_render_fn=fused_render_fn,
        composite_fn=composite_fn)
    return fine


def render_rays_tiled(render_fn: Callable, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, mesh):
    """Rays rendered rank by rank (port of fsnerf_tpu/parallel/
    train_parallel.py::render_rays_tiled): the rays are padded to a
    multiple of the group's size with rays of direction (0, 0, -1), as
    render_frame pads a frame, this rank renders its rows through
    render_fn(rays_o, rays_d) -> a tuple of per-ray tensors, and every
    rank's rows are gathered. mesh: parallel/mesh.py::Mesh."""
    R = rays_o.shape[0]
    pad = -R % mesh.world
    if pad:
        rays_o = torch.cat([rays_o, rays_o.new_zeros((pad, 3))])
        rays_d = torch.cat([rays_d, rays_d.new_tensor([[0.0, 0.0, -1.0]])
                            .expand(pad, 3)])
    rows = mesh.rows(R + pad)
    out = render_fn(rays_o[rows], rays_d[rows])
    return tuple(mesh.all_gather(v)[:R] for v in out)


def tile_march(render_fn: Callable, mesh) -> Callable:
    """The fused ray-march renderer `render_fn` (ops/kernels/render.py)
    marched rank by rank: its inputs, already sorted, are padded with
    masked-out rays to a multiple of the group's size times the march's
    ray block, each rank marches its rows and the outputs are gathered.
    The block is the one the single-GPU march takes for these rays
    (pad_for_march's rule) and each rank's share is a whole number of
    blocks, so every block holds the rays, and the padding, it holds on
    one GPU: the per-block early exit decides alike and the gathered
    result is the single-GPU march's."""
    from ..ops.kernels.render import march_block_rows

    def tiled(x, dirs, t, deltas, mask, bkgd=0.0):
        R = x.shape[0]
        step = mesh.world * march_block_rows(R, render_fn.block_rows)
        pad = -R % step

        def p(a):
            return (torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
                    if pad else a)

        rows = mesh.rows(R + pad)
        out = render_fn(*(p(a)[rows] for a in (x, dirs, t, deltas, mask)),
                        bkgd)
        return {k: mesh.all_gather(v)[:R] for k, v in out.items()}

    return tiled


def make_chunk_renderer(
    model_fn: Optional[Callable],
    *,
    strategy: str = "occgrid",
    grid: Optional[og.OccGrid] = None,
    n_samples: int = 512,
    n_fine: int = 128,
    render_step_size: float = 5e-3,
    white_bkgd: bool = False,
    near: float = 2.0,
    far: float = 6.0,
    n_compact: int = 0,
    early_stop_eps: float = 1e-4,
    query_stride: int = 1,
    fused_render_fn: Optional[Callable] = None,
    composite_fn: Callable = volume_render,
    mesh=None,
) -> Callable:
    """(rays_o, rays_d) -> (rgb, depth) chunk renderer of one strategy.

    mesh: a data-parallel group (parallel/mesh.py::Mesh) that renders each
    chunk tiled. With the fused ray march every rank computes the chunk's
    samples and their depth-coherence sort, and the march, the kernel that
    takes the time, is split over the ranks at its block boundaries
    (tile_march), so the chunk is bitwise the single-GPU one; otherwise
    the chunk's rays are split (render_rays_tiled)."""
    if mesh is not None and fused_render_fn is not None:
        fused_render_fn = tile_march(fused_render_fn, mesh)

    @torch.no_grad()
    def render(rays_o, rays_d):
        out = _render_rays_dispatch(
            model_fn, rays_o, rays_d, white_bkgd, strategy=strategy,
            grid=grid, n_samples=n_samples, n_fine=n_fine, near=near,
            far=far, render_step_size=render_step_size, n_compact=n_compact,
            early_stop_eps=early_stop_eps, query_stride=query_stride,
            fused_render_fn=fused_render_fn, composite_fn=composite_fn)
        return out["rgb"], out["depth"]

    if mesh is not None and fused_render_fn is None:
        return torch.no_grad()(
            lambda rays_o, rays_d: render_rays_tiled(render, rays_o, rays_d,
                                                     mesh))
    return render


def render_frame(
    model_fn: Optional[Callable],
    pose: torch.Tensor,
    hwf: Tuple[int, int, float],
    near: float,
    far: float,
    *,
    strategy: str = "occgrid",
    grid: Optional[og.OccGrid] = None,
    n_samples: int = 512,
    n_fine: int = 128,
    render_step_size: float = 5e-3,
    ndc: bool = False,
    white_bkgd: bool = False,
    chunksize: int = 16384,
    n_compact: int = 0,
    early_stop_eps: float = 1e-4,
    query_stride: int = 1,
    chunk_renderer: Optional[Callable] = None,
    fused_render_fn: Optional[Callable] = None,
    composite_fn: Callable = volume_render,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Render a full H x W frame from one pose [4, 4] or [3, 4] (on the
    pose's device) in chunks of `chunksize` rays (at most 16384 under
    occgrid); the last chunk is padded with rays of direction (0, 0, -1).
    mesh: each chunk rendered tiled over a data-parallel group
    (make_chunk_renderer), in the single-GPU chunks.

    Returns img [H, W, 3] and depth [H, W] clamped to [near, far]."""
    H, W, _ = hwf
    if strategy == "occgrid":
        chunksize = min(chunksize, 16384)
    rays_o, rays_d = get_rays(pose, hwf)
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    if ndc:
        rays_o, rays_d = to_ndc(rays_o, rays_d, hwf, 1.0)

    n_rays = H * W
    chunksize = min(chunksize, n_rays)
    n_chunks = -(-n_rays // chunksize)
    pad = n_chunks * chunksize - n_rays
    if pad:
        rays_o = torch.cat([rays_o, rays_o.new_zeros((pad, 3))])
        rays_d = torch.cat([rays_d, rays_d.new_tensor([[0.0, 0.0, -1.0]])
                            .expand(pad, 3)])

    render = chunk_renderer or make_chunk_renderer(
        model_fn, strategy=strategy, grid=grid, n_samples=n_samples,
        n_fine=n_fine, render_step_size=render_step_size,
        white_bkgd=white_bkgd, near=near, far=far, n_compact=n_compact,
        early_stop_eps=early_stop_eps, query_stride=query_stride,
        fused_render_fn=fused_render_fn, composite_fn=composite_fn,
        mesh=mesh)
    imgs, depths = [], []
    for c in range(n_chunks):
        sl = slice(c * chunksize, (c + 1) * chunksize)
        rgb, depth = render(rays_o[sl], rays_d[sl])
        imgs.append(rgb)
        depths.append(depth)
    img = torch.cat(imgs)[:n_rays]
    depth = torch.clamp(torch.cat(depths)[:n_rays], near, far)
    return img.reshape(H, W, 3), depth.reshape(H, W)


def render_path(
    model_fn: Optional[Callable],
    render_poses,
    hwf: Tuple[int, int, float],
    near: float,
    far: float,
    device=None,
    compact_transfer: bool = False,
    **frame_kwargs,
) -> Tuple[np.ndarray, np.ndarray]:
    """Render a sequence of poses [F, 4, 4] or [F, 3, 4] with one chunk
    renderer (tiled over frame_kwargs' mesh, if any).

    Returns frames [F, H, W, 3] and depths [F, H, W] as float32 numpy, or,
    with `compact_transfer`, quantized on the device before they are copied
    to the host: rgb to uint8 (to8b's truncation), depth to float16."""
    renderer_kwargs = {k: v for k, v in frame_kwargs.items()
                       if k in ("strategy", "grid", "n_samples", "n_fine",
                                "render_step_size", "white_bkgd", "n_compact",
                                "early_stop_eps", "query_stride",
                                "fused_render_fn", "composite_fn", "mesh")}
    chunk_renderer = make_chunk_renderer(model_fn, near=near, far=far,
                                         **renderer_kwargs)
    frames, d_frames = [], []
    for pose in render_poses:
        pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)
        rgb, depth = render_frame(model_fn, pose, hwf, near, far,
                                  chunk_renderer=chunk_renderer,
                                  **frame_kwargs)
        if compact_transfer:
            rgb = (255.0 * torch.clamp(rgb, 0.0, 1.0)).to(torch.uint8)
            depth = depth.to(torch.float16)
        frames.append(rgb.cpu().numpy())
        d_frames.append(depth.cpu().numpy())
    return np.stack(frames, 0), np.stack(d_frames, 0)


def render_video(frames: np.ndarray, d_frames: np.ndarray
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """The path's video streams as uint8 [T, C, H, W]: rgb (to8b unless
    already uint8) and depth normalized over the whole clip and mapped
    through `plasma` (render/colormap.py, matplotlib's arithmetic)."""
    from .colormap import to_rgb

    d_rgb = to_rgb(d_frames.flatten(), float(np.amin(d_frames)),
                   float(np.amax(d_frames)))
    d_rgb = np.reshape(d_rgb, list(d_frames.shape[:3]) + [-1])
    rgb8 = frames if frames.dtype == np.uint8 else to8b(frames)
    return (np.transpose(rgb8, (0, 3, 1, 2)),
            np.transpose(to8b(d_rgb), (0, 3, 1, 2)))
