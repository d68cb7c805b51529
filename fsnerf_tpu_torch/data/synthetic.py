"""Procedural scenes with exact ground truth (numpy copy of
fsnerf_tpu/data/synthetic.py): the normal-coloured sphere and the lego-like
box lattice, both on the Blender camera regime (orbit radius ~4, near 2 /
far 6, AABB [-1.5, 1.5]^3), and the floater contamination of training
images (add_floaters), the occlusion regularizer's design regime.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple

import numpy as np

from .poses import pose_from_spherical, spherical_path


def _numpy_get_rays(pose: np.ndarray, hwf) -> Tuple[np.ndarray, np.ndarray]:
    H, W, f = hwf
    j, i = np.meshgrid(np.arange(H, dtype=np.float32),
                       np.arange(W, dtype=np.float32), indexing="ij")
    dirs = np.stack([(i - W * 0.5) / f, -(j - H * 0.5) / f,
                     -np.ones_like(i)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    dirs_w = np.sum(dirs[..., None, :] * pose[:3, :3], axis=-1)
    origins = np.broadcast_to(pose[:3, 3], dirs_w.shape)
    return origins, dirs_w


def render_sphere_image(
    pose: np.ndarray,
    hwf,
    radius: float = 1.0,
    white_bkgd: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Analytically ray-trace the sphere: color = 0.5 * (normal + 1).

    Returns rgb [H, W, 3] in [0, 1] and depth [H, W] (0 where no hit).
    """
    o, d = _numpy_get_rays(pose, hwf)
    b = np.sum(o * d, axis=-1)
    c = np.sum(o * o, axis=-1) - radius ** 2
    disc = b * b - c
    hit = disc > 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    hit &= t > 0
    p = o + t[..., None] * d
    n = p / radius
    rgb = 0.5 * (n + 1.0)
    bg = 1.0 if white_bkgd else 0.0
    rgb = np.where(hit[..., None], rgb, bg).astype(np.float32)
    depth = np.where(hit, t, 0.0).astype(np.float32)
    return rgb, depth


@dataclass
class SphereScene:
    """Analytic sphere dataset with the BlenderDataset surface."""

    n_imgs: int = 8
    hw: int = 64
    white_bkgd: bool = True
    radius: float = 4.0311289
    seed: int = 0
    near: float = 2.0
    far: float = 6.0
    ndc: bool = False
    imgs: np.ndarray = field(init=False)
    poses: np.ndarray = field(init=False)
    depths: np.ndarray = field(init=False)
    hwf: tuple = field(init=False)
    aabb: np.ndarray = field(init=False)
    path_poses: np.ndarray = field(init=False)

    def __post_init__(self):
        H = W = self.hw
        focal = 0.5 * W / np.tan(0.5 * 0.6911112)   # lego-like 39.6 deg fov
        self.hwf = (H, W, float(focal))
        rng = np.random.default_rng(self.seed)
        thetas = rng.uniform(30.0, 75.0, self.n_imgs)
        phis = np.linspace(0.0, 360.0, self.n_imgs, endpoint=False)
        phis = phis + rng.uniform(0, 360.0 / self.n_imgs, self.n_imgs)
        self.poses = np.stack([
            pose_from_spherical(self.radius, t, p)
            for t, p in zip(thetas, phis)
        ])
        rendered = [render_sphere_image(p, self.hwf, 1.0, self.white_bkgd)
                    for p in self.poses]
        self.imgs = np.stack([r[0] for r in rendered])
        self.depths = np.stack([r[1] for r in rendered])
        self.aabb = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)
        self.path_poses = spherical_path(self.radius, 50.0, 12)

    def holdout(self, n: int = 2, seed: int = 1) -> "SphereScene":
        """A fresh set of views from different angles for validation."""
        return SphereScene(n_imgs=n, hw=self.hw, white_bkgd=self.white_bkgd,
                           radius=self.radius, seed=seed)


def make_lattice_boxes(seed: int = 0) -> np.ndarray:
    """The lattice geometry: [B, 6] float32 rows of (lo_xyz, hi_xyz) — a
    base plate, a 5x5 grid of thin columns with seeded heights (some
    dropped: holes) and horizontal beams (concavities, self-occlusion)."""
    rng = np.random.default_rng(seed)
    boxes = [(-1.25, -1.25, -1.0, 1.25, 1.25, -0.82)]       # base plate
    grid = np.linspace(-1.0, 1.0, 5)
    hw = 0.07                                               # column half-width
    for gx in grid:
        for gy in grid:
            if rng.uniform() < 0.2:                         # hole in the grid
                continue
            h = rng.uniform(-0.3, 1.05)                     # column top
            boxes.append((gx - hw, gy - hw, -0.82, gx + hw, gy + hw, h))
    bh = 0.055                                              # beam half-width
    for y, z in ((-0.5, 0.35), (0.5, -0.05), (0.0, 0.75)):  # beams along x
        boxes.append((-1.1, y - bh, z - bh, 1.1, y + bh, z + bh))
    for x, z in ((-1.0, 0.15), (1.0, 0.55)):                # beams along y
        boxes.append((x - bh, -1.1, z - bh, x + bh, 1.1, z + bh))
    return np.asarray(boxes, np.float32)


_LIGHT = np.array([1.0, 0.6, 1.8], np.float32)
_LIGHT = _LIGHT / np.linalg.norm(_LIGHT)
_CHECKER_A = np.array([0.85, 0.30, 0.20], np.float32)
_CHECKER_B = np.array([0.92, 0.80, 0.25], np.float32)


def render_lattice_image(
    pose: np.ndarray,
    hwf,
    boxes: np.ndarray,
    white_bkgd: bool = True,
    checker_freq: float = 6.0,
    row_chunk: int = 64,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact ray-traced view of the box lattice: nearest-hit slab
    intersection, Lambertian shading of the entry face, world-space checker
    albedo with a continuous modulation. Returns (rgb [H, W, 3],
    depth [H, W])."""
    H, W, _ = hwf
    lo, hi = boxes[:, :3], boxes[:, 3:]                     # [B, 3]
    o_full, d_full = _numpy_get_rays(pose, hwf)
    rgb_out = np.empty((H, W, 3), np.float32)
    depth_out = np.empty((H, W), np.float32)
    bg = 1.0 if white_bkgd else 0.0
    for r0 in range(0, H, row_chunk):
        o = o_full[r0:r0 + row_chunk].reshape(-1, 1, 3)     # [n, 1, 3]
        d = d_full[r0:r0 + row_chunk].reshape(-1, 1, 3)
        inv = np.where(np.abs(d) > 1e-9, 1.0 / d, 1e12)
        t1 = (lo - o) * inv                                 # [n, B, 3]
        t2 = (hi - o) * inv
        tmin, tmax = np.minimum(t1, t2), np.maximum(t1, t2)
        tnear = tmin.max(axis=-1)                           # [n, B]
        tfar = tmax.min(axis=-1)
        hit = (tfar >= tnear) & (tnear > 1e-4)              # cameras outside
        tnear = np.where(hit, tnear, np.inf)
        b = tnear.argmin(axis=-1)                           # nearest box
        n_rows = np.arange(len(b))
        t = tnear[n_rows, b]
        any_hit = np.isfinite(t)
        ts = np.where(any_hit, t, 0.0)
        # entry face: the axis whose slab entry time equals tnear
        axis = tmin[n_rows, b].argmax(axis=-1)              # [n]
        sgn = -np.sign(d[n_rows, 0, axis])
        normal = np.zeros((len(b), 3), np.float32)
        normal[n_rows, axis] = sgn
        p = o[:, 0, :] + ts[:, None] * d[:, 0, :]
        cell = np.floor(p * checker_freq).sum(axis=-1).astype(np.int64)
        albedo = np.where((cell % 2 == 0)[:, None], _CHECKER_A, _CHECKER_B)
        mod = 0.82 + 0.18 * np.sin(9.0 * p[:, 0]) * np.sin(7.0 * p[:, 1] +
                                                           3.0 * p[:, 2])
        shade = 0.35 + 0.65 * np.maximum(normal @ _LIGHT, 0.0)
        col = albedo * (shade * mod)[:, None]
        col = np.where(any_hit[:, None], col, bg).astype(np.float32)
        n_r = min(row_chunk, H - r0)
        rgb_out[r0:r0 + n_r] = col.reshape(n_r, W, 3)
        depth_out[r0:r0 + n_r] = np.where(any_hit, ts, 0.0).reshape(n_r, W)
    return rgb_out, depth_out


@dataclass
class LatticeScene:
    """Procedural lego-like dataset with the BlenderDataset surface."""

    n_imgs: int = 8
    hw: int = 64
    white_bkgd: bool = True
    radius: float = 4.0311289
    seed: int = 0
    geom_seed: int = 7          # scene geometry (independent of view seed)
    near: float = 2.0
    far: float = 6.0
    ndc: bool = False
    imgs: np.ndarray = field(init=False)
    poses: np.ndarray = field(init=False)
    depths: np.ndarray = field(init=False)
    hwf: tuple = field(init=False)
    aabb: np.ndarray = field(init=False)
    path_poses: np.ndarray = field(init=False)
    boxes: np.ndarray = field(init=False)

    def __post_init__(self):
        H = W = self.hw
        focal = 0.5 * W / np.tan(0.5 * 0.6911112)
        self.hwf = (H, W, float(focal))
        self.boxes = make_lattice_boxes(self.geom_seed)
        rng = np.random.default_rng(self.seed)
        thetas = rng.uniform(30.0, 75.0, self.n_imgs)
        phis = np.linspace(0.0, 360.0, self.n_imgs, endpoint=False)
        phis = phis + rng.uniform(0, 360.0 / self.n_imgs, self.n_imgs)
        self.poses = np.stack([
            pose_from_spherical(self.radius, t, p)
            for t, p in zip(thetas, phis)
        ])
        rendered = [render_lattice_image(p, self.hwf, self.boxes,
                                         self.white_bkgd)
                    for p in self.poses]
        self.imgs = np.stack([r[0] for r in rendered])
        self.depths = np.stack([r[1] for r in rendered])
        self.aabb = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)
        self.path_poses = spherical_path(self.radius, 50.0, 12)

    def holdout(self, n: int = 2, seed: int = 1) -> "LatticeScene":
        return LatticeScene(n_imgs=n, hw=self.hw,
                            white_bkgd=self.white_bkgd, radius=self.radius,
                            seed=seed, geom_seed=self.geom_seed)


def add_floaters(
    imgs: np.ndarray,
    poses: np.ndarray,
    hwf,
    aabb_r: float = 1.5,
    n_blobs: int = 4,
    alpha: float = 0.55,
    blob_radius: float = 0.12,
    seed: int = 0,
) -> np.ndarray:
    """Composite view-inconsistent translucent blobs into training images.

    Content that appears in one training view and in no other has no
    photometrically consistent volumetric explanation except density
    parked just inside the AABB in front of that camera: a near-camera
    floater, the occlusion regularizer's target. Each blob is a gaussian
    splat centred on a random pixel's ray 0.18 inside the AABB, its alpha
    falling off with the perpendicular ray-to-centre distance. Returns a new
    float32 image stack; the draws come from `seed`.
    """
    rng = np.random.default_rng(seed)
    out = imgs.astype(np.float32).copy()
    H, W, _ = hwf
    color = np.array([0.55, 0.58, 0.68], np.float32)        # smoky gray
    for i, pose in enumerate(poses):
        o, d = _numpy_get_rays(pose, hwf)
        for _ in range(n_blobs):
            pi = rng.integers(H // 4, 3 * H // 4)
            pj = rng.integers(W // 4, 3 * W // 4)
            oc, dc = o[pi, pj], d[pi, pj]
            # the ray's entry into the AABB plus a small inward offset
            inv = np.where(np.abs(dc) > 1e-9, 1.0 / dc, 1e12)
            t1, t2 = (-aabb_r - oc) * inv, (aabb_r - oc) * inv
            t_in = np.minimum(t1, t2).max() + 0.18
            center = oc + t_in * dc
            # perpendicular distance of every pixel's ray to the centre
            rel = center - o.reshape(-1, 3)
            t_proj = (rel * d.reshape(-1, 3)).sum(-1)
            closest = o.reshape(-1, 3) + t_proj[:, None] * d.reshape(-1, 3)
            dist = np.linalg.norm(closest - center, axis=-1)
            a = alpha * np.exp(-0.5 * (dist / blob_radius) ** 2)
            a = np.where(t_proj > 0, a, 0.0).reshape(H, W, 1)
            out[i] = a * color + (1.0 - a) * out[i]
    return out
