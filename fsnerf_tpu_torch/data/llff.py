"""LLFF (forward-facing) scenes (port of fsnerf_tpu/data/llff.py).

  * poses_bounds.npy [N, 17] -> poses [N, 3, 5] (rotation | position | hwf
    column) and bounds [N, 2];
  * images from images_{factor}/, focal divided by the factor;
  * the column reorder [y, -x, z] from the LLFF convention to NeRF's;
  * positions and bounds rescaled by 1 / (min bound * bd_factor), poses
    recentred on the average pose;
  * the spiral render path (data/poses.py::spiral_path);
  * NDC: near 0 / far 1 and the occupancy grid's AABB from the projected
    ray extents, scaled so the outermost of 4 levels covers them; without
    NDC, near = 0.9 * min bound.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..native import decode_images
from .poses import recenter_poses, spiral_path
from .synthetic import _numpy_get_rays


def load_llff_scene(
    scene_dir: str,
    factor: int = 8,
    bd_factor: float = 0.75,
    recenter: bool = True,
) -> dict:
    """Load and normalize one LLFF scene directory holding
    `poses_bounds.npy` and `images_{factor}/`.

    Returns dict(imgs [N,H,W,3], poses [N,3,4], bounds [N,2],
    hwf, path_poses [F,3,4]).
    """
    data = np.load(os.path.join(scene_dir, "poses_bounds.npy"))
    poses = data[:, :-2].reshape([-1, 3, 5]).astype(np.float32)  # [N, 3, 5]
    bounds = data[:, -2:].astype(np.float32)                     # [N, 2]

    img_dir = os.path.join(scene_dir, f"images_{factor}")
    if not os.path.isdir(img_dir):
        raise FileNotFoundError(f"images_{factor}/ not found in {scene_dir}")
    files = [os.path.join(img_dir, f) for f in sorted(os.listdir(img_dir))
             if f.lower().endswith(("jpg", "jpeg", "png"))]
    if len(files) != len(poses):
        raise ValueError(
            f"{len(files)} images vs {len(poses)} poses in {scene_dir}")
    imgs = decode_images(files)[..., :3]

    # refresh the hwf column from the decoded size; focal scaled by 1/factor
    H, W = imgs.shape[1:3]
    poses[:, 0, 4] = H
    poses[:, 1, 4] = W
    poses[:, 2, 4] = poses[:, 2, 4] / factor

    # LLFF [x_down, y_right] -> NeRF [right, up, back]: columns [y, -x, z]
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2)

    # rescale so the closest scene content sits near depth 1/bd_factor
    scale = 1.0 / (bounds.min() * bd_factor)
    poses[:, :3, 3] *= scale
    bounds = bounds * scale

    hwf_col = poses[0, :3, 4].copy()
    pose_mats = poses[:, :3, :4]
    if recenter:
        pose_mats = recenter_poses(pose_mats)

    path_poses = spiral_path(pose_mats, bounds)
    return {
        "imgs": imgs,
        "poses": pose_mats,
        "bounds": bounds,
        "hwf": (int(hwf_col[0]), int(hwf_col[1]), float(hwf_col[2])),
        "path_poses": path_poses,
    }


@dataclass
class LLFFDataset:
    """One split of an LLFF scene: its images, poses, bounds and the
    occupancy grid's AABB. The rays and their NDC projection are built by
    the ray pool (data/pool.py::pool_from_images) and the renderer."""

    imgs: np.ndarray
    poses: np.ndarray
    hwf: tuple
    min_bound: float
    max_bound: float
    white_bkgd: bool = False
    ndc: bool = True

    near: float = field(init=False)
    far: float = field(init=False)
    aabb: np.ndarray = field(init=False)

    def __post_init__(self):
        if self.ndc:
            self.near, self.far = 0.0, 1.0
            self.aabb = self._ndc_aabb()
        else:
            self.near = float(self.min_bound) * 0.9
            self.far = float(self.max_bound)
            self.aabb = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5],
                                 np.float32)

    def _ndc_aabb(self, levels: int = 4) -> np.ndarray:
        """Base AABB sized so the outermost of `levels` grid levels covers
        every ray's NDC segment [o, o + d]; numpy on the host, one view at
        a time."""
        H, W, focal = self.hwf
        lo = np.full(3, np.inf, np.float32)
        hi = np.full(3, -np.inf, np.float32)
        for pose in np.asarray(self.poses):
            o, d = _numpy_get_rays(pose, self.hwf)
            o, d = o.reshape(-1, 3), d.reshape(-1, 3)
            # data/rays.py::to_ndc at near=1.0
            t = -(1.0 + o[:, 2]) / d[:, 2]
            o = o + t[:, None] * d
            ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
            dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
            no = np.stack([-(2.0 * focal / W) * ox / oz,
                           -(2.0 * focal / H) * oy / oz,
                           1.0 + 2.0 / oz], axis=-1)
            nd = np.stack([-(2.0 * focal / W) * (dx / dz - ox / oz),
                           -(2.0 * focal / H) * (dy / dz - oy / oz),
                           -2.0 / oz], axis=-1)
            ends = no + nd
            lo = np.minimum(lo, np.minimum(no.min(0), ends.min(0)))
            hi = np.maximum(hi, np.maximum(no.max(0), ends.max(0)))
        return (np.concatenate([lo, hi]) / 2 ** (levels - 1)).astype(
            np.float32)
