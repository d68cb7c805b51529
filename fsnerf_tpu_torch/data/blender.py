"""Blender (NeRF-synthetic) scenes (port of fsnerf_tpu/data/blender.py).

  * <root>/synthetic/<scene>/transforms_<split>.json and its PNG frames,
    decoded by the port's native decoder (fsnerf_tpu_torch/native);
    focal = 0.5 * W / tan(0.5 * camera_angle_x);
  * near 2 / far 6, no NDC, AABB [-1.5, 1.5]^3;
  * white-background compositing rgb * a + (1 - a);
  * a seeded `testimg`;
  * few-shot selection: K-means over the positions of the poses with
    positive z, the view closest to each centre (data/kmeans.py);
  * box-filter `downsample`;
  * the spherical render path: radius 4.0311289, theta 50 deg, 90 frames.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np

from ..native import decode_images
from .kmeans import select_representative_views
from .poses import spherical_path


@dataclass
class BlenderDataset:
    """Few-shot Blender scene: images, poses, intrinsics, render path."""

    scene: str
    split: str = "train"
    n_imgs: Optional[int] = None
    white_bkgd: bool = False
    data_root: str = "../datasets"
    downsample: int = 1
    seed: int = 42
    near: float = 2.0
    far: float = 6.0
    ndc: bool = False

    imgs: np.ndarray = field(init=False)
    poses: np.ndarray = field(init=False)
    hwf: tuple = field(init=False)
    aabb: np.ndarray = field(init=False)
    path_poses: np.ndarray = field(init=False)
    testimg: np.ndarray = field(init=False)
    testpose: np.ndarray = field(init=False)

    def __post_init__(self):
        imgs, poses, hwf = self._load()
        self.hwf = hwf
        self.path_poses = spherical_path(4.0311289, 50.0, 90)

        if imgs.shape[-1] == 4 and self.white_bkgd:
            imgs = imgs[..., :3] * imgs[..., -1:] + (1.0 - imgs[..., -1:])
        else:
            imgs = imgs[..., :3]

        rng = np.random.default_rng(self.seed)
        idx = int(rng.integers(0, imgs.shape[0]))
        self.testimg = imgs[idx]
        self.testpose = poses[idx]

        if self.n_imgs is not None and self.n_imgs < len(imgs):
            x = poses[:, :3, 3]
            keep = x[:, -1] > 0        # drop below-ground poses
            kept_idx = np.nonzero(keep)[0]
            sel = select_representative_views(x[keep], self.n_imgs, self.seed)
            idxs = kept_idx[sel]
            imgs = imgs[idxs]
            poses = poses[idxs]

        self.imgs = imgs
        self.poses = poses
        self.aabb = np.array([-1.5, -1.5, -1.5, 1.5, 1.5, 1.5], np.float32)

    def _load(self) -> Tuple[np.ndarray, np.ndarray, tuple]:
        path = os.path.join(self.data_root, "synthetic", self.scene)
        with open(os.path.join(path, f"transforms_{self.split}.json")) as fh:
            meta = json.load(fh)

        poses = np.stack([np.array(f["transform_matrix"], np.float32)
                          for f in meta["frames"]], 0)
        files = [os.path.join(path, f["file_path"] + ".png")
                 for f in meta["frames"]]
        imgs = decode_images(files)

        if self.downsample > 1:
            d = self.downsample
            H, W = imgs.shape[1] // d, imgs.shape[2] // d
            # box-filter downsample (exact average pooling)
            imgs = imgs[:, :H * d, :W * d].reshape(
                imgs.shape[0], H, d, W, d, imgs.shape[-1]).mean((2, 4))

        H, W = imgs.shape[1:3]
        focal = 0.5 * W / np.tan(0.5 * float(meta["camera_angle_x"]))
        return imgs, poses, (H, W, float(focal))
