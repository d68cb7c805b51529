"""Train/val/test splits by pose-diverse K-means selection (port of
fsnerf_tpu/data/splitter.py).

Test views first (test_ratio of the scene), then val views (val_ratio),
then the n_training_views training views (or the remainder), each set drawn
from the views still available by K-means closest-to-centre selection over
camera positions (data/kmeans.py), with seeds seed, seed + 1 and seed + 2.
Blender (`synthetic`), LLFF and the procedural sphere and lattice scenes
all split the same way; a procedural scene is built with
max(24, 3 * n_training_views) views of side `hw`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Tuple

import numpy as np

from .kmeans import select_representative_views


@dataclass
class Split:
    """One split's images and metadata, consumable by pool_from_images."""

    imgs: np.ndarray          # [N, H, W, 3]
    poses: np.ndarray         # [N, 3 or 4, 4]
    hwf: tuple
    near: float
    far: float
    ndc: bool
    aabb: np.ndarray
    white_bkgd: bool


class Splitter:
    """Builds the train/val/test Splits of one scene."""

    def __init__(
        self,
        dataset_type: str,
        scene: str,
        n_training_views: int = -1,
        val_ratio: float = 0.15,
        test_ratio: float = 0.15,
        data_root: str = "../datasets",
        white_bkgd: bool = False,
        factor: int = 8,
        bd_factor: float = 0.75,
        recenter: bool = True,
        ndc: bool = True,
        seed: int = 42,
        downsample: int = 1,
        hw: int = 64,
    ):
        self.dataset_type = dataset_type
        self.scene = scene
        self.n_training_views = n_training_views
        self.val_ratio = val_ratio
        self.test_ratio = test_ratio
        self.seed = seed
        self.white_bkgd = white_bkgd
        self.train_ids = None

        if dataset_type == "llff":
            from .llff import load_llff_scene
            d = load_llff_scene(os.path.join(data_root, "llff", scene),
                                factor=factor, bd_factor=bd_factor,
                                recenter=recenter)
            self._imgs, self._poses = d["imgs"], d["poses"]
            self._hwf = d["hwf"]
            self._bounds = d["bounds"]
            self.path_poses = d["path_poses"]
            self._ndc = ndc
        elif dataset_type == "synthetic":
            from .blender import BlenderDataset
            ds = BlenderDataset(scene, split="train", n_imgs=None,
                                white_bkgd=white_bkgd, data_root=data_root,
                                downsample=downsample, seed=seed)
            self._imgs, self._poses = ds.imgs, ds.poses
            self._hwf = ds.hwf
            self._bounds = None
            self.path_poses = ds.path_poses
            self._ndc = False
            self._synth_meta = ds
        elif dataset_type in ("sphere", "lattice"):
            from .synthetic import LatticeScene, SphereScene
            cls = SphereScene if dataset_type == "sphere" else LatticeScene
            ds = cls(n_imgs=max(24, (n_training_views or 8) * 3), hw=hw,
                     white_bkgd=white_bkgd, seed=seed)
            self._imgs, self._poses = ds.imgs, ds.poses
            self._hwf = ds.hwf
            self._bounds = None
            self.path_poses = ds.path_poses
            self._ndc = False
            self._synth_meta = ds
        else:
            raise ValueError(
                f"Dataset of type '{dataset_type}' is not supported.")

    def split(self) -> None:
        """Select the test, then the val, then the train index sets."""
        n = len(self._poses)
        available = np.arange(n)
        rng_seed = self.seed

        n_test = int(self.test_ratio * n)
        self.test_ids, available = self._select(available, n_test, rng_seed)
        n_val = int(self.val_ratio * n)
        self.val_ids, available = self._select(available, n_val, rng_seed + 1)

        if self.n_training_views < 0:
            self.train_ids = available
        else:
            if self.n_training_views == 0:
                raise ValueError(
                    "the specified number of training images must be greater "
                    "than zero.")
            self.train_ids, _ = self._select(available, self.n_training_views,
                                             rng_seed + 2)

    def _select(self, available: np.ndarray, n_samples: int, seed: int):
        if n_samples == 0:
            return np.array([], dtype=int), available
        x = self._poses[available][:, :3, 3]
        sel = select_representative_views(x, n_samples, seed=seed)
        chosen = available[sel]
        remaining = np.array([i for i in available if i not in set(chosen)])
        return chosen, remaining

    def get_splits(self) -> Tuple[Split, Split, Split]:
        """The train, val and test Splits."""
        assert self.train_ids is not None, \
            "Split the source data before building the datasets."

        def build(ids) -> Split:
            imgs, poses = self._imgs[ids], self._poses[ids]
            if self.dataset_type == "llff":
                from .llff import LLFFDataset
                ds = LLFFDataset(imgs, poses, self._hwf,
                                 float(self._bounds.min()),
                                 float(self._bounds.max()),
                                 white_bkgd=self.white_bkgd, ndc=self._ndc)
                return Split(imgs, poses, self._hwf, ds.near, ds.far,
                             self._ndc, ds.aabb, self.white_bkgd)
            meta = self._synth_meta
            return Split(imgs, poses, self._hwf, meta.near, meta.far,
                         False, np.asarray(meta.aabb), self.white_bkgd)

        return (build(self.train_ids), build(self.val_ids),
                build(self.test_ids))
