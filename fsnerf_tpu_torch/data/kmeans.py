"""Seeded K-means for pose-diverse view selection (numpy copy of
fsnerf_tpu/data/kmeans.py, index for index the same selections).

k-means++ initialisation, Lloyd iterations and n_init restarts keeping the
lowest inertia, all from one numpy Generator seeded by `seed`, so a split is
the same on every run. `select_representative_views` fits K-means on the
camera positions and takes, per cluster, the view closest to its centre.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _kmeans_pp_init(x: np.ndarray, k: int, rng: np.random.Generator):
    n = x.shape[0]
    centers = np.empty((k, x.shape[1]), x.dtype)
    idx = rng.integers(n)
    centers[0] = x[idx]
    d2 = np.sum((x - centers[0]) ** 2, axis=1)
    for i in range(1, k):
        probs = d2 / max(d2.sum(), 1e-12)
        idx = rng.choice(n, p=probs)
        centers[i] = x[idx]
        d2 = np.minimum(d2, np.sum((x - centers[i]) ** 2, axis=1))
    return centers


def kmeans(
    x: np.ndarray,
    k: int,
    n_init: int = 10,
    max_iter: int = 300,
    tol: float = 1e-6,
    seed: int = 42,
) -> Tuple[np.ndarray, np.ndarray, float]:
    """Seeded k-means++ with Lloyd iterations.

    Returns:
      (centers [k, D], labels [N], inertia).
    """
    x = np.asarray(x, np.float64)
    rng = np.random.default_rng(seed)
    best = None
    for _ in range(n_init):
        centers = _kmeans_pp_init(x, k, rng)
        for _ in range(max_iter):
            d2 = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
            labels = d2.argmin(1)
            new_centers = centers.copy()
            for j in range(k):
                pts = x[labels == j]
                if len(pts):
                    new_centers[j] = pts.mean(0)
            shift = ((new_centers - centers) ** 2).sum()
            centers = new_centers
            if shift < tol:
                break
        d2 = ((x[:, None, :] - centers[None]) ** 2).sum(-1)
        labels = d2.argmin(1)
        inertia = d2[np.arange(len(x)), labels].sum()
        if best is None or inertia < best[2]:
            best = (centers, labels, inertia)
    return best


def select_representative_views(
    positions: np.ndarray, n_views: int, seed: int = 42
) -> np.ndarray:
    """Pick n_views indices covering the scene: the view closest to each
    K-means cluster's centre.

    Args:
      positions: [N, 3] camera positions.

    Returns:
      [n_views] selected indices (unique).
    """
    positions = np.asarray(positions, np.float64)
    if n_views >= len(positions):
        return np.arange(len(positions))
    centers, labels, _ = kmeans(positions, n_views, seed=seed)
    dists = np.linalg.norm(positions - centers[labels], axis=1)
    idxs = np.empty((n_views,), dtype=int)
    taken = np.zeros(len(positions), bool)
    for i in range(n_views):
        cluster_dists = np.where((labels == i) & ~taken, dists, np.inf)
        if np.isinf(cluster_dists.min()):
            # empty cluster (argmin over all-inf would alias index 0):
            # fall back to the not-yet-selected view farthest from every
            # chosen center — keeps the n_views indices unique and diverse.
            far = np.min(np.linalg.norm(
                positions[:, None, :] - centers[None], axis=-1), axis=1)
            idxs[i] = np.argmax(np.where(taken, -np.inf, far))
        else:
            idxs[i] = np.argmin(cluster_dists)
        taken[idxs[i]] = True
    assert len(set(idxs.tolist())) == n_views
    return idxs
