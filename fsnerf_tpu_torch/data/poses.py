"""Camera poses (numpy copy of fsnerf_tpu/data/poses.py).

pose_from_spherical / trans_t / rot_theta / rot_phi: camera placed at
`radius` along +z looking down -z at the origin, tilted by colatitude theta
about world x, then rotated by azimuth phi about world z. spherical_path:
the inward-facing orbit used for path renders. viewmatrix / avg_pose /
recenter_poses / spiral_path: the LLFF average-pose frame and its spiral
render path.
"""

from __future__ import annotations

import numpy as np


def trans_t(t: float) -> np.ndarray:
    m = np.eye(4, dtype=np.float32)
    m[2, 3] = t
    return m


def rot_theta(theta: float) -> np.ndarray:
    """Rotation about the world x-axis (radians)."""
    c, s = np.cos(theta), np.sin(theta)
    m = np.eye(4, dtype=np.float32)
    m[1, 1], m[1, 2] = c, -s
    m[2, 1], m[2, 2] = s, c
    return m


def rot_phi(phi: float) -> np.ndarray:
    """Rotation about the world z-axis (radians)."""
    c, s = np.cos(phi), np.sin(phi)
    m = np.eye(4, dtype=np.float32)
    m[0, 0], m[0, 1] = c, -s
    m[1, 0], m[1, 1] = s, c
    return m


def pose_from_spherical(radius: float, theta_deg: float,
                        phi_deg: float) -> np.ndarray:
    """4x4 camera-to-world pose from spherical coordinates."""
    pose = trans_t(radius)
    pose = rot_theta(np.deg2rad(theta_deg)) @ pose
    pose = rot_phi(np.deg2rad(phi_deg)) @ pose
    return pose


def spherical_path(radius: float = 4.0311289, theta_deg: float = 50.0,
                   frames: int = 90) -> np.ndarray:
    """Inward-facing orbit for path rendering."""
    phis = np.linspace(0.0, 360.0, frames, endpoint=False)
    return np.stack([pose_from_spherical(radius, theta_deg, p) for p in phis])


def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """[3, 4] camera matrix from view dir, up vector, position."""
    z = normalize(z)
    x = normalize(np.cross(up, z))
    y = normalize(np.cross(z, x))
    return np.stack([x, y, z, pos], axis=1)


def avg_pose(poses: np.ndarray) -> np.ndarray:
    """Average camera pose of [N, 3, 4+] poses."""
    center = poses[:, :3, 3].mean(0)
    viewdir = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return viewmatrix(viewdir, up, center)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Transform [N, 3, 4] poses into the average-pose frame."""
    c2w = avg_pose(poses)
    bottom = np.array([[0, 0, 0, 1.0]], np.float32)
    c2w4 = np.concatenate([c2w[:3, :4], bottom], axis=0)
    homog = np.concatenate(
        [poses[:, :3, :4],
         np.tile(bottom[None], (poses.shape[0], 1, 1))], axis=1)
    out = np.linalg.inv(c2w4) @ homog
    return out[:, :3, :4].astype(np.float32)


def spiral_path(
    poses: np.ndarray,
    bounds: np.ndarray,
    n_views: int = 120,
    n_rots: int = 2,
    zrate: float = 0.5,
    path_zflat: bool = False,
) -> np.ndarray:
    """LLFF spiral render path: 120 views, 2 rotations, zrate 0.5, radii
    at the 90th percentile of |t|.

    Args:
      poses: [N, 3, 4] recentered camera poses.
      bounds: [N, 2] per-view near/far bounds.

    Returns:
      [F, 3, 4] path poses.
    """
    c2w = avg_pose(poses)
    up = normalize(poses[:, :3, 1].sum(0))
    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1.0 - dt) / close_depth + dt / inf_depth)

    tt = poses[:, :3, 3]
    rads = np.percentile(np.abs(tt), 90, 0)

    if path_zflat:
        zloc = -close_depth * 0.1
        c2w = c2w.copy()
        c2w[:3, 3] = c2w[:3, 3] + zloc * c2w[:3, 2]
        rads[2] = 0.0
        n_rots = 1
        n_views = n_views // 2

    rads = np.array(list(rads) + [1.0])
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_views + 1)[:-1]:
        c = c2w[:3, :4] @ (np.array(
            [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads)
        z = normalize(c - c2w[:3, :4] @ np.array([0, 0, -focal, 1.0]))
        out.append(viewmatrix(z, up, c))
    return np.stack(out).astype(np.float32)
