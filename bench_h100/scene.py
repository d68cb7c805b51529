"""The one generator of the benchmark's inputs: camera poses, the box
lattice seen from them, and the seeded choices that a traffic file's
parameters leave open.

The lattice is a torch copy of the port's numpy ray tracer
(`fsnerf_tpu_torch/data/synthetic.py::render_lattice_image`, frozen here so
that a later change to the program cannot move the yardstick): a base plate,
a 5 x 5 grid of thin columns with seeded heights, some dropped, and five
horizontal beams; the nearest hit's entry face is shaded Lambertian under a
checker albedo with a continuous modulation. The views are traced on the
device in blocks of rays.

Poses follow the Blender convention of the port (`data/poses.py`): the
camera sits at `radius` on +z looking at the origin, is tilted by the
colatitude about world x, then turned by the azimuth about world z.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

_LIGHT = np.array([1.0, 0.6, 1.8], np.float64)
_LIGHT = (_LIGHT / np.linalg.norm(_LIGHT)).astype(np.float32)
_CHECKER_A = (0.85, 0.30, 0.20)
_CHECKER_B = (0.92, 0.80, 0.25)


def pose(radius: float, colatitude_deg: float, azimuth_deg: float
         ) -> np.ndarray:
    """4 x 4 float32 camera-to-world matrix."""
    t, p = math.radians(colatitude_deg), math.radians(azimuth_deg)
    lift = np.eye(4, dtype=np.float32)
    lift[2, 3] = radius
    tilt = np.eye(4, dtype=np.float32)
    tilt[1, 1], tilt[1, 2], tilt[2, 1], tilt[2, 2] = (
        math.cos(t), -math.sin(t), math.sin(t), math.cos(t))
    turn = np.eye(4, dtype=np.float32)
    turn[0, 0], turn[0, 1], turn[1, 0], turn[1, 1] = (
        math.cos(p), -math.sin(p), math.sin(p), math.cos(p))
    return turn @ (tilt @ lift)


def focal(hw: int, camera_angle_x: float) -> float:
    return 0.5 * hw / math.tan(0.5 * camera_angle_x)


def train_poses(traffic: dict, seed: int) -> np.ndarray:
    """[V, 4, 4] training cameras: V azimuth sectors, each camera at a
    seeded azimuth inside its sector, and a fixed set of V colatitudes
    spread over the traffic's range, dealt to the sectors in a seeded
    order. Every seed sees the scene from the same spread of heights."""
    v = int(traffic["views"])
    lo, hi = traffic["colatitude_deg"]
    rng = np.random.default_rng([int(seed), 1])
    colat = np.linspace(lo, hi, v)[rng.permutation(v)]
    sector = 360.0 / v
    azim = sector * (np.arange(v) + rng.uniform(0.0, 1.0, v))
    return np.stack([pose(traffic["radius"], c, a)
                     for c, a in zip(colat, azim)]).astype(np.float32)


def lattice_boxes(geom_seed: int) -> np.ndarray:
    """[B, 6] float32 boxes (lo xyz, hi xyz) of the lattice."""
    rng = np.random.default_rng(geom_seed)
    boxes = [(-1.25, -1.25, -1.0, 1.25, 1.25, -0.82)]
    hw = 0.07
    for gx in np.linspace(-1.0, 1.0, 5):
        for gy in np.linspace(-1.0, 1.0, 5):
            if rng.uniform() < 0.2:
                continue
            h = rng.uniform(-0.3, 1.05)
            boxes.append((gx - hw, gy - hw, -0.82, gx + hw, gy + hw, h))
    bh = 0.055
    for y, z in ((-0.5, 0.35), (0.5, -0.05), (0.0, 0.75)):
        boxes.append((-1.1, y - bh, z - bh, 1.1, y + bh, z + bh))
    for x, z in ((-1.0, 0.15), (1.0, 0.55)):
        boxes.append((x - bh, -1.1, z - bh, x + bh, 1.1, z + bh))
    return np.asarray(boxes, np.float32)


def camera_rays(c2w: torch.Tensor, hw: int, f: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-direction pinhole rays [hw * hw, 3] of one camera, pixel
    centres at integer coordinates, rows top to bottom."""
    dev = c2w.device
    j, i = torch.meshgrid(torch.arange(hw, dtype=torch.float32, device=dev),
                          torch.arange(hw, dtype=torch.float32, device=dev),
                          indexing="ij")
    d = torch.stack([(i - hw * 0.5) / f, -(j - hw * 0.5) / f,
                     -torch.ones_like(i)], dim=-1)
    d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
    d = torch.sum(d[..., None, :] * c2w[:3, :3], dim=-1).reshape(-1, 3)
    return c2w[:3, 3].expand(d.shape), d


@torch.no_grad()
def trace_lattice(o: torch.Tensor, d: torch.Tensor, boxes: torch.Tensor,
                  white_bkgd: bool, block: int = 1 << 16) -> torch.Tensor:
    """rgb [R, 3] of the lattice along rays, in blocks of `block` rays."""
    lo, hi = boxes[:, :3], boxes[:, 3:]
    light = torch.as_tensor(_LIGHT, device=o.device)
    ca = torch.tensor(_CHECKER_A, device=o.device)
    cb = torch.tensor(_CHECKER_B, device=o.device)
    out = []
    for s in range(0, o.shape[0], block):
        ob, db = o[s:s + block, None, :], d[s:s + block, None, :]
        inv = torch.where(db.abs() > 1e-9, 1.0 / db,
                          torch.full_like(db, 1e12))
        t1, t2 = (lo - ob) * inv, (hi - ob) * inv
        tmin, tmax = torch.minimum(t1, t2), torch.maximum(t1, t2)
        tnear, tfar = tmin.amax(-1), tmax.amin(-1)
        hit = (tfar >= tnear) & (tnear > 1e-4)
        tnear = torch.where(hit, tnear, torch.full_like(tnear, math.inf))
        t, b = tnear.min(-1)
        any_hit = torch.isfinite(t)
        ts = torch.where(any_hit, t, torch.zeros_like(t))
        rows = torch.arange(b.shape[0], device=o.device)
        axis = tmin[rows, b].argmax(-1)
        sgn = -torch.sign(db[rows, 0, axis])
        normal = torch.zeros((b.shape[0], 3), device=o.device)
        normal[rows, axis] = sgn
        p = ob[:, 0] + ts[:, None] * db[:, 0]
        cell = torch.floor(p * 6.0).sum(-1).to(torch.int64)
        albedo = torch.where((cell % 2 == 0)[:, None], ca, cb)
        mod = 0.82 + 0.18 * torch.sin(9.0 * p[:, 0]) * torch.sin(
            7.0 * p[:, 1] + 3.0 * p[:, 2])
        shade = 0.35 + 0.65 * torch.clamp(normal @ light, min=0.0)
        col = albedo * (shade * mod)[:, None]
        bg = 1.0 if white_bkgd else 0.0
        out.append(torch.where(any_hit[:, None], col,
                               torch.full_like(col, bg)))
    return torch.cat(out)


def train_views(traffic: dict, seed: int, device) -> dict:
    """The training scene of a traffic file: its poses, its images
    [V, H, W, 3] on `device`, hwf, near, far, aabb, white_bkgd."""
    hw = int(traffic["hw"])
    f = focal(hw, traffic["camera_angle_x"])
    poses = train_poses(traffic, seed)
    boxes = torch.as_tensor(lattice_boxes(traffic["lattice_geom_seed"]),
                            device=device)
    imgs = []
    for c2w in poses:
        o, d = camera_rays(torch.as_tensor(c2w, device=device), hw, f)
        imgs.append(trace_lattice(o, d, boxes, traffic["white_bkgd"])
                    .reshape(hw, hw, 3))
    return {"poses": poses, "imgs": torch.stack(imgs), "hwf": (hw, hw, f),
            "near": float(traffic["near"]), "far": float(traffic["far"]),
            "aabb": np.asarray(traffic["aabb"], np.float32),
            "white_bkgd": bool(traffic["white_bkgd"])}
