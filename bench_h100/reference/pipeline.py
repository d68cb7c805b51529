"""The reference's training steps, from the benchmark's own inputs: its
weights, its scene, its seed.

Training: each step draws its rays, its phase jitter and, on a refresh
step, the refresh's cell jitter from one torch.Generator seeded with the
run's seed, in that order (the draws the configuration's sampler makes);
builds the lattice on the grid, compacts it, runs the MLP in the
reference's precision, composites over a white or black background, takes
the MSE and its gradients by autograd, and applies Adam (0.9, 0.999, eps
1e-8 outside the root, float32) at the schedule's rate. The grid starts
with every cell occupied and is refreshed after the update of every step
on the interval, over all cells before the warm-up ends: EMA max(decay *
occ, sigma * step) at jittered cell positions, the threshold the smaller
of the mean and occ_thre. The compaction K starts at the ceiling and
follows the ladder (a mean surviving count observed after every step:
up at once, down after two observations below).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import nerf, sinerf
from .ops import (Quant, compact, composite, lattice, ladder_target,
                  pixel_rays, query_plan, surviving, tables)

MODELS = {"nerf": nerf, "sinerf": sinerf}


def model_args(cfg: dict) -> dict:
    m, e = cfg["model"], cfg["encoder"]
    return {"n_layers": m["n_layers"], "skip": tuple(m["skip"]),
            "n_freqs": e["n_freqs"], "n_freqs_views": e["n_freqs_views"]}


class Grid:
    """One level's EMA values, threshold and query tables."""

    def __init__(self, cfg: dict, aabb, device):
        s = cfg["sampling"]
        self.res = s["grid_resolution"]
        self.stride, self.dilation = query_plan(
            aabb, self.res, s["render_step_size"], s["n_samples"])
        self.aabb = torch.as_tensor(np.asarray(aabb, np.float32),
                                    device=device)
        self.occs = torch.zeros(self.res ** 3, device=device)
        self.thre = torch.tensor(-1.0, device=device)
        self._tables()

    def _tables(self):
        self.occ, self.od = tables(self.occs, self.res, self.dilation)

    def view(self) -> dict:
        return {"occ": self.occ, "od": self.od, "thre": self.thre,
                "aabb": self.aabb, "res": self.res}

    def refresh(self, sigma_fn: Callable, jitter: torch.Tensor,
                cfg: dict, chunk: int = 1 << 18):
        s = cfg["sampling"]
        res = self.res
        idx = torch.arange(res ** 3, device=self.occs.device)
        ijk = torch.stack([idx // (res * res), (idx // res) % res,
                           idx % res], -1).float()
        lo, hi = self.aabb[:3], self.aabb[3:]
        x = lo + (ijk + jitter) / res * (hi - lo)
        with torch.no_grad():
            sig = torch.cat([sigma_fn(xc) for xc in torch.split(x, chunk)])
        self.occs = torch.maximum(self.occs * s["ema_decay"],
                                  sig * s["render_step_size"])
        self.thre = torch.clamp(self.occs.mean(), max=s["occ_thre"])
        self._tables()


def samples(o, d, grid: Grid, cfg: dict, u, k: int):
    """(t, delta, mask [R, k], mean surviving count) of rays [R, 3]."""
    s = cfg["sampling"]
    t, dt, inbox = lattice(o, d, grid.aabb, s["n_samples"],
                           s["render_step_size"], u)
    mask = surviving(o, d, t, dt, inbox, grid.view(), s["render_step_size"],
                     grid.stride, s["early_stop_eps"])
    nv = mask.sum(-1).float()
    return (*compact(t, dt, mask, k), nv)


def render_rays(w, cfg, o, d, grid: Grid, k: int, u, q, bkgd: float):
    """(rgb [R, 3], depth [R], mean surviving count)."""
    mod = MODELS[cfg["reference"]]
    t, delta, mask, nv = samples(o, d, grid, cfg, u, k)
    R = o.shape[0]
    x = o[:, None] + d[:, None] * t[..., None]
    out = mod.forward(w, model_args(cfg), x.reshape(-1, 3),
                      d[:, None].expand(R, k, 3).reshape(-1, 3), q
                      ).reshape(R, k, 4)
    rgb, depth = composite(out[..., 3], out[..., :3], t, delta, mask, bkgd)
    return rgb, depth, nv.mean()


def lr_at(step: int, traffic: dict) -> float:
    return float(np.float32(traffic["lro"]) * np.float32(
        traffic["decay_rate"]) ** np.float32(step / traffic["n_iters"]))


def refresh_due(step: int, s: dict) -> bool:
    late = s["update_interval_late"]
    interval = (late if late and step >= s["update_interval_late_start"]
                else s["update_interval"])
    return step % interval == 0


def train_steps(w0: Dict[str, torch.Tensor], cfg: dict, traffic: dict,
                views: dict, seed: int, n_steps: int,
                precision: str = "float32",
                fault: Optional[str] = None) -> dict:
    """The first n_steps training steps from weights w0: each step's loss,
    the first step's gradient, the weights after the last step and the
    grid's EMA values then. fault "half_batch" takes the loss over the
    first half of each step's rays (a fault the comparison must catch)."""
    s = cfg["sampling"]
    mod = MODELS[cfg["reference"]]
    q = Quant(precision)
    dev = views["imgs"].device
    H, W, _ = views["hwf"]
    poses = torch.as_tensor(views["poses"], device=dev)
    gt_all = views["imgs"].reshape(-1, 3)
    n_rays = gt_all.shape[0]
    bkgd = 1.0 if views["white_bkgd"] else 0.0
    w = {n: p.detach().clone().float().requires_grad_(True)
         for n, p in w0.items()}
    m = {n: torch.zeros_like(p) for n, p in w.items()}
    v = {n: torch.zeros_like(p) for n, p in w.items()}
    grid = Grid(cfg, views["aabb"], dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    k, below, k_max = s["n_compact"], 0, s["n_compact"]
    B = traffic["batch_size"]
    losses, grad1 = [], None
    for step in range(n_steps):
        idx = torch.randint(0, n_rays, (B,), generator=gen, device=dev)
        u = torch.rand((B, 1), generator=gen, device=dev)
        view = torch.div(idx, H * W, rounding_mode="floor")
        o = torch.empty((B, 3), device=dev)
        d = torch.empty((B, 3), device=dev)
        for c in range(poses.shape[0]):
            sel = view == c
            o[sel], d[sel] = pixel_rays(poses[c], views["hwf"],
                                        idx[sel] % (H * W))
        rgb, _, nv = render_rays(w, cfg, o, d, grid, k, u, q, bkgd)
        gt = gt_all[idx]
        if fault == "half_batch":
            rgb, gt = rgb[: B // 2], gt[: B // 2]
        loss = torch.mean(torch.square(rgb - gt))
        grads = torch.autograd.grad(loss, list(w.values()))
        losses.append(float(loss.detach()))
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in zip(w, grads)}
        lr, t = lr_at(step, traffic), step + 1
        with torch.no_grad():
            for (n, p), g in zip(w.items(), grads):
                m[n].mul_(0.9).add_(0.1 * g)
                v[n].mul_(0.999).add_(0.001 * g * g)
                mh = m[n] / (1.0 - 0.9 ** t)
                vh = v[n] / (1.0 - 0.999 ** t)
                p.sub_(lr * mh / (torch.sqrt(vh) + 1e-8))
        if refresh_due(step, s):
            if step >= s["warmup_steps"]:
                raise ValueError("the reference refreshes every cell only")
            jit = torch.rand((grid.res ** 3, 3), generator=gen, device=dev)
            wd = {n: p.detach() for n, p in w.items()}
            grid.refresh(lambda x: mod.density(wd, model_args(cfg), x, q),
                         jit, cfg)
        target = ladder_target(float(nv), k_max, s["compact_margin"])
        if s["adapt_compact"] and k_max > 16:
            if target > k:
                k, below = target, 0
            elif target < k:
                below += 1
                if below >= 2:
                    k, below = target, 0
            else:
                below = 0
    return {"losses": losses, "grad": grad1,
            "weights": {n: p.detach() for n, p in w.items()},
            "occs": grid.occs}


__all__ = ["Grid", "train_steps"]
