"""Device-resident ray pool (port of fsnerf_tpu/data/pool.py).

The few-shot ray set fits in device memory (8 views x 800^2 x 9 floats is
~180 MB), so batches are drawn there, with replacement, from an explicit
torch.Generator on the pool's device: no host traffic in the train loop.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


class RayPool:
    """Flattened (rays_o, rays_d, rgb) [N, 3] float32 on one device."""

    def __init__(self, rays_o, rays_d, rgb, device=None):
        if not (rays_o.shape == rays_d.shape == rgb.shape):
            raise ValueError("rays_o, rays_d and rgb must share one shape")

        def put(a):
            return torch.as_tensor(a, dtype=torch.float32).to(device)

        self.rays_o, self.rays_d, self.rgb = put(rays_o), put(rays_d), put(rgb)
        self.n = int(self.rays_o.shape[0])

    @property
    def device(self) -> torch.device:
        return self.rays_o.device

    def sample_indices(self, generator: torch.Generator,
                       batch_size: int) -> torch.Tensor:
        """[batch_size] int64 indices drawn with replacement."""
        return torch.randint(0, self.n, (batch_size,), generator=generator,
                             device=self.device)

    def sample(self, generator: torch.Generator, batch_size: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        return self.gather(self.sample_indices(generator, batch_size))

    def gather(self, idx: torch.Tensor):
        """The rays at given indices (e.g. indices drawn elsewhere)."""
        return self.rays_o[idx], self.rays_d[idx], self.rgb[idx]


def pool_from_images(imgs: np.ndarray, poses: np.ndarray, hwf,
                     ndc: bool = False, device=None) -> RayPool:
    """A pool from [N, H, W, 3] images and [N, 4, 4] poses; the rays are
    built on `device`."""
    from .rays import get_rays, to_ndc

    os_, ds_ = [], []
    for pose in np.asarray(poses, np.float32):
        o, d = get_rays(torch.as_tensor(pose, device=device), hwf)
        os_.append(o.reshape(-1, 3))
        ds_.append(d.reshape(-1, 3))
    o, d = torch.cat(os_), torch.cat(ds_)
    if ndc:
        o, d = to_ndc(o, d, hwf, 1.0)
    rgb = torch.as_tensor(np.asarray(imgs, np.float32).reshape(-1, 3),
                          device=device)
    return RayPool(o, d, rgb, device=device)
