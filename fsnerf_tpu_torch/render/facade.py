"""Object-oriented renderer facade (port of fsnerf_tpu/render/facade.py).

`Renderer` binds the model, the occupancy grid and the sampling options
once and exposes the functional renderer (render/renderer.py) underneath:
`render_rays` for a batch of rays, `render_frame` for one pose and
`render_poses` for a path.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import renderer as R


class Renderer:
    """Bound renderer over (model_fn, grid, sampling options)."""

    def __init__(
        self,
        model_fn,
        grid=None,
        *,
        strategy: str = "occgrid",
        n_samples: int = 512,
        n_fine: int = 128,
        n_compact: int = 192,
        early_stop_eps: float = 1e-4,
        render_step_size: float = 5e-3,
        near: float = 2.0,
        far: float = 6.0,
        ndc: bool = False,
        white_bkgd: bool = False,
        chunksize: int = 16384,
    ):
        self.model_fn = model_fn
        self.grid = grid
        self.strategy = strategy
        self.n_samples = n_samples
        self.n_fine = n_fine
        self.n_compact = n_compact
        self.early_stop_eps = early_stop_eps
        self.render_step_size = render_step_size
        self.near = near
        self.far = far
        self.ndc = ndc
        self.white_bkgd = white_bkgd
        self.chunksize = chunksize

    @classmethod
    def from_state(cls, model, state, cfg, scene) -> "Renderer":
        """Build from a TrainState (its grid), the model, a Config and the
        scene's metadata (near, far, ndc)."""
        def model_fn(x, d=None):
            return model(x, d)
        return cls(
            model_fn, state.grid,
            strategy=cfg.sampling.strategy,
            n_samples=cfg.sampling.n_samples,
            n_fine=cfg.sampling.n_fine,
            n_compact=cfg.sampling.n_compact,
            early_stop_eps=cfg.sampling.early_stop_eps,
            render_step_size=cfg.sampling.render_step_size,
            near=scene.near, far=scene.far, ndc=scene.ndc,
            white_bkgd=cfg.data.white_bkgd,
            chunksize=2 * cfg.train.batch_size,
        )

    @torch.no_grad()
    def render_rays(self, rays_o: torch.Tensor, rays_d: torch.Tensor
                    ) -> dict:
        """Render a ray batch [R, 3] without random draws: the occgrid
        result, or the hierarchical fine pass."""
        if self.strategy == "occgrid":
            return R.render_rays_occgrid(
                self.model_fn, rays_o, rays_d, self.grid, self.n_samples,
                render_step_size=self.render_step_size,
                white_bkgd=self.white_bkgd, n_compact=self.n_compact,
                early_stop_eps=self.early_stop_eps)
        _, fine = R.render_rays_hierarchical(
            self.model_fn, rays_o, rays_d, self.near, self.far,
            self.n_samples, self.n_fine, white_bkgd=self.white_bkgd)
        return fine

    def _frame_kwargs(self) -> dict:
        return dict(strategy=self.strategy, grid=self.grid,
                    n_samples=self.n_samples, n_fine=self.n_fine,
                    render_step_size=self.render_step_size, ndc=self.ndc,
                    white_bkgd=self.white_bkgd, chunksize=self.chunksize,
                    n_compact=self.n_compact,
                    early_stop_eps=self.early_stop_eps)

    def render_frame(self, pose: torch.Tensor, hwf
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
        return R.render_frame(self.model_fn, pose, hwf, self.near, self.far,
                              **self._frame_kwargs())

    def render_poses(self, poses, hwf, device=None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """Render a pose path."""
        return R.render_path(self.model_fn, poses, hwf, self.near, self.far,
                             device=device, **self._frame_kwargs())
