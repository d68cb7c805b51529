"""Ray-sharded training step and tiled frame rendering (port of
fsnerf_tpu/parallel/train_parallel.py).

Training: every rank runs the single-GPU step's loss (train/step.py::
make_loss_fn) on its share of the step's rays, then the gradients are
averaged over the ranks in one all-reduce, as are the loss and the metrics,
and every rank applies the same Adam update and the same grid refresh, its
densities evaluated rank by rank (ops/occgrid.py::update_'s shard). The
weights, the Adam state, the grid and the generator stay replicated.

Draws. The JAX step folds the device index into its batch and render keys,
so each chip draws its own rays. The port draws the global batch's indices
and render jitter from the replicated state generator and each rank takes
its rows (Mesh.rows): every rank advances the generator alike, so the
state stays replicated (a checkpoint from rank 0 resumes every rank
bitwise), and the union of the ranks' batches is the single-GPU step's
batch. A draws object handed in (the tests hand in the JAX step's
per-device draws, concatenated in rank order) is read the same way.

Graphs. Every decision the host takes (the step kind, the compaction
ladder's rung, the divergence guard) reads the step count or all-reduced
metrics, so the ranks take the same steps and collectives. Under NCCL on
the card a step is captured and replayed as a CUDA graph, collectives
included, as the single-GPU step is. Under gloo, which stages tensors
through the host where a graph cannot follow, the steps run eagerly: that
is the rule (ParallelTrainStep.graphed), never a fallback from a capture
that failed.

Rendering: render/renderer.py::make_chunk_renderer(mesh=) marches each
chunk's rays rank by rank (render_rays_tiled, or the fused ray march's
blocks, see there) and gathers them.
"""

from __future__ import annotations

import torch

from ..render.renderer import render_rays_tiled  # noqa: F401
from ..train.step import TrainStep, render_draws
from .mesh import Mesh


class ParallelTrainStep(TrainStep):
    """TrainStep over a data-parallel group: each rank's batch is its rows
    of the global batch of world * max(1, batch_size // world) rays, the
    gradients and metrics are averaged, the refresh is sharded."""

    def __init__(self, model, cfg, optimizer, pool, scene, mesh: Mesh):
        super().__init__(model, cfg, optimizer, pool, scene)
        self.mesh = mesh
        self.local_bs = max(1, cfg.train.batch_size // mesh.world)

    @property
    def graphed(self) -> bool:
        """CUDA graphs under NCCL on the card; gloo steps run eagerly."""
        return self.device.type == "cuda" and self.mesh.backend == "nccl"

    def draw(self, draws, pool):
        n = self.local_bs * self.mesh.world
        rows = self.mesh.rows(n)
        idx = draws.batch_indices(pool, n)[rows]
        u = render_draws(self.cfg, draws, n, self.device)
        if isinstance(u, tuple):
            u = tuple(x[rows] for x in u)
        elif u is not None:
            u = u[rows]
        return pool.gather(idx), u

    def reduce(self, loss, main_mse, spr, nv):
        """One all-reduce of the flattened gradients, one of the four
        metrics; both averages over the ranks."""
        params = [p for p in self.model.parameters() if p.grad is not None]
        flat = torch.cat([p.grad.reshape(-1) for p in params])
        self.mesh.all_mean_(flat)
        for p, g in zip(params, flat.split([p.numel() for p in params])):
            p.grad.copy_(g.view_as(p.grad))
        m = self.mesh.all_mean_(torch.stack([
            loss, main_mse, torch.as_tensor(spr, dtype=loss.dtype),
            torch.as_tensor(nv, dtype=loss.dtype)]))
        return m[0], m[1], m[2], m[3]


def make_parallel_train_step(model, cfg, optimizer, pool, scene,
                             mesh: Mesh) -> ParallelTrainStep:
    """The data-parallel train step of `cfg` over `mesh`, called as the
    single-GPU one (step(state, pool=None, draws=None) -> (state,
    metrics); .replay on the card under NCCL)."""
    return ParallelTrainStep(model, cfg, optimizer, pool, scene, mesh)
