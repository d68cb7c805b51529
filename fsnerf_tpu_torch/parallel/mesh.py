"""The data-parallel group and its collectives (port of
fsnerf_tpu/parallel/mesh.py).

The JAX package's mesh is one 'data' axis over the chips. In PyTorch a
process drives one GPU, so the port's counterpart is the process group
that torchrun starts (one rank per GPU): `Mesh` holds its size, this
process's rank and device, and the collectives the training step, the grid
refresh and the tiled renderer use. The weights, the Adam state and the
occupancy grid are replicated; only the ray axis is sharded.

Backends: NCCL for CUDA tensors, gloo for CPU tensors. Gloo also serves
several ranks on one GPU (NCCL refuses a duplicate device); it has no
all-gather for CUDA tensors, so every gloo collective here stages its
tensor through the host.

Multi-node: torchrun numbers ranks host-major (node_rank * nproc_per_node
+ local_rank), which is the row-major device order of the JAX package's
hybrid ('replica' over hosts x 'data' within a host) mesh, and NCCL picks
its own hierarchical algorithms across nodes. So one flat group serves
both shapes, and make_hybrid_mesh returns it.
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist


def distributed_init(backend: Optional[str] = None, store=None,
                     rank: Optional[int] = None,
                     world_size: Optional[int] = None) -> None:
    """Join the process group, before any CUDA call of the process.

    Without a `store`, reads torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT); a process started without it is
    a single-process run and nothing happens, as in the JAX package. With a
    `store` (a FileStore, a TCPStore), rank and world_size are given.
    backend None: NCCL when CUDA is available, else gloo. Under NCCL the
    process's CUDA device becomes cuda:LOCAL_RANK. A no-op once the group
    exists."""
    if dist.is_initialized():
        return
    if store is None and "WORLD_SIZE" not in os.environ:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank())
    if store is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world_size)


def local_rank() -> int:
    """This process's rank on its node (torchrun's LOCAL_RANK; else the
    group rank, else 0)."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return dist.get_rank() if dist.is_initialized() else 0


@dataclass(frozen=True)
class Mesh:
    """The data-parallel group of one process: `world` ranks, this one's
    `rank`, the `device` it computes on and the group's `backend`."""

    world: int
    rank: int
    device: torch.device
    backend: str

    def rows(self, n: int) -> slice:
        """This rank's contiguous share of n rows (n a multiple of
        world)."""
        if n % self.world:
            raise ValueError(f"{n} rows do not split over {self.world} "
                             "ranks")
        k = n // self.world
        return slice(self.rank * k, (self.rank + 1) * k)

    def _staged(self, t: torch.Tensor, op) -> torch.Tensor:
        """op(t) in place on the backend's device: gloo works on host
        copies, NCCL on the rank's GPU."""
        dev = torch.device("cpu") if self.backend == "gloo" else self.device
        if t.device == dev:
            op(t)
            return t
        s = t.to(dev)
        op(s)
        return t.copy_(s)

    def all_mean_(self, t: torch.Tensor) -> torch.Tensor:
        """t <- the mean of every rank's t, in place: a SUM, then / world
        (gloo has no AVG). Every rank receives the same bits."""
        self._staged(t, dist.all_reduce)
        return t.div_(self.world)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t concatenated along dim 0 in rank order, on t's
        device."""
        dev = torch.device("cpu") if self.backend == "gloo" else self.device
        s = t.to(dev).contiguous()
        parts = [torch.empty_like(s) for _ in range(self.world)]
        dist.all_gather(parts, s)
        return torch.cat(parts).to(t.device)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """t <- rank src's t, in place."""
        if t.dtype == torch.bool:
            self._staged(t.view(torch.uint8),
                         lambda s: dist.broadcast(s, src))
            return t
        return self._staged(t, lambda s: dist.broadcast(s, src))


def make_mesh(n_devices: int = 0, device=None) -> Mesh:
    """The data-parallel group over the process group's ranks (call
    distributed_init first). n_devices 0 takes every rank; another value
    must equal the group's size, since a process drives one GPU: launch
    that many with torchrun. device None: cuda:LOCAL_RANK."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: launch one process per GPU "
            "with torchrun --nproc_per_node N ... --distributed")
    world = dist.get_world_size()
    if n_devices and n_devices != world:
        raise ValueError(
            f"n_devices {n_devices} is not the process group's {world} "
            "ranks: a process drives one GPU, so launch n_devices processes "
            f"(torchrun --nproc_per_node {n_devices})")
    if device is None:
        device = torch.device("cuda", local_rank())
    return Mesh(world, dist.get_rank(), torch.device(device),
                dist.get_backend())


def make_hybrid_mesh(device=None) -> Mesh:
    """The flat group of make_mesh: torchrun's host-major ranks are the
    hybrid mesh's device order (see the module docstring)."""
    return make_mesh(device=device)


def batch_sharding(mesh: Mesh, n_rows: int) -> slice:
    """This rank's rows of a batch of n_rows (the ray axis sharded over
    the group)."""
    return mesh.rows(n_rows)


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of each tensor of a (rays_o, rays_d, rgb) batch."""
    return tuple(x[batch_sharding(mesh, x.shape[0])] for x in batch)


def replicate(tree, mesh: Mesh):
    """Rank 0's values in every rank's tensors, in place: tensors, modules'
    parameters and buffers, optimizers' state, generators' state, and these
    inside dataclasses (a TrainState, an OccGrid), lists, tuples and dicts.
    Python numbers stay as they are: every rank derives them from the same
    config. Returns tree."""
    if isinstance(tree, torch.Tensor):
        mesh.broadcast_(tree)
    elif isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in list(tree.parameters()) + list(tree.buffers()):
                mesh.broadcast_(t)
    elif isinstance(tree, torch.optim.Optimizer):
        for state in tree.state.values():
            replicate(state, mesh)
        for group in tree.param_groups:
            if isinstance(group.get("lr"), torch.Tensor):
                mesh.broadcast_(group["lr"])
    elif isinstance(tree, torch.Generator):
        state = tree.get_state()
        tree.set_state(mesh.broadcast_(state))
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            replicate(getattr(tree, f.name), mesh)
    elif isinstance(tree, dict):
        for v in tree.values():
            replicate(v, mesh)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            replicate(v, mesh)
    return tree
