"""Serving artifacts: the trained chunk renderer saved as a torch.export
program (port of fsnerf_tpu/utils/export.py).

A serving process should not re-run the model, config and checkpoint code
to render. This module exports the trained chunk renderer
(render/renderer.py::make_chunk_renderer, weights and occupancy grid
closed over) with torch.export: the weights and the grid are baked into
the program as constants, and the hand-written kernels on its path stay
in it as calls of their registered ops (`fsnerf_torch::nerf_mlp`,
ops/kernels/mlp.py; `fsnerf_torch::siren_mlp_fwd`, ops/kernels/siren.py).
The artifact is a directory of two files, renderer.pt2 (torch.export.save)
and meta.json:

    fn, meta = load_render_artifact(path)     # fn: (rays_o, rays_d)
    rgb, depth = render_frame_exported(path_or_loaded, pose)

Self-containment: loading and replaying needs PyTorch and the port's op
library, `fsnerf_tpu_torch.ops.kernels` (its ops registered on import,
the CUDA kernels built from csrc/ at their first launch). It needs no
model, config or checkpoint code. This differs from the JAX package's
StableHLO artifact, which carries its Pallas custom calls inside: here the
program names the ops, and a process that has not imported their
registrations cannot run it. `render_frame_exported` also imports
fsnerf_tpu_torch.data.rays for the camera rays; a serving process that
builds its own rays calls the loaded callable directly.

Artifacts are device-specific: meta.json's `platforms` is ["cuda"] for a
program exported on the card, whose constants and launches live there, and
["cpu"] for one exported on the CPU (the kernels' plain versions). A CUDA
artifact is never moved to the CPU: loading it without CUDA raises. Chunk
shapes are static: the callable takes exactly [chunksize, 3] float32 rays
on the artifact's device, and `render_frame_exported` does the chunk and
pad loop of render/renderer.py::render_frame.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

_ARTIFACT_FILE = "renderer.pt2"
_META_FILE = "meta.json"


class _ChunkProgram(torch.nn.Module):
    """The chunk renderer as the module torch.export traces."""

    def __init__(self, chunk_renderer: Callable):
        super().__init__()
        self.chunk_renderer = chunk_renderer

    def forward(self, rays_o, rays_d):
        return self.chunk_renderer(rays_o, rays_d)


def export_render_artifact(
    chunk_renderer: Callable,
    chunksize: int,
    out_path: str,
    *,
    hwf: Tuple[int, int, float],
    near: float,
    far: float,
    ndc: bool = False,
    extra_meta: Optional[dict] = None,
    device=None,
) -> str:
    """Export `chunk_renderer` ((rays_o, rays_d) -> (rgb, depth), from
    render/renderer.py::make_chunk_renderer, weights and grid closed over)
    on [chunksize, 3] float32 rays on `device` (the renderer's: default
    cuda, which must be present) to `out_path/`.

    Returns the artifact directory path."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("export_render_artifact: no CUDA device; pass "
                           "device='cpu' to export the CPU renderer")
    rays_o = torch.zeros((chunksize, 3), dtype=torch.float32, device=device)
    rays_d = rays_o.new_tensor([[0.0, 0.0, -1.0]]).expand(chunksize, 3) \
        .contiguous()
    program = torch.export.export(_ChunkProgram(chunk_renderer),
                                  (rays_o, rays_d), strict=False)
    os.makedirs(out_path, exist_ok=True)
    torch.export.save(program, os.path.join(out_path, _ARTIFACT_FILE))
    meta = {
        "chunksize": int(chunksize),
        "hwf": [int(hwf[0]), int(hwf[1]), float(hwf[2])],
        "near": float(near),
        "far": float(far),
        "ndc": bool(ndc),
        "platforms": [device.type],
        "torch_version": torch.__version__,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
    }
    meta.update(extra_meta or {})
    with open(os.path.join(out_path, _META_FILE), "w") as fh:
        json.dump(meta, fh, indent=1)
    return out_path


def load_render_artifact(path: str) -> Tuple[Callable, dict]:
    """Load an exported renderer: returns (fn, meta).

    fn(rays_o, rays_d) -> (rgb [chunksize, 3], depth [chunksize]) runs the
    program without autograd; both arguments must be [meta["chunksize"],
    3] float32 on the artifact's device (use render_frame_exported for
    whole frames). Raises RuntimeError for a CUDA artifact where CUDA is
    unavailable."""
    from ..ops.kernels import register_ops

    register_ops()
    with open(os.path.join(path, _META_FILE)) as fh:
        meta = json.load(fh)
    if "cuda" in meta["platforms"] and not torch.cuda.is_available():
        raise RuntimeError(f"{path} was exported for CUDA "
                           f"({meta.get('device_name')}) and this process "
                           "has no CUDA device")
    program = torch.export.load(os.path.join(path, _ARTIFACT_FILE)).module()
    return torch.no_grad()(program), meta


def render_frame_exported(artifact, pose,
                          compact_transfer: bool = False,
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Render a full frame from a pose [4, 4] or [3, 4] through an exported
    renderer.

    `artifact`: a path or a (fn, meta) pair from load_render_artifact.
    Mirrors render/renderer.py::render_frame's chunk and pad loop, on the
    artifact's device, except that every chunk has the program's static
    shape: a frame smaller than one chunk is padded to it (padded rays
    point down the -z axis and are cropped after).

    `compact_transfer`: quantize on the device before the device-to-host
    copy (rgb to uint8 with to8b semantics, depth to float16), 4x less
    transfer (see render/renderer.py::render_path).

    Returns (rgb [H, W, 3], depth [H, W]) as numpy arrays (uint8 / float16
    when compact_transfer), depth clamped to [near, far]."""
    from ..data.rays import get_rays, to_ndc

    fn, meta = (load_render_artifact(artifact)
                if isinstance(artifact, (str, os.PathLike)) else artifact)
    H, W, focal = meta["hwf"]
    chunksize = meta["chunksize"]
    device = "cuda" if "cuda" in meta["platforms"] else "cpu"
    pose = torch.as_tensor(np.asarray(pose, np.float32), device=device)
    rays_o, rays_d = get_rays(pose, (H, W, focal))
    rays_o = rays_o.reshape(-1, 3)
    rays_d = rays_d.reshape(-1, 3)
    if meta.get("ndc"):
        rays_o, rays_d = to_ndc(rays_o, rays_d, (H, W, focal), 1.0)
    n_rays = H * W
    n_chunks = -(-n_rays // chunksize)
    pad = n_chunks * chunksize - n_rays
    if pad:
        rays_o = torch.cat([rays_o, rays_o.new_zeros((pad, 3))])
        rays_d = torch.cat([rays_d, rays_d.new_tensor([[0.0, 0.0, -1.0]])
                            .expand(pad, 3)])
    imgs, depths = [], []
    for c in range(n_chunks):
        sl = slice(c * chunksize, (c + 1) * chunksize)
        rgb, depth = fn(rays_o[sl], rays_d[sl])
        imgs.append(rgb)
        depths.append(depth)
    img = torch.cat(imgs)[:n_rays].reshape(H, W, 3)
    depth = torch.clamp(torch.cat(depths)[:n_rays], meta["near"],
                        meta["far"]).reshape(H, W)
    if compact_transfer:
        img = (255.0 * torch.clamp(img, 0.0, 1.0)).to(torch.uint8)
        depth = depth.to(torch.float16)
    return img.cpu().numpy(), depth.cpu().numpy()
