"""Chunking + debug-plot utilities (port of fsnerf_tpu/utils/chunks.py;
reference src/utils/utilities.py:15-32, 122-134)."""

from __future__ import annotations

from typing import List

import numpy as np


def get_chunks(inputs, chunksize: int) -> List:
    """Split an array into chunksize-row pieces (utilities.py:122-134).

    The render path uses fixed-size padded chunks instead (static shapes, the
    serving artifact's one program — render/renderer.py::render_frame,
    utils/export.py); this helper exists for host-side/API parity.
    """
    return [inputs[i: i + chunksize]
            for i in range(0, inputs.shape[0], chunksize)]


def save_origins_and_dirs(poses, out_path: str = "out/verify/poses.png"):
    """Quiver plot of camera positions + optical axes (utilities.py:15-32)."""
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    poses = np.asarray(poses)
    dirs = np.stack([-p[:3, 2] for p in poses])      # -z optical axis
    origins = poses[:, :3, -1]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    ax = plt.figure(figsize=(12, 8)).add_subplot(projection="3d")
    ax.quiver(origins[:, 0], origins[:, 1], origins[:, 2],
              dirs[:, 0], dirs[:, 1], dirs[:, 2],
              length=0.5, normalize=True)
    plt.savefig(out_path)
    plt.close()
    return out_path
