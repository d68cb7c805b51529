"""Plot helpers: depth colormapping and density-curve comparison animation
(port of fsnerf_tpu/utils/plotting.py; matplotlib imported where used).

Reference counterparts (src/utils/plotting.py):
  * apply_colormap — plotting.py:174-193: depth map -> plasma RGBA with a
    fixed-norm default vmax 6.0 (the Blender far plane).
  * density_animate — plotting.py:119-171: matplotlib FuncAnimation comparing
    the per-iteration density-vs-depth curves of two runs, saved as a GIF.
The legacy CameraPosesPlot duplicate (plotting.py:19-116) is superseded by
utils/camera3dplotter.py and intentionally not reproduced.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def apply_colormap(
    depth: np.ndarray,
    cmap: str = "plasma",
    vmin: float = 0.0,
    vmax: float = 6.0,
) -> np.ndarray:
    """Map a [H, W] depth array to RGBA uint8-compatible floats in [0, 1]."""
    import matplotlib
    import matplotlib.cm as cm

    norm = matplotlib.colors.Normalize(vmin=vmin, vmax=vmax)
    mapper = cm.ScalarMappable(norm=norm, cmap=cmap)
    return mapper.to_rgba(np.asarray(depth))


def density_animate(
    curves_a: np.ndarray,
    curves_b: np.ndarray,
    t_vals: Optional[np.ndarray] = None,
    labels=("run A", "run B"),
    interval_ms: int = 50,
    out_path: Optional[str] = None,
):
    """Animate two runs' density-vs-depth curves over training iterations.

    Args:
      curves_a/curves_b: [n_iters, n_samples] density curves per iteration.
      t_vals: optional [n_samples] depth axis (defaults to sample index).
      out_path: if given, saves a GIF there (reference writes densities.gif).

    Returns the matplotlib FuncAnimation.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.animation import FuncAnimation, PillowWriter

    n = min(len(curves_a), len(curves_b))
    x = t_vals if t_vals is not None else np.arange(curves_a.shape[1])
    fig, ax = plt.subplots(figsize=(8, 5))
    la, = ax.plot(x, curves_a[0], label=labels[0])
    lb, = ax.plot(x, curves_b[0], label=labels[1])
    ax.set_xlabel("depth")
    ax.set_ylabel("density")
    ax.legend()
    ymax = max(curves_a[:n].max(), curves_b[:n].max())
    ax.set_ylim(0, ymax * 1.05 + 1e-6)

    def update(i):
        la.set_ydata(curves_a[i])
        lb.set_ydata(curves_b[i])
        ax.set_title(f"iteration {i}")
        return la, lb

    anim = FuncAnimation(fig, update, frames=n, interval=interval_ms,
                         blit=True)
    if out_path:
        anim.save(out_path, writer=PillowWriter(fps=1000 // interval_ms))
        plt.close(fig)
    return anim
