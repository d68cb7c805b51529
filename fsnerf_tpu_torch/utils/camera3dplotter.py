"""Interactive 3D camera-pose visualization (port of
fsnerf_tpu/utils/camera3dplotter.py).

Reference counterpart: src/utils/camera3dplotter.py:10-101 (plotly scatter of
train/val/test camera positions uploaded to wandb at run-nerf.py:378-380).
Same public surface (set_poses / configure_pose_markers / set_axes_ranges /
set_axes_margins), with save_html for offline runs and upload_plot for wandb.
numpy only at import; plotly, matplotlib and wandb are imported where they
are used, and the CLI skips the plot with a warning when neither plotting
library is installed.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


_DEFAULT_MARKERS = {"size": 7, "opacity": 0.8, "color": "black"}


class Camera3DPlotter:
    def __init__(self):
        self._poses: Dict[str, np.ndarray] = {}
        self._markers: Dict[str, dict] = {}
        self._margins = dict(l=20, r=20, t=20, b=20)
        self._ranges = None

    def set_poses(self, poses: np.ndarray, name: str) -> None:
        """poses: [N, 3or4, 4] camera-to-world matrices."""
        self._poses[name] = np.asarray(poses)

    def configure_pose_markers(self, name: str, size: int = 7,
                               opacity: float = 0.8,
                               color: str = "black") -> None:
        self._markers[name] = dict(size=size, opacity=opacity, color=color)

    def set_axes_margins(self, left=20, right=20, top=20, bottom=20) -> None:
        self._margins = dict(l=left, r=right, t=top, b=bottom)

    def set_axes_ranges(self, xrange=None, yrange=None, zrange=None) -> None:
        self._ranges = dict(x=xrange, y=yrange, z=zrange)

    def _figure(self):
        import plotly.graph_objects as go

        traces = []
        for name, poses in self._poses.items():
            t = poses[:, :3, 3]
            marker = {**_DEFAULT_MARKERS, **self._markers.get(name, {})}
            traces.append(go.Scatter3d(
                x=t[:, 0], y=t[:, 1], z=t[:, 2],
                mode="markers", name=name, marker=marker))
        layout = dict(margin=self._margins)
        if self._ranges:
            layout["scene"] = {
                f"{ax}axis": dict(range=rng)
                for ax, rng in self._ranges.items() if rng is not None}
        return go.Figure(data=traces, layout=layout)

    def save_html(self, path: str) -> str:
        """Write an interactive plotly HTML; falls back to a matplotlib 3D
        scatter PNG when plotly is not installed. Returns the path actually
        written."""
        try:
            self._figure().write_html(path)
            return path
        except ImportError:
            png = path.rsplit(".", 1)[0] + ".png"
            self._save_matplotlib(png)
            return png

    def _save_matplotlib(self, path: str) -> None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=(8, 8))
        ax = fig.add_subplot(projection="3d")
        for name, poses in self._poses.items():
            t = poses[:, :3, 3]
            m = {**_DEFAULT_MARKERS, **self._markers.get(name, {})}
            ax.scatter(t[:, 0], t[:, 1], t[:, 2], label=name,
                       s=m["size"] ** 2, alpha=m["opacity"], c=m["color"])
        if self._ranges:
            for axis, rng in self._ranges.items():
                if rng is not None:
                    getattr(ax, f"set_{axis}lim")(rng)
        ax.legend()
        fig.savefig(path, dpi=100, bbox_inches="tight")
        plt.close(fig)

    def upload_plot(self, name: str = "Camera Poses") -> None:
        """Log to wandb when available (reference camera3dplotter.py:92-101)."""
        try:
            import wandb
            if wandb.run is not None:
                wandb.log({name: self._figure()})
        except Exception:
            pass
