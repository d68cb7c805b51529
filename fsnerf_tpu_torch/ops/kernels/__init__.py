"""kernels layer of the PyTorch port (see fsnerf_tpu_torch/__init__.py).

Every kernel wrapper counts the launches of its kernel in its own
`.launches`. A CUDA graph launches its kernels without calling the
wrappers, so a graph records the counts its capture added
(`launch_counts` before and after) and adds them back at each replay
(`add_launches`): the counts read the same after a graphed run as after
an eager one.
"""

from __future__ import annotations

import functools
from typing import Dict


@functools.lru_cache(maxsize=None)
def counted() -> Dict[str, object]:
    """The counting wrappers by name (one dict, made once: a replay adds
    its counts through it)."""
    from . import mlp, mlp_train, render, siren, volrend

    fns = (render.ray_march, render.siren_ray_march, mlp.nerf_mlp,
           mlp.nerf_density, mlp_train.mlp_train_fwd, mlp_train.mlp_train_bwd,
           mlp_train.dw_pass, siren.siren_mlp_fwd, siren.siren_mlp_bwd,
           volrend.volume_render_fused)
    return {fn.__name__: fn for fn in fns}


def register_ops() -> None:
    """Register the kernels' torch ops (fsnerf_torch::nerf_mlp,
    fsnerf_torch::siren_mlp_fwd): importing their modules does it. A
    process must do this before it loads a program that calls them."""
    from . import mlp, siren  # noqa: F401


def launch_counts() -> Dict[str, int]:
    """Every wrapper's launch count."""
    return {name: fn.launches for name, fn in counted().items()}


def add_launches(delta: Dict[str, int]) -> None:
    """Add `delta` (name -> launches) to the wrappers' counts."""
    fns = counted()
    for name, n in delta.items():
        fns[name].launches += n
