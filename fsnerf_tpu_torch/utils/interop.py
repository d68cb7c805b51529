"""Weights and training state across packages: JAX params and reference
`nn.pt` files -> the port's NeRF state dict; a JAX TrainState -> the port's.

The port's NeRF (core/models.py) uses the reference state-dict keys, so a
reference `nn.pt` loads as it is. JAX/flax params ({'params': {'layers_0':
{'kernel' [in, out], 'bias'}, ...}}) map by the same rule as
fsnerf_tpu/utils/torch_interop.py::export_torch_state_dict: `layers_{i}` ->
`layers.{i}`, heads keep their names, kernels transpose to [out, in].
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch

_NERF_HEADS = ("sigma", "connection", "branch", "rgb")


def _torch_prefix(name: str) -> str:
    m = re.fullmatch(r"layers_(\d+)", name)
    if m:
        return f"layers.{m.group(1)}"
    if name in _NERF_HEADS:
        return name
    raise ValueError(f"unrecognized NeRF module name: {name!r}")


def state_dict_from_jax(params: Dict) -> Dict[str, torch.Tensor]:
    """flax NeRF params (numpy or array-likes) -> reference-keyed state dict
    of float32 CPU tensors."""
    p = params.get("params", params)
    out: Dict[str, torch.Tensor] = {}
    for name, entry in p.items():
        prefix = _torch_prefix(name)
        kernel = np.array(entry["kernel"], dtype=np.float32)
        out[f"{prefix}.weight"] = torch.from_numpy(
            np.ascontiguousarray(kernel.T))
        out[f"{prefix}.bias"] = torch.from_numpy(
            np.array(entry["bias"], dtype=np.float32))
    return out


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """Reference `nn.pt` (torch.save(model.state_dict())) -> state dict."""
    return torch.load(path, map_location="cpu", weights_only=True)


def train_state_from_jax(jax_state, model, optimizer, grid, generator):
    """The port's TrainState carrying a fsnerf_tpu TrainState: its params
    into `model`, both Adam moment trees and the update count into
    `optimizer`'s state, its step, and its grid's EMA occupancy and
    threshold into `grid` (a port grid of the same shape, whose query
    tables are rebuilt). The JAX key has no counterpart: the port's state
    takes `generator`. Reads the JAX state by attribute; imports no jax.

    Both packages then start a step from the same state (optax.adam's
    count, mu, nu are torch.optim.Adam's step, exp_avg, exp_avg_sq)."""
    from ..ops import occgrid as og
    from ..train.state import TrainState

    model.load_state_dict(state_dict_from_jax(jax_state.params))
    adam = next(s for s in jax_state.opt_state
                if hasattr(s, "mu") and hasattr(s, "nu"))
    mu = state_dict_from_jax(adam.mu)
    nu = state_dict_from_jax(adam.nu)
    count = float(np.asarray(adam.count))
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(count, dtype=torch.float32),
            "exp_avg": mu[name].to(p.device).clone(),
            "exp_avg_sq": nu[name].to(p.device).clone(),
        }
    g = og.with_occs(grid, torch.from_numpy(np.array(jax_state.grid.occs)),
                     torch.from_numpy(np.array(jax_state.grid.thre)))
    return TrainState(model, optimizer, g, int(np.asarray(jax_state.step)),
                      generator)
