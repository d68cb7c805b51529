"""Training state (port of fsnerf_tpu/train/state.py).

The JAX package threads one immutable pytree through jit; here the model
and the Adam optimizer update in place, and the step advances the grid,
the step count and the generator's stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from ..ops.occgrid import OccGrid


@dataclass
class TrainState:
    model: torch.nn.Module          # the NeRF module (float32 parameters)
    optimizer: torch.optim.Optimizer
    grid: OccGrid
    step: int
    generator: torch.Generator      # on the training device: batch and jitter
    # the compaction ladder's state (train/loop.py::CompactionController),
    # kept so a run continued from this state steps as the unbroken one
    ladder: Optional[dict] = None
