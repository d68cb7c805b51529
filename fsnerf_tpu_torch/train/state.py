"""Training state (port of fsnerf_tpu/train/state.py).

The JAX package threads one immutable pytree through jit; here the model
and the Adam optimizer update in place, and the step advances the grid,
the step count and the generator's stream. The step is counted twice: the
host's `step`, which the loop decides by (refresh kind, logs, callbacks),
and `step_t`, a 0-d int64 on the training device that the step itself
reads (FreeNeRF masks, the card's lr) and advances, so a captured step
replays with no host input.
"""

from __future__ import annotations

from dataclasses import dataclass, field
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
    # the device step counter (None: made from `step` on the grid's device)
    step_t: Optional[torch.Tensor] = field(default=None, repr=False)

    def __post_init__(self):
        if self.step_t is None:
            self.step_t = torch.tensor(self.step, dtype=torch.int64,
                                       device=self.grid.occs.device)

    def set_step(self, step: int) -> None:
        """Set both step counters (the device one in place)."""
        self.step = int(step)
        self.step_t.fill_(self.step)
