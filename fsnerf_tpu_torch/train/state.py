"""Training state (port of fsnerf_tpu/train/state.py).

The JAX package threads one immutable pytree through jit; here the model
and the Adam optimizer update in place, and the step advances the grid,
the step count and the generator's stream. The step is counted twice: the
host's `step`, which the loop decides by (refresh kind, logs, callbacks),
and `step_t`, a 0-d int64 on the training device that the step itself
reads (FreeNeRF masks, the card's lr) and advances, so a captured step
replays with no host input. `rows_t` is the MLP rows that carried a sample,
summed by every step on the device (float64), and `rows_read` its value at
the loop's last read (utils/profiling.py's `rows_valid` counter); neither
is checkpointed, so both start at 0 in a fresh or restored state.
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
    # the device accumulator of valid MLP rows (None: 0 on the grid's
    # device) and its value at the last read
    rows_t: Optional[torch.Tensor] = field(default=None, repr=False)
    rows_read: float = field(default=0.0, repr=False)

    def __post_init__(self):
        dev = self.grid.occs.device
        if self.step_t is None:
            self.step_t = torch.tensor(self.step, dtype=torch.int64,
                                       device=dev)
        if self.rows_t is None:
            self.rows_t = torch.zeros((), dtype=torch.float64, device=dev)

    def read_rows(self) -> float:
        """The valid rows summed since the last read (a copy from the
        device: call it where the host already waits on the card)."""
        now = self.rows_t.item()
        new, self.rows_read = now - self.rows_read, now
        return new

    def set_step(self, step: int) -> None:
        """Set both step counters (the device one in place)."""
        self.step = int(step)
        self.step_t.fill_(self.step)
