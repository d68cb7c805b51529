"""Full-state checkpoints with retention (port of
fsnerf_tpu/utils/checkpoint.py, torch.save in place of orbax).

A checkpoint holds the whole TrainState: the module's parameters, the Adam
state, the occupancy grid's EMA values, binaries and threshold, the step,
the generator's state and the compaction ladder's, so a run continued from
it steps exactly as the unbroken run would have. The valid-row accumulator
(TrainState.rows_t), a measurement, starts again at 0. The grid's query tables
are not stored: `restore` rebuilds them from the EMA values with the plan
of the template grid (og.create's, from resolve_query_plan), so a
checkpoint cannot carry a stale or differently packed table.

`restore` writes into the template's own tensors (the grid's, the device
step counter, the card's lr) before any CUDA graph is captured around
them; `save` reads the generator as it stands, which a graph's replays
advance as far as the eager steps would.

Files: <directory>/ckpt_<step>.pt, written whole and then renamed into
place; the newest `max_to_keep` are kept.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import torch

from ..ops import occgrid as og
from ..train.state import TrainState

_NAME = re.compile(r"ckpt_(\d+)\.pt$")


class Checkpointer:
    """Saves and restores TrainStates under one directory."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        """The file of the checkpoint of `step`."""
        return os.path.join(self.directory, f"ckpt_{step:08d}.pt")

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        found = (_NAME.match(n) for n in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, state: TrainState, step: int) -> None:
        """Write `state` as the checkpoint of `step` (a no-op when that step
        is saved already, as when ckpt_every divides n_iters), then drop
        all but the newest max_to_keep."""
        if self.latest_step() == step:
            return
        g = state.grid
        blob = {"step": state.step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
                "grid": {"occs": g.occs, "binaries": g.binaries,
                         "thre": g.thre},
                "generator": state.generator.get_state(),
                "ladder": state.ladder}
        path = self.path(step)
        torch.save(blob, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))

    def restore(self, template: TrainState) -> Optional[TrainState]:
        """The latest checkpoint loaded into `template` (a TrainState from
        train/step.py::init_state with the same model and grid settings:
        its module and optimizer are loaded in place); None when there is
        none."""
        step = self.latest_step()
        if step is None:
            return None
        blob = torch.load(self.path(step), map_location="cpu",
                          weights_only=True)
        template.model.load_state_dict(blob["model"])
        opt = template.optimizer
        lrs = [g["lr"] for g in opt.param_groups]
        opt.load_state_dict(blob["optimizer"])
        for group, lr in zip(opt.param_groups, lrs):
            if isinstance(lr, torch.Tensor):
                # the card's capturable Adam keeps its own lr tensor
                lr.copy_(group["lr"])
                group["lr"] = lr
        dev = template.grid.occs.device
        saved = blob["grid"]
        og.set_occs_(template.grid, saved["occs"].to(dev),
                     saved["thre"].to(dev))
        template.grid.binaries.copy_(saved["binaries"])
        template.generator.set_state(blob["generator"])
        template.set_step(blob["step"])
        template.ladder = blob["ladder"]
        template.rows_t.zero_()             # not checkpointed
        template.rows_read = 0.0
        return template
