"""Learning-rate schedules as plain functions of the step (port of
fsnerf_tpu/core/schedules.py).

  * constant: lr(t) = lro.
  * exponential decay: lr(t) = lro * r**(t / T) for t < T, lro * r after.

T is n_iters, as the reference trainer builds its scheduler (Td only
parameterizes the weight-reg window). Evaluated in float32 as the JAX
schedule is. A schedule has two forms: given a Python int it returns a
Python float (the host form: the CPU optimizer and the loop's logs take it
with no device traffic); given a 0-d tensor step it returns a float32 0-d
tensor on the step's device (the device form: the train step computes the
card's lr from its device step counter, so a CUDA graph replays it).
"""

from __future__ import annotations

from typing import Callable, Union

import numpy as np
import torch

Step = Union[int, torch.Tensor]


def constant_lr(lro: float) -> Callable[[Step], Union[float, torch.Tensor]]:
    def schedule(step):
        if isinstance(step, torch.Tensor):
            return torch.full_like(step, lro, dtype=torch.float32)
        return float(np.float32(lro))
    return schedule


def exponential_decay_lr(lro: float, T: int,
                         r: float) -> Callable[[Step], Union[float,
                                                             torch.Tensor]]:
    """lr(t) = lro * r**(t/T), clamped to lro*r once t >= T."""
    def schedule(step):
        if isinstance(step, torch.Tensor):
            t = step.to(torch.float32)
            lr = torch.pow(r, t / float(T)) * lro
            return torch.where(t < T, lr, lro * r)
        t = np.float32(step)
        if t >= T:
            return float(np.float32(lro * r))
        return float(np.float32(lro) * np.power(np.float32(r),
                                                t / np.float32(T)))
    return schedule


def make_schedule(cfg) -> Callable[[Step], Union[float, torch.Tensor]]:
    """The schedule cfg.train.scheduler names."""
    if cfg.train.scheduler == "const":
        return constant_lr(cfg.train.lro)
    if cfg.train.scheduler == "exp":
        return exponential_decay_lr(cfg.train.lro, cfg.train.n_iters,
                                    cfg.train.decay_rate)
    raise ValueError(f"Unknown scheduler: {cfg.train.scheduler}")
