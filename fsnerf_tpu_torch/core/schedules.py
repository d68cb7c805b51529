"""Learning-rate schedules as plain functions of the step (port of
fsnerf_tpu/core/schedules.py).

  * constant: lr(t) = lro.
  * exponential decay: lr(t) = lro * r**(t / T) for t < T, lro * r after.

T is n_iters, as the reference trainer builds its scheduler (Td only
parameterizes the weight-reg window). Evaluated in float32 as the JAX
schedule is, and returned as a Python float: the optimizer takes it with no
device traffic.
"""

from __future__ import annotations

from typing import Callable

import numpy as np


def constant_lr(lro: float) -> Callable[[int], float]:
    def schedule(step) -> float:
        return float(np.float32(lro))
    return schedule


def exponential_decay_lr(lro: float, T: int, r: float) -> Callable[[int], float]:
    """lr(t) = lro * r**(t/T), clamped to lro*r once t >= T."""
    def schedule(step) -> float:
        t = np.float32(step)
        if t >= T:
            return float(np.float32(lro * r))
        return float(np.float32(lro) * np.power(np.float32(r),
                                                t / np.float32(T)))
    return schedule


def make_schedule(cfg) -> Callable[[int], float]:
    """The schedule cfg.train.scheduler names."""
    if cfg.train.scheduler == "const":
        return constant_lr(cfg.train.lro)
    if cfg.train.scheduler == "exp":
        return exponential_decay_lr(cfg.train.lro, cfg.train.n_iters,
                                    cfg.train.decay_rate)
    raise ValueError(f"Unknown scheduler: {cfg.train.scheduler}")
