"""Training driver (port of fsnerf_tpu/train/loop.py): the adaptive
compaction ladder, the divergence guard, a JSON-lines metrics sink and the
loop itself, with its in-loop validation and checkpoint hooks.

The loop runs one step per Python iteration; the device queue stays full
because a step never waits on it. Metrics cross to the host only at the
ladder's boundaries (every `chunk` steps, where the JAX package ends a
lax.scan chunk), at log steps and at validations.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import os
import time
from typing import Callable, Optional

from ..core.schedules import make_schedule
from .state import TrainState
from .step import init_state, make_optimizer, make_train_step

_log = logging.getLogger(__name__)

COMPACT_STEP = 16


def compaction_target(nv_q: float, k_max: int, margin: float = 1.0) -> int:
    """Ladder K for a valid-sample count: ceil(margin * nv / 16) * 16,
    clamped to [16, k_max]."""
    t = int(-(-margin * max(nv_q, 1.0) // COMPACT_STEP)) * COMPACT_STEP
    return min(max(t, COMPACT_STEP), k_max)


class CompactionController:
    """Adaptive compaction-K ladder: as the grid converges, the mean
    pre-compaction valid count per ray falls below the configured ceiling
    n_compact; K follows it in steps of 16 (margin
    SamplingConfig.compact_margin). Growth is immediate; shrinking waits
    for `patience` consecutive observations below."""

    STEP = COMPACT_STEP

    def __init__(self, cfg, margin: Optional[float] = None,
                 patience: int = 2):
        s = cfg.sampling
        self.k_max = int(s.n_compact) if s.n_compact else 0
        self.enabled = bool(s.adapt_compact and s.strategy == "occgrid"
                            and self.k_max > self.STEP)
        self.k = self.k_max
        self.margin = float(s.compact_margin if margin is None else margin)
        self.patience = patience
        self._below = 0

    def target(self, nv_q: float) -> int:
        return compaction_target(nv_q, self.k_max, self.margin)

    def observe(self, nv_q: float) -> bool:
        """Feed one n_valid_mean observation; True when K changed."""
        if not self.enabled:
            return False
        t = self.target(nv_q)
        if t > self.k:
            self.k = t
            self._below = 0
            return True
        if t < self.k:
            self._below += 1
            if self._below >= self.patience:
                self.k = t
                self._below = 0
                return True
        else:
            self._below = 0
        return False

    def apply(self, cfg):
        """cfg with n_compact pinned to the controller's current K."""
        return cfg.replace(sampling=dataclasses.replace(
            cfg.sampling, n_compact=self.k))

    def state_dict(self) -> dict:
        return {"k": self.k, "below": self._below}

    def load_state_dict(self, d: dict):
        self.k, self._below = int(d["k"]), int(d["below"])


class DivergenceGuard:
    """Watches the metrics fetched at log steps. A non-finite loss or PSNR
    always halts (the Adam moments are poisoned); a train-PSNR collapse of
    more than `drop_db` below the best seen after `warmup` steps warns once,
    and halts only with `halt_on_collapse`."""

    def __init__(self, halt_on_collapse: bool = False, drop_db: float = 10.0,
                 warmup: int = 500):
        self.halt_on_collapse = bool(halt_on_collapse)
        self.drop_db = float(drop_db)
        self.warmup = int(warmup)
        self.best_psnr: Optional[float] = None
        self.tripped = False

    def observe(self, step: int, metrics: dict) -> bool:
        """Feed one fetched metrics dict; True => stop training now."""
        loss = float(metrics.get("loss", 0.0))
        psnr = float(metrics.get("psnr", 0.0))
        if not (math.isfinite(loss) and math.isfinite(psnr)):
            _log.error("Divergence guard: non-finite training metrics at "
                       "step %d (loss=%r, psnr=%r) — halting.", step, loss,
                       psnr)
            self.tripped = True
            return True
        if step < self.warmup:
            return False
        if self.best_psnr is None or psnr > self.best_psnr:
            self.best_psnr = psnr
        elif psnr < self.best_psnr - self.drop_db:
            if not self.tripped:
                _log.warning(
                    "Divergence guard: train PSNR collapsed to %.2f dB at "
                    "step %d (best seen %.2f dB, threshold drop %.1f dB)%s",
                    psnr, step, self.best_psnr, self.drop_db,
                    " — halting (--halt_on_divergence)."
                    if self.halt_on_collapse else "; continuing.")
            self.tripped = True
            return self.halt_on_collapse
        return False


class MetricsLogger:
    """JSON-lines metrics sink (`<out_dir>/metrics.jsonl`; none without an
    out_dir)."""

    def __init__(self, out_dir: Optional[str]):
        self.fh = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.fh = open(os.path.join(out_dir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: dict):
        if self.fh:
            rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
            self.fh.write(json.dumps(rec) + "\n")
            self.fh.flush()

    def close(self):
        if self.fh:
            self.fh.close()
            self.fh = None


def chunk_length(log_every: int) -> int:
    """Steps between ladder observations: the largest of (100, 50, 25, 20,
    10, 5, 4, 2, 1) dividing log_every (the JAX loop's scan chunk)."""
    g = max(1, log_every)
    return next(d for d in (100, 50, 25, 20, 10, 5, 4, 2, 1) if g % d == 0)


def train(model, cfg, pool, scene, state: Optional[TrainState] = None,
          logger: Optional[MetricsLogger] = None,
          log_every: int = 100, checkpointer=None,
          val_fn: Optional[Callable] = None) -> TrainState:
    """Run steps until cfg.train.n_iters.

    Args: model, the NeRF module on the pool's device; pool: RayPool;
    scene: .aabb; state: a TrainState to continue (None = fresh, around
    `model`); checkpointer: utils/checkpoint.py::Checkpointer, saved every
    cfg.train.ckpt_every steps and at the end; val_fn(state, step) -> dict,
    run every cfg.train.val_rate steps when cfg.train.val is set, its
    metrics logged with a "val_" prefix. Returns the final TrainState."""
    if state is None:
        state = init_state(model, cfg, make_optimizer(cfg, model),
                           scene.aabb, pool.device)
    compactor = CompactionController(cfg)
    if state.ladder:
        compactor.load_state_dict(state.ladder)
    schedule = make_schedule(cfg)
    guard = DivergenceGuard(halt_on_collapse=cfg.train.halt_on_divergence)
    t_cfg = cfg.train
    val_on = bool(t_cfg.val and val_fn)
    ckpt_on = bool(checkpointer and t_cfg.ckpt_every)
    # the ladder observes at a common divisor of every callback boundary,
    # as the JAX loop sizes its lax.scan chunks
    bounds = [max(1, log_every)]
    bounds += [max(1, t_cfg.val_rate)] if val_on else []
    bounds += [max(1, t_cfg.ckpt_every)] if ckpt_on else []
    chunk = chunk_length(math.gcd(*bounds))
    n_iters = t_cfg.n_iters

    def build(c):
        return make_train_step(state.model, c, state.optimizer, pool, scene)

    step_fn = build(compactor.apply(cfg))
    start = state.step
    t0 = time.perf_counter()
    while state.step < n_iters:
        state, metrics = step_fn(state)
        k = state.step
        # the ladder observes the last step of each chunk, as the JAX
        # loop observes each lax.scan chunk's last step
        if compactor.enabled and (k % chunk == 0 or k == n_iters):
            if compactor.observe(float(metrics["n_valid_mean"])):
                step_fn = build(compactor.apply(cfg))
        if k % log_every == 0 or k == n_iters:
            m = {name: float(v) for name, v in metrics.items()}
            dt = time.perf_counter() - t0
            m["rays_per_sec"] = (k - start) * cfg.train.batch_size / dt
            m["lr"] = schedule(k - 1)
            if cfg.train.ao is not None:
                m["alpha"] = cfg.train.ao
            m["n_compact"] = compactor.k
            if logger:
                logger.log(k, m)
            if guard.observe(k, m):
                break
        if val_on and k % t_cfg.val_rate == 0:
            val_metrics = val_fn(state, k)
            if logger and val_metrics:
                logger.log(k, {f"val_{n}": v for n, v in val_metrics.items()
                               if v is not None})
        if ckpt_on and k % t_cfg.ckpt_every == 0:
            state.ladder = compactor.state_dict()
            checkpointer.save(state, k)
    state.ladder = compactor.state_dict()
    if checkpointer:
        checkpointer.save(state, state.step)
    return state
