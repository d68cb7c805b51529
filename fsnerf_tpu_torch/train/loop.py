"""Training driver (port of fsnerf_tpu/train/loop.py): the adaptive
compaction ladder, the divergence guard, a JSON-lines metrics sink, the
loop itself with its in-loop validation and checkpoint hooks, and the
headless `train_scanned`.

The loop dispatches chunks of steps between the callback boundaries, as
the JAX loop dispatches lax.scan chunks (train/step.py::make_train_chunk):
on the card each step is one replay of the CUDA graph of its kind, since
per-step host dispatch (the autograd, optimizer and kernel-launch work of
an eager step) would otherwise dominate the wall clock. Metrics cross to
the host only at chunk ends, where the ladder observes, and at log steps
and validations.
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
from .step import (init_state, make_optimizer, make_train_chunk,
                   make_train_step)

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
    out_dir) and, with use_wandb, wandb too where it is installed (the
    reference logs to wandb only)."""

    def __init__(self, out_dir: Optional[str], use_wandb: bool = False,
                 run_name: str = "run"):
        self.fh = None
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            self.fh = open(os.path.join(out_dir, "metrics.jsonl"), "a")
        self.wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                _log.warning("--use_wandb: wandb is not installed; logging "
                             "to metrics.jsonl only")
            else:
                wandb.init(project="fsnerf-tpu", name=run_name)
                self.wandb = wandb

    def log(self, step: int, metrics: dict):
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        if self.fh:
            self.fh.write(json.dumps(rec) + "\n")
            self.fh.flush()
        if self.wandb:
            self.wandb.log(rec, step=step)

    def log_summary(self, metrics: dict):
        """The run's final metrics (wandb only)."""
        if self.wandb:
            self.wandb.log({k: v for k, v in metrics.items()
                            if v is not None})

    def log_video(self, name: str, frames_tchw, fps: int = 30):
        """A rendered uint8 [T, C, H, W] video (wandb only)."""
        if self.wandb:
            self.wandb.log({name: self.wandb.Video(frames_tchw, fps=fps,
                                                   format="mp4")})

    def close(self):
        if self.fh:
            self.fh.close()
            self.fh = None
        if self.wandb:
            self.wandb.finish()
            self.wandb = None


def chunk_length(log_every: int) -> int:
    """Steps between ladder observations: the largest of (100, 50, 25, 20,
    10, 5, 4, 2, 1) dividing log_every (the JAX loop's scan chunk)."""
    g = max(1, log_every)
    return next(d for d in (100, 50, 25, 20, 10, 5, 4, 2, 1) if g % d == 0)


def train(model, cfg, pool, scene, state: Optional[TrainState] = None,
          logger: Optional[MetricsLogger] = None,
          log_every: int = 100, checkpointer=None,
          val_fn: Optional[Callable] = None,
          graphs: Optional[bool] = None, mesh=None) -> TrainState:
    """Run steps until cfg.train.n_iters.

    Args: model, the NeRF module on the pool's device; pool: RayPool;
    scene: .aabb; state: a TrainState to continue (None = fresh, around
    `model`); checkpointer: utils/checkpoint.py::Checkpointer, saved every
    cfg.train.ckpt_every steps and at the end; val_fn(state, step) -> dict,
    run every cfg.train.val_rate steps when cfg.train.val is set, its
    metrics logged with a "val_" prefix; graphs: make_train_chunk's (None:
    CUDA graphs on the card, eager steps on the CPU; False: eager steps on
    the card, the reference the graphs are bitwise equal to).

    mesh: a data-parallel group (parallel/mesh.py::Mesh): the state is
    replicated from rank 0 and each step is the parallel step
    (parallel/train_parallel.py; graphed under NCCL on the card, eager
    under gloo). Every rank runs the loop and val_fn (its render is
    tiled); only rank 0 logs and checkpoints (the other ranks' logger
    and checkpointer are ignored). The chunk boundaries count
    cfg.train.ckpt_every on every rank alike. Returns the final
    TrainState."""
    if state is None:
        state = init_state(model, cfg, make_optimizer(cfg, model),
                           scene.aabb, pool.device)
    if mesh is not None:
        from ..parallel.mesh import replicate
        replicate(state, mesh)
        if mesh.rank != 0:
            logger = checkpointer = None
    compactor = CompactionController(cfg)
    if state.ladder:
        compactor.load_state_dict(state.ladder)
    schedule = make_schedule(cfg)
    guard = DivergenceGuard(halt_on_collapse=cfg.train.halt_on_divergence)
    t_cfg = cfg.train
    val_on = bool(t_cfg.val and val_fn)
    ckpt_on = bool(checkpointer and t_cfg.ckpt_every)
    # the ladder observes at a common divisor of every callback boundary,
    # as the JAX loop sizes its lax.scan chunks; the ranks of a mesh
    # observe at the same steps whichever of them checkpoints
    bounds = [max(1, log_every)]
    bounds += [max(1, t_cfg.val_rate)] if val_on else []
    if ckpt_on or (mesh is not None and t_cfg.ckpt_every):
        bounds.append(max(1, t_cfg.ckpt_every))
    chunk = chunk_length(math.gcd(*bounds))
    n_iters = t_cfg.n_iters

    def build(c):
        if mesh is not None:
            from ..parallel.train_parallel import make_parallel_train_step
            return make_parallel_train_step(state.model, c, state.optimizer,
                                            pool, scene, mesh)
        return make_train_step(state.model, c, state.optimizer, pool, scene)

    step_fn = build(compactor.apply(cfg))
    start = state.step
    t0 = time.perf_counter()
    while state.step < n_iters:
        # a chunk ends on the next common boundary (a run resumed off the
        # lattice realigns with a short one) or at n_iters
        n = min(chunk - state.step % chunk, n_iters - state.step)
        state, metrics = make_train_chunk(step_fn, n, graphs)(state)
        k = state.step
        # the ladder observes each chunk's last step, as the JAX loop
        # observes each lax.scan chunk's; a new K is a new step function
        # whose graphs are captured as its kinds come (the JAX recompile).
        # A capture is synchronous, so TrainConfig.async_ladder stays unread
        if compactor.enabled and compactor.observe(
                float(metrics["n_valid_mean"])):
            _log_graphs(step_fn, k)
            step_fn.release()
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
    _log_graphs(step_fn, state.step)
    step_fn.release()
    state.ladder = compactor.state_dict()
    if checkpointer:
        checkpointer.save(state, state.step)
    return state


def _log_graphs(step_fn, k: int) -> None:
    """Log the CUDA graphs of a retiring step function: its K, its kinds
    and their capture seconds (the port's counterpart of the JAX loop's
    compile time), in the record's `graphs` attribute too."""
    if not step_fn.graphs:
        return
    rung = {"step": k, "n_compact": step_fn.cfg.sampling.n_compact,
            "capture_s": {str(kind): g.capture_s
                          for kind, g in step_fn.graphs.items()}}
    _log.info("step %d: %d CUDA graphs at K %s captured in %.3f s", k,
              len(rung["capture_s"]), rung["n_compact"],
              sum(rung["capture_s"].values()), extra={"graphs": rung})


def train_scanned(model, cfg, pool, scene,
                  state: Optional[TrainState] = None, chunk: int = 100,
                  on_chunk: Optional[Callable] = None,
                  graphs: Optional[bool] = None) -> TrainState:
    """Headless training (port of fsnerf_tpu/train/loop.py::
    train_scanned): n_iters // chunk chunks of `chunk` steps
    (make_train_chunk; on the card one graph replay per step), with no
    logs, validation or checkpoints; on_chunk(c, state, metrics) after
    chunk c. Adaptive compaction runs at the chunk boundaries: each
    chunk's last-step n_valid_mean feeds the controller, and a K change
    swaps in a step function at the new K, whose graphs are captured anew.
    The first chunk runs at cfg's K ceiling, as the JAX one does."""
    if state is None:
        state = init_state(model, cfg, make_optimizer(cfg, model),
                           scene.aabb, pool.device)

    def build(c):
        return make_train_step(state.model, c, state.optimizer, pool, scene)

    compactor = CompactionController(cfg)
    step_fn = build(cfg)
    run = make_train_chunk(step_fn, chunk, graphs)
    for c in range(cfg.train.n_iters // chunk):
        state, metrics = run(state)
        if on_chunk:
            on_chunk(c, state, metrics)
        if compactor.enabled and compactor.observe(
                float(metrics["n_valid_mean"])):
            _log_graphs(step_fn, state.step)
            step_fn.release()
            step_fn = build(compactor.apply(cfg))
            run = make_train_chunk(step_fn, chunk, graphs)
    _log_graphs(step_fn, state.step)
    step_fn.release()
    return state
