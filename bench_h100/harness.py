"""One run of one cell: set-up, the measured window, the traced
sub-window, and the comparison with the plain reference.

A cell is a workload of BENCHMARK.json, a configuration under a traffic
mix: configs/<config>.json and traffic/<traffic>.json, whose "kind" picks
the run function in KINDS below. Per-layer metrics are readers
in metrics/<name>.py; the limits of the comparison are limits/<cell>.json.
All of them are found by name, so a cell, a mix or a metric is added by
adding files.

The program is driven only through its public entry points:
config.Config, core.models.make_model, data.pool.pool_from_images,
train.step.init_state / make_optimizer and train.loop.train (with its
logger hook).
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import statistics
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

import torch

from . import flops, scene
from .reference import pipeline as ref
from .trace import Profiled, busy_us

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class WindowClosed(Exception):
    """Raised from train()'s logger hook to end a training stretch at a
    log boundary."""


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as fh:
        return json.load(fh)


def load_json(kind: str, name: str) -> dict:
    with open(HERE / kind / f"{name}.json") as fh:
        return json.load(fh)


def cell(name: str) -> dict:
    """The workload entry, its configuration, its traffic, its limits and
    its metrics (end-to-end and per-layer entries that apply to it)."""
    bench = manifest()
    w = next((w for w in bench["workloads"] if w["name"] == name), None)
    if w is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = load_json("configs", w["config"])
    traffic = load_json("traffic", w["traffic"])

    def applies(m):
        return "workloads" not in m or name in m["workloads"]

    return {"workload": w, "config": cfg, "traffic": traffic,
            "limits": load_json("limits", name),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def reader(name: str):
    """metrics/<name>.py as a module (LAYER, UNIT, SOURCE, MOVES, KERNELS,
    read(ctx))."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_h100_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- the program's configuration, weights and inputs -------------------

def port_config(cfg: dict, traffic: dict, seed: int, n_iters: int):
    from fsnerf_tpu_torch.config import (Config, DataConfig, EncoderConfig,
                                         ModelConfig, SamplingConfig,
                                         TrainConfig)

    m, e = cfg["model"], cfg["encoder"]
    return Config(
        encoder=EncoderConfig(n_freqs=e["n_freqs"],
                              n_freqs_views=e["n_freqs_views"],
                              log_space=e["log_space"]),
        model=ModelConfig(model=m["model"], d_filter=m["d_filter"],
                          n_layers=m["n_layers"], skip=tuple(m["skip"]),
                          density_activation=m["density_activation"]),
        data=DataConfig(dataset="lattice", n_imgs=traffic["views"],
                        white_bkgd=traffic["white_bkgd"]),
        sampling=SamplingConfig(**cfg["sampling"]),
        train=TrainConfig(n_iters=n_iters, batch_size=traffic["batch_size"],
                          lro=traffic["lro"],
                          decay_rate=traffic["decay_rate"], seed=int(seed)))


def init_bounds(model, init: str) -> Dict[str, float]:
    """U(-b, b) bound of each parameter: torch.nn.Linear's 1/sqrt(fan_in),
    or for the sine layers of a SIREN 1/fan_in (the first) and
    sqrt(6/fan_in)."""
    params = dict(model.named_parameters())
    out = {}
    for name in params:
        layer = name.rsplit(".", 1)[0]
        fan = params[layer + ".weight"].shape[1]
        if init == "siren" and layer.endswith("fc_layer"):
            first = layer.startswith("first_layers.0.")
            out[name] = 1.0 / fan if first else math.sqrt(6.0 / fan)
        else:
            out[name] = 1.0 / math.sqrt(fan)
    return out


@torch.no_grad()
def seeded_weights(model, init: str, seed: int) -> Dict[str, torch.Tensor]:
    """Every parameter drawn from one uniform draw on the model's device
    from `seed`; returns a float32 copy of the weights."""
    params = dict(model.named_parameters())
    bounds = init_bounds(model, init)
    dev = next(model.parameters()).device
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed) ^ 0x5DEECE66D)
    u = torch.rand(sum(p.numel() for p in params.values()), generator=g,
                   device=dev)
    off = 0
    for name, p in params.items():
        n = p.numel()
        p.copy_((u[off:off + n].view_as(p) * 2.0 - 1.0) * bounds[name])
        off += n
    return {n: p.detach().float().clone() for n, p in params.items()}


def program_inputs(c: dict, seed: int, device, n_iters: int):
    """(port config, model, pool, scene, views, initial weights)."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.data.pool import pool_from_images

    cfg, traffic = c["config"], c["traffic"]
    views = scene.train_views(traffic, traffic["views_seed"], device)
    pcfg = port_config(cfg, traffic, seed, n_iters)
    model = make_model(pcfg, torch.bfloat16, device=device)
    w0 = seeded_weights(model, cfg["init"], seed)
    pool = pool_from_images(views["imgs"].cpu().numpy(), views["poses"],
                            views["hwf"], device=device)
    scn = SimpleNamespace(aabb=views["aabb"], near=views["near"],
                          far=views["far"])
    return pcfg, model, pool, scn, views, w0


def release():
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


# ---- the comparison ----------------------------------------------------

def leaf_gaps(prog: Dict[str, torch.Tensor], want: Dict[str, torch.Tensor],
              keep: List[str]) -> Dict[str, float]:
    """Each leaf's |‖prog‖ - ‖want‖| over max(‖want‖, the median leaf's
    ‖want‖), over the leaves `keep`."""
    norms = {n: float(torch.linalg.vector_norm(want[n].float()))
             for n in keep}
    med = statistics.median(norms.values())
    return {n: abs(float(torch.linalg.vector_norm(prog[n].float()))
                   - norms[n]) / max(norms[n], med) for n in keep}


def moved_leaves(grad: Dict[str, torch.Tensor]) -> List[str]:
    """The leaves whose reference gradient is not nought to rounding:
    norm at least a thousandth of the median leaf's."""
    norms = {n: float(torch.linalg.vector_norm(g.float()))
             for n, g in grad.items()}
    med = statistics.median(norms.values())
    return [n for n, v in norms.items() if v >= 1e-3 * med]


def train_numbers(prog: dict, want: dict, w0: dict) -> dict:
    keep = moved_leaves(want["grad"])
    loss = max(abs(a - b) / abs(b)
               for a, b in zip(prog["losses"], want["losses"]))
    dp = {n: prog["weights"][n].float() - w0[n] for n in keep}
    dw = {n: want["weights"][n].float() - w0[n] for n in keep}
    diff = float(torch.linalg.vector_norm(prog["occs"].float().reshape(-1)
                                          - want["occs"].reshape(-1)))
    base = float(torch.linalg.vector_norm(want["occs"]))
    occ = diff / base if base > 0 else (0.0 if diff == 0 else math.inf)
    grads, updates = (leaf_gaps(prog["grad"], want["grad"], keep),
                      leaf_gaps(dp, dw, keep))
    return {"loss_gap": loss, "grad_gap": max(grads.values()),
            "update_gap": max(updates.values()), "grid_gap": occ,
            # which leaf sets each worst gap, and the grid's own size: read
            # by the calibration, compared by nothing
            "grad_leaf": max(grads, key=grads.get),
            "update_leaf": max(updates, key=updates.get),
            "leaves_compared": len(keep),
            "occs_norm": base,
            "occs_occupied": float((want["occs"] > 0).float().mean())}


def judged(numbers: dict, limits: dict) -> dict:
    """{name: [number, limit]} for every number that has a limit (each
    must have been read)."""
    return {n: [numbers[n], limits[n]] for n in limits}


# ---- training ----------------------------------------------------------

class CheckLogger:
    """The logger of the first steps (log_every 1): each step's loss, the
    first step's gradient as Adam holds it (exp_avg / (1 - beta1) after one
    step), and after `n` steps the weights and the grid's EMA values; then
    it ends the stretch."""

    def __init__(self, state, n: int):
        self.state, self.n = state, n
        self.losses, self.grad, self.times = [], None, []

    def log(self, step, metrics):
        s = self.state
        self.losses.append(float(metrics["loss"]))
        self.times.append((f"step {step}", time.perf_counter()))
        if step == 1:
            # no moment where the optimizer got no gradient
            moments = s.optimizer.state
            self.grad = {n: moments[p]["exp_avg"].detach().float()
                         / (1.0 - 0.9) if "exp_avg" in moments[p]
                         else torch.zeros_like(p, dtype=torch.float32)
                         for n, p in s.model.named_parameters()}
        if step >= self.n:
            self.weights = {n: p.detach().float().clone()
                            for n, p in s.model.named_parameters()}
            self.occs = s.grid.occs.detach().clone()
            raise WindowClosed


class WindowLogger:
    """The logger of the set-up's rest, the window and the traced
    sub-window: at the first boundary at or past `setup_steps` the window
    opens; at the first boundary at least `seconds` later it closes; with
    `trace` the profiler then runs over the next chunk whose compaction K
    has held for HELD boundaries, or over the PATIENCE-th chunk at the
    latest. A new ladder rung runs each step kind eagerly once and
    captures it when the kind first comes, and a part refresh's kind
    comes every 256 steps late in training, so a rung needs ~300 steps
    before its chunks are all replays. Each boundary records the step and
    the MLP samples per ray of its last step."""

    HELD, PATIENCE = 3, 10

    def __init__(self, setup_steps: int, seconds: float, trace: bool,
                 device):
        self.setup_steps, self.seconds, self.trace = (setup_steps, seconds,
                                                      trace)
        self.device = device
        self.t_open = self.t_close = None
        self.records = []
        self.prof = None
        self.k, self.held = None, 0

    def log(self, step, metrics):
        now = time.perf_counter()
        if not math.isfinite(float(metrics["loss"])):
            raise RuntimeError(f"non-finite loss at step {step}")
        self.records.append((step, float(metrics["samples_per_ray"]), now))
        k = metrics["n_compact"]
        self.held, self.k = (self.held + 1 if k == self.k else 0), k
        if self.t_open is None:
            if step >= self.setup_steps:
                self.t_open, self.step_open = now, step
            return
        if self.t_close is None:
            if now - self.t_open < self.seconds:
                return
            self.t_close, self.step_close = now, step
            if not self.trace:
                raise WindowClosed
            self.waited = 0
        if self.prof is None:
            if self.held < self.HELD and self.waited < self.PATIENCE:
                self.waited += 1
                return
            sync(self.device)
            self.prof = Profiled()
            self.prof_from = step
            return
        sync(self.device)
        self.prof.stop()
        self.prof_to = step
        raise WindowClosed

    def rows(self, first: int, last: int, batch: int) -> float:
        """MLP rows of steps first .. last - 1: each boundary's samples per
        ray for the steps since the previous one."""
        total, prev = 0.0, None
        for step, spr, _ in self.records:
            if prev is not None and first <= prev and step <= last:
                total += (step - prev) * spr * batch
            prev = step
        return total


def run_train(c: dict, seed: int, seconds: float, trace: bool, device,
              t_start: float, fault: Optional[Callable] = None,
              keep: bool = False) -> dict:
    from fsnerf_tpu_torch.train.loop import train
    from fsnerf_tpu_torch.train.step import init_state, make_optimizer

    cfg, traffic = c["config"], c["traffic"]
    pcfg, model, pool, scn, views, w0 = program_inputs(
        c, seed, device, traffic["n_iters"])
    phases = [("inputs", time.perf_counter())]
    state = init_state(model, pcfg, make_optimizer(pcfg, model), scn.aabb,
                       device)
    if fault:
        fault(state)
    check = CheckLogger(state, traffic["check_steps"])
    try:
        train(model, pcfg, pool, scn, state=state, logger=check, log_every=1)
    except WindowClosed:
        pass
    phases += check.times
    win = WindowLogger(traffic["setup_steps"], seconds, trace, device)
    try:
        train(model, pcfg, pool, scn, state=state, logger=win,
              log_every=traffic["log_every"])
    except WindowClosed:
        pass
    setup_s = win.t_open - t_start
    window_s = win.t_close - win.t_open
    steps = win.step_close - win.step_open
    B = traffic["batch_size"]
    phases.append(("window opened", win.t_open))
    rows_per_ray = win.rows(win.step_open, win.step_close, 1) / steps
    out = {"setup_s": setup_s, "window_s": window_s, "attempted": steps,
           "failed": 0, "phases": phases, "rows_per_ray": rows_per_ray,
           "e2e": {"train_rays_per_s": steps * B / window_s,
                   "setup_s": setup_s}}
    if trace:
        rows = win.rows(win.prof_from, win.prof_to, B)
        wbytes = flops.n_params(cfg) * (2 + 4)
        out["ctx"] = {
            "kind": "train", "config": cfg, "prof": win.prof,
            "window_s": window_s,
            "window_flops": win.rows(win.step_open, win.step_close, B)
            * flops.train_row_flops(cfg)
            + flops.refresh_flops(cfg, win.step_open, win.step_close),
            "rows": rows, "row_flops": flops.train_row_flops(cfg),
            "bytes": rows * 56 + (win.prof_to - win.prof_from) * wbytes}
    out["memory_peak_bytes"] = (torch.cuda.max_memory_allocated()
                                if torch.device(device).type == "cuda"
                                else 0)
    prog = {"losses": check.losses, "grad": check.grad,
            "weights": check.weights, "occs": check.occs}
    del state, model, pool, win
    release()
    want = ref.train_steps(w0, cfg, traffic, views, seed,
                           traffic["check_steps"])
    out["numbers"] = train_numbers(prog, want, w0)
    if keep:
        out["kept"] = {"prog": prog, "want": want, "w0": w0, "views": views}
    return out


KINDS = {"train": run_train}


def per_layer(c: dict, ctx: dict) -> Dict[str, dict]:
    """Each per-layer metric of the cell from its reader; a listed metric
    that reads nothing ends the run."""
    out = {}
    for m in c["per_layer"]:
        value = reader(m["name"]).read(ctx)
        if value is None:
            raise RuntimeError(f"per-layer metric {m['name']} found "
                               "nothing to read in the trace")
        out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def device_busy(ctx: dict) -> dict:
    prof = ctx["prof"]
    return {"busy_s": busy_us(prof.device) / 1e6, "window_s": prof.wall_s}


