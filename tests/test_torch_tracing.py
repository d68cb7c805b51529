"""The port's tracer (fsnerf_tpu_torch/utils/profiling.py) and the
benchmark's readers of it (bench_h100/spans.py, bench_h100/metrics/), on
the CPU.

Spans: off by default (nothing recorded, no annotation opened); under a
torch profiler each span is one `user_annotation` of its name, its
duration within 20 us or 5% of the annotation's, nested spans name their
parent, a span left by an exception closes, and the ring drops its oldest
spans and counts them. Counters: an eager train() with log_every 1 adds,
step by step, samples_per_ray x batch to `rows_valid` and K x batch to
`rows_computed`, snapshotting them at each log boundary. Readers: on
synthetic traces, device events grouped by correlation and by stream
order, the refresh steps' excess device time, the idle outside the steps'
device extents, the row fill between the bracketing snapshots and the
median capture; each returns None for a run of another kind and where the
program keeps no record.
"""

import json
import time
from types import SimpleNamespace

import pytest
import torch

from bench_h100 import harness
from bench_h100 import spans as bspans
from fsnerf_tpu_torch.config import (Config, DataConfig, EncoderConfig,
                                     ModelConfig, SamplingConfig, TrainConfig)
from fsnerf_tpu_torch.core.models import make_model
from fsnerf_tpu_torch.data.pool import pool_from_images
from fsnerf_tpu_torch.data.synthetic import SphereScene
from fsnerf_tpu_torch.train import loop, step
from fsnerf_tpu_torch.utils import profiling
from fsnerf_tpu_torch.utils.checkpoint import Checkpointer

READERS = ("mlp_row_fill.train", "grid_refresh_share.train",
           "host_idle_share.train", "graph_capture_ms.train")


@pytest.fixture(autouse=True)
def fresh_tracer():
    profiling.reset()
    yield
    profiling.reset()


def _spin(seconds):
    t = time.perf_counter()
    while time.perf_counter() - t < seconds:
        pass


def test_off_records_nothing_and_opens_no_annotation(monkeypatch):
    def refuse(name):
        raise AssertionError("an annotation was opened")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with profiling.span("off.block", n=1) as s:
        s.set(more=2)
    assert profiling.span("a") is profiling.span("b")
    rec = profiling.record()
    assert rec["spans"] == [] and rec["dropped"] == 0


def test_spans_pair_with_the_profilers_annotations(tmp_path):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("t.outer", i=0) as outer:
            for i in range(3):
                with profiling.span("t.inner", i=i):
                    _spin(0.002 * (i + 1))
            outer.set(done=True)
        with pytest.raises(ValueError):
            with profiling.span("t.raises"):
                _spin(0.004)
                raise ValueError("inside")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    notes = sorted((e for e in events if e.get("cat") == "user_annotation"
                    and e["name"].startswith("t.")), key=lambda e: e["ts"])
    rec = profiling.record()["spans"]
    mine = sorted(rec, key=lambda s: s["t0_ns"])
    assert [s["name"] for s in mine] == [e["name"] for e in notes] == [
        "t.outer", "t.inner", "t.inner", "t.inner", "t.raises"]
    for s, e in zip(mine, notes):
        us = (s["t1_ns"] - s["t0_ns"]) / 1e3
        assert abs(us - e["dur"]) <= max(20.0, 0.05 * e["dur"]), (s, e)
    outer = mine[0]
    assert outer["parent"] is None and outer["attrs"] == {"i": 0,
                                                          "done": True}
    assert all(s["parent"] == outer["id"] for s in mine[1:4])
    assert [s["attrs"]["i"] for s in mine[1:4]] == [0, 1, 2]
    assert mine[4]["parent"] is None and mine[4]["t1_ns"] > mine[4]["t0_ns"]
    with profiling.span("t.after"):           # the stack was unwound
        pass
    assert profiling.record()["spans"] == rec   # off again: nothing new


def test_ring_drops_its_oldest_and_counts_them():
    profiling.reset(ring=4)
    with profiling.recording():
        for i in range(10):
            with profiling.span("t.ring", i=i):
                pass
    rec = profiling.record()
    assert [s["attrs"]["i"] for s in rec["spans"]] == [6, 7, 8, 9]
    assert rec["dropped"] == 6


def test_a_span_outlives_the_profiler_it_opened_under():
    """The harness stops its profiler inside train()'s logger, inside a
    train.boundary span: the span still closes and is kept."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    prof.start()
    with profiling.span("t.boundary"):
        prof.stop()
    assert [s["name"] for s in profiling.record()["spans"]] == ["t.boundary"]


# -- the counters of a training run ---------------------------------------

def _cfg(strategy):
    sampling = dict(n_samples=32, n_compact=32, grid_resolution=8,
                    render_step_size=0.2, warmup_steps=4, update_interval=4)
    if strategy == "hierarchical":
        sampling = dict(strategy="hierarchical", n_samples=8, n_fine=16)
    return Config(encoder=EncoderConfig(n_freqs=3, n_freqs_views=2),
                  model=ModelConfig(n_layers=3, d_filter=32, skip=(1,)),
                  data=DataConfig(dataset="sphere", white_bkgd=True),
                  sampling=SamplingConfig(**sampling),
                  train=TrainConfig(n_iters=12, batch_size=64, lro=5e-3))


class _Steps:
    """Each logged step's samples_per_ray and K, and the last snapshot."""

    def __init__(self):
        self.rows = []

    def log(self, k, m):
        snap = profiling.record()["snapshots"][-1]
        self.rows.append((k, m["samples_per_ray"], m["n_compact"], snap))


@pytest.mark.parametrize("strategy", ["occgrid", "hierarchical"])
def test_row_counters_follow_each_step(strategy, tmp_path):
    """train() with log_every 1 (eager, on the CPU): at each log boundary
    the snapshot's rows_valid is the sum of samples_per_ray x batch over
    the steps so far, rows_computed the sum of each step's K x batch (the
    ladder's K before the step; hierarchical: its coarse and fine
    samples, so its fill is 100%), and each step is one train.step span.
    The accumulator is no part of a checkpoint."""
    cfg = _cfg(strategy)
    scene = SphereScene(n_imgs=3, hw=16, white_bkgd=True)
    model = make_model(cfg, torch.float32, torch.Generator().manual_seed(0))
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf)
    logs = _Steps()
    ckpt = Checkpointer(str(tmp_path / "ck"))
    with profiling.recording():
        state = loop.train(model, cfg, pool, scene, logger=logs,
                           log_every=1, checkpointer=ckpt)
    B, s = cfg.train.batch_size, cfg.sampling
    k = s.n_compact if strategy == "occgrid" else s.n_samples + s.n_fine
    valid = computed = 0.0
    for i, (step_k, spr, rung, snap) in enumerate(logs.rows):
        valid += spr * B
        computed += k * B
        assert snap["step"] == step_k == i + 1 and snap["k"] == rung
        assert snap["counters"]["rows_valid"] == pytest.approx(valid,
                                                               rel=1e-12)
        assert snap["counters"]["rows_computed"] == computed
        if strategy == "occgrid":
            k = rung
    assert len(logs.rows) == cfg.train.n_iters
    assert float(state.rows_t) == state.rows_read == pytest.approx(valid)
    if strategy == "hierarchical":
        assert valid == computed
    else:
        assert 0 < valid < computed
    steps = [x for x in profiling.record()["spans"]
             if x["name"] == "train.step"]
    assert [x["attrs"]["step"] for x in steps] == list(range(12))
    assert {x["attrs"]["mode"] for x in steps} == {"eager"}
    assert all(x["parent"] is None for x in steps)
    bounds = [x for x in profiling.record()["spans"]
              if x["name"] == "train.boundary"]
    assert [x["attrs"]["step"] for x in bounds] == list(range(1, 13))
    assert all(x["attrs"]["log"] for x in bounds)

    template = step.init_state(model, cfg, step.make_optimizer(cfg, model),
                               scene.aabb)
    template.rows_t.fill_(5.0)
    template.rows_read = 5.0
    restored = ckpt.restore(template)
    assert restored.step == 12 and float(restored.rows_t) == 0.0
    assert restored.rows_read == 0.0


def test_a_logger_may_switch_profilers(tmp_path):
    """A logger that stops the running profiler and starts another at
    each log boundary, as a torch.profiler schedule's cycles do: train()
    goes on, and each session's trace holds one train.step annotation for
    each step of its chunk. (Torch cannot end an annotation under another
    profiler session than the one it began under: the loop calls the
    caller's hooks outside its spans.)"""
    import dataclasses

    from torch.profiler import ProfilerActivity, profile

    class Cycling:
        def __init__(self):
            self.prof, self.notes = None, []

        def log(self, k, m):
            if self.prof is not None:
                self.prof.stop()
                path = tmp_path / f"{k}.json"
                self.prof.export_chrome_trace(str(path))
                self.notes.append(sum(
                    e.get("cat") == "user_annotation"
                    and e["name"] == "train.step"
                    for e in json.loads(path.read_text())["traceEvents"]))
            self.prof = profile(activities=[ProfilerActivity.CPU])
            self.prof.start()

    cfg = _cfg("occgrid")
    cfg = cfg.replace(train=dataclasses.replace(cfg.train, n_iters=40))
    scene = SphereScene(n_imgs=3, hw=16, white_bkgd=True)
    model = make_model(cfg, torch.float32, torch.Generator().manual_seed(0))
    pool = pool_from_images(scene.imgs, scene.poses, scene.hwf)
    cycling = Cycling()
    state = loop.train(model, cfg, pool, scene, logger=cycling, log_every=2)
    cycling.prof.stop()
    assert state.step == 40 and cycling.notes == [2] * 19
    steps = [x for x in profiling.record()["spans"]
             if x["name"] == "train.step"]
    assert [x["attrs"]["step"] for x in steps] == list(range(2, 40))


# -- the benchmark's readers on synthetic traces ----------------------------

def _reader(name):
    return harness.reader(name)


def _trace(steps, corr=True, boundary_gap=50.0):
    """A profiled stretch of `steps` [(attrs, [kernel us ...])]: each step's
    annotation launches one cudaGraphLaunch whose kernels run back to back
    after a 10 us launch delay, a 2 us bubble between kernels; between
    steps the host idles `boundary_gap` us. Returns (prof, record)."""
    host, device, spans = [], [], []
    t = 1000.0
    for i, (attrs, kernels) in enumerate(steps):
        note = {"cat": "user_annotation", "name": "train.step", "ts": t,
                "dur": 8.0}
        launch = {"cat": "cuda_runtime", "name": "cudaGraphLaunch",
                  "ts": t + 2.0, "dur": 5.0, "args": {"correlation": 100 + i}}
        host += [note, launch]
        d = t + 10.0
        for us in kernels:
            device.append({"cat": "kernel", "name": "k", "ts": d, "dur": us,
                           "args": {"correlation": 100 + i} if corr
                           else {}})
            d += us + 2.0
        spans.append({"id": i + 1, "parent": None, "name": "train.step",
                      "attrs": attrs, "t0_ns": 4_000_100 + i * 10,
                      "t1_ns": 4_000_108 + i * 10})
        t = d + boundary_gap
    wall_s = (t + 100.0 - 900.0) / 1e6
    prof = SimpleNamespace(device=device, host=host, _t0=4e-3,
                           wall_s=wall_s)
    snaps = [{"t_ns": 3_999_000, "step": 100, "k": 192,
              "counters": {"rows_computed": 1000, "rows_valid": 600.0}},
             {"t_ns": 4_000_000 + 1e9 * wall_s - 1, "step": 200, "k": 192,
              "counters": {"rows_computed": 3000, "rows_valid": 2100.0}}]
    rec = {"spans": spans, "dropped": 0, "snapshots": snaps,
           "counters": {"capture_s": [0.05, 0.02, 0.08, 0.03],
                        "rows_computed": 3000, "rows_valid": 2100.0}}
    return prof, rec


def _attrs(refresh=None, k=192, weight_reg=False):
    return {"step": 0, "k": k, "refresh": refresh, "hold": False,
            "weight_reg": weight_reg, "mode": "replay"}


def _ctx(monkeypatch, prof, rec):
    monkeypatch.setattr(bspans, "program_record", lambda: rec)
    return {"kind": "train", "prof": prof}


@pytest.mark.parametrize("corr", [True, False])
def test_device_events_go_to_their_steps(monkeypatch, corr):
    """By correlation (each kernel to the step annotation holding its
    launch), and by stream order where the kernels carry none."""
    prof, rec = _trace([(_attrs(), [10, 20]), (_attrs(), [30]),
                        (_attrs(refresh=2), [40, 50, 60])], corr=corr)
    how, per = bspans.steps(_ctx(monkeypatch, prof, rec))
    assert how == ("correlation" if corr else "stream order")
    assert [[e["dur"] for e in evs] for _, evs in per] == [
        [10, 20], [30], [40, 50, 60]]


def test_correlation_ignores_launches_outside_the_steps(monkeypatch):
    """A kernel launched at the boundary (outside every step annotation)
    goes to no step under correlation."""
    prof, rec = _trace([(_attrs(), [10]), (_attrs(), [20])])
    last = prof.device[-1]
    prof.host.append({"cat": "cuda_runtime", "name": "cudaMemcpyAsync",
                      "ts": last["ts"] + 25.0, "dur": 3.0,
                      "args": {"correlation": 7}})
    prof.device.append({"cat": "gpu_memcpy", "name": "Memcpy DtoH",
                        "ts": last["ts"] + 30.0, "dur": 2.0,
                        "args": {"correlation": 7}})
    how, per = bspans.steps(_ctx(monkeypatch, prof, rec))
    assert how == "correlation"
    assert [[e["dur"] for e in evs] for _, evs in per] == [[10], [20]]


def test_pairing_fails_when_the_counts_differ(monkeypatch):
    prof, rec = _trace([(_attrs(), [10]), (_attrs(), [20])])
    rec["spans"].pop()
    ctx = _ctx(monkeypatch, prof, rec)
    assert bspans.steps(ctx) is None
    assert _reader("grid_refresh_share.train").read(ctx) is None
    assert _reader("host_idle_share.train").read(ctx) is None


def test_grid_refresh_share_is_the_refresh_steps_excess(monkeypatch):
    """Plain steps of 100, 110, 90 us at K 192 and 150 at K 176; a refresh
    at 192 of 300 us and one at 176 of 170: excess 200 + 20 us over the
    stretch's device time."""
    steps = [(_attrs(), [100]), (_attrs(), [110]), (_attrs(refresh=-1),
                                                     [150, 150]),
             (_attrs(), [90]), (_attrs(k=176), [150]),
             (_attrs(refresh=3, k=176), [170])]
    prof, rec = _trace(steps)
    got = _reader("grid_refresh_share.train").read(
        _ctx(monkeypatch, prof, rec))
    assert got == pytest.approx(100 * 220 / 920)
    steps[-1] = (_attrs(refresh=3, k=160), [170])   # no plain step at 160
    prof, rec = _trace(steps)
    assert _reader("grid_refresh_share.train").read(
        _ctx(monkeypatch, prof, rec)) is None


def test_host_idle_share_is_the_idle_outside_the_steps(monkeypatch):
    """Three steps of two kernels: 2 us bubbles inside each (in-step idle),
    50 us of host idle between them and 100 us at either end of the
    stretch; host idle + in-step idle = the whole idle."""
    prof, rec = _trace([(_attrs(), [10, 20])] * 3)
    wall_us = prof.wall_s * 1e6
    busy = 3 * 30.0
    inside = 3 * 2.0
    got = _reader("host_idle_share.train").read(_ctx(monkeypatch, prof, rec))
    assert got == pytest.approx(100 * (wall_us - busy - inside) / wall_us)
    whole = _reader("idle_share.train").read({"kind": "train", "prof": prof})
    assert whole - got == pytest.approx(100 * inside / wall_us)


def test_row_fill_and_capture_readers(monkeypatch):
    prof, rec = _trace([(_attrs(), [10])])
    ctx = _ctx(monkeypatch, prof, rec)
    assert _reader("mlp_row_fill.train").read(ctx) == pytest.approx(
        100 * 1500 / 2000)
    assert _reader("graph_capture_ms.train").read(ctx) == pytest.approx(40.0)
    rec["snapshots"].pop()          # no snapshot inside the stretch
    assert _reader("mlp_row_fill.train").read(ctx) is None
    rec["counters"]["capture_s"] = []
    assert _reader("graph_capture_ms.train").read(ctx) is None


@pytest.mark.parametrize("name", READERS)
def test_each_reader_declares_itself_and_reads_nothing_elsewhere(
        name, monkeypatch):
    """LAYER, UNIT, SOURCE, MOVES and KERNELS declared; None for another
    kind of run, and None where the program keeps no record (a checkout
    whose profiling module has no record())."""
    mod = _reader(name)
    assert mod.MOVES == "train_rays_per_s" and mod.KERNELS == ()
    assert mod.SOURCE in ("program_span", "program_counter")
    assert mod.UNIT in ("%", "ms") and mod.LAYER
    assert mod.read({"kind": "none"}) is None
    prof, _ = _trace([(_attrs(), [10])])
    monkeypatch.setattr(profiling, "record", None)
    assert bspans.program_record() is None
    assert mod.read({"kind": "train", "prof": prof}) is None
