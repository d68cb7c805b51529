"""The benchmark's own arithmetic: model FLOPs, the refresh schedule, the
busy union of a trace and its idle gaps, on numbers worked by hand."""

import pytest
import torch

from bench_h100 import flops, harness
from bench_h100.trace import busy_us, gaps

NERF = harness.load_json("configs", "nerf-8x256")
SINERF = harness.load_json("configs", "sinerf-8x256")


@pytest.mark.parametrize("cfg,macs", [(NERF, 593_408), (SINERF, 591_488)],
                         ids=["nerf", "sinerf"])
def test_forward_macs_are_the_card_scripts(cfg, macs):
    # the port's card script's mlp_macs / siren_macs at 8 x 256
    assert flops.forward_macs(cfg) == macs
    assert flops.train_row_flops(cfg) == 6 * macs


def test_density_macs():
    # NeRF: 63 x 256 + 7 x 256^2 + 63 x 256 (the skip) + 256
    assert flops.density_macs(NERF) == 63 * 256 + 7 * 256 ** 2 + \
        63 * 256 + 256
    # SiNeRF: 3 x 256 + 7 x 256^2 + 256 x 128 + 128
    assert flops.density_macs(SINERF) == 3 * 256 + 7 * 256 ** 2 + \
        256 * 128 + 128


@pytest.mark.parametrize("cfg", [NERF, SINERF], ids=["nerf", "sinerf"])
def test_parameter_count_is_the_models(cfg):
    from fsnerf_tpu_torch.core.models import NeRF, SiNeRF

    model = SiNeRF() if cfg["reference"] == "sinerf" else NeRF()
    assert flops.n_params(cfg) == sum(p.numel() for p in model.parameters())


def test_refresh_schedule():
    cells = 128 ** 3
    # every 16 steps, all cells before step 256, a quarter after, every
    # 64 steps from step 1024
    assert flops.refreshed_cells(NERF, 0) == cells
    assert flops.refreshed_cells(NERF, 1) == 0
    assert flops.refreshed_cells(NERF, 240) == cells
    assert flops.refreshed_cells(NERF, 256) == cells // 4
    assert flops.refreshed_cells(NERF, 1040) == 0
    assert flops.refreshed_cells(NERF, 1088) == cells // 4
    assert flops.refresh_flops(NERF, 0, 32) == \
        2 * flops.density_macs(NERF) * 2 * cells


def _ev(ts, dur):
    return {"ts": ts, "dur": dur, "name": "k"}


def test_busy_union_and_gaps():
    ev = [_ev(0, 10), _ev(5, 10), _ev(30, 5), _ev(31, 2), _ev(40, 1)]
    # [0, 15) U [30, 35) U [40, 41)
    assert busy_us(ev) == 21
    assert gaps(ev) == [(15, 30), (35, 40)]
    assert busy_us([]) == 0 and gaps([]) == []


def test_window_rows_apply_each_reading_to_the_steps_before_it():
    log = harness.WindowLogger(100, 1e9, False, "cpu")
    log.records = [(100, 150.0, 0.0), (200, 140.0, 1.0), (300, 130.0, 2.0)]
    assert log.rows(100, 300, 1024) == 100 * 1024 * (140.0 + 130.0)
    assert log.rows(200, 300, 1024) == 100 * 1024 * 130.0


def test_leaf_gap_and_moved_leaves():
    want = {"a": torch.ones(4), "b": 2 * torch.ones(4), "c": torch.zeros(4)}
    assert harness.moved_leaves(want) == ["a", "b"]
    prog = {"a": torch.ones(4), "b": torch.zeros(4), "c": torch.zeros(4)}
    # leaf b: |0 - 4| / max(4, median 3) = 1
    assert harness.leaf_gaps(prog, want, ["a", "b"]) == pytest.approx(
        {"a": 0.0, "b": 1.0})


def test_profiled_reads_its_own_trace():
    from bench_h100.trace import Profiled

    p = Profiled()
    torch.ones(64, 64) @ torch.ones(64, 64)
    p.stop()
    assert p.wall_s > 0 and p.host
    assert p.kernel_us(("no such kernel",)) == 0
    got = p.breakdown()
    assert set(got) == {"device_ops", "idle_gaps"}


def test_the_traced_chunk_keeps_its_compaction_k():
    log = harness.WindowLogger(100, 0.0, True, "cpu")

    def at(step, k):
        log.log(step, {"loss": 0.1, "samples_per_ray": 100.0,
                       "n_compact": k})

    at(100, 192)                  # the window opens
    at(200, 176)                  # it closes; K changed here: wait
    assert log.step_close == 200 and log.prof is None
    at(300, 160)                  # K changed again: wait
    for step in (400, 500):       # K held for one, then two boundaries
        at(step, 160)
        assert log.prof is None
    at(600, 160)                  # held for three: profile the next chunk
    assert log.prof is not None and log.prof_from == 600
    with pytest.raises(harness.WindowClosed):
        at(700, 144)
    assert log.prof_to == 700


def test_the_traced_chunk_waits_at_most_patience_chunks():
    log = harness.WindowLogger(100, 0.0, True, "cpu")
    for i, step in enumerate(range(100, 100 * (log.PATIENCE + 3), 100)):
        log.log(step, {"loss": 0.1, "samples_per_ray": 100.0,
                       "n_compact": 192 - 16 * (i % 2)})
        if log.prof is not None:
            break
    assert log.prof_from == 200 + 100 * log.PATIENCE
