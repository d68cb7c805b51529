"""A run end to end: without a card it refuses; with the look for a card
skipped it drives the rest of a run on the CPU at a small size, and a
timed path broken underneath comes out not correct, once for each fault a
cell can have. The control (the reference in float8 in the program's
place) fails at the cell's own size on the card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from bench_h100 import calibrate, harness, run

ROOT = harness.ROOT

TRAIN = "nerf-8x256.occgrid-train"


def small(name: str) -> dict:
    """The cell at a size a CPU test holds."""
    c = harness.cell(name)
    c["traffic"].update(views=2, hw=32, batch_size=64, setup_steps=4,
                        log_every=2)
    c["config"]["sampling"].update(n_samples=64, grid_resolution=16,
                                   n_compact=32)
    return c


def correct(c: dict, fault=None, seed: int = 2 ** 31 + 5) -> bool:
    out = harness.KINDS[c["traffic"]["kind"]](
        c, seed, 0.5, False, torch.device("cpu"), time.perf_counter(),
        fault=fault)
    checks = harness.judged(out["numbers"], c["limits"])
    assert checks
    return all(v <= lim for v, lim in checks.values())


def test_a_run_without_a_card_fails_clearly():
    proc = subprocess.run(
        [sys.executable, "-m", "bench_h100.run", "--workload", TRAIN,
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode == 2
    assert "needs 1 CUDA device" in proc.stderr
    assert proc.stdout.strip() == ""


def test_the_guard_names_jax_and_the_jax_package(monkeypatch):
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "fsnerf_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jax", object())
    assert run.forbidden_modules() == ["fsnerf_tpu", "jax"]


def test_a_sound_training_run_is_correct():
    assert correct(small(TRAIN))


def test_training_with_its_state_left_unchanged_is_not_correct():
    def frozen(state):
        state.optimizer.step = lambda *a, **k: None
    assert not correct(small(TRAIN), fault=frozen)


def test_training_on_half_the_batch_is_not_correct(monkeypatch):
    import fsnerf_tpu_torch.train.step as step

    def half(pred, target):
        n = pred.shape[0] // 2
        return torch.mean(torch.square(pred[:n] - target[:n]))
    monkeypatch.setattr(step, "mse", half)
    assert not correct(small(TRAIN))


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.manifest()["workloads"]])
def test_the_control_is_not_correct_on_the_card(card, name):
    c = harness.cell(name)
    out = harness.KINDS[c["traffic"]["kind"]](
        c, 2 ** 31 + 11, 1.0, False, card, time.perf_counter(), keep=True)
    got = calibrate.control_train(c, out["kept"], 2 ** 31 + 11,
                                  precision="float8")
    checks = harness.judged(got, c["limits"])
    assert any(v > lim for v, lim in checks.values()), json.dumps(checks)
