"""fsnerf_tpu_torch metrics and the render-only command line against
fsnerf_tpu."""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.config import Config as JConfig
from fsnerf_tpu.eval import metrics as jmet
from fsnerf_tpu.ops import occgrid as jog
from fsnerf_tpu_torch import cli
from fsnerf_tpu_torch.config import Config
from fsnerf_tpu_torch.eval import metrics
from fsnerf_tpu_torch.ops import occgrid as og
from torch_parity import AABB, sphere_density_jax, sphere_density_torch, t

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("hw", [(24, 20), (7, 9)])
def test_psnr_ssim_match_jax(hw):
    rng = np.random.default_rng(0)
    a = rng.uniform(size=(2, *hw, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    np.testing.assert_allclose(float(metrics.psnr(t(a), t(b))),
                               float(jmet.psnr(jnp.asarray(a),
                                               jnp.asarray(b))), atol=1e-5)
    np.testing.assert_allclose(float(metrics.ssim(t(a[0]), t(b[0]))),
                               float(jmet.ssim(jnp.asarray(a[0]),
                                               jnp.asarray(b[0]))),
                               atol=1e-5)
    ours = metrics.evaluate_frames(t(a), t(b))
    theirs = jmet.evaluate_frames(jnp.asarray(a), jnp.asarray(b))
    for k in ("psnr", "ssim"):
        np.testing.assert_allclose(ours[k], theirs[k], atol=1e-5)
    assert ours["lpips"] is None


@pytest.mark.parametrize("n_compact", [192, 48])
def test_derive_eval_n_compact_matches_jax(n_compact):
    """The eval K ladder (97th percentile of the grid's valid-sample count,
    ceil to 16, clamped to the ceiling) picks the same K."""
    from fsnerf_tpu.cli import derive_eval_n_compact as jderive

    split = cli.build_split("sphere", 3, 24, True, seed=4)
    kw = dict(grid_resolution=16, n_samples=128, n_compact=n_compact)
    tcfg = Config().replace(sampling=dataclasses.replace(
        Config().sampling, **kw))
    jcfg = JConfig().replace(sampling=dataclasses.replace(
        JConfig().sampling, **kw))
    _, dil = og.resolve_query_plan(tcfg.sampling, AABB)
    tg = og.update(og.create(AABB, 16, 1, dil), sphere_density_torch, 0)
    jg = jog.update(jog.create(jnp.asarray(AABB), 16, 1, dil),
                    sphere_density_jax, None, jnp.asarray(0))
    assert cli.derive_eval_n_compact(tg, split, tcfg) == \
        jderive(jg, split, jcfg)


def test_compaction_target_ladder():
    assert cli.compaction_target(0.0, 192) == 16
    assert cli.compaction_target(16.0, 192) == 16
    assert cli.compaction_target(16.5, 192) == 32
    assert cli.compaction_target(500.0, 192) == 192
    assert cli.compaction_target(20.0, 192, margin=1.25) == 32


def test_render_only_main_runs_small(capsys):
    """The render-only main path end to end at a tiny size on the CPU."""
    rc = cli.main(["--dataset", "lattice", "--render_only", "--device",
                   "cpu", "--hw", "12", "--n_layers", "3",
                   "--d_filter", "32", "--skip", "1", "--n_freqs", "3",
                   "--n_freqs_views", "2", "--grid_resolution", "8",
                   "--n_samples", "32", "--n_compact", "32"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(out["psnr"]) and 0.0 < out["ssim"] <= 1.0
    assert out["device"] == "cpu" and out["eval_k"] % 16 == 0


def test_cli_refuses_without_cuda_unless_asked_for_the_cpu(monkeypatch,
                                                          capsys):
    """The device defaults to cuda: without a card the command line exits
    non-zero with a message instead of running on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = cli.main(["--dataset", "sphere", "--render_only", "--hw", "8"])
    captured = capsys.readouterr()
    assert rc != 0 and "--device cpu" in captured.err
    assert captured.out == ""


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """chip_smoke.py prints no result and exits non-zero without CUDA, and
    in a directory holding nothing else of the repository."""
    script = REPO / "chip_smoke.py"
    for cwd, path in ((REPO, script), (tmp_path, tmp_path / "chip_smoke.py")):
        if path != script:
            path.write_text(script.read_text())
        proc = subprocess.run([sys.executable, str(path)], cwd=cwd,
                              capture_output=True, text=True, timeout=120,
                              env={"PATH": "/usr/bin:/bin",
                                   "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert '"ok": true' not in proc.stdout
