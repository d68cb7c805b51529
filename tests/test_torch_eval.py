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
                   "--n_samples", "32", "--n_compact", "32", "--debug"])
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


# A res-64 grid queried with 256 samples: the plan picks stride 8 on tables
# dilated by 2, while an undilated table admits stride 2 at most by
# auto_query_stride's rule (a sample in every occupied cell).
RODS_SAMPLING = dict(grid_resolution=64, n_samples=256, early_stop_eps=0.0)


def _rods_grid(cfg, seed=0):
    """A live grid at the plan's dilation whose occupied cells are twelve
    1-cell rods along the three axes."""
    res = cfg.sampling.grid_resolution
    _, dilation = og.resolve_query_plan(cfg.sampling, AABB)
    occ = torch.zeros(res, res, res)
    rng = np.random.default_rng(seed)
    for _ in range(12):
        a, b = rng.integers(8, res - 8, 2)
        idx = [slice(a, a + 1), slice(b, b + 1)]
        idx.insert(int(rng.integers(0, 3)), slice(None))
        occ[tuple(idx)] = 1.0
    return og.with_occs(og.create(AABB, res, 1, dilation),
                        occ.reshape(1, -1), 0.01)


def test_grid_query_stride_follows_the_grid():
    """A live grid is queried at the plan's stride; its undilated view, or
    a grid at another dilation, at stride 1; no grid (hierarchical) at the
    plan's."""
    cfg = Config().replace(sampling=dataclasses.replace(
        Config().sampling, **RODS_SAMPLING))
    assert og.resolve_query_plan(cfg.sampling, AABB) == (8, 2)
    live = _rods_grid(cfg)
    assert og.grid_query_stride(cfg.sampling, AABB, live) == 8
    assert og.grid_query_stride(cfg.sampling, AABB, None) == 8
    assert og.grid_query_stride(cfg.sampling, AABB, og.conservative(live)) == 1
    assert og.grid_query_stride(cfg.sampling, AABB,
                                og.create(AABB, 64, 1, 1)) == 1


@pytest.mark.parametrize("view", ["live", "conservative"])
def test_eval_masks_keep_every_occupied_sample(monkeypatch, view):
    """evaluate_split's sample masks on 1-cell rods, held against the
    stride-1 mask of the undilated table: no occupied sample is lost beyond
    what the live table at the plan's stride loses. Before the stride
    followed the grid, the undilated table queried at stride 8 lost 30-40%
    of them (stride 2 still loses 8-12%)."""
    from fsnerf_tpu_torch.core.models import make_model
    from fsnerf_tpu_torch.render import renderer

    cfg = Config().replace(
        sampling=dataclasses.replace(Config().sampling, **RODS_SAMPLING),
        model=dataclasses.replace(Config().model, n_layers=2, d_filter=32,
                                  skip=()))
    live = _rods_grid(cfg)
    grid = live if view == "live" else og.conservative(live)
    calls, real = [], renderer._masked_lattice

    def spy(rays_o, rays_d, g, *args):
        out = real(rays_o, rays_d, g, *args)
        calls.append((rays_o, rays_d, g, args, out[2]))
        return out

    monkeypatch.setattr(renderer, "_masked_lattice", spy)
    split = cli.build_split("lattice", 2, 16, True, seed=3)
    model = make_model(cfg, torch.float32, torch.Generator().manual_seed(0),
                       "cpu")
    cli.evaluate_split(model, grid, split, cfg, device="cpu")
    monkeypatch.undo()
    assert len(calls) >= 2 * len(split.poses)   # K probes and the renders
    stride, _ = og.resolve_query_plan(cfg.sampling, AABB)
    for rays_o, rays_d, g, args, mask in calls:
        assert g is grid
        n, jitter, step, eps, q_stride = args
        assert q_stride == (stride if view == "live" else 1)

        def lattice(gg, s):
            return real(rays_o, rays_d, gg, n, jitter, step, eps, s)[2]

        truth = lattice(og.conservative(live), 1)
        lost = int((truth & ~mask).sum())
        assert lost <= int((truth & ~lattice(live, stride)).sum())
        assert int(truth.sum()) > 0


def test_cli_evaluates_on_the_live_grid(monkeypatch, capsys):
    """main hands evaluate_split the trained grid itself (tables at the
    plan's dilation), as the reference does, not its undilated view."""
    seen = {}

    def fake_eval(model, grid, split, cfg, **kw):
        seen.update(grid=grid, cfg=cfg, aabb=split.aabb)
        return {"psnr": 0.0, "ssim": 0.0, "eval_k": 16}, None

    monkeypatch.setattr(cli, "evaluate_split", fake_eval)
    rc = cli.main(["--dataset", "sphere", "--device", "cpu", "--hw", "8",
                   "--n_imgs", "2", "--n_layers", "2", "--d_filter", "32",
                   "--skip", "0", "--n_freqs", "2", "--n_freqs_views", "2",
                   "--grid_resolution", "64", "--n_samples", "256",
                   "--n_iters", "2", "--batch_size", "16", "--debug"])
    assert rc == 0
    capsys.readouterr()
    stride, dilation = og.resolve_query_plan(seen["cfg"].sampling,
                                             seen["aabb"])
    grid = seen["grid"]
    assert (stride, dilation) == (8, 2) and grid.query_dilation == dilation
    occ_q, _ = og._build_query_table(grid.occs, grid.resolution, dilation)
    assert torch.equal(grid.occ_q, occ_q)
    assert og.grid_query_stride(seen["cfg"].sampling, seen["aabb"],
                                grid) == stride
