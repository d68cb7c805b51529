"""fsnerf_tpu_torch's LPIPS (eval/lpips.py) against fsnerf_tpu's, with
seeded random weights in the npz format (the pretrained ones do not ship
with the repository), and the evaluation's report of it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsnerf_tpu.eval import lpips as jlpips
from fsnerf_tpu_torch.eval import lpips as tlpips
from fsnerf_tpu_torch.eval.metrics import evaluate_frames

_CHANNELS = [64, 128, 256, 512, 512]


def random_weights(seed=0):
    """VGG16 kernels (He-scaled) and non-negative heads, from numpy."""
    rng = np.random.default_rng(seed)
    w, cin, i = {}, 3, 0
    for c in tlpips._VGG_CFG:
        if c == "M":
            continue
        w[f"conv{i}_kernel"] = (rng.standard_normal((3, 3, cin, c))
                                * np.sqrt(2.0 / (9 * cin))).astype(np.float32)
        w[f"conv{i}_bias"] = (0.01 * rng.standard_normal(c)).astype(
            np.float32)
        cin, i = c, i + 1
    for j, c in enumerate(_CHANNELS):
        w[f"lin{j}"] = rng.uniform(0.0, 1.0, c).astype(np.float32)
    return w


@pytest.fixture(scope="module")
def weights_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("lpips") / "w.npz"
    np.savez(path, **random_weights())
    return str(path)


@pytest.mark.parametrize("pair", range(3))
def test_lpips_matches_jax(weights_file, pair):
    """Three 32x32 pairs (noise, a blurred copy, a shifted copy): the
    port's load_lpips on the CPU against the JAX package's lpips_distance
    at float32 ('highest') matmul precision, within 1e-5 relative."""
    rng = np.random.default_rng(10 + pair)
    a = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    b = [rng.uniform(0, 1, (32, 32, 3)).astype(np.float32),
         0.5 * (a + np.roll(a, 1, axis=0)),
         np.roll(a, 3, axis=1)][pair]
    raw = np.load(weights_file)
    jw = {k: jnp.asarray(raw[k]) for k in raw.files}
    with jax.default_matmul_precision("highest"):
        want = float(jlpips.lpips_distance(jnp.asarray(a), jnp.asarray(b),
                                           jw))
    fn = tlpips.load_lpips(weights_file, device="cpu")
    got = float(fn(torch.from_numpy(a), torch.from_numpy(b)))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert float(fn(torch.from_numpy(a), torch.from_numpy(a))) == 0.0


def test_lpips_absent_without_weights(tmp_path, monkeypatch, weights_file):
    """No file: load_lpips() is None and the evaluation reports lpips None;
    FSNERF_LPIPS_WEIGHTS names the file, and evaluate_frames then reports
    the mean over the frames."""
    monkeypatch.setenv("FSNERF_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    assert tlpips.load_lpips() is None
    rng = np.random.default_rng(3)
    pred = torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32))
    gt = torch.from_numpy(rng.uniform(0, 1, (2, 16, 16, 3)).astype(
        np.float32))
    assert evaluate_frames(pred, gt)["lpips"] is None
    monkeypatch.setenv("FSNERF_LPIPS_WEIGHTS", weights_file)
    fn = tlpips.load_lpips()
    m = evaluate_frames(pred, gt, fn)
    want = np.mean([float(fn(pred[i], gt[i])) for i in range(2)])
    assert m["lpips"] == pytest.approx(want, rel=1e-6) and m["lpips"] > 0
