"""Image quality metrics (port of fsnerf_tpu/eval/metrics.py; LPIPS in
lpips.py).

PSNR: -10 log10(MSE) with the MSE taken jointly over all frames.
SSIM: skimage.metrics.structural_similarity with gaussian_weights=True,
data_range=1 — 11x11 gaussian window (sigma 1.5, truncate 3.5), K1 0.01,
K2 0.03, sample-covariance normalization, per-channel maps cropped by the
window radius (a 'valid' separable filter) and averaged. The filter is a
float32 convolution with TF32 off, as the JAX code runs it at HIGHEST.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Joint-MSE PSNR over any number of frames."""
    return -10.0 * torch.log10(torch.mean(torch.square(pred - target)))


def _gaussian_kernel1d(sigma: float = 1.5, truncate: float = 3.5,
                       max_radius: int = 10 ** 9) -> np.ndarray:
    radius = min(int(truncate * sigma + 0.5), max_radius)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _filter2d(img: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Separable 'valid' gaussian filter over [N, 1, H, W]."""
    out = F.conv2d(img, k[None, None, :, None])
    return F.conv2d(out, k[None, None, None, :])


def ssim(img0: torch.Tensor, img1: torch.Tensor,
         data_range: float = 1.0) -> torch.Tensor:
    """Mean SSIM between two [H, W, C] images; images smaller than the
    11x11 window use a clamped window."""
    max_radius = max(1, (min(img0.shape[0], img0.shape[1]) - 1) // 2)
    k = torch.as_tensor(_gaussian_kernel1d(1.5, 3.5, max_radius),
                        device=img0.device)
    NP = k.numel() ** 2
    cov_norm = NP / (NP - 1)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    # channels as a batch of one-channel images: [C, 1, H, W]
    x = img0.to(torch.float32).permute(2, 0, 1)[:, None]
    y = img1.to(torch.float32).permute(2, 0, 1)[:, None]
    with _no_tf32():
        ux, uy = _filter2d(x, k), _filter2d(y, k)
        uxx, uyy = _filter2d(x * x, k), _filter2d(y * y, k)
        uxy = _filter2d(x * y, k)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
    B1, B2 = ux * ux + uy * uy + C1, vx + vy + C2
    per_channel = ((A1 * A2) / (B1 * B2)).mean(dim=(1, 2, 3))
    return per_channel.mean()


def evaluate_frames(pred: torch.Tensor, target: torch.Tensor,
                    lpips_fn=None) -> dict:
    """dict(psnr, ssim, lpips) over [F, H, W, 3] stacks; lpips is the mean
    of lpips_fn(pred[i], target[i]) (eval/lpips.py::load_lpips), None
    without one."""
    p = psnr(pred, target)
    s = torch.stack([ssim(pred[i], target[i])
                     for i in range(pred.shape[0])]).mean()
    lp = None
    if lpips_fn is not None:
        lp = float(torch.stack([lpips_fn(pred[i], target[i])
                                for i in range(pred.shape[0])]).mean())
    return {"psnr": float(p), "ssim": float(s), "lpips": lp}
