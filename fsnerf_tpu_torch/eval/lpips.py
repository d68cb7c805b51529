"""LPIPS perceptual metric: VGG16 features and learned linear heads (port
of fsnerf_tpu/eval/lpips.py).

Reference counterpart: lpips.LPIPS(net='vgg'). The pretrained weights
(torchvision's VGG16 and the lpips package's linear layers) do not ship
with the repository, so `load_lpips()` returns None unless a weights file
exists, and evaluation then reports lpips None, as the JAX package does.

Weights file (npz), the JAX package's format, written from the lpips
package by `python -m fsnerf_tpu_torch.eval.lpips export <out.npz>` where
it is installed:
  conv{i}_kernel [kh, kw, cin, cout], conv{i}_bias [cout]  for i in 0..12
  lin{j} [c_j] non-negative per-channel weights            for j in 0..4
Its path: FSNERF_LPIPS_WEIGHTS, else lpips_vgg_weights.npz beside this
module.

The convolutions are torch.nn.functional.conv2d (the JAX package runs
XLA's convolutions; there is no kernel of its own to port), in float32
with TF32 off.
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .metrics import _no_tf32

# VGG16 feature config: channel widths, 'M' = 2x2 max pool
_VGG_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
            512, 512, 512, "M", 512, 512, 512]
# the convolutions (in order) after which LPIPS taps features: relu1_2,
# relu2_2, relu3_3, relu4_3, relu5_3
_TAPS = [1, 3, 6, 9, 12]

# lpips's input scaling layer
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)

DEFAULT_WEIGHTS = os.path.join(os.path.dirname(__file__),
                               "lpips_vgg_weights.npz")


def _vgg_features(x: torch.Tensor, weights: Dict[str, torch.Tensor]):
    """The 5 tapped relu feature maps [1, C, h, w] of VGG16 on x [H, W, 3]
    (scaled input)."""
    h = x.permute(2, 0, 1)[None]
    feats = []
    conv_i = 0
    for c in _VGG_CFG:
        if c == "M":
            h = F.max_pool2d(h, 2, 2)
            continue
        k = weights[f"conv{conv_i}_kernel"]          # [kh, kw, cin, cout]
        h = F.conv2d(h, k.permute(3, 2, 0, 1), weights[f"conv{conv_i}_bias"],
                     padding="same")
        h = torch.relu(h)
        if conv_i in _TAPS:
            feats.append(h)
        conv_i += 1
    return feats


def lpips_distance(img0: torch.Tensor, img1: torch.Tensor,
                   weights: Dict[str, torch.Tensor]) -> torch.Tensor:
    """LPIPS(img0, img1) for [H, W, 3] images in [0, 1]: a 0-d tensor."""
    dev = img0.device
    shift = torch.tensor(_SHIFT, device=dev)
    scale = torch.tensor(_SCALE, device=dev)

    def prep(im):
        return (im.to(torch.float32) * 2.0 - 1.0 - shift) / scale

    with _no_tf32():
        f0 = _vgg_features(prep(img0), weights)
        f1 = _vgg_features(prep(img1), weights)
    total = torch.zeros((), device=dev)
    for j, (a, b) in enumerate(zip(f0, f1)):
        an = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
        bn = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
        d = (an - bn) ** 2                               # [1, C, h, w]
        lin = weights[f"lin{j}"]                         # [C]
        total = total + torch.mean(torch.sum(d * lin[None, :, None, None],
                                             dim=1))
    return total


def load_lpips(path: Optional[str] = None,
               device=None) -> Optional[Callable]:
    """(img0, img1) -> 0-d LPIPS tensor with the weights of `path`
    (default FSNERF_LPIPS_WEIGHTS, else DEFAULT_WEIGHTS) on `device`, or
    None when the file does not exist."""
    path = path or os.environ.get("FSNERF_LPIPS_WEIGHTS", DEFAULT_WEIGHTS)
    if not os.path.exists(path):
        return None
    with np.load(path) as raw:
        weights = {k: torch.as_tensor(raw[k], dtype=torch.float32,
                                      device=device) for k in raw.files}

    @torch.no_grad()
    def fn(img0, img1):
        return lpips_distance(img0, img1, weights)

    return fn


def export_from_torch(out_path: str) -> None:
    """Write torchvision's VGG16 and the lpips package's linear weights in
    the npz format (needs the `lpips` package)."""
    import lpips as lpips_pkg  # type: ignore

    net = lpips_pkg.LPIPS(net="vgg")
    out = {}
    conv_i = 0
    for layer in (net.net.slice1 + net.net.slice2 + net.net.slice3
                  + net.net.slice4 + net.net.slice5):
        if isinstance(layer, torch.nn.Conv2d):
            out[f"conv{conv_i}_kernel"] = (
                layer.weight.detach().numpy().transpose(2, 3, 1, 0))
            out[f"conv{conv_i}_bias"] = layer.bias.detach().numpy()
            conv_i += 1
    for j, lin in enumerate(net.lins):
        out[f"lin{j}"] = lin.model[-1].weight.detach().numpy().reshape(-1)
    np.savez(out_path, **out)


if __name__ == "__main__":
    if len(sys.argv) > 2 and sys.argv[1] == "export":
        export_from_torch(sys.argv[2])
