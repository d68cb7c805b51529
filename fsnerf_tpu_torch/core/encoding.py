"""Fourier-feature positional encoding with the FreeNeRF mask hook
(port of fsnerf_tpu/core/encoding.py).

Layout [x, sin(f0 x), cos(f0 x), sin(f1 x), cos(f1 x), ...], d_out =
d_in * (1 + 2F); log-spaced freqs 2**linspace(0, F-1, F) or linear
linspace(1, 2**(F-1), F).
"""

from __future__ import annotations

from typing import Optional

import torch


def linspace(start: float, stop: float, n: int, device=None):
    """float32 linspace by jnp.linspace's formula, start*(1-s) + stop*s with
    s = i/(n-1) and the endpoint exact. torch.linspace rounds differently;
    this gives the JAX package's log-spaced bands to the bit (XLA may still
    move a linear band by an ulp for F >= 7). Built on the device with no
    host-to-device copy, so a CUDA graph can capture it."""
    if n == 1:
        return torch.full((1,), start, dtype=torch.float32, device=device)
    s = torch.arange(n - 1, dtype=torch.float32, device=device) / (n - 1)
    out = start * (1.0 - s) + stop * s
    return torch.cat([out, torch.full((1,), stop, dtype=torch.float32,
                                      device=device)])


def frequencies(n_freqs: int, log_space: bool = True,
                device=None) -> torch.Tensor:
    """Frequency bands [F] float32."""
    if log_space:
        return 2.0 ** linspace(0.0, n_freqs - 1, n_freqs, device)
    return linspace(1.0, 2.0 ** (n_freqs - 1), n_freqs, device)


def positional_encoding(
    x: torch.Tensor,
    n_freqs: int,
    log_space: bool = True,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """gamma(x) = [x, sin(f_k x), cos(f_k x)]_k, optional per-band mask [F]
    multiplying both the sin and cos features of each band."""
    if n_freqs == 0:
        return x
    freqs = frequencies(n_freqs, log_space, x.device)      # [F]
    xb = x[..., None, :] * freqs[:, None]                   # [..., F, D]
    feat = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    if mask is not None:
        feat = feat * mask[:, None, None]
    feat = feat.reshape(*x.shape[:-1], 2 * n_freqs * x.shape[-1])
    return torch.cat([x, feat], dim=-1)


def encoded_dim(d_input: int, n_freqs: int) -> int:
    return d_input * (1 + 2 * n_freqs)


def freq_mask(n_freqs: int, step, total_steps: int,
              device=None) -> torch.Tensor:
    """FreeNeRF linear frequency-annealing mask [F] in [0, 1]: at step t the
    first floor(t*F/T) bands are visible, the next one fractionally.
    Identity (ones) when total_steps <= 0. `step` is a Python int or a 0-d
    tensor on `device` (the train step passes its device step counter, so
    the mask costs no host-to-device copy and a CUDA graph can capture
    it)."""
    if total_steps <= 0:
        return torch.ones(n_freqs, dtype=torch.float32, device=device)
    alpha = (torch.as_tensor(step, dtype=torch.float32, device=device)
             * n_freqs / float(total_steps))
    bands = torch.arange(n_freqs, dtype=torch.float32, device=device)
    return torch.clamp(alpha - bands, 0.0, 1.0)
