"""SiNeRF (Xie et al. 2022) in plain torch: the reference the benchmark
holds the port's SIREN kernels against.

Weights come as a dict keyed like the port's state dict:
first_layers.{i}.fc_layer, sigma_layers.0.fc_layer, sigma_layers.1,
fc_feature, rgb_layers.0.fc_layer, rgb_layers.1. Every matmul reads its
two operands through `q` (ops.Quant).

    h_0 = x;  h_i+1 = sin(a_i (W_i h_i + b_i)),  a = (30, 1, ..., 1)
    sigma = relu(W_s1 sin(W_s0 h + b_s0) + b_s1)
    rgb = sigmoid(W_r1 sin(W_r0 [W_f h + b_f, d] + b_r0) + b_r1)
"""

from __future__ import annotations

import torch


def linear(w: dict, name: str, x: torch.Tensor, q) -> torch.Tensor:
    return q(x) @ q(w[name + ".weight"]).t() + w[name + ".bias"]


def trunk(w: dict, model: dict, x: torch.Tensor, q) -> torch.Tensor:
    h = x
    for i in range(model["n_layers"]):
        a = 30.0 if i == 0 else 1.0
        h = torch.sin(a * linear(w, f"first_layers.{i}.fc_layer", h, q))
    return h


def _sigma(w: dict, h: torch.Tensor, q) -> torch.Tensor:
    s = torch.sin(linear(w, "sigma_layers.0.fc_layer", h, q))
    return torch.relu(linear(w, "sigma_layers.1", s, q))


def density(w: dict, model: dict, x: torch.Tensor, q) -> torch.Tensor:
    """sigma [N] at points [N, 3]."""
    return _sigma(w, trunk(w, model, x, q), q)[..., 0]


def forward(w: dict, model: dict, x: torch.Tensor, d: torch.Tensor,
            q) -> torch.Tensor:
    """[rgb, sigma] [N, 4] at points [N, 3] seen along unit directions
    [N, 3]."""
    h = trunk(w, model, x, q)
    feat = linear(w, "fc_feature", h, q)
    r = torch.sin(linear(w, "rgb_layers.0.fc_layer",
                         torch.cat([feat, d], dim=-1), q))
    rgb = torch.sigmoid(linear(w, "rgb_layers.1", r, q))
    return torch.cat([rgb, _sigma(w, h, q)], dim=-1)
