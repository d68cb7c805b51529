"""The NeRF MLP of Mildenhall et al. 2020 in plain torch: the reference the
benchmark holds the port's NeRF kernels against.

Weights come as a dict keyed like the port's state dict (torch.nn.Linear's
[out, in] matrices): layers.{i}, sigma, connection, branch, rgb. Every
matmul reads its two operands through `q` (ops.Quant: float32 as given, or
rounded to float8 for the control).

    enc(x) = [x, sin(f_0 x), cos(f_0 x), ..., sin(f_F-1 x), cos(f_F-1 x)],
             f_k = 2^k, each sin / cos over the three coordinates
    h_0 = enc(x);  h_i+1 = relu(W_i h_i + b_i), then [h_i+1, enc(x)] after
          each layer index in `skip`
    sigma = W_s h + b_s (raw)
    rgb = sigmoid(W_rgb relu(W_br [W_c h + b_c, enc(d)] + b_br) + b_rgb)
"""

from __future__ import annotations

import torch


def encode(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    freqs = 2.0 ** torch.arange(n_freqs, dtype=torch.float32,
                                device=x.device)
    xb = x[..., None, :] * freqs[:, None]                 # [..., F, 3]
    both = torch.stack([torch.sin(xb), torch.cos(xb)], dim=-2)
    return torch.cat([x, both.flatten(-3)], dim=-1)


def linear(w: dict, name: str, x: torch.Tensor, q) -> torch.Tensor:
    return q(x) @ q(w[name + ".weight"]).t() + w[name + ".bias"]


def trunk(w: dict, model: dict, x: torch.Tensor, q) -> torch.Tensor:
    enc = encode(x, model["n_freqs"])
    h = enc
    for i in range(model["n_layers"]):
        h = torch.relu(linear(w, f"layers.{i}", h, q))
        if i in model["skip"]:
            h = torch.cat([h, enc], dim=-1)
    return h


def density(w: dict, model: dict, x: torch.Tensor, q) -> torch.Tensor:
    """sigma [N] at points [N, 3]."""
    return linear(w, "sigma", trunk(w, model, x, q), q)[..., 0]


def forward(w: dict, model: dict, x: torch.Tensor, d: torch.Tensor,
            q) -> torch.Tensor:
    """[rgb, sigma] [N, 4] at points [N, 3] seen along unit directions
    [N, 3]."""
    h = trunk(w, model, x, q)
    sigma = linear(w, "sigma", h, q)
    feat = linear(w, "connection", h, q)
    b = torch.relu(linear(w, "branch", torch.cat(
        [feat, encode(d, model["n_freqs_views"])], dim=-1), q))
    return torch.cat([torch.sigmoid(linear(w, "rgb", b, q)), sigma], dim=-1)
