"""The NeRF and SiNeRF MLPs as nn.Modules (port of
fsnerf_tpu/core/models.py::NeRF and ::SiNeRF).

State-dict keys follow the reference `nn.pt` schema, with torch.nn.Linear's
[out, in] weights, so a reference checkpoint loads directly
(utils/interop.py maps JAX params). NeRF: layers.{i}, sigma, connection,
branch, rgb. SiNeRF: first_layers.{i}.fc_layer, sigma_layers.0.fc_layer,
sigma_layers.1, fc_feature, rgb_layers.0.fc_layer, rgb_layers.1 (a
SirenLinear wraps its nn.Linear as `fc_layer`).

NeRF:
8x256 ReLU trunk; after each layer index in `skip` the positional encoding
is concatenated behind the activation, so layer skip+1 takes [h, enc]
(weight columns [:d_filter] read h). Raw (unactivated) sigma head by
default, bottleneck `connection`, a d_filter/2-wide view branch over
[connection, dir_enc], sigmoid rgb. Output [..., 4] = [rgb, sigma], or
[..., 1] sigma when dirs is None.

SiNeRF: a SIREN trunk h = sin(a_i (h W_i^T + b_i)) with a = (30, 1, ...,
1), a sigma head of a sine layer (a = 1) and a plain Linear with ReLU, a
`fc_feature` Linear, and an rgb head of a sine layer over [feat, raw view
directions] (no encoding) and a Linear with sigmoid.

Compute modes, as fsnerf_tpu's TorchDense: float32, or bfloat16 where every
plain layer's matmul output, bias add and nonlinearity stay bfloat16 while
the parameters stay float32. A sine layer in bfloat16 mode multiplies
bf16-rounded operands in float32 and adds the float32 bias before the sine
(SirenDense's preferred_element_type=f32: a bf16 matmul output would cost
the a = 30 layer ~30 |y| 2^-9 of phase). The GEMMs here are plain
torch.matmul: these modules serve the grid's density pass and the non-fused
path, which the JAX package also leaves to XLA; the fused paths run
ops/kernels/.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
from torch import nn

from .encoding import encoded_dim, positional_encoding


def _density_activation(name: str, s: torch.Tensor) -> torch.Tensor:
    if name == "none":
        return s
    if name == "relu":
        return torch.relu(s)
    if name == "trunc_exp":
        return torch.exp(torch.clamp(s, -15.0, 15.0))
    raise ValueError(f"Unknown density activation: {name}")


def _dense(lin: nn.Linear, x: torch.Tensor,
           compute_dtype: torch.dtype) -> torch.Tensor:
    """A plain layer in the compute dtype (TorchDense): matmul output and
    bias add both in compute_dtype."""
    y = torch.matmul(x.to(compute_dtype), lin.weight.to(compute_dtype).t())
    return y + lin.bias.to(compute_dtype)


class NeRF(nn.Module):
    """Original-paper NeRF MLP with reference state-dict keys."""

    def __init__(
        self,
        n_layers: int = 8,
        d_filter: int = 256,
        skip: Sequence[int] = (4,),
        d_pos: int = 3,
        d_dir: int = 3,
        n_freqs: int = 10,
        n_freqs_views: int = 4,
        log_space: bool = True,
        density_activation: str = "none",
        compute_dtype: torch.dtype = torch.float32,
        use_viewdirs: bool = True,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.n_layers = n_layers
        self.d_filter = d = d_filter
        self.skip = tuple(skip)
        self.n_freqs = n_freqs
        self.n_freqs_views = n_freqs_views
        self.log_space = log_space
        self.density_activation = density_activation
        self.compute_dtype = compute_dtype
        self.use_viewdirs = use_viewdirs
        d_pos_enc = encoded_dim(d_pos, n_freqs)
        d_dir_enc = encoded_dim(d_dir, n_freqs_views) if use_viewdirs else 0

        layers, fan = [], d_pos_enc
        for i in range(n_layers):
            layers.append(nn.Linear(fan, d, device=device))
            fan = d + d_pos_enc if i in self.skip else d
        self.layers = nn.ModuleList(layers)
        self.sigma = nn.Linear(fan, 1, device=device)
        self.connection = nn.Linear(fan, d, device=device)
        self.branch = nn.Linear(d + d_dir_enc, d // 2, device=device)
        self.rgb = nn.Linear(d // 2, 3, device=device)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """torch.nn.Linear's default distribution, U(-1/sqrt(fan_in),
        1/sqrt(fan_in)) for weight and bias, drawn on the host from the CPU
        `generator` so a seed gives the same weights on every device."""
        for lin in self.modules():
            if isinstance(lin, nn.Linear):
                bound = 1.0 / math.sqrt(lin.in_features)
                for p in (lin.weight, lin.bias):
                    u = torch.rand(p.shape, generator=generator,
                                   dtype=torch.float32)
                    p.copy_(u * (2 * bound) - bound)

    def _dense(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return _dense(lin, x, self.compute_dtype)

    def forward(
        self,
        x: torch.Tensor,
        dirs: Optional[torch.Tensor] = None,
        pos_mask: Optional[torch.Tensor] = None,
        dir_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        x_in = positional_encoding(x, self.n_freqs, self.log_space, pos_mask)
        h = x_in
        for i, lin in enumerate(self.layers):
            h = torch.relu(self._dense(lin, h))
            if i in self.skip:
                h = torch.cat([h, x_in.to(h.dtype)], dim=-1)

        sigma = _density_activation(self.density_activation,
                                    self._dense(self.sigma, h))
        if dirs is None:
            return sigma
        feat = self._dense(self.connection, h)
        if self.use_viewdirs:
            dir_in = positional_encoding(dirs, self.n_freqs_views,
                                         self.log_space, dir_mask)
            b_in = torch.cat([feat, dir_in.to(feat.dtype)], dim=-1)
        else:
            b_in = feat
        b = torch.relu(self._dense(self.branch, b_in))
        rgb = torch.sigmoid(self._dense(self.rgb, b))
        return torch.cat([rgb, sigma], dim=-1)


def _sine_dtype(compute_dtype: torch.dtype) -> torch.dtype:
    """The sine layers' accumulation dtype: float32, or float64 for a
    float64 module (the tests' arbiter)."""
    return torch.promote_types(compute_dtype, torch.float32)


class SirenLinear(nn.Module):
    """sin(w (x W^T + b)) around an nn.Linear `fc_layer` (the reference's
    SirenLinear). SIREN init: U(-s, s) for weight and bias, s = 1/fan_in
    for the first layer and sqrt(6/fan_in) after it."""

    def __init__(self, in_features: int, out_features: int, w: float = 1.0,
                 is_first: bool = False,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.w = float(w)
        self.is_first = is_first
        self.compute_dtype = compute_dtype
        self.fc_layer = nn.Linear(in_features, out_features, device=device)

    @property
    def init_scale(self) -> float:
        fan_in = self.fc_layer.in_features
        return 1.0 / fan_in if self.is_first else math.sqrt(6.0 / fan_in)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd, lin = self.compute_dtype, self.fc_layer
        acc = _sine_dtype(cd)
        y = torch.matmul(x.to(cd).to(acc),
                         lin.weight.to(cd).to(acc).t()) + lin.bias.to(acc)
        return torch.sin(self.w * y)



class SiNeRF(nn.Module):
    """SIREN MLP for NeRF with reference state-dict keys. Output [..., 4] =
    [rgb, sigma], or [..., 1] sigma when dirs is None. pos_mask / dir_mask
    are accepted and ignored: SiNeRF reads raw coordinates."""

    def __init__(
        self,
        width: int = 256,
        alpha: Sequence[float] = (30.0,) + (1.0,) * 7,
        d_pos: int = 3,
        d_dir: int = 3,
        compute_dtype: torch.dtype = torch.float32,
        use_viewdirs: bool = True,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        w = self.width = width
        self.alpha = tuple(float(a) for a in alpha)
        self.compute_dtype = compute_dtype
        self.use_viewdirs = use_viewdirs
        cd = dict(compute_dtype=compute_dtype, device=device)
        self.first_layers = nn.ModuleList(
            [SirenLinear(d_pos, w, self.alpha[0], is_first=True, **cd)]
            + [SirenLinear(w, w, a, **cd) for a in self.alpha[1:]])
        self.sigma_layers = nn.ModuleList([
            SirenLinear(w, w // 2, 1.0, **cd),
            nn.Linear(w // 2, 1, device=device)])
        self.fc_feature = nn.Linear(w, w, device=device)
        self.rgb_layers = nn.ModuleList([
            SirenLinear(w + (d_dir if use_viewdirs else 0), w // 2, 1.0, **cd),
            nn.Linear(w // 2, 3, device=device)])
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """SIREN init for the sine layers, torch.nn.Linear's default for the
        plain ones, drawn on the host from the CPU `generator`."""
        sine = {id(m.fc_layer): m.init_scale for m in self.modules()
                if isinstance(m, SirenLinear)}
        for lin in self.modules():
            if not isinstance(lin, nn.Linear):
                continue
            bound = sine.get(id(lin), 1.0 / math.sqrt(lin.in_features))
            for p in (lin.weight, lin.bias):
                u = torch.rand(p.shape, generator=generator,
                               dtype=torch.float32)
                p.copy_(u * (2 * bound) - bound)

    def _dense(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return _dense(lin, x, self.compute_dtype)

    def forward(
        self,
        x: torch.Tensor,
        dirs: Optional[torch.Tensor] = None,
        pos_mask: Optional[torch.Tensor] = None,
        dir_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        h = x
        for layer in self.first_layers:
            h = layer(h)
        sigma = torch.relu(self._dense(self.sigma_layers[1],
                                       self.sigma_layers[0](h)))
        if dirs is None:
            return sigma
        feat = self._dense(self.fc_feature, h)
        acc = _sine_dtype(self.compute_dtype)
        r = (torch.cat([feat.to(acc), dirs.to(acc)], dim=-1)
             if self.use_viewdirs else feat)
        rgb = torch.sigmoid(self._dense(self.rgb_layers[1],
                                        self.rgb_layers[0](r)))
        return torch.cat([rgb, sigma], dim=-1)


def make_model(cfg, compute_dtype: torch.dtype = torch.bfloat16,
               generator: Optional[torch.Generator] = None,
               device=None) -> nn.Module:
    """NeRF or SiNeRF from a Config (fsnerf_tpu/core/models.py::make_model;
    the JAX package's default compute dtype is bfloat16)."""
    if cfg.model.model == "sinerf":
        return SiNeRF(
            width=cfg.model.d_filter,
            alpha=(30.0,) + (1.0,) * (cfg.model.n_layers - 1),
            d_pos=cfg.encoder.d_input,
            d_dir=cfg.encoder.d_input,
            compute_dtype=compute_dtype,
            use_viewdirs=not cfg.encoder.no_dirs,
            generator=generator,
            device=device,
        )
    if cfg.model.model != "nerf":
        raise ValueError(f"Model {cfg.model.model} not supported")
    return NeRF(
        n_layers=cfg.model.n_layers,
        d_filter=cfg.model.d_filter,
        skip=tuple(cfg.model.skip),
        d_pos=cfg.encoder.d_input,
        d_dir=cfg.encoder.d_input,
        n_freqs=cfg.encoder.n_freqs,
        n_freqs_views=cfg.encoder.n_freqs_views,
        log_space=cfg.encoder.log_space,
        density_activation=cfg.model.density_activation,
        compute_dtype=compute_dtype,
        use_viewdirs=not cfg.encoder.no_dirs,
        generator=generator,
        device=device,
    )
