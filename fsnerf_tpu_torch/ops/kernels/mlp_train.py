"""Trainable fused NeRF MLP: the CUDA train kernels' wrappers, their plain
PyTorch versions and the autograd Function the train step calls (port of
fsnerf_tpu/ops/pallas/mlp_train.py::make_fused_train_model_fn).

Forward: positional encoding of the raw points and directions (polynomial
sin, reference layout, FreeNeRF band masks), the NeRF MLP with bf16
operands and f32 accumulation, out [N, 4] = rgb (f32 sigmoid), raw sigma;
optionally the trunk activations [N, L*W] bf16 for the backward. Backward:
the weight and bias gradients of the same MLP, rounded to bf16, from the
saved activations or a recompute of the trunk (bitwise equal either way).
The positions and directions get no gradient.

`mlp_train_fwd` / `mlp_train_bwd` launch csrc/mlp_train.cu for CUDA tensors
and run `mlp_train_fwd_reference` / `mlp_train_bwd_reference` only for CPU
tensors. Weights travel packed in the ray march's walk order
(render.py::pack_weights); gradients come back in the same packed layout.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ...core.encoding import encoded_dim
from .render import (_bf16, _round_up, enc_table, encode, heads_forward,
                     pack_weights, trunk_forward, unpack)

ROWS = 128              # the kernels' row tile (csrc/mlp_common.cuh kRows)
DW_TILE = 64            # weight-gradient output tile and row chunk
SPLIT_ROWS = 8192       # rows per weight-gradient split, a multiple of DW_TILE


@dataclass(frozen=True)
class TrainLayout:
    """The NeRF architecture the train kernels are built for."""

    n_layers: int
    skip: Tuple[int, ...]
    width: int
    n_freqs: int
    n_freqs_views: int

    @property
    def d_enc(self) -> int:
        return encoded_dim(3, self.n_freqs)

    @property
    def d_dir(self) -> int:
        return encoded_dim(3, self.n_freqs_views)

    @property
    def de(self) -> int:
        return _round_up(self.d_enc, 16)

    @property
    def dd(self) -> int:
        return _round_up(self.d_dir, 16)

    @property
    def skip_mask(self) -> int:
        return sum(1 << i for i in range(1, self.n_layers)
                   if (i - 1) in self.skip)

    @property
    def n_w(self) -> int:
        W, Wh = self.width, self.width // 2
        trunk = self.de * W + sum(
            W * W + (self.de * W if (i - 1) in self.skip else 0)
            for i in range(1, self.n_layers))
        return trunk + W + W * W + W * Wh + self.dd * Wh + Wh * 3

    @property
    def n_b(self) -> int:
        return self.n_layers * self.width + 1 + self.width + \
            self.width // 2 + 3

    @property
    def param_names(self) -> Tuple[str, ...]:
        """The NeRF module's parameter names, in registration order."""
        mods = [f"layers.{i}" for i in range(self.n_layers)] + [
            "sigma", "connection", "branch", "rgb"]
        return tuple(f"{m}.{k}" for m in mods for k in ("weight", "bias"))

    @staticmethod
    def from_config(cfg) -> "TrainLayout":
        skip = tuple(cfg.model.skip)
        if skip and max(skip) >= cfg.model.n_layers - 1:
            raise ValueError("the train kernels need the skip concat to "
                             "feed a trunk layer")
        if cfg.model.d_filter % 32:
            raise ValueError("width must be a multiple of 32")
        return TrainLayout(cfg.model.n_layers, skip, cfg.model.d_filter,
                           cfg.encoder.n_freqs, cfg.encoder.n_freqs_views)

    def grads_from_packed(self, dw: torch.Tensor, db: torch.Tensor):
        """Packed gradients -> one tensor per parameter, in param_names
        order and the module's [out, in] orientation."""
        trunk, b_trunk, hd = unpack(dw, db, self.n_layers, self.skip,
                                    self.width, self.de, self.dd)
        out = []
        for i, ws in enumerate(trunk):
            if i == 0:
                g = ws[0][:self.d_enc].t()
            elif len(ws) == 2:
                g = torch.cat([ws[0].t(), ws[1][:self.d_enc].t()], dim=1)
            else:
                g = ws[0].t()
            out += [g, b_trunk[i]]
        out += [hd["sigma"].t(), hd["b_sigma"], hd["conn"].t(), hd["b_conn"],
                torch.cat([hd["branch_h"].t(),
                           hd["branch_d"][:self.d_dir].t()], dim=1),
                hd["b_branch"], hd["rgb"].t(), hd["b_rgb"]]
        return [g.contiguous() for g in out]


@dataclass(frozen=True)
class TrainParams:
    """Weights packed for the train kernels: wpack / bpack as
    render.py::pack_weights; wtpack (bf16) the [out, in] matrices of the
    input-cotangent products: the h part of trunk layers 1..L-1, then
    connection, then the h part of branch; enc the band table of
    render.py::enc_table."""

    wpack: torch.Tensor
    bpack: torch.Tensor
    wtpack: torch.Tensor
    enc: torch.Tensor
    layout: TrainLayout


def pack_train_params(state_dict: Dict[str, torch.Tensor],
                      layout: TrainLayout, enc: torch.Tensor) -> TrainParams:
    """Pack a reference-keyed NeRF state dict on its own device."""
    with torch.no_grad():
        sd = {k: v.detach().to(torch.float32) for k, v in state_dict.items()}
        wpack, bpack = pack_weights(sd, layout.n_layers, layout.skip,
                                    layout.de, layout.dd)
        W = layout.width
        wt = [sd[f"layers.{i}.weight"][:, :W].reshape(-1)
              for i in range(1, layout.n_layers)]
        wt += [sd["connection.weight"].reshape(-1),
               sd["branch.weight"][:, :W].reshape(-1)]
        wtpack = torch.cat(wt).to(torch.bfloat16).contiguous()
    return TrainParams(wpack, bpack, wtpack, enc, layout)


def _encodings(x, d, p: TrainParams):
    lay, e = p.layout, p.enc
    F, Fv = lay.n_freqs, lay.n_freqs_views
    ex = encode(x, e[:F], e[F:2 * F], lay.de)
    ed = encode(d, e[2 * F:2 * F + Fv], e[2 * F + Fv:], lay.dd)
    return ex, ed


def _unpacked(p: TrainParams):
    lay = p.layout
    return unpack(p.wpack.to(torch.float32), p.bpack, lay.n_layers,
                  lay.skip, lay.width, lay.de, lay.dd)


def mlp_train_fwd_reference(x, d, params: TrainParams,
                            save_acts: bool = False):
    """Plain PyTorch version of the train forward kernel.

    Args: x, d [N, 3] float32 points and directions; params from
    pack_train_params. Returns (out [N, 4] float32, acts [N, L*W] bf16 or
    None)."""
    ex, ed = _encodings(x, d, params)
    trunk, b_trunk, hd = _unpacked(params)
    hs = trunk_forward(ex, trunk, b_trunk)
    sigma = hs[-1] @ hd["sigma"] + hd["b_sigma"]
    rgb = heads_forward(hs[-1], ed, hd)[2]
    acts = torch.cat(hs, dim=-1).to(torch.bfloat16) if save_acts else None
    return torch.cat([rgb, sigma], dim=-1), acts


def mlp_train_bwd_reference(x, d, dout, params: TrainParams, acts=None):
    """Plain PyTorch version of the train backward kernels, step for step
    as fsnerf_tpu/ops/pallas/mlp_train.py::_bwd_grads: each cotangent is
    rounded to bf16 before it enters a product, ReLU' is the bf16
    activation > 0, bias gradients are column sums of the f32 cotangents.

    Args: x, d [N, 3]; dout [N, 4] float32; acts from the forward (None =
    recompute the trunk). Returns (dw [n_w], db [n_b]) float32 holding
    bf16-rounded values, packed as wpack / bpack."""
    lay = params.layout
    W = lay.width
    ex, ed = _encodings(x, d, params)
    trunk, b_trunk, hd = _unpacked(params)
    if acts is None:
        hs = trunk_forward(ex, trunk, b_trunk)
    else:
        hs = [acts[:, i * W:(i + 1) * W].to(torch.float32)
              for i in range(lay.n_layers)]
    h = hs[-1]
    feat, br, rgb = heads_forward(h, ed, hd)
    dout = dout.to(torch.float32)

    drgb = dout[:, :3] * rgb * (1.0 - rgb)
    drgb_b = _bf16(drgb)
    dbr = torch.where(br > 0, drgb_b @ hd["rgb"].t(), 0.0)
    dbr_b = _bf16(dbr)
    dfeat = dbr_b @ hd["branch_h"].t()
    dfeat_b = _bf16(dfeat)
    dsig = dout[:, 3:4]
    dsig_b = _bf16(dsig)
    heads_w = [h.t() @ dsig_b, h.t() @ dfeat_b, feat.t() @ dbr_b,
               ed.t() @ dbr_b, br.t() @ drgb_b]
    heads_b = [dsig.sum(0), dfeat.sum(0), dbr.sum(0), drgb.sum(0)]

    dh = dfeat_b @ hd["conn"].t() + dsig_b @ hd["sigma"].t()
    g_trunk, b_grads = [None] * lay.n_layers, [None] * lay.n_layers
    for i in range(lay.n_layers - 1, -1, -1):
        dh = torch.where(hs[i] > 0, dh, 0.0)
        dh_b = _bf16(dh)
        b_grads[i] = dh.sum(0)
        ws = trunk[i]
        if i == 0:
            g_trunk[i] = [ex.t() @ dh_b]
        else:
            g_trunk[i] = [hs[i - 1].t() @ dh_b]
            if len(ws) == 2:
                g_trunk[i].append(ex.t() @ dh_b)
            dh = dh_b @ ws[0].t()
    dw = torch.cat([g.reshape(-1) for gs in g_trunk for g in gs]
                   + [g.reshape(-1) for g in heads_w])
    db = torch.cat(b_grads + heads_b)
    return _bf16(dw), _bf16(db)


def _check(name, x, d, params: TrainParams, extra=()):
    N = x.shape[0]
    for nm, a, shape in (("x", x, (N, 3)), ("d", d, (N, 3))) + tuple(extra):
        if tuple(a.shape) != shape or a.dtype != torch.float32:
            raise ValueError(f"{name}: {nm} wants float32 {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    tensors = [x, d, params.wpack, params.bpack, params.wtpack, params.enc]
    tensors += [a for _, a, _ in extra]
    for a in tensors:
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on one device")


def _launch_error(lib, err, name):
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.fsnerf_error_string(err).decode())


def mlp_train_fwd(x, d, params: TrainParams, save_acts: bool = False):
    """The train forward: csrc/mlp_train.cu for CUDA tensors,
    mlp_train_fwd_reference for CPU tensors. On the card acts has
    round_up(N, 128) rows (the kernel's row tile). Counts its kernel
    launches in `mlp_train_fwd.launches`."""
    if x.device.type == "cpu":
        return mlp_train_fwd_reference(x, d, params, save_acts)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_train_fwd runs on cpu or cuda, not {x.device}")
    _check("mlp_train_fwd", x, d, params)
    from .build import load_library

    lib = load_library()
    lay = params.layout
    N = x.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=x.device)
    acts = (torch.empty((_round_up(N, ROWS), lay.n_layers * lay.width),
                        dtype=torch.bfloat16, device=x.device)
            if save_acts else None)
    err = lib.fsnerf_mlp_train_fwd(
        x.data_ptr(), d.data_ptr(), params.wpack.data_ptr(),
        params.bpack.data_ptr(), params.enc.data_ptr(), out.data_ptr(),
        None if acts is None else acts.data_ptr(), N, lay.n_layers,
        lay.skip_mask, lay.width, lay.n_freqs, lay.n_freqs_views, lay.de,
        lay.dd, torch.cuda.current_stream(x.device).cuda_stream)
    _launch_error(lib, err, "mlp_train_fwd")
    mlp_train_fwd.launches += 1
    return out, acts


mlp_train_fwd.launches = 0


def dw_jobs(lay: TrainLayout):
    """The weight-gradient products, one per packed matrix in wpack order:
    (x_src 0 = acts / 1 = xs, x_col, k_in, y_col, n_out, w_off) over the
    backward's scratch layouts (csrc/mlp_train.cu TrainArgs)."""
    W, Wh, L, de, dd = lay.width, lay.width // 2, lay.n_layers, lay.de, lay.dd
    dy_conn = L * W
    dy_branch, dy_sigma = dy_conn + W, dy_conn + W + Wh
    jobs, off = [], 0

    def add(x_src, x_col, k_in, y_col, n_out):
        nonlocal off
        jobs.append((x_src, x_col, k_in, y_col, n_out, off))
        off += k_in * n_out

    for i in range(L):
        if i == 0:
            add(1, 0, de, 0, W)
        else:
            add(0, (i - 1) * W, W, i * W, W)
            if (i - 1) in lay.skip:
                add(1, 0, de, i * W, W)
    add(0, (L - 1) * W, W, dy_sigma, 1)
    add(0, (L - 1) * W, W, dy_conn, W)
    add(1, de + dd, W, dy_branch, Wh)
    add(1, de, dd, dy_branch, Wh)
    add(1, de + dd + W, Wh, dy_sigma + 8, 3)
    assert off == lay.n_w
    return jobs


@functools.lru_cache(maxsize=None)
def dw_plan(jobs: Tuple[Tuple[int, ...], ...], device: str):
    """(jobs [n_jobs, 6], tiles [n_tiles, 3]) int32 on `device`: one tile
    per DW_TILE x DW_TILE block of each job's [k_in, n_out] gradient."""
    tiles = [(j, tm, tn) for j, job in enumerate(jobs)
             for tm in range(-(-job[2] // DW_TILE))
             for tn in range(-(-job[4] // DW_TILE))]
    return (torch.tensor(jobs, dtype=torch.int32, device=device),
            torch.tensor(tiles, dtype=torch.int32, device=device))


def mlp_train_bwd(x, d, dout, params: TrainParams, acts=None):
    """The train backward: csrc/mlp_train.cu for CUDA tensors,
    mlp_train_bwd_reference for CPU tensors; same arguments and returns.
    acts None recomputes the trunk. Counts its launches in
    `mlp_train_bwd.launches`."""
    if x.device.type == "cpu":
        return mlp_train_bwd_reference(x, d, dout, params, acts)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_train_bwd runs on cpu or cuda, not {x.device}")
    lay = params.layout
    N, W, Wh = x.shape[0], lay.width, lay.width // 2
    n_pad = _round_up(N, ROWS)
    _check("mlp_train_bwd", x, d, params, (("dout", dout, (N, 4)),))
    recompute = acts is None
    dev = x.device
    if recompute:
        acts = torch.empty((n_pad, lay.n_layers * W), dtype=torch.bfloat16,
                           device=dev)
    elif (tuple(acts.shape) != (n_pad, lay.n_layers * W)
          or acts.dtype != torch.bfloat16 or acts.device != dev
          or not acts.is_contiguous()):
        raise ValueError("mlp_train_bwd: acts must be the forward kernel's "
                         f"[{n_pad}, {lay.n_layers * W}] bf16 stream")
    from .build import load_library

    lib = load_library()
    xs = torch.empty((n_pad, lay.de + lay.dd + W + Wh), dtype=torch.bfloat16,
                     device=dev)
    dy = torch.empty((n_pad, lay.n_layers * W + W + Wh + 16),
                     dtype=torch.bfloat16, device=dev)
    pbias = torch.empty((n_pad // ROWS, lay.n_b), dtype=torch.float32,
                        device=dev)
    jobs, tiles = dw_plan(tuple(dw_jobs(lay)), str(dev))
    part = torch.empty((-(-n_pad // SPLIT_ROWS), lay.n_w),
                       dtype=torch.float32, device=dev)
    dw = torch.empty(lay.n_w, dtype=torch.float32, device=dev)
    db = torch.empty(lay.n_b, dtype=torch.float32, device=dev)
    err = lib.fsnerf_mlp_train_bwd(
        x.data_ptr(), d.data_ptr(), dout.data_ptr(), params.wpack.data_ptr(),
        params.bpack.data_ptr(), params.wtpack.data_ptr(),
        params.enc.data_ptr(), acts.data_ptr(), int(recompute),
        xs.data_ptr(), dy.data_ptr(), pbias.data_ptr(), jobs.data_ptr(),
        tiles.data_ptr(), tiles.shape[0], part.data_ptr(), SPLIT_ROWS,
        dw.data_ptr(), db.data_ptr(), N, lay.n_layers, lay.skip_mask, W,
        lay.n_freqs, lay.n_freqs_views, lay.de, lay.dd,
        torch.cuda.current_stream(dev).cuda_stream)
    _launch_error(lib, err, "mlp_train_bwd")
    mlp_train_bwd.launches += 1
    return dw, db


mlp_train_bwd.launches = 0


class FusedTrainMLP(torch.autograd.Function):
    """out [N, 4] = the NeRF MLP of the packed `weights` (the module's
    parameters in TrainLayout.param_names order) at x, d [N, 3]; the
    backward runs mlp_train_bwd and returns bf16-representable float32
    gradients for the weights only."""

    @staticmethod
    def forward(ctx, layout: TrainLayout, enc, save_acts: bool, x, d,
                *weights):
        params = pack_train_params(dict(zip(layout.param_names, weights)),
                                   layout, enc)
        out, acts = mlp_train_fwd(x, d, params, save_acts)
        ctx.params, ctx.acts = params, acts
        ctx.save_for_backward(x, d)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, d = ctx.saved_tensors
        params, acts = ctx.params, ctx.acts
        ctx.params = ctx.acts = None
        dw, db = mlp_train_bwd(x, d, dout.contiguous(), params, acts)
        return (None, None, None, None, None,
                *params.layout.grads_from_packed(dw, db))


@functools.lru_cache(maxsize=None)
def _band_table(n_freqs: int, n_freqs_views: int, log_space: bool,
                device: str) -> torch.Tensor:
    return enc_table(n_freqs, n_freqs_views, log_space, device=device)


def make_fused_train_model_fn(cfg, save_acts: Optional[bool] = None):
    """The trainable model_fn of the train step: apply_fn(model, x, dirs,
    pos_mask=None, dir_mask=None) -> [..., 4] whose gradient with respect
    to the NeRF module's parameters runs through the train kernels.

    save_acts: None resolves from cfg.model.fused_save_acts."""
    layout = TrainLayout.from_config(cfg)
    if save_acts is None:
        save_acts = bool(cfg.model.fused_save_acts)
    log_space = cfg.encoder.log_space

    def apply_fn(model, x, dirs, pos_mask=None, dir_mask=None):
        names, weights = zip(*model.named_parameters())
        if names != layout.param_names:
            raise ValueError(f"model parameters {names} do not match the "
                             f"train kernels' layout {layout.param_names}")
        if pos_mask is None and dir_mask is None:
            enc = _band_table(layout.n_freqs, layout.n_freqs_views,
                              log_space, str(x.device))
        else:
            enc = enc_table(layout.n_freqs, layout.n_freqs_views, log_space,
                            pos_mask, dir_mask, x.device)
        shape = x.shape[:-1]
        out = FusedTrainMLP.apply(
            layout, enc, save_acts,
            x.reshape(-1, 3).to(torch.float32).contiguous(),
            dirs.reshape(-1, 3).to(torch.float32).contiguous(), *weights)
        return out.reshape(*shape, 4)

    return apply_fn
