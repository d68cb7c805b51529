"""Trainable fused NeRF MLP: the CUDA train kernels' wrappers, their plain
PyTorch versions and the autograd Function the train step calls (port of
fsnerf_tpu/ops/pallas/mlp_train.py::make_fused_train_model_fn).

Forward: positional encoding of the raw points and directions (polynomial
sin, reference layout, FreeNeRF band masks), the NeRF MLP with bf16
operands and f32 accumulation, out [N, 4] = rgb (f32 sigmoid), raw sigma;
optionally the trunk activations [N, L*W] bf16 for the backward. Backward:
the weight and bias gradients of the same MLP, rounded to bf16, from the
saved activations or, without them, the forward kernel run again into the
same stream first (bitwise equal either way). The positions and
directions get no gradient.

`mlp_train_fwd` / `mlp_train_bwd` launch csrc/mlp_train.cu for CUDA tensors
and run `mlp_train_fwd_reference` / `mlp_train_bwd_reference` only for CPU
tensors. Weights travel packed in the ray march's walk order
(render.py::pack_weights) at the packed width (render.py::nerf_kernel_width);
gradients come back in the same packed layout, their padded entries
exactly 0, and TrainLayout.grads_from_packed cuts them to the module's
shapes. At the packed widths 384 and 512 the forward runs the column-split
trunk of csrc/ws_trunk.cuh and the backward's row pass 64-row CTAs
(bwd_rows); at 768 and 1024 the forward runs the streamed trunk (each
layer's output stored to acts, or to a scratch the wrapper allocates, and
read back as the next layer's operand) and the row pass streams its
operands from device memory on 64-row CTAs. All write and read the same
layouts as at the other widths.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from ...core.encoding import encoded_dim
from .render import (KERNEL_WIDTHS, STREAM_WIDTHS, _bf16, _ptr, _round_up,
                     enc_table, encode, heads_forward, kernel_arch_error,
                     nerf_kernel_width, pack_weights, stream_scratch,
                     trunk_forward, unpack)

ROWS = 128              # the kernels' row tile (csrc/mlp_common.cuh kRows)
# weight-gradient output tile: input dims x output dims
# (csrc/train_common.cuh kDwTileM, kDwTileN), rows per pipeline stage (kDwBk)
DW_TILE_M, DW_TILE_N, DW_BK = 128, 256, 64
SPLIT_ROWS = 8192       # rows per weight-gradient split, a multiple of DW_BK


def bwd_rows(width: int) -> int:
    """Kernel 6's row pass's rows per CTA at a packed width (csrc/
    mlp_train.cu bwd_rows): ROWS, or 64 from 384 up, where two 128-row
    activation buffers would not fit in shared memory."""
    return ROWS if width <= KERNEL_WIDTHS[-1] else 64


def bwd_rows_smem_bytes(width: int, d_dir_pad: int,
                        rows: Optional[int] = None) -> int:
    """Shared memory of kernel 6's row pass over `rows` rows a CTA
    (default bwd_rows(width); csrc/mlp_train.cu smem_bytes): two activation
    buffers and the direction encoding (rows padded by 8), the weight ring,
    the heads' floats and one row of column sums per warp of 2 rows
    threads. At STREAM_WIDTHS (and rows None) the streamed row pass's
    (csrc/mlp_train.cu stream_rows_smem_bytes): three stages of a 128 x 64
    weight tile and a 64 x 64 operand tile (rows padded by 8), one 64 x 128
    output tile (padded by 8), the heads' floats and four warps' column
    sums of a 128-column chunk, whatever the width and encodings."""
    if width in STREAM_WIDTHS and rows is None:
        return (1024 + 3 * (128 * 128 + 64 * 72 * 2) + 64 * 136 * 2
                + 4 * (7 * 64 + 4 * 128))
    R = bwd_rows(width) if rows is None else rows
    return (2 * R * (2 * width + d_dir_pad + 24) + 3 * 128 * 128 + 1024
            + 4 * (7 * R + R // 16 * width))


@dataclass(frozen=True)
class TrainLayout:
    """The NeRF architecture the train kernels are built for: `width` the
    packed width (render.py::nerf_kernel_width of the module's),
    model_width the module's (None: width)."""

    n_layers: int
    skip: Tuple[int, ...]
    width: int
    n_freqs: int
    n_freqs_views: int
    model_width: Optional[int] = None

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

    def wpack_views(self):
        """How the forward kernel's tensor maps view wpack (csrc/
        mlp_train.cu launch_fwd_w): its first trunk_rows * W elements as a
        [trunk_rows, W] matrix (each trunk matrix, w_sigma, w_conn), the
        next (W + dd) * W/2 as a [W + dd, W/2] one (w_branch_h, w_branch_d).
        Returns (trunk_rows, {matrix: (view, first row, rows)}), view
        "trunk" or "branch"; ".enc" / ".dir" name the encoding part of a
        skip layer or of the branch."""
        W, de = self.width, self.de
        rows, r = {}, 0
        for i in range(self.n_layers):
            rows[f"layers.{i}"] = ("trunk", r, de if i == 0 else W)
            r += rows[f"layers.{i}"][2]
            if i > 0 and (i - 1) in self.skip:
                rows[f"layers.{i}.enc"] = ("trunk", r, de)
                r += de
        rows["sigma"] = ("trunk", r, 1)
        rows["connection"] = ("trunk", r + 1, W)
        rows["branch"] = ("branch", 0, W)
        rows["branch.dir"] = ("branch", W, self.dd)
        return r + 1 + W, rows

    @property
    def param_names(self) -> Tuple[str, ...]:
        """The NeRF module's parameter names, in registration order."""
        mods = [f"layers.{i}" for i in range(self.n_layers)] + [
            "sigma", "connection", "branch", "rgb"]
        return tuple(f"{m}.{k}" for m in mods for k in ("weight", "bias"))

    def kernel_error(self) -> Optional[str]:
        """Why the train kernels refuse this layout on the card, or None
        (their plain versions take any width)."""
        return kernel_arch_error(self.width, self.de, self.dd,
                                 "train kernels")

    @staticmethod
    def of_module(n_layers: int, skip: Tuple[int, ...], width: int,
                  n_freqs: int, n_freqs_views: int) -> "TrainLayout":
        """The layout of a NeRF module `width` wide, at the packed width."""
        return TrainLayout(n_layers, tuple(skip), nerf_kernel_width(width),
                           n_freqs, n_freqs_views, width)

    @staticmethod
    def from_config(cfg, device=None) -> "TrainLayout":
        """The layout of cfg's NeRF for the train kernels on `device` (None:
        the card), at the packed width; ValueError if they do not take it
        there."""
        skip = tuple(cfg.model.skip)
        if skip and max(skip) >= cfg.model.n_layers - 1:
            raise ValueError("the train kernels need the skip concat to "
                             "feed a trunk layer")
        lay = TrainLayout.of_module(cfg.model.n_layers, skip,
                                    cfg.model.d_filter, cfg.encoder.n_freqs,
                                    cfg.encoder.n_freqs_views)
        err = lay.kernel_error()
        if err is not None and (device is None
                                or torch.device(device).type == "cuda"):
            raise ValueError(err)
        return lay

    def grads_from_packed(self, dw: torch.Tensor, db: torch.Tensor):
        """Packed gradients -> one tensor per parameter, in param_names
        order, the module's [out, in] orientation and its width (the padded
        units' entries cut away)."""
        trunk, b_trunk, hd = unpack(dw, db, self.n_layers, self.skip,
                                    self.width, self.de, self.dd)
        W = self.model_width or self.width
        Wh, de = W // 2, self.d_enc
        out = []
        for i, ws in enumerate(trunk):
            if i == 0:
                g = ws[0][:de, :W].t()
            elif len(ws) == 2:
                g = torch.cat([ws[0][:W, :W].t(), ws[1][:de, :W].t()], dim=1)
            else:
                g = ws[0][:W, :W].t()
            out += [g, b_trunk[i][:W]]
        out += [hd["sigma"][:W].t(), hd["b_sigma"], hd["conn"][:W, :W].t(),
                hd["b_conn"][:W],
                torch.cat([hd["branch_h"][:W, :Wh].t(),
                           hd["branch_d"][:self.d_dir, :Wh].t()], dim=1),
                hd["b_branch"][:Wh], hd["rgb"][:Wh].t(), hd["b_rgb"]]
        return [g.contiguous() for g in out]


@dataclass(frozen=True)
class TrainParams:
    """Weights packed for the train kernels: wpack / bpack as
    render.py::pack_weights (the backward reads wpack's [in, out] matrices
    K-major for its input-cotangent products); enc the band table of
    render.py::enc_table."""

    wpack: torch.Tensor
    bpack: torch.Tensor
    enc: torch.Tensor
    layout: TrainLayout


def pack_train_params(state_dict: Dict[str, torch.Tensor],
                      layout: TrainLayout, enc: torch.Tensor) -> TrainParams:
    """Pack a reference-keyed NeRF state dict on its own device."""
    with torch.no_grad():
        sd = {k: v.detach().to(torch.float32) for k, v in state_dict.items()}
        wpack, bpack = pack_weights(sd, layout.n_layers, layout.skip,
                                    layout.de, layout.dd, layout.width)
    return TrainParams(wpack, bpack, enc, layout)


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


def _bwd_terms(x, d, dout, params: TrainParams, acts=None):
    """The backward's operands and cotangents, step for step as
    fsnerf_tpu/ops/pallas/mlp_train.py::_bwd_grads: each cotangent is
    rounded to bf16 before it enters a product, ReLU' is the bf16
    activation > 0. Returns a dict of them; dh / dh_b [layer] are the
    trunk's masked f32 cotangents and their bf16 roundings."""
    lay = params.layout
    W = lay.width
    ex, ed = _encodings(x, d, params)
    trunk, b_trunk, hd = _unpacked(params)
    if acts is None:
        hs = trunk_forward(ex, trunk, b_trunk)
    else:
        hs = [acts[:, i * W:(i + 1) * W].to(torch.float32)
              for i in range(lay.n_layers)]
    feat, br, rgb = heads_forward(hs[-1], ed, hd)
    dout = dout.to(torch.float32)

    drgb = dout[:, :3] * rgb * (1.0 - rgb)
    drgb_b = _bf16(drgb)
    dbr = torch.where(br > 0, drgb_b @ hd["rgb"].t(), 0.0)
    dbr_b = _bf16(dbr)
    dfeat = dbr_b @ hd["branch_h"].t()
    dfeat_b = _bf16(dfeat)
    dsig = dout[:, 3:4]
    dsig_b = _bf16(dsig)
    dh_all, dh_b_all = [None] * lay.n_layers, [None] * lay.n_layers
    dh = dfeat_b @ hd["conn"].t() + dsig_b @ hd["sigma"].t()
    for i in range(lay.n_layers - 1, -1, -1):
        dh = torch.where(hs[i] > 0, dh, 0.0)
        dh_all[i], dh_b_all[i] = dh, _bf16(dh)
        if i > 0:
            dh = dh_b_all[i] @ trunk[i][0].t()
    return dict(ex=ex, ed=ed, hs=hs, feat=feat, br=br, drgb=drgb,
                drgb_b=drgb_b, dbr=dbr, dbr_b=dbr_b, dfeat=dfeat,
                dfeat_b=dfeat_b, dsig=dsig, dsig_b=dsig_b, dh=dh_all,
                dh_b=dh_b_all, trunk=trunk)


def mlp_train_bwd_reference(x, d, dout, params: TrainParams, acts=None):
    """Plain PyTorch version of the train backward kernels, step for step
    as fsnerf_tpu/ops/pallas/mlp_train.py::_bwd_grads: each cotangent is
    rounded to bf16 before it enters a product, ReLU' is the bf16
    activation > 0, bias gradients are column sums of the f32 cotangents.

    Args: x, d [N, 3]; dout [N, 4] float32; acts from the forward (None =
    recompute the trunk). Returns (dw [n_w], db [n_b]) float32 holding
    bf16-rounded values, packed as wpack / bpack."""
    lay = params.layout
    t = _bwd_terms(x, d, dout, params, acts)
    h, ex = t["hs"][-1], t["ex"]
    heads_w = [h.t() @ t["dsig_b"], h.t() @ t["dfeat_b"],
               t["feat"].t() @ t["dbr_b"], t["ed"].t() @ t["dbr_b"],
               t["br"].t() @ t["drgb_b"]]
    heads_b = [t["dsig"].sum(0), t["dfeat"].sum(0), t["dbr"].sum(0),
               t["drgb"].sum(0)]
    g_trunk = []
    for i in range(lay.n_layers):
        dh_b = t["dh_b"][i]
        if i == 0:
            g_trunk.append([ex.t() @ dh_b])
        else:
            g_trunk.append([t["hs"][i - 1].t() @ dh_b])
            if len(t["trunk"][i]) == 2:
                g_trunk[i].append(ex.t() @ dh_b)
    b_grads = [dh.sum(0) for dh in t["dh"]]
    dw = torch.cat([g.reshape(-1) for gs in g_trunk for g in gs]
                   + [g.reshape(-1) for g in heads_w])
    db = torch.cat(b_grads + heads_b)
    return _bf16(dw), _bf16(db)


def bwd_operands_reference(x, d, dout, params: TrainParams, acts=None):
    """Plain PyTorch version of what the backward's row pass leaves in
    device memory for the weight-gradient pass, in its layouts (csrc/
    mlp_train.cu TrainArgs): (acts [N, L*W], xs [N, XW] = encx | encd |
    feat | br, dy [N, DYW] = dY_0..L-1 | conn | branch | sigma (8) | rgb
    (8)), all bf16."""
    t = _bwd_terms(x, d, dout, params, acts)
    zeros = torch.zeros((x.shape[0], 5), dtype=torch.float32,
                        device=x.device)
    bf = torch.bfloat16
    acts_out = torch.cat(t["hs"], dim=-1).to(bf)
    xs = torch.cat([t["ex"], t["ed"], t["feat"], t["br"]], dim=-1).to(bf)
    dy = torch.cat(t["dh_b"] + [t["dfeat_b"], t["dbr_b"], t["dsig_b"],
                                zeros, zeros[:, :2], t["drgb_b"], zeros],
                   dim=-1).to(bf)
    return acts_out, xs, dy


def _check(name, x, d, params: TrainParams, extra=()):
    """Validate a CUDA call: shapes, dtypes, one device, contiguity, and an
    architecture the forward kernel is built for (the backward runs it in
    recompute mode and reads its activations in saved mode)."""
    err = params.layout.kernel_error()
    if err is not None:
        raise ValueError(f"{name}: {err}")
    N = x.shape[0]
    for nm, a, shape in (("x", x, (N, 3)), ("d", d, (N, 3))) + tuple(extra):
        if tuple(a.shape) != shape or a.dtype != torch.float32:
            raise ValueError(f"{name}: {nm} wants float32 {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")
    tensors = [x, d, params.wpack, params.bpack, params.enc]
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
    slab, ctas = stream_scratch(lay.width, x.device)
    err = lib.fsnerf_mlp_train_fwd(
        x.data_ptr(), d.data_ptr(), params.wpack.data_ptr(),
        params.bpack.data_ptr(), params.enc.data_ptr(), out.data_ptr(),
        _ptr(acts), _ptr(slab), ctas, N, lay.n_layers,
        lay.skip_mask, lay.width, lay.n_freqs, lay.n_freqs_views, lay.de,
        lay.dd, lay.wpack_views()[0],
        torch.cuda.current_stream(x.device).cuda_stream)
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
    (job, tm, tn) per DW_TILE_M x DW_TILE_N block of each job's [k_in,
    n_out] gradient, the blocks of one job next to each other."""
    tiles = [(j, tm, tn) for j, job in enumerate(jobs)
             for tn in range(-(-job[4] // DW_TILE_N))
             for tm in range(-(-job[2] // DW_TILE_M))]
    return (torch.tensor(jobs, dtype=torch.int32, device=device),
            torch.tensor(tiles, dtype=torch.int32, device=device))


def dw_pass_reference(acts, xs, dy, jobs, split_rows: int = SPLIT_ROWS):
    """Plain PyTorch version of the weight-gradient pass: for each job
    (x_src, x_col, k_in, y_col, n_out, w_off), f32 X^T dY over each split
    of split_rows rows, the splits summed in order, rounded to bf16.
    Returns dw [n_w] float32."""
    n_w = max(j[5] + j[2] * j[4] for j in jobs)
    dw = torch.zeros(n_w, dtype=torch.float32, device=dy.device)
    for x_src, x_col, k_in, y_col, n_out, w_off in jobs:
        X = (xs if x_src else acts)[:, x_col:x_col + k_in].float()
        Y = dy[:, y_col:y_col + n_out].float()
        g = torch.zeros((k_in, n_out), dtype=torch.float32,
                        device=dy.device)
        for r in range(0, dy.shape[0], split_rows):
            g = g + X[r:r + split_rows].t() @ Y[r:r + split_rows]
        dw[w_off:w_off + k_in * n_out] = g.reshape(-1)
    return _bf16(dw)


def dw_pass(acts, xs, dy, jobs, split_rows: int = SPLIT_ROWS):
    """The weight-gradient pass alone (the backward's last two launches,
    csrc/train_common.cuh) over bf16 operands acts, xs, dy [rows, .] for
    CUDA tensors (rows a multiple of ROWS); dw_pass_reference for CPU
    tensors. Counts its launches in `dw_pass.launches`."""
    if dy.device.type == "cpu":
        return dw_pass_reference(acts, xs, dy, jobs, split_rows)
    if dy.device.type != "cuda":
        raise ValueError(f"dw_pass runs on cpu or cuda, not {dy.device}")
    n = dy.shape[0]
    for a in (acts, xs, dy):
        if (a.dim() != 2 or a.shape[0] != n or a.dtype != torch.bfloat16
                or a.device != dy.device or not a.is_contiguous()):
            raise ValueError("dw_pass needs contiguous bf16 [rows, .] "
                             "operands on one device")
    if n % ROWS or split_rows % DW_BK:
        raise ValueError(f"dw_pass: rows {n} must be a multiple of {ROWS} "
                         f"and split_rows of {DW_BK}")
    from .build import load_library

    lib = load_library()
    jobs_t, tiles = dw_plan(tuple(tuple(j) for j in jobs), str(dy.device))
    n_w = max(j[5] + j[2] * j[4] for j in jobs)
    part = torch.empty((-(-n // split_rows), n_w), dtype=torch.float32,
                       device=dy.device)
    dw = torch.empty(n_w, dtype=torch.float32, device=dy.device)
    err = lib.fsnerf_dw_pass(
        acts.data_ptr(), acts.shape[1], xs.data_ptr(), xs.shape[1],
        dy.data_ptr(), dy.shape[1], n, jobs_t.data_ptr(), tiles.data_ptr(),
        tiles.shape[0], part.data_ptr(), n_w, split_rows, dw.data_ptr(),
        torch.cuda.current_stream(dy.device).cuda_stream)
    _launch_error(lib, err, "dw_pass")
    dw_pass.launches += 1
    return dw


dw_pass.launches = 0


def mlp_train_bwd(x, d, dout, params: TrainParams, acts=None,
                  operands: Optional[dict] = None):
    """The train backward: csrc/mlp_train.cu for CUDA tensors,
    mlp_train_bwd_reference for CPU tensors; same arguments and returns.
    acts None recomputes the trunk: on the card the forward kernel runs
    first, into the acts stream the backward allocates (not counted in
    `mlp_train_fwd.launches`). On the card a dict `operands` receives the
    row pass's xs and dy scratch (bwd_operands_reference's layouts, n_pad
    rows; scripts/grad_arbiter.py reads them). Counts its launches in
    `mlp_train_bwd.launches`."""
    if x.device.type == "cpu":
        return mlp_train_bwd_reference(x, d, dout, params, acts)
    if x.device.type != "cuda":
        raise ValueError(f"mlp_train_bwd runs on cpu or cuda, not {x.device}")
    lay = params.layout
    N, W, Wh = x.shape[0], lay.width, lay.width // 2
    n_pad = _round_up(N, ROWS)
    _check("mlp_train_bwd", x, d, params, (("dout", dout, (N, 4)),))
    dev = x.device
    fwd_out, slab, ctas = None, None, 0
    if acts is None:
        slab, ctas = stream_scratch(W, dev)
        acts = torch.empty((n_pad, lay.n_layers * W), dtype=torch.bfloat16,
                           device=dev)
        fwd_out = torch.empty((N, 4), dtype=torch.float32, device=dev)
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
    pbias = torch.empty((n_pad // bwd_rows(W), lay.n_b),
                        dtype=torch.float32, device=dev)
    jobs, tiles = dw_plan(tuple(dw_jobs(lay)), str(dev))
    part = torch.empty((-(-n_pad // SPLIT_ROWS), lay.n_w),
                       dtype=torch.float32, device=dev)
    dw = torch.empty(lay.n_w, dtype=torch.float32, device=dev)
    db = torch.empty(lay.n_b, dtype=torch.float32, device=dev)
    err = lib.fsnerf_mlp_train_bwd(
        x.data_ptr(), d.data_ptr(), dout.data_ptr(), params.wpack.data_ptr(),
        params.bpack.data_ptr(), params.enc.data_ptr(), acts.data_ptr(),
        _ptr(fwd_out), _ptr(slab), ctas, xs.data_ptr(),
        dy.data_ptr(), pbias.data_ptr(), jobs.data_ptr(), tiles.data_ptr(),
        tiles.shape[0], part.data_ptr(), SPLIT_ROWS, dw.data_ptr(),
        db.data_ptr(), N, lay.n_layers, lay.skip_mask, W, lay.n_freqs,
        lay.n_freqs_views, lay.de, lay.dd, lay.wpack_views()[0],
        torch.cuda.current_stream(dev).cuda_stream)
    _launch_error(lib, err, "mlp_train_bwd")
    mlp_train_bwd.launches += 1
    if operands is not None:
        operands.update(xs=xs, dy=dy)
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


def make_fused_train_model_fn(cfg, save_acts: Optional[bool] = None,
                              device=None):
    """The trainable model_fn of the train step: apply_fn(model, x, dirs,
    pos_mask=None, dir_mask=None) -> [..., 4] whose gradient with respect
    to the NeRF module's parameters runs through the train kernels on
    `device` (None: the card; TrainLayout.from_config says which
    architectures they take).

    save_acts: None resolves from cfg.model.fused_save_acts."""
    layout = TrainLayout.from_config(cfg, device)
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
