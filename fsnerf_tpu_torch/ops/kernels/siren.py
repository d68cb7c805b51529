"""Trainable SiNeRF (SIREN) MLP: the CUDA train kernels' wrappers, their
plain PyTorch versions, the autograd Function the train step calls and the
eval model_fn (port of fsnerf_tpu/ops/pallas/siren.py).

The MLP: an L-layer sine trunk h_i = bf16(sin(a_i (h W_i + b_i))) with
a = (30, 1, ..., 1) on raw bf16 coordinates; a sigma head (a sine layer,
a = 1, then a Linear and ReLU); feat = bf16(h W_f + b_f); an rgb head (a
sine layer over feat and the raw bf16 view directions, as two GEMMs into
one sum, then a Linear and an f32 sigmoid). Every GEMM multiplies bf16
operands in f32; the bias is added in f32 and the sine argument stays f32.
Every sin/cos is the polynomial of fastmath.py (csrc/fastmath.cuh on the
card). Out [N, 4] = rgb, sigma.

Two backward modes, as the TPU kernels:
* saved (save_acts=True): the forward streams each trunk activation h_i and
  its premultiplied derivative bf16(a_i cos(a_i y_i)) to device memory
  ([N, 2 L W] bf16: h_i at columns i W, the factor at (L + i) W); the
  backward reads them and recomputes only the heads.
* recompute (acts None): the backward runs the trunk again and holds the
  factors a_i cos(a_i y_i) in float32 (on the card from the packed width
  384 up it runs the forward kernel into an acts stream first, so there
  its factors are bf16 and its gradients the saved mode's).
The two modes' gradients differ by that bf16 rounding; each mode alone is
bitwise repeatable on the card. Weight gradients come back rounded to bf16,
bias gradients in float32 (the TPU kernels' operand dtypes). The positions
and directions get no gradient.

`siren_mlp_fwd` / `siren_mlp_bwd` launch csrc/siren.cu for CUDA tensors and
run `siren_mlp_fwd_reference` / `siren_mlp_bwd_reference` only for CPU
tensors; the forward without acts does so as the registered op
fsnerf_torch::siren_mlp_fwd, which a torch.export program keeps as a call
(utils/export.py). Inputs are the padded bf16 coordinates of
`pad_inputs`; weights travel packed by `prep_siren_params` in the
kernels' walk order at the packed width (render.py::kernel_width: zero
units with zero biases, whose sines are exactly 0), and gradients come back
in the same packed layout.

On the card the warp-specialized kernels take every packed width:
64, 128, 192 and 256 with two 64-row consumers of whole rows, 384 and 512
on csrc/ws_trunk.cuh's column-split trunk (one 64-row consumer, each
product as two output column halves; the backward's row pass on 64-row
CTAs), 768 and every multiple of 256 above (render.py::stream_width) on its
streamed trunk (persistent CTAs of one 64-row consumer, each layer in
256-column chunks through device memory and back, the heads in 128-column
chunks; the backward's row pass on kernel 6's streamed shape, every
operand through L2), so a SiNeRF of any width trains and renders on them
up to W_max, the widest whose packed weights int32 offsets address
(render.py::MAX_PACKED_WEIGHTS: 15,360 at 8 layers; siren_kernel_error).
The mma.sync forward and march still take 288 and 320, which no packer
lays out (the card checks reach them through _prep_siren_params).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

from .fastmath import sincos_fast
from .mlp_train import SPLIT_ROWS, _launch_error, bwd_rows, dw_plan
from .mlp_train import bwd_rows_smem_bytes
from .render import (MAX_PACKED_WEIGHTS, SMEM_LIMIT, SPLIT_WIDTHS,
                     STREAM_MIN_WIDTH, STREAM_STEP, _bf16, _ptr, _round_up,
                     kernel_width, padded, stream_scratch, stream_width,
                     widest_stream_width)

ROWS = 128              # the kernels' row tile (csrc/mlp_common.cuh kRows)
D_IN_PAD = 16           # raw coordinates / directions, zero-padded columns
# the widest width of the mma.sync SIREN kernels (the forward and the march
# at 288 and 320, the recompute mode's row pass up to 256): past it they
# hold two [128, W + 8] bf16 activation buffers beside the weight slabs
# (csrc/siren.cu fwd_smem_bytes, bwd_smem_bytes; render.cu SirenMarch),
# which fill SMEM_LIMIT (mma_smem_bytes)
SIREN_MMA_MAX_WIDTH = {"forward": 320, "march": 320, "backward": 256}


def mma_smem_bytes(width: int, kernel: str) -> int:
    """Shared memory of the mma.sync SIREN `kernel` at a packed width."""
    slabs, rows = 2 * 64 * 136, ROWS * (2 * (width + 8) + 2 * (D_IN_PAD + 8))
    if kernel == "forward":
        return 2 * (rows + slabs) + 4 * 4 * ROWS
    if kernel == "march":
        return 2 * (rows + slabs) + 4 * 16 * ROWS
    return (2 * (rows + ROWS * (width // 2 + 8) + slabs)
            + 4 * (8 * ROWS + 4 * width))


def siren_smem_bytes(width: int, kernel: str, n_stages: int = 2,
                     n_layers: int = 8, rows: Optional[int] = None) -> int:
    """Shared memory of the warp-specialized SIREN `kernel` ("forward" in
    saved mode, "march", or "backward": the saved mode's row pass) at a
    packed width with a ring of n_stages (csrc/ws_trunk.cuh fwd_smem_bytes
    with the extras of csrc/siren.cu launch_fwd_ws and csrc/render.cu
    launch_siren_march_w; csrc/siren.cu ws_bwd_smem_bytes). rows: a CTA's
    rows, 128 (two consumers of 64 whole-width rows, stages of 64 x width)
    or 64 (one consumer on the column-split trunk: stages of 64 x width / 2
    and three half tiles); default 64 at SPLIT_WIDTHS, else 128. The
    128-row backward also holds each consumer's bias partials (n_layers
    deep); the 64-row one writes them straight to device memory. At
    a streamed width (and rows None) the streamed shapes', whatever the
    width:
    the forward's and the march's (csrc/ws_trunk.cuh stream_smem_bytes:
    stages of 64 x 256, the A ring's four 64 x 64 tiles, one 64 x 256
    output tile, the input tile; the forward's factor staging block and
    input barrier, the march's done flag and rows' directions), the
    backward's kernel 6's streamed row pass's (n_stages cp.async stages;
    mlp_train.py::bwd_rows_smem_bytes)."""
    blk, bar, Wh = 64 * 64 * 2, 8, width // 2
    if stream_width(width) and rows is None:
        if kernel == "backward":
            return (bwd_rows_smem_bytes(width, 0)
                    + (n_stages - 3) * (128 * 128 + 64 * 72 * 2))
        base = (1024 + n_stages * 256 * 128 + (4 + 4 + 1) * blk
                + (2 * n_stages + 4) * bar)
        if kernel == "forward":
            return base + blk + 16
        return base + 16 + ROWS * 4 * 4
    R = rows or (64 if width in SPLIT_WIDTHS else ROWS)
    if kernel == "backward":
        s_tile = -(-Wh // 64) * blk            # s_s, then dys
        if R == 64:
            return (1024 + (n_stages + 3) * Wh * 128 + s_tile
                    + 4 * 4 * (width + 4) + (2 * n_stages + 1) * bar)
        n_b = SirenLayout(n_layers, width, ()).n_b
        return (1024 + (n_stages + 2) * width * 128 + 2 * s_tile
                + 2 * 4 * (4 * (width + 4) + n_b) + (2 * n_stages + 2) * bar)
    consumers = 1 if R == 64 else 2
    tiles = 3 * Wh * 128 if R == 64 else 2 * width * 128
    stage = Wh * 128 if R == 64 else width * 128
    base = (1024 + n_stages * stage + tiles + consumers * blk
            + 2 * n_stages * bar)
    if kernel == "forward":          # each consumer's input barrier, its
        return base + consumers * (bar + blk)      # factors' staging block
    return base + 16 + ROWS * 4 * 4  # the done flag, the rows' directions


def siren_stages(width: int, kernel: str, n_layers: int = 8) -> int:
    """The ring the warp-specialized SIREN `kernel` runs at a packed width:
    the deepest up to 4 stages that fits in SMEM_LIMIT (siren_smem_bytes),
    or 0 if 2 do not; at a streamed width the backward's row pass runs
    kernel 6's fixed ring of 3 cp.async stages (0 if it did not fit)."""
    if stream_width(width) and kernel == "backward":
        return 3 if siren_smem_bytes(width, kernel, 3) <= SMEM_LIMIT else 0
    for n in (4, 3, 2):
        if siren_smem_bytes(width, kernel, n, n_layers) <= SMEM_LIMIT:
            return n
    return 0


def launcher_stages(width: int, kernel: str, n_layers: int = 8) -> int:
    """The ring the C launcher of the warp-specialized SIREN `kernel` runs
    at a packed width, from its own arithmetic (csrc/siren.cu
    fsnerf_siren_stages, csrc/render.cu fsnerf_siren_march_stages), or 0:
    the number siren_stages mirrors. Builds the kernel library."""
    from .build import load_library

    lib = load_library()
    if kernel == "march":
        return lib.fsnerf_siren_march_stages(width)
    return lib.fsnerf_siren_stages(
        width, {"forward": 0, "backward": 2}[kernel], n_layers)


def siren_max_width(n_layers: int = 8) -> int:
    """W_max of an n_layers SiNeRF: the widest streamed width whose packed
    weights (SirenLayout.n_w; wtpack holds fewer) int32 offsets address."""
    return widest_stream_width(lambda W: SirenLayout(n_layers, W, ()).n_w)


def siren_kernel_error(width: int, kernel: str = "backward",
                       n_layers: int = 8) -> Optional[str]:
    """Why the SIREN `kernel` refuses a packed width for an n_layers SiNeRF
    on the card, or None. "backward" is the train kernels' limit (the
    backward and its forward). They take every width render.py::
    kernel_width packs at up to siren_max_width(n_layers) (and the
    mma.sync kernels' widths up to SIREN_MMA_MAX_WIDTH)."""
    mma = SIREN_MMA_MAX_WIDTH[kernel]
    top = siren_max_width(n_layers)
    if width <= mma or width in SPLIT_WIDTHS or (stream_width(width)
                                                 and width <= top):
        return None
    if stream_width(width):
        return (f"the SIREN {kernel} kernel takes widths up to W_max = "
                f"{top} at {n_layers} layers, not {width}: its packed "
                f"weights ({SirenLayout(n_layers, width, ()).n_w} elements) "
                f"would pass the {MAX_PACKED_WEIGHTS} that int32 offsets "
                f"address")
    return (f"the SIREN {kernel} kernel takes the packed widths up to {mma}, "
            f"{SPLIT_WIDTHS} and the multiples of {STREAM_STEP} from "
            f"{STREAM_MIN_WIDTH} up to W_max, not {width} (its mma.sync "
            f"shape's shared memory: {mma_smem_bytes(width, kernel)} bytes "
            f"of {SMEM_LIMIT})")


def siren_alphas(n_layers: int) -> Tuple[float, ...]:
    """The reference's per-layer frequencies (run-nerf.py:69)."""
    return (30.0,) + (1.0,) * (n_layers - 1)


@dataclass(frozen=True)
class SirenLayout:
    """The SiNeRF architecture the kernels are built for: `width` the
    packed width (render.py::kernel_width of the module's), model_width the
    module's (None: width)."""

    n_layers: int
    width: int
    alphas: Tuple[float, ...]
    model_width: Optional[int] = None

    @property
    def n_w(self) -> int:
        L, W, Wh, P = self.n_layers, self.width, self.width // 2, D_IN_PAD
        return (P * W + (L - 1) * W * W + W * Wh + Wh + W * W + W * Wh
                + P * Wh + Wh * 3)

    @property
    def n_b(self) -> int:
        W, Wh = self.width, self.width // 2
        return self.n_layers * W + Wh + 1 + W + Wh + 3

    @property
    def modules(self) -> Tuple[str, ...]:
        """The SiNeRF module's Linear layers, in walk order."""
        return tuple(f"first_layers.{i}.fc_layer"
                     for i in range(self.n_layers)) + (
            "sigma_layers.0.fc_layer", "sigma_layers.1", "fc_feature",
            "rgb_layers.0.fc_layer", "rgb_layers.1")

    @property
    def param_names(self) -> Tuple[str, ...]:
        """The SiNeRF module's parameter names, in registration order."""
        return tuple(f"{m}.{k}" for m in self.modules
                     for k in ("weight", "bias"))

    @staticmethod
    def from_config(cfg) -> "SirenLayout":
        if cfg.encoder.no_dirs:
            raise ValueError("the SiNeRF train kernels take view directions")
        W = cfg.model.d_filter
        return SirenLayout(cfg.model.n_layers, kernel_width(W),
                           siren_alphas(cfg.model.n_layers), W)

    def grads_from_packed(self, dw: torch.Tensor, db: torch.Tensor):
        """Packed gradients -> one tensor per parameter, in param_names
        order, the module's [out, in] orientation and its width (the padded
        units' entries cut away)."""
        u = unpack(dw, db, self)
        W = self.model_width or self.width
        Wh = W // 2
        out = []
        for i in range(self.n_layers):
            g = u["t"][i][:3, :W] if i == 0 else u["t"][i][:W, :W]
            out += [g.t(), u["b"][i][:W]]
        out += [u["ws0"][:W, :Wh].t(), u["bs0"][:Wh], u["ws1"][:Wh].t(),
                u["bs1"], u["wf"][:W, :W].t(), u["bf"][:W],
                torch.cat([u["wr0f"][:W, :Wh].t(), u["wr0d"][:3, :Wh].t()],
                          dim=1),
                u["br0"][:Wh], u["wr1"][:Wh].t(), u["br1"]]
        return [g.contiguous() for g in out]


@dataclass(frozen=True)
class SirenParams:
    """Weights packed for the SIREN kernels. wpack (bf16, flat) holds the
    [in, out] row-major matrices in walk order: t_0 [16, W] (rows past 3
    zero), t_1 .. t_{L-1} [W, W], w_s0 [W, W/2], w_s1 [W/2], w_f [W, W],
    w_r0f [W, W/2], w_r0d [16, W/2] (rows past 3 zero; all zero without
    view directions), w_r1 [W/2, 3]. bpack (float32, not rounded): b_0 ..
    b_{L-1} [W], b_s0 [W/2], b_s1 [1], b_f [W], b_r0 [W/2], b_r1 [3].
    wtpack (bf16; the train backward only) holds the [out, in] matrices of
    the input-cotangent products: t_1 .. t_{L-1}, w_f, w_s0, w_r0f. alphas:
    [L] float32."""

    wpack: torch.Tensor
    bpack: torch.Tensor
    wtpack: Optional[torch.Tensor]
    alphas: torch.Tensor
    layout: SirenLayout


def prep_siren_params(state_dict: Dict[str, torch.Tensor],
                      n_layers: int = 8,
                      alphas: Optional[Sequence[float]] = None,
                      with_transposed: bool = False,
                      device=None) -> SirenParams:
    """Pack a reference-keyed SiNeRF state dict (core/models.py) on
    `device` (default: the state dict's) at render.py::kernel_width of the
    module's width: the units past the module's are zero columns with zero
    biases, read by zero rows."""
    W = state_dict["first_layers.0.fc_layer.weight"].shape[0]
    return _prep_siren_params(state_dict, n_layers, alphas, with_transposed,
                              device, kernel_width(W))


def _prep_siren_params(state_dict, n_layers, alphas, with_transposed,
                       device, width: int) -> SirenParams:
    """prep_siren_params at the packed width `width` (at least the
    module's): the card checks pack at 288 or 320 with it to reach the
    mma.sync forward and march, which kernel_width no longer packs at."""
    with torch.no_grad():
        sd = {k: v.detach().to(device=device, dtype=torch.float32)
              for k, v in state_dict.items()}
        W = sd["first_layers.0.fc_layer.weight"].shape[0]
        K = width
        if K < W or K % 2:
            raise ValueError(f"cannot pack a SiNeRF of width {W} at {K}")
        Kh = K // 2
        alphas = tuple(float(a) for a in (alphas or siren_alphas(n_layers)))
        if len(alphas) != n_layers:
            raise ValueError(f"{len(alphas)} alphas for {n_layers} layers")
        lay = SirenLayout(n_layers, K, alphas, W)

        def w(name):
            return sd[f"{name}.weight"]

        t = [w(f"first_layers.{i}.fc_layer") for i in range(n_layers)]
        wr0 = w("rgb_layers.0.fc_layer")
        mats = [padded(t[0].t(), D_IN_PAD, K)]
        mats += [padded(ti.t(), K, K) for ti in t[1:]]
        mats += [padded(w("sigma_layers.0.fc_layer").t(), K, Kh),
                 padded(w("sigma_layers.1").reshape(-1), Kh),
                 padded(w("fc_feature").t(), K, K),
                 padded(wr0[:, :W].t(), K, Kh),
                 padded(wr0[:, W:].t(), D_IN_PAD, Kh),
                 padded(w("rgb_layers.1").t(), Kh, 3)]
        wpack = torch.cat([m.reshape(-1) for m in mats]).to(torch.bfloat16)
        sizes = [K] * n_layers + [Kh, 1, K, Kh, 3]
        bpack = torch.cat([padded(sd[f"{m}.bias"].reshape(-1), n)
                           for m, n in zip(lay.modules, sizes)])
        wtpack = None
        if with_transposed:
            wtpack = torch.cat([m.reshape(-1) for m in [
                padded(ti, K, K) for ti in t[1:]] + [
                padded(w("fc_feature"), K, K),
                padded(w("sigma_layers.0.fc_layer"), Kh, K),
                padded(wr0[:, :W], Kh, K)]]).to(torch.bfloat16).contiguous()
    if wpack.numel() != lay.n_w or bpack.numel() != lay.n_b:
        raise ValueError("state dict does not match a SiNeRF of "
                         f"{n_layers} layers")
    return SirenParams(wpack.contiguous(), bpack.contiguous(), wtpack,
                       _alpha_table(alphas, str(wpack.device)), lay)


@functools.lru_cache(maxsize=None)
def _alpha_table(alphas: Tuple[float, ...], device: str) -> torch.Tensor:
    """[L] float32 on `device`, made once (a host-to-device copy per train
    step would wait for the device)."""
    return torch.tensor(alphas, dtype=torch.float32, device=device)


def unpack(wflat: torch.Tensor, bflat: torch.Tensor, lay: SirenLayout):
    """Views of flat packed weights and biases in the kernels' walk order:
    dict of t [L matrices], b [L vectors] and the head matrices / biases
    (w_s1 as [W/2, 1])."""
    W, Wh, P = lay.width, lay.width // 2, D_IN_PAD
    off = 0

    def take(rows, cols):
        nonlocal off
        m = wflat[off:off + rows * cols].reshape(rows, cols)
        off += rows * cols
        return m

    u = {"t": [take(P, W)] + [take(W, W) for _ in range(lay.n_layers - 1)]}
    u.update(ws0=take(W, Wh), ws1=take(Wh, 1), wf=take(W, W),
             wr0f=take(W, Wh), wr0d=take(P, Wh), wr1=take(Wh, 3))
    sizes = [W] * lay.n_layers + [Wh, 1, W, Wh, 3]
    parts = list(torch.split(bflat, sizes))
    u["b"] = parts[:lay.n_layers]
    u.update(zip(("bs0", "bs1", "bf", "br0", "br1"), parts[lay.n_layers:]))
    return u


def _unpacked(p: SirenParams):
    return unpack(p.wpack.to(torch.float32), p.bpack, p.layout)


def pad_inputs(v: torch.Tensor) -> torch.Tensor:
    """[N, 3] coordinates or directions -> [N, 16] bf16, zero-padded."""
    out = torch.zeros((v.shape[0], D_IN_PAD), dtype=torch.bfloat16,
                      device=v.device)
    out[:, :3] = v.to(torch.bfloat16)
    return out


def _trunk(x, u, alphas, want_cos: bool):
    """Trunk activations [h_0 .. h_{L-1}] (bf16-rounded float32) and, with
    want_cos, the float32 factors a_i cos(a_i y_i)."""
    hs, cs, h = [], [], x
    for i, a in enumerate(alphas):
        y = h @ u["t"][i] + u["b"][i]
        s, c = sincos_fast(a * y, True, want_cos)
        h = _bf16(s)
        hs.append(h)
        if want_cos:
            cs.append(a * c)
    return hs, cs


def _heads(h, d, u):
    """The head stack from the last trunk activation, as the TPU kernels'
    _heads_siren: every intermediate the backward reads."""
    ys = h @ u["ws0"] + u["bs0"]
    s_s = _bf16(sincos_fast(ys)[0])
    sigma_pre = s_s @ u["ws1"] + u["bs1"]
    feat = _bf16(h @ u["wf"] + u["bf"])
    yr = feat @ u["wr0f"] + d @ u["wr0d"] + u["br0"]
    s_r = _bf16(sincos_fast(yr)[0])
    rgb = torch.sigmoid(s_r @ u["wr1"] + u["br1"])
    return dict(ys=ys, s_s=s_s, sigma_pre=sigma_pre, feat=feat, yr=yr,
                s_r=s_r, rgb=rgb)


def siren_mlp_fwd_reference(x, d, params: SirenParams,
                            save_acts: bool = False):
    """Plain PyTorch version of the SIREN forward kernel, step for step as
    fsnerf_tpu/ops/pallas/siren.py::_fwd_siren.

    Args: x, d [N, 16] bf16 (pad_inputs); params from prep_siren_params.
    Returns (out [N, 4] float32, acts [N, 2 L W] bf16 or None)."""
    _check_inputs("siren_mlp_fwd_reference", x, d)
    u = _unpacked(params)
    if not save_acts:
        h = _trunk(x.to(torch.float32), u, params.layout.alphas, False)[0][-1]
        acts = None
    else:      # _trunk's walk, each layer's h_i and factor stored as bf16
        L, W = params.layout.n_layers, params.layout.width
        acts = torch.empty((x.shape[0], 2 * L * W), dtype=torch.bfloat16,
                           device=x.device)
        h = x.to(torch.float32)
        for i, a in enumerate(params.layout.alphas):
            hs, cs = _trunk(h, {"t": u["t"][i:i + 1], "b": u["b"][i:i + 1]},
                            (a,), True)
            h = hs[0]
            acts[:, i * W:(i + 1) * W] = h
            acts[:, (L + i) * W:(L + i + 1) * W] = cs[0]
            del hs, cs
    hd = _heads(h, d.to(torch.float32), u)
    out = torch.cat([hd["rgb"], torch.relu(hd["sigma_pre"])], dim=-1)
    return out, acts


def siren_mlp_bwd_reference(x, d, dout, params: SirenParams, acts=None):
    """Plain PyTorch version of the SIREN backward kernels, step for step
    as fsnerf_tpu/ops/pallas/siren.py::_bwd_grads_siren: each cotangent is
    rounded to bf16 before it enters a product, the heads' derivative
    factors are float32 cos of the recomputed pre-activations, the sigma
    gate is sigma_pre > 0, bias gradients are column sums of the float32
    cotangents.

    Args: x, d [N, 16] bf16; dout [N, 4] float32; acts (at least N rows)
    from the forward, or None to recompute the trunk with float32 factors.
    Returns (dw [n_w] float32 holding bf16-rounded values, db [n_b]
    float32), packed as wpack / bpack."""
    _check_inputs("siren_mlp_bwd_reference", x, d)
    lay = params.layout
    L, W = lay.n_layers, lay.width
    N = x.shape[0]
    xf, df = x.to(torch.float32), d.to(torch.float32)
    u = _unpacked(params)
    if acts is None:
        hs, cs = _trunk(xf, u, lay.alphas, True)
    else:
        a = acts[:N].to(torch.float32)
        hs = [a[:, i * W:(i + 1) * W] for i in range(L)]
        cs = [a[:, (L + i) * W:(L + i + 1) * W] for i in range(L)]
    hd = _heads(hs[-1], df, u)
    h = hs[-1]
    dout = dout.to(torch.float32)

    hc = head_cotangents(hd, dout, u)
    drgb, drgb_b, dyr = hc["drgb"], hc["drgb_b"], hc["dyr"]
    dsig, dsig_b, dys = hc["dsig"], hc["dsig_b"], hc["dys"]
    dyr_b = _bf16(dyr)
    dfeat = dyr_b @ u["wr0f"].t()
    dfeat_b = _bf16(dfeat)
    dys_b = _bf16(dys)
    heads_w = [h.t() @ dys_b, hd["s_s"].t() @ dsig_b, h.t() @ dfeat_b,
               hd["feat"].t() @ dyr_b, df.t() @ dyr_b, hd["s_r"].t() @ drgb_b]
    heads_b = [dys.sum(0), dsig.sum(0), dfeat.sum(0), dyr.sum(0),
               drgb.sum(0)]

    dh = dfeat_b @ u["wf"].t() + dys_b @ u["ws0"].t()
    g_trunk, b_trunk = [None] * L, [None] * L
    for i in range(L - 1, -1, -1):
        dy = dh * cs[i]
        dy_b = _bf16(dy)
        b_trunk[i] = dy.sum(0)
        g_trunk[i] = (xf if i == 0 else hs[i - 1]).t() @ dy_b
        if i > 0:
            dh = dy_b @ u["t"][i].t()
    dw = torch.cat([g.reshape(-1) for g in g_trunk + heads_w])
    db = torch.cat(b_trunk + heads_b)
    return _bf16(dw), db


def head_cotangents(hd, dout, u):
    """The heads' cotangents from _heads' intermediates hd and the output
    cotangent dout [N, 4], as the TPU kernels' _bwd_grads_siren: drgb =
    dout_rgb r (1 - r), dyr = (bf16(drgb) w_r1^T) cos(yr); dsig = dout_sigma
    where sigma_pre > 0, dys = (bf16(dsig) w_s1^T) cos(ys); f32 throughout,
    cos the polynomial of fastmath.py. Returns a dict of drgb, drgb_b, dyr,
    dsig, dsig_b, dys (the _b ones bf16-rounded)."""
    rgb = hd["rgb"]
    drgb = dout[:, :3] * rgb * (1.0 - rgb)
    drgb_b = _bf16(drgb)
    dyr = (drgb_b @ u["wr1"].t()) * sincos_fast(hd["yr"], False, True)[1]
    dsig = torch.where(hd["sigma_pre"] > 0.0, dout[:, 3:4], 0.0)
    dsig_b = _bf16(dsig)
    dys = (dsig_b @ u["ws1"].t()) * sincos_fast(hd["ys"], False, True)[1]
    return dict(drgb=drgb, drgb_b=drgb_b, dyr=dyr, dsig=dsig, dsig_b=dsig_b,
                dys=dys)


def _check_inputs(name, x, d, extra=()):
    N = x.shape[0]
    for nm, a, shape, dt in (("x", x, (N, D_IN_PAD), torch.bfloat16),
                             ("d", d, (N, D_IN_PAD), torch.bfloat16)
                             ) + tuple(extra):
        if tuple(a.shape) != shape or a.dtype != dt:
            raise ValueError(f"{name}: {nm} wants {dt} {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")


def _check_device(name, tensors):
    dev = tensors[0].device
    for a in tensors:
        if a.device != dev or not a.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on one device")


def siren_mlp_fwd(x, d, params: SirenParams, save_acts: bool = False):
    """The SIREN forward: csrc/siren.cu for CUDA tensors,
    siren_mlp_fwd_reference for CPU tensors. On the card acts has
    round_up(N, 128) rows (the kernel's row tile). Counts its kernel
    launches in `siren_mlp_fwd.launches`.

    On the card every route is a hand-written kernel, chosen by the packed
    width in csrc/siren.cu fsnerf_siren_fwd: widths 64, 128, 192 and 256
    run the warp-specialized wgmma + TMA forward (siren_fwd_ws_kernel), 384
    and 512 the same kernel on the column-split trunk (64-row CTAs), the
    streamed widths its streamed instance (siren_fwd_kernel_stream: persistent
    64-row CTAs, each layer through their slots of render.py::
    stream_scratch's scratch, allocated per call), 288 and 320 (no
    packer's width) the mma.sync one (siren_fwd_kernel); another width
    raises ValueError (siren_kernel_error); all write the same acts
    layout.

    Without acts the call runs as the registered op
    `torch.ops.fsnerf_torch.siren_mlp_fwd`, so a program that torch.export
    traces through it keeps the call (the serving artifact,
    utils/export.py); with acts (the train step's forward) it launches
    directly."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"siren_mlp_fwd runs on cpu or cuda, not {x.device}")
    if not save_acts:
        lay = params.layout
        return torch.ops.fsnerf_torch.siren_mlp_fwd(
            x, d, params.wpack, params.bpack, params.alphas, lay.n_layers,
            lay.width), None
    if x.device.type == "cpu":
        return siren_mlp_fwd_reference(x, d, params, save_acts)
    return _siren_fwd_launch(x, d, params.wpack, params.bpack,
                             params.alphas, params.layout, save_acts)


siren_mlp_fwd.launches = 0


def _siren_fwd_launch(x, d, wpack, bpack, alphas, lay: SirenLayout,
                      save_acts: bool):
    """One launch of csrc/siren.cu's forward on CUDA tensors: (out, acts
    or None)."""
    _check_cuda_fwd(x, d, wpack, bpack, alphas, lay.width, lay.n_layers)
    from .build import load_library

    lib = load_library()
    N = x.shape[0]
    out = torch.empty((N, 4), dtype=torch.float32, device=x.device)
    acts = (torch.empty((_round_up(N, ROWS), 2 * lay.n_layers * lay.width),
                        dtype=torch.bfloat16, device=x.device)
            if save_acts else None)
    slab, ctas = stream_scratch(lay.width, x.device)
    err = lib.fsnerf_siren_fwd(
        x.data_ptr(), d.data_ptr(), wpack.data_ptr(), bpack.data_ptr(),
        alphas.data_ptr(), out.data_ptr(), _ptr(acts), _ptr(slab), ctas, N,
        lay.n_layers, lay.width,
        torch.cuda.current_stream(x.device).cuda_stream)
    _launch_error(lib, err, "siren_mlp_fwd")
    siren_mlp_fwd.launches += 1
    return out, acts


def _check_cuda_fwd(x, d, wpack, bpack, alphas, width: int, n_layers: int):
    """The forward launch's checks: inputs, one device, a packed width its
    kernels take."""
    _check_inputs("siren_mlp_fwd", x, d)
    _check_device("siren_mlp_fwd", [x, d, wpack, bpack, alphas])
    err = siren_kernel_error(width, "forward", n_layers)
    if err is not None:
        raise ValueError(f"siren_mlp_fwd: {err}")


@torch.library.custom_op("fsnerf_torch::siren_mlp_fwd", mutates_args=(),
                         device_types="cpu")
def _siren_fwd_op(x: torch.Tensor, d: torch.Tensor, wpack: torch.Tensor,
                  bpack: torch.Tensor, alphas: torch.Tensor, n_layers: int,
                  width: int) -> torch.Tensor:
    """CPU tensors: the plain version without acts."""
    if alphas.shape != (n_layers,):
        raise ValueError(f"siren_mlp_fwd: {tuple(alphas.shape)} alphas for "
                         f"{n_layers} layers")
    lay = SirenLayout(n_layers, width, tuple(alphas.tolist()))
    return siren_mlp_fwd_reference(
        x, d, SirenParams(wpack, bpack, None, alphas, lay))[0]


@_siren_fwd_op.register_kernel("cuda")
def _siren_fwd_cuda(x, d, wpack, bpack, alphas, n_layers, width):
    """CUDA tensors: one launch of the forward without acts."""
    lay = SirenLayout(n_layers, width, ())
    return _siren_fwd_launch(x, d, wpack, bpack, alphas, lay, False)[0]


@_siren_fwd_op.register_fake
def _siren_fwd_fake(x, d, wpack, bpack, alphas, n_layers, width):
    """The output's shape, after the launch's checks."""
    _check_inputs("siren_mlp_fwd", x, d)
    if x.device.type == "cuda":
        _check_cuda_fwd(x, d, wpack, bpack, alphas, width, n_layers)
    lay = SirenLayout(n_layers, width, ())
    if wpack.numel() != lay.n_w or bpack.numel() != lay.n_b \
            or alphas.shape != (n_layers,):
        raise ValueError(f"siren_mlp_fwd: weights do not match a SiNeRF of "
                         f"{n_layers} layers of width {width}")
    return x.new_empty((x.shape[0], 4), dtype=torch.float32)


def dw_jobs(lay: SirenLayout):
    """The weight-gradient products, one per packed matrix in wpack order:
    (x_src 0 = acts / 1 = xs, x_col, k_in, y_col, n_out, w_off) over the
    backward's scratch layouts (csrc/siren.cu SirenTrainArgs): xs = x | d |
    s_s | feat | s_r; dy = dy_0 .. dy_{L-1} | dys | dfeat | dyr | dsig (8)
    | drgb (8)."""
    L, W, Wh, P = lay.n_layers, lay.width, lay.width // 2, D_IN_PAD
    xs_ss, xs_feat, xs_sr = 2 * P, 2 * P + Wh, 2 * P + Wh + W
    dy_s, dy_f = L * W, L * W + Wh
    dy_r, dy_sig = dy_f + W, dy_f + W + Wh
    jobs, off = [], 0

    def add(x_src, x_col, k_in, y_col, n_out):
        nonlocal off
        jobs.append((x_src, x_col, k_in, y_col, n_out, off))
        off += k_in * n_out

    add(1, 0, P, 0, W)
    for i in range(1, L):
        add(0, (i - 1) * W, W, i * W, W)
    add(0, (L - 1) * W, W, dy_s, Wh)
    add(1, xs_ss, Wh, dy_sig, 1)
    add(0, (L - 1) * W, W, dy_f, W)
    add(1, xs_feat, W, dy_r, Wh)
    add(1, P, P, dy_r, Wh)
    add(1, xs_sr, Wh, dy_sig + 8, 3)
    assert off == lay.n_w
    return jobs


def siren_mlp_bwd(x, d, dout, params: SirenParams, acts=None,
                  operands: Optional[dict] = None):
    """The SIREN backward: csrc/siren.cu for CUDA tensors,
    siren_mlp_bwd_reference for CPU tensors; same arguments and returns
    (params need wtpack). acts None recomputes the trunk. On the card a
    dict `operands` receives the row pass's xs and dy scratch (layouts of
    dw_jobs, n_pad rows; scripts/grad_arbiter.py reads them). Counts its
    launches in `siren_mlp_bwd.launches`.

    On the card the row pass has three routes, each a hand-written
    kernel, chosen in csrc/siren.cu fsnerf_siren_bwd: saved mode at the
    packed widths 64, 128, 192 and 256 (the main path's; at a depth whose
    bias partials fit in its shared memory) runs the warp-specialized
    wgmma + TMA row pass (siren_bwd_rows_ws_kernel), at 384 and 512 the
    same kernel on 64-row CTAs, each cotangent product split by output
    columns, at the streamed widths the streamed row pass
    (siren_bwd_rows_kernel_stream, kernel 6's streamed shape on 64-row
    CTAs); recompute mode, which is not on the main path, holds its factors
    in f32 by design up to 256 and runs the mma.sync row pass
    (siren_bwd_rows_kernel); from 384 up, where that pass does not fit, it
    runs the forward kernel into an acts stream it allocates (not counted
    in `siren_mlp_fwd.launches`) and then the saved mode's row pass, so
    there its factors are bf16 and its gradients equal the saved mode's.
    The dW pass and the reduce are the same for both. Another packed width
    raises ValueError (siren_kernel_error)."""
    if x.device.type == "cpu":
        return siren_mlp_bwd_reference(x, d, dout, params, acts)
    if x.device.type != "cuda":
        raise ValueError(f"siren_mlp_bwd runs on cpu or cuda, not {x.device}")
    lay = params.layout
    L, W, Wh = lay.n_layers, lay.width, lay.width // 2
    N = x.shape[0]
    n_pad = _round_up(N, ROWS)
    _check_inputs("siren_mlp_bwd", x, d,
                  (("dout", dout, (N, 4), torch.float32),))
    if params.wtpack is None:
        raise ValueError("siren_mlp_bwd needs params packed "
                         "with_transposed=True")
    err = siren_kernel_error(W, "backward", L)
    if err is not None:
        raise ValueError(f"siren_mlp_bwd: {err}")
    _check_device("siren_mlp_bwd", [x, d, dout, params.wpack, params.bpack,
                                    params.wtpack, params.alphas])
    recompute = acts is None
    # from 384 up recompute mode runs the forward kernel, then saved mode
    wide = W in SPLIT_WIDTHS or stream_width(W)
    dev = x.device
    lda = L * W if recompute and not wide else 2 * L * W
    cfs = fwd_out = slab = None
    ctas = 0
    if recompute:
        acts = torch.empty((n_pad, lda), dtype=torch.bfloat16, device=dev)
        if wide:
            fwd_out = torch.empty((N, 4), dtype=torch.float32, device=dev)
            slab, ctas = stream_scratch(W, dev)
        else:
            cfs = torch.empty((n_pad, L * W), dtype=torch.float32,
                              device=dev)
    else:
        if (tuple(acts.shape) != (n_pad, lda)
                or acts.dtype != torch.bfloat16 or acts.device != dev
                or not acts.is_contiguous()):
            raise ValueError("siren_mlp_bwd: acts must be the forward "
                             f"kernel's [{n_pad}, {lda}] bf16 stream")
    from .build import load_library

    lib = load_library()
    xs = torch.empty((n_pad, 2 * D_IN_PAD + 2 * W), dtype=torch.bfloat16,
                     device=dev)
    dy = torch.empty((n_pad, L * W + 2 * W + 16), dtype=torch.bfloat16,
                     device=dev)
    pbias = torch.empty((n_pad // bwd_rows(W), lay.n_b), dtype=torch.float32,
                        device=dev)
    jobs, tiles = dw_plan(tuple(dw_jobs(lay)), str(dev))
    part = torch.empty((-(-n_pad // SPLIT_ROWS), lay.n_w),
                       dtype=torch.float32, device=dev)
    dw = torch.empty(lay.n_w, dtype=torch.float32, device=dev)
    db = torch.empty(lay.n_b, dtype=torch.float32, device=dev)
    err = lib.fsnerf_siren_bwd(
        x.data_ptr(), d.data_ptr(), dout.data_ptr(), params.wpack.data_ptr(),
        params.bpack.data_ptr(), params.wtpack.data_ptr(),
        params.alphas.data_ptr(), acts.data_ptr(), lda, _ptr(cfs),
        _ptr(fwd_out), _ptr(slab), ctas, xs.data_ptr(),
        dy.data_ptr(), pbias.data_ptr(), jobs.data_ptr(), tiles.data_ptr(),
        tiles.shape[0], part.data_ptr(), SPLIT_ROWS, dw.data_ptr(),
        db.data_ptr(), N, L, W, torch.cuda.current_stream(dev).cuda_stream)
    _launch_error(lib, err, "siren_mlp_bwd")
    siren_mlp_bwd.launches += 1
    if operands is not None:
        operands.update(xs=xs, dy=dy)
    return dw, db


siren_mlp_bwd.launches = 0


class FusedSirenMLP(torch.autograd.Function):
    """out [N, 4] = the SiNeRF MLP of the packed `weights` (the module's
    parameters in SirenLayout.param_names order) at x, d [N, 16] bf16; the
    backward runs siren_mlp_bwd and returns gradients for the weights
    only. A call whose weights need no gradient saves no activations."""

    @staticmethod
    def forward(ctx, layout: SirenLayout, save_acts: bool, x, d, *weights):
        params = prep_siren_params(dict(zip(layout.param_names, weights)),
                                   layout.n_layers, layout.alphas,
                                   with_transposed=True)
        save = save_acts and any(ctx.needs_input_grad[4:])
        out, acts = siren_mlp_fwd(x, d, params, save)
        ctx.params, ctx.acts = params, acts
        ctx.save_for_backward(x, d)
        return out

    @staticmethod
    def backward(ctx, dout):
        x, d = ctx.saved_tensors
        params, acts = ctx.params, ctx.acts
        ctx.params = ctx.acts = None
        dw, db = siren_mlp_bwd(x, d, dout.contiguous(), params, acts)
        return (None, None, None, None,
                *params.layout.grads_from_packed(dw, db))


def make_fused_siren_model_fn(cfg, save_acts: Optional[bool] = None):
    """The trainable model_fn of the train step for SiNeRF: apply_fn(model,
    x, dirs, pos_mask=None, dir_mask=None) -> [..., 4] whose gradient with
    respect to the module's parameters runs through the SIREN kernels. The
    FreeNeRF masks are accepted and ignored (SiNeRF reads raw coordinates).

    save_acts: None resolves from cfg.model.siren_save_acts."""
    layout = SirenLayout.from_config(cfg)
    if save_acts is None:
        save_acts = bool(cfg.model.siren_save_acts)

    def apply_fn(model, x, dirs, pos_mask=None, dir_mask=None):
        names, weights = zip(*model.named_parameters())
        if names != layout.param_names:
            raise ValueError(f"model parameters {names} do not match the "
                             f"SIREN kernels' layout {layout.param_names}")
        shape = x.shape[:-1]
        out = FusedSirenMLP.apply(layout, save_acts,
                                  pad_inputs(x.reshape(-1, 3)),
                                  pad_inputs(dirs.reshape(-1, 3)), *weights)
        return out.reshape(*shape, 4)

    return apply_fn


def make_siren_forward_fn(state_dict: Dict[str, torch.Tensor],
                          n_layers: int = 8, alphas=None, device=None):
    """model_fn(x [..., 3], dirs [..., 3]) -> [..., 4] on the SIREN forward
    kernel with the weights packed once (the eval-time counterpart of the
    JAX package's primal fused SIREN call). It needs dirs."""
    params = prep_siren_params(state_dict, n_layers, alphas, device=device)

    def model_fn(x, dirs):
        shape = x.shape[:-1]
        out, _ = siren_mlp_fwd(pad_inputs(x.reshape(-1, 3)),
                               pad_inputs(dirs.reshape(-1, 3)), params)
        return out.reshape(*shape, 4)

    return model_fn
