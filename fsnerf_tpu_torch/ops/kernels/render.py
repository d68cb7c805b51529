"""Fused ray-march render: the CUDA kernels' wrappers, their plain PyTorch
versions and the renderers built on them (port of
fsnerf_tpu/ops/pallas/render.py::make_fused_ray_renderer and
::make_fused_siren_ray_renderer).

Per block of `block_rows` rays and chunk of `chunk_s` samples: skip the
chunk unless some ray of the block is still below the transmittance cutoff
(accumulated od < -log eps) and some sample of the chunk is valid;
otherwise positionally encode the chunk (polynomial sin, reference layout),
run the NeRF MLP (bf16 operands, f32 accumulation, bf16-rounded biases added
in f32, activations rounded to bf16) and composite in exp/cumsum form with
the optical depth carried across chunks. Outputs [R, 8] = rgb, opacity,
depth, trans_final, 0, 0; the background is blended by the caller.

`ray_march` launches csrc/render.cu for CUDA tensors (the NeRF march on
the warp-specialized MLP of csrc/ws_trunk.cuh, which is built for the
widths NERF_KERNEL_WIDTHS and the streamed widths) and runs
`ray_march_reference` only for CPU tensors. The two share one signature,
one weight packing and one skip rule, and both return the per-block count of
executed chunk steps so a run on the card can compare them.

Every packer lays the weights out at the packed width: a NeRF or SiNeRF
module's width W pads to the next of the fixed widths KERNEL_WIDTHS +
SPLIT_WIDTHS, or above 512 to the next streamed width, a multiple of 256
from 768 up (`kernel_width`, also named `nerf_kernel_width`; a NeRF of
width 193-256 whose direction encoding is wider than
KERNEL_MAX_DIR_AT_256 packs at 384), with zero columns (and zero biases),
the next matrix reading them through zero rows, so the padded units'
activations are exactly 0 (ReLU(0) = 0, sin(a 0) = 0) and the real
outputs gain only exact zero products; the plain versions run the padded
pack as the kernels do. The NeRF and SIREN kernels take every packed
width whose packed weights int32 offsets can address (MAX_PACKED_WEIGHTS;
siren.py::siren_kernel_error for the SIREN's).

The early exit's blocking is the same at every width: from the packed
width 384 up the kernel runs each block x chunk step (up to 128 rows) as
two 64-row halves on one consumer warpgroup, but decides the skip once per
step, over all its rays and samples, as the other widths and the TPU
kernel do; so ray_march_reference's block x chunk loop is the kernel's at
every width. At the streamed widths (768 and every multiple of 256 above)
each layer's output goes through a scratch in device memory and back (the
streamed trunk); its bf16 values are the ones the other widths keep in
shared memory, so the plain version needs no change there either.

The SiNeRF march (`siren_ray_march`, `siren_ray_march_reference`) is the
same shell with the SIREN MLP of siren.py on the raw points and directions
(bf16, no encoding) in place of the encoding and the NeRF MLP; from 384
up it runs the same 64-row halves with the same per-step skip decision,
and at the streamed widths through the same streamed trunk.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Dict, Optional, Sequence, Tuple

import torch

from ...core.encoding import encoded_dim, frequencies
from .fastmath import sincos_fast

_DENSITY_ACT = {"none": 0, "relu": 1, "trunc_exp": 2}
# the kernel's GEMM tile: block_rows * chunk_s rows per chunk step
KERNEL_ROWS = 128
# the widths the warp-specialized kernels (csrc/ws_trunk.cuh: the NeRF ray
# march, forward MLP, density pass and train forward, the SIREN forward,
# march and saved-mode backward) are built for with whole-row consumers,
# and their widest encoding
KERNEL_WIDTHS = (64, 128, 192, 256)
KERNEL_MAX_ENC = 256
# ... at width 256, the widest direction encoding: a 2-stage ring beside
# 6 encoding blocks fills a shell's shared memory (shell_smem_bytes), and
# kernel 6's row pass stages the direction encoding (mlp_train.py::
# bwd_rows_smem_bytes)
KERNEL_MAX_DIR_AT_256 = 128
# the fixed widths every packer lays out (kernel_width) and the NeRF and
# SIREN kernels take beside the streamed ones: KERNEL_WIDTHS and, on the
# column-split trunk (one 64-row consumer, each layer as two column halves;
# the backward row passes of kernels 6 and 8 on 64-row CTAs), 384 and 512.
# There both encodings reach KERNEL_MAX_ENC: the shells fit a 2-stage ring
# beside 8 encoding blocks at 512 (shell_smem_bytes(512, 256, 256) =
# 230,448 bytes), the 64-row pass a 256-wide direction encoding
# (bwd_rows_smem_bytes(512, 256) = 227,072). Above 512 the input and
# output activation tiles of one 64-row warpgroup (192 KB at 768) leave no
# room for the weight ring.
SPLIT_WIDTHS = (384, 512)
NERF_KERNEL_WIDTHS = KERNEL_WIDTHS + SPLIT_WIDTHS
# ... and above them the streamed trunk (csrc/ws_trunk.cuh: one 64-row
# consumer, each layer in 256-column chunks stored to device memory and
# read back as the next layer's operand; the row passes of kernels 6 and 8
# stream their operands too) for the NeRF kernels 1 and 3-6 and the SIREN
# kernels 2, 7 and 8: one instance each, W at run time, at every multiple
# of STREAM_STEP from STREAM_MIN_WIDTH up (the branch's N = W / 2 runs in
# 128-column chunks). Their shared memory does not grow with the width:
# with both encodings 256 wide a 3-stage ring fits (shell_smem_bytes(W,
# 256, 256, 3) = 230,496 bytes), the row pass takes 99,072 whatever the
# encodings. The scratch each persistent CTA streams its layers through
# (64 rows x 2 W bf16) stays in the 50 MB L2 cache up to 1024 (34.6 MB on
# 132 SMs); wider, it does not (69 MB at 2048), which costs time, not
# correctness.
STREAM_MIN_WIDTH = 768
STREAM_STEP = 256
# The packed weights are addressed by int32 element offsets (the weight-
# gradient pass's job table and the C entries' n_w), so their element
# count (wpack's numel, TrainLayout.n_w, SirenLayout.n_w) must stay below
# 2^31: that is what bounds a streamed width (W_max, ~(L + 1/2) W^2
# elements for a NeRF of L layers: 15,872 at 8 layers, skip 4, n_freqs
# 10/4; 15,360 for an 8-layer SiNeRF).
MAX_PACKED_WEIGHTS = 2**31 - 1
SMEM_LIMIT = 227 * 1024          # an H100 block's shared memory, bytes
STREAM_ROWS = 64                 # a streamed CTA's rows (its scratch slot)


def stream_width(width: int) -> bool:
    """Whether a packed width runs on the streamed trunk (csrc/ws_trunk.cuh
    stream_width): a multiple of STREAM_STEP from STREAM_MIN_WIDTH up."""
    return width >= STREAM_MIN_WIDTH and width % STREAM_STEP == 0


def widest_stream_width(n_w_at) -> int:
    """W_max of an architecture: the widest streamed width W whose packed
    weights n_w_at(W) (an element count, increasing in W) stay within
    MAX_PACKED_WEIGHTS."""
    lo, hi = STREAM_MIN_WIDTH // STREAM_STEP, 2 ** 16 // STREAM_STEP
    while lo < hi:                  # the largest k with n_w_at(k step) fits
        mid = (lo + hi + 1) // 2
        if n_w_at(mid * STREAM_STEP) <= MAX_PACKED_WEIGHTS:
            lo = mid
        else:
            hi = mid - 1
    return lo * STREAM_STEP


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def kernel_width(width: int, d_dir_pad: int = 0) -> int:
    """The width the NeRF and SiNeRF packers lay a module of `width` out
    at: the smallest of NERF_KERNEL_WIDTHS that holds it, else the next
    streamed width (a multiple of STREAM_STEP, at least STREAM_MIN_WIDTH).
    A NeRF's padded direction encoding `d_dir_pad` wider than
    KERNEL_MAX_DIR_AT_256 does not fit the shells' shared memory at 256, so
    such a module of 193-256 units packs at 384 (the SiNeRF has no
    direction encoding: 0)."""
    for w in NERF_KERNEL_WIDTHS:
        if width <= w and not (w == 256
                               and d_dir_pad > KERNEL_MAX_DIR_AT_256):
            return w
    return max(STREAM_MIN_WIDTH, _round_up(width, STREAM_STEP))


nerf_kernel_width = kernel_width       # the NeRF packers' name for it


def shell_smem_bytes(width: int, d_enc_pad: int, d_dir_pad: int,
                     n_stages: int = 2) -> int:
    """Shared memory of a warp-specialized NeRF shell with a ring of
    n_stages (csrc/ws_trunk.cuh fwd_smem_bytes, plus the largest shell's
    16 extra bytes): two consumers' tiles of 64 x width, or above 256 the
    column-split trunk's one consumer, stages of 64 x width / 2 and three
    activation tiles of 64 x width / 2, or at a streamed width the streamed
    trunk's (ws_trunk.cuh stream_smem_bytes): stages of 64 x 256, the A
    ring's four 64 x 64 tiles and one 64 x 256 output tile, whatever the
    width."""
    blocks = -(-d_enc_pad // 64) + -(-d_dir_pad // 64)
    if stream_width(width):
        return (1024 + n_stages * 256 * 128 + (4 + 4 + blocks) * 64 * 64 * 2
                + (2 * n_stages + 4) * 8 + 16)
    if width > KERNEL_WIDTHS[-1]:
        return (1024 + (n_stages + 3) * width // 2 * 128
                + blocks * 64 * 64 * 2 + 2 * n_stages * 8 + 16)
    return (1024 + (n_stages + 2) * width * 128 + 2 * blocks * 64 * 64 * 2
            + 2 * n_stages * 8 + 16)


def kernel_arch_error(width: int, d_enc_pad: int, d_dir_pad: int = 0,
                      what: str = "kernels",
                      n_w: int = 0) -> Optional[str]:
    """Why the warp-specialized NeRF kernels (`what`) refuse a packed
    width (nerf_kernel_width's), padded encoding widths and n_w packed
    weights, or None if they take them."""
    max_dir = KERNEL_MAX_DIR_AT_256 if width == 256 else KERNEL_MAX_ENC
    if ((width in NERF_KERNEL_WIDTHS or stream_width(width))
            and d_enc_pad <= KERNEL_MAX_ENC
            and d_dir_pad <= max_dir and n_w <= MAX_PACKED_WEIGHTS):
        return None
    if n_w > MAX_PACKED_WEIGHTS:
        return (f"the {what} take packed weights of up to "
                f"{MAX_PACKED_WEIGHTS} elements (int32 offsets address "
                f"them), not {n_w} at width {width}: widths up to the one "
                f"whose weights fit (W_max; 15,872 at 8 layers, skip 4, "
                f"n_freqs 10/4)")
    return (f"the {what} take widths up to W_max (laid out at "
            f"{NERF_KERNEL_WIDTHS} and above at multiples of "
            f"{STREAM_STEP} from {STREAM_MIN_WIDTH}) and encodings up to "
            f"{KERNEL_MAX_ENC} wide (at width 256 a direction encoding up "
            f"to {KERNEL_MAX_DIR_AT_256}: shared memory), not width "
            f"{width} with encodings {d_enc_pad} / {d_dir_pad}")


def march_chunk_error(width: int, block_rows: int,
                      chunk_s: int) -> Optional[str]:
    """Why the NeRF or SIREN march refuses a blocking at a packed width,
    or None: at most KERNEL_ROWS rows a chunk step, and at the split and
    streamed widths (run as 64-row halves, each holding whole rays) a
    chunk_s that divides 64 when the step has more than 64 rows."""
    if block_rows * chunk_s > KERNEL_ROWS:
        return f"block_rows * chunk_s must be <= {KERNEL_ROWS}"
    if (width > KERNEL_WIDTHS[-1] and block_rows * chunk_s > 64
            and 64 % chunk_s):
        return (f"at width {width} a chunk step of more than 64 rows runs "
                f"as 64-row halves of whole rays: chunk_s must divide 64, "
                f"not {chunk_s}")
    return None


def trunk_rows(n_layers: int, skip: Tuple[int, ...], width: int,
               d_enc_pad: int) -> int:
    """Rows of wpack's [rows, width] view that the warp-specialized kernels'
    tensor maps read (csrc/ws_trunk.cuh): the trunk matrices, w_sigma and
    w_conn, in pack_weights' walk."""
    return d_enc_pad + sum(width + (d_enc_pad if (i - 1) in skip else 0)
                           for i in range(1, n_layers)) + 1 + width


def stream_scratch(width: int, device):
    """(scratch, ctas) for a kernel launch at a packed width: at a streamed
    width the streamed trunk's [ctas * STREAM_ROWS, 2 width] bf16 scratch,
    one slot per persistent CTA, ctas the card's SM count; else (None,
    0)."""
    if not stream_width(width):
        return None, 0
    ctas = torch.cuda.get_device_properties(device).multi_processor_count
    return torch.empty((ctas * STREAM_ROWS, 2 * width), dtype=torch.bfloat16,
                       device=device), ctas


def _ptr(t: Optional[torch.Tensor]):
    """A tensor's device pointer for ctypes, None for no tensor."""
    return None if t is None else t.data_ptr()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


@dataclass(frozen=True)
class RayMarchParams:
    """NeRF weights packed for the ray march.

    wpack (bf16, flat) holds [in, out] row-major matrices in the order the
    kernel walks them: per trunk layer i, W0 [d_enc_pad, W] for i = 0, the
    pair W_h [W, W], W_e [d_enc_pad, W] for a layer fed by a skip concat,
    else W_i [W, W]; then w_sigma [W], w_conn [W, W], w_branch_h [W, W/2],
    w_branch_d [d_dir_pad, W/2], w_rgb [W/2, 3]. Encoding rows are
    zero-padded. bpack (float32 holding bf16-rounded values): b_0..b_{n-1}
    [W], b_sigma [1], b_conn [W], b_branch [W/2], b_rgb [3]. enc: [2F+2Fv]
    = freq_x, mask_x, freq_d, mask_d.
    """

    wpack: torch.Tensor
    bpack: torch.Tensor
    enc: torch.Tensor
    n_layers: int
    skip: Tuple[int, ...]
    width: int              # the packed (kernel) width
    n_freqs: int
    n_freqs_views: int
    d_enc_pad: int
    d_dir_pad: int
    density_activation: str = "none"
    model_width: Optional[int] = None      # the module's (None: width)

    @property
    def skip_mask(self) -> int:
        """Bit i set: trunk layer i takes the skip concat [h, enc]."""
        return sum(1 << i for i in range(1, self.n_layers)
                   if (i - 1) in self.skip)

    def to(self, device) -> "RayMarchParams":
        return replace(self, wpack=self.wpack.to(device),
                       bpack=self.bpack.to(device), enc=self.enc.to(device))


def padded(m: torch.Tensor, *shape: int) -> torch.Tensor:
    """m zero-padded at the end of each dimension to `shape`."""
    pads = []
    for size, want in zip(reversed(m.shape), reversed(shape)):
        pads += [0, want - size]
    return torch.nn.functional.pad(m, pads)


def pack_weights(sd: Dict[str, torch.Tensor], n_layers: int,
                 skip: Tuple[int, ...], d_enc_pad: int, d_dir_pad: int,
                 width: Optional[int] = None):
    """(wpack bf16, bpack float32 holding bf16-rounded values) of a
    reference-keyed NeRF state dict in the walk order of RayMarchParams at
    `width` (default nerf_kernel_width of the module's and d_dir_pad), on
    the state dict's device: the trunk's, the connection's and the
    branch's units past the module's are zero columns with zero biases,
    read by zero rows."""
    W = sd["layers.0.weight"].shape[0]
    K = nerf_kernel_width(W, d_dir_pad) if width is None else width
    Kh = K // 2

    mats, biases = [], []
    for i in range(n_layers):
        w = sd[f"layers.{i}.weight"]                      # [W, in]
        if i == 0:
            mats.append(padded(w.t(), d_enc_pad, K))
        elif (i - 1) in skip:
            mats += [padded(w[:, :W].t(), K, K),
                     padded(w[:, W:].t(), d_enc_pad, K)]
        else:
            mats.append(padded(w.t(), K, K))
        biases.append(padded(sd[f"layers.{i}.bias"], K))
    wb = sd["branch.weight"]
    mats += [padded(sd["sigma.weight"].reshape(-1), K),
             padded(sd["connection.weight"].t(), K, K),
             padded(wb[:, :W].t(), K, Kh),
             padded(wb[:, W:].t(), d_dir_pad, Kh),
             padded(sd["rgb.weight"].t(), Kh, 3)]
    biases += [sd["sigma.bias"], padded(sd["connection.bias"], K),
               padded(sd["branch.bias"], Kh), sd["rgb.bias"]]
    wpack = torch.cat([m.reshape(-1) for m in mats]).to(torch.bfloat16)
    bpack = _bf16(torch.cat([b.reshape(-1) for b in biases]))
    return wpack.contiguous(), bpack.contiguous()


def enc_table(n_freqs: int, n_freqs_views: int, log_space: bool = True,
              pos_mask=None, dir_mask=None, device=None) -> torch.Tensor:
    """[2F + 2Fv] float32: freq_x, mask_x, freq_d, mask_d (ones where no
    FreeNeRF mask is given)."""
    def band_mask(m, n):
        return (torch.ones(n, device=device) if m is None
                else torch.as_tensor(m, dtype=torch.float32).to(device))

    return torch.cat([frequencies(n_freqs, log_space, device),
                      band_mask(pos_mask, n_freqs),
                      frequencies(n_freqs_views, log_space, device),
                      band_mask(dir_mask, n_freqs_views)]).contiguous()


def prep_params(
    state_dict: Dict[str, torch.Tensor],
    n_layers: int = 8,
    skip: Sequence[int] = (4,),
    n_freqs: int = 10,
    n_freqs_views: int = 4,
    log_space: bool = True,
    density_activation: str = "none",
    pos_mask: Optional[torch.Tensor] = None,
    dir_mask: Optional[torch.Tensor] = None,
    device=None,
) -> RayMarchParams:
    """Pack a reference-keyed NeRF state dict (core/models.py) for
    ray_march, at nerf_kernel_width of its width and direction encoding,
    on the state dict's own device (no host round trip), then on
    `device` when one is given."""
    skip = tuple(skip)
    if skip and max(skip) >= n_layers - 1:
        raise ValueError(
            "the ray march needs the skip concat to feed a TRUNK layer "
            f"(skip {skip} with n_layers {n_layers} would feed the heads)")
    if density_activation not in _DENSITY_ACT:
        raise ValueError(f"Unknown density activation: {density_activation}")
    sd = {k: v.detach().to(torch.float32) for k, v in state_dict.items()}
    W = sd["layers.0.weight"].shape[0]
    d_enc = encoded_dim(3, n_freqs)
    d_dir = encoded_dim(3, n_freqs_views)
    if sd["layers.0.weight"].shape[1] != d_enc or \
            sd["branch.weight"].shape[1] != W + d_dir:
        raise ValueError("state dict does not match n_freqs/n_freqs_views")
    de, dd = _round_up(d_enc, 16), _round_up(d_dir, 16)
    wpack, bpack = pack_weights(sd, n_layers, skip, de, dd)
    enc = enc_table(n_freqs, n_freqs_views, log_space, pos_mask,
                    dir_mask).to(wpack.device)
    return RayMarchParams(wpack, bpack, enc, n_layers, skip,
                          nerf_kernel_width(W, dd), n_freqs, n_freqs_views,
                          de, dd, density_activation, W).to(device)


def unpack(wflat: torch.Tensor, bflat: torch.Tensor, n_layers: int,
           skip: Tuple[int, ...], width: int, d_enc_pad: int,
           d_dir_pad: int):
    """Views of flat packed weights and biases in the kernels' walk order:
    (trunk [(W0,) | (W_h, W_e) | (W_i,)], biases [b_i], heads dict)."""
    W, Wh, de, dd = width, width // 2, d_enc_pad, d_dir_pad
    off = 0

    def take(rows, cols):
        nonlocal off
        m = wflat[off:off + rows * cols].reshape(rows, cols)
        off += rows * cols
        return m

    trunk = []
    for i in range(n_layers):
        if i == 0:
            trunk.append((take(de, W),))
        elif (i - 1) in skip:
            trunk.append((take(W, W), take(de, W)))
        else:
            trunk.append((take(W, W),))
    heads = dict(sigma=take(W, 1), conn=take(W, W), branch_h=take(W, Wh),
                 branch_d=take(dd, Wh), rgb=take(Wh, 3))
    b = bflat
    b_trunk = [b[i * W:(i + 1) * W] for i in range(n_layers)]
    o = n_layers * W
    heads.update(b_sigma=b[o:o + 1], b_conn=b[o + 1:o + 1 + W],
                 b_branch=b[o + 1 + W:o + 1 + W + Wh],
                 b_rgb=b[o + 1 + W + Wh:o + 4 + W + Wh])
    return trunk, b_trunk, heads


def _unpack(p: RayMarchParams):
    """float32 views of the packed weights, in the kernel's walk order."""
    return unpack(p.wpack.to(torch.float32), p.bpack, p.n_layers, p.skip,
                  p.width, p.d_enc_pad, p.d_dir_pad)


def encode(v: torch.Tensor, freqs: torch.Tensor, band_mask: torch.Tensor,
           d_pad: int) -> torch.Tensor:
    """[N, 3] -> [N, d_pad] bf16-rounded float32 features in the reference
    layout [v, sin f0 v, cos f0 v, ...] * band mask, zero-padded; cos is the
    polynomial sin at x + pi/2, as the TPU kernel's encoding computes it."""
    xb = v[:, None, :] * freqs[:, None]                    # [N, F, 3]
    s, _ = sincos_fast(xb)
    c, _ = sincos_fast(xb + math.pi / 2)
    feat = torch.stack([s, c], dim=-2) * band_mask[:, None, None]
    out = torch.zeros(v.shape[0], d_pad, device=v.device)
    n = 3 + feat.shape[1] * 6
    out[:, :n] = torch.cat([v, feat.reshape(v.shape[0], -1)], dim=-1)
    return _bf16(out)


def trunk_forward(ex, trunk, b_trunk):
    """Trunk activations [h_0 .. h_{L-1}] (bf16-rounded float32) from the
    encoded points, as matmuls of bf16-rounded operands."""
    hs, h = [], None
    for i, ws in enumerate(trunk):
        if i == 0:
            y = ex @ ws[0]
        elif len(ws) == 2:
            y = h @ ws[0] + ex @ ws[1]
        else:
            y = h @ ws[0]
        h = _bf16(torch.relu(y + b_trunk[i]))
        hs.append(h)
    return hs


def heads_forward(h, ed, hd):
    """(feat, br, rgb): feat bf16 without activation, br ReLU then bf16,
    rgb an f32 sigmoid."""
    feat = _bf16(h @ hd["conn"] + hd["b_conn"])
    br = _bf16(torch.relu(feat @ hd["branch_h"] + ed @ hd["branch_d"]
                          + hd["b_branch"]))
    return feat, br, torch.sigmoid(br @ hd["rgb"] + hd["b_rgb"])


def sigma_head(h, hd, density_activation: str):
    """sigma [N] of the last trunk activations: an f32 dot plus the
    bf16-rounded bias, raw, ReLU or exp(clip(., -15, 15))."""
    sigma = (h @ hd["sigma"])[:, 0] + hd["b_sigma"]
    if density_activation == "relu":
        sigma = torch.relu(sigma)
    elif density_activation == "trunc_exp":
        sigma = torch.exp(torch.clamp(sigma, -15.0, 15.0))
    return sigma


def mlp_forward(ex, ed, density_activation: str, unpacked):
    """(rgb [N, 3], sigma [N]) of the encoded rows as f32 matmuls of
    bf16-rounded operands; unpacked as unpack() returns it."""
    trunk, b_trunk, hd = unpacked
    h = trunk_forward(ex, trunk, b_trunk)[-1]
    return (heads_forward(h, ed, hd)[2],
            sigma_head(h, hd, density_activation))


def _check(x, dirs, t, deltas, mask, block_rows, chunk_s):
    R, K, _ = x.shape
    if R % block_rows or K % chunk_s:
        raise ValueError(f"rays {R} / samples {K} must be multiples of "
                         f"block_rows {block_rows} / chunk_s {chunk_s}")
    for name, a, shape in (("x", x, (R, K, 3)), ("dirs", dirs, (R, 3)),
                           ("t", t, (R, K)), ("deltas", deltas, (R, K)),
                           ("mask", mask, (R, K))):
        if tuple(a.shape) != shape or a.dtype != torch.float32:
            raise ValueError(f"{name}: want float32 {shape}, got "
                             f"{a.dtype} {tuple(a.shape)}")


def _march(x, dirs, t, deltas, mask, block_rows: int, chunk_s: int,
           early_stop_eps: float, mlp_rows):
    """The block x chunk loop both ray marches share: per block of
    `block_rows` rays and chunk of `chunk_s` samples, skip unless a ray of
    the block is below the transmittance cutoff and a sample of the chunk
    is valid; else mlp_rows(idx, sl) -> (rgb [n * chunk_s, 3], sigma
    [n * chunk_s]) for rays idx over samples sl, then exp/cumsum
    compositing with the optical depth carried across chunks.

    Returns (stats [R, 8] float32, steps [R / block_rows] int32)."""
    _check(x, dirs, t, deltas, mask, block_rows, chunk_s)
    R, K, _ = x.shape
    bR, cs = block_rows, chunk_s
    nB = R // bR
    dev = x.device
    thresh = -math.log(max(float(early_stop_eps), 1e-30))

    od_acc = torch.zeros(R, device=dev)
    rgb_acc = torch.zeros(R, 3, device=dev)
    op_acc = torch.zeros(R, device=dev)
    dep_acc = torch.zeros(R, device=dev)
    steps = torch.zeros(nB, dtype=torch.int32, device=dev)
    for c in range(K // cs):
        sl = slice(c * cs, (c + 1) * cs)
        alive = od_acc.view(nB, bR).amin(dim=1) < thresh
        has_valid = (mask[:, sl].reshape(nB, bR * cs) > 0).any(dim=1)
        active = alive & has_valid
        steps += active.to(torch.int32)
        idx = torch.nonzero(active.repeat_interleave(bR)).squeeze(1)
        if idx.numel() == 0:
            continue
        n = idx.numel()
        rgb, sigma = mlp_rows(idx, sl)
        od = sigma.view(n, cs) * deltas[idx, sl] * mask[idx, sl]
        cum = torch.cumsum(od, dim=-1)
        w = torch.exp(-(od_acc[idx, None] + cum - od)) * (1.0 - torch.exp(-od))
        rgb_acc[idx] += (rgb.view(n, cs, 3) * w[..., None]).sum(dim=1)
        op_acc[idx] += w.sum(dim=-1)
        dep_acc[idx] += (w * t[idx, sl]).sum(dim=-1)
        od_acc[idx] += cum[:, -1]
    stats = torch.cat([rgb_acc, op_acc[:, None], dep_acc[:, None],
                       torch.exp(-od_acc)[:, None],
                       torch.zeros(R, 2, device=dev)], dim=-1)
    return stats, steps


def ray_march_reference(x, dirs, t, deltas, mask, params: RayMarchParams,
                        block_rows: int, chunk_s: int,
                        early_stop_eps: float = 1e-4):
    """Plain PyTorch version of the ray-march kernel, with its blocking at
    every packed width (one skip decision per block x chunk step; the
    kernel's 64-row halves from 384 up change no result).

    Args:
      x [R, K, 3], dirs [R, 3], t/deltas/mask [R, K] float32, R a multiple
      of block_rows and K of chunk_s; params from prep_params.

    Returns (stats [R, 8] float32, steps [R / block_rows] int32).
    """
    F, Fv = params.n_freqs, params.n_freqs_views
    e = params.enc
    fx, mx, fd, md = e[:F], e[F:2 * F], e[2 * F:2 * F + Fv], e[2 * F + Fv:]
    unpacked = _unpack(params)
    ed_all = encode(dirs, fd, md, params.d_dir_pad)

    def mlp_rows(idx, sl):
        ex = encode(x[idx, sl].reshape(-1, 3), fx, mx, params.d_enc_pad)
        ed = ed_all[idx].repeat_interleave(chunk_s, dim=0)
        return mlp_forward(ex, ed, params.density_activation, unpacked)

    return _march(x, dirs, t, deltas, mask, block_rows, chunk_s,
                  early_stop_eps, mlp_rows)


def ray_march(x, dirs, t, deltas, mask, params: RayMarchParams,
              block_rows: int, chunk_s: int, early_stop_eps: float = 1e-4):
    """The ray march: csrc/render.cu's nerf_march_kernel for CUDA tensors
    (packed widths, encodings and weights as kernel_arch_error and
    blockings as march_chunk_error take them: ValueError otherwise),
    ray_march_reference for CPU tensors. Same arguments and returns as
    ray_march_reference. Counts its kernel launches in
    `ray_march.launches`."""
    if x.device.type == "cpu":
        return ray_march_reference(x, dirs, t, deltas, mask, params,
                                   block_rows, chunk_s, early_stop_eps)
    err = (kernel_arch_error(params.width, params.d_enc_pad,
                             params.d_dir_pad, n_w=params.wpack.numel())
           or march_chunk_error(params.width, block_rows, chunk_s))
    if err is not None:
        raise ValueError(f"ray_march: {err}")
    slab, ctas = stream_scratch(params.width, x.device)
    stats, steps = _launch_march(
        "ray_march", x, dirs, t, deltas, mask,
        (params.wpack, params.bpack, params.enc), block_rows, chunk_s,
        early_stop_eps, params.n_layers, params.skip_mask, params.width,
        params.n_freqs, params.n_freqs_views, params.d_enc_pad,
        params.d_dir_pad, _DENSITY_ACT[params.density_activation],
        trunk_rows(params.n_layers, params.skip, params.width,
                   params.d_enc_pad), scratch=(_ptr(slab), ctas))
    ray_march.launches += 1
    return stats, steps


def _launch_march(name, x, dirs, t, deltas, mask, weights, block_rows,
                  chunk_s, early_stop_eps, *arch, scratch=()):
    """Check the inputs and launch the C entry fsnerf_<name> of
    csrc/render.cu on CUDA tensors: (x, dirs, t, deltas, mask, *weights,
    stats, steps, *scratch, R, K, block_rows, chunk_s, *arch, thresh,
    stream). Returns (stats [R, 8], steps [R / block_rows])."""
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {x.device}")
    _check(x, dirs, t, deltas, mask, block_rows, chunk_s)
    if block_rows * chunk_s > KERNEL_ROWS:
        raise ValueError(f"block_rows * chunk_s must be <= {KERNEL_ROWS}")
    tensors = (x, dirs, t, deltas, mask, *weights)
    for a in tensors:
        if a.device != x.device or not a.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors on one "
                             "device")
    from .build import load_library

    lib = load_library()
    R, K, _ = x.shape
    stats = torch.empty((R, 8), dtype=torch.float32, device=x.device)
    steps = torch.empty((R // block_rows,), dtype=torch.int32,
                        device=x.device)
    thresh = -math.log(max(float(early_stop_eps), 1e-30))
    err = getattr(lib, f"fsnerf_{name}")(
        *(a.data_ptr() for a in tensors), stats.data_ptr(), steps.data_ptr(),
        *scratch, R, K, block_rows, chunk_s, *arch, thresh,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.fsnerf_error_string(err).decode())
    return stats, steps


ray_march.launches = 0


def pick_chunk_s(k: int, want: int = 8) -> int:
    """Largest of (want, 8, 4, 2, 1) dividing the sample count."""
    for c in (want, 8, 4, 2, 1):
        if k % c == 0:
            return c
    return 1


def march_block_rows(n_rays: int, block_rows: int = 16) -> int:
    """The ray block of a march over n_rays: min(block_rows, max(8,
    n_rays)), as the TPU renderer picks it."""
    return min(block_rows, max(8, n_rays))


def pad_for_march(x, dirs, t, deltas, mask, block_rows: int = 16,
                  chunk_s: int = 8):
    """Pad rays to the block size (padded rays carry mask 0) and pick the
    chunk: bR = march_block_rows(R), cs = pick_chunk_s(K), as the TPU
    renderer does. Returns ((x, dirs, t, deltas, mask) padded, bR, cs)."""
    R, K, _ = x.shape
    cs = pick_chunk_s(K, chunk_s)
    bR = march_block_rows(R, block_rows)
    pad = _round_up(max(R, bR), bR) - R

    def p(a):
        a = a.to(torch.float32)
        if pad:
            a = torch.cat([a, a.new_zeros((pad, *a.shape[1:]))])
        return a.contiguous()

    return tuple(p(a) for a in (x, dirs, t, deltas, mask)), bR, cs


def make_fused_ray_renderer(
    state_dict: Dict[str, torch.Tensor],
    n_layers: int = 8,
    skip=(4,),
    n_freqs: int = 10,
    n_freqs_views: int = 4,
    log_space: bool = True,
    density_activation: str = "none",
    early_stop_eps: float = 1e-4,
    block_rows: int = 16,
    chunk_s: int = 8,
    pos_mask=None,
    dir_mask=None,
    device=None,
):
    """render_fn(x [R,K,3], dirs [R,3], t [R,K], deltas [R,K], mask [R,K]
    bool, bkgd) -> dict(rgb [R,3], opacity [R], depth [R], trans_final [R])
    for the occgrid render path (render/renderer.py). block_rows * chunk_s
    is the kernel's GEMM tile: at most KERNEL_ROWS rows."""
    params = prep_params(state_dict, n_layers, skip, n_freqs, n_freqs_views,
                         log_space, density_activation, pos_mask, dir_mask,
                         device)
    return _renderer(ray_march, params, early_stop_eps, block_rows, chunk_s)


def _renderer(march, params, early_stop_eps: float, block_rows: int,
              chunk_s: int):
    """render_fn over a ray march (ray_march or siren_ray_march): pad,
    march, blend the background."""

    def render_fn(x, dirs, t, deltas, mask, bkgd=0.0):
        R = x.shape[0]
        padded, bR, cs = pad_for_march(x, dirs, t, deltas, mask, block_rows,
                                       chunk_s)
        stats, _ = march(*padded, params, bR, cs, early_stop_eps)
        stats = stats[:R]
        trans_final = stats[:, 5]
        bk = torch.as_tensor(bkgd, dtype=torch.float32, device=stats.device)
        rgb = stats[:, 0:3] + trans_final[:, None] * bk
        return {"rgb": rgb, "opacity": stats[:, 3], "depth": stats[:, 4],
                "trans_final": trans_final}

    render_fn.block_rows = block_rows
    return render_fn


def siren_ray_march_reference(x, dirs, t, deltas, mask, params,
                              block_rows: int, chunk_s: int,
                              early_stop_eps: float = 1e-4):
    """Plain PyTorch version of the SIREN ray-march kernel: the block x
    chunk loop of ray_march_reference with the SiNeRF MLP
    (siren.py::siren_mlp_fwd_reference) on the bf16-rounded raw points and
    directions in place of the encoding and the NeRF MLP.

    Args: as ray_march_reference; params from siren.py::prep_siren_params.
    Returns (stats [R, 8] float32, steps [R / block_rows] int32)."""
    from .siren import pad_inputs, siren_mlp_fwd_reference

    d_all = pad_inputs(dirs)

    def mlp_rows(idx, sl):
        xb = pad_inputs(x[idx, sl].reshape(-1, 3))
        db = d_all[idx].repeat_interleave(chunk_s, dim=0)
        out, _ = siren_mlp_fwd_reference(xb, db, params)
        return out[:, :3], out[:, 3]

    return _march(x, dirs, t, deltas, mask, block_rows, chunk_s,
                  early_stop_eps, mlp_rows)


def siren_ray_march(x, dirs, t, deltas, mask, params, block_rows: int,
                    chunk_s: int, early_stop_eps: float = 1e-4):
    """The SIREN ray march: csrc/render.cu for CUDA tensors,
    siren_ray_march_reference for CPU tensors. Same arguments and returns.
    Counts its kernel launches in `siren_ray_march.launches`.

    On the card every route is a hand-written kernel, chosen by the packed
    width in csrc/render.cu fsnerf_siren_ray_march: widths 64, 128, 192 and
    256 run the warp-specialized march (siren_march_kernel, the SIREN
    forward's wgmma trunk in the NeRF march's shell), 384 and 512 the same
    kernel on the column-split trunk, the streamed widths its streamed
    instance (siren_march_kernel_stream: persistent CTAs over the ray
    blocks, each layer through their slots of stream_scratch's scratch;
    blockings as
    march_chunk_error takes them from 384 up), 288 and 320 (no packer's
    width) the mma.sync one (ray_march_kernel<SirenMarch>); another width
    raises ValueError (siren.py::siren_kernel_error)."""
    if x.device.type == "cpu":
        return siren_ray_march_reference(x, dirs, t, deltas, mask, params,
                                         block_rows, chunk_s, early_stop_eps)
    from .siren import siren_kernel_error

    lay = params.layout
    err = (siren_kernel_error(lay.width, "march", lay.n_layers)
           or march_chunk_error(lay.width, block_rows, chunk_s))
    if err is not None:
        raise ValueError(f"siren_ray_march: {err}")
    slab, ctas = stream_scratch(lay.width, x.device)
    stats, steps = _launch_march(
        "siren_ray_march", x, dirs, t, deltas, mask,
        (params.wpack, params.bpack, params.alphas), block_rows, chunk_s,
        early_stop_eps, lay.n_layers, lay.width, scratch=(_ptr(slab), ctas))
    siren_ray_march.launches += 1
    return stats, steps


siren_ray_march.launches = 0


def make_fused_siren_ray_renderer(
    state_dict: Dict[str, torch.Tensor],
    n_layers: int = 8,
    alphas=None,
    early_stop_eps: float = 1e-4,
    block_rows: int = 16,
    chunk_s: int = 8,
    device=None,
):
    """render_fn(x, dirs, t, deltas, mask, bkgd) -> dict as
    make_fused_ray_renderer's, over the SIREN ray march of a
    reference-keyed SiNeRF state dict (alphas None: (30, 1, ..., 1))."""
    from .siren import prep_siren_params

    params = prep_siren_params(state_dict, n_layers, alphas, device=device)
    return _renderer(siren_ray_march, params, early_stop_eps, block_rows,
                     chunk_s)
