// SiNeRF (SIREN) MLP training kernels for Hopper (sm_90a): the forward
// (optionally streaming each sine activation and its premultiplied
// derivative to HBM) and the backward to bf16 weight and f32 bias
// gradients.
//
// Replaces fsnerf_tpu/ops/pallas/siren.py::make_fused_siren_mlp, whose custom
// VJP runs two Pallas TPU kernels: fwd_call (kernel 7; here
// siren_fwd_ws_kernel at widths 64 / 128 / 192 / 256 and on the column-split
// trunk at 384 / 512, siren_fwd_kernel_stream on the streamed trunk at the
// streamed widths, else siren_fwd_kernel) and bwd_call (kernel 8; here a row
// pass, siren_bwd_rows_ws_kernel in saved mode at widths 64 / 128 / 192 / 256
// and on 64-row CTAs at 384 / 512, siren_bwd_rows_kernel_stream at the
// streamed widths, else siren_bwd_rows_kernel, then dw_gemm_kernel and
// dw_reduce_kernel of train_common.cuh). Plain PyTorch twins:
// fsnerf_tpu_torch/ops/kernels/siren.py::siren_mlp_fwd_reference /
// siren_mlp_bwd_reference.
//
// What bounds them on this card. A row of SiNeRF 8x256 costs ~1.18 MFLOP of
// bf16 GEMMs forward and ~2.6 MFLOP backward (the head recompute, the
// input-cotangent products and the weight-gradient products), plus ~2,300
// polynomial sines per row on the FP32 pipe. Saving the activations streams
// 8 KB per row (h_i and a_i cos(a_i y_i), bf16, 8 layers x 256) out and the
// backward reads them back: at the main path's 196,608 rows that stream
// (1.61 GB) bounds the forward by bytes, and the backward sits near the
// balance of bytes and operations. The forward's GEMMs run on the tensor
// cores, at widths 64, 128, 192, 256, 384 and 512 as warp-specialized wgmma
// fed by TMA (siren_fwd_ws_kernel, below: ws_trunk.cuh's trunk, at 384 and
// 512 its column-split shape, with a sine epilogue), at 288 and 320 (which
// no packer lays out any more) on mma.sync m16n8k16 through the GEMM core
// of mlp_common.cuh (siren_fwd_kernel); the sines run in the GEMM
// epilogues, so no f32 pre-activation ever leaves the SM in the forward.
//
// The backward, as the NeRF one (mlp_train.cu), runs in three launches so
// that nothing is summed in an order that depends on scheduling: a
// row-parallel pass (128 rows per CTA) recomputes the heads and walks the
// layers back, writing every weight gradient's bf16 operands to scratch
// (xs: x | d | s_s | feat | s_r; dy: the bf16 cotangents) and each CTA's
// column sums of the f32 cotangents; then the dW tiles and the fixed-order
// reduce of train_common.cuh. So each backward mode is bitwise repeatable.
// Saved mode reads h_{L-1} and the bf16 factors from the forward's stream;
// recompute mode runs the trunk again, writes h_i to its own stream and the
// factors a_i cos(a_i y_i) in f32 to scratch, as the TPU kernel holds them
// f32 (the two modes' gradients differ by that rounding, by design).
//
// Three row passes. The main path's, saved mode at width 64, 128, 192, 256,
// 384 or 512, is siren_bwd_rows_ws_kernel (below): warp-specialized, every
// product on wgmma fed by TMA, the heads' cotangents in registers; at the
// streamed widths siren_bwd_rows_kernel_stream (kernel 6's streamed shape,
// every operand through L2). Recompute mode up to width 256 takes
// siren_bwd_rows_kernel (which fits in shared memory up to there); from 384
// up it runs the forward kernel into an acts stream first and then the saved
// mode's passes, so there its factors are bf16 and its gradients the saved
// mode's. siren_bwd_rows_kernel is one CTA of 8 warps, mma.sync through
// mlp_common.cuh's GEMM core, each phase behind __syncthreads(); at width 256
// two [128 x 264] bf16 activation buffers (the heads' f32 cos factors borrow
// one as a [128 x 128] f32 array), a [128 x 136] bf16 head buffer, the staged
// inputs and the weight slabs: ~220 KB, one CTA per SM.
//
// Numerics, as the TPU kernels (siren.py::_bwd_grads_siren): each
// cotangent is rounded to bf16 before it enters a product; the heads'
// factors are f32 cos of the recomputed pre-activations; the sigma gate is
// sigma_pre > 0; bias gradients are column sums of the f32 cotangents and
// stay f32, weight gradients are rounded to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "siren_common.cuh"
#include "train_common.cuh"
#include "ws_trunk.cuh"

namespace fsnerf {
namespace {

struct SirenTrainArgs {
  const bf16* x;         // [N, 16] raw coordinates, bf16
  const bf16* d;         // [N, 16] raw view directions, bf16
  Siren m;
  float* out;            // [N, 4] rgb, sigma
  bf16* acts;            // [N_pad, lda]: h_i | (saved) a_i cos(a_i y_i)
  int lda;
  float* cfs;            // [N_pad, L W] f32 factors (recompute), or null
  const bf16* wtpack;    // [out, in]: t_1 .. t_{L-1}, w_f, w_s0, w_r0f
  const float* dout;     // [N, 4] output cotangent
  bf16* xs;              // [N_pad, XW]: x | d | s_s | feat | s_r
  bf16* dy;              // [N_pad, DYW]: dy_0..L-1 | dys | dfeat | dyr |
                         //   dsig (8) | drgb (8)
  float* pbias;          // [N_pad / kRows, n_b] bias-gradient partials
  int N, recompute;
};

// Rows r0 .. r0+127 of x and d ([N, 16] bf16) into xin / din [kRows, kLdIn];
// rows past N become zero.
__device__ void stage_inputs(const SirenTrainArgs& a, bf16* xin, bf16* din,
                             int r0) {
  for (int e = threadIdx.x; e < 2 * kRows * 2; e += kThreads) {
    const int which = e / (2 * kRows), rem = e - which * 2 * kRows;
    const int row = rem >> 1, c8 = (rem & 1) * 8;
    const bf16* src = which ? a.d : a.x;
    bf16* dst = which ? din : xin;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + row < a.N)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * kInPad +
                                          c8);
    *reinterpret_cast<uint4*>(dst + row * kLdIn + c8) = v;
  }
}

size_t fwd_smem_bytes(int width) {
  return sizeof(bf16) * ((size_t)kRows * (2 * (width + kPad) + 2 * kLdIn) +
                         2 * kSlabRows * kSlabLd) +
         sizeof(float) * 4 * kRows;
}

__global__ void __launch_bounds__(kThreads, 1)
    siren_fwd_kernel(SirenTrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int LDH = a.m.width + kPad;
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf1 = buf0 + kRows * LDH;
  bf16* xin = buf1 + kRows * LDH;
  bf16* din = xin + kRows * kLdIn;
  bf16* slabs = din + kRows * kLdIn;
  float* sig = reinterpret_cast<float*>(slabs + 2 * kSlabRows * kSlabLd);
  float* rgb = sig + kRows;

  const int r0 = blockIdx.x * kRows;
  stage_inputs(a, xin, din, r0);
  __syncthreads();
  bf16* acts = a.acts ? a.acts + (size_t)r0 * a.lda : nullptr;
  siren_mlp_rows(a.m, xin, din, buf0, buf1, slabs, kRows, sig, rgb, acts,
                 a.lda, acts != nullptr);
  for (int e = threadIdx.x; e < 4 * kRows; e += kThreads) {
    const int row = e >> 2, c = e & 3;
    if (r0 + row < a.N)
      a.out[(size_t)r0 * 4 + e] = c < 3 ? rgb[3 * row + c] : sig[row];
  }
}

// ---- the forward, warp-specialized ------------------------------------
//
// siren_fwd_ws_kernel<W, kSave> (W = 64, 128, 192, 256; 384 and 512 as
// ws_fwd_consume_split, after it): the forward of
// siren_fwd_kernel on the warp-specialized shape of ws_trunk.cuh. 384
// threads: a producer warpgroup, one of whose threads streams every weight
// tile by TMA through an mbarrier ring (siren_produce_pass), and two
// consumer warpgroups of 64 rows that run every product on wgmma. Per
// consumer:
//   - its 64 rows of x ([N, 16] bf16) are loaded by TMA into a one-block
//     (64 x 64) K-major tile, TMA filling the columns past 16 and the rows
//     past N with zeros; the rows' directions go to registers;
//   - the trunk: each layer's epilogue adds the f32 bias, takes a_i's sine
//     (SineAct) and overwrites the activation tile with h_i once the
//     layer's wgmma have retired; in saved mode the tile goes to acts'
//     columns i W by TMA while the next layer runs, and the factor
//     bf16(a_i cos(a_i y_i)) goes to columns (L + i) W 64 columns at a
//     time through an 8 KB staging block by TMA (a factor tile of 32 KB a
//     consumer does not fit beside a 4-stage ring at width 256; the block
//     timed faster than 4-byte stores from registers in the accumulator
//     layout, than the input tile as a second block with one barrier a
//     chunk, and than a 3-stage ring: PERF.md);
//   - the heads as the saved-mode backward's row pass computes them
//     (siren_heads), then one float4 [rgb, sigma] store a row.
// Shared memory at W = 256: a 4-stage ring (128 KB), the activation tiles
// (2 x 32 KB), the input tiles (2 x 8 KB) and in saved mode the staging
// blocks (2 x 8 KB): 225 KB, one CTA per SM. The acts stream (8 KB a row
// in saved mode) bounds it by bytes.

template <int W, bool kSave>
__device__ __forceinline__ void ws_fwd_consume(
    const CUtensorMap* map_x, const CUtensorMap* map_acts,
    const SirenTrainArgs& a, FwdRing& r, unsigned char* act,
    unsigned char* xt, unsigned char* stage, uint64_t* loaded, int wg) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int row0 = blockIdx.x * kRows + 64 * wg;
  const int quad_row = 16 * (t >> 5) + (lane >> 2);  // rows quad_row + 8 h
  const int bar = 1 + wg;
  const int L = a.m.n_layers;
  if (r.lead) {
    mbar_arrive_expect_tx(loaded, kBlock);
    tma_load_2d(xt, map_x, loaded, 0, row0);
  }
  RowDirs dir;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = row0 + quad_row + 8 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dir.v[h][k] = g < a.N
                        ? __bfloat162float(a.d[(size_t)g * kInPad + k])
                        : 0.f;
  }
  mbar_wait(loaded, 0);
  const SineActs<kSave> acts{a.m.alphas, W, stage, map_acts, L * W, row0,
                             bar, r.lead};
  float acc[W / 2], unused[2] = {0.f, 0.f};
  fwd_trunk<W>(acc, r, act, smem_u32(xt), FwdShape{L, 0, kInPad, 0},
               a.m.bpack, nullptr, unused, bar, kSave ? map_acts : nullptr,
               row0, acts);
  float sigma[2], rgb[2][3];
  siren_heads<W>(acc, r, act, a.m, dir, bar, sigma, rgb);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = row0 + quad_row + 8 * h;
    if ((lane & 3) == 0 && g < a.N)
      reinterpret_cast<float4*>(a.out)[g] =
          make_float4(rgb[h][0], rgb[h][1], rgb[h][2], sigma[h]);
  }
  if (r.lead) bulk_wait<0>();           // the saved activations are written
}

// ws_fwd_consume at a split width (FwdTraits<W>::kSplit: 384, 512): the
// CTA's one consumer warpgroup, its 64 rows from row0 through the
// column-split sine trunk (each output half's factors staged and stored to
// that half's columns) and siren_heads_split.
template <int W, bool kSave>
__device__ __forceinline__ void ws_fwd_consume_split(
    const CUtensorMap* map_x, const CUtensorMap* map_acts,
    const SirenTrainArgs& a, FwdRing& r, SplitActs<W>& tiles,
    unsigned char* xt, unsigned char* stage, uint64_t* loaded) {
  const int t = threadIdx.x, lane = t & 31;
  const int row0 = blockIdx.x * FwdTraits<W>::kCtaRows;
  const int quad_row = 16 * (t >> 5) + (lane >> 2);  // rows quad_row + 8 h
  const int bar = 1;
  const int L = a.m.n_layers;
  if (r.lead) {
    mbar_arrive_expect_tx(loaded, kBlock);
    tma_load_2d(xt, map_x, loaded, 0, row0);
  }
  RowDirs dir;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = row0 + quad_row + 8 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dir.v[h][k] = g < a.N
                        ? __bfloat162float(a.d[(size_t)g * kInPad + k])
                        : 0.f;
  }
  mbar_wait(loaded, 0);
  const SineActs<kSave> acts{a.m.alphas, W, stage, map_acts, L * W, row0,
                             bar, r.lead};
  float acc[W / 4], unused[2] = {0.f, 0.f};
  fwd_trunk_split<W>(acc, r, tiles, smem_u32(xt), FwdShape{L, 0, kInPad, 0},
                     a.m.bpack, nullptr, unused, bar,
                     kSave ? map_acts : nullptr, row0, acts);
  float sigma[2], rgb[2][3];
  siren_heads_split<W>(acc, r, tiles, a.m, dir, bar, sigma, rgb);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = row0 + quad_row + 8 * h;
    if ((lane & 3) == 0 && g < a.N)
      reinterpret_cast<float4*>(a.out)[g] =
          make_float4(rgb[h][0], rgb[h][1], rgb[h][2], sigma[h]);
  }
  if (r.lead) bulk_wait<0>();           // the saved activations are written
}

// The split kernel's body: the ring of W / 2-wide stages, the three
// activation tiles, the input tile, (saved mode) the staging block, the
// barriers; 256 threads, the producer's first thread feeding the ring.
template <int W, bool kSave>
__device__ __forceinline__ void fwd_ws_split_body(
    const SirenFwdMaps& mp, const CUtensorMap* map_x,
    const CUtensorMap* map_acts, const SirenTrainArgs& a, int n_stages,
    unsigned char* smem_raw) {
  using T = FwdTraits<W>;
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* act = ring + n_stages * T::kStageBytes;
  unsigned char* xt = act + T::kActBytes;
  unsigned char* stage = xt + kBlock;              // saved factors
  uint64_t* full =
      reinterpret_cast<uint64_t*>(stage + (kSave ? kBlock : 0));
  uint64_t* empty = full + n_stages;
  uint64_t* loaded = empty + n_stages;
  fwd_init_barriers(full, empty, n_stages, loaded, 1, 1);
  __syncthreads();
  if (threadIdx.x >= 128) {                        // the producer
    if (threadIdx.x == 128) {
      int it = 0;
      siren_produce_pass_split<W>(mp, a.m.n_layers, ring, full, empty,
                                  n_stages, it, nullptr);
    }
    return;
  }
  SplitActs<W> tiles(act);
  FwdRing r{smem_u32(ring), T::kStageBytes, full, empty, n_stages, 0,
            threadIdx.x == 0};
  ws_fwd_consume_split<W, kSave>(map_x, map_acts, a, r, tiles, xt, stage,
                                 loaded);
}

// The kernel's body at a width of whole-row consumers (up to 256).
template <int W, bool kSave>
__device__ __forceinline__ void fwd_ws_whole_body(
    const SirenFwdMaps& mp, const CUtensorMap* map_x,
    const CUtensorMap* map_acts, const SirenTrainArgs& a, int n_stages,
    unsigned char* fwd_ws_smem_raw) {
  unsigned char* ring = fwd_ws_smem_raw +
                        ((1024 - (smem_u32(fwd_ws_smem_raw) & 1023)) & 1023);
  unsigned char* act = ring + n_stages * W * 128;
  unsigned char* xt = act + kFwdConsumers * W * 128;
  unsigned char* stage = xt + kFwdConsumers * kBlock;  // saved factors
  uint64_t* full = reinterpret_cast<uint64_t*>(
      stage + (kSave ? kFwdConsumers * kBlock : 0));
  uint64_t* empty = full + n_stages;
  uint64_t* loaded = empty + n_stages;           // each consumer's inputs
  fwd_init_barriers(full, empty, n_stages, loaded, kFwdConsumers);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kFwdConsumers) {                       // the producer
    setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == 128 * kFwdConsumers) {
      int it = 0;
      siren_produce_pass<W>(mp, a.m.n_layers, ring, full, empty, n_stages,
                            it, nullptr);
    }
    return;
  }
  setmaxnreg_inc<kFwdConsumerRegs>();
  FwdRing r{smem_u32(ring), W * 128, full, empty, n_stages, 0,
            (threadIdx.x & 127) == 0};
  ws_fwd_consume<W, kSave>(map_x, map_acts, a, r, act + wg * W * 128,
                           xt + wg * kBlock, stage + wg * kBlock,
                           &loaded[wg], wg);
}

// grid: one CTA per 128 rows (64 at a split width); block: the consumer
// warpgroups + the producer's (FwdTraits<W>). kSave: a.acts is set
// (map_acts is read only then).
template <int W, bool kSave>
__global__ void __launch_bounds__(FwdTraits<W>::kThreads, 1)
    siren_fwd_ws_kernel(const __grid_constant__ SirenFwdMaps mp,
                        const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_acts,
                        SirenTrainArgs a, int n_stages) {
  extern __shared__ unsigned char fwd_ws_smem_raw[];
  if constexpr (FwdTraits<W>::kSplit)
    fwd_ws_split_body<W, kSave>(mp, &map_x, &map_acts, a, n_stages,
                                fwd_ws_smem_raw);
  else
    fwd_ws_whole_body<W, kSave>(mp, &map_x, &map_acts, a, n_stages,
                                fwd_ws_smem_raw);
}

// The forward's shared memory past ws_trunk.cuh's fwd_smem_bytes: each
// consumer's input barrier and (saved mode) staging block.
template <int W>
size_t fwd_ws_extra(bool save) {
  using T = FwdTraits<W>;
  return T::kConsumers * sizeof(uint64_t) + (save ? T::kConsumers * kBlock : 0);
}

// The forward at width W on `st`: the weight maps, the maps of x and (in
// saved mode) acts, the deepest ring that fits (4 stages at each width up
// to 256 and at 384, 3 at 512; ops/kernels/siren.py::siren_smem_bytes
// mirrors the sizes, fsnerf_siren_stages reports the ring).
template <int W>
cudaError_t launch_fwd_ws(const SirenTrainArgs& a, int n_blocks,
                          cudaStream_t st) {
  using T = FwdTraits<W>;
  const int L = a.m.n_layers;
  SirenFwdMaps mp;
  CUtensorMap map_x, map_acts;
  if (!encode_siren_fwd_maps(&mp, a.m.wpack, L, W) ||
      !encode_bf16_map(&map_x, a.x, a.N, kInPad, kInPad, 64))
    return cudaErrorInvalidValue;
  if (a.acts == nullptr)
    map_acts = map_x;                              // unread
  else if (!encode_bf16_map(&map_acts, a.acts, n_blocks * kRows, a.lda,
                            a.lda, 64))
    return cudaErrorInvalidValue;
  const size_t extra = fwd_ws_extra<W>(a.acts != nullptr);
  const int n_stages = fwd_stages(W, kInPad, 0, extra);
  if (n_stages == 0) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(W, kInPad, 0, n_stages) + extra;
  const auto kernel = a.acts != nullptr ? siren_fwd_ws_kernel<W, true>
                                        : siren_fwd_ws_kernel<W, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<n_blocks * (kRows / T::kCtaRows), T::kThreads, smem, st>>>(
      mp, map_x, map_acts, a, n_stages);
  return cudaGetLastError();
}

// ---- the forward at the streamed widths (768 and every multiple of 256 up)
//
// siren_fwd_kernel_stream<kSave>: ws_trunk.cuh's streamed trunk with the
// sine epilogue and siren_common.cuh's streamed heads, on persistent CTAs
// of one 64-row consumer warpgroup and a producer warpgroup (the NeRF
// train forward's shell, mlp_train.cu fwd_stream_body), W at run time.
// Per row tile: its rows of x are loaded by TMA into encx (one 64 x 64
// block, TMA's zero fill past 16 columns and past N); each trunk layer's
// 256-column chunks go to device memory, in saved mode h_i straight to the
// acts stream's columns i W, and its bf16 factors a_i cos(a_i y_i) through
// one 8 KB staging block (64 columns at a time, as the other widths') to
// columns (L + i) W: the block keeps the 4-stage weight ring, which a
// whole 64 x 256 factor tile would cut to 3; without acts (and for feat
// in either mode) the CTA's slot of render.py::stream_scratch's [SMs x
// 64, 2 W] scratch holds the layers. Then the heads (siren_heads_stream),
// the rows' directions in registers, and one float4 [rgb, sigma] store a
// row. Per row and layer 2 W^2 FLOP against 4 W bytes through L2, so the
// layers stay compute-bound; in saved mode the acts stream (4 L W bytes a
// row, 64 KB at 8 x 1024) goes to HBM.

template <bool kSave>
__device__ __forceinline__ void fwd_stream_consume(
    const CUtensorMap* map_x, const CUtensorMap* map_acts,
    const CUtensorMap* map_slab, const SirenTrainArgs& a, FwdRing& r,
    ARing& ar, const StreamTiles& s, uint64_t* loaded) {
  const int W = a.m.width, L = a.m.n_layers;
  const int t = threadIdx.x, lane = t & 31, bar = 1;
  const int quad_row = 16 * (t >> 5) + (lane >> 2);  // rows quad_row + 8 h
  const int n_tiles = (a.N + kRows - 1) / kRows * (kRows / 64);
  int k = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++k) {
    const int row0 = tile * 64;
    // every warp's products of the last tile have read encx
    named_bar(bar, 128);
    if (r.lead) {
      mbar_arrive_expect_tx(loaded, kBlock);
      tma_load_2d(s.encx, map_x, loaded, 0, row0);
    }
    const StreamBufs io{kSave ? map_acts : nullptr, map_slab, row0,
                        (int)blockIdx.x * 64, W, L};
    const SineActs<kSave> acts{a.m.alphas, W,   s.encd, map_acts,
                               L * W,      row0, bar,    r.lead};
    mbar_wait(loaded, k & 1);
    float sigma[2], rgb[2][3];
    {
      float acc[kStreamCols / 2], unused[2] = {0.f, 0.f};
      zero_acc(acc);
      stream_trunk(acc, r, ar, s, FwdShape{L, 0, kInPad, 0}, W, a.m.bpack,
                   nullptr, unused, bar, io, acts);
      RowDirs dir;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = row0 + quad_row + 8 * h;
#pragma unroll
        for (int c = 0; c < 3; ++c)
          dir.v[h][c] = g < a.N
                            ? __bfloat162float(a.d[(size_t)g * kInPad + c])
                            : 0.f;
      }
      siren_heads_stream(acc, r, ar, s, a.m, dir, bar, io, sigma, rgb);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = row0 + quad_row + 8 * h;
      if ((lane & 3) == 0 && g < a.N)
        reinterpret_cast<float4*>(a.out)[g] =
            make_float4(rgb[h][0], rgb[h][1], rgb[h][2], sigma[h]);
    }
  }
  if (r.lead) bulk_wait<0>();           // the saved activations are written
}

// grid: min(row tiles, the scratch's slots) persistent CTAs; block: one
// consumer warpgroup + the producer's. Shared memory: stream_carve's, its
// encd block (in saved mode) the factors' staging block, its first extra
// barrier the row tile's input load. map_acts is read only with kSave.
template <bool kSave>
__global__ void __launch_bounds__(256, 1)
    siren_fwd_kernel_stream(const __grid_constant__ SirenFwdMaps mp,
                            const __grid_constant__ CUtensorMap map_x,
                            const __grid_constant__ CUtensorMap map_acts,
                            const __grid_constant__ CUtensorMap map_slab,
                            SirenTrainArgs a, int n_stages) {
  extern __shared__ unsigned char fwd_stream_smem_raw[];
  const StreamTiles s =
      stream_carve(fwd_stream_smem_raw, n_stages, kInPad, kSave ? 64 : 0);
  fwd_init_barriers(s.full, s.empty, n_stages, s.afull, kStreamAStages + 1,
                    1);
  __syncthreads();
  const int W = a.m.width, L = a.m.n_layers;
  const int n_tiles = (a.N + kRows - 1) / kRows * (kRows / 64);
  if (threadIdx.x >= 128) {                        // the producer
    if (threadIdx.x == 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        siren_produce_pass_stream(mp, L, W, s.ring, s.full, s.empty,
                                  n_stages, it, nullptr);
    }
    return;
  }
  FwdRing r{smem_u32(s.ring), kStreamStageBytes, s.full, s.empty, n_stages,
            0, threadIdx.x == 0};
  ARing ar{smem_u32(s.a), s.a, s.afull, 0};
  fwd_stream_consume<kSave>(&map_x, &map_acts, &map_slab, a, r, ar, s,
                            s.extra);
}

// The streamed forward's extra shared memory past its barriers: the row
// tile's input barrier.
constexpr size_t kFwdStreamExtra = 16;

// The ring the streamed forward runs (saved mode or not): the deepest up
// to 4 stages that fits (ops/kernels/siren.py::siren_smem_bytes mirrors
// it).
int fwd_stream_stages(bool save) {
  return stream_stages(kInPad, save ? 64 : 0, kFwdStreamExtra);
}

// The streamed forward on `st`, slab the [slab_ctas * 64, 2 W] bf16
// scratch. Every row up to round_up(N, 128) is computed (rows past N on
// zero inputs), as the backward's passes read them.
cudaError_t launch_fwd_stream(const SirenTrainArgs& a, const bf16* slab,
                              int slab_ctas, cudaStream_t st) {
  const int W = a.m.width, L = a.m.n_layers;
  const int n_rows = (a.N + kRows - 1) / kRows * kRows;
  const bool save = a.acts != nullptr;
  SirenFwdMaps mp;
  CUtensorMap map_x, map_acts, map_slab;
  if (slab == nullptr || slab_ctas <= 0 ||
      !encode_siren_fwd_maps(&mp, a.m.wpack, L, W) ||
      !encode_bf16_map(&map_x, a.x, a.N, kInPad, kInPad, 64) ||
      !encode_bf16_map(&map_slab, slab, slab_ctas * 64, 2 * W, 2 * W, 64))
    return cudaErrorInvalidValue;
  if (!save)
    map_acts = map_slab;                           // unread
  else if (!encode_bf16_map(&map_acts, a.acts, n_rows, a.lda, a.lda, 64))
    return cudaErrorInvalidValue;
  const int n_stages = fwd_stream_stages(save);
  if (n_stages == 0) return cudaErrorInvalidValue;
  const size_t smem =
      stream_smem_bytes(kInPad, save ? 64 : 0, n_stages) + kFwdStreamExtra;
  const auto kernel = save ? siren_fwd_kernel_stream<true>
                           : siren_fwd_kernel_stream<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<min(n_rows / 64, slab_ctas), 256, smem, st>>>(
      mp, map_x, map_acts, map_slab, a, n_stages);
  return cudaGetLastError();
}

// The backward layer epilogue: v = acc (times the factor of the tile's
// (row, col) in device memory: bf16 fb or f32 ff, row stride ldf, when
// given), C = bf16(v) in shared memory, and this warp's column sums of the
// f32 v into colpart.
struct FactorEpi {
  bf16* C;
  int ldc;
  const bf16* fb;
  const float* ff;
  int ldf;
  float* colpart;
  int width;
  __device__ __forceinline__ void operator()(int row, int col,
                                             const float (&c)[2][4]) const {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 16 * i + 8 * h;
        float v0 = c[i][2 * h], v1 = c[i][2 * h + 1];
        if (fb) {
          const __nv_bfloat162 f = *reinterpret_cast<const __nv_bfloat162*>(
              fb + (size_t)r * ldf + col);
          v0 = __fmul_rn(v0, __bfloat162float(f.x));
          v1 = __fmul_rn(v1, __bfloat162float(f.y));
        } else if (ff) {
          const float2 f =
              *reinterpret_cast<const float2*>(ff + (size_t)r * ldf + col);
          v0 = __fmul_rn(v0, f.x);
          v1 = __fmul_rn(v1, f.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(C + r * ldc + col) =
            __floats2bfloat162_rn(v0, v1);
        s0 += v0;
        s1 += v1;
      }
    }
    warp_colsums(s0, s1, colpart, width, col);
  }
};

size_t bwd_smem_bytes(int width) {
  return sizeof(bf16) * ((size_t)kRows * (2 * (width + kPad) +
                                          (width / 2 + kPad) + 2 * kLdIn) +
                         2 * kSlabRows * kSlabLd) +
         sizeof(float) * (8 * kRows + 4 * (size_t)width);
}

__global__ void __launch_bounds__(kThreads, 1)
    siren_bwd_rows_kernel(SirenTrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Siren& m = a.m;
  const int W = m.width, Wh = W / 2, L = m.n_layers;
  const int LDH = W + kPad, LDS = Wh + kPad;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  bf16* bufA = reinterpret_cast<bf16*>(smem_raw);
  bf16* bufB = bufA + kRows * LDH;
  bf16* hbuf = bufB + kRows * LDH;         // [kRows, Wh]: s_s, dys, s_r, dyr
  bf16* xin = hbuf + kRows * LDS;
  bf16* din = xin + kRows * kLdIn;
  bf16* slabs = din + kRows * kLdIn;
  float* dsig = reinterpret_cast<float*>(slabs + 2 * kSlabRows * kSlabLd);
  float* rgb = dsig + kRows;
  float* drgb = rgb + 3 * kRows;
  float* colpart = drgb + 3 * kRows;       // [4][W]

  const int XW = 2 * kInPad + 2 * W, DYW = L * W + 2 * W + 16;
  const int xs_ss = 2 * kInPad, xs_feat = xs_ss + Wh, xs_sr = xs_feat + W;
  const int dy_s = L * W, dy_f = dy_s + Wh, dy_r = dy_f + W;
  const int dy_sig = dy_r + Wh, dy_rgb = dy_sig + 8;
  const int NB = L * W + Wh + 1 + W + Wh + 3;
  const int r0 = blockIdx.x * kRows;
  float* pb = a.pbias + (size_t)blockIdx.x * NB;
  const Seg none = {nullptr, 0, nullptr, 0};

  stage_inputs(a, xin, din, r0);
  __syncthreads();
  rows_to_global(xin, kLdIn, a.xs, XW, r0, 0, kInPad);
  rows_to_global(din, kLdIn, a.xs, XW, r0, kInPad, kInPad);
  bf16* acts = a.acts + (size_t)r0 * a.lda;
  bf16* hl;
  if (a.recompute) {
    hl = siren_trunk(m, xin, bufA, bufB, slabs, acts, a.lda, false,
                     a.cfs + (size_t)r0 * L * W);
  } else {
    rows_from_global(acts, a.lda, 0, (L - 1) * W, bufA, LDH, W);
    __syncthreads();
    hl = bufA;
  }
  bf16* other = hl == bufA ? bufB : bufA;
  float* cosf = reinterpret_cast<float*>(other);   // [kRows, Wh] f32

  // sigma head: s_s into hbuf, cos(ys) f32 into `other`
  SineEpi s_epi{m.bpack + m.ob_s0(), 1.f, hbuf, LDS, nullptr, 0, cosf, Wh};
  gemm(Seg{hl, LDH, m.ws0(), W}, none, Wh, slabs, s_epi);
  __syncthreads();
  siren_sigma_pre(m, hbuf, LDS, kRows, [&](int row, float v) {
    const int g = r0 + row;
    dsig[row] = (v > 0.f && g < a.N) ? a.dout[(size_t)g * 4 + 3] : 0.f;
  });
  rows_to_global(hbuf, LDS, a.xs, XW, r0, xs_ss, Wh);
  __syncthreads();
  if (warp == 0) {             // b_s1, then the bf16 dsig as a dY operand
    float v = 0.f;
    for (int row = lane; row < kRows; row += 32) v += dsig[row];
    v = warp_sum(v);
    if (lane == 0) pb[m.ob_s1()] = v;
  }
  __syncthreads();
  if (tid < kRows) {
    bf16* dr = a.dy + (size_t)(r0 + tid) * DYW + dy_sig;
    const bf16 vb = __float2bfloat16_rn(dsig[tid]);
    for (int c = 0; c < 8; ++c) dr[c] = c == 0 ? vb : __float2bfloat16_rn(0.f);
    dsig[tid] = __bfloat162float(vb);
  }
  __syncthreads();
  // dys = (dsig_b w_s1) cos(ys): one column per thread, rows in order, into
  // hbuf over s_s (already in xs)
  {
    const bf16* w_s1 = m.ws1();
    for (int j = tid; j < Wh; j += kThreads) {
      const float w = __bfloat162float(w_s1[j]);
      float colsum = 0.f;
      for (int row = 0; row < kRows; ++row) {
        const float v = __fmul_rn(__fmul_rn(dsig[row], w), cosf[row * Wh + j]);
        colsum += v;
        hbuf[row * LDS + j] = __float2bfloat16_rn(v);
      }
      pb[m.ob_s0() + j] = colsum;
    }
  }
  __syncthreads();
  rows_to_global(hbuf, LDS, a.dy, DYW, r0, dy_s, Wh);

  // feat into `other` (the gemm's first barrier ends the reads of cos(ys))
  gemm_layer(Seg{hl, LDH, m.wf(), W}, none, m.bpack + m.ob_f(), W, false,
             other, LDH, slabs);
  __syncthreads();
  rows_to_global(other, LDH, a.xs, XW, r0, xs_feat, W);
  // rgb head: s_r into hbuf (its dys copy ended at the feat gemm's
  // barriers), cos(yr) f32 into hl (h_last is dead)
  float* cosr = reinterpret_cast<float*>(hl);
  SineEpi r_epi{m.bpack + m.ob_r0(), 1.f, hbuf, LDS, nullptr, 0, cosr, Wh};
  gemm(Seg{other, LDH, m.wr0f(), W}, Seg{din, kLdIn, m.wr0d(), kInPad}, Wh,
       slabs, r_epi);
  __syncthreads();
  siren_rgb(m, hbuf, LDS, kRows, rgb);
  rows_to_global(hbuf, LDS, a.xs, XW, r0, xs_sr, Wh);
  __syncthreads();
  if (tid < kRows) {           // d rgb_pre = d rgb * r (1 - r)
    const int g = r0 + tid;
    for (int c = 0; c < 3; ++c) {
      const float r = rgb[3 * tid + c];
      const float dv = g < a.N ? a.dout[(size_t)g * 4 + c] : 0.f;
      drgb[3 * tid + c] = dv * r * (1.f - r);
    }
  }
  __syncthreads();
  if (warp < 3) {              // b_r1: one warp per channel
    float v = 0.f;
    for (int row = lane; row < kRows; row += 32) v += drgb[3 * row + warp];
    v = warp_sum(v);
    if (lane == 0) pb[m.ob_r1() + warp] = v;
  }
  __syncthreads();
  if (tid < kRows) {           // the bf16 drgb as a dY operand
    bf16* dr = a.dy + (size_t)(r0 + tid) * DYW + dy_rgb;
    for (int c = 0; c < 8; ++c) {
      const bf16 vb = __float2bfloat16_rn(c < 3 ? drgb[3 * tid + c] : 0.f);
      dr[c] = vb;
      if (c < 3) drgb[3 * tid + c] = __bfloat162float(vb);
    }
  }
  __syncthreads();
  // dyr = (drgb_b w_r1^T) cos(yr): one column per thread, into hbuf over s_r
  {
    const bf16* w_r1 = m.wr1();
    for (int j = tid; j < Wh; j += kThreads) {
      const float w0 = __bfloat162float(w_r1[3 * j]);
      const float w1 = __bfloat162float(w_r1[3 * j + 1]);
      const float w2 = __bfloat162float(w_r1[3 * j + 2]);
      float colsum = 0.f;
      for (int row = 0; row < kRows; ++row) {
        const float* dr = drgb + 3 * row;
        const float p = __fadd_rn(__fadd_rn(__fmul_rn(dr[0], w0),
                                            __fmul_rn(dr[1], w1)),
                                  __fmul_rn(dr[2], w2));
        const float v = __fmul_rn(p, cosr[row * Wh + j]);
        colsum += v;
        hbuf[row * LDS + j] = __float2bfloat16_rn(v);
      }
      pb[m.ob_r0() + j] = colsum;
    }
  }
  __syncthreads();
  rows_to_global(hbuf, LDS, a.dy, DYW, r0, dy_r, Wh);

  // dfeat = dyr_b w_r0f^T into `other` (feat is in xs)
  const bf16* wt = a.wtpack;
  const bf16* wt_f = wt + (size_t)(L - 1) * W * W;
  const bf16* wt_s0 = wt_f + (size_t)W * W;
  const bf16* wt_r0f = wt_s0 + (size_t)Wh * W;
  FactorEpi epi{other, LDH, nullptr, nullptr, 0, colpart, W};
  gemm(Seg{hbuf, LDS, wt_r0f, Wh}, none, W, slabs, epi);
  __syncthreads();
  store_colsums(colpart, pb, m.ob_f(), W, W, 4);
  rows_to_global(other, LDH, a.dy, DYW, r0, dy_f, W);
  __syncthreads();
  // back to dys_b in hbuf for the last trunk layer's product
  rows_from_global(a.dy, DYW, r0, dy_s, hbuf, LDS, Wh);
  __syncthreads();

  // last trunk layer: dy = (dfeat_b w_f^T + dys_b w_s0^T) * factor
  const bf16* fb = a.recompute ? nullptr : acts + (size_t)L * W;
  const float* ff = a.recompute ? a.cfs + (size_t)r0 * L * W : nullptr;
  const int ldf = a.recompute ? L * W : a.lda;
  bf16* cur = hl;
  epi = FactorEpi{cur, LDH, fb ? fb + (size_t)(L - 1) * W : nullptr,
                  ff ? ff + (size_t)(L - 1) * W : nullptr, ldf, colpart, W};
  gemm(Seg{other, LDH, wt_f, W}, Seg{hbuf, LDS, wt_s0, Wh}, W, slabs, epi);
  __syncthreads();
  store_colsums(colpart, pb, (L - 1) * W, W, W, 4);
  rows_to_global(cur, LDH, a.dy, DYW, r0, (L - 1) * W, W);

  // trunk: dy_{i-1} = (dy_i_b t_i^T) * factor_{i-1}
  bf16* nxt = other;
  for (int i = L - 1; i >= 1; --i) {
    epi = FactorEpi{nxt, LDH, fb ? fb + (size_t)(i - 1) * W : nullptr,
                    ff ? ff + (size_t)(i - 1) * W : nullptr, ldf, colpart, W};
    gemm(Seg{cur, LDH, wt + (size_t)(i - 1) * W * W, W}, none, W, slabs, epi);
    __syncthreads();
    store_colsums(colpart, pb, (i - 1) * W, W, W, 4);
    rows_to_global(nxt, LDH, a.dy, DYW, r0, (i - 1) * W, W);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// ---- the saved-mode backward row pass, warp-specialized --------------
//
// siren_bwd_rows_ws_kernel<W> (W = 64, 128, 192, 256; saved mode; 384 and
// 512 on 64-row CTAs, below): the same
// outputs as siren_bwd_rows_kernel (xs, dy, pbias) on the warp-specialized
// shape of ws_trunk.cuh. 384 threads: a producer warpgroup, one of whose
// threads streams every weight tile by TMA through an mbarrier ring in the
// order the consumers use them, and two consumer warpgroups of 64 rows that
// run every product on wgmma (A a consumer's K-major 128B-swizzled tile in
// shared memory, B the ring's stage read N-major: wpack's [in, out] rows
// for the heads' forward, wtpack's [out, in] rows for the cotangent
// products, so that each is the forward's operand form). Per consumer:
//   - h_{L-1} is loaded by TMA into its W-wide tile T; x | d are copied to
//     xs (zeros past N);
//   - ys = h W_s0 + b_s0: the epilogue keeps s_s (bf16, into its Wh-wide
//     tile S, then to xs by TMA) and cos(ys) (f32, over the accumulators);
//     sigma_pre = s_s . w_s1 + b_s1 is a per-thread dot over its columns
//     and two quad shuffles, so dsig (sigma_pre > 0 gate) and dys = (dsig_b
//     w_s1) cos(ys) stay in registers, and dys_b overwrites s_s in S;
//   - feat = bf16(h W_f + b_f) overwrites h in T (to xs by TMA);
//   - yr = feat W_r0f + d W_r0d + b_r0: the view directions' term is a
//     rank-3 update in the epilogue (d's columns past 3 meet zero rows of
//     w_r0d); s_r goes to T's first Wh columns (to xs), rgb = sigmoid(s_r
//     w_r1 + b_r1) from quad sums, drgb, and dyr = (drgb_b w_r1^T) cos(yr)
//     to T's last Wh columns (at W = 192 over s_r: kDyr) (to dy);
//   - dfeat = dyr_b W_r0f^T, then dh = dfeat_b W_f^T + dys_b W_s0^T (two
//     segments into one accumulator), then dh_{i-1} = dy_i_b W_i^T: each
//     epilogue multiplies by the saved bf16 factor a_i cos(a_i y_i), read
//     from acts into registers in the accumulator layout, and writes the
//     bf16 cotangent over T in place once the product's wgmma have retired
//     and T's last TMA store has read it; the tile then goes to dy by TMA.
// Bias partials: each warp's column sums of the f32 cotangents over its 16
// rows (shuffles; a reduce-scatter over the quads in the cotangent
// products' epilogues) go to a shared array, which the warpgroup sums over
// its 4 warps in order into its own row of the CTA's bias partials in
// shared memory; the two consumers never wait for each other until the end,
// where their rows are added in order into pbias[blockIdx], so the
// backward stays bitwise repeatable. After set-up no __syncthreads() runs.
// Shared memory at W = 256, L = 8: a 3-stage ring (96 KB; a 4th stage does
// not fit beside the tiles and the partials), T (32 KB) and S (16 KB) per
// consumer, the column sums and the bias partials (28 KB).
constexpr int kBwdBoth = 3;          // both consumers' named barrier

//
// At the packed widths 384 and 512 (FwdTraits<W>::kSplit) the same pass
// runs on CTAs of 64 rows: 256 threads, the producer and one consumer
// warpgroup (no setmaxnreg), every product with N = W split into two
// output column halves of W / 2 into one W / 2 accumulator (128 registers
// a thread at 512, as at W = 256), the ring's stages 64 K-rows x W / 2.
// Its tiles are SplitActs' three half-width tiles, which rotate as the
// forward's: h_{L-1} arrives in two of them; feat's halves go to the free
// one and over h's first half; s_r to the free one and dyr over feat's
// first half; dfeat's halves (K = W / 2, from dyr) to the other two; then
// each cotangent product dh_{i-1} = dy_i W_i^T (and dh's two segments)
// reads both input halves per output half, the first half's output going
// to the free tile, the second over the input's first half once both
// halves' products have retired. S holds s_s, then dys, as above. With one
// consumer a CTA's bias partials need no sum across warpgroups: each
// combine writes its columns straight to the CTA's row of pbias, which has
// n_pad / 64 rows (the reduce walks them in order). Shared memory at 512:
// a 2-stage ring (64 KB), the three tiles (96 KB), S (32 KB) and the
// column sums (8 KB); at 384 a 4-stage ring.

template <int W>
size_t ws_bwd_smem_bytes(int n_stages, int n_bias) {
  if (FwdTraits<W>::kSplit)
    return 1024 + (size_t)(n_stages + 3) * (W / 2) * 128 +
           (size_t)enc_blocks(W / 2) * kBlock + 4 * (W + 4) * sizeof(float) +
           (2 * n_stages + 1) * sizeof(uint64_t);
  return 1024 + (size_t)(n_stages + kFwdConsumers) * W * 128 +
         (size_t)kFwdConsumers * enc_blocks(W / 2) * kBlock +
         (size_t)kFwdConsumers * (4 * (W + 4) + n_bias) * sizeof(float) +
         (2 * n_stages + kFwdConsumers) * sizeof(uint64_t);
}

// The deepest ring up to kFwdMaxStages that fits beside the tiles and the
// partials of n_bias bias columns, or 0 if a ring of 2 does not.
template <int W>
int ws_bwd_stages(int n_bias) {
  int n = kFwdMaxStages;
  while (n >= 2 && ws_bwd_smem_bytes<W>(n, n_bias) > kMaxSmem) --n;
  return n < 2 ? 0 : n;
}

// The bias columns of an L-layer SIREN at packed width W (bpack's length).
int siren_n_bias(int L, int W) { return L * W + W / 2 + 1 + W + W / 2 + 3; }

// The tensor maps: the heads' forward matrices in wpack (w_s0 [W, Wh], w_f
// [W, W], w_r0f [W, Wh]), wtpack as [(L + 1) W, W] (t_1 .. t_{L-1}, w_f,
// w_s0, w_r0f, each [out, in]), and acts, xs and dy.
struct SirenBwdMaps {
  CUtensorMap s0, f, r0, wt, acts, xs, dy;
};

// The producer: every weight tile in the consumers' order (at a split
// width each N = W product half by half, from that half's columns).
template <int W>
__device__ __forceinline__ void ws_bwd_produce(const SirenBwdMaps& mp,
                                               int L, unsigned char* ring,
                                               uint64_t* full,
                                               uint64_t* empty,
                                               int n_stages) {
  constexpr int Wh = W / 2, NS = head_n(W);
  constexpr int SC = FwdTraits<W>::kSplit ? Wh : W;   // a stage's columns
  int it = 0;
  auto feed = [&](const CUtensorMap* map, int row, int k, int n_box,
                  int col0 = 0) {
    for (int kc = 0; kc < k; kc += 64, ++it) {
      const int s = it % n_stages;
      if (it >= n_stages) mbar_wait(&empty[s], (it / n_stages - 1) & 1);
      unsigned char* st = ring + s * (SC * 128);
      mbar_arrive_expect_tx(&full[s], n_box * kBlock);
      for (int q = 0; q < n_box; ++q)
        tma_load_2d(st + q * kBlock, map, &full[s], col0 + 64 * q, row + kc);
    }
  };
  if constexpr (FwdTraits<W>::kSplit) {
    feed(&mp.s0, 0, W, NS / 64);               // ys = h W_s0 (N = Wh)
    for (int n = 0; n < 2; ++n)                // feat = h W_f
      feed(&mp.f, 0, W, Wh / 64, n * Wh);
    feed(&mp.r0, 0, W, NS / 64);               // yr = feat W_r0f
    for (int n = 0; n < 2; ++n)                // dfeat = dyr W_r0f^T
      feed(&mp.wt, L * W + Wh, Wh, Wh / 64, n * Wh);
    for (int n = 0; n < 2; ++n) {              // dh = dfeat W_f^T
      feed(&mp.wt, (L - 1) * W, W, Wh / 64, n * Wh);
      feed(&mp.wt, L * W, Wh, Wh / 64, n * Wh);  //    + dys W_s0^T
    }
    for (int i = L - 1; i >= 1; --i)
      for (int n = 0; n < 2; ++n)              // dh_{i-1} = dy_i W_i^T
        feed(&mp.wt, (i - 1) * W, W, Wh / 64, n * Wh);
    return;
  }
  feed(&mp.s0, 0, W, NS / 64);                 // ys = h W_s0
  feed(&mp.f, 0, W, W / 64);                   // feat = h W_f
  feed(&mp.r0, 0, W, NS / 64);                 // yr = feat W_r0f
  feed(&mp.wt, L * W + Wh, Wh, W / 64);        // dfeat = dyr W_r0f^T
  feed(&mp.wt, (L - 1) * W, W, W / 64);        // dh = dfeat W_f^T
  feed(&mp.wt, L * W, Wh, W / 64);             //    + dys W_s0^T
  for (int i = L - 1; i >= 1; --i)
    feed(&mp.wt, (i - 1) * W, W, W / 64);      // dh_{i-1} = dy_i W_i^T
}

// Columns [c0, c0 + n) of a consumer's tile to columns gcol.. of its 64
// rows from row0 of a [*, ld] bf16 matrix: by TMA from the lead thread
// when they are whole 64-column blocks, else by the warpgroup's 16-byte
// copies (a 32-wide head at W = 64). Called by the whole warpgroup after
// the barrier that ends the tile's writes.
__device__ __forceinline__ void store_cols(const CUtensorMap* map,
                                           unsigned char* tile, int c0,
                                           int n, bf16* g, int ld, int gcol,
                                           int row0, bool lead) {
  if (n % 64 == 0 && c0 % 64 == 0) {
    if (lead) {
      for (int q = 0; q < n / 64; ++q)
        tma_store_2d(map, tile + (c0 / 64 + q) * kBlock, gcol + 64 * q,
                     row0);
      bulk_commit();
    }
    return;
  }
  const int per_row = n / 8;
  for (int e = threadIdx.x & 127; e < 64 * per_row; e += 128) {
    const int row = e / per_row, c = e - row * per_row;
    *reinterpret_cast<uint4*>(g + (size_t)(row0 + row) * ld + gcol + 8 * c) =
        *reinterpret_cast<const uint4*>(tile_at(tile, row, c0 + 8 * c));
  }
}

// This warp's column sums (its 16 rows) of the f32 values s0 / s1 at
// columns col, col + 1 into its row of the column-sum array.
__device__ __forceinline__ void warp_colsum(float s0, float s1, float* cp,
                                            int col) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if ((threadIdx.x & 31) < 4) {
    cp[col] = s0;
    cp[col + 1] = s1;
  }
}

// This warp's sum over its 16 rows of a per-row value held in every lane
// of the row's quad (v[h]: rows lane / 4 + 8 h), into cp[col].
__device__ __forceinline__ void warp_rowsum(const float (&v)[2], float* cp,
                                            int col) {
  float s = v[0] + v[1];
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) cp[col] = s;
}

// After the warpgroup's four warps wrote their rows (stride ld) of its
// column-sum array cp: dst[c] = the rows' sums in order, c < n (dst: the
// warpgroup's bias partials). `bar` is the warpgroup's named barrier.
__device__ __forceinline__ void colsums_combine(const float* cp, int ld,
                                                int n, float* dst, int bar) {
  named_bar(bar, 128);
  for (int c = threadIdx.x & 127; c < n; c += 128)
    dst[c] = ((cp[c] + cp[ld + c]) + cp[2 * ld + c]) + cp[3 * ld + c];
}

// This warp's column sums (its 16 rows) of s[jj][e] (column 8 (j0 + jj) +
// 2 (lane % 4) + e of this thread's two rows) into cp, by a reduce-scatter
// over the quads (lane bits 4, 3, 2): afterwards lane l holds the sums of
// block j0 + l / 4.
__device__ __forceinline__ void warp_colsum8(const float (&s)[8][2],
                                             float* cp, int j0) {
  const int lane = threadIdx.x & 31;
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float a[4][2], c[2][2], d[2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      a[i][e] = (b4 ? s[i + 4][e] : s[i][e]) +
                __shfl_xor_sync(0xffffffffu, b4 ? s[i][e] : s[i + 4][e], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      c[i][e] = (b3 ? a[i + 2][e] : a[i][e]) +
                __shfl_xor_sync(0xffffffffu, b3 ? a[i][e] : a[i + 2][e], 8);
#pragma unroll
  for (int e = 0; e < 2; ++e)
    d[e] = (b2 ? c[1][e] : c[0][e]) +
           __shfl_xor_sync(0xffffffffu, b2 ? c[0][e] : c[1][e], 4);
  const int col = 8 * (j0 + (lane >> 2)) + 2 * (lane & 3);
  cp[col] = d[0];
  cp[col + 1] = d[1];
}

// A cotangent product's epilogue over the accumulators (rows 16 warp +
// lane / 4 + 8 h of the consumer's 64): v = acc (times the bf16 factor at
// fac[row * ldf + col] when fac is set), the tile's columns = bf16(v) by
// stmatrix, and this warp's column sums of the f32 v into cp (a
// reduce-scatter per kChunk column blocks: 14 shuffles for 16 sums, where
// a shuffle tree per column pair takes 48). The factors of kChunk column
// blocks are loaded before their use.
template <int NACC>
__device__ __forceinline__ void cot_epilogue(const float (&acc)[NACC],
                                             const bf16* fac, int ldf,
                                             unsigned char* tile, float* cp) {
  constexpr int kChunk = 8;
  const int lane = threadIdx.x & 31;
  const int m = lane >> 3;
  const int srow = 16 * ((threadIdx.x >> 5) & 3) + 8 * (m & 1) + (lane & 7);
  const int qrow = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
#pragma unroll
  for (int j0 = 0; j0 < NACC / 4; j0 += kChunk) {
    uint32_t f[kChunk][2];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int col = 8 * (j0 + jj) + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h)
        f[jj][h] = fac ? *reinterpret_cast<const uint32_t*>(
                             fac + (size_t)(qrow + 8 * h) * ldf + col)
                       : 0u;
    }
    uint32_t packed[kChunk][2];
    float sums[kChunk][2];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int j = j0 + jj;
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
        if (fac) {
          const __nv_bfloat162 fv =
              *reinterpret_cast<const __nv_bfloat162*>(&f[jj][h]);
          v0 = __fmul_rn(v0, __low2float(fv));
          v1 = __fmul_rn(v1, __high2float(fv));
        }
        s0 += v0;
        s1 += v1;
        const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
        packed[jj][h] = *reinterpret_cast<const uint32_t*>(&p);
      }
      sums[jj][0] = s0;
      sums[jj][1] = s1;
    }
    warp_colsum8(sums, cp, j0);
#pragma unroll
    for (int jj = 0; jj < kChunk; jj += 2)
      stsm_x4(smem_u32(tile_at(tile, srow, 8 * (j0 + jj + (m >> 1)))),
              packed[jj][0], packed[jj][1], packed[jj + 1][0],
              packed[jj + 1][1]);
  }
}

// A consumer warpgroup: its 64 rows from row0 through the whole row pass.
// T: its W-wide tile, or at a split width the three half tiles' base; pb:
// its bias partials (shared memory, or at a split width the CTA's row of
// pbias).
template <int W>
__device__ __forceinline__ void ws_bwd_consume(const SirenTrainArgs& a,
                                               const SirenBwdMaps& mp,
                                               FwdRing& r, unsigned char* T,
                                               unsigned char* S,
                                               float* colpart, float* pb,
                                               uint64_t* loaded, int wg) {
  constexpr bool kSplit = FwdTraits<W>::kSplit;
  constexpr int Wh = W / 2, NS = head_n(W), LDC = W + 4;
  // dyr's first column in T: past s_r where that is a block's start or
  // inside block 0; at W = 192 over s_r, once its copy to xs has read it
  // (dfeat's A, 96 columns from column 96, would cross a block inside a
  // 64-K stage, which fwd_product's descriptors do not step over)
  constexpr int kDyr = (Wh % 64 == 0 || Wh < 64) ? Wh : 0;
  const Siren& m = a.m;
  const int L = m.n_layers;
  const int t = threadIdx.x & 127, lane = t & 31, warp = t >> 5;
  const int row0 = blockIdx.x * FwdTraits<W>::kCtaRows + 64 * wg;
  const int bar = 1 + wg;
  const int XW = 2 * kInPad + 2 * W, DYW = L * W + 2 * W + 16;
  SplitActs<W> tl(T);         // the half tiles (a split width only)
  const int xs_ss = 2 * kInPad, xs_feat = xs_ss + Wh, xs_sr = xs_feat + W;
  const int dy_s = L * W, dy_f = dy_s + Wh, dy_r = dy_f + W;
  const int dy_sig = dy_r + Wh;
  // stmatrix: lane l addresses row l % 8 of 8 x 8 block m = l / 8 of the
  // four (column block j + sm / 2, row half sm % 2) that one x4 stores
  const int sm = lane >> 3;
  const int srow = 16 * warp + 8 * (sm & 1) + (lane & 7);
  const int qrow = 16 * warp + (lane >> 2);    // rows qrow + 8 h
  // this warp's row of the column sums; pb: this consumer's bias partials
  auto cp_row = [&]() { return colpart + warp * LDC; };
  auto combine = [&](int n, float* dst) {
    colsums_combine(colpart, LDC, n, dst, bar);
  };
  // T's last TMA store has read it and every warp's products have retired
  auto tile_free = [&]() {
    if (r.lead) bulk_wait_read<0>();
    named_bar(bar, 128);
  };
  auto tile_written = [&]() {
    fence_proxy_async();
    named_bar(bar, 128);
  };

  if (r.lead) {              // h_{L-1}; at a split width into (in0, in1)
    unsigned char* h = kSplit ? tl.tile(tl.in0) : T;
    static_assert(!kSplit || SplitActs<W>::kBytes == (W / 128) * kBlock,
                  "in1 follows in0");
    mbar_arrive_expect_tx(loaded, (W / 64) * kBlock);
    for (int q = 0; q < W / 64; ++q)
      tma_load_2d(h + q * kBlock, &mp.acts, loaded, (L - 1) * W + 64 * q,
                  row0);
  }
  for (int e = t; e < 64 * 4; e += 128) {      // x | d to xs
    const int row = e >> 2, c = e & 3, g = row0 + row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g < a.N)
      v = reinterpret_cast<const uint4*>(c < 2 ? a.x : a.d)[(size_t)g * 2 +
                                                            (c & 1)];
    *reinterpret_cast<uint4*>(a.xs + (size_t)g * XW + 8 * c) = v;
  }
  // the rows' directions and output cotangents: at a split width loaded
  // where the rgb head uses them (held from here, beside its W / 4
  // accumulators, they spill at 384), sigma's read where it is used
  float dir[2][3], dout[2][4];
  auto load_rows = [&]() {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = row0 + qrow + 8 * h;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        dir[h][k] = g < a.N ? __bfloat162float(a.d[(size_t)g * kInPad + k])
                            : 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dout[h][c] = g < a.N ? a.dout[(size_t)g * 4 + c] : 0.f;
    }
  };
  auto dout_sigma = [&](int h) {
    if constexpr (kSplit) {
      const int g = row0 + qrow + 8 * h;
      return g < a.N ? a.dout[(size_t)g * 4 + 3] : 0.f;
    } else {
      return dout[h][3];
    }
  };
  if constexpr (!kSplit) load_rows();
  mbar_wait(loaded, 0);

  // Each product's accumulators live in their own scope: an array left
  // live across a later product would hold its registers through it.
  // sigma head: ys = h W_s0 + b_s0; s_s into S, cos(ys) over the
  // accumulators, this thread's sigma_pre partial dots
  {
    float acc_s[NS / 2];
    if constexpr (kSplit)
      split_product<W>(acc_s, tl, r);
    else
      fwd_product(acc_s, smem_u32(T), W, true, r);
    const float* b_s0 = m.bpack + m.ob_s0();
    const bf16* w_s1 = m.ws1();
    float sp[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < Wh / 8; j += 2) {
      uint32_t packed[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 8 * (j + jj) + 2 * (lane & 3);
        const float b0 = b_s0[col], b1 = b_s0[col + 1];
        const float w0 = __bfloat162float(w_s1[col]);
        const float w1 = __bfloat162float(w_s1[col + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& c0 = acc_s[4 * (j + jj) + 2 * h];
          float& c1 = acc_s[4 * (j + jj) + 2 * h + 1];
          const float y0 = __fadd_rn(c0, b0), y1 = __fadd_rn(c1, b1);
          const __nv_bfloat162 p =
              __floats2bfloat162_rn(sin_fast(y0), sin_fast(y1));
          packed[jj][h] = *reinterpret_cast<const uint32_t*>(&p);
          sp[h] += __low2float(p) * w0 + __high2float(p) * w1;
          c0 = cos_fast(y0);
          c1 = cos_fast(y1);
        }
      }
      stsm_x4(smem_u32(tile_at(S, srow, 8 * (j + (sm >> 1)))), packed[0][0],
              packed[0][1], packed[1][0], packed[1][1]);
    }
    tile_written();
    store_cols(&mp.xs, S, 0, Wh, a.xs, XW, xs_ss, row0, r.lead);
    float dsig[2], dsig_b[2];
    const float b_s1 = m.bpack[m.ob_s1()];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = quad_sum(sp[h]) + b_s1;
      dsig[h] = v > 0.f ? dout_sigma(h) : 0.f;  // 0 past N
      dsig_b[h] = __bfloat162float(__float2bfloat16_rn(dsig[h]));
    }
    // dys = (dsig_b w_s1) cos(ys) over s_s in S, once its store has read
    // it and every thread has copied it
    tile_free();
    float* cp = cp_row();
#pragma unroll
    for (int j = 0; j < Wh / 8; j += 2) {
      uint32_t packed[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 8 * (j + jj) + 2 * (lane & 3);
        const float w0 = __bfloat162float(w_s1[col]);
        const float w1 = __bfloat162float(w_s1[col + 1]);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float v0 =
              __fmul_rn(__fmul_rn(dsig_b[h], w0), acc_s[4 * (j + jj) + 2 * h]);
          const float v1 = __fmul_rn(__fmul_rn(dsig_b[h], w1),
                                     acc_s[4 * (j + jj) + 2 * h + 1]);
          s0 += v0;
          s1 += v1;
          const __nv_bfloat162 p = __floats2bfloat162_rn(v0, v1);
          packed[jj][h] = *reinterpret_cast<const uint32_t*>(&p);
        }
        warp_colsum(s0, s1, cp, col);
      }
      stsm_x4(smem_u32(tile_at(S, srow, 8 * (j + (sm >> 1)))), packed[0][0],
              packed[0][1], packed[1][0], packed[1][1]);
    }
    warp_rowsum(dsig, cp, Wh);
    if ((lane & 3) == 0) {                     // dsig_b as a dY operand
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(dsig_b[h], 0.f);
        uint4* dst = reinterpret_cast<uint4*>(
            a.dy + (size_t)(row0 + qrow + 8 * h) * DYW + dy_sig);
        dst[0] = make_uint4(*reinterpret_cast<const uint32_t*>(&p), 0u, 0u,
                            0u);
      }
    }
    tile_written();
    store_cols(&mp.dy, S, 0, Wh, a.dy, DYW, dy_s, row0, r.lead);
    combine(Wh + 1, pb + m.ob_s0());           // b_s0, then b_s1
  }

  if constexpr (kSplit) {  // feat's halves, each to xs; (in0, in1) after
    float acc[W / 4], unused[2] = {0.f, 0.f};
    for (int n = 0; n < 2; ++n) {
      split_product<W>(acc, tl, r);
      split_epilogue<W>(acc, tl, n, m.bpack + m.ob_f() + n * Wh,
                        ReluAct{false}, nullptr, unused, bar, r.lead, &mp.xs,
                        xs_feat + n * Wh, row0);
    }
    tl.advance();
  } else {  // feat = bf16(h W_f + b_f) over h in T
    {
      float acc[W / 2], unused[2] = {0.f, 0.f};
      fwd_product(acc, smem_u32(T), W, true, r);
      named_bar(bar, 128);
      fwd_epilogue(acc, m.bpack + m.ob_f(), ReluAct{false}, T, nullptr,
                   unused);
    }
    tile_written();
    store_cols(&mp.xs, T, 0, W, a.xs, XW, xs_feat, row0, r.lead);
  }

  // rgb head: yr = feat W_r0f + d W_r0d + b_r0; s_r into T[:, :Wh] (at a
  // split width the free tile), cos(yr) over the accumulators, rgb, drgb,
  // dyr into T[:, Wh:] (over feat's first half)
  unsigned char* const sr_tile = kSplit ? tl.tile(tl.spare) : T;
  unsigned char* const dyr_tile = kSplit ? tl.tile(tl.in0) : T;
  constexpr int kDyrCol = kSplit ? 0 : kDyr;
  {
    float acc_s[NS / 2];
    if constexpr (kSplit)
      split_product<W>(acc_s, tl, r);
    else
      fwd_product(acc_s, smem_u32(T), W, true, r);
    tile_free();
    if constexpr (kSplit) load_rows();
    const float* b_r0 = m.bpack + m.ob_r0();
    const bf16* w_r0d = m.wr0d();
    const bf16* w_r1 = m.wr1();
    float rp[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < Wh / 8; j += 2) {
      uint32_t packed[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 8 * (j + jj) + 2 * (lane & 3);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float wd[3], wr[3];
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            wd[k] = __bfloat162float(w_r0d[k * Wh + col + e]);
            wr[k] = __bfloat162float(w_r1[3 * (col + e) + k]);
          }
          const float b = b_r0[col + e];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float& c = acc_s[4 * (j + jj) + 2 * h + e];
            const float dterm =
                __fadd_rn(__fadd_rn(__fmul_rn(dir[h][0], wd[0]),
                                    __fmul_rn(dir[h][1], wd[1])),
                          __fmul_rn(dir[h][2], wd[2]));
            const float y = __fadd_rn(__fadd_rn(c, dterm), b);
            const bf16 sb = __float2bfloat16_rn(sin_fast(y));
            const float sv = __bfloat162float(sb);
#pragma unroll
            for (int k = 0; k < 3; ++k) rp[h][k] += sv * wr[k];
            c = cos_fast(y);
            const uint32_t bits = __bfloat16_as_ushort(sb);
            packed[jj][h] = e == 0 ? bits : (packed[jj][h] | (bits << 16));
          }
        }
      }
      stsm_x4(smem_u32(tile_at(sr_tile, srow, 8 * (j + (sm >> 1)))),
              packed[0][0], packed[0][1], packed[1][0], packed[1][1]);
    }
    tile_written();
    store_cols(&mp.xs, sr_tile, 0, Wh, a.xs, XW, xs_sr, row0, r.lead);
    const float* b_r1 = m.bpack + m.ob_r1();
    float drgb[3][2], drgb_b[2][3];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = quad_sum(rp[h][c]) + b_r1[c];
        const float rr = 1.f / (1.f + expf(-v));
        drgb[c][h] = dout[h][c] * rr * (1.f - rr);     // 0 past N
        drgb_b[h][c] = __bfloat162float(__float2bfloat16_rn(drgb[c][h]));
      }
    if (!kSplit && kDyr == 0) tile_free();
    float* cp = cp_row();
#pragma unroll
    for (int j = 0; j < Wh / 8; j += 2) {
      uint32_t packed[2][2];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int col = 8 * (j + jj) + 2 * (lane & 3);
        float s[2] = {0.f, 0.f}, v[2][2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float w0 = __bfloat162float(w_r1[3 * (col + e)]);
          const float w1 = __bfloat162float(w_r1[3 * (col + e) + 1]);
          const float w2 = __bfloat162float(w_r1[3 * (col + e) + 2]);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float p = __fadd_rn(
                __fadd_rn(__fmul_rn(drgb_b[h][0], w0),
                          __fmul_rn(drgb_b[h][1], w1)),
                __fmul_rn(drgb_b[h][2], w2));
            v[h][e] = __fmul_rn(p, acc_s[4 * (j + jj) + 2 * h + e]);
            s[e] += v[h][e];
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 p = __floats2bfloat162_rn(v[h][0], v[h][1]);
          packed[jj][h] = *reinterpret_cast<const uint32_t*>(&p);
        }
        warp_colsum(s[0], s[1], cp, col);
      }
      stsm_x4(smem_u32(tile_at(dyr_tile, srow,
                               kDyrCol + 8 * (j + (sm >> 1)))),
              packed[0][0], packed[0][1], packed[1][0], packed[1][1]);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) warp_rowsum(drgb[c], cp, Wh + c);
    if ((lane & 3) == 0) {                     // drgb_b as a dY operand
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 p0 =
            __floats2bfloat162_rn(drgb_b[h][0], drgb_b[h][1]);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(drgb_b[h][2], 0.f);
        uint4* dst = reinterpret_cast<uint4*>(
            a.dy + (size_t)(row0 + qrow + 8 * h) * DYW + dy_sig + 8);
        dst[0] = make_uint4(*reinterpret_cast<const uint32_t*>(&p0),
                            *reinterpret_cast<const uint32_t*>(&p1), 0u, 0u);
      }
    }
    tile_written();
    store_cols(&mp.dy, dyr_tile, kDyrCol, Wh, a.dy, DYW, dy_r, row0,
               r.lead);
    combine(Wh + 3, pb + m.ob_r0());           // b_r0, then b_r1
  }
  if constexpr (kSplit) {
    // dfeat = dyr_b W_r0f^T: its halves over feat's second half (in1) and
    // s_r (spare), which then hold the products' input
    float acc[W / 4];
    for (int n = 0; n < 2; ++n) {
      unsigned char* out = tl.tile(n == 0 ? tl.in1 : tl.spare);
      fwd_product(acc, smem_u32(dyr_tile), Wh, true, r);
      tile_free();
      cot_epilogue(acc, nullptr, 0, out, cp_row() + n * Wh);
      tile_written();
      store_cols(&mp.dy, out, 0, Wh, a.dy, DYW, dy_f + n * Wh, row0,
                 r.lead);
    }
    combine(W, pb + m.ob_f());
    const int free_tile = tl.in0;              // dyr's
    tl.in0 = tl.in1;
    tl.in1 = tl.spare;
    tl.spare = free_tile;
    // dy_{L-1} = (dfeat_b W_f^T + dys_b W_s0^T) * factor_{L-1}, then
    // dy_{i-1} = (dy_i_b W_i^T) * factor_{i-1}, each half by half
    const bf16* fac = a.acts + (size_t)(row0)*a.lda + (size_t)L * W;
    for (int i = L; i >= 1; --i) {
      for (int n = 0; n < 2; ++n) {
        split_product<W>(acc, tl, r);
        if (i == L) fwd_product(acc, smem_u32(S), Wh, false, r);
        tile_free();
        cot_epilogue(acc, fac + (size_t)(i - 1) * W + n * Wh, a.lda,
                     tl.out(n), cp_row() + n * Wh);
        tile_written();
        store_cols(&mp.dy, tl.out(n), 0, Wh, a.dy, DYW,
                   (i - 1) * W + n * Wh, row0, r.lead);
      }
      combine(W, pb + (i - 1) * W);
      tl.advance();
    }
  } else {
    // dfeat = dyr_b W_r0f^T over T (feat has no activation)
    float acc[W / 2];
    const uint32_t t_a = smem_u32(T);
    fwd_product(acc, t_a + (kDyr / 64) * kBlock + (kDyr % 64) * 2, Wh, true,
                r);
    tile_free();
    cot_epilogue(acc, nullptr, 0, T, cp_row());
    tile_written();
    store_cols(&mp.dy, T, 0, W, a.dy, DYW, dy_f, row0, r.lead);
    combine(W, pb + m.ob_f());

    // dy_{L-1} = (dfeat_b W_f^T + dys_b W_s0^T) * factor_{L-1}, then
    // dy_{i-1} = (dy_i_b W_i^T) * factor_{i-1}
    const bf16* fac = a.acts + (size_t)(row0)*a.lda + (size_t)L * W;
    for (int i = L; i >= 1; --i) {
      fwd_product(acc, t_a, W, true, r);
      if (i == L) fwd_product(acc, smem_u32(S), Wh, false, r);
      tile_free();
      cot_epilogue(acc, fac + (size_t)(i - 1) * W, a.lda, T, cp_row());
      tile_written();
      store_cols(&mp.dy, T, 0, W, a.dy, DYW, (i - 1) * W, row0, r.lead);
      combine(W, pb + (i - 1) * W);
    }
  }
  if (r.lead) bulk_wait<0>();                 // every store has landed
}

// The split kernel's body: the ring of W / 2-wide stages, the three half
// tiles, S, the column sums, the barriers; the consumer's bias partials go
// to pbias[blockIdx] (n_bias columns).
template <int W>
__device__ __forceinline__ void bwd_rows_split_body(const SirenBwdMaps& mp,
                                                    const SirenTrainArgs& a,
                                                    int n_stages, int n_bias,
                                                    unsigned char* ring) {
  constexpr int Wh = W / 2;
  unsigned char* tiles = ring + n_stages * Wh * 128;
  unsigned char* S = tiles + 3 * Wh * 128;
  float* colpart =
      reinterpret_cast<float*>(S + enc_blocks(Wh) * kBlock);
  uint64_t* full = reinterpret_cast<uint64_t*>(colpart + 4 * (W + 4));
  uint64_t* empty = full + n_stages;
  uint64_t* loaded = empty + n_stages;
  fwd_init_barriers(full, empty, n_stages, loaded, 1, 1);
  __syncthreads();
  if (threadIdx.x >= 128) {                        // the producer
    if (threadIdx.x == 128)
      ws_bwd_produce<W>(mp, a.m.n_layers, ring, full, empty, n_stages);
    return;
  }
  FwdRing r{smem_u32(ring), Wh * 128, full, empty, n_stages, 0,
            threadIdx.x == 0};
  ws_bwd_consume<W>(a, mp, r, tiles, S, colpart,
                    a.pbias + (size_t)blockIdx.x * n_bias, loaded, 0);
}

// The kernel's body at a width of whole-row consumers (up to 256): the
// ring, each consumer's T, S, column sums and bias partials, the barriers;
// the two consumers' partials added in order into pbias[blockIdx].
template <int W>
__device__ __forceinline__ void bwd_rows_whole_body(const SirenBwdMaps& mp,
                                                    const SirenTrainArgs& a,
                                                    int n_stages, int n_bias,
                                                    unsigned char* ring) {
  unsigned char* T = ring + n_stages * W * 128;
  unsigned char* S = T + kFwdConsumers * W * 128;
  float* colpart = reinterpret_cast<float*>(
      S + kFwdConsumers * enc_blocks(W / 2) * kBlock);
  float* bias = colpart + kFwdConsumers * 4 * (W + 4);
  uint64_t* full = reinterpret_cast<uint64_t*>(bias + kFwdConsumers *
                                                          n_bias);
  uint64_t* empty = full + n_stages;
  uint64_t* loaded = empty + n_stages;
  fwd_init_barriers(full, empty, n_stages, loaded, kFwdConsumers);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kFwdConsumers) {                       // the producer
    setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == 128 * kFwdConsumers)
      ws_bwd_produce<W>(mp, a.m.n_layers, ring, full, empty, n_stages);
    return;
  }
  setmaxnreg_inc<kFwdConsumerRegs>();
  FwdRing r{smem_u32(ring), W * 128, full, empty, n_stages, 0,
            (threadIdx.x & 127) == 0};
  ws_bwd_consume<W>(a, mp, r, T + wg * W * 128,
                    S + wg * enc_blocks(W / 2) * kBlock,
                    colpart + wg * 4 * (W + 4), bias + wg * n_bias,
                    &loaded[wg], wg);
  // both consumers' bias partials, added in order
  named_bar(kBwdBoth, 128 * kFwdConsumers);
  float* pb = a.pbias + (size_t)blockIdx.x * n_bias;
  for (int c = threadIdx.x; c < n_bias; c += 128 * kFwdConsumers)
    pb[c] = bias[c] + bias[n_bias + c];
}

// grid: one CTA per 128 rows (64 at a split width); block: the consumer
// warpgroups + the producer's (FwdTraits<W>).
template <int W>
__global__ void __launch_bounds__(FwdTraits<W>::kThreads, 1)
    siren_bwd_rows_ws_kernel(const __grid_constant__ SirenBwdMaps mp,
                             SirenTrainArgs a, int n_stages) {
  extern __shared__ unsigned char bwd_ws_smem_raw[];
  unsigned char* ring = bwd_ws_smem_raw +
                        ((1024 - (smem_u32(bwd_ws_smem_raw) & 1023)) & 1023);
  const int L = a.m.n_layers, n_bias = L * W + W / 2 + 1 + W + W / 2 + 3;
  if constexpr (FwdTraits<W>::kSplit)
    bwd_rows_split_body<W>(mp, a, n_stages, n_bias, ring);
  else
    bwd_rows_whole_body<W>(mp, a, n_stages, n_bias, ring);
}

template <int W>
cudaError_t launch_bwd_rows_ws(const SirenTrainArgs& a, int n_blocks,
                               cudaStream_t st) {
  const int L = a.m.n_layers, n_pad = n_blocks * kRows;
  const int XW = 2 * kInPad + 2 * W, DYW = L * W + 2 * W + 16;
  SirenBwdMaps mp;
  if (!encode_siren_head_maps(&mp.s0, &mp.f, &mp.r0, a.m.wpack, L, W) ||
      !encode_bf16_map(&mp.wt, a.wtpack, (L + 1) * W, W, W, 64) ||
      !encode_bf16_map(&mp.acts, a.acts, n_pad, a.lda, a.lda, 64) ||
      !encode_bf16_map(&mp.xs, a.xs, n_pad, XW, XW, 64) ||
      !encode_bf16_map(&mp.dy, a.dy, n_pad, DYW, DYW, 64))
    return cudaErrorInvalidValue;
  const int n_bias = siren_n_bias(L, W);
  const int n_stages = ws_bwd_stages<W>(n_bias);
  if (n_stages == 0) return cudaErrorInvalidValue;
  const size_t smem = ws_bwd_smem_bytes<W>(n_stages, n_bias);
  cudaError_t err = cudaFuncSetAttribute(
      siren_bwd_rows_ws_kernel<W>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  using T = FwdTraits<W>;
  siren_bwd_rows_ws_kernel<W>
      <<<n_blocks * (kRows / T::kCtaRows), T::kThreads, smem, st>>>(mp, a,
                                                                    n_stages);
  return cudaGetLastError();
}

// ---- the saved-mode row pass at the streamed widths ----------------------
//
// siren_bwd_rows_kernel_stream: the outputs of siren_bwd_rows_ws_kernel
// (xs, dy, pbias) on kernel 6's streamed shape (mlp_train.cu
// mlp_train_bwd_rows_kernel_stream): 64-row CTAs of one warpgroup, every
// product streaming its A operand and its weights by cp.async through
// train_common.cuh's ring (stream_rows_gemm), 128 output columns at a time
// through the tile C to where the weight-gradient pass reads them, each
// chunk's column sums of the f32 values to the bias partials (the four
// warps' in order, pbias[blockIdx] of n_pad / 64 rows). In walk order:
//   - x | d to xs; the rows' directions and output cotangents to
//     registers (rows 16 warp + lane / 4 + 8 h, the accumulator's);
//   - ys = h_{L-1} W_s0 + b_s0 (h from the acts stream), chunk by chunk:
//     s_s to xs and this thread's sigma partial dots; then sigma_pre, dsig
//     (the sigma_pre > 0 gate) and dsig_b, and the same chunks again for
//     dys = (dsig_b w_s1) cos(ys) to dy: a second product, where the other
//     widths keep cos(ys) in registers (here Wh / 2 = 256 of them a thread
//     at 1024);
//   - feat = bf16(h W_f + b_f) to xs (stream_rows_product);
//   - yr = feat W_r0f + d W_r0d + b_r0 (feat back from xs, the directions'
//     term the rank-3 update of the other widths): s_r to xs and the rgb
//     partial dots; drgb and drgb_b; the chunks again for dyr = (drgb_b
//     w_r1^T) cos(yr) to dy;
//   - dfeat = dyr_b W_r0f^T to dy, then dy_{L-1} = (dfeat_b W_f^T + dys_b
//     W_s0^T) * factor_{L-1} and dy_{i-1} = (dy_i_b W_i^T) * factor_{i-1}
//     to dy, each chunk's bf16 factors a_i cos(a_i y_i) prefetched from
//     the acts stream into C with the product's first stage (where kernel
//     6 prefetches the activations for ReLU').
// The heads' forward products read their weights [K, N] N-major (wgmma's
// transposed B), the cotangent products [N, K] K-major, from wpack alone.
// Per row 2 (L - 1) W^2 + 5.5 W^2 MACs (the two heads' products run twice)
// against ~4 W bytes of operands a product through L2. Shared memory:
// stream_rows_smem_bytes (the NeRF pass's head floats unused), 2 CTAs an
// SM.

// grid: one CTA per 64 rows up to round_up(N, 128); block: 128 threads.
__global__ void __launch_bounds__(128, 1)
    siren_bwd_rows_kernel_stream(SirenTrainArgs a) {
  constexpr int R = 64, T = 128, NC = kBwdPassCols;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* C = reinterpret_cast<bf16*>(ring + kStreamRowStages *
                                               kStreamRowStageBytes);
  // four warps' column sums of a chunk, where kernel 6's layout has them
  // (past its heads' floats: stream_rows_smem_bytes)
  float* colpart = reinterpret_cast<float*>(C + R * kStreamRowLdc) + 7 * R;
  const Siren& m = a.m;
  const int W = m.width, Wh = W / 2, L = m.n_layers;
  const int tid = threadIdx.x, lane = tid & 31;
  const int qrow = 16 * (tid >> 5) + (lane >> 2);   // rows qrow + 8 h
  const int XW = 2 * kInPad + 2 * W, DYW = L * W + 2 * W + 16;
  const int xs_ss = 2 * kInPad, xs_feat = xs_ss + Wh, xs_sr = xs_feat + W;
  const int dy_s = L * W, dy_f = dy_s + Wh, dy_r = dy_f + W;
  const int dy_sig = dy_r + Wh;
  const int r0 = blockIdx.x * R;
  float* pb = a.pbias + (size_t)blockIdx.x * (L * W + Wh + 1 + W + Wh + 3);
  float* cp = colpart + (tid >> 5) * NC;      // this warp's column sums
  // C's rows out to columns col.. of out (and with pb_off >= 0 the
  // chunk's column sums to pb[pb_off ..]), once every warp has written
  auto chunk_out = [&](bf16* out, int ld, int col, int pb_off) {
    __syncthreads();
    if (pb_off >= 0) store_colsums<T>(colpart, pb, pb_off, NC, NC, 4);
    rows_to_global<R>(C, kStreamRowLdc, out, ld, r0, col, NC);
    __syncthreads();
  };
  auto c_at = [&](int h, int lc) {
    return reinterpret_cast<__nv_bfloat162*>(C + (qrow + 8 * h) *
                                                     kStreamRowLdc + lc);
  };

  for (int e = tid; e < R * 4; e += T) {        // x | d to xs
    const int row = e >> 2, c = e & 3, g = r0 + row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (g < a.N)
      v = reinterpret_cast<const uint4*>(c < 2 ? a.x : a.d)[(size_t)g * 2 +
                                                            (c & 1)];
    *reinterpret_cast<uint4*>(a.xs + (size_t)g * XW + 8 * c) = v;
  }
  float dir[2][3], dout[2][4];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = r0 + qrow + 8 * h;
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dir[h][k] =
          g < a.N ? __bfloat162float(a.d[(size_t)g * kInPad + k]) : 0.f;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      dout[h][c] = g < a.N ? a.dout[(size_t)g * 4 + c] : 0.f;
  }

  // sigma head: ys = h W_s0 + b_s0 (the forward pass, then dys)
  const RowSeg ys_seg[1] = {{a.acts + (L - 1) * W, a.lda, m.ws0(), Wh, W}};
  const float* b_s0 = m.bpack + m.ob_s0();
  const bf16* w_s1 = m.ws1();
  float dsig[2], dsig_b[2];
  {
    float sp[2] = {0.f, 0.f};
    for (int n0 = 0; n0 < Wh; n0 += NC) {
      float acc[64];
      stream_rows_gemm<true>(acc, ys_seg, 1, n0, Wh, r0, ring, nullptr, 0,
                             C);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int lc = 8 * j + 2 * (lane & 3), col = n0 + lc;
        const float b0 = b_s0[col], b1 = b_s0[col + 1];
        const float w0 = __bfloat162float(w_s1[col]);
        const float w1 = __bfloat162float(w_s1[col + 1]);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float y0 = __fadd_rn(acc[4 * j + 2 * h], b0);
          const float y1 = __fadd_rn(acc[4 * j + 2 * h + 1], b1);
          const __nv_bfloat162 p =
              __floats2bfloat162_rn(sin_fast(y0), sin_fast(y1));
          sp[h] += __low2float(p) * w0 + __high2float(p) * w1;
          *c_at(h, lc) = p;
        }
      }
      chunk_out(a.xs, XW, xs_ss + n0, -1);
    }
    const float b_s1 = m.bpack[m.ob_s1()];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v = quad_sum(sp[h]) + b_s1;
      dsig[h] = v > 0.f ? dout[h][3] : 0.f;    // 0 past N
      dsig_b[h] = __bfloat162float(__float2bfloat16_rn(dsig[h]));
    }
  }
  warp_rowsum(dsig, cp, 0);
  if ((lane & 3) == 0) {                       // dsig_b as a dY operand
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(dsig_b[h], 0.f);
      *reinterpret_cast<uint4*>(a.dy + (size_t)(r0 + qrow + 8 * h) * DYW +
                                dy_sig) =
          make_uint4(*reinterpret_cast<const uint32_t*>(&p), 0u, 0u, 0u);
    }
  }
  __syncthreads();
  store_colsums<T>(colpart, pb, m.ob_s1(), 1, NC, 4);     // b_s1
  __syncthreads();
  for (int n0 = 0; n0 < Wh; n0 += NC) {        // dys = (dsig_b w_s1) cos(ys)
    float acc[64];
    stream_rows_gemm<true>(acc, ys_seg, 1, n0, Wh, r0, ring, nullptr, 0, C);
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int lc = 8 * j + 2 * (lane & 3), col = n0 + lc;
      const float b0 = b_s0[col], b1 = b_s0[col + 1];
      const float w0 = __bfloat162float(w_s1[col]);
      const float w1 = __bfloat162float(w_s1[col + 1]);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 =
            __fmul_rn(__fmul_rn(dsig_b[h], w0),
                      cos_fast(__fadd_rn(acc[4 * j + 2 * h], b0)));
        const float v1 =
            __fmul_rn(__fmul_rn(dsig_b[h], w1),
                      cos_fast(__fadd_rn(acc[4 * j + 2 * h + 1], b1)));
        s0 += v0;
        s1 += v1;
        *c_at(h, lc) = __floats2bfloat162_rn(v0, v1);
      }
      warp_colsum(s0, s1, cp, lc);
    }
    chunk_out(a.dy, DYW, dy_s + n0, m.ob_s0() + n0);
  }

  // feat = bf16(h W_f + b_f) to xs
  {
    const RowSeg seg[1] = {{a.acts + (L - 1) * W, a.lda, m.wf(), W, W}};
    stream_rows_product<true>(seg, 1, W, r0, ring, C, nullptr, 0,
                              RowChunkOut{m.bpack + m.ob_f(), false, false,
                                          nullptr, nullptr, nullptr},
                              a.xs, XW, xs_feat, nullptr, 0);
  }

  // rgb head: yr = feat W_r0f + d W_r0d + b_r0 (the forward pass, then dyr)
  const RowSeg yr_seg[1] = {{a.xs + xs_feat, XW, m.wr0f(), Wh, W}};
  const float* b_r0 = m.bpack + m.ob_r0();
  const bf16* w_r0d = m.wr0d();
  const bf16* w_r1 = m.wr1();
  // yr of element e (column col) of this thread's row h, from acc
  auto yr_of = [&](float v, int h, int col) {
    const float dterm = __fadd_rn(
        __fadd_rn(__fmul_rn(dir[h][0], __bfloat162float(w_r0d[col])),
                  __fmul_rn(dir[h][1], __bfloat162float(w_r0d[Wh + col]))),
        __fmul_rn(dir[h][2], __bfloat162float(w_r0d[2 * Wh + col])));
    return __fadd_rn(__fadd_rn(v, dterm), b_r0[col]);
  };
  float drgb_b[2][3];
  {
    float rp[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
    for (int n0 = 0; n0 < Wh; n0 += NC) {
      float acc[64];
      stream_rows_gemm<true>(acc, yr_seg, 1, n0, Wh, r0, ring, nullptr, 0,
                             C);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int lc = 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float sv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + lc + e;
            sv[e] = __bfloat162float(__float2bfloat16_rn(
                sin_fast(yr_of(acc[4 * j + 2 * h + e], h, col))));
#pragma unroll
            for (int k = 0; k < 3; ++k)
              rp[h][k] += sv[e] * __bfloat162float(w_r1[3 * col + k]);
          }
          *c_at(h, lc) = __floats2bfloat162_rn(sv[0], sv[1]);
        }
      }
      chunk_out(a.xs, XW, xs_sr + n0, -1);
    }
    const float* b_r1 = m.bpack + m.ob_r1();
    float drgb[3][2];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float v = quad_sum(rp[h][c]) + b_r1[c];
        const float rr = 1.f / (1.f + expf(-v));
        drgb[c][h] = dout[h][c] * rr * (1.f - rr);     // 0 past N
        drgb_b[h][c] = __bfloat162float(__float2bfloat16_rn(drgb[c][h]));
      }
#pragma unroll
    for (int c = 0; c < 3; ++c) warp_rowsum(drgb[c], cp, c);
  }
  if ((lane & 3) == 0) {                       // drgb_b as a dY operand
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 p0 =
          __floats2bfloat162_rn(drgb_b[h][0], drgb_b[h][1]);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(drgb_b[h][2], 0.f);
      *reinterpret_cast<uint4*>(a.dy + (size_t)(r0 + qrow + 8 * h) * DYW +
                                dy_sig + 8) =
          make_uint4(*reinterpret_cast<const uint32_t*>(&p0),
                     *reinterpret_cast<const uint32_t*>(&p1), 0u, 0u);
    }
  }
  __syncthreads();
  store_colsums<T>(colpart, pb, m.ob_r1(), 3, NC, 4);     // b_r1
  __syncthreads();
  for (int n0 = 0; n0 < Wh; n0 += NC) {   // dyr = (drgb_b w_r1^T) cos(yr)
    float acc[64];
    stream_rows_gemm<true>(acc, yr_seg, 1, n0, Wh, r0, ring, nullptr, 0, C);
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int lc = 8 * j + 2 * (lane & 3);
      float s[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + lc + e;
          const float p = __fadd_rn(
              __fadd_rn(
                  __fmul_rn(drgb_b[h][0], __bfloat162float(w_r1[3 * col])),
                  __fmul_rn(drgb_b[h][1],
                            __bfloat162float(w_r1[3 * col + 1]))),
              __fmul_rn(drgb_b[h][2], __bfloat162float(w_r1[3 * col + 2])));
          v[e] = __fmul_rn(p, cos_fast(yr_of(acc[4 * j + 2 * h + e], h,
                                             col)));
          s[e] += v[e];
        }
        *c_at(h, lc) = __floats2bfloat162_rn(v[0], v[1]);
      }
      warp_colsum(s[0], s[1], cp, lc);
    }
    chunk_out(a.dy, DYW, dy_r + n0, m.ob_r0() + n0);
  }

  // dfeat = dyr_b W_r0f^T (feat has no activation)
  {
    const RowSeg seg[1] = {{a.dy + dy_r, DYW, m.wr0f(), Wh, Wh}};
    stream_rows_product<false>(seg, 1, W, r0, ring, C, nullptr, 0,
                               RowChunkOut{nullptr, false, false, nullptr,
                                           nullptr, colpart},
                               a.dy, DYW, dy_f, pb, m.ob_f());
  }
  // dy_{L-1} = (dfeat_b W_f^T + dys_b W_s0^T) * factor_{L-1}, then dy_{i-1}
  // = (dy_i_b W_i^T) * factor_{i-1}, the factors prefetched into C
  for (int i = L; i >= 1; --i) {
    const RowSeg segs[2] = {
        i == L ? RowSeg{a.dy + dy_f, DYW, m.wf(), W, W}
               : RowSeg{a.dy + i * W, DYW, m.t(i), W, W},
        {a.dy + dy_s, DYW, m.ws0(), Wh, Wh}};
    const bf16* fac = a.acts + (size_t)(L + i - 1) * W;
    for (int n0 = 0; n0 < W; n0 += NC) {
      float acc[64];
      stream_rows_gemm<false>(acc, segs, i == L ? 2 : 1, n0, W, r0, ring,
                              fac, a.lda, C);
#pragma unroll
      for (int j = 0; j < NC / 8; ++j) {
        const int lc = 8 * j + 2 * (lane & 3);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 f = *c_at(h, lc);
          const float v0 = __fmul_rn(acc[4 * j + 2 * h], __low2float(f));
          const float v1 =
              __fmul_rn(acc[4 * j + 2 * h + 1], __high2float(f));
          s0 += v0;
          s1 += v1;
          *c_at(h, lc) = __floats2bfloat162_rn(v0, v1);
        }
        warp_colsum(s0, s1, cp, lc);
      }
      chunk_out(a.dy, DYW, (i - 1) * W + n0, (i - 1) * W + n0);
    }
  }
}

// The streamed row pass's ring (ops/kernels/siren.py::siren_stages
// mirrors it), or 0 if it does not fit.
int stream_rows_stages() {
  return stream_rows_smem_bytes() <= kMaxSmem ? kStreamRowStages : 0;
}

cudaError_t launch_bwd_rows_stream(const SirenTrainArgs& a, int n_blocks,
                                   cudaStream_t st) {
  const size_t smem = stream_rows_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      siren_bwd_rows_kernel_stream,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  siren_bwd_rows_kernel_stream<<<n_blocks * (kRows / 64), 128, smem, st>>>(
      a);
  return cudaGetLastError();
}

// The ring launch_fwd_ws (kernel 0: saved mode, 1: without acts) or
// launch_bwd_rows_ws (2) runs at width W with L layers.
template <int W>
int ws_stages(int kernel, int L) {
  if (kernel == 2) return ws_bwd_stages<W>(siren_n_bias(L, W));
  return fwd_stages(W, kInPad, 0, fwd_ws_extra<W>(kernel == 0));
}

void fill_args(SirenTrainArgs& a, const void* x, const void* d,
               const void* wpack, const void* bpack, const void* alphas,
               int n, int n_layers, int width) {
  a = SirenTrainArgs{};
  a.x = static_cast<const bf16*>(x);
  a.d = static_cast<const bf16*>(d);
  a.m = Siren{static_cast<const bf16*>(wpack),
              static_cast<const float*>(bpack),
              static_cast<const float*>(alphas), n_layers, width};
  a.N = n;
}

}  // namespace
}  // namespace fsnerf

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors validated by the Python wrapper (ops/kernels/siren.py), which also
// allocates every output and scratch buffer. Each launches on `stream` and
// returns cudaGetLastError() (0 = launched).

// out [n, 4]; acts [round_up(n, 128), 2 n_layers width] or null; at the
// streamed widths slab [slab_ctas * 64, 2 width] bf16
// scratch (null elsewhere).
extern "C" int fsnerf_siren_fwd(const void* x, const void* d,
                                const void* wpack, const void* bpack,
                                const void* alphas, void* out, void* acts,
                                void* slab, int slab_ctas, int n,
                                int n_layers, int width, void* stream) {
  using namespace fsnerf;
  SirenTrainArgs a;
  fill_args(a, x, d, wpack, bpack, alphas, n, n_layers, width);
  a.out = static_cast<float*>(out);
  a.acts = static_cast<bf16*>(acts);
  a.lda = 2 * n_layers * width;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (siren_n_w(n_layers, width) > kMaxPackedWeights)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (n + kRows - 1) / kRows;
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  // widths 64, 128, 192 and 256 on the warp-specialized kernel, 384 and
  // 512 on its column-split shape, the streamed widths on the streamed one,
  // others (multiples of 32 up to 320) on siren_fwd_kernel
  if (stream_width(width))
    return static_cast<int>(launch_fwd_stream(
        a, static_cast<const bf16*>(slab), slab_ctas, st));
  switch (width) {
    case 64:
      return static_cast<int>(launch_fwd_ws<64>(a, n_blocks, st));
    case 128:
      return static_cast<int>(launch_fwd_ws<128>(a, n_blocks, st));
    case 192:
      return static_cast<int>(launch_fwd_ws<192>(a, n_blocks, st));
    case 256:
      return static_cast<int>(launch_fwd_ws<256>(a, n_blocks, st));
    case 384:
      return static_cast<int>(launch_fwd_ws<384>(a, n_blocks, st));
    case 512:
      return static_cast<int>(launch_fwd_ws<512>(a, n_blocks, st));
    default:
      break;
  }
  const size_t smem = fwd_smem_bytes(width);
  cudaError_t err = cudaFuncSetAttribute(
      siren_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  siren_fwd_kernel<<<n_blocks, kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dw [n_w] (bf16-rounded) and db [n_b] (f32) in the wpack / bpack layouts.
// Saved mode (cfs and fwd_out null): acts is the forward's [n_pad, lda = 2
// L W] stream. Recompute mode up to width 256 (cfs given): acts [n_pad, lda
// = L W] bf16 and cfs [n_pad, L W] f32 are scratch the row pass writes.
// Recompute mode from 384 up (fwd_out given, [n, 4] f32 scratch): the
// forward kernel first writes acts [n_pad, lda = 2 L W] (its bf16
// factors; at the streamed widths through slab, [slab_ctas * 64, 2 W] bf16
// scratch), then the saved mode's passes run. xs, dy, pbias ([n_pad / R,
// n_b]: R = 128, or 64 from 384 up) and part are scratch of the shapes
// documented in SirenTrainArgs and train_common.cuh::dw_gemm_kernel; jobs
// [n_jobs, 6] and tiles [n_tiles, 3] int32 (ops/kernels/siren.py::dw_jobs).
extern "C" int fsnerf_siren_bwd(
    const void* x, const void* d, const void* dout, const void* wpack,
    const void* bpack, const void* wtpack, const void* alphas, void* acts,
    int lda, void* cfs, void* fwd_out, void* slab, int slab_ctas, void* xs,
    void* dy, void* pbias, const void* jobs, const void* tiles, int n_tiles,
    void* part, int split_rows, void* dw, void* db, int n, int n_layers,
    int width, void* stream) {
  using namespace fsnerf;
  SirenTrainArgs a;
  fill_args(a, x, d, wpack, bpack, alphas, n, n_layers, width);
  a.wtpack = static_cast<const bf16*>(wtpack);
  a.acts = static_cast<bf16*>(acts);
  a.lda = lda;
  a.cfs = static_cast<float*>(cfs);
  a.recompute = cfs != nullptr;
  a.dout = static_cast<const float*>(dout);
  a.xs = static_cast<bf16*>(xs);
  a.dy = static_cast<bf16*>(dy);
  a.pbias = static_cast<float*>(pbias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (siren_n_w(n_layers, width) > kMaxPackedWeights)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_blocks = (n + kRows - 1) / kRows;
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const bool streamed = stream_width(width);
  const bool split = width == 384 || width == 512;
  const bool rows64 = split || streamed;        // 64-row row-pass CTAs
  cudaError_t err;
  if (fwd_out != nullptr) {      // recompute mode from 384 up
    if (!rows64 || a.recompute || lda != 2 * n_layers * width)
      return static_cast<int>(cudaErrorInvalidValue);
    a.out = static_cast<float*>(fwd_out);
    err = streamed ? launch_fwd_stream(a, static_cast<const bf16*>(slab),
                                       slab_ctas, st)
          : width == 384 ? launch_fwd_ws<384>(a, n_blocks, st)
                         : launch_fwd_ws<512>(a, n_blocks, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  // the row pass: saved mode at width 64, 128, 192, 256, 384 or 512 on the
  // warp-specialized kernel (384, 512: its 64-row split shape), where its
  // shared memory fits (up to 256 a ring of 2 stages or more beside the
  // bias partials), at the streamed widths on the streamed one; recompute mode
  // (f32 factors) up to 256 and other widths on siren_bwd_rows_kernel
  const int Wh = width / 2, L = n_layers;
  const int n_b = siren_n_bias(L, width);
  const bool ws = !a.recompute && (width == 64    ? ws_bwd_stages<64>(n_b)
                                   : width == 128 ? ws_bwd_stages<128>(n_b)
                                   : width == 192 ? ws_bwd_stages<192>(n_b)
                                   : width == 256 ? ws_bwd_stages<256>(n_b)
                                   : width == 384 ? ws_bwd_stages<384>(n_b)
                                   : width == 512 ? ws_bwd_stages<512>(n_b)
                                                  : 0) > 0;
  if ((split && !ws) || (streamed && a.recompute))
    return static_cast<int>(cudaErrorInvalidValue);
  if (streamed) {
    err = launch_bwd_rows_stream(a, n_blocks, st);
  } else if (ws) {
    err = width == 64    ? launch_bwd_rows_ws<64>(a, n_blocks, st)
          : width == 128 ? launch_bwd_rows_ws<128>(a, n_blocks, st)
          : width == 192 ? launch_bwd_rows_ws<192>(a, n_blocks, st)
          : width == 256 ? launch_bwd_rows_ws<256>(a, n_blocks, st)
          : width == 384 ? launch_bwd_rows_ws<384>(a, n_blocks, st)
                         : launch_bwd_rows_ws<512>(a, n_blocks, st);
  } else {
    const size_t smem = bwd_smem_bytes(width);
    err = cudaFuncSetAttribute(siren_bwd_rows_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    siren_bwd_rows_kernel<<<n_blocks, kThreads, smem, st>>>(a);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) return static_cast<int>(err);

  const int n_w = static_cast<int>(siren_n_w(L, width));
  return static_cast<int>(launch_dw(
      static_cast<const bf16*>(acts), lda, static_cast<const bf16*>(xs),
      2 * kInPad + 2 * width, static_cast<const bf16*>(dy),
      L * width + 2 * width + 16, static_cast<const int*>(tiles), n_tiles,
      static_cast<const int*>(jobs), static_cast<float*>(part), n_w,
      split_rows, static_cast<const float*>(pbias),
      rows64 ? 2 * n_blocks : n_blocks, n_b, 0, static_cast<float*>(dw),
      static_cast<float*>(db), st, rows64 ? 64 : kRows));
}

// The ring of stages the warp-specialized forward (kernel 0: saved mode, 1:
// without acts) or saved-mode row pass (2) launches with at a packed width
// and n_layers (the launchers' own arithmetic; at the streamed widths the
// streamed forward's weight ring and the streamed row pass's cp.async
// ring), or 0 where that width has no warp-specialized instance or a ring
// of 2 does not fit.
extern "C" int fsnerf_siren_stages(int width, int kernel, int n_layers) {
  using namespace fsnerf;
  if (stream_width(width))
    return kernel == 2 ? stream_rows_stages() : fwd_stream_stages(kernel == 0);
  switch (width) {
    case 64:
      return ws_stages<64>(kernel, n_layers);
    case 128:
      return ws_stages<128>(kernel, n_layers);
    case 192:
      return ws_stages<192>(kernel, n_layers);
    case 256:
      return ws_stages<256>(kernel, n_layers);
    case 384:
      return ws_stages<384>(kernel, n_layers);
    case 512:
      return ws_stages<512>(kernel, n_layers);
    default:
      return 0;
  }
}
