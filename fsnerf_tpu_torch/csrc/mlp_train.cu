// NeRF MLP training kernels for Hopper (sm_90a): the forward with the
// positional encoding inside (optionally streaming the trunk activations to
// HBM) and the backward to bf16 weight and bias gradients.
//
// Replaces fsnerf_tpu/ops/pallas/mlp_train.py::make_fused_train_mlp, whose
// custom VJP runs two Pallas TPU kernels: fwd_call (the forward, kernel
// mlp_train_fwd_kernel here) and bwd_call (the backward, the three kernels
// mlp_train_bwd_rows_kernel here, then dw_gemm_kernel and dw_reduce_kernel
// of train_common.cuh). Plain PyTorch twins:
// fsnerf_tpu_torch/ops/kernels/mlp_train.py::mlp_train_fwd_reference /
// mlp_train_bwd_reference.
//
// What bounds them on this card. A sample costs ~1.2 MFLOP forward and
// ~2.5 MFLOP backward (the head recompute, the input-cotangent products and
// the weight-gradient products). The forward's only large HBM traffic is
// the saved activations (L * W bf16 a row: ~0.8 GB at the main path's
// 196,608 rows, ~0.24 ms at 3.35 TB/s, about its ~0.24 ms of bf16 tensor
// work), so it is bound by both; its weights (~1.2 MB at 8 x 256) are read
// by every CTA from L2. The backward moves ~10 KB a sample (acts read, the
// scratch operands written and read back): its ~2 GB of scratch traffic
// (~0.6 ms) weighs as much as its operations.
//
// The forward (mlp_train_fwd_kernel) is the warp-specialized MLP of
// ws_trunk.cuh: a producer warpgroup streams the weights by TMA through an
// mbarrier ring, two consumer warpgroups of 64 rows run each layer on
// wgmma with their activation tiles in shared memory. Each consumer
// encodes its own rows (encx, encd) and, in saved mode, one of its threads
// stores each trunk layer's activation tile to `acts` by TMA while the
// next layer runs. At the packed widths 384 and 512 it runs ws_trunk.cuh's
// column-split trunk (one consumer of 64 rows, each layer as two column
// halves, each half's tile stored to acts' [rows, L * W] layout by TMA).
// A row there costs ~4.6 MFLOP forward at 8 x 512 (~1.19 at 8 x 256). At
// the streamed widths, 768 and every multiple of 256 up (~18 MFLOP a row
// at 8 x 1024), mlp_train_fwd_kernel_stream
// runs its streamed trunk: each layer's 256-column chunks stored to acts
// (or a scratch) and read back from L2 as the next layer's operand.
//
// The backward is split, because CUDA blocks run in no order and float
// atomics would make the gradients change from run to run, where the
// Pallas backward keeps every weight-gradient block resident in VMEM
// across a sequential grid:
//   1. mlp_train_bwd_rows_kernel, row-parallel (128 rows per CTA; 64 at
//      the packed widths 384 and 512, one warpgroup, so that its two
//      activation buffers fit in shared memory; at the streamed widths
//      mlp_train_bwd_rows_kernel_stream, which holds no activation buffer
//      and streams every product's operands from device memory): encodes
//      the inputs, takes the trunk activations from the forward's stream,
//      recomputes the heads (mma.sync, mlp_common.cuh::gemm), and walks the
//      layers back on wgmma.m64n128k16 with A (the cotangent tile) from
//      registers and the weights streamed by cp.async into 128B-swizzled
//      tiles (cotangent_gemm), each layer's activations prefetched for
//      ReLU'. It writes every GEMM operand a weight gradient needs to HBM as
//      bf16 (the encodings, feat, branch activation and each layer's bf16
//      cotangent) and each CTA's column sums of the f32 cotangents (the
//      bias-gradient partials).
//   2. dw_gemm_kernel: dW = X^T dY for every weight matrix on wgmma fed by
//      TMA, one CTA per (128 x 256 output tile, split of rows), the rows
//      of its split in a fixed order; each split writes its own f32
//      partial.
//   3. dw_reduce_kernel: sums the partials of each gradient in a fixed
//      order and rounds to bf16, as the TPU kernel's caller does.
// In recompute mode (no saved activations) the backward first runs the
// forward kernel into the same acts stream, then the same three launches.
// Nothing is summed in an order that depends on scheduling, so two runs give
// bitwise-equal gradients, and both backward modes give bitwise-equal
// gradients by construction.
//
// Numerics, as the TPU kernels (mlp_train.py::_fwd_compute, _bwd_grads):
// bf16 operands, f32 accumulation, bf16-rounded biases added in f32, trunk
// activations ReLU then bf16, the skip concat [h, enc] as two products into
// one accumulator, feat bf16 without activation, branch ReLU then bf16,
// rgb an f32 sigmoid, sigma raw. Each cotangent is rounded to bf16 before
// it enters a product; ReLU' is read from the bf16 activation being > 0;
// bias gradients are column sums of the f32 cotangents; at a skip layer
// the cotangent flows back only through W_h (the encoding gets none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "train_common.cuh"
#include "ws_trunk.cuh"

namespace fsnerf {
namespace {

struct TrainArgs {
  const float* x;        // [N, 3] sample points
  const float* d;        // [N, 3] view directions
  const bf16* wpack;     // packed [in, out] weights (ops/kernels/render.py)
  const float* bpack;    // packed biases (bf16-rounded values)
  const float* enc;      // [2F + 2Fv]: freq_x, mask_x, freq_d, mask_d
  float* out;            // [N, 4] rgb, sigma
  bf16* acts;            // [N_pad, L*W] trunk activations, or null
  const float* dout;     // [N, 4] output cotangent
  bf16* xs;              // [N_pad, XW]: encx | encd | feat | br
  bf16* dy;              // [N_pad, DYW]: dY_0..L-1 | conn | branch | sigma | rgb
  float* pbias;          // [N_pad / R, NB] bias-gradient partials (R:
                         // the row pass's rows per CTA, bwd_rows)
  int N, n_layers, skip_mask, width, n_freqs, n_freqs_views;
  int d_enc_pad, d_dir_pad;
};

// Offset of trunk layer i's first matrix in wpack (the walk of
// ops/kernels/render.py::pack_weights); i = n_layers gives the heads.
__host__ __device__ __forceinline__ size_t trunk_offset(const TrainArgs& a,
                                                      int i) {
  const int W = a.width, DE = a.d_enc_pad;
  if (i == 0) return 0;
  size_t off = (size_t)DE * W;
  for (int k = 1; k < i; ++k)
    off += (size_t)W * W + (((a.skip_mask >> k) & 1) ? (size_t)DE * W : 0);
  return off;
}

// wpack's element count: the trunk, w_sigma, w_conn, the branch and w_rgb.
size_t packed_weights(const TrainArgs& a) {
  const size_t W = a.width, Wh = W / 2;
  return trunk_offset(a, a.n_layers) + W + W * W + W * Wh +
         a.d_dir_pad * Wh + Wh * 3;
}

// The backward row kernel's weight staging: a ring of kBwdStages tiles of
// kBwdPassCols weight rows x 64 K (train_common.cuh) for its wgmma GEMMs,
// which the slabs of gemm() (mlp_common.cuh, the heads' recompute) alias.
constexpr int kSlabBytes = 2 * kSlabRows * kSlabLd * sizeof(bf16);
constexpr int kBwdSlabBytes = kBwdStages * kBwdStageBytes + 1024;
static_assert(kSlabBytes <= kBwdSlabBytes, "the slabs alias the ring");

// The backward row kernel's shared memory over its R rows (128; 64 at the
// packed widths 384 and 512, where two 128-row activation buffers would
// not fit). The points' encoding goes straight to xs (no product of this
// kernel reads it), so only the directions' is staged: at width 256 the
// 128-row kernel fits with encd up to 128 wide (231,936 bytes), at 512 the
// 64-row one with encd up to 256 (227,072 bytes), whatever the points'
// encoding.
struct Smem {
  bf16 *buf0, *buf1, *encd, *slabs;
  float *rgb, *drgb, *dsig, *colpart;
  int LDH, LDD;
};

template <int R>
__device__ __forceinline__ Smem carve(unsigned char* raw,
                                      const TrainArgs& a) {
  Smem s;
  s.LDH = a.width + kPad;
  s.LDD = a.d_dir_pad + kPad;
  s.buf0 = reinterpret_cast<bf16*>(raw);
  s.buf1 = s.buf0 + R * s.LDH;
  s.encd = s.buf1 + R * s.LDH;
  s.slabs = s.encd + R * s.LDD;
  s.rgb = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(s.slabs) +
                                   kBwdSlabBytes);
  s.drgb = s.rgb + 3 * R;
  s.dsig = s.drgb + 3 * R;
  s.colpart = s.dsig + R;                  // [row groups][width]
  return s;
}

// The row pass's rows per CTA at a packed width.
__host__ __device__ constexpr int bwd_rows(int width) {
  return width > kWholeMaxWidth ? 64 : kRows;
}

// (ops/kernels/mlp_train.py::bwd_rows_smem_bytes mirrors it): R rows, one
// row group of column sums per warp of the 2 R threads
size_t smem_bytes(int width, int d_dir_pad) {
  const size_t R = bwd_rows(width);
  return sizeof(bf16) * R * (2 * width + d_dir_pad + 3 * kPad) +
         kBwdSlabBytes + sizeof(float) * (7 * R + R / 16 * width);
}

// The encodings of the CTA's R rows from r0 of x and d (zero inputs past
// N) as bf16: encx straight to xs' columns [0, DE), encd into shared memory
// for the branch's product and then to xs' columns [DE, DE + DD). The rows'
// points and directions are staged first in the weight ring, which nothing
// uses until the heads' products.
template <int R>
__device__ void encode_rows(const TrainArgs& a, const Smem& s, int r0,
                            int XW) {
  constexpr int T = 2 * R;
  const int tid = threadIdx.x;
  float* xin = reinterpret_cast<float*>(s.slabs);
  float* din = xin + 3 * R;
  for (int e = tid; e < 3 * R; e += T) {
    const bool in = r0 + e / 3 < a.N;
    xin[e] = in ? a.x[(size_t)r0 * 3 + e] : 0.f;
    din[e] = in ? a.d[(size_t)r0 * 3 + e] : 0.f;
  }
  __syncthreads();
  const float* freq_x = a.enc;
  const float* mask_x = freq_x + a.n_freqs;
  const float* freq_d = mask_x + a.n_freqs;
  const float* mask_d = freq_d + a.n_freqs_views;
  const int DE = a.d_enc_pad, DD = a.d_dir_pad;
  for (int e = tid; e < R * DE; e += T) {
    const int row = e / DE, col = e - row * DE;
    a.xs[(size_t)(r0 + row) * XW + col] = __float2bfloat16_rn(
        encode_lane(xin + 3 * row, col, a.n_freqs, freq_x, mask_x));
  }
  for (int e = tid; e < R * DD; e += T) {
    const int row = e / DD, col = e - row * DD;
    s.encd[row * s.LDD + col] = __float2bfloat16_rn(
        encode_lane(din + 3 * row, col, a.n_freqs_views, freq_d, mask_d));
  }
  __syncthreads();
  rows_to_global<R>(s.encd, s.LDD, a.xs, XW, r0, DE, DD);
}

// feat = bf16(h_last @ w_conn + b_conn) into `other`; then
// br = bf16(relu(feat @ w_branch_h + encd @ w_branch_d + b_branch)) into
// hl (h_last is dead by then); then rgb = sigmoid(br @ w_rgb + b_rgb) into
// s.rgb. With `xs`, feat and br also go to HBM for the weight gradients.
template <int R>
__device__ void heads_forward(const TrainArgs& a, const Smem& s, int r0,
                              bf16* hl, bf16* other, bf16* xs, int XW) {
  const int W = a.width, Wh = W / 2, DE = a.d_enc_pad, DD = a.d_dir_pad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Seg none = {nullptr, 0, nullptr, 0};
  const bf16* w = a.wpack + trunk_offset(a, a.n_layers) + W;   // past w_sigma
  const float* b = a.bpack + a.n_layers * W + 1;               // past b_sigma
  gemm_layer<R>(Seg{hl, s.LDH, w, W}, none, b, W, false, other, s.LDH,
                s.slabs);
  w += W * W;
  b += W;
  __syncthreads();
  if (xs) rows_to_global<R>(other, s.LDH, xs, XW, r0, DE + DD, W);
  gemm_layer<R>(Seg{other, s.LDH, w, W}, Seg{s.encd, s.LDD, w + W * Wh, DD},
                b, Wh, true, hl, s.LDH, s.slabs);
  w += W * Wh + DD * Wh;
  b += Wh;
  __syncthreads();
  if (xs) rows_to_global<R>(hl, s.LDH, xs, XW, r0, DE + DD + W, Wh);
  for (int row = warp; row < R; row += R / 16) {
    const bf16* h = hl + row * s.LDH;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    for (int k = lane; k < Wh; k += 32) {
      const float hv = __bfloat162float(h[k]);
      v0 += hv * __bfloat162float(w[3 * k]);
      v1 += hv * __bfloat162float(w[3 * k + 1]);
      v2 += hv * __bfloat162float(w[3 * k + 2]);
    }
    v0 = warp_sum(v0) + b[0];
    v1 = warp_sum(v1) + b[1];
    v2 = warp_sum(v2) + b[2];
    if (lane == 0) {
      s.rgb[3 * row] = 1.f / (1.f + expf(-v0));
      s.rgb[3 * row + 1] = 1.f / (1.f + expf(-v1));
      s.rgb[3 * row + 2] = 1.f / (1.f + expf(-v2));
    }
  }
  __syncthreads();
}

// ---- the forward (mlp_train_fwd_kernel) -------------------------------
//
// The warp-specialized forward of ws_trunk.cuh, encoding its rows itself
// and, in saved mode, storing each trunk layer's activation tile to acts.

// A consumer warpgroup: its 64 rows from row0 through the whole MLP.
template <int W, int NB>
__device__ __forceinline__ void fwd_consume(const CUtensorMap* map_acts,
                                            const TrainArgs& a, FwdRing& r,
                                            unsigned char* act,
                                            unsigned char* encx,
                                            unsigned char* encd, int wg) {
  const int t = threadIdx.x & 127, lane = t & 31;
  const int L = a.n_layers, DE = a.d_enc_pad, DD = a.d_dir_pad;
  const int row0 = blockIdx.x * kRows + 64 * wg;
  const int bar = 1 + wg;                           // this warpgroup's barrier

  {  // encode: thread t owns row t % 64 and every other 16-byte chunk
    const int row = t & 63, g = row0 + row;
    float xv[3], dv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      xv[k] = g < a.N ? a.x[(size_t)g * 3 + k] : 0.f;
      dv[k] = g < a.N ? a.d[(size_t)g * 3 + k] : 0.f;
    }
    const float* freq_x = a.enc;
    const float* mask_x = freq_x + a.n_freqs;
    const float* freq_d = mask_x + a.n_freqs;
    const float* mask_d = freq_d + a.n_freqs_views;
    encode_row(encx, xv, row, t >> 6, enc_blocks(DE), a.n_freqs, freq_x,
               mask_x);
    encode_row(encd, dv, row, t >> 6, enc_blocks(DD), a.n_freqs_views,
               freq_d, mask_d);
  }
  fence_proxy_async();
  named_bar(bar, 128);

  const FwdShape sh{L, a.skip_mask, DE, DD};
  const bf16* w_sigma = a.wpack + trunk_offset(a, L);
  const float* b = a.bpack;
  float sig[2] = {0.f, 0.f};
  float acc[W / 2];
  fwd_trunk<W>(acc, r, act, smem_u32(encx), sh, b, w_sigma, sig, bar,
               a.acts ? map_acts : nullptr, row0);
  const int quad_row = 16 * (t >> 5) + (lane >> 2);
  const float b_sigma = b[L * W];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v = quad_sum(sig[h]) + b_sigma;
    const int g = row0 + quad_row + 8 * h;
    if ((lane & 3) == 0 && g < a.N) a.out[(size_t)g * 4 + 3] = v;
  }
  float rgb[2][3];
  fwd_conn<W>(acc, r, act, b + L * W + 1, bar);
  fwd_branch<W, NB>(r, act, smem_u32(encd), DD, w_sigma + W, b + L * W + 1,
                    rgb);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = row0 + quad_row + 8 * h;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if ((lane & 3) == 0 && g < a.N) a.out[(size_t)g * 4 + c] = rgb[h][c];
  }
  if (r.lead) bulk_wait<0>();           // the saved activations are written
}

// fwd_consume at a split width (FwdTraits<W>::kSplit): the CTA's one
// consumer warpgroup, its 64 rows from row0 through the column-split
// trunk, connection and branch, each trunk layer's two halves stored to
// acts by TMA.
template <int W, int NB>
__device__ __forceinline__ void fwd_consume_split(const CUtensorMap* map_acts,
                                                  const TrainArgs& a,
                                                  FwdRing& r,
                                                  SplitActs<W>& tiles,
                                                  unsigned char* encx,
                                                  unsigned char* encd) {
  const int t = threadIdx.x, lane = t & 31;
  const int L = a.n_layers, DE = a.d_enc_pad, DD = a.d_dir_pad;
  const int row0 = blockIdx.x * FwdTraits<W>::kCtaRows;
  const int bar = 1;
  {  // encode: thread t owns row t % 64 and every other 16-byte chunk
    const int row = t & 63, g = row0 + row;
    float xv[3], dv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      xv[k] = g < a.N ? a.x[(size_t)g * 3 + k] : 0.f;
      dv[k] = g < a.N ? a.d[(size_t)g * 3 + k] : 0.f;
    }
    const float* freq_x = a.enc;
    const float* mask_x = freq_x + a.n_freqs;
    const float* freq_d = mask_x + a.n_freqs;
    const float* mask_d = freq_d + a.n_freqs_views;
    encode_row(encx, xv, row, t >> 6, enc_blocks(DE), a.n_freqs, freq_x,
               mask_x);
    encode_row(encd, dv, row, t >> 6, enc_blocks(DD), a.n_freqs_views,
               freq_d, mask_d);
  }
  fence_proxy_async();
  named_bar(bar, 128);

  const FwdShape sh{L, a.skip_mask, DE, DD};
  const bf16* w_sigma = a.wpack + trunk_offset(a, L);
  const float* b = a.bpack;
  float sig[2] = {0.f, 0.f};
  float acc[W / 4];
  fwd_trunk_split<W>(acc, r, tiles, smem_u32(encx), sh, b, w_sigma, sig, bar,
                     a.acts ? map_acts : nullptr, row0);
  const int quad_row = 16 * (t >> 5) + (lane >> 2);
  const float b_sigma = b[L * W];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v = quad_sum(sig[h]) + b_sigma;
    const int g = row0 + quad_row + 8 * h;
    if ((lane & 3) == 0 && g < a.N) a.out[(size_t)g * 4 + 3] = v;
  }
  float rgb[2][3];
  fwd_conn_split<W>(acc, r, tiles, b + L * W + 1, bar);
  fwd_branch_split<W, NB>(r, tiles, smem_u32(encd), DD, w_sigma + W,
                          b + L * W + 1, rgb);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = row0 + quad_row + 8 * h;
#pragma unroll
    for (int c = 0; c < 3; ++c)
      if ((lane & 3) == 0 && g < a.N) a.out[(size_t)g * 4 + c] = rgb[h][c];
  }
  if (r.lead) bulk_wait<0>();           // the saved activations are written
}

// The split kernel's body: the ring of W / 2-wide stages, the three
// activation tiles, one consumer's encodings, the barriers.
template <int W>
__device__ __forceinline__ void fwd_split_body(const CUtensorMap* map_w,
                                               const CUtensorMap* map_br,
                                               const CUtensorMap* map_acts,
                                               const TrainArgs& a,
                                               int n_stages,
                                               unsigned char* smem_raw) {
  using T = FwdTraits<W>;
  constexpr int NB = head_n(W);
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nbx = enc_blocks(a.d_enc_pad);
  unsigned char* act = ring + n_stages * T::kStageBytes;
  unsigned char* encx = act + T::kActBytes;
  unsigned char* encd = encx + nbx * kBlock;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      encd + enc_blocks(a.d_dir_pad) * kBlock);
  uint64_t* empty = full + n_stages;
  fwd_init_barriers(full, empty, n_stages, nullptr, 0, 1);
  __syncthreads();
  if (threadIdx.x >= 128) {                        // the producer
    if (threadIdx.x == 128) {
      int it = 0;
      produce_pass_split<W, NB>(
          map_w, map_br,
          FwdShape{a.n_layers, a.skip_mask, a.d_enc_pad, a.d_dir_pad}, true,
          ring, full, empty, n_stages, it, nullptr);
    }
    return;
  }
  SplitActs<W> tiles(act);
  FwdRing r{smem_u32(ring), T::kStageBytes, full, empty, n_stages, 0,
            threadIdx.x == 0};
  fwd_consume_split<W, NB>(map_acts, a, r, tiles, encx, encd);
}

// The kernel's body at a width of whole-row consumers (up to 256).
template <int W>
__device__ __forceinline__ void fwd_whole_body(const CUtensorMap* map_w,
                                               const CUtensorMap* map_br,
                                               const CUtensorMap* map_acts,
                                               const TrainArgs& a,
                                               int n_stages,
                                               unsigned char* fwd_smem_raw) {
  constexpr int NB = head_n(W);                   // the branch product's N
  // the ring from the next 1024-byte boundary, by pointer arithmetic on the
  // shared array (an integer round trip would make every tile access a
  // generic one, which the compiler cannot tell from the global loads)
  unsigned char* ring =
      fwd_smem_raw + ((1024 - (smem_u32(fwd_smem_raw) & 1023)) & 1023);
  const int nbx = enc_blocks(a.d_enc_pad), nbd = enc_blocks(a.d_dir_pad);
  unsigned char* act = ring + n_stages * W * 128;
  unsigned char* encx = act + kFwdConsumers * W * 128;
  unsigned char* encd = encx + kFwdConsumers * nbx * kBlock;
  uint64_t* full = reinterpret_cast<uint64_t*>(encd + kFwdConsumers * nbd *
                                                          kBlock);
  uint64_t* empty = full + n_stages;
  fwd_init_barriers(full, empty, n_stages, nullptr, 0);
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kFwdConsumers) {                       // the producer
    setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == 128 * kFwdConsumers) {
      int it = 0;
      produce_pass<W, NB>(map_w, map_br,
                          FwdShape{a.n_layers, a.skip_mask, a.d_enc_pad,
                                   a.d_dir_pad},
                          true, ring, full, empty, n_stages, it, nullptr);
    }
  } else {
    setmaxnreg_inc<kFwdConsumerRegs>();
    FwdRing r{smem_u32(ring), W * 128, full, empty, n_stages, 0,
              (threadIdx.x & 127) == 0};
    fwd_consume<W, NB>(map_acts, a, r, act + wg * W * 128,
                       encx + wg * nbx * kBlock, encd + wg * nbd * kBlock,
                       wg);
  }
}

// grid: one CTA per 128 rows (64 at a split width); block: the consumer
// warpgroups + the producer's. map_acts is read only when a.acts is set.
template <int W>
__global__ void __launch_bounds__(FwdTraits<W>::kThreads, 1)
    mlp_train_fwd_kernel(const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_br,
                         const __grid_constant__ CUtensorMap map_acts,
                         TrainArgs a, int n_stages) {
  extern __shared__ unsigned char fwd_smem_raw[];
  if constexpr (FwdTraits<W>::kSplit)
    fwd_split_body<W>(&map_w, &map_br, &map_acts, a, n_stages,
                      fwd_smem_raw);
  else
    fwd_whole_body<W>(&map_w, &map_br, &map_acts, a, n_stages,
                      fwd_smem_raw);
}

// The forward at width W on `st`: the tensor maps of wpack (trunk_rows x
// W, then the branch's [W + DD, W / 2] right after it) and of acts, the
// deepest ring that fits in shared memory. Every row up to round_up(N,
// 128) is computed (rows past N on zero inputs), as the backward's passes
// read them.
template <int W>
cudaError_t launch_fwd_w(const TrainArgs& a, int trunk_rows,
                         cudaStream_t st) {
  using T = FwdTraits<W>;
  const int L = a.n_layers, DE = a.d_enc_pad, DD = a.d_dir_pad;
  const int n_blocks = (a.N + kRows - 1) / kRows;
  CUtensorMap map_w, map_br, map_acts;
  if (!encode_weight_maps<W>(&map_w, &map_br, a.wpack, trunk_rows, DD))
    return cudaErrorInvalidValue;
  if (a.acts == nullptr)
    map_acts = map_w;
  else if (!encode_bf16_map(&map_acts, a.acts, n_blocks * kRows, L * W,
                            L * W, 64))
    return cudaErrorInvalidValue;
  const int n_stages = fwd_stages(W, DE, DD, 0);
  if (n_stages == 0) return cudaErrorInvalidValue;
  const size_t smem = fwd_smem_bytes(W, DE, DD, n_stages);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mlp_train_fwd_kernel<W>
      <<<n_blocks * (kRows / T::kCtaRows), T::kThreads, smem, st>>>(
          map_w, map_br, map_acts, a, n_stages);
  return cudaGetLastError();
}

// ---- the forward at the streamed widths (768 and every multiple of 256 up)
//
// ws_trunk.cuh's streamed trunk: one consumer warpgroup of 64 rows, the
// CTAs persistent over the row tiles up to round_up(N, 128), each tile's
// rows encoded into encx / encd by the consumer, every layer's output
// stored by TMA (the trunk's to acts in saved mode, else to the CTA's
// scratch slot; feat always to the scratch) and read back as the next
// product's A operand. One instance serves both widths.
__device__ __forceinline__ void fwd_stream_body(const CUtensorMap* map_w,
                                                const CUtensorMap* map_br,
                                                const CUtensorMap* map_acts,
                                                const CUtensorMap* map_slab,
                                                const TrainArgs& a,
                                                int n_stages,
                                                unsigned char* smem_raw) {
  const int W = a.width, L = a.n_layers, DE = a.d_enc_pad, DD = a.d_dir_pad;
  const StreamTiles s = stream_carve(smem_raw, n_stages, DE, DD);
  fwd_init_barriers(s.full, s.empty, n_stages, s.afull, kStreamAStages, 1);
  __syncthreads();
  const FwdShape sh{L, a.skip_mask, DE, DD};
  const int n_tiles = (a.N + kRows - 1) / kRows * (kRows / 64);
  if (threadIdx.x >= 128) {                        // the producer
    if (threadIdx.x == 128) {
      int it = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x)
        produce_pass_stream(map_w, map_br, W, sh, true, s.ring, s.full,
                            s.empty, n_stages, it, nullptr);
    }
    return;
  }
  const int t = threadIdx.x, lane = t & 31, bar = 1;
  FwdRing r{smem_u32(s.ring), kStreamStageBytes, s.full, s.empty, n_stages,
            0, t == 0};
  ARing ar{smem_u32(s.a), s.a, s.afull, 0};
  const bf16* w_sigma = a.wpack + trunk_offset(a, L);
  const float* b = a.bpack;
  const float* freq_x = a.enc;
  const float* mask_x = freq_x + a.n_freqs;
  const float* freq_d = mask_x + a.n_freqs;
  const float* mask_d = freq_d + a.n_freqs_views;
  const int quad_row = 16 * (t >> 5) + (lane >> 2);
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * 64;
    // every warp's products of the last tile have read encx and encd
    named_bar(bar, 128);
    {  // encode: thread t owns row t % 64 and every other 16-byte chunk
      const int row = t & 63, g = row0 + row;
      float xv[3], dv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        xv[k] = g < a.N ? a.x[(size_t)g * 3 + k] : 0.f;
        dv[k] = g < a.N ? a.d[(size_t)g * 3 + k] : 0.f;
      }
      encode_row(s.encx, xv, row, t >> 6, enc_blocks(DE), a.n_freqs, freq_x,
                 mask_x);
      encode_row(s.encd, dv, row, t >> 6, enc_blocks(DD), a.n_freqs_views,
                 freq_d, mask_d);
    }
    fence_proxy_async();
    named_bar(bar, 128);
    const StreamBufs io{a.acts ? map_acts : nullptr, map_slab, row0,
                        (int)blockIdx.x * 64, W, L};
    float sig[2] = {0.f, 0.f};
    {
      float acc[kStreamCols / 2];
      zero_acc(acc);
      stream_trunk(acc, r, ar, s, sh, W, b, w_sigma, sig, bar, io);
      const float b_sigma = b[L * W];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v = quad_sum(sig[h]) + b_sigma;
        const int g = row0 + quad_row + 8 * h;
        if ((lane & 3) == 0 && g < a.N) a.out[(size_t)g * 4 + 3] = v;
      }
      stream_conn(acc, r, ar, s, W, b + L * W + 1, bar, io);
    }
    float rgb[2][3];
    stream_branch(r, ar, s, io.at(L), W, DD, w_sigma + W, b + L * W + 1,
                  rgb);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int g = row0 + quad_row + 8 * h;
#pragma unroll
      for (int c = 0; c < 3; ++c)
        if ((lane & 3) == 0 && g < a.N) a.out[(size_t)g * 4 + c] = rgb[h][c];
    }
  }
}

// grid: min(row tiles, the scratch's slots) persistent CTAs; block: one
// consumer warpgroup + the producer's. map_acts is read only when a.acts
// is set.
__global__ void __launch_bounds__(256, 1)
    mlp_train_fwd_kernel_stream(const __grid_constant__ CUtensorMap map_w,
                                const __grid_constant__ CUtensorMap map_br,
                                const __grid_constant__ CUtensorMap map_acts,
                                const __grid_constant__ CUtensorMap map_slab,
                                TrainArgs a, int n_stages) {
  extern __shared__ unsigned char fwd_stream_smem_raw[];
  fwd_stream_body(&map_w, &map_br, &map_acts, &map_slab, a, n_stages,
                  fwd_stream_smem_raw);
}

// The streamed forward on `st`, slab the [slab_ctas * 64, 2 W] bf16
// scratch.
cudaError_t launch_fwd_stream(const TrainArgs& a, int trunk_rows,
                              const bf16* slab, int slab_ctas,
                              cudaStream_t st) {
  const int W = a.width, L = a.n_layers;
  const int n_rows = (a.N + kRows - 1) / kRows * kRows;
  CUtensorMap map_w, map_br, map_acts, map_slab;
  if (!encode_stream_maps(&map_w, &map_br, &map_slab, a.wpack, trunk_rows,
                          W, a.d_dir_pad, slab, slab_ctas))
    return cudaErrorInvalidValue;
  if (a.acts == nullptr)
    map_acts = map_slab;
  else if (!encode_bf16_map(&map_acts, a.acts, n_rows, L * W, L * W, 64))
    return cudaErrorInvalidValue;
  const int n_stages = stream_stages(a.d_enc_pad, a.d_dir_pad, 0);
  if (n_stages == 0) return cudaErrorInvalidValue;
  const size_t smem = stream_smem_bytes(a.d_enc_pad, a.d_dir_pad, n_stages);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_fwd_kernel_stream,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  mlp_train_fwd_kernel_stream<<<min(n_rows / 64, slab_ctas), 256, smem,
                                st>>>(map_w, map_br, map_acts, map_slab, a,
                                      n_stages);
  return cudaGetLastError();
}

// The forward into a.out and (when set) a.acts. The kernel takes W of 64,
// 128, 192, 256, 384, 512 or a streamed width (with slab, [slab_ctas * 64,
// 2 W] bf16 scratch) whose packed weights number at most
// kMaxPackedWeights, and encodings up to kMaxEnc wide (at W = 256 up
// to 6 blocks of 64 together); trunk_rows must be the rows of wpack's
// [rows, W] view (the trunk, w_sigma and w_conn).
cudaError_t launch_fwd(const TrainArgs& a, int trunk_rows, const bf16* slab,
                       int slab_ctas, cudaStream_t st) {
  const int W = a.width;
  if (a.d_enc_pad > kMaxEnc || a.d_dir_pad > kMaxEnc ||
      (size_t)trunk_rows * W != trunk_offset(a, a.n_layers) + W + W * W ||
      packed_weights(a) > kMaxPackedWeights)
    return cudaErrorInvalidValue;
  if (a.N == 0) return cudaGetLastError();
  if (stream_width(W))
    return launch_fwd_stream(a, trunk_rows, slab, slab_ctas, st);
  switch (W) {
    case 64:
      return launch_fwd_w<64>(a, trunk_rows, st);
    case 128:
      return launch_fwd_w<128>(a, trunk_rows, st);
    case 192:
      return launch_fwd_w<192>(a, trunk_rows, st);
    case 256:
      return launch_fwd_w<256>(a, trunk_rows, st);
    case 384:
      return launch_fwd_w<384>(a, trunk_rows, st);
    case 512:
      return launch_fwd_w<512>(a, trunk_rows, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Where a cotangent GEMM's epilogue writes: C (in shared memory, row
// stride ldc) = bf16(v), v = acc (+ dsig[row] * w_sigma[col]), v = 0 where
// the activation prefetched into C is not > 0 (ReLU', when masked), and
// each warp's column sums of the f32 v over its 16 rows into
// colpart[warp][col].
struct CotangentOut {
  bf16* C;
  int ldc;
  const bf16* acts;        // C's layer's first activation column (of
  int acts_ld;             // acts [., acts_ld]): ReLU'; null: none
  const float* dsig;       // null: no rank-1 term
  const bf16* w_sigma;
  float* colpart;          // [8][width]
};

__device__ __forceinline__ void cotangent_epilogue(const CotangentOut& o,
                                                   const float (&acc)[64],
                                                   int n0, int N,
                                                   int width) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * warp + (lane >> 2);
  const int c0 = n0 + 2 * (lane & 3);
  float ds[2] = {0.f, 0.f};
  if (o.dsig) {
    ds[0] = o.dsig[row];
    ds[1] = o.dsig[row + 8];
  }
#pragma unroll
  for (int j = 0; j < kBwdPassCols / 8; ++j) {
    if (n0 + 8 * j >= N) break;            // the same for the whole warp
    const int col = c0 + 8 * j;
    float w0 = 0.f, w1 = 0.f;
    if (o.dsig) {
      w0 = __bfloat162float(o.w_sigma[col]);
      w1 = __bfloat162float(o.w_sigma[col + 1]);
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (o.dsig) {
        v0 += ds[h] * w0;
        v1 += ds[h] * w1;
      }
      __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(
          o.C + (row + 8 * h) * o.ldc + col);
      if (o.acts) {
        const __nv_bfloat162 hv = *p;
        if (!(__bfloat162float(hv.x) > 0.f)) v0 = 0.f;
        if (!(__bfloat162float(hv.y) > 0.f)) v1 = 0.f;
      }
      *p = __floats2bfloat162_rn(v0, v1);
      s0 += v0;
      s1 += v1;
    }
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, m);
      s1 += __shfl_xor_sync(0xffffffffu, s1, m);
    }
    if (lane < 4) {
      o.colpart[warp * width + col] = s0;
      o.colpart[warp * width + col + 1] = s1;
    }
  }
}

// KS k16 steps of a cotangent GEMM: this warp's A fragments from shared
// memory at ap (ldmatrix), then the warpgroup's wgmma on the weight tile at
// shared address b; returns when they have completed.
template <int KS>
__device__ __forceinline__ void cotangent_stage(float (&acc)[64],
                                                const bf16* ap, uint32_t b) {
  uint32_t a[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(a[kk], ap + 16 * kk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs(acc, a[kk], sw128_desc(b + 32 * kk, 16, 1024), 1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) fence_regs(a[kk]);
}

// An input-cotangent product of the backward on the tensor cores:
// C[R, :N] = epilogue(A[R, :K] @ B^T), A the bf16 cotangent tile in
// shared memory (row stride lda), B [N, K] a weight matrix of wpack read
// K-major (its [in, out] rows, row stride ldb = K). Each warpgroup owns 64
// rows and runs wgmma.m64n128k16 per 128 output columns, its A fragments
// loaded by ldmatrix (the register-A layout), B streamed by cp.async
// through a ring of kBwdStages 128B-swizzled tiles of 64 K. With o.acts,
// C's rows of this layer's activations are copied into C by cp.async
// while the product runs, for the epilogue's ReLU'. Ends with a barrier;
// then colpart holds the column sums of every output column.
template <int R>
__device__ void cotangent_gemm(const bf16* A, int lda, int K, const bf16* B,
                               int N, int r0, int width,
                               const CotangentOut& o, unsigned char* ring) {
  constexpr int T = 2 * R;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk = (K + 63) / 64;
  const bf16* ap = A + (16 * warp + (lane & 15)) * lda + (lane >> 4) * 8;
  for (int n0 = 0; n0 < N; n0 += kBwdPassCols) {
    // every warpgroup's wgmma of the last pass has read the ring before
    // this pass's prologue writes to it
    if (n0 > 0) __syncthreads();
    // stage kc: rows n0 .. n0 + 127 of B, K columns 64 kc .. 64 kc + 63;
    // the first pass's last stage also brings the activations, so they
    // land while the earlier stages run and are waited for with it
    auto load = [&](int kc) {
      unsigned char* tile = ring + (kc % kBwdStages) * kBwdStageBytes;
      for (int q = tid; q < kBwdPassCols * 8; q += T) {
        const int n = q >> 3, c = q & 7, k = kc * 64 + c * 8;
        const bool ok = n0 + n < N && k < K;
        cp_async_16(tile + n * 128 + (((c ^ n) & 7) << 4),
                    ok ? B + (size_t)(n0 + n) * K + k : B, ok);
      }
      if (o.acts && n0 == 0 && kc == nk - 1) {
        const int per_row = N / 8;
        for (int e = tid; e < R * per_row; e += T) {
          const int row = e / per_row, c8 = (e - row * per_row) * 8;
          cp_async_16(o.C + row * o.ldc + c8,
                      o.acts + (size_t)(r0 + row) * o.acts_ld + c8, true);
        }
      }
    };
#pragma unroll
    for (int st = 0; st < kBwdStages - 1; ++st) {
      if (st < nk) load(st);
      cp_async_commit();
    }
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kc = 0; kc < nk; ++kc) {
      cp_async_wait<kBwdStages - 2>();     // stage kc landed
      fence_proxy_async();                 // ... visible to the tensor cores
      __syncthreads();                     // for every thread's copies
      if (kc + kBwdStages - 1 < nk) load(kc + kBwdStages - 1);
      cp_async_commit();
      const uint32_t tile = smem_u32(ring + (kc % kBwdStages) *
                                               kBwdStageBytes);
      if (kc * 64 + 64 <= K) {
        cotangent_stage<4>(acc, ap + kc * 64, tile);
      } else {                             // a last stage of 16 or 48 K
        for (int kk = 0; kc * 64 + 16 * kk < K; ++kk)
          cotangent_stage<1>(acc, ap + kc * 64 + 16 * kk, tile + 32 * kk);
      }
    }
    fence_regs(acc);
    cotangent_epilogue(o, acc, n0, N, width);
  }
  __syncthreads();
}

// grid: one CTA per R rows (bwd_rows(width): 128, or 64 at the packed
// widths 384 and 512, where a 128-row CTA's activation buffers exceed the
// 227 KB of a block); block: 2 R threads, one warpgroup per 64 rows.
template <int R>
__global__ void __launch_bounds__(2 * R, 1)
    mlp_train_bwd_rows_kernel(TrainArgs a) {
  constexpr int T = 2 * R;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem s = carve<R>(smem_raw, a);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.width, Wh = W / 2, L = a.n_layers;
  const int DE = a.d_enc_pad, DD = a.d_dir_pad;
  const int XW = DE + DD + W + Wh, DYW = L * W + W + Wh + 16, LA = L * W;
  const int NB = L * W + 1 + W + Wh + 3;
  const int off_sigma = L * W, off_conn = L * W + 1;
  const int off_branch = off_conn + W, off_rgb = off_branch + Wh;
  const int dy_conn = L * W, dy_branch = dy_conn + W;
  const int dy_sigma = dy_branch + Wh, dy_rgb = dy_sigma + 8;
  const int r0 = blockIdx.x * R;
  float* pb = a.pbias + (size_t)blockIdx.x * NB;

  encode_rows<R>(a, s, r0, XW);
  rows_from_global<R>(a.acts, LA, r0, (L - 1) * W, s.buf0, s.LDH, W);
  __syncthreads();
  bf16* hl = s.buf0;
  bf16* other = s.buf1;
  heads_forward<R>(a, s, r0, hl, other, a.xs, XW);

  // rgb head: d rgb_pre = d rgb * r (1 - r); sigma: d sigma as it is
  if (tid < R) {
    const int g = r0 + tid;
    for (int c = 0; c < 3; ++c) {
      const float r = s.rgb[3 * tid + c];
      const float dv = g < a.N ? a.dout[(size_t)g * 4 + c] : 0.f;
      s.drgb[3 * tid + c] = dv * r * (1.f - r);
    }
    s.dsig[tid] = g < a.N ? a.dout[(size_t)g * 4 + 3] : 0.f;
  }
  __syncthreads();
  if (warp < 4) {            // b_rgb (3) and b_sigma (1): one warp each
    float v = 0.f;
    for (int row = lane; row < R; row += 32)
      v += warp < 3 ? s.drgb[3 * row + warp] : s.dsig[row];
    v = warp_sum(v);
    if (lane == 0) pb[warp < 3 ? off_rgb + warp : off_sigma] = v;
  }
  __syncthreads();
  if (tid < R) {             // bf16 cotangents of the two narrow heads
    bf16* dr = a.dy + (size_t)(r0 + tid) * DYW;
    for (int c = 0; c < 8; ++c) {
      const float v = c < 3 ? s.drgb[3 * tid + c] : 0.f;
      const bf16 vb = __float2bfloat16_rn(v);
      dr[dy_rgb + c] = vb;
      if (c < 3) s.drgb[3 * tid + c] = __bfloat162float(vb);
      dr[dy_sigma + c] = __float2bfloat16_rn(c == 0 ? s.dsig[tid] : 0.f);
    }
    s.dsig[tid] = __bfloat162float(__float2bfloat16_rn(s.dsig[tid]));
  }
  __syncthreads();
  // branch: d br = (d rgb_b @ w_rgb^T) * (br > 0), one column per thread,
  // rows in order, in place over br
  const bf16* w_rgb = a.wpack + trunk_offset(a, L) + W + W * W + W * Wh +
                      DD * Wh;
  for (int j = tid; j < Wh; j += T) {
    const float w0 = __bfloat162float(w_rgb[3 * j]);
    const float w1 = __bfloat162float(w_rgb[3 * j + 1]);
    const float w2 = __bfloat162float(w_rgb[3 * j + 2]);
    float colsum = 0.f;
    for (int row = 0; row < R; ++row) {
      const float* dr = s.drgb + 3 * row;
      float v = dr[0] * w0 + dr[1] * w1 + dr[2] * w2;
      bf16* p = hl + row * s.LDH + j;
      if (!(__bfloat162float(*p) > 0.f)) v = 0.f;
      colsum += v;
      *p = __float2bfloat16_rn(v);
    }
    pb[off_branch + j] = colsum;
  }
  __syncthreads();
  rows_to_global<R>(hl, s.LDH, a.dy, DYW, r0, dy_branch, Wh);

  // conn: d feat = d br_b @ w_branch_h^T (feat has no activation)
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(s.slabs) + 1023) & ~uintptr_t(1023));
  const bf16* w_conn = a.wpack + trunk_offset(a, L) + W;
  cotangent_gemm<R>(hl, s.LDH, Wh, w_conn + (size_t)W * W, W, r0, W,
                    CotangentOut{other, s.LDH, nullptr, 0, nullptr, nullptr,
                                 s.colpart},
                    ring);
  store_colsums<T>(s.colpart, pb, off_conn, W, W, T / 32);
  rows_to_global<R>(other, s.LDH, a.dy, DYW, r0, dy_conn, W);

  // last trunk layer: d h = d feat_b @ w_conn^T + d sigma_b w_sigma^T,
  // masked by h_{L-1} > 0, which is prefetched into the output buffer
  cotangent_gemm<R>(other, s.LDH, W, w_conn, W, r0, W,
                    CotangentOut{hl, s.LDH, a.acts + (L - 1) * W, LA, s.dsig,
                                 a.wpack + trunk_offset(a, L), s.colpart},
                    ring);
  store_colsums<T>(s.colpart, pb, (L - 1) * W, W, W, T / 32);
  rows_to_global<R>(hl, s.LDH, a.dy, DYW, r0, (L - 1) * W, W);

  // trunk: d h_{i-1} = d h_i_b @ W_i^T (the h part at a skip layer)
  bf16* cur = hl;
  bf16* nxt = other;
  for (int i = L - 1; i >= 1; --i) {
    cotangent_gemm<R>(cur, s.LDH, W, a.wpack + trunk_offset(a, i), W, r0,
                      W,
                      CotangentOut{nxt, s.LDH, a.acts + (i - 1) * W, LA,
                                   nullptr, nullptr, s.colpart},
                      ring);
    store_colsums<T>(s.colpart, pb, (i - 1) * W, W, W, T / 32);
    rows_to_global<R>(nxt, s.LDH, a.dy, DYW, r0, (i - 1) * W, W);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// ---- the row pass at the streamed widths ---------------------------------
//
// mlp_train_bwd_rows_kernel's walk on 64-row CTAs (one warpgroup) with no
// activation buffer a whole layer wide: every product streams its A
// operand from device memory in 64 x 64 K tiles beside the weight tiles,
// both by cp.async through a ring of kStreamRowStages stages, and writes
// its output 128 columns at a time (through a 64 x 128 tile in shared
// memory) to where the weight-gradient pass reads it anyway: feat and br
// to xs (A: the saved h_{L-1}, then feat and encd from xs), each layer's
// bf16 cotangent to dy (A: the cotangent of the layer above, from dy),
// ReLU' from the saved activations, each chunk's column sums to the bias
// partials. The heads' forward products read their weights [K, N] N-major
// (wgmma's transposed B), the cotangent products [N, K] K-major, as the
// other widths' row pass. Per row and layer 2 W^2 FLOP against ~4 W bytes
// of operands through L2, as the streamed forward's. The products and
// their ring are train_common.cuh's (stream_rows_gemm, stream_rows_product),
// which siren.cu's streamed row pass shares; kSplitK (above a packed width
// of 1024, kSplitKMinWidth) sums each product's K stage by stage (64 K)
// into an f32 total.

// grid: one CTA per 64 rows up to round_up(N, 128); block: 128 threads.
template <bool kSplitK>
__global__ void __launch_bounds__(128, 1)
    mlp_train_bwd_rows_kernel_stream(TrainArgs a) {
  constexpr int R = 64, T = 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  bf16* C = reinterpret_cast<bf16*>(ring + kStreamRowStages *
                                               kStreamRowStageBytes);
  float* rgb = reinterpret_cast<float*>(C + R * kStreamRowLdc);
  float* drgb = rgb + 3 * R;
  float* dsig = drgb + 3 * R;
  float* colpart = dsig + R;                       // [4][kBwdPassCols]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.width, Wh = W / 2, L = a.n_layers;
  const int DE = a.d_enc_pad, DD = a.d_dir_pad;
  const int XW = DE + DD + W + Wh, DYW = L * W + W + Wh + 16, LA = L * W;
  const int NB = L * W + 1 + W + Wh + 3;
  const int off_sigma = L * W, off_conn = L * W + 1;
  const int off_branch = off_conn + W, off_rgb = off_branch + Wh;
  const int dy_conn = L * W, dy_branch = dy_conn + W;
  const int dy_sigma = dy_branch + Wh, dy_rgb = dy_sigma + 8;
  const int x_feat = DE + DD, x_br = x_feat + W;
  const int r0 = blockIdx.x * R;
  float* pb = a.pbias + (size_t)blockIdx.x * NB;

  {  // the encodings straight to xs (the points and directions staged in
     // the ring, which no product uses yet)
    float* xin = reinterpret_cast<float*>(ring);
    float* din = xin + 3 * R;
    for (int e = tid; e < 3 * R; e += T) {
      const bool in = r0 + e / 3 < a.N;
      xin[e] = in ? a.x[(size_t)r0 * 3 + e] : 0.f;
      din[e] = in ? a.d[(size_t)r0 * 3 + e] : 0.f;
    }
    for (int e = tid; e < 3 * R; e += T) rgb[e] = 0.f;
    __syncthreads();
    const float* freq_x = a.enc;
    const float* mask_x = freq_x + a.n_freqs;
    const float* freq_d = mask_x + a.n_freqs;
    const float* mask_d = freq_d + a.n_freqs_views;
    for (int e = tid; e < R * DE; e += T) {
      const int row = e / DE, col = e - row * DE;
      a.xs[(size_t)(r0 + row) * XW + col] = __float2bfloat16_rn(
          encode_lane(xin + 3 * row, col, a.n_freqs, freq_x, mask_x));
    }
    for (int e = tid; e < R * DD; e += T) {
      const int row = e / DD, col = e - row * DD;
      a.xs[(size_t)(r0 + row) * XW + DE + col] = __float2bfloat16_rn(
          encode_lane(din + 3 * row, col, a.n_freqs_views, freq_d, mask_d));
    }
    __syncthreads();
  }

  // feat = bf16(h_{L-1} @ w_conn + b_conn) to xs
  const bf16* w_conn = a.wpack + trunk_offset(a, L) + W;
  const bf16* w_bh = w_conn + (size_t)W * W;       // [W, Wh]
  const bf16* w_bd = w_bh + (size_t)W * Wh;        // [DD, Wh]
  const bf16* w_rgb = w_bd + DD * Wh;              // [Wh, 3]
  const float* b_conn = a.bpack + L * W + 1;
  {
    const RowSeg seg[1] = {{a.acts + (L - 1) * W, LA, w_conn, W, W}};
    stream_rows_product<true, kSplitK>(
        seg, 1, W, r0, ring, C, nullptr, 0,
        RowChunkOut{b_conn, false, false, nullptr, nullptr, nullptr}, a.xs,
        XW, x_feat, nullptr, 0);
  }
  // br = bf16(relu(feat @ w_branch_h + encd @ w_branch_d + b_branch)) to
  // xs, each chunk's rgb partial dots summed per row in order
  for (int n0 = 0; n0 < Wh; n0 += kBwdPassCols) {
    const RowSeg segs[2] = {{a.xs + x_feat, XW, w_bh, Wh, W},
                            {a.xs + DE, XW, w_bd, Wh, DD}};
    float acc[64];
    stream_rows_gemm<true, kSplitK>(acc, segs, 2, n0, Wh, r0, ring, nullptr,
                                    0, C);
    stream_rows_epilogue(RowChunkOut{b_conn + W, true, false, nullptr,
                                     nullptr, nullptr},
                         acc, n0, C);
    __syncthreads();
    for (int row = warp; row < R; row += T / 32) {
      const bf16* h = C + row * kStreamRowLdc;
      float v0 = 0.f, v1 = 0.f, v2 = 0.f;
      for (int k = lane; k < kBwdPassCols; k += 32) {
        const float hv = __bfloat162float(h[k]);
        const bf16* w = w_rgb + 3 * (n0 + k);
        v0 += hv * __bfloat162float(w[0]);
        v1 += hv * __bfloat162float(w[1]);
        v2 += hv * __bfloat162float(w[2]);
      }
      v0 = warp_sum(v0);
      v1 = warp_sum(v1);
      v2 = warp_sum(v2);
      if (lane == 0) {
        rgb[3 * row] += v0;
        rgb[3 * row + 1] += v1;
        rgb[3 * row + 2] += v2;
      }
    }
    rows_to_global<R>(C, kStreamRowLdc, a.xs, XW, r0, x_br + n0,
                      kBwdPassCols);
    __syncthreads();
  }

  // rgb head: d rgb_pre = d rgb * r (1 - r); sigma: d sigma as it is
  const float* b_rgb = b_conn + W + Wh;
  if (tid < R) {
    const int g = r0 + tid;
    for (int c = 0; c < 3; ++c) {
      const float r = 1.f / (1.f + expf(-(rgb[3 * tid + c] + b_rgb[c])));
      const float dv = g < a.N ? a.dout[(size_t)g * 4 + c] : 0.f;
      drgb[3 * tid + c] = dv * r * (1.f - r);
    }
    dsig[tid] = g < a.N ? a.dout[(size_t)g * 4 + 3] : 0.f;
  }
  __syncthreads();
  if (warp < 4) {            // b_rgb (3) and b_sigma (1): one warp each
    float v = 0.f;
    for (int row = lane; row < R; row += 32)
      v += warp < 3 ? drgb[3 * row + warp] : dsig[row];
    v = warp_sum(v);
    if (lane == 0) pb[warp < 3 ? off_rgb + warp : off_sigma] = v;
  }
  __syncthreads();
  if (tid < R) {             // bf16 cotangents of the two narrow heads
    bf16* dr = a.dy + (size_t)(r0 + tid) * DYW;
    for (int c = 0; c < 8; ++c) {
      const float v = c < 3 ? drgb[3 * tid + c] : 0.f;
      const bf16 vb = __float2bfloat16_rn(v);
      dr[dy_rgb + c] = vb;
      if (c < 3) drgb[3 * tid + c] = __bfloat162float(vb);
      dr[dy_sigma + c] = __float2bfloat16_rn(c == 0 ? dsig[tid] : 0.f);
    }
    dsig[tid] = __bfloat162float(__float2bfloat16_rn(dsig[tid]));
  }
  __syncthreads();
  // branch: d br = (d rgb_b @ w_rgb^T) * (br > 0), one column per thread,
  // rows in order, br read back from xs
  for (int j = tid; j < Wh; j += T) {
    const float w0 = __bfloat162float(w_rgb[3 * j]);
    const float w1 = __bfloat162float(w_rgb[3 * j + 1]);
    const float w2 = __bfloat162float(w_rgb[3 * j + 2]);
    float colsum = 0.f;
    for (int row = 0; row < R; ++row) {
      const float* dr = drgb + 3 * row;
      float v = dr[0] * w0 + dr[1] * w1 + dr[2] * w2;
      const size_t g = r0 + row;
      if (!(__bfloat162float(a.xs[g * XW + x_br + j]) > 0.f)) v = 0.f;
      colsum += v;
      a.dy[g * DYW + dy_branch + j] = __float2bfloat16_rn(v);
    }
    pb[off_branch + j] = colsum;
  }
  __syncthreads();

  // conn: d feat = d br_b @ w_branch_h^T (feat has no activation)
  {
    const RowSeg seg[1] = {{a.dy + dy_branch, DYW, w_bh, Wh, Wh}};
    stream_rows_product<false, kSplitK>(
        seg, 1, W, r0, ring, C, nullptr, 0,
        RowChunkOut{nullptr, false, false, nullptr, nullptr, colpart}, a.dy,
        DYW, dy_conn, pb, off_conn);
  }
  // last trunk layer: d h = d feat_b @ w_conn^T + d sigma_b w_sigma^T,
  // masked by h_{L-1} > 0
  {
    const RowSeg seg[1] = {{a.dy + dy_conn, DYW, w_conn, W, W}};
    stream_rows_product<false, kSplitK>(
        seg, 1, W, r0, ring, C, a.acts + (L - 1) * W, LA,
        RowChunkOut{nullptr, false, true, dsig, a.wpack + trunk_offset(a, L),
                    colpart},
        a.dy, DYW, (L - 1) * W, pb, (L - 1) * W);
  }
  // trunk: d h_{i-1} = d h_i_b @ W_i^T (the h part at a skip layer)
  for (int i = L - 1; i >= 1; --i) {
    const RowSeg seg[1] = {{a.dy + i * W, DYW, a.wpack + trunk_offset(a, i),
                            W, W}};
    stream_rows_product<false, kSplitK>(
        seg, 1, W, r0, ring, C, a.acts + (i - 1) * W, LA,
        RowChunkOut{nullptr, false, true, nullptr, nullptr, colpart}, a.dy,
        DYW, (i - 1) * W, pb, (i - 1) * W);
  }
}

void fill_args(TrainArgs& a, const void* x, const void* d, const void* wpack,
               const void* bpack, const void* enc, int n, int n_layers,
               int skip_mask, int width, int n_freqs, int n_freqs_views,
               int d_enc_pad, int d_dir_pad) {
  a = TrainArgs{};
  a.x = static_cast<const float*>(x);
  a.d = static_cast<const float*>(d);
  a.wpack = static_cast<const bf16*>(wpack);
  a.bpack = static_cast<const float*>(bpack);
  a.enc = static_cast<const float*>(enc);
  a.N = n;
  a.n_layers = n_layers;
  a.skip_mask = skip_mask;
  a.width = width;
  a.n_freqs = n_freqs;
  a.n_freqs_views = n_freqs_views;
  a.d_enc_pad = d_enc_pad;
  a.d_dir_pad = d_dir_pad;
}

}  // namespace
}  // namespace fsnerf

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors validated by the Python wrapper (ops/kernels/mlp_train.py), which
// also allocates every output and scratch buffer. Each launches on `stream`
// and returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue
// for a shape the kernels do not take.

// out [n, 4]; acts [round_up(n, 128), n_layers * width] or null; trunk_rows
// the rows of wpack's [rows, width] view (mlp_train.py::wpack_views); at
// the streamed widths slab [slab_ctas * 64, 2 width] bf16
// scratch (null elsewhere).
extern "C" int fsnerf_mlp_train_fwd(
    const void* x, const void* d, const void* wpack, const void* bpack,
    const void* enc, void* out, void* acts, void* slab, int slab_ctas, int n,
    int n_layers, int skip_mask, int width, int n_freqs, int n_freqs_views,
    int d_enc_pad, int d_dir_pad, int trunk_rows, void* stream) {
  using namespace fsnerf;
  TrainArgs a;
  fill_args(a, x, d, wpack, bpack, enc, n, n_layers, skip_mask, width,
            n_freqs, n_freqs_views, d_enc_pad, d_dir_pad);
  a.out = static_cast<float*>(out);
  a.acts = static_cast<bf16*>(acts);
  return static_cast<int>(launch_fwd(a, trunk_rows,
                                     static_cast<const bf16*>(slab),
                                     slab_ctas,
                                     static_cast<cudaStream_t>(stream)));
}

// dw [n_w], db [n_b]: bf16-rounded gradients in the wpack / bpack layouts.
// acts is the forward's stream, or with fwd_out ([n, 4] scratch) the
// buffer the forward kernel writes it into first (recompute mode; at 768
// and 1024 with the forward's slab); xs, dy, pbias and part are scratch of
// the shapes documented in TrainArgs and train_common.cuh::dw_gemm_kernel;
// jobs [n_jobs, 6] and tiles [n_tiles, 3] int32.
extern "C" int fsnerf_mlp_train_bwd(
    const void* x, const void* d, const void* dout, const void* wpack,
    const void* bpack, const void* enc, void* acts, void* fwd_out,
    void* slab, int slab_ctas, void* xs, void* dy, void* pbias,
    const void* jobs, const void* tiles, int n_tiles, void* part,
    int split_rows, void* dw, void* db, int n, int n_layers, int skip_mask,
    int width, int n_freqs, int n_freqs_views, int d_enc_pad, int d_dir_pad,
    int trunk_rows, void* stream) {
  using namespace fsnerf;
  TrainArgs a;
  fill_args(a, x, d, wpack, bpack, enc, n, n_layers, skip_mask, width,
            n_freqs, n_freqs_views, d_enc_pad, d_dir_pad);
  if (packed_weights(a) > kMaxPackedWeights)
    return static_cast<int>(cudaErrorInvalidValue);
  a.acts = static_cast<bf16*>(acts);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (fwd_out != nullptr) {
    a.out = static_cast<float*>(fwd_out);
    err = launch_fwd(a, trunk_rows, static_cast<const bf16*>(slab),
                     slab_ctas, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  a.dout = static_cast<const float*>(dout);
  a.xs = static_cast<bf16*>(xs);
  a.dy = static_cast<bf16*>(dy);
  a.pbias = static_cast<float*>(pbias);
  // every row up to round_up(n, 128), in CTAs of R rows
  const int R = bwd_rows(width);
  const int n_blocks = (n + kRows - 1) / kRows * (kRows / R);
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const bool streamed = stream_width(width);
  const size_t smem =
      streamed ? stream_rows_smem_bytes() : smem_bytes(width, d_dir_pad);
  const auto rows_kernel = streamed
                               ? (width >= kSplitKMinWidth
                                      ? mlp_train_bwd_rows_kernel_stream<true>
                                      : mlp_train_bwd_rows_kernel_stream<false>)
                           : R == kRows ? mlp_train_bwd_rows_kernel<kRows>
                                        : mlp_train_bwd_rows_kernel<64>;
  err = cudaFuncSetAttribute(rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  rows_kernel<<<n_blocks, 2 * R, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int Wh = width / 2;
  const int n_w = static_cast<int>(packed_weights(a));
  const int n_b = n_layers * width + 1 + width + Wh + 3;
  return static_cast<int>(launch_dw(
      static_cast<const bf16*>(acts), n_layers * width,
      static_cast<const bf16*>(xs), d_enc_pad + d_dir_pad + width + Wh,
      static_cast<const bf16*>(dy), n_layers * width + width + Wh + 16,
      static_cast<const int*>(tiles), n_tiles, static_cast<const int*>(jobs),
      static_cast<float*>(part), n_w, split_rows,
      static_cast<const float*>(pbias), n_blocks, n_b, 1,
      static_cast<float*>(dw), static_cast<float*>(db), st, R));
}

// The weight-gradient pass alone (the backward's last two launches) over
// operands already in device memory: dw [n_w] = bf16(sum over splits of
// X^T dY) for each job, X from acts [n_rows, ld_acts] or xs [n_rows,
// ld_xs], dY from dy [n_rows, ld_dy]; n_rows a multiple of 128, part
// [ceil(n_rows / split_rows), n_w] f32 scratch.
extern "C" int fsnerf_dw_pass(const void* acts, int ld_acts, const void* xs,
                              int ld_xs, const void* dy, int ld_dy,
                              int n_rows, const void* jobs, const void* tiles,
                              int n_tiles, void* part, int n_w,
                              int split_rows, void* dw, void* stream) {
  using namespace fsnerf;
  return static_cast<int>(launch_dw(
      static_cast<const bf16*>(acts), ld_acts, static_cast<const bf16*>(xs),
      ld_xs, static_cast<const bf16*>(dy), ld_dy,
      static_cast<const int*>(tiles), n_tiles, static_cast<const int*>(jobs),
      static_cast<float*>(part), n_w, split_rows, nullptr, n_rows / kRows, 0,
      1, static_cast<float*>(dw), nullptr,
      static_cast<cudaStream_t>(stream)));
}
