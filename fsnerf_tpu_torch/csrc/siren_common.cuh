// The SiNeRF (SIREN) MLP on a 128-row tile, shared by the SIREN ray march of
// render.cu and the SIREN train kernels of siren.cu: the sine epilogue of
// the GEMM core, the trunk and the forward heads, in two shapes. The
// mma.sync shape (SineEpi, siren_trunk, siren_mlp_rows: one CTA of 8
// warps, each phase behind __syncthreads()) serves the backward's
// recompute mode up to width 256 and the forward and the march at 288 and
// 320 (its buffers' shared memory), which no packer lays out any more; the
// warp-specialized shape (SineAct, siren_produce_pass, siren_heads, at the
// end: ws_trunk.cuh's producer, ring, products and epilogue with a sine
// activation) serves the forward and the march at widths 64, 128, 192 and
// 256, on the column-split trunk (siren_produce_pass_split,
// siren_heads_split) at 384 and 512, and on the streamed trunk
// (siren_produce_pass_stream, siren_heads_stream) at 768 and 1024.
//
// Numerics, as the TPU kernels (fsnerf_tpu/ops/pallas/siren.py::_fwd_siren,
// _heads_siren): bf16 operands and f32 accumulation; the f32 bias is added
// to the accumulator (not rounded), then the sine argument a * y stays f32
// and h = bf16(sin_fast(a * y)), the polynomial of fastmath.cuh. The first
// layer reads the raw coordinates (bf16, zero-padded to 16 columns). Heads:
// s_s = bf16(sin(h W_s0 + b_s0)), sigma = relu(s_s . w_s1 + b_s1), feat =
// bf16(h W_f + b_f), s_r = bf16(sin(feat W_r0f + dirs W_r0d + b_r0)), rgb
// an f32 sigmoid of s_r W_r1 + b_r1.
//
// Weights (ops/kernels/siren.py::prep_siren_params): wpack holds the bf16
// [in, out] matrices t_0 [16, W], t_1 .. t_{L-1} [W, W], w_s0 [W, W/2],
// w_s1 [W/2], w_f [W, W], w_r0f [W, W/2], w_r0d [16, W/2], w_r1 [W/2, 3];
// bpack the f32 biases b_0 .. b_{L-1} [W], b_s0 [W/2], b_s1, b_f [W], b_r0
// [W/2], b_r1 [3]; alphas the per-layer frequencies [L].

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"
#include "ws_trunk.cuh"

namespace fsnerf {
namespace {

constexpr int kInPad = 16;             // raw input columns (3 real)
constexpr int kLdIn = kInPad + kPad;   // their shared row stride

struct Siren {
  const bf16* wpack;
  const float* bpack;
  const float* alphas;
  int n_layers, width;

  __device__ __forceinline__ const bf16* t(int i) const {
    return i == 0 ? wpack
                  : wpack + (size_t)kInPad * width +
                        (size_t)(i - 1) * width * width;
  }
  // the head matrices, in walk order
  __device__ __forceinline__ const bf16* ws0() const { return t(n_layers); }
  __device__ __forceinline__ const bf16* ws1() const {
    return ws0() + width * (width / 2);
  }
  __device__ __forceinline__ const bf16* wf() const {
    return ws1() + width / 2;
  }
  __device__ __forceinline__ const bf16* wr0f() const {
    return wf() + width * width;
  }
  __device__ __forceinline__ const bf16* wr0d() const {
    return wr0f() + width * (width / 2);
  }
  __device__ __forceinline__ const bf16* wr1() const {
    return wr0d() + kInPad * (width / 2);
  }
  // bias offsets in bpack
  __device__ __forceinline__ int ob_s0() const { return n_layers * width; }
  __device__ __forceinline__ int ob_s1() const { return ob_s0() + width / 2; }
  __device__ __forceinline__ int ob_f() const { return ob_s1() + 1; }
  __device__ __forceinline__ int ob_r0() const { return ob_f() + width; }
  __device__ __forceinline__ int ob_r1() const { return ob_r0() + width / 2; }
};

// The sine epilogue: y = acc + bias (f32), arg = alpha * y, C =
// bf16(sin_fast(arg)) in shared memory; with cb, bf16(alpha *
// cos_fast(arg)) at cb[row * ldcb + col] (device memory, the saved factor);
// with cf, the same in f32 at cf[row * ldcf + col] (device or shared
// memory).
struct SineEpi {
  const float* bias;
  float alpha;
  bf16* C;
  int ldc;
  bf16* cb;
  int ldcb;
  float* cf;
  int ldcf;
  __device__ __forceinline__ void operator()(int row, int col,
                                             const float (&c)[2][4]) const {
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 16 * i + 8 * h;
        const float a0 = __fmul_rn(alpha, __fadd_rn(c[i][2 * h], b0));
        const float a1 = __fmul_rn(alpha, __fadd_rn(c[i][2 * h + 1], b1));
        *reinterpret_cast<__nv_bfloat162*>(C + r * ldc + col) =
            __floats2bfloat162_rn(sin_fast(a0), sin_fast(a1));
        if (cb || cf) {
          const float k0 = __fmul_rn(alpha, cos_fast(a0));
          const float k1 = __fmul_rn(alpha, cos_fast(a1));
          if (cb)
            *reinterpret_cast<__nv_bfloat162*>(cb + (size_t)r * ldcb + col) =
                __floats2bfloat162_rn(k0, k1);
          if (cf)
            *reinterpret_cast<float2*>(cf + (size_t)r * ldcf + col) =
                make_float2(k0, k1);
        }
      }
    }
  }
};

// The sine trunk on the staged inputs xin [kRows, kLdIn]; returns the
// buffer (buf0 or buf1, [kRows, W + kPad]) holding h_{L-1}. With acts
// (device memory, row stride lda, at the tile's row 0) each h_i goes to
// columns [i W, (i + 1) W); with save_c also bf16(a_i cos(a_i y_i)) to
// [(L + i) W, (L + i + 1) W). With cf (device memory, row stride L W, at the
// tile's row 0) the f32 factors go to [i W, (i + 1) W). Ends with a barrier.
__device__ bf16* siren_trunk(const Siren& m, const bf16* xin, bf16* buf0,
                             bf16* buf1, bf16* slabs, bf16* acts, int lda,
                             bool save_c, float* cf) {
  const int W = m.width, L = m.n_layers, LDH = W + kPad;
  const Seg none = {nullptr, 0, nullptr, 0};
  bf16* hin = nullptr;
  bf16* hout = buf0;
  for (int i = 0; i < L; ++i) {
    SineEpi epi{m.bpack + i * W,
                m.alphas[i],
                hout,
                LDH,
                save_c ? acts + (size_t)(L + i) * W : nullptr,
                lda,
                cf ? cf + (size_t)i * W : nullptr,
                L * W};
    const Seg a = i == 0 ? Seg{xin, kLdIn, m.t(0), kInPad}
                         : Seg{hin, LDH, m.t(i), W};
    gemm(a, none, W, slabs, epi);
    __syncthreads();
    if (acts) rows_to_global(hout, LDH, acts, lda, 0, i * W, W);
    hin = hout;
    hout = (hout == buf0) ? buf1 : buf0;
  }
  return hin;
}

// rgb[3 row] = sigmoid(s_r[row] . w_r1 + b_r1) for rows < nrows: a warp per
// row, lanes across k.
__device__ __forceinline__ void siren_rgb(const Siren& m, const bf16* s_r,
                                          int ld, int nrows, float* rgb) {
  const int Wh = m.width / 2, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* w = m.wr1();
  const float* b = m.bpack + m.ob_r1();
  for (int row = warp; row < nrows; row += kThreads / 32) {
    const bf16* h = s_r + row * ld;
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
      rgb[3 * row] = 1.f / (1.f + expf(-v0));
      rgb[3 * row + 1] = 1.f / (1.f + expf(-v1));
      rgb[3 * row + 2] = 1.f / (1.f + expf(-v2));
    }
  }
}

// sigma_pre[row] = s_s[row] . w_s1 + b_s1 for rows < nrows: a warp per row.
template <class Fn>
__device__ __forceinline__ void siren_sigma_pre(const Siren& m,
                                                const bf16* s_s, int ld,
                                                int nrows, Fn&& use) {
  const int Wh = m.width / 2, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bf16* w = m.ws1();
  const float b = m.bpack[m.ob_s1()];
  for (int row = warp; row < nrows; row += kThreads / 32) {
    const bf16* h = s_s + row * ld;
    float v = 0.f;
    for (int k = lane; k < Wh; k += 32)
      v += __bfloat162float(h[k]) * __bfloat162float(w[k]);
    v = warp_sum(v) + b;
    if (lane == 0) use(row, v);
  }
}

// The forward SiNeRF MLP on the staged inputs xin, din [kRows, kLdIn]:
// sig[row] and rgb[3 row] (shared, f32) for rows < nrows. acts / lda /
// save_c as siren_trunk (null: nothing saved). Ends with a barrier.
__device__ void siren_mlp_rows(const Siren& m, const bf16* xin,
                               const bf16* din, bf16* buf0, bf16* buf1,
                               bf16* slabs, int nrows, float* sig, float* rgb,
                               bf16* acts, int lda, bool save_c) {
  const int W = m.width, Wh = W / 2, LDH = W + kPad;
  const Seg none = {nullptr, 0, nullptr, 0};
  bf16* hl = siren_trunk(m, xin, buf0, buf1, slabs, acts, lda, save_c,
                         nullptr);
  bf16* other = hl == buf0 ? buf1 : buf0;
  // sigma head: s_s into other, then a warp per row
  SineEpi s_epi{m.bpack + m.ob_s0(), 1.f, other, LDH, nullptr, 0, nullptr,
                0};
  gemm(Seg{hl, LDH, m.ws0(), W}, none, Wh, slabs, s_epi);
  __syncthreads();
  siren_sigma_pre(m, other, LDH, nrows,
                  [&](int row, float v) { sig[row] = fmaxf(v, 0.f); });
  // feat into other (the gemm's first barrier ends the reads of s_s), then
  // s_r = sin(feat W_r0f + dirs W_r0d + b_r0) into hl
  gemm_layer(Seg{hl, LDH, m.wf(), W}, none, m.bpack + m.ob_f(), W, false,
             other, LDH, slabs);
  __syncthreads();
  SineEpi r_epi{m.bpack + m.ob_r0(), 1.f, hl, LDH, nullptr, 0, nullptr, 0};
  gemm(Seg{other, LDH, m.wr0f(), W}, Seg{din, kLdIn, m.wr0d(), kInPad}, Wh,
       slabs, r_epi);
  __syncthreads();
  siren_rgb(m, hl, LDH, nrows, rgb);
  __syncthreads();
}

// ---- the warp-specialized shape (widths 64 ... 256, 384, 512) ----------
//
// ws_trunk.cuh's trunk with the sine activation, then the heads as the
// saved-mode backward's row pass (siren.cu, ws_bwd_consume) computes them,
// all on wgmma with A a consumer's tile in shared memory and B the ring's
// stage. The producer streams t_0 (K 16: one stage, of which the consumers
// run one k16 step; its rows past 16 are t_1's), t_1 .. t_{L-1}, then
// w_s0, w_f and w_r0f. The first layer's A is a one-block (64 x 64) tile
// holding the rows' bf16 coordinates in columns 0..15 (3 real).

// The weight maps: the trunk [16 + (L - 1) W, W] (wpack's first rows) and
// the heads' [in, out] blocks w_s0 [W, W/2], w_f [W, W], w_r0f [W, W/2].
struct SirenFwdMaps {
  CUtensorMap t, s0, f, r0;
};

// The heads' maps of wpack (the backward's row pass reads the same three).
// False if one cannot be encoded.
bool encode_siren_head_maps(CUtensorMap* s0, CUtensorMap* f,
                            CUtensorMap* r0, const bf16* wpack, int L,
                            int W) {
  const int Wh = W / 2;
  const bf16* w_s0 = wpack + (size_t)kInPad * W + (size_t)(L - 1) * W * W;
  const bf16* w_f = w_s0 + (size_t)W * Wh + Wh;
  const bf16* w_r0f = w_f + (size_t)W * W;
  return encode_bf16_map(s0, w_s0, W, Wh, Wh, 64) &&
         encode_bf16_map(f, w_f, W, W, W, 64) &&
         encode_bf16_map(r0, w_r0f, W, Wh, Wh, 64);
}

bool encode_siren_fwd_maps(SirenFwdMaps* mp, const bf16* wpack, int L,
                           int W) {
  return encode_bf16_map(&mp->t, wpack, kInPad + (L - 1) * W, W, W, 64) &&
         encode_siren_head_maps(&mp->s0, &mp->f, &mp->r0, wpack, L, W);
}

// The producer's pass over every weight tile of the forward, in the
// consumers' order; `it` and `done` as feed_stages'.
template <int W>
__device__ __forceinline__ bool siren_produce_pass(
    const SirenFwdMaps& mp, int L, unsigned char* ring, uint64_t* full,
    uint64_t* empty, int n_stages, int& it, const volatile int* done) {
  constexpr int NS = head_n(W);                   // the heads' product N
  auto feed = [&](const CUtensorMap* map, int k, int n_box) {
    return feed_stages<W>(map, 0, k, n_box, ring, full, empty, n_stages, it,
                          done);
  };
  return produce_pass<W, NS>(&mp.t, nullptr, FwdShape{L, 0, kInPad, 0},
                             false, ring, full, empty, n_stages, it, done) &&
         feed(&mp.s0, W, NS / 64) && feed(&mp.f, W, W / 64) &&
         feed(&mp.r0, W, NS / 64);
}

// siren_produce_pass at a split width (384, 512): the trunk through
// produce_pass_split (t_0's K 16 read from one stage, as above), then the
// heads in siren_heads_split's order, each stage 64 K-rows x W / 2: w_s0
// (N = head_n(W) = W / 2, K = W over both input halves), w_f as two output
// halves, w_r0f (N = W / 2).
template <int W>
__device__ __forceinline__ bool siren_produce_pass_split(
    const SirenFwdMaps& mp, int L, unsigned char* ring, uint64_t* full,
    uint64_t* empty, int n_stages, int& it, const volatile int* done) {
  constexpr int Wh = W / 2;
  auto feed = [&](const CUtensorMap* map, int col0) {
    return feed_stages<Wh>(map, 0, W, Wh / 64, ring, full, empty, n_stages,
                           it, done, col0);
  };
  return produce_pass_split<W, Wh>(&mp.t, nullptr,
                                   FwdShape{L, 0, kInPad, 0}, false, ring,
                                   full, empty, n_stages, it, done) &&
         feed(&mp.s0, 0) && feed(&mp.f, 0) && feed(&mp.f, Wh) &&
         feed(&mp.r0, 0);
}

// The sine layer's activation in fwd_epilogue, numerically SineEpi's: (v0,
// v1) = acc + b (f32, the bias not rounded), arg = alpha v, the pair
// sin_fast(arg). With kSave, also the factor bf16(alpha cos_fast(arg)): a
// chunk's factors stay in registers, go by stmatrix into the consumer's
// 64 x 64 staging block, and its lead thread stores the block by TMA to
// acts (map, column gcol + the chunk's, rows from row0) once every warp
// has written it (bar: the warpgroup's named barrier). Saving is a
// template parameter, so the no-save launch carries none of the factor's
// work.
template <bool kSave>
struct SineAct {
  float alpha;
  unsigned char* stage;
  const CUtensorMap* map;
  int gcol, row0, bar;
  bool lead;
  uint32_t fp[8][2];
  __device__ __forceinline__ float2 operator()(float v0, float v1, int h,
                                               int jj) {
    const float a0 = __fmul_rn(alpha, v0), a1 = __fmul_rn(alpha, v1);
    float c0, c1;
    const float s0 = sin_cos_fast<kSave>(a0, &c0);
    const float s1 = sin_cos_fast<kSave>(a1, &c1);
    if (kSave) {
      const __nv_bfloat162 f =
          __floats2bfloat162_rn(__fmul_rn(alpha, c0), __fmul_rn(alpha, c1));
      fp[jj][h] = *reinterpret_cast<const uint32_t*>(&f);
    }
    return make_float2(s0, s1);
  }
  __device__ __forceinline__ void chunk_end(int j0) {
    if (!kSave) return;
    const int lane = threadIdx.x & 31, m = lane >> 3;
    const int srow = 16 * ((threadIdx.x >> 5) & 3) + 8 * (m & 1) + (lane & 7);
    if (lead) bulk_wait_read<0>();     // the last chunk's store has read it
    named_bar(bar, 128);
#pragma unroll
    for (int jj = 0; jj < 8; jj += 2)
      stsm_x4(smem_u32(tile_at(stage, srow, 8 * (jj + (m >> 1)))),
              fp[jj][0], fp[jj][1], fp[jj + 1][0], fp[jj + 1][1]);
    fence_proxy_async();
    named_bar(bar, 128);
    if (lead) {
      tma_store_2d(map, stage, gcol + 8 * j0, row0);
      bulk_commit();
    }
  }
};

// The SIREN trunk's activation of layer i, for fwd_trunk and
// fwd_trunk_split: a_i's sine; with kSave its factor to columns (L + i) W
// + col of acts (gcol0 = L W; col the output half's first column in a
// split layer), the rest as SineAct's. No sigma head rides on the trunk.
template <bool kSave>
struct SineActs {
  static constexpr bool kSigma = false;
  const float* alphas;
  int width;
  unsigned char* stage;
  const CUtensorMap* map;
  int gcol0, row0, bar;
  bool lead;
  __device__ __forceinline__ SineAct<kSave> layer(int i, int col = 0) const {
    SineAct<kSave> a;
    a.alpha = alphas[i];
    a.stage = stage;
    a.map = map;
    a.gcol = gcol0 + i * width + col;
    a.row0 = row0;
    a.bar = bar;
    a.lead = lead;
    return a;
  }
};

// The rows' view directions for siren_heads: dirs(h, k) is coordinate k
// of the bf16 direction of this thread's row h. RowDirs holds them in
// registers; SharedDirs reads them from a shared array of 4 floats a row
// (rows, at this thread's first row), which keeps them out of the
// registers through the trunk.
struct RowDirs {
  float v[2][3];
  __device__ __forceinline__ float operator()(int h, int k) const {
    return v[h][k];
  }
};

struct SharedDirs {
  const float* rows;
  __device__ __forceinline__ float operator()(int h, int k) const {
    return rows[32 * h + k];
  }
};

// The sigma head's epilogue on acc_s = h W_s0 (no bias yet), for this
// thread's rows 16 warp + lane / 4 + 8 h: sigma[h] = relu(s_s . w_s1 +
// b_s1) with s_s = bf16(sin(acc_s + b_s0)), per-thread dots over its
// columns and two quad shuffles.
// ... its partial dots over NJ column blocks from column c0 (acc_s's
// first NJ blocks: a chunk of the streamed heads), added to sp[h].
template <int NJ, int NACC>
__device__ __forceinline__ void siren_sigma_part(const float (&acc_s)[NACC],
                                                 const Siren& m, int c0,
                                                 float (&sp)[2]) {
  const int lane = threadIdx.x & 31;
  const float* b_s0 = m.bpack + m.ob_s0();
  const bf16* w_s1 = m.ws1();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int col = c0 + 8 * j + 2 * (lane & 3);
    const float b0 = b_s0[col], b1 = b_s0[col + 1];
    const float w0 = __bfloat162float(w_s1[col]);
    const float w1 = __bfloat162float(w_s1[col + 1]);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(
          sin_fast(__fadd_rn(acc_s[4 * j + 2 * h], b0)),
          sin_fast(__fadd_rn(acc_s[4 * j + 2 * h + 1], b1)));
      sp[h] += __low2float(p) * w0 + __high2float(p) * w1;
    }
  }
}

// sigma[h] = relu(quad sum of the partial dots sp[h] + b_s1).
__device__ __forceinline__ void siren_sigma_end(const float (&sp)[2],
                                                const Siren& m,
                                                float (&sigma)[2]) {
  const float b_s1 = m.bpack[m.ob_s1()];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sigma[h] = fmaxf(quad_sum(sp[h]) + b_s1, 0.f);
}

template <int Wh, int NACC>
__device__ __forceinline__ void siren_sigma_out(const float (&acc_s)[NACC],
                                                const Siren& m,
                                                float (&sigma)[2]) {
  float sp[2] = {0.f, 0.f};
  siren_sigma_part<Wh / 8>(acc_s, m, 0, sp);
  siren_sigma_end(sp, m, sigma);
}

// The rgb head's epilogue on acc_s = feat W_r0f (no bias yet): rgb[h] =
// sigmoid(s_r . w_r1 + b_r1) with s_r = bf16(sin(acc_s + d W_r0d +
// b_r0)), the directions' term a rank-3 update from dirs (RowDirs or
// SharedDirs).
// ... its partial dots over NJ column blocks from column c0 (a chunk of
// the streamed heads; wh the heads' width W / 2), added to rp[h].
template <int NJ, int NACC, class Dirs>
__device__ __forceinline__ void siren_rgb_part(const float (&acc_s)[NACC],
                                               const Siren& m, int wh,
                                               int c0, const Dirs& dirs,
                                               float (&rp)[2][3]) {
  const int lane = threadIdx.x & 31;
  const float* b_r0 = m.bpack + m.ob_r0();
  const bf16* w_r0d = m.wr0d();
  const bf16* w_r1 = m.wr1();
  float dir[2][3];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 3; ++k) dir[h][k] = dirs(h, k);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = c0 + 8 * j + 2 * (lane & 3) + e;
      float wd[3], wr[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        wd[k] = __bfloat162float(w_r0d[k * wh + col]);
        wr[k] = __bfloat162float(w_r1[3 * col + k]);
      }
      const float b = b_r0[col];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float dterm = __fadd_rn(__fadd_rn(__fmul_rn(dir[h][0], wd[0]),
                                                __fmul_rn(dir[h][1], wd[1])),
                                      __fmul_rn(dir[h][2], wd[2]));
        const float y = __fadd_rn(__fadd_rn(acc_s[4 * j + 2 * h + e], dterm),
                                  b);
        const float sv = __bfloat162float(__float2bfloat16_rn(sin_fast(y)));
#pragma unroll
        for (int k = 0; k < 3; ++k) rp[h][k] += sv * wr[k];
      }
    }
  }
}

// rgb[h][c] = sigmoid(quad sum of the partial dots rp[h][c] + b_r1[c]).
__device__ __forceinline__ void siren_rgb_end(const float (&rp)[2][3],
                                              const Siren& m,
                                              float (&rgb)[2][3]) {
  const float* b_r1 = m.bpack + m.ob_r1();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[h][c] = 1.f / (1.f + expf(-(quad_sum(rp[h][c]) + b_r1[c])));
}

template <int Wh, int NACC, class Dirs>
__device__ __forceinline__ void siren_rgb_out(const float (&acc_s)[NACC],
                                              const Siren& m,
                                              const Dirs& dirs,
                                              float (&rgb)[2][3]) {
  float rp[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  siren_rgb_part<Wh / 8>(acc_s, m, Wh, 0, dirs, rp);
  siren_rgb_end(rp, m, rgb);
}

// The heads after the trunk (act holding h_{L-1}), for this thread's rows
// 16 warp + lane / 4 + 8 h: sigma (siren_sigma_out) from h W_s0; feat =
// bf16(h W_f + b_f) over act; rgb (siren_rgb_out) from feat W_r0f.
// Every product accumulates into the trunk's acc (the heads' N-wide ones
// into its first NS / 2): wgmma reads its accumulators, so in the march's
// chunk loop a second array would stay live across the trunk (and spill).
template <int W, class Dirs>
__device__ __forceinline__ void siren_heads(float (&acc)[W / 2], FwdRing& r,
                                            unsigned char* act,
                                            const Siren& m,
                                            const Dirs& dirs, int bar,
                                            float (&sigma)[2],
                                            float (&rgb)[2][3]) {
  constexpr int Wh = W / 2, NS = head_n(W);
  float(&acc_s)[NS / 2] = *reinterpret_cast<float(*)[NS / 2]>(&acc);
  fwd_product(acc_s, smem_u32(act), W, true, r);
  siren_sigma_out<Wh>(acc_s, m, sigma);
  fwd_conn<W>(acc, r, act, m.bpack + m.ob_f(), bar);
  fwd_product(acc_s, smem_u32(act), W, true, r);
  siren_rgb_out<Wh>(acc_s, m, dirs, rgb);
}

// siren_heads at a split width (h_{L-1} in t.in0, t.in1): the heads' N =
// head_n(W) = W / 2 products are exactly the split trunk's accumulator, a
// product over both input halves each; feat through fwd_conn_split, in
// (t.in0, t.in1) after it.
template <int W, class Dirs>
__device__ __forceinline__ void siren_heads_split(float (&acc)[W / 4],
                                                  FwdRing& r,
                                                  SplitActs<W>& t,
                                                  const Siren& m,
                                                  const Dirs& dirs, int bar,
                                                  float (&sigma)[2],
                                                  float (&rgb)[2][3]) {
  constexpr int Wh = W / 2;
  static_assert(head_n(W) == Wh, "the heads' N is one split half");
  split_product<W>(acc, t, r);
  siren_sigma_out<Wh>(acc, m, sigma);
  fwd_conn_split<W>(acc, r, t, m.bpack + m.ob_f(), bar);
  split_product<W>(acc, t, r);
  siren_rgb_out<Wh>(acc, m, dirs, rgb);
}

// ---- the streamed shape (widths 768 and 1024) --------------------------
//
// ws_trunk.cuh's streamed trunk with the sine activation (one 64-row
// consumer, each layer in 256-column chunks through device memory and back
// from L2), then the heads as streamed chunks of kStreamBranchCols = 128
// columns of one m64n128 accumulator (the trunk's first 64 registers, as
// siren_heads'): s_s = sin(h W_s0 + b_s0) over W / 256 chunks, its sigma
// partial dots summed in registers; feat = bf16(h W_f + b_f) through
// stream_conn into the CTA's scratch slot; s_r = sin(feat W_r0f + dirs
// W_r0d + b_r0) over W / 256 chunks, the directions' term the rank-3
// update of the other widths (siren_rgb_part), its rgb partial dots summed,
// then the sigmoid. The numerics are every other width's.

// The producer's pass at a streamed width: the trunk through
// produce_pass_stream (t_0's K 16 read from one stage, as above), then the
// heads in siren_heads_stream's order, each stage 64 K-rows of one chunk's
// columns: w_s0's 128-column chunks, w_f's 256-column chunks, w_r0f's
// 128-column chunks.
__device__ __forceinline__ bool siren_produce_pass_stream(
    const SirenFwdMaps& mp, int L, int W, unsigned char* ring,
    uint64_t* full, uint64_t* empty, int n_stages, int& it,
    const volatile int* done) {
  auto feed = [&](const CUtensorMap* map, int cols, int n) {
    for (int c = 0; c < n; ++c)
      if (!feed_stages<kStreamCols>(map, 0, W, cols / 64, ring, full, empty,
                                    n_stages, it, done, c * cols))
        return false;
    return true;
  };
  const int nh = W / 2 / kStreamBranchCols;
  return produce_pass_stream(&mp.t, nullptr, W, FwdShape{L, 0, kInPad, 0},
                             false, ring, full, empty, n_stages, it, done) &&
         feed(&mp.s0, kStreamBranchCols, nh) &&
         feed(&mp.f, kStreamCols, W / kStreamCols) &&
         feed(&mp.r0, kStreamBranchCols, nh);
}

// The heads after stream_trunk (h_{L-1} at io.at(L - 1), flushed), for this
// thread's rows 16 warp + lane / 4 + 8 h: sigma[h] and rgb[h][c]; feat
// goes to io.at(L). acc is the trunk's accumulator.
template <class Dirs>
__device__ __forceinline__ void siren_heads_stream(
    float (&acc)[kStreamCols / 2], FwdRing& r, ARing& ar,
    const StreamTiles& s, const Siren& m, const Dirs& dirs, int bar,
    const StreamBufs& io, float (&sigma)[2], float (&rgb)[2][3]) {
  constexpr int NC = kStreamBranchCols;
  const int W = m.width, Wh = W / 2, nh = Wh / NC;
  float(&acc_h)[NC / 2] = *reinterpret_cast<float(*)[NC / 2]>(&acc);
  float sp[2] = {0.f, 0.f};
  const AStream hs = stream_begin(ar, io.at(io.L - 1), W, nh, r.lead);
  for (int n = 0; n < nh; ++n) {
    stream_chunk(acc_h, r, ar, hs, 0, 0);
    siren_sigma_part<NC / 8>(acc_h, m, n * NC, sp);
  }
  siren_sigma_end(sp, m, sigma);
  stream_conn(acc, r, ar, s, W, m.bpack + m.ob_f(), bar, io);
  float rp[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
  const AStream fs = stream_begin(ar, io.at(io.L), W, nh, r.lead);
  for (int n = 0; n < nh; ++n) {
    stream_chunk(acc_h, r, ar, fs, 0, 0);
    siren_rgb_part<NC / 8>(acc_h, m, Wh, n * NC, dirs, rp);
  }
  siren_rgb_end(rp, m, rgb);
}

}  // namespace
}  // namespace fsnerf
