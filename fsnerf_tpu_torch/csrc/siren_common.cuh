// The SiNeRF (SIREN) MLP on a 128-row tile, shared by the SIREN ray march of
// render.cu and the SIREN train kernels of siren.cu: the sine epilogue of
// the GEMM core, the trunk and the forward heads.
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

}  // namespace
}  // namespace fsnerf
