// SiNeRF (SIREN) MLP training kernels for Hopper (sm_90a): the forward
// (optionally streaming each sine activation and its premultiplied
// derivative to HBM) and the backward to bf16 weight and f32 bias
// gradients.
//
// Replaces fsnerf_tpu/ops/pallas/siren.py::make_fused_siren_mlp, whose
// custom VJP runs two Pallas TPU kernels: fwd_call (kernel 7; here
// siren_fwd_kernel) and bwd_call (kernel 8; here siren_bwd_rows_kernel,
// then dw_tiles_kernel and dw_reduce_kernel of train_common.cuh). Plain
// PyTorch twins: fsnerf_tpu_torch/ops/kernels/siren.py::
// siren_mlp_fwd_reference / siren_mlp_bwd_reference.
//
// What bounds them on this card. A row of SiNeRF 8x256 costs ~1.18 MFLOP of
// bf16 GEMMs forward and ~2.6 MFLOP backward (the head recompute, the
// input-cotangent products and the weight-gradient products), plus ~2,300
// polynomial sines per row on the FP32 pipe. Saving the activations streams
// 8 KB per row (h_i and a_i cos(a_i y_i), bf16, 8 layers x 256) out and the
// backward reads them back: at the main path's 196,608 rows that stream
// (1.61 GB) bounds the forward by bytes, and the backward sits near the
// balance of bytes and operations. The GEMMs run on the tensor cores
// (mma.sync m16n8k16 bf16, f32 accumulation) through the GEMM core of
// mlp_common.cuh; the sines run in the GEMM epilogues, so no f32
// pre-activation ever leaves the SM in the forward.
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
// Shared memory of the backward row pass at width 256: two [128 x 264] bf16
// activation buffers (the heads' f32 cos factors borrow one of them as a
// [128 x 128] f32 array), a [128 x 136] bf16 head buffer, the staged inputs
// and the weight slabs: ~220 KB, one CTA per SM.
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
  store_colsums(colpart, pb, m.ob_f(), W, W);
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
  store_colsums(colpart, pb, (L - 1) * W, W, W);
  rows_to_global(cur, LDH, a.dy, DYW, r0, (L - 1) * W, W);

  // trunk: dy_{i-1} = (dy_i_b t_i^T) * factor_{i-1}
  bf16* nxt = other;
  for (int i = L - 1; i >= 1; --i) {
    epi = FactorEpi{nxt, LDH, fb ? fb + (size_t)(i - 1) * W : nullptr,
                    ff ? ff + (size_t)(i - 1) * W : nullptr, ldf, colpart, W};
    gemm(Seg{cur, LDH, wt + (size_t)(i - 1) * W * W, W}, none, W, slabs, epi);
    __syncthreads();
    store_colsums(colpart, pb, (i - 1) * W, W, W);
    rows_to_global(nxt, LDH, a.dy, DYW, r0, (i - 1) * W, W);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
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

// out [n, 4]; acts [round_up(n, 128), 2 n_layers width] or null.
extern "C" int fsnerf_siren_fwd(const void* x, const void* d,
                                const void* wpack, const void* bpack,
                                const void* alphas, void* out, void* acts,
                                int n, int n_layers, int width,
                                void* stream) {
  using namespace fsnerf;
  SirenTrainArgs a;
  fill_args(a, x, d, wpack, bpack, alphas, n, n_layers, width);
  a.out = static_cast<float*>(out);
  a.acts = static_cast<bf16*>(acts);
  a.lda = 2 * n_layers * width;
  const size_t smem = fwd_smem_bytes(width);
  cudaError_t err = cudaFuncSetAttribute(
      siren_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (n + kRows - 1) / kRows;
  if (n_blocks > 0)
    siren_fwd_kernel<<<n_blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dw [n_w] (bf16-rounded) and db [n_b] (f32) in the wpack / bpack layouts.
// Saved mode (cfs null): acts is the forward's [n_pad, lda = 2 L W] stream.
// Recompute mode (cfs given): acts [n_pad, lda = L W] bf16 and cfs [n_pad,
// L W] f32 are scratch the row pass writes. xs, dy, pbias and part are
// scratch of the shapes documented in SirenTrainArgs and
// train_common.cuh::dw_tiles_kernel; jobs [n_jobs, 6] and tiles [n_tiles,
// 3] int32 (ops/kernels/siren.py::dw_jobs).
extern "C" int fsnerf_siren_bwd(
    const void* x, const void* d, const void* dout, const void* wpack,
    const void* bpack, const void* wtpack, const void* alphas, void* acts,
    int lda, void* cfs, void* xs, void* dy, void* pbias, const void* jobs,
    const void* tiles, int n_tiles, void* part, int split_rows, void* dw,
    void* db, int n, int n_layers, int width, void* stream) {
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
  const int n_blocks = (n + kRows - 1) / kRows;
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = bwd_smem_bytes(width);
  cudaError_t err = cudaFuncSetAttribute(
      siren_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  siren_bwd_rows_kernel<<<n_blocks, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int Wh = width / 2, L = n_layers;
  const int n_w = kInPad * width + (L - 1) * width * width + width * Wh + Wh +
                  width * width + width * Wh + kInPad * Wh + Wh * 3;
  const int n_b = L * width + Wh + 1 + width + Wh + 3;
  return static_cast<int>(launch_dw(
      static_cast<const bf16*>(acts), lda, static_cast<const bf16*>(xs),
      2 * kInPad + 2 * width, static_cast<const bf16*>(dy),
      L * width + 2 * width + 16, static_cast<const int*>(tiles), n_tiles,
      static_cast<const int*>(jobs), static_cast<float*>(part), n_w,
      split_rows, static_cast<const float*>(pbias), n_blocks, n_b, 0,
      static_cast<float*>(dw), static_cast<float*>(db), st));
}
