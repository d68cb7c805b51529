// Building blocks shared by the MLP kernels of csrc/ (the SIREN ray march
// of render.cu, the train backward of mlp_train.cu and the SIREN kernels
// of siren.cu; the warp-specialized kernels of ws_trunk.cuh take its
// constants and encoding): the 128-row tensor-core GEMM with weights
// streamed through shared memory, its forward epilogue, copies of a tile's
// rows to and from device memory, and the positional encoding of one
// feature.
//
// Every kernel that uses them runs kThreads threads per CTA over a tile of
// kRows rows held in shared memory as bf16 (row stride padded by kPad so
// ldmatrix rows hit distinct banks).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fastmath.cuh"

namespace fsnerf {
namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kRows = 128;             // GEMM rows held by one CTA
constexpr int kPassCols = 128;         // GEMM output columns per pass
constexpr int kSlabRows = 64;          // weight rows staged per slab
constexpr int kPad = 8;                // +16 B per shared row: no bank conflicts
constexpr int kSlabLd = kPassCols + kPad;
// 16-byte pieces of one weight slab that each thread moves
constexpr int kSlabPieces = kSlabRows * kPassCols / 8 / kThreads;
constexpr float kHalfPi = 1.57079632679489661923f;

// One GEMM operand pair: A [kRows, K] in shared memory (row stride lda),
// B [K, N] row-major in global memory (row stride N).
struct Seg {
  const bf16* A;
  int lda;
  const bf16* B;
  int K;
};

__device__ __forceinline__ void slab_of(int si, int ns0, const Seg& s0,
                                        const Seg& s1, Seg& sg, int& k0,
                                        int& rows) {
  sg = si < ns0 ? s0 : s1;
  k0 = (si < ns0 ? si : si - ns0) * kSlabRows;
  rows = min(kSlabRows, sg.K - k0);
}

// This thread's share of the weight slab B[k0 : k0+rows, n0 : n0+ncols].
__device__ __forceinline__ void slab_load(uint4 (&r)[kSlabPieces],
                                          const Seg& sg, int N, int k0,
                                          int rows, int n0, int ncols) {
#pragma unroll
  for (int q = 0; q < kSlabPieces; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    const int row = idx >> 4, c8 = (idx & 15) * 8;
    if (row < rows && c8 < ncols)
      r[q] = *reinterpret_cast<const uint4*>(sg.B + (size_t)(k0 + row) * N +
                                             n0 + c8);
  }
}

__device__ __forceinline__ void slab_store(const uint4 (&r)[kSlabPieces],
                                           bf16* dst, int rows, int ncols) {
#pragma unroll
  for (int q = 0; q < kSlabPieces; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    const int row = idx >> 4, c8 = (idx & 15) * 8;
    if (row < rows && c8 < ncols)
      *reinterpret_cast<uint4*>(dst + row * kSlabLd + c8) = r[q];
  }
}

// Four 8x8 b16 matrices from shared memory; lane l gives the address of
// row l%8 of matrix l/8. With .trans each matrix arrives transposed.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// d += a (16x16, row) @ b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[kRows, :N] = s0.A @ s0.B (+ s1.A @ s1.B), handed to `epi` one 8-column
// tile at a time. Warps tile 4 x 2 over (rows, 128-column pass): 32 x 64
// outputs per warp per pass, as 2 x 8 mma.sync m16n8k16 tiles. The weights
// stream through shared memory in 64-row slabs, double-buffered: slab i+1
// is fetched into registers while the tensor cores consume slab i.
//
// epi(row, col, c) gets this lane's accumulators of one m16n8 tile pair:
// c[i][2h + e] is output (row + 16 i + 8 h, col + e). Every lane of a warp
// calls it for the same tiles, so it may use warp shuffles.
template <class Epi>
__device__ void gemm(const Seg& s0, const Seg& s1, int N, bf16* slabs,
                     Epi& epi) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = (warp & 3) * 32, wcol = (warp >> 2) * 64;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;  // ldmatrix addressing
  const int ns0 = (s0.K + kSlabRows - 1) / kSlabRows;
  const int ns = ns0 + (s1.K + kSlabRows - 1) / kSlabRows;
  for (int n0 = 0; n0 < N; n0 += kPassCols) {
    const int ncols = min(kPassCols, N - n0);
    float acc[2][8][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    uint4 r[kSlabPieces];
    Seg sg;
    int k0, rows;
    slab_of(0, ns0, s0, s1, sg, k0, rows);
    slab_load(r, sg, N, k0, rows, n0, ncols);
    slab_store(r, slabs, rows, ncols);
    __syncthreads();
    for (int si = 0; si < ns; ++si) {
      Seg cur;
      int ck0, crows;
      slab_of(si, ns0, s0, s1, cur, ck0, crows);
      const bool more = si + 1 < ns;
      if (more) {
        slab_of(si + 1, ns0, s0, s1, sg, k0, rows);
        slab_load(r, sg, N, k0, rows, n0, ncols);
      }
      const bf16* bs = slabs + (si & 1) * kSlabRows * kSlabLd;
#pragma unroll
      for (int kk = 0; kk < kSlabRows; kk += 16) {
        if (kk >= crows) break;    // the last slab of a segment may be short
        uint32_t a[2][4], b[4][4];
        const bf16* ap = cur.A + (row0 + lrow) * cur.lda + ck0 + kk + lcol;
        ldsm_x4(a[0], ap);
        ldsm_x4(a[1], ap + 16 * cur.lda);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp)
          if (wcol + 16 * jp < ncols)
            ldsm_x4_trans(b[jp], bs + (kk + lrow) * kSlabLd + wcol + 16 * jp +
                                     lcol);
#pragma unroll
        for (int jp = 0; jp < 4; ++jp) {
          if (wcol + 16 * jp < ncols) {
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              mma_bf16(acc[i][2 * jp], a[i], b[jp][0], b[jp][1]);
              mma_bf16(acc[i][2 * jp + 1], a[i], b[jp][2], b[jp][3]);
            }
          }
        }
      }
      if (more)
        slab_store(r, slabs + ((si + 1) & 1) * kSlabRows * kSlabLd, rows,
                   ncols);
      __syncthreads();
    }
    const int qr = lane >> 2, qc = 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (wcol + 8 * j < ncols) {
        float c[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[i][e] = acc[i][j][e];
        epi(row0 + qr, n0 + wcol + 8 * j + qc, c);
      }
    }
  }
}

// The forward layer epilogue: C = bf16(act(acc + bias)), C in shared memory.
struct BiasActEpi {
  const float* bias;
  bool relu;
  bf16* C;
  int ldc;
  __device__ __forceinline__ void operator()(int row, int col,
                                             const float (&c)[2][4]) const {
    const float b0 = bias[col], b1 = bias[col + 1];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float v0 = c[i][2 * h] + b0, v1 = c[i][2 * h + 1] + b1;
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(C + (row + 16 * i + 8 * h) * ldc +
                                           col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
};

// C[kRows, :N] = bf16(act(s0.A @ s0.B (+ s1.A @ s1.B) + bias)), C in shared
// memory (row stride ldc).
__device__ __forceinline__ void gemm_layer(const Seg& s0, const Seg& s1,
                                           const float* bias, int N,
                                           bool relu, bf16* C, int ldc,
                                           bf16* slabs) {
  BiasActEpi epi{bias, relu, C, ldc};
  gemm(s0, s1, N, slabs, epi);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// dst[r0 + row, col0 : col0 + ncols] = src[row, :ncols] for the CTA's 128
// rows, in 16-byte pieces (ncols, ld and col0 multiples of 8).
__device__ __forceinline__ void rows_to_global(const bf16* src, int lds,
                                               bf16* dst, int ld, int r0,
                                               int col0, int ncols) {
  const int per_row = ncols / 8;
  for (int e = threadIdx.x; e < kRows * per_row; e += kThreads) {
    const int row = e / per_row, c8 = (e - row * per_row) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)(r0 + row) * ld + col0 + c8) =
        *reinterpret_cast<const uint4*>(src + row * lds + c8);
  }
}

__device__ __forceinline__ void rows_from_global(const bf16* src, int ld,
                                                 int r0, int col0, bf16* dst,
                                                 int ldd, int ncols) {
  const int per_row = ncols / 8;
  for (int e = threadIdx.x; e < kRows * per_row; e += kThreads) {
    const int row = e / per_row, c8 = (e - row * per_row) * 8;
    *reinterpret_cast<uint4*>(dst + row * ldd + c8) =
        *reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * ld +
                                        col0 + c8);
  }
}

// One encoded feature of v in the reference layout [v, sin f0 v, cos f0 v,
// ...] (3 lanes per group), times the band's FreeNeRF mask; 0 past the end.
__device__ __forceinline__ float encode_lane(const float* v, int col,
                                             int n_freqs, const float* freq,
                                             const float* band_mask) {
  if (col < 3) return v[col];
  const int g = col - 3;
  const int band = g / 6;
  if (band >= n_freqs) return 0.f;
  const int w = g - 6 * band;
  const float phase = w >= 3 ? kHalfPi : 0.f;
  const float arg = __fadd_rn(__fmul_rn(v[w % 3], freq[band]), phase);
  return __fmul_rn(sin_fast(arg), band_mask[band]);
}

}  // namespace
}  // namespace fsnerf
