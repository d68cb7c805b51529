// The weight-gradient passes shared by the train backwards of mlp_train.cu
// (NeRF) and siren.cu (SiNeRF), and the column sums of a cotangent tile.
//
// A backward's row pass writes every GEMM operand a weight gradient needs
// to device memory as bf16 (X: the trunk activations `acts` or a scratch
// `xs`; dY: the bf16 cotangents `dy`) and each row CTA's column sums of the
// f32 cotangents (`pbias`, the bias-gradient partials). Then:
//   dw_tiles_kernel: dW = X^T dY for every weight matrix, one CTA per (64 x
//     64 output tile, split of rows), the rows of its split in a fixed
//     order; each split writes its own f32 partial;
//   dw_reduce_kernel: sums the partials of each gradient in a fixed order
//     and rounds to bf16, as the TPU kernels' callers do.
// Nothing is summed in an order that depends on scheduling, so two runs give
// bitwise-equal gradients.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"

namespace fsnerf {
namespace {

// This warp's column sums (over its 32 rows) of one m16n8 tile pair's f32
// values s0 / s1 at columns col, col + 1, into colpart[row group][col]: the
// rows' adds are in a fixed order and the shuffles a fixed tree.
__device__ __forceinline__ void warp_colsums(float s0, float s1,
                                             float* colpart, int width,
                                             int col) {
#pragma unroll
  for (int o = 4; o < 32; o <<= 1) {
    s0 += __shfl_xor_sync(0xffffffffu, s0, o);
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
  }
  if ((threadIdx.x & 31) < 4) {
    float* cp = colpart + ((threadIdx.x >> 5) & 3) * width + col;
    cp[0] = s0;
    cp[1] = s1;
  }
}

// pb[off : off + n] = the four row groups' column sums, in order.
__device__ __forceinline__ void store_colsums(const float* colpart, float* pb,
                                              int off, int n, int width) {
  for (int c = threadIdx.x; c < n; c += kThreads)
    pb[off + c] = ((colpart[c] + colpart[width + c]) + colpart[2 * width + c]) +
                  colpart[3 * width + c];
}

constexpr int kDwThreads = 128;
constexpr int kDwTile = 64;           // output tile 64 x 64, row chunk 64
constexpr int kDwLd = kDwTile + kPad;
constexpr int kDwPieces = kDwTile * kDwTile / 8 / kDwThreads;

// One weight matrix: X columns [x_col, x_col + k_in) of acts (x_src 0) or
// xs (x_src 1), dY columns [y_col, y_col + n_out) of dy, written as the
// [k_in, n_out] row-major block at w_off of the packed gradient.
struct DwJob {
  int x_src, x_col, k_in, y_col, n_out, w_off;
};

__device__ __forceinline__ void dw_load(uint4 (&r)[kDwPieces], const bf16* p,
                                        int ld, int k0, int lim) {
#pragma unroll
  for (int q = 0; q < kDwPieces; ++q) {
    const int idx = threadIdx.x + q * kDwThreads;
    const int row = idx >> 3, c8 = (idx & 7) * 8;
    r[q] = c8 < lim ? *reinterpret_cast<const uint4*>(
                          p + (size_t)(k0 + row) * ld + c8)
                    : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void dw_store(const uint4 (&r)[kDwPieces],
                                         bf16* dst) {
#pragma unroll
  for (int q = 0; q < kDwPieces; ++q) {
    const int idx = threadIdx.x + q * kDwThreads;
    *reinterpret_cast<uint4*>(dst + (idx >> 3) * kDwLd + (idx & 7) * 8) = r[q];
  }
}

// blockIdx.x: an output tile (tiles[3t] = job, tm, tn); blockIdx.y: a split
// of split_rows rows. Each warp owns 16 rows (input dims) x 64 columns
// (output dims) of the tile and walks the split's rows in order, 16 at a
// time: A = X^T through ldmatrix.trans of the [rows, in] chunk, B = dY
// through ldmatrix.trans of the [rows, out] chunk.
__global__ void __launch_bounds__(kDwThreads)
    dw_tiles_kernel(const bf16* acts, int ld_acts, const bf16* xs, int ld_xs,
                    const bf16* dy, int ld_dy, const int* tiles,
                    const int* jobs, float* part, int n_w, int n_rows,
                    int split_rows) {
  __shared__ __align__(16) bf16 Xs[2][kDwTile * kDwLd];
  __shared__ __align__(16) bf16 Ys[2][kDwTile * kDwLd];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int* t = tiles + 3 * blockIdx.x;
  const int* jp = jobs + 6 * t[0];
  const DwJob job = {jp[0], jp[1], jp[2], jp[3], jp[4], jp[5]};
  const int m0 = t[1] * kDwTile, n0 = t[2] * kDwTile;
  const bf16* X = (job.x_src ? xs : acts) + job.x_col + m0;
  const int ldx = job.x_src ? ld_xs : ld_acts;
  const bf16* Y = dy + job.y_col + n0;
  const int mlim = job.k_in - m0;
  const int nlim = ((job.n_out + 7) / 8) * 8 - n0;
  const int row_begin = blockIdx.y * split_rows;
  const int row_end = min(n_rows, row_begin + split_rows);

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint4 rx[kDwPieces], ry[kDwPieces];
  dw_load(rx, X, ldx, row_begin, mlim);
  dw_load(ry, Y, ld_dy, row_begin, nlim);
  dw_store(rx, Xs[0]);
  dw_store(ry, Ys[0]);
  __syncthreads();
  const int q = lane >> 3, r = lane & 7;
  const int lrow = lane & 15, lcol = (lane >> 4) * 8;
  int it = 0;
  for (int k0 = row_begin; k0 < row_end; k0 += kDwTile, ++it) {
    const bool more = k0 + kDwTile < row_end;
    if (more) {
      dw_load(rx, X, ldx, k0 + kDwTile, mlim);
      dw_load(ry, Y, ld_dy, k0 + kDwTile, nlim);
    }
    const bf16* xb = Xs[it & 1];
    const bf16* yb = Ys[it & 1];
#pragma unroll
    for (int kk = 0; kk < kDwTile; kk += 16) {
      uint32_t a[4], b[4][4];
      ldsm_x4_trans(a, xb + (kk + r + ((q >> 1) << 3)) * kDwLd + warp * 16 +
                           ((q & 1) << 3));
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2)
        ldsm_x4_trans(b[j2], yb + (kk + lrow) * kDwLd + 16 * j2 + lcol);
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        mma_bf16(acc[2 * j2], a, b[j2][0], b[j2][1]);
        mma_bf16(acc[2 * j2 + 1], a, b[j2][2], b[j2][3]);
      }
    }
    if (more) {
      dw_store(rx, Xs[(it + 1) & 1]);
      dw_store(ry, Ys[(it + 1) & 1]);
    }
    __syncthreads();
  }
  float* out = part + (size_t)blockIdx.y * n_w + job.w_off;
  const int qr = lane >> 2, qc = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + warp * 16 + 8 * h + qr;
      if (m >= job.k_in) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = n0 + 8 * j + qc + e;
        if (n < job.n_out) out[(size_t)m * job.n_out + n] = acc[j][2 * h + e];
      }
    }
  }
}

// dw[e] = bf16(sum over splits of part[., e]) for the first n_w threads of
// the grid; then one warp per bias: db[e] = sum over row CTAs of pbias[.,
// e], lanes striding the CTAs, then a fixed shuffle tree, rounded to bf16
// when round_db.
constexpr int kReduceThreads = 256;

__global__ void __launch_bounds__(kReduceThreads)
    dw_reduce_kernel(const float* part, int n_splits, int n_w,
                     const float* pbias, int n_blocks, int n_b, int round_db,
                     int w_blocks, float* dw, float* db) {
  if (blockIdx.x < w_blocks) {
    const int e = blockIdx.x * kReduceThreads + threadIdx.x;
    if (e >= n_w) return;
    float v = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) v += part[(size_t)sp * n_w + e];
    dw[e] = __bfloat162float(__float2bfloat16_rn(v));
    return;
  }
  const int e = (blockIdx.x - w_blocks) * (kReduceThreads / 32) +
                (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (e >= n_b) return;
  float v = 0.f;
  for (int blk = lane; blk < n_blocks; blk += 32)
    v += pbias[(size_t)blk * n_b + e];
  v = warp_sum(v);
  if (lane == 0)
    db[e] = round_db ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// The two weight-gradient launches after a row pass of n_blocks CTAs: dW
// tiles over split_rows-row splits into `part`, then the fixed-order reduce
// into dw [n_w] and db [n_b]. Returns the first launch error.
cudaError_t launch_dw(const bf16* acts, int ld_acts, const bf16* xs,
                      int ld_xs, const bf16* dy, int ld_dy, const int* tiles,
                      int n_tiles, const int* jobs, float* part, int n_w,
                      int split_rows, const float* pbias, int n_blocks,
                      int n_b, int round_db, float* dw, float* db,
                      cudaStream_t st) {
  const int n_rows = n_blocks * kRows;
  const int n_splits = (n_rows + split_rows - 1) / split_rows;
  dw_tiles_kernel<<<dim3(n_tiles, n_splits), kDwThreads, 0, st>>>(
      acts, ld_acts, xs, ld_xs, dy, ld_dy, tiles, jobs, part, n_w, n_rows,
      split_rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int w_blocks = (n_w + kReduceThreads - 1) / kReduceThreads;
  const int b_blocks = (n_b + kReduceThreads / 32 - 1) / (kReduceThreads / 32);
  dw_reduce_kernel<<<w_blocks + b_blocks, kReduceThreads, 0, st>>>(
      part, n_splits, n_w, pbias, n_blocks, n_b, round_db, w_blocks, dw, db);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fsnerf
