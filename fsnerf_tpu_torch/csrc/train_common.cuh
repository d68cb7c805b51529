// The weight-gradient passes shared by the train backwards of mlp_train.cu
// (NeRF) and siren.cu (SiNeRF), and the column sums of a cotangent tile.
//
// A backward's row pass writes every GEMM operand a weight gradient needs
// to device memory as bf16 (X: the trunk activations `acts` or a scratch
// `xs`; dY: the bf16 cotangents `dy`) and each row CTA's column sums of the
// f32 cotangents (`pbias`, the bias-gradient partials). Then:
//   dw_gemm_kernel: dW = X^T dY for every weight matrix on wgmma fed by
//     TMA, one CTA per (128 x 256 output tile, split of rows), the rows of
//     its split in a fixed order; each split writes its own f32 partial;
//   dw_reduce_kernel: sums the partials of each gradient in a fixed order
//     and rounds to bf16, as the TPU kernels' callers do.
// Nothing is summed in an order that depends on scheduling, so two runs give
// bitwise-equal gradients.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"
#include "wgmma_common.cuh"

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

// pb[off : off + n] = the row groups' column sums, in order (T threads).
template <int T = kThreads>
__device__ __forceinline__ void store_colsums(const float* colpart, float* pb,
                                              int off, int n, int width,
                                              int groups) {
  for (int c = threadIdx.x; c < n; c += T) {
    float v = colpart[c];
    for (int g = 1; g < groups; ++g) v += colpart[g * width + c];
    pb[off + c] = v;
  }
}

// One weight matrix: X columns [x_col, x_col + k_in) of acts (x_src 0) or
// xs (x_src 1), dY columns [y_col, y_col + n_out) of dy, written as the
// [k_in, n_out] row-major block at w_off of the packed gradient.
struct DwJob {
  int x_src, x_col, k_in, y_col, n_out, w_off;
};

// dW = X^T dY on the tensor cores: K runs over the rows, A = X^T is the
// M-major view of X's [rows, k_in] block and B = dY's [rows, n_out] block
// is N-major; wgmma reads both transposed from 128B-swizzled shared memory.
// An output tile is 128 input dims (two consumer warpgroups of m64) x up
// to 256 output dims, its f32 sums in registers (128 a thread at 256); one
// producer warp keeps a ring of kDwStages stages of kDwBk rows filled by
// TMA (A: two boxes of 64 X columns, B: up to four of 64 dY columns),
// guarded by full / empty mbarriers. A job narrower than a box (sigma and
// rgb's 1 or 3 columns, a 16- or 32-wide input) reads the whole box: TMA
// fills the columns past the matrix's end with zeros, and the rows and
// columns past the job's are never stored.
constexpr int kDwConsumers = 2;
constexpr int kDwThreads = 128 * kDwConsumers + 32;
constexpr int kDwBk = 64;                        // rows per stage
constexpr int kDwStages = 4;
constexpr int kDwTileM = 64 * kDwConsumers;      // input dims per tile
constexpr int kDwTileN = 256;                    // output dims per tile
constexpr int kDwBox = 64 * kDwBk * 2;           // one 64-column box, bytes
constexpr int kDwStageBytes = (kDwTileM / 64 + kDwTileN / 64) * kDwBox;

size_t dw_smem_bytes() {
  return (size_t)kDwStages * kDwStageBytes + 1024 +
         2 * kDwStages * sizeof(uint64_t);
}

// One consumer warpgroup's m64 x 64 NB slice of the tile, its rows (K) in
// the ring's order; then its f32 sums into this split's partial `out`.
template <int NB>
__device__ __forceinline__ void dw_consume(unsigned char* ring,
                                           uint64_t* full, uint64_t* empty,
                                           int n_iters, int wg,
                                           const DwJob& job, int m0, int n0,
                                           float* out) {
  float acc[32 * NB];
#pragma unroll
  for (int i = 0; i < 32 * NB; ++i) acc[i] = 0.f;
  for (int it = 0; it < n_iters; ++it) {
    const int s = it % kDwStages;
    mbar_wait(&full[s], (it / kDwStages) & 1);
    const uint32_t a = smem_u32(ring + s * kDwStageBytes + wg * kDwBox);
    const uint32_t b = smem_u32(ring + s * kDwStageBytes +
                                (kDwTileM / 64) * kDwBox);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDwBk / 16; ++kk)   // 16 rows = two 8-row groups
      wgmma_mn(acc, sw128_desc(a + kk * 2048, kDwBox, 1024),
               sw128_desc(b + kk * 2048, kDwBox, 1024), 1);
    wgmma_commit();
    wgmma_wait<1>();          // the stage before this one has been read
    if (it > 0 && threadIdx.x % 128 == 0)
      mbar_arrive(&empty[(it - 1) % kDwStages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  const int lane = threadIdx.x & 31;
  const int mb = m0 + 64 * wg + 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  const int nb = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < 8 * NB; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mb + 8 * h;
      if (m >= job.k_in) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int n = nb + 8 * j + e;
        if (n < job.n_out)
          out[(size_t)m * job.n_out + n] = acc[4 * j + 2 * h + e];
      }
    }
  }
}

// blockIdx.x: an output tile (tiles[3t] = job, tm, tn: input dims from 128
// tm, output dims from 256 tn, so any width's jobs tile it: a [512, 512]
// gradient is 4 x 2 tiles; the two halves of a job's 256 input dims are
// neighbours, so the second read of a dY block hits L2);
// blockIdx.y: a split of split_rows rows (a multiple of kDwBk; n_rows one
// of kRows).
// Each split writes its own f32 partial of every gradient.
__global__ void __launch_bounds__(kDwThreads, 1)
    dw_gemm_kernel(const __grid_constant__ CUtensorMap map_acts,
                   const __grid_constant__ CUtensorMap map_xs,
                   const __grid_constant__ CUtensorMap map_dy,
                   const int* tiles, const int* jobs, float* part, int n_w,
                   int n_rows, int split_rows) {
  extern __shared__ unsigned char dw_smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dw_smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring +
                                               kDwStages * kDwStageBytes);
  uint64_t* empty = full + kDwStages;
  const int* t = tiles + 3 * blockIdx.x;
  const int* jp = jobs + 6 * t[0];
  const DwJob job = {jp[0], jp[1], jp[2], jp[3], jp[4], jp[5]};
  const int m0 = t[1] * kDwTileM, n0 = t[2] * kDwTileN;
  const int na = job.k_in - m0 > 64 ? 2 : 1;             // A boxes
  // B boxes: 1, 2 or 4 (a tile 192 wide reads a fourth, not stored)
  int nb = min(kDwTileN / 64, (job.n_out - n0 + 63) / 64);
  if (nb == 3) nb = 4;
  const int row_begin = blockIdx.y * split_rows;
  const int n_iters = (min(n_rows, row_begin + split_rows) - row_begin) /
                      kDwBk;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kDwStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], na);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kDwConsumers) {                 // the producer warp
    if (threadIdx.x == 128 * kDwConsumers) {
      const CUtensorMap* mx = job.x_src ? &map_xs : &map_acts;
      for (int it = 0; it < n_iters; ++it) {
        const int s = it % kDwStages;
        if (it >= kDwStages)
          mbar_wait(&empty[s], (it / kDwStages - 1) & 1);
        unsigned char* st = ring + s * kDwStageBytes;
        const int row = row_begin + it * kDwBk;
        mbar_arrive_expect_tx(&full[s], (na + nb) * kDwBox);
        for (int q = 0; q < na; ++q)
          tma_load_2d(st + q * kDwBox, mx, &full[s],
                      job.x_col + m0 + 64 * q, row);
        for (int q = 0; q < nb; ++q)
          tma_load_2d(st + (kDwTileM / 64 + q) * kDwBox, &map_dy, &full[s],
                      job.y_col + n0 + 64 * q, row);
      }
    }
    return;
  }
  if (wg >= na) return;
  float* out = part + (size_t)blockIdx.y * n_w + job.w_off;
  switch (nb) {
    case 1:
      dw_consume<1>(ring, full, empty, n_iters, wg, job, m0, n0, out);
      break;
    case 2:
      dw_consume<2>(ring, full, empty, n_iters, wg, job, m0, n0, out);
      break;
    default:
      dw_consume<4>(ring, full, empty, n_iters, wg, job, m0, n0, out);
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

// The two weight-gradient launches after a row pass of n_blocks CTAs of
// block_rows rows: dW tiles over split_rows-row splits into `part`, then
// the fixed-order reduce into dw [n_w] and db [n_b]. The tensor maps of acts, xs and dy are
// encoded here, at each call (their addresses change from call to call);
// one that cannot be encoded is a launch error (cudaErrorInvalidValue).
// Returns the first launch error.
cudaError_t launch_dw(const bf16* acts, int ld_acts, const bf16* xs,
                      int ld_xs, const bf16* dy, int ld_dy, const int* tiles,
                      int n_tiles, const int* jobs, float* part, int n_w,
                      int split_rows, const float* pbias, int n_blocks,
                      int n_b, int round_db, float* dw, float* db,
                      cudaStream_t st, int block_rows = kRows) {
  const int n_rows = n_blocks * block_rows;
  const int n_splits = (n_rows + split_rows - 1) / split_rows;
  CUtensorMap map_acts, map_xs, map_dy;
  if (split_rows % kDwBk != 0 ||
      !encode_bf16_map(&map_acts, acts, n_rows, ld_acts, ld_acts, kDwBk) ||
      !encode_bf16_map(&map_xs, xs, n_rows, ld_xs, ld_xs, kDwBk) ||
      !encode_bf16_map(&map_dy, dy, n_rows, ld_dy, ld_dy, kDwBk))
    return cudaErrorInvalidValue;
  const size_t smem = dw_smem_bytes();
  cudaError_t err = cudaFuncSetAttribute(
      dw_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dw_gemm_kernel<<<dim3(n_tiles, n_splits), kDwThreads, smem, st>>>(
      map_acts, map_xs, map_dy, tiles, jobs, part, n_w, n_rows, split_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int w_blocks = (n_w + kReduceThreads - 1) / kReduceThreads;
  const int b_blocks = (n_b + kReduceThreads / 32 - 1) / (kReduceThreads / 32);
  dw_reduce_kernel<<<w_blocks + b_blocks, kReduceThreads, 0, st>>>(
      part, n_splits, n_w, pbias, n_blocks, n_b, round_db, w_blocks, dw, db);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fsnerf
