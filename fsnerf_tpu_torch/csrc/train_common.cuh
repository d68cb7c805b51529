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
#include "ws_trunk.cuh"

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


// ---- the streamed row passes' products (the streamed widths) ------------
//
// The row passes of the train backwards (mlp_train.cu
// mlp_train_bwd_rows_kernel_stream, siren.cu siren_bwd_rows_kernel_stream)
// on 64-row CTAs of one warpgroup, with no activation buffer a whole layer
// wide: each product streams its A operand (64 rows of a bf16 matrix in
// device memory) in 64 x 64 K tiles beside 128-column weight tiles of 64
// K, both by cp.async through a ring of kStreamRowStages stages, into one
// m64n128 accumulator per 128 output columns, whose epilogue writes
// through a 64 x 128 tile C in shared memory to device memory.

// The row kernels' weight staging: tiles of kBwdPassCols weight rows x 64
// K, 128B-swizzled and 1024-byte aligned (kBwdStages of them in the ring
// of mlp_train.cu's unstreamed row pass).
constexpr int kBwdStages = 3;
constexpr int kBwdPassCols = 128;
constexpr int kBwdStageBytes = kBwdPassCols * 128;
constexpr int kStreamRowStages = 3;
constexpr int kStreamRowLda = 64 + kPad;          // the A tile's row stride
constexpr int kStreamRowLdc = kBwdPassCols + kPad;
constexpr int kStreamRowStageBytes =
    kBwdStageBytes + 64 * kStreamRowLda * (int)sizeof(bf16);
static_assert(kStreamRowStageBytes % 1024 == 0, "stages stay 1024-aligned");

// (ops/kernels/mlp_train.py::bwd_rows_smem_bytes mirrors it): the ring,
// the output tile, the rgb head's floats and four warps' column sums of
// one chunk; whatever the width and encodings.
size_t stream_rows_smem_bytes() {
  return 1024 + (size_t)kStreamRowStages * kStreamRowStageBytes +
         sizeof(bf16) * 64 * kStreamRowLdc +
         sizeof(float) * (7 * 64 + 4 * kBwdPassCols);
}

// One operand pair of a streamed row-pass product: A the 64 rows from r0
// of a bf16 matrix in device memory (row stride lda, from its column at
// A), B a weight matrix of wpack ([N, K] K-contiguous, or [K, N]
// N-contiguous with kTransB; row stride ldb), K deep.
struct RowSeg {
  const bf16* A;
  int lda;
  const bf16* B;
  int ldb, K;
};

// KS k16 steps: this warp's A fragments by ldmatrix from the stage's A
// tile at ap, then the warpgroup's wgmma on the B tile at shared address b
// (K-major: k16 step kk at b + 32 kk; N-major: 16 K-rows at b + 2048 kk,
// the two 64-column blocks 8 KB apart); returns when they have completed.
template <int KS, bool kTransB>
__device__ __forceinline__ void stream_rows_stage(float (&acc)[64],
                                                  const bf16* ap,
                                                  uint32_t b) {
  uint32_t a[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) ldsm_x4(a[kk], ap + 16 * kk);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
    wgmma_rs<kTransB ? 1 : 0>(
        acc, a[kk],
        kTransB ? sw128_desc(b + 2048 * kk, kBlock, 1024)
                : sw128_desc(b + 32 * kk, 16, 1024),
        1);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) fence_regs(a[kk]);
}

// With kSplitK (the row passes above a packed width of 1024) a product's
// K is summed stage by stage: each stage's wgmma (64 K) accumulate into
// acc, which is then added into a float32 total by FADD and cleared. The
// tensor cores' f32 sums lose precision as they run long (a kernel's bf16
// roundings of feat and br flipped ~7x as often as the plain version's at
// K = 2048, scripts/grad_arbiter.py; chunks of 256 K still left one seed
// of ten at 3.4x the plain version's gradient error); a stage bounds that
// to 64 K, and the stages' totals round to nearest.
constexpr int kSplitKMinWidth = 1025;

// acc = the sum over segs[0 .. nseg) of A[64, :K] @ B[:K, n0 : n0 + 128)
// (columns past N: 0), by the CTA's one warpgroup: each stage one 64 x 64
// A tile and one 128 x 64 B tile (128B-swizzled), by cp.async, kStreamRow-
// Stages - 1 stages ahead (kSplitK: each stage's sum into a total, above).
// With mask, rows r0 .. of mask's columns n0 .. n0 + 127 (row stride
// mask_ld) land in C with the first stage, for the epilogue's ReLU'. Ends
// past a barrier, the ring free.
template <bool kTransB, bool kSplitK = false>
__device__ void stream_rows_gemm(float (&acc)[64], const RowSeg* segs,
                                 int nseg, int n0, int N, int r0,
                                 unsigned char* ring, const bf16* mask,
                                 int mask_ld, bf16* C) {
  constexpr int T = 128;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nk0 = (segs[0].K + 63) / 64;
  const int ns = nk0 + (nseg > 1 ? (segs[1].K + 63) / 64 : 0);
  auto seg_of = [&](int st, int& k0) -> const RowSeg& {
    k0 = (st < nk0 ? st : st - nk0) * 64;
    return st < nk0 ? segs[0] : segs[1];
  };
  auto load = [&](int st) {
    unsigned char* stage = ring + (st % kStreamRowStages) *
                                      kStreamRowStageBytes;
    int k0;
    const RowSeg& sg = seg_of(st, k0);
    for (int q = tid; q < kBwdPassCols * 8; q += T) {
      if (!kTransB) {       // row n of B ([N, K]): 64 K in 8 chunks
        const int n = q >> 3, c = q & 7, k = k0 + 8 * c;
        const bool ok = n0 + n < N && k < sg.K;
        cp_async_16(stage + n * 128 + (((c ^ n) & 7) << 4),
                    ok ? sg.B + (size_t)(n0 + n) * sg.ldb + k : sg.B, ok);
      } else {              // row k of B ([K, N]): 2 blocks of 64 N
        const int kr = q >> 4, j = (q >> 3) & 1, c = q & 7;
        const int n = n0 + 64 * j + 8 * c, k = k0 + kr;
        const bool ok = n < N && k < sg.K;
        cp_async_16(stage + j * kBlock + kr * 128 + (((c ^ kr) & 7) << 4),
                    ok ? sg.B + (size_t)k * sg.ldb + n : sg.B, ok);
      }
    }
    bf16* at = reinterpret_cast<bf16*>(stage + kBwdStageBytes);
    for (int q = tid; q < 64 * 8; q += T) {
      const int row = q >> 3, c = q & 7, k = k0 + 8 * c;
      const bool ok = k < sg.K;
      cp_async_16(at + row * kStreamRowLda + 8 * c,
                  ok ? sg.A + (size_t)(r0 + row) * sg.lda + k : sg.A, ok);
    }
    if (mask != nullptr && st == 0)
      for (int e = tid; e < 64 * (kBwdPassCols / 8); e += T) {
        const int row = e / (kBwdPassCols / 8), c8 = e % (kBwdPassCols / 8);
        cp_async_16(C + row * kStreamRowLdc + 8 * c8,
                    mask + (size_t)(r0 + row) * mask_ld + n0 + 8 * c8,
                    true);
      }
  };
#pragma unroll
  for (int st = 0; st < kStreamRowStages - 1; ++st) {
    if (st < ns) load(st);
    cp_async_commit();
  }
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float total[kSplitK ? 64 : 1];
  if constexpr (kSplitK) {
#pragma unroll
    for (int i = 0; i < 64; ++i) total[i] = 0.f;
  }
  for (int kc = 0; kc < ns; ++kc) {
    cp_async_wait<kStreamRowStages - 2>();     // stage kc landed
    fence_proxy_async();                       // ... visible to wgmma
    __syncthreads();                           // for every thread's copies
    if (kc + kStreamRowStages - 1 < ns) load(kc + kStreamRowStages - 1);
    cp_async_commit();
    unsigned char* stage = ring + (kc % kStreamRowStages) *
                                      kStreamRowStageBytes;
    const uint32_t tile = smem_u32(stage);
    const bf16* ap = reinterpret_cast<const bf16*>(stage + kBwdStageBytes) +
                     (16 * warp + (lane & 15)) * kStreamRowLda +
                     (lane >> 4) * 8;
    int k0;
    const RowSeg& sg = seg_of(kc, k0);
    if (k0 + 64 <= sg.K) {
      stream_rows_stage<4, kTransB>(acc, ap, tile);
    } else {                                   // a last tile of 16 .. 48 K
      for (int kk = 0; k0 + 16 * kk < sg.K; ++kk)
        stream_rows_stage<1, kTransB>(acc, ap + 16 * kk,
                                      tile + (kTransB ? 2048 : 32) * kk);
    }
    if constexpr (kSplitK) {
      fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        total[i] = __fadd_rn(total[i], acc[i]);
        acc[i] = 0.f;
      }
      fence_regs(total);
    }
  }
  if constexpr (kSplitK) {
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = total[i];
  }
  fence_regs(acc);
  cp_async_wait<0>();
  __syncthreads();
}

// A chunk's epilogue into C [64, 128) for output columns n0 ...: the
// heads' forward (bias, optional ReLU, bf16), or with colpart a cotangent
// (+ dsig[row] * w_sigma[col] with dsig; 0 where the activation
// prefetched into C is not > 0 with masked; bf16), each warp's column sums
// of the f32 values over its 16 rows into colpart[warp][col - n0].
struct RowChunkOut {
  const float* bias;
  bool relu, masked;
  const float* dsig;
  const bf16* w_sigma;
  float* colpart;
};

__device__ __forceinline__ void stream_rows_epilogue(const RowChunkOut& o,
                                                     const float (&acc)[64],
                                                     int n0, bf16* C) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * warp + (lane >> 2);
  float ds[2] = {0.f, 0.f};
  if (o.dsig) {
    ds[0] = o.dsig[row];
    ds[1] = o.dsig[row + 8];
  }
#pragma unroll
  for (int j = 0; j < kBwdPassCols / 8; ++j) {
    const int lc = 8 * j + 2 * (lane & 3), col = n0 + lc;
    float c0 = 0.f, c1 = 0.f;
    if (o.bias) {
      c0 = o.bias[col];
      c1 = o.bias[col + 1];
    } else if (o.dsig) {
      c0 = __bfloat162float(o.w_sigma[col]);
      c1 = __bfloat162float(o.w_sigma[col + 1]);
    }
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
      if (o.bias) {
        v0 += c0;
        v1 += c1;
      } else if (o.dsig) {
        v0 += ds[h] * c0;
        v1 += ds[h] * c1;
      }
      if (o.relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
      }
      __nv_bfloat162* p =
          reinterpret_cast<__nv_bfloat162*>(C + (row + 8 * h) * kStreamRowLdc + lc);
      if (o.masked) {
        const __nv_bfloat162 hv = *p;
        if (!(__bfloat162float(hv.x) > 0.f)) v0 = 0.f;
        if (!(__bfloat162float(hv.y) > 0.f)) v1 = 0.f;
      }
      *p = __floats2bfloat162_rn(v0, v1);
      s0 += v0;
      s1 += v1;
    }
    if (o.colpart) {
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, m);
        s1 += __shfl_xor_sync(0xffffffffu, s1, m);
      }
      if (lane < 4) {
        o.colpart[warp * kBwdPassCols + lc] = s0;
        o.colpart[warp * kBwdPassCols + lc + 1] = s1;
      }
    }
  }
}

// One product of the row pass, chunk by chunk: out[r0 .., dst_col + n] =
// the epilogue of (segs @ B) for n < N, through C; with o.colpart, each
// chunk's column sums (the four warps' in order) to pb[pb_off + n].
template <bool kTransB, bool kSplitK = false>
__device__ void stream_rows_product(const RowSeg* segs, int nseg, int N,
                                    int r0, unsigned char* ring, bf16* C,
                                    const bf16* mask, int mask_ld,
                                    RowChunkOut o, bf16* out, int out_ld,
                                    int dst_col, float* pb, int pb_off) {
  for (int n0 = 0; n0 < N; n0 += kBwdPassCols) {
    float acc[64];
    stream_rows_gemm<kTransB, kSplitK>(acc, segs, nseg, n0, N, r0, ring,
                                       mask, mask_ld, C);
    stream_rows_epilogue(o, acc, n0, C);
    __syncthreads();
    if (o.colpart)
      store_colsums<128>(o.colpart, pb, pb_off + n0, kBwdPassCols,
                         kBwdPassCols, 4);
    rows_to_global<64>(C, kStreamRowLdc, out, out_ld, r0, dst_col + n0,
                       kBwdPassCols);
    __syncthreads();
  }
}

}  // namespace
}  // namespace fsnerf
