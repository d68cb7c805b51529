// The warp-specialized MLP forward shared by the train forward
// (mlp_train.cu, kernel mlp_train_fwd_kernel), the forward MLP on encoded
// rows and the density pass (mlp.cu, nerf_mlp_kernel and
// nerf_density_kernel) and the NeRF ray march (render.cu,
// nerf_march_kernel); with the sine epilogue of siren_common.cuh, also the
// SIREN forward (siren.cu, siren_fwd_ws_kernel) and the SIREN ray march
// (render.cu, siren_march_kernel).
//
// A CTA of 128 rows holds two consumer warpgroups of 64 rows each and a
// producer warpgroup (which gives its registers to the consumers by
// setmaxnreg). One producer thread streams the weight matrices as 64-row x
// W tiles by TMA, in the order the consumers use them, through a ring of up
// to 4 stages guarded by full / empty mbarriers (each stage is read by both
// consumers, so its empty barrier takes two arrivals). Each consumer keeps
// its rows through the whole MLP: its inputs sit in 128B-swizzled K-major
// tiles (encx, encd), each layer runs as wgmma.m64nWk16 with A its
// activation tile in shared memory and B the ring's stage read N-major, and
// the layer's epilogue (bias, ReLU, bf16) overwrites the activation tile in
// place once the layer's wgmma have retired. The sigma and rgb heads (1
// and 3 columns) are per-thread partial dot products on the accumulators in
// registers, summed across each quad by shuffles. Nothing but the ring is
// shared between the consumers, so a consumer's epilogue waits only on its
// own warpgroup's named barrier.
//
// At the packed widths 384 and 512 a 64 x W f32 accumulator (W / 2
// registers a thread) no longer fits beside the epilogue, so the NeRF and
// SIREN shells run the column-split trunk below instead: one consumer
// warpgroup of 64 rows per CTA, each layer's output computed as two column
// halves of W / 2 into one W / 2 accumulator (FwdTraits). From 768 up
// not even one layer's 64-row input and output tiles fit beside a weight
// ring, and the NeRF and SIREN shells run the streamed trunk at the end of
// this file: each layer's output goes to device memory and comes back from
// L2 as the next layer's operand.
//
// Numerics of the NeRF, as the TPU kernels: bf16 operands, f32
// accumulation, bf16-rounded biases added in f32, trunk activations ReLU
// then bf16 (the activation is a policy of the epilogue; the SIREN's sine
// layers take their own), the skip concat [h, enc] as two products into
// one accumulator, feat bf16 without activation, branch ReLU then bf16,
// rgb an f32 sigmoid.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"
#include "wgmma_common.cuh"

namespace fsnerf {
namespace {

// Shared memory, from a 1024-byte boundary: the weight ring (n_stages
// stages of W * 128 bytes: one 64-row x W weight tile as W / 64 boxes of
// 64 x 64), then each consumer's activation tile (64 rows x W), its encx
// tile and its encd tile, then the ring's full and empty mbarriers. Every
// tile is K-major and 128B-swizzled in blocks of 64 rows x 64 columns
// (kBlock bytes), the layout TMA's CU_TENSOR_MAP_SWIZZLE_128B reads and
// writes and wgmma's descriptors name.
constexpr int kFwdConsumers = 2;                  // warpgroups of 64 rows
// ... and a producer warpgroup, whose first thread issues the loads: a
// whole warpgroup, so that setmaxnreg can give its registers to the
// consumers (a lone ninth warp would cap every thread at 168 registers,
// 3 warps x 32 x 168 of a sub-partition's 16,384, and spill the 128
// accumulators of a 256-wide layer)
// (the producer keeps setmaxnreg's least, 24, and the consumers take the
// rest: 240 rather than 232 took the ray march's spills at width 256 from
// 220 to 168 bytes and its time down 5%)
constexpr int kFwdThreads = 128 * (kFwdConsumers + 1);
constexpr int kFwdProducerRegs = 24;
constexpr int kFwdConsumerRegs = 240;
static_assert(128 * kFwdProducerRegs + 128 * kFwdConsumers * kFwdConsumerRegs
                  <= 65536, "the register file");
constexpr int kFwdMaxStages = 4;
constexpr int kBlock = 64 * 64 * 2;              // a 64 x 64 bf16 block
constexpr size_t kMaxSmem = 227 * 1024;          // a block's limit (H100)

// The widest encoding (columns, after padding) the shells take: 4 blocks.
constexpr int kMaxEnc = 256;

__host__ __device__ __forceinline__ int enc_blocks(int k) {
  return (k + 63) / 64;
}

// The N of a head product W / 2 wide (the NeRF branch, the SIREN heads):
// whole 64-column boxes, the columns past W / 2 TMA's zero fill, which no
// epilogue reads (64 at W = 64, 128 at W = 192).
__host__ __device__ constexpr int head_n(int W) {
  return (W / 2 + 63) / 64 * 64;
}

// Rows of the trunk matrices in wpack's [rows, W] view (the walk of
// ops/kernels/render.py::pack_weights): W_0, then per layer W_i and, at a
// skip layer, its encoding part. w_sigma is the next row, w_conn the W
// after it.
__host__ __device__ __forceinline__ int trunk_rows_of(int n_layers,
                                                      int skip_mask, int W,
                                                      int DE) {
  int rows = DE;
  for (int i = 1; i < n_layers; ++i)
    rows += W + (((skip_mask >> i) & 1) ? DE : 0);
  return rows;
}

// The widest width whose consumers keep whole 64 x W accumulators; the
// packed widths above it (384, 512) take the column-split trunk.
constexpr int kWholeMaxWidth = 256;

// A warp-specialized shell's shape at width W: up to kWholeMaxWidth two
// consumer warpgroups of 64 whole-width rows (the producer's registers
// moved to them by setmaxnreg); above it one consumer warpgroup whose
// layers run as two column halves, ring stages of 64 K-rows x W / 2 and
// three activation tiles of 64 rows x W / 2 (fwd_trunk_split). With 256
// threads a thread may keep 255 registers, so the split shells move none.
template <int W>
struct FwdTraits {
  static constexpr bool kSplit = W > kWholeMaxWidth;
  static constexpr int kConsumers = kSplit ? 1 : kFwdConsumers;
  static constexpr int kThreads = 128 * (kConsumers + 1);
  static constexpr int kCtaRows = 64 * kConsumers;
  static constexpr int kStageBytes = (kSplit ? W / 2 : W) * 128;
  static constexpr int kActBytes =
      kSplit ? 3 * (W / 2) * 128 : kConsumers * W * 128;
};

size_t fwd_smem_bytes(int width, int d_enc_pad, int d_dir_pad,
                      int n_stages) {
  if (width > kWholeMaxWidth)      // FwdTraits<width>, kSplit
    return 1024 + (size_t)(n_stages + 3) * (width / 2) * 128 +
           (size_t)(enc_blocks(d_enc_pad) + enc_blocks(d_dir_pad)) * kBlock +
           2 * n_stages * sizeof(uint64_t);
  return 1024 + (size_t)(n_stages + kFwdConsumers) * width * 128 +
         (size_t)kFwdConsumers *
             (enc_blocks(d_enc_pad) + enc_blocks(d_dir_pad)) * kBlock +
         2 * n_stages * sizeof(uint64_t);
}

// The deepest ring up to kFwdMaxStages whose kernel fits in shared memory
// with `extra` bytes past the barriers, or 0 if a ring of 2 does not (at W
// = 256 encodings of more than 6 blocks together:
// ops/kernels/render.py::kernel_arch_error refuses them by name).
int fwd_stages(int width, int d_enc_pad, int d_dir_pad, size_t extra) {
  int n = kFwdMaxStages;
  while (n >= 2 && fwd_smem_bytes(width, d_enc_pad, d_dir_pad, n) + extra >
                       kMaxSmem)
    --n;
  return n < 2 ? 0 : n;
}

// Byte address of element (row, col) of a tile in that layout.
__device__ __forceinline__ unsigned char* tile_at(unsigned char* tile,
                                                  int row, int col) {
  return tile + (col >> 6) * kBlock + row * 128 +
         ((((col >> 3) & 7) ^ (row & 7)) << 4) + (col & 7) * 2;
}

// The encoded features of v (one row's 3 coordinates) into row `row` of
// an encoding tile of n_blocks blocks, 16-byte chunks c0, c0 + 2, ...
__device__ __forceinline__ void encode_row(unsigned char* tile,
                                           const float* v, int row, int c0,
                                           int n_blocks, int n_freqs,
                                           const float* freq,
                                           const float* mask) {
  for (int c = c0; c < 8 * n_blocks; c += 2) {
    uint32_t p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * c + 2 * e;
      const __nv_bfloat162 b = __floats2bfloat162_rn(
          encode_lane(v, col, n_freqs, freq, mask),
          encode_lane(v, col + 1, n_freqs, freq, mask));
      p[e] = *reinterpret_cast<const uint32_t*>(&b);
    }
    *reinterpret_cast<uint4*>(tile_at(tile, row, 8 * c)) =
        make_uint4(p[0], p[1], p[2], p[3]);
  }
}

// The MLP's shape as the producer and the consumers walk it.
struct FwdShape {
  int n_layers, skip_mask, d_enc_pad, d_dir_pad;
};

// The producer's loads of k weight rows from row `row` of `map` (n_box
// boxes of 64 columns each, from column col0): one ring stage (SC * 128
// bytes) of 64 rows per 64 of k, by TMA. `it` counts the stages fed. With
// `done`, the flag is read after each wait for a free stage, and the feed
// stops (returning false) once it is raised.
template <int SC>
__device__ __forceinline__ bool feed_stages(const CUtensorMap* map, int row,
                                            int k, int n_box,
                                            unsigned char* ring,
                                            uint64_t* full, uint64_t* empty,
                                            int n_stages, int& it,
                                            const volatile int* done,
                                            int col0 = 0) {
  for (int kc = 0; kc < k; kc += 64, ++it) {
    const int s = it % n_stages;
    if (it >= n_stages) {
      mbar_wait(&empty[s], (it / n_stages - 1) & 1);
      if (done != nullptr && *done) return false;
    }
    unsigned char* st = ring + s * (SC * 128);
    mbar_arrive_expect_tx(&full[s], n_box * kBlock);
    for (int q = 0; q < n_box; ++q)
      tma_load_2d(st + q * kBlock, map, &full[s], col0 + 64 * q, row + kc);
  }
  return true;
}

// The producer: one pass over the weight tiles in the consumers' order, by
// TMA into the ring: the trunk, then with `heads` w_conn and the branch.
// map_w views wpack as [rows, W] (the trunk matrices, w_sigma, w_conn:
// ops/kernels/mlp_train.py::wpack_views), map_br the branch's [w_branch_h;
// w_branch_d] as [W + DD, W / 2]. A stage always loads 64 rows: past a K
// below 64 they are the next matrix's rows (or zeros past the map), which
// the consumers' k16 steps never reach. `it` and `done` as feed_stages'.
template <int W, int NB>
__device__ __forceinline__ bool produce_pass(const CUtensorMap* map_w,
                                             const CUtensorMap* map_br,
                                             const FwdShape& sh, bool heads,
                                             unsigned char* ring,
                                             uint64_t* full, uint64_t* empty,
                                             int n_stages, int& it,
                                             const volatile int* done) {
  auto feed = [&](const CUtensorMap* map, int row, int k, int n_box) {
    return feed_stages<W>(map, row, k, n_box, ring, full, empty, n_stages,
                          it, done);
  };
  const int DE = sh.d_enc_pad;
  int row = DE;
  if (!feed(map_w, 0, DE, W / 64)) return false;        // W_0
  for (int i = 1; i < sh.n_layers; ++i) {
    if (!feed(map_w, row, W, W / 64)) return false;     // W_i (its h part)
    row += W;
    if ((sh.skip_mask >> i) & 1) {
      if (!feed(map_w, row, DE, W / 64)) return false;  // its encoding part
      row += DE;
    }
  }
  if (!heads) return true;
  return feed(map_w, row + 1, W, W / 64) &&             // w_conn, past w_sigma
         feed(map_br, 0, W, NB / 64) &&                 // w_branch_h
         feed(map_br, W, sh.d_dir_pad, NB / 64);        // w_branch_d
}

// A consumer's view of the ring: shared address of stage 0, its bytes,
// the barriers, and the stages this consumer has taken.
struct FwdRing {
  uint32_t base;
  int stage_bytes;
  uint64_t *full, *empty;
  int n_stages;
  int it;
  bool lead;                // the thread that arrives for the warpgroup
};

// One product segment of a consumer: acc (+)= A[64, :K] @ B[:K, N], A its
// K-major tile at shared address a, B the ring's next ceil(K / 64)
// stages (N-major, W / 64 or NB / 64 boxes of 64 columns). Only the k16
// steps below K run. Each stage goes back to the producer (one arrival of
// this warpgroup) once its wgmma have completed; returns with all of them
// complete.
template <int NACC>
__device__ __forceinline__ void fwd_product(float (&acc)[NACC], uint32_t a,
                                            int K, bool zero, FwdRing& r) {
  const int nk = (K + 63) / 64;
  for (int kc = 0; kc < nk; ++kc, ++r.it) {
    const int s = r.it % r.n_stages;
    mbar_wait(&r.full[s], (r.it / r.n_stages) & 1);
    const uint32_t b = r.base + s * r.stage_bytes;
    const int steps = min(4, (K - 64 * kc) / 16);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk < steps)
        wgmma_kn(acc, sw128_desc(a + kc * kBlock + 32 * kk, 16, 1024),
                 sw128_desc(b + 2048 * kk, kBlock, 1024),
                 zero && kc == 0 && kk == 0 ? 0 : 1);
    }
    wgmma_commit();
    wgmma_wait<1>();          // the stage before this one has been read
    if (kc > 0 && r.lead) mbar_arrive(&r.empty[(r.it - 1) % r.n_stages]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (r.lead) mbar_arrive(&r.empty[(r.it - 1) % r.n_stages]);
}

// The NeRF layers' activation in fwd_epilogue: ReLU, or none (feat).
struct ReluAct {
  bool on;
  __device__ __forceinline__ float2 operator()(float v0, float v1, int,
                                               int) {
    return on ? make_float2(fmaxf(v0, 0.f), fmaxf(v1, 0.f))
              : make_float2(v0, v1);
  }
  __device__ __forceinline__ void chunk_end(int) {}
};

// The NeRF trunk's activation of every layer, for fwd_trunk (col: the
// output half's first column in a split layer, fwd_trunk_split). kSigma:
// the last layer's epilogue also takes the sigma head's partial dots.
struct ReluActs {
  static constexpr bool kSigma = true;
  __device__ __forceinline__ ReluAct layer(int, int = 0) const {
    return {true};
  }
};

// A layer's epilogue on this thread's accumulators (rows 16 warp + lane / 4
// + 8 h of the warpgroup's 64, columns 8 j + 2 (lane % 4) + e):
// tile = bf16(act(acc + bias)), act(v0, v1, h, jj) giving the activated
// pair of this thread's two columns of row h in column block jj of the
// chunk, act.chunk_end(j0) called after each chunk of kChunk column
// blocks (ReluAct; the SIREN's sine of siren_common.cuh, which may stage a
// chunk's factors there). With w_sigma (the last trunk layer), also sig[h]
// += the row's bf16 activations . w_sigma over this thread's columns. The
// bias (and w_sigma) of kChunk column blocks are loaded before their
// stores, so that their latencies overlap; the bf16 pairs go to the tile
// by stmatrix, four 8 x 8 blocks at a time.
template <int NACC, class Act>
__device__ __forceinline__ void fwd_epilogue(const float (&acc)[NACC],
                                             const float* bias, Act act,
                                             unsigned char* tile,
                                             const bf16* w_sigma,
                                             float (&sig)[2]) {
  constexpr int kChunk = 8;
  const int lane = threadIdx.x & 31;
  // stmatrix: lane l addresses row l % 8 of 8 x 8 block m = l / 8 of the
  // four (column block j + m / 2, row half m % 2) that one x4 stores
  const int m = lane >> 3;
  const int srow = 16 * ((threadIdx.x >> 5) & 3) + 8 * (m & 1) + (lane & 7);
#pragma unroll
  for (int j0 = 0; j0 < NACC / 4; j0 += kChunk) {
    float bv[kChunk][2], wv[kChunk][2];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int col = 8 * (j0 + jj) + 2 * (lane & 3);
      bv[jj][0] = bias[col];
      bv[jj][1] = bias[col + 1];
      wv[jj][0] = wv[jj][1] = 0.f;
      if (w_sigma) {
        wv[jj][0] = __bfloat162float(w_sigma[col]);
        wv[jj][1] = __bfloat162float(w_sigma[col + 1]);
      }
    }
    uint32_t packed[kChunk][2];
#pragma unroll
    for (int jj = 0; jj < kChunk; ++jj) {
      const int j = j0 + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 v = act(acc[4 * j + 2 * h] + bv[jj][0],
                             acc[4 * j + 2 * h + 1] + bv[jj][1], h, jj);
        const __nv_bfloat162 p = __floats2bfloat162_rn(v.x, v.y);
        packed[jj][h] = *reinterpret_cast<const uint32_t*>(&p);
        if (w_sigma)
          sig[h] += __low2float(p) * wv[jj][0] + __high2float(p) * wv[jj][1];
      }
    }
#pragma unroll
    for (int jj = 0; jj < kChunk; jj += 2)
      stsm_x4(smem_u32(tile_at(tile, srow, 8 * (j0 + jj + (m >> 1)))),
              packed[jj][0], packed[jj][1], packed[jj + 1][0],
              packed[jj + 1][1]);
    act.chunk_end(j0);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The trunk over a consumer's 64 rows, its encodings in the tile at encx:
// each layer's product into acc, its epilogue into the activation tile
// act, which ends holding h_{L-1}; layer i's activation is acts.layer(i)
// (ReLU for the NeRF; the SIREN's sines). On the last layer sig[h] gets
// this thread's partial sigma dots (w_sigma past the trunk in wpack; null
// for none). With map_acts, one thread stores each layer's tile to acts
// (columns i W, rows row0 ...) by TMA while the next layer runs. `bar` is
// the warpgroup's named barrier.
template <int W, class Acts = ReluActs>
__device__ __forceinline__ void fwd_trunk(float (&acc)[W / 2], FwdRing& r,
                                          unsigned char* act, uint32_t encx,
                                          const FwdShape& sh,
                                          const float* b,
                                          const bf16* w_sigma,
                                          float (&sig)[2], int bar,
                                          const CUtensorMap* map_acts,
                                          int row0,
                                          const Acts& acts = Acts()) {
  const uint32_t act_a = smem_u32(act);
  const int L = sh.n_layers, DE = sh.d_enc_pad;
  for (int i = 0; i < L; ++i) {
    if (i == 0) {
      fwd_product(acc, encx, DE, true, r);
    } else {
      fwd_product(acc, act_a, W, true, r);
      if ((sh.skip_mask >> i) & 1) fwd_product(acc, encx, DE, false, r);
    }
    if (r.lead) bulk_wait_read<0>();    // the last store has read the tile
    named_bar(bar, 128);
    fwd_epilogue(acc, b + i * W, acts.layer(i), act,
                 i == L - 1 ? w_sigma : nullptr, sig);
    fence_proxy_async();
    named_bar(bar, 128);
    if (r.lead && map_acts != nullptr) {
      for (int q = 0; q < W / 64; ++q)
        tma_store_2d(map_acts, act + q * kBlock, i * W + 64 * q, row0);
      bulk_commit();
    }
  }
}

// The connection after the trunk (act holding h_{L-1}): feat = bf16(
// h_{L-1} @ w_conn + b_conn) over act. b_conn points past b_sigma.
template <int W>
__device__ __forceinline__ void fwd_conn(float (&acc)[W / 2], FwdRing& r,
                                         unsigned char* act,
                                         const float* b_conn, int bar) {
  float unused[2] = {0.f, 0.f};
  fwd_product(acc, smem_u32(act), W, true, r);
  if (r.lead) bulk_wait_read<0>();
  named_bar(bar, 128);
  fwd_epilogue(acc, b_conn, ReluAct{false}, act, nullptr, unused);
  fence_proxy_async();
  named_bar(bar, 128);
}

// The branch after fwd_conn (act holding feat): br = bf16(relu(feat @
// w_branch_h + encd @ w_branch_d + b_branch)) in registers, then rgb[h][c]
// = sigmoid(br @ w_rgb + b_rgb) of rows 16 warp + lane / 4 + 8 h, in every
// lane of the quad. w_conn and b_conn point past w_sigma and b_sigma.
template <int W, int NB>
__device__ __forceinline__ void branch_rgb(const float (&bacc)[NB / 2],
                                           int DD, const bf16* w_conn,
                                           const float* b_conn,
                                           float (&rgb)[2][3]);

template <int W, int NB>
__device__ __forceinline__ void fwd_branch(FwdRing& r, unsigned char* act,
                                           uint32_t encd, int DD,
                                           const bf16* w_conn,
                                           const float* b_conn,
                                           float (&rgb)[2][3]) {
  float bacc[NB / 2];
  fwd_product(bacc, smem_u32(act), W, true, r);
  fwd_product(bacc, encd, DD, false, r);
  branch_rgb<W, NB>(bacc, DD, w_conn, b_conn, rgb);
}

// The branch's epilogue and the rgb head on the branch product bacc (no
// bias yet), as fwd_branch's.
template <int W, int NB>
__device__ __forceinline__ void branch_rgb(const float (&bacc)[NB / 2],
                                           int DD, const bf16* w_conn,
                                           const float* b_conn,
                                           float (&rgb)[2][3]) {
  constexpr int Wh = W / 2;
  const int lane = threadIdx.x & 31;
  const float* b_branch = b_conn + W;
  const bf16* w_rgb = w_conn + W * W + W * Wh + DD * Wh;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[h][c] = 0.f;
#pragma unroll
  for (int j = 0; j < Wh / 8; ++j) {
    const int col = 8 * j + 2 * (lane & 3);
    const float b0 = b_branch[col], b1 = b_branch[col + 1];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const __nv_bfloat162 p = __floats2bfloat162_rn(
          fmaxf(bacc[4 * j + 2 * h] + b0, 0.f),
          fmaxf(bacc[4 * j + 2 * h + 1] + b1, 0.f));
      const float v0 = __low2float(p), v1 = __high2float(p);
#pragma unroll
      for (int c = 0; c < 3; ++c)
        rgb[h][c] += v0 * __bfloat162float(w_rgb[3 * col + c]) +
                     v1 * __bfloat162float(w_rgb[3 * col + 3 + c]);
    }
  }
  const float* b_rgb = b_branch + Wh;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[h][c] = 1.f / (1.f + expf(-(quad_sum(rgb[h][c]) + b_rgb[c])));
}

// sigma's activation: raw (0), ReLU (1) or exp(clip(., -15, 15)) (2)
__device__ __forceinline__ float density_activate(float s, int act) {
  if (act == 1) return fmaxf(s, 0.f);
  if (act == 2) return expf(fminf(fmaxf(s, -15.f), 15.f));
  return s;
}

// The kernels' set-up: the ring's barriers (full: one arrival with the
// stage's bytes; empty: one arrival per consumer, `consumers` of them) and
// `extra` more barriers of one arrival, initialised by thread 0 and made
// visible to TMA; the caller then syncs the CTA.
__device__ __forceinline__ void fwd_init_barriers(uint64_t* full,
                                                  uint64_t* empty,
                                                  int n_stages,
                                                  uint64_t* extra,
                                                  int n_extra,
                                                  int consumers =
                                                      kFwdConsumers) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], consumers);
    }
    for (int e = 0; e < n_extra; ++e) mbar_init(&extra[e], 1);
    mbar_fence_init();
  }
}

// The weight maps of wpack at width W: [trunk_rows, W] (the trunk
// matrices, w_sigma, w_conn) and, with map_br, the branch's [W + DD, W /
// 2] right after it. False if one cannot be encoded.
template <int W>
bool encode_weight_maps(CUtensorMap* map_w, CUtensorMap* map_br,
                        const bf16* wpack, int trunk_rows, int DD) {
  if (!encode_bf16_map(map_w, wpack, trunk_rows, W, W, 64)) return false;
  return map_br == nullptr ||
         encode_bf16_map(map_br, wpack + (size_t)trunk_rows * W, W + DD,
                         W / 2, W / 2, 64);
}

// ---- the column-split trunk (packed widths 384 and 512) ---------------
//
// One consumer warpgroup of 64 rows (the NeRF shells; with the sine
// epilogue of siren_common.cuh also the SIREN forward and march; the
// SIREN backward's row pass of siren.cu splits its products the same
// way). Each layer (and the connection) runs as two output column halves
// of Wh = W / 2, one after the other, into the same Wh accumulator
// (wgmma m64n192 / m64n256: 96 / 128 registers a thread, as at W = 192 /
// 256). A layer reads both halves of its input for
// each output half, so three half-width tiles rotate (SplitActs): the
// first output half goes to the free tile, the second over the input's
// first half once both halves' products have retired; the input's second
// half is then free. The producer feeds each layer half by half
// (produce_pass_split: per output half, the K tiles of that half's columns
// in the consumer's order), each stage 64 K-rows x Wh, read by the one
// consumer (its empty barriers take one arrival). The sigma head's partial
// dots add up over both halves of the last layer in the same two
// registers; the skip layer's products W_h (both input halves) and W_e go
// into each output half; the branch (N = head_n(W) = Wh) stays one
// product over both halves of feat and the direction encoding.

// The three activation tiles (64 rows x Wh, K-major, 128B-swizzled) and
// which hold the current input's halves (in0, in1) and which is free.
template <int W>
struct SplitActs {
  static constexpr int kBytes = (W / 2) * 128;
  unsigned char* base;
  int in0, in1, spare;

  __device__ __forceinline__ explicit SplitActs(unsigned char* b)
      : base(b), in0(1), in1(2), spare(0) {}
  __device__ __forceinline__ unsigned char* tile(int i) const {
    return base + i * kBytes;
  }
  // where output half n of the running layer goes
  __device__ __forceinline__ unsigned char* out(int n) const {
    return tile(n == 0 ? spare : in0);
  }
  // after the layer: its output (spare, in0) is the next input
  __device__ __forceinline__ void advance() {
    const int f = in1;
    in1 = in0;
    in0 = spare;
    spare = f;
  }
};

// The producer's pass at a split width: each layer, w_conn and (with
// `heads`) the branch, in the consumer's order (produce_pass's walk, each
// trunk matrix fed once per output half from that half's columns).
template <int W, int NB>
__device__ __forceinline__ bool produce_pass_split(
    const CUtensorMap* map_w, const CUtensorMap* map_br, const FwdShape& sh,
    bool heads, unsigned char* ring, uint64_t* full, uint64_t* empty,
    int n_stages, int& it, const volatile int* done) {
  constexpr int Wh = W / 2;
  auto feed = [&](const CUtensorMap* map, int row, int k, int n_box,
                  int col0) {
    return feed_stages<Wh>(map, row, k, n_box, ring, full, empty, n_stages,
                           it, done, col0);
  };
  const int DE = sh.d_enc_pad;
  for (int n = 0; n < 2; ++n)                            // W_0
    if (!feed(map_w, 0, DE, Wh / 64, n * Wh)) return false;
  int row = DE;
  for (int i = 1; i < sh.n_layers; ++i) {
    const bool skip = (sh.skip_mask >> i) & 1;
    for (int n = 0; n < 2; ++n) {
      if (!feed(map_w, row, W, Wh / 64, n * Wh)) return false;  // W_i (h)
      if (skip && !feed(map_w, row + W, DE, Wh / 64, n * Wh))  // its enc
        return false;
    }
    row += W + (skip ? DE : 0);
  }
  if (!heads) return true;
  for (int n = 0; n < 2; ++n)                            // w_conn
    if (!feed(map_w, row + 1, W, Wh / 64, n * Wh)) return false;
  return feed(map_br, 0, W, NB / 64, 0) &&               // w_branch_h
         feed(map_br, W, sh.d_dir_pad, NB / 64, 0);      // w_branch_d
}

// One output half's epilogue of a split layer into t.out(n), with the
// activation act (fwd_epilogue's policy): the warpgroup waits for the last
// acts store to have read its tile and for every warp's products, writes,
// and (with map_acts) one thread stores the half to acts (columns gcol
// ..., rows row0 ...) by TMA.
template <int W, class Act>
__device__ __forceinline__ void split_epilogue(
    const float (&acc)[W / 4], const SplitActs<W>& t, int n,
    const float* bias, Act act, const bf16* w_sigma, float (&sig)[2],
    int bar, bool lead, const CUtensorMap* map_acts, int gcol, int row0) {
  unsigned char* out = t.out(n);
  if (lead) bulk_wait_read<0>();
  named_bar(bar, 128);
  fwd_epilogue(acc, bias, act, out, w_sigma, sig);
  fence_proxy_async();
  named_bar(bar, 128);
  if (lead && map_acts != nullptr) {
    for (int q = 0; q < W / 128; ++q)
      tma_store_2d(map_acts, out + q * kBlock, gcol + 64 * q, row0);
    bulk_commit();
  }
}

// The product of one output half over the input's two halves.
template <int W>
__device__ __forceinline__ void split_product(float (&acc)[W / 4],
                                              const SplitActs<W>& t,
                                              FwdRing& r) {
  fwd_product(acc, smem_u32(t.tile(t.in0)), W / 2, true, r);
  fwd_product(acc, smem_u32(t.tile(t.in1)), W / 2, false, r);
}

// fwd_trunk at a split width: the trunk over the consumer's 64 rows, its
// encodings (or the SIREN's raw inputs) at encx; ends with h_{L-1} in
// (t.in0, t.in1). Output half n of layer i takes acts.layer(i, n W / 2)
// (ReLU for the NeRF; the SIREN's sines, whose saved factors go to that
// half's columns). sig (with Acts::kSigma), map_acts, row0 and bar as
// fwd_trunk's.
template <int W, class Acts = ReluActs>
__device__ __forceinline__ void fwd_trunk_split(
    float (&acc)[W / 4], FwdRing& r, SplitActs<W>& t, uint32_t encx,
    const FwdShape& sh, const float* b, const bf16* w_sigma,
    float (&sig)[2], int bar, const CUtensorMap* map_acts, int row0,
    const Acts& acts = Acts()) {
  constexpr int Wh = W / 2;
  const int L = sh.n_layers, DE = sh.d_enc_pad;
  for (int i = 0; i < L; ++i) {
    for (int n = 0; n < 2; ++n) {
      if (i == 0) {
        fwd_product(acc, encx, DE, true, r);
      } else {
        split_product<W>(acc, t, r);
        if ((sh.skip_mask >> i) & 1) fwd_product(acc, encx, DE, false, r);
      }
      split_epilogue<W>(acc, t, n, b + i * W + n * Wh, acts.layer(i, n * Wh),
                        Acts::kSigma && i == L - 1 ? w_sigma + n * Wh
                                                   : nullptr,
                        sig, bar, r.lead, map_acts, i * W + n * Wh, row0);
    }
    t.advance();
  }
}

// fwd_conn at a split width: feat = bf16(h_{L-1} @ w_conn + b_conn), in
// (t.in0, t.in1) after it.
template <int W>
__device__ __forceinline__ void fwd_conn_split(float (&acc)[W / 4],
                                               FwdRing& r, SplitActs<W>& t,
                                               const float* b_conn,
                                               int bar) {
  float unused[2] = {0.f, 0.f};
  for (int n = 0; n < 2; ++n) {
    split_product<W>(acc, t, r);
    split_epilogue<W>(acc, t, n, b_conn + n * (W / 2), ReluAct{false},
                      nullptr, unused, bar, r.lead, nullptr, 0, 0);
  }
  t.advance();
}

// An accumulator set to 0 before its first product: the wgmma operands
// read and write it ("+f"), so one left undefined in a loop body is live
// across the iterations. In the split march the trunk's and the branch's
// (128 registers each at W = 512) would then be live together and spill.
template <int N>
__device__ __forceinline__ void zero_acc(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// fwd_branch at a split width (feat in t.in0, t.in1).
template <int W, int NB>
__device__ __forceinline__ void fwd_branch_split(FwdRing& r,
                                                 const SplitActs<W>& t,
                                                 uint32_t encd, int DD,
                                                 const bf16* w_conn,
                                                 const float* b_conn,
                                                 float (&rgb)[2][3]) {
  float bacc[NB / 2];
  zero_acc(bacc);
  fwd_product(bacc, smem_u32(t.tile(t.in0)), W / 2, true, r);
  fwd_product(bacc, smem_u32(t.tile(t.in1)), W / 2, false, r);
  fwd_product(bacc, encd, DD, false, r);
  branch_rgb<W, NB>(bacc, DD, w_conn, b_conn, rgb);
}

// ---- the streamed trunk (packed widths 768 and every multiple of 256 up)
//
// One consumer warpgroup of 64 rows per CTA and a producer warpgroup, the
// CTAs persistent over the row tiles (the march's ray blocks), one
// instance for every streamed width (W and its loop counts at run time;
// W a multiple of 256, as the branch's N = W / 2 runs in 128-column
// chunks); the NeRF
// shells' and, with the sine epilogue and siren_common.cuh's streamed
// heads, the SIREN forward's and march's. Each layer
// (and the connection) runs as W / kStreamCols output column chunks, one
// after the other, into one m64n256 accumulator (128 registers a thread,
// the whole-width consumer's at W = 256), so fwd_epilogue applies; each
// chunk's bf16 tile is stored by TMA to the layer's output in device
// memory (StreamBufs: the CTA's 64 rows of a [ctas * 64, 2 W] scratch,
// layer j in columns (j % 2) W, or in saved mode each trunk layer straight
// to the acts stream). The next layer's A operand comes back from there in
// 64-column K tiles by TMA, through a ring of kStreamAStages tiles that the
// consumer's lead thread keeps kStreamAStages - 1 tiles ahead (every chunk
// rereads the same K tiles, so the lead runs ahead across chunks), issuing
// a layer's first loads only once its input's stores have completed
// (cp.async.bulk.wait_group 0, then a proxy fence). The weights come
// through the producer's ring as at every width, in stages of 64 K-rows x
// kStreamCols columns (produce_pass_stream), read by the one consumer. The
// first layer's and the skip layer's encoding products read encx in shared
// memory, the branch's direction product encd; the sigma head's partial
// dots add up over the last layer's chunks in two registers, as in
// fwd_trunk_split; the branch (N = W / 2) runs as W / 256 chunks of
// kStreamBranchCols columns whose epilogues add up the rgb head's partial
// dots. Per row and layer 2 W^2 FLOP against 4 W bytes through L2 (W / 2
// FLOP a byte: 384 at 768, 512 at 1024, past the H100's bf16 ridge of
// ~295 FLOP a byte of HBM), so sending the activations out and back keeps
// the layers compute-bound, more so as W grows, whether or not the CTAs'
// scratch slots (64 x 2 W bf16 each) stay in L2. The bf16 values read
// back are the ones the in-register path rounds, so the numerics are the
// other widths'.

constexpr int kStreamCols = 256;        // a trunk / connection chunk
constexpr int kStreamBranchCols = 128;  // a branch chunk
constexpr int kStreamAStages = 4;       // the A ring's 64 x 64 tiles
constexpr int kStreamStageBytes = kStreamCols * 128;

constexpr int kStreamMinWidth = 768;
constexpr int kStreamStep = 256;

__host__ __device__ constexpr bool stream_width(int W) {
  return W >= kStreamMinWidth && W % kStreamStep == 0;
}

// The packed weights are addressed by int32 element offsets (the weight-
// gradient jobs' w_off, n_w), so a launch takes at most this many (which
// bounds the streamed width: W_max, ops/kernels/render.py).
constexpr size_t kMaxPackedWeights = 2147483647;

// (ops/kernels/render.py::shell_smem_bytes mirrors it): the weight ring,
// the A ring, the output chunk's tile, encx and encd, the ring's and the A
// ring's barriers.
size_t stream_smem_bytes(int d_enc_pad, int d_dir_pad, int n_stages) {
  return 1024 + (size_t)n_stages * kStreamStageBytes +
         (size_t)(kStreamAStages + kStreamCols / 64 + enc_blocks(d_enc_pad) +
                  enc_blocks(d_dir_pad)) *
             kBlock +
         (2 * n_stages + kStreamAStages) * sizeof(uint64_t);
}

// The deepest weight ring up to kFwdMaxStages that fits with `extra` bytes
// past the barriers, or 0 if a ring of 2 does not.
int stream_stages(int d_enc_pad, int d_dir_pad, size_t extra) {
  int n = kFwdMaxStages;
  while (n >= 2 &&
         stream_smem_bytes(d_enc_pad, d_dir_pad, n) + extra > kMaxSmem)
    --n;
  return n < 2 ? 0 : n;
}

// A streamed shell's shared memory, from a 1024-byte boundary.
struct StreamTiles {
  unsigned char *ring, *a, *out, *encx, *encd;
  uint64_t *full, *empty, *afull, *extra;
};

__device__ __forceinline__ StreamTiles stream_carve(unsigned char* raw,
                                                    int n_stages, int de,
                                                    int dd) {
  StreamTiles s;
  s.ring = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  s.a = s.ring + n_stages * kStreamStageBytes;
  s.out = s.a + kStreamAStages * kBlock;
  s.encx = s.out + kStreamCols * 128;
  s.encd = s.encx + enc_blocks(de) * kBlock;
  s.full = reinterpret_cast<uint64_t*>(s.encd + enc_blocks(dd) * kBlock);
  s.empty = s.full + n_stages;
  s.afull = s.empty + n_stages;
  s.extra = s.afull + kStreamAStages;
  return s;
}

// The producer's pass at a streamed width W: per layer and output chunk,
// the K tiles of that chunk's columns (the h part, then at a skip layer
// the encoding part), then w_conn's chunks and (with `heads`) the branch's
// chunks (w_branch_h, then w_branch_d), in the consumer's order. `it` and
// `done` as feed_stages'.
__device__ __forceinline__ bool produce_pass_stream(
    const CUtensorMap* map_w, const CUtensorMap* map_br, int W,
    const FwdShape& sh, bool heads, unsigned char* ring, uint64_t* full,
    uint64_t* empty, int n_stages, int& it, const volatile int* done) {
  auto feed = [&](const CUtensorMap* map, int row, int k, int cols,
                  int col0) {
    return feed_stages<kStreamCols>(map, row, k, cols / 64, ring, full,
                                    empty, n_stages, it, done, col0);
  };
  const int DE = sh.d_enc_pad, nc = W / kStreamCols;
  for (int c = 0; c < nc; ++c)                           // W_0
    if (!feed(map_w, 0, DE, kStreamCols, c * kStreamCols)) return false;
  int row = DE;
  for (int i = 1; i < sh.n_layers; ++i) {
    const bool skip = (sh.skip_mask >> i) & 1;
    for (int c = 0; c < nc; ++c) {
      if (!feed(map_w, row, W, kStreamCols, c * kStreamCols))  // W_i (h)
        return false;
      if (skip && !feed(map_w, row + W, DE, kStreamCols, c * kStreamCols))
        return false;                                    // its encoding part
    }
    row += W + (skip ? DE : 0);
  }
  if (!heads) return true;
  for (int c = 0; c < nc; ++c)                           // w_conn
    if (!feed(map_w, row + 1, W, kStreamCols, c * kStreamCols)) return false;
  for (int c = 0; c < W / 2 / kStreamBranchCols; ++c) {  // the branch
    const int col0 = c * kStreamBranchCols;
    if (!feed(map_br, 0, W, kStreamBranchCols, col0) ||
        !feed(map_br, W, sh.d_dir_pad, kStreamBranchCols, col0))
      return false;
  }
  return true;
}

// Where a layer's output lives in device memory: a tensor map and the
// column and row of the CTA's first element.
struct StreamAt {
  const CUtensorMap* map;
  int col, row;
};

// The outputs of a pass over one row tile: layer j (the trunk's 0 .. L - 1,
// then feat as L) in the CTA's scratch rows slab_row .. + 63, columns (j %
// 2) W; with acts (saved mode), the trunk's layers in the acts stream's
// rows acts_row .., columns j W instead.
struct StreamBufs {
  const CUtensorMap* acts;
  const CUtensorMap* slab;
  int acts_row, slab_row, W, L;

  __device__ __forceinline__ StreamAt at(int j) const {
    if (acts != nullptr && j < L) return {acts, j * W, acts_row};
    return {slab, (j & 1) * W, slab_row};
  }
};

// The consumer's A ring: shared address and pointer of tile 0, the
// barriers, and the tiles it has taken.
struct ARing {
  uint32_t base;
  unsigned char* tiles;
  uint64_t* full;
  int it;
};

// One product's streamed operand: the K tiles of src (nk of them), read
// again by each of its chunks; `first` is the A ring's count at its first
// tile.
struct AStream {
  StreamAt src;
  int nk, total, first;
};

// The lead's load of tile q of the operand's sequence (chunk q / nk, K
// tile q % nk) into its A ring slot.
__device__ __forceinline__ void a_issue(const ARing& ar, const AStream& st,
                                        int q) {
  const int slot = (st.first + q) % kStreamAStages;
  mbar_arrive_expect_tx(&ar.full[slot], kBlock);
  tma_load_2d(ar.tiles + slot * kBlock, st.src.map, &ar.full[slot],
              st.src.col + 64 * (q % st.nk), st.src.row);
}

// Starts a product whose A is src[64, :K] (K 0: none) over n_chunks
// output chunks: the lead fills the A ring's first tiles. The caller has
// flushed src's stores (stream_flush).
__device__ __forceinline__ AStream stream_begin(const ARing& ar,
                                                const StreamAt& src, int K,
                                                int n_chunks, bool lead) {
  const AStream st{src, K / 64, n_chunks * (K / 64), ar.it};
  if (lead)
    for (int q = 0; q < min(kStreamAStages - 1, st.total); ++q)
      a_issue(ar, st, q);
  return st;
}

// One output chunk: acc = A[64, :K] @ B (the ring's next nk stages; A
// tiles from the A ring, which the lead refills kStreamAStages - 1 ahead
// as each tile's wgmma retire), then with DE acc += enc[64, :DE] @ B_enc
// (fwd_product, from shared memory; alone when there is no streamed A).
// Each weight stage goes back to the producer once its wgmma have
// completed; returns with all of them complete.
template <int NACC>
__device__ __forceinline__ void stream_chunk(float (&acc)[NACC], FwdRing& r,
                                             ARing& ar, const AStream& st,
                                             uint32_t enc, int DE) {
  for (int kc = 0; kc < st.nk; ++kc, ++ar.it, ++r.it) {
    const int s = r.it % r.n_stages, as = ar.it % kStreamAStages;
    mbar_wait(&r.full[s], (r.it / r.n_stages) & 1);
    mbar_wait(&ar.full[as], (ar.it / kStreamAStages) & 1);
    const uint32_t a = ar.base + as * kBlock;
    const uint32_t b = r.base + s * r.stage_bytes;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_kn(acc, sw128_desc(a + 32 * kk, 16, 1024),
               sw128_desc(b + 2048 * kk, kBlock, 1024),
               kc == 0 && kk == 0 ? 0 : 1);
    wgmma_commit();
    wgmma_wait<1>();          // the tiles before this one have been read
    if (r.lead) {
      if (kc > 0) mbar_arrive(&r.empty[(r.it - 1) % r.n_stages]);
      const int q = ar.it - st.first + kStreamAStages - 1;
      if (q < st.total) a_issue(ar, st, q);
    }
  }
  if (st.nk > 0) {
    wgmma_wait<0>();
    fence_regs(acc);
    if (r.lead) mbar_arrive(&r.empty[(r.it - 1) % r.n_stages]);
  }
  if (DE > 0) fwd_product(acc, enc, DE, st.nk == 0, r);
}

// A trunk or connection chunk's epilogue: the warpgroup waits for the last
// store to have read the output tile, writes bf16(act(acc + bias)) there
// (fwd_epilogue's activation policy: ReluAct, or the SIREN's SineAct,
// which stores its saved factors itself; with w_sigma, sig += this
// thread's partial sigma dots), and the lead stores it by TMA to dst's
// columns col ...
template <class Act>
__device__ __forceinline__ void stream_store_chunk(
    const float (&acc)[kStreamCols / 2], unsigned char* out,
    const float* bias, Act act, const bf16* w_sigma, float (&sig)[2],
    int bar, bool lead, const StreamAt& dst, int col) {
  if (lead) bulk_wait_read<0>();
  named_bar(bar, 128);
  fwd_epilogue(acc, bias, act, out, w_sigma, sig);
  fence_proxy_async();
  named_bar(bar, 128);
  if (lead) {
    for (int q = 0; q < kStreamCols / 64; ++q)
      tma_store_2d(dst.map, out + q * kBlock, col + 64 * q, dst.row);
    bulk_commit();
  }
}

// The lead waits for its stores to be complete in device memory, for the
// next product's loads of them.
__device__ __forceinline__ void stream_flush(bool lead) {
  if (lead) {
    bulk_wait<0>();
    fence_proxy_async_global();
  }
}

// The trunk over the CTA's 64 rows at width W, its encodings (or the
// SIREN's raw inputs) at s.encx: layer i's output to io.at(i), chunk c
// with the activation acts.layer(i, c kStreamCols) (ReLU for the NeRF; the
// SIREN's sines, whose saved factors go to that chunk's columns); on the
// last layer (with Acts::kSigma) sig[h] gets this thread's partial sigma
// dots (w_sigma past the trunk in wpack).
template <class Acts = ReluActs>
__device__ __forceinline__ void stream_trunk(float (&acc)[kStreamCols / 2],
                                             FwdRing& r, ARing& ar,
                                             const StreamTiles& s,
                                             const FwdShape& sh, int W,
                                             const float* b,
                                             const bf16* w_sigma,
                                             float (&sig)[2], int bar,
                                             const StreamBufs& io,
                                             const Acts& acts = Acts()) {
  const int L = sh.n_layers, DE = sh.d_enc_pad, nc = W / kStreamCols;
  const uint32_t encx = smem_u32(s.encx);
  for (int i = 0; i < L; ++i) {
    const bool enc = i == 0 || ((sh.skip_mask >> i) & 1);
    const AStream st =
        stream_begin(ar, i == 0 ? io.at(0) : io.at(i - 1), i == 0 ? 0 : W,
                     nc, r.lead);
    const StreamAt dst = io.at(i);
    for (int c = 0; c < nc; ++c) {
      stream_chunk(acc, r, ar, st, encx, enc ? DE : 0);
      stream_store_chunk(acc, s.out, b + i * W + c * kStreamCols,
                         acts.layer(i, c * kStreamCols),
                         Acts::kSigma && i == L - 1
                             ? w_sigma + c * kStreamCols
                             : nullptr,
                         sig, bar, r.lead, dst, dst.col + c * kStreamCols);
    }
    stream_flush(r.lead);
  }
}

// The connection: feat = bf16(h_{L-1} @ w_conn + b_conn) to io.at(L).
// b_conn points past b_sigma.
__device__ __forceinline__ void stream_conn(float (&acc)[kStreamCols / 2],
                                            FwdRing& r, ARing& ar,
                                            const StreamTiles& s, int W,
                                            const float* b_conn, int bar,
                                            const StreamBufs& io) {
  float unused[2] = {0.f, 0.f};
  const int nc = W / kStreamCols;
  const AStream st = stream_begin(ar, io.at(io.L - 1), W, nc, r.lead);
  const StreamAt dst = io.at(io.L);
  for (int c = 0; c < nc; ++c) {
    stream_chunk(acc, r, ar, st, 0, 0);
    stream_store_chunk(acc, s.out, b_conn + c * kStreamCols, ReluAct{false},
                       nullptr, unused, bar, r.lead, dst,
                       dst.col + c * kStreamCols);
  }
  stream_flush(r.lead);
}

// The branch over feat (at `feat`) and encd: br = bf16(relu(feat @
// w_branch_h + encd @ w_branch_d + b_branch)) chunk by chunk in registers,
// each chunk's rgb partial dots summed into rgb; then rgb[h][c] =
// sigmoid(rgb + b_rgb) of rows 16 warp + lane / 4 + 8 h, in every lane of
// the quad. w_conn and b_conn point past w_sigma and b_sigma.
__device__ __forceinline__ void stream_branch(FwdRing& r, ARing& ar,
                                              const StreamTiles& s,
                                              const StreamAt& feat, int W,
                                              int DD, const bf16* w_conn,
                                              const float* b_conn,
                                              float (&rgb)[2][3]) {
  constexpr int NC = kStreamBranchCols;
  const int lane = threadIdx.x & 31, Wh = W / 2, nb = Wh / NC;
  const float* b_branch = b_conn + W;
  const bf16* w_rgb = w_conn + (size_t)W * W + (size_t)W * Wh + DD * Wh;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c) rgb[h][c] = 0.f;
  float bacc[NC / 2];
  zero_acc(bacc);
  const AStream st = stream_begin(ar, feat, W, nb, r.lead);
  for (int n = 0; n < nb; ++n) {
    stream_chunk(bacc, r, ar, st, smem_u32(s.encd), DD);
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int col = n * NC + 8 * j + 2 * (lane & 3);
      const float b0 = b_branch[col], b1 = b_branch[col + 1];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(
            fmaxf(bacc[4 * j + 2 * h] + b0, 0.f),
            fmaxf(bacc[4 * j + 2 * h + 1] + b1, 0.f));
        const float v0 = __low2float(p), v1 = __high2float(p);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          rgb[h][c] += v0 * __bfloat162float(w_rgb[3 * col + c]) +
                       v1 * __bfloat162float(w_rgb[3 * col + 3 + c]);
      }
    }
  }
  const float* b_rgb = b_branch + Wh;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      rgb[h][c] = 1.f / (1.f + expf(-(quad_sum(rgb[h][c]) + b_rgb[c])));
}

// The weight maps of wpack at a streamed width: [trunk_rows, W] and the
// branch's [W + DD, W / 2] after it (null map_br: none); the scratch
// [ctas * 64, 2 W]. False if one cannot be encoded.
bool encode_stream_maps(CUtensorMap* map_w, CUtensorMap* map_br,
                        CUtensorMap* map_slab, const bf16* wpack,
                        int trunk_rows, int W, int DD, const bf16* slab,
                        int slab_ctas) {
  return encode_bf16_map(map_w, wpack, trunk_rows, W, W, 64) &&
         (map_br == nullptr ||
          encode_bf16_map(map_br, wpack + (size_t)trunk_rows * W, W + DD,
                          W / 2, W / 2, 64)) &&
         slab != nullptr && slab_ctas > 0 &&
         encode_bf16_map(map_slab, slab, slab_ctas * 64, 2 * W, 2 * W, 64);
}

}  // namespace
}  // namespace fsnerf
