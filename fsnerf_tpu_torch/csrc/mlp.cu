// Forward NeRF MLP on pre-encoded features for Hopper (sm_90a): the 8x256
// trunk with its skip, the sigma head, the connection, the view branch and
// the rgb head, one 128-row tile per CTA; and its density pass (trunk and
// sigma head only, nerf_density_kernel at the end of this file, on the
// warp-specialized trunk of ws_trunk.cuh).
//
// Replaces fsnerf_tpu/ops/pallas/mlp.py::_fused_call (the Pallas TPU kernel
// reached from fused_nerf_mlp / make_fused_model_fn). Plain PyTorch twin:
// fsnerf_tpu_torch/ops/kernels/mlp.py::nerf_mlp_reference.
//
// What bounds it on this card: the GEMMs. A row costs ~1.19 MFLOP of bf16
// products at 8x256 against 208 bytes of HBM traffic (a 64-column and a
// 32-column bf16 encoding in, four floats out), so the kernel is
// compute-bound by three orders of magnitude. What the design does about
// it: every activation stays in shared memory. A CTA of 8 warps stages its
// 128 encoded rows once (16-byte loads, rows past N zero-filled and never
// written back), then runs every layer on the tensor cores through the GEMM
// core of mlp_common.cuh (mma.sync m16n8k16 bf16, f32 accumulation, weights
// streamed from L2 in double-buffered 64-row slabs, two [128 x width] bf16
// activation buffers ping-ponged). The MLP itself is nerf_mlp_rows; ~196
// KB of shared memory at width 256, so one CTA per SM. Asynchronous wgmma fed by TMA,
// and two CTAs per SM, are work for a later change.
//
// Numerics, as the TPU kernel (mlp.py::_kernel_body): see nerf_mlp_rows.
// The encodings arrive already rounded to bf16 (exact f32 sin/cos and the
// FreeNeRF band mask applied by the caller), unlike the ray march and the
// train forward, which encode inside with a polynomial sin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"
#include "ws_trunk.cuh"

namespace fsnerf {
namespace {

struct MlpArgs {
  const bf16* encx;   // [N, d_enc_pad] positional encodings
  const bf16* encd;   // [N, d_dir_pad] view-direction encodings
  Mlp mlp;
  float* out;         // [N, 4]: rgb, sigma
  int N;
};

// src rows r0 .. r0+nrows-1 ([*, D] bf16, D a multiple of 8) into dst
// [kRows, ld] in shared memory; the tile's rows past nrows become zero.
__device__ __forceinline__ void stage_rows(const bf16* src, int D, bf16* dst,
                                           int ld, int r0, int nrows) {
  const int per_row = D / 8;
  for (int e = threadIdx.x; e < kRows * per_row; e += kThreads) {
    const int row = e / per_row, c8 = (e - row * per_row) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + row) * D + c8);
    *reinterpret_cast<uint4*>(dst + row * ld + c8) = v;
  }
}

__global__ void __launch_bounds__(kThreads, 1) nerf_mlp_kernel(MlpArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DE = a.mlp.d_enc_pad, DD = a.mlp.d_dir_pad;
  const int LDH = a.mlp.width + kPad, LDE = DE + kPad, LDD = DD + kPad;
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf1 = buf0 + kRows * LDH;
  bf16* encx = buf1 + kRows * LDH;
  bf16* encd = encx + kRows * LDE;
  bf16* slabs = encd + kRows * LDD;
  float* sig = reinterpret_cast<float*>(slabs + 2 * kSlabRows * kSlabLd);
  float* rgb = sig + kRows;

  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, a.N - r0);
  stage_rows(a.encx, DE, encx, LDE, r0, nrows);
  stage_rows(a.encd, DD, encd, LDD, r0, nrows);
  __syncthreads();
  nerf_mlp_rows(a.mlp, encx, LDE, encd, LDD, buf0, buf1, slabs, nrows, sig,
                rgb);
  for (int row = threadIdx.x; row < nrows; row += kThreads)
    reinterpret_cast<float4*>(a.out)[r0 + row] =
        make_float4(rgb[3 * row], rgb[3 * row + 1], rgb[3 * row + 2],
                    sig[row]);
}

size_t mlp_smem_bytes(int width, int d_enc_pad, int d_dir_pad) {
  return sizeof(bf16) * ((size_t)kRows * (2 * width + d_enc_pad + d_dir_pad +
                                          4 * kPad) +
                         2 * kSlabRows * kSlabLd) +
         sizeof(float) * 4 * kRows;
}

// The density pass: trunk and sigma head only (no connection, branch or rgb
// head, no view input), the occupancy grid refresh's workload. Replaces
// fsnerf_tpu/ops/pallas/mlp.py::_density_call (reached from fused_density /
// make_fused_density_fn). Plain PyTorch twin:
// fsnerf_tpu_torch/ops/kernels/mlp.py::nerf_density_reference.
//
// What bounds it on this card: the trunk's GEMMs. A row costs ~0.98 MFLOP
// at 8x256 against 132 bytes of HBM traffic (a 64-column bf16 encoding in,
// one float out), so it is compute-bound by three orders of magnitude.
// What the design does about it: the warp-specialized trunk of
// ws_trunk.cuh (a producer warpgroup feeding 64-row weight tiles by TMA
// through an mbarrier ring, two consumer warpgroups of 64 rows on wgmma).
// The encoding is loaded, not computed: each consumer's lead thread loads
// its 64 rows of the caller's bf16 encoding by TMA (boxes of 64 rows x 64
// columns, 128B-swizzled: the tile layout the trunk reads; rows past N
// zero-filled), the producer feeds only the trunk's matrices, and the last
// trunk epilogue's quad-reduced sigma dot, plus the bf16-rounded bias and
// the activation, goes straight to out[N]. Numerics: the trunk's and
// sigma head's of ws_trunk.cuh; sigma raw, ReLU or exp(clip(., -15, 15)).
struct DensityArgs {
  const bf16* wpack;
  const float* bpack;
  float* out;         // [N] sigma
  int N, n_layers, skip_mask, d_enc_pad, density_act;
};

template <int W>
__global__ void __launch_bounds__(kFwdThreads, 1)
    nerf_density_kernel(const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_x,
                        DensityArgs a, int n_stages) {
  extern __shared__ unsigned char density_smem_raw[];
  unsigned char* ring = density_smem_raw +
                        ((1024 - (smem_u32(density_smem_raw) & 1023)) & 1023);
  const int nbx = enc_blocks(a.d_enc_pad);
  unsigned char* act = ring + n_stages * W * 128;
  unsigned char* encx = act + kFwdConsumers * W * 128;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(encx + kFwdConsumers * nbx * kBlock);
  uint64_t* empty = full + n_stages;
  uint64_t* loaded = empty + n_stages;           // each consumer's encx
  fwd_init_barriers(full, empty, n_stages, loaded, kFwdConsumers);
  __syncthreads();
  const FwdShape sh{a.n_layers, a.skip_mask, a.d_enc_pad, 0};
  const int wg = threadIdx.x / 128;
  if (wg == kFwdConsumers) {                       // the producer
    setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == 128 * kFwdConsumers) {
      int it = 0;
      produce_pass<W, 64>(&map_w, nullptr, sh, false, ring, full, empty,
                          n_stages, it, nullptr);
    }
    return;
  }
  setmaxnreg_inc<kFwdConsumerRegs>();
  const int t = threadIdx.x & 127, lane = t & 31;
  const int row0 = blockIdx.x * kRows + 64 * wg;
  unsigned char* tile = encx + wg * nbx * kBlock;
  FwdRing r{smem_u32(ring), W * 128, full, empty, n_stages, 0, t == 0};
  if (r.lead) {
    mbar_arrive_expect_tx(&loaded[wg], nbx * kBlock);
    for (int q = 0; q < nbx; ++q)
      tma_load_2d(tile + q * kBlock, &map_x, &loaded[wg], 64 * q, row0);
  }
  mbar_wait(&loaded[wg], 0);
  const int rows = trunk_rows_of(a.n_layers, a.skip_mask, W, a.d_enc_pad);
  const bf16* w_sigma = a.wpack + (size_t)rows * W;
  float sig[2] = {0.f, 0.f};
  float acc[W / 2];
  fwd_trunk<W>(acc, r, act + wg * W * 128, smem_u32(tile), sh, a.bpack,
               w_sigma, sig, 1 + wg, nullptr, row0);
  const float b_sigma = a.bpack[a.n_layers * W];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float v =
        density_activate(quad_sum(sig[h]) + b_sigma, a.density_act);
    const int g = row0 + 16 * (t >> 5) + (lane >> 2) + 8 * h;
    if ((lane & 3) == 0 && g < a.N) a.out[g] = v;
  }
}

template <int W>
cudaError_t launch_density_w(const DensityArgs& a, const bf16* encx,
                             int trunk_rows, cudaStream_t st) {
  CUtensorMap map_w, map_x;
  if (!encode_weight_maps<W>(&map_w, nullptr, a.wpack, trunk_rows, 0) ||
      !encode_bf16_map(&map_x, encx, a.N, a.d_enc_pad, a.d_enc_pad, 64))
    return cudaErrorInvalidValue;
  const size_t extra = kFwdConsumers * sizeof(uint64_t);
  // no encd tiles: the dir width 0 leaves them out
  const int n_stages = fwd_stages(W, a.d_enc_pad, 0, extra);
  const size_t smem = fwd_smem_bytes(W, a.d_enc_pad, 0, n_stages) + extra;
  cudaError_t err = cudaFuncSetAttribute(
      nerf_density_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  nerf_density_kernel<W><<<(a.N + kRows - 1) / kRows, kFwdThreads, smem,
                           st>>>(map_w, map_x, a, n_stages);
  return cudaGetLastError();
}

}  // namespace
}  // namespace fsnerf

// Plain C entry for ctypes. Pointers are device pointers of contiguous
// tensors validated by the Python wrapper (ops/kernels/mlp.py::nerf_mlp);
// launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fsnerf_nerf_mlp(const void* encx, const void* encd,
                               const void* wpack, const void* bpack,
                               void* out, int n_rows, int n_layers,
                               int skip_mask, int width, int d_enc_pad,
                               int d_dir_pad, int density_act, void* stream) {
  using namespace fsnerf;
  MlpArgs a;
  a.encx = static_cast<const bf16*>(encx);
  a.encd = static_cast<const bf16*>(encd);
  a.mlp = Mlp{static_cast<const bf16*>(wpack),
              static_cast<const float*>(bpack),
              n_layers,
              skip_mask,
              width,
              d_enc_pad,
              d_dir_pad,
              density_act};
  a.out = static_cast<float*>(out);
  a.N = n_rows;
  const size_t smem = mlp_smem_bytes(width, d_enc_pad, d_dir_pad);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_mlp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (n_rows + kRows - 1) / kRows;
  if (n_blocks > 0)
    nerf_mlp_kernel<<<n_blocks, kThreads, smem,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The density pass (ops/kernels/mlp.py::nerf_density): the same packed
// weights, walked only through the sigma head. Takes width 64, 128 or 256
// and d_enc_pad a multiple of 64 up to 128; trunk_rows must be the rows of
// wpack's [rows, width] view (the trunk, w_sigma and w_conn:
// mlp_train.py::TrainLayout.wpack_views). Returns cudaErrorInvalidValue
// for anything else.
extern "C" int fsnerf_nerf_density(const void* encx, const void* wpack,
                                   const void* bpack, void* out, int n_rows,
                                   int n_layers, int skip_mask, int width,
                                   int d_enc_pad, int density_act,
                                   int trunk_rows, void* stream) {
  using namespace fsnerf;
  DensityArgs a{static_cast<const bf16*>(wpack),
                static_cast<const float*>(bpack),
                static_cast<float*>(out),
                n_rows,
                n_layers,
                skip_mask,
                d_enc_pad,
                density_act};
  if (d_enc_pad % 64 || d_enc_pad > 128 ||
      trunk_rows !=
          trunk_rows_of(n_layers, skip_mask, width, d_enc_pad) + 1 + width)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return static_cast<int>(cudaGetLastError());
  const bf16* x = static_cast<const bf16*>(encx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64:
      return static_cast<int>(launch_density_w<64>(a, x, trunk_rows, st));
    case 128:
      return static_cast<int>(launch_density_w<128>(a, x, trunk_rows, st));
    case 256:
      return static_cast<int>(launch_density_w<256>(a, x, trunk_rows, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
