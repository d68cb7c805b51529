// Forward NeRF MLP on pre-encoded features for Hopper (sm_90a): the 8x256
// trunk with its skip, the sigma head, the connection, the view branch and
// the rgb head, one 128-row tile per CTA; and its density pass (trunk and
// sigma head only, nerf_density_kernel at the end of this file).
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
// activation buffers ping-ponged). The MLP itself is nerf_mlp_rows, the
// same code the ray march of render.cu runs per chunk; ~196 KB of shared
// memory at width 256, so one CTA per SM. Asynchronous wgmma fed by TMA,
// and two CTAs per SM, are work for a later change.
//
// Numerics, as the TPU kernel (mlp.py::_kernel_body): see nerf_mlp_rows.
// The encodings arrive already rounded to bf16 (exact f32 sin/cos and the
// FreeNeRF band mask applied by the caller), unlike the ray march, which
// encodes inside with a polynomial sin.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"

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
// fsnerf_tpu_torch/ops/kernels/mlp.py::nerf_density_reference. Same tile,
// GEMM core and numerics as nerf_mlp_kernel through nerf_trunk_sigma; the
// sigma head writes each row's sigma straight to device memory. A row costs
// ~0.98 MFLOP at 8x256 against 132 bytes of HBM traffic, so it is
// compute-bound like nerf_mlp_kernel.
struct DensityArgs {
  const bf16* encx;   // [N, d_enc_pad] positional encodings
  Mlp mlp;
  float* out;         // [N] sigma
  int N;
};

__global__ void __launch_bounds__(kThreads, 1)
    nerf_density_kernel(DensityArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int DE = a.mlp.d_enc_pad;
  const int LDH = a.mlp.width + kPad, LDE = DE + kPad;
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf1 = buf0 + kRows * LDH;
  bf16* encx = buf1 + kRows * LDH;
  bf16* slabs = encx + kRows * LDE;

  const int r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, a.N - r0);
  stage_rows(a.encx, DE, encx, LDE, r0, nrows);
  __syncthreads();
  const bf16* w = a.mlp.wpack;
  const float* b = a.mlp.bpack;
  nerf_trunk_sigma(a.mlp, encx, LDE, buf0, buf1, slabs, nrows, a.out + r0, w,
                   b);
}

size_t density_smem_bytes(int width, int d_enc_pad) {
  return sizeof(bf16) * ((size_t)kRows * (2 * width + d_enc_pad + 3 * kPad) +
                         2 * kSlabRows * kSlabLd);
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
// weights, walked only through the sigma head.
extern "C" int fsnerf_nerf_density(const void* encx, const void* wpack,
                                   const void* bpack, void* out, int n_rows,
                                   int n_layers, int skip_mask, int width,
                                   int d_enc_pad, int density_act,
                                   void* stream) {
  using namespace fsnerf;
  DensityArgs a;
  a.encx = static_cast<const bf16*>(encx);
  a.mlp = Mlp{static_cast<const bf16*>(wpack),
              static_cast<const float*>(bpack),
              n_layers,
              skip_mask,
              width,
              d_enc_pad,
              0,
              density_act};
  a.out = static_cast<float*>(out);
  a.N = n_rows;
  const size_t smem = density_smem_bytes(width, d_enc_pad);
  cudaError_t err = cudaFuncSetAttribute(
      nerf_density_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (n_rows + kRows - 1) / kRows;
  if (n_blocks > 0)
    nerf_density_kernel<<<n_blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
