// Fused NeRF ray march for Hopper (sm_90a): positional encoding, the NeRF
// MLP, exp/cumsum compositing and an exact per-(ray block x sample chunk)
// early exit, in one kernel.
//
// Replaces fsnerf_tpu/ops/pallas/render.py::_fused_render_call (the Pallas
// TPU kernel reached from make_fused_ray_renderer). Plain PyTorch twin:
// fsnerf_tpu_torch/ops/kernels/render.py::ray_march_reference, which follows
// the same block x chunk skip rule and counts the same executed steps.
//
// What bounds it on this card: the MLP. Each sample costs ~1.2 MFLOP of
// bf16 GEMMs (8x256 trunk, skip, heads) against 52 bytes of per-sample
// input, so the kernel is compute-bound by three orders of magnitude over
// HBM; every activation stays in shared memory. What the design does about
// it: one CTA of 8 warps owns a block of `block_rows` rays and loops over the
// sample chunks (the TPU's sequential grid axis); per chunk step it encodes
// block_rows*chunk_s <= 128 rows into shared memory as bf16 and runs every
// layer on the tensor cores (mma.sync m16n8k16 bf16, f32 accumulation),
// ping-ponging two [128 x width] bf16 activation buffers (132 KB at width
// 256 with row padding; ~202 KB in all, above the 48 KB default, hence the
// dynamic shared-memory attribute). Weights (1.3 MB bf16, L2-resident)
// stream through shared memory in double-buffered 64-row slabs, the next
// slab fetched while the tensor cores consume the current one. With one CTA
// of 8 warps per SM there is little to hide memory latency behind, so each
// chunk's sample inputs (x, t, delta, mask; ~3 KB, read once from HBM) are
// fetched by all threads in one batch of loads issued a chunk ahead, and
// everything after reads them from shared memory.
// A chunk is skipped — GEMMs and encoding included — unless some ray of the
// block is still below the transmittance cutoff (od < -log eps) AND some
// sample of the chunk is valid, which is where the depth-coherence sort of
// the caller pays. Measured, it reaches ~160 TFLOP/s: with one CTA per SM
// the synchronous MMAs and the loads, barriers and epilogues around them
// barely overlap. Asynchronous wgmma fed by TMA is work for a later change.
//
// Numerics, as the TPU kernel (render.py::_mlp_chunk): bf16 operands, f32
// accumulation, bias rounded to bf16 then added in f32, ReLU, round to bf16.
// The encoding uses the polynomial sin of fastmath.cuh (cos x = sin(x+pi/2))
// in the reference layout [x, sin f0 x, cos f0 x, ...], zero-padded. The
// GEMM, its epilogue and the encoding live in mlp_common.cuh, shared with
// the train kernels of mlp_train.cu; the MLP itself (nerf_mlp_rows) with the
// forward MLP of mlp.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"

namespace fsnerf {
namespace {

struct Args {
  const float* x;       // [R, K, 3] sample points
  const float* dirs;    // [R, 3] per-ray directions
  const float* t;       // [R, K]
  const float* deltas;  // [R, K]
  const float* mask;    // [R, K] 0/1
  const bf16* wpack;    // packed [in, out] weights, ops/kernels/render.py
  const float* bpack;   // packed biases (bf16-rounded values)
  const float* enc;     // [2*F + 2*Fv]: freq_x, mask_x, freq_d, mask_d
  float* stats;         // [R, 8]: rgb, opacity, depth, trans_final, 0, 0
  int* steps;           // [R / block_rows] executed chunk steps per block
  int K, block_rows, chunk_s, n_layers, skip_mask, width;
  int n_freqs, n_freqs_views, d_enc_pad, d_dir_pad, density_act;
  float thresh;         // -log(early_stop_eps)
};

// One chunk's sample inputs in flight: elements tid and tid + kThreads of
// the chunk's [rows, 3] points (rows = block_rows * chunk_s, ray-major), and
// t/delta/mask of row tid.
struct ChunkIn {
  float x0, x1, t, d, m;
};

__device__ __forceinline__ void chunk_fetch(ChunkIn& in, const Args& a,
                                            int ray0, int k0, int nrows) {
  const int tid = threadIdx.x, cs = a.chunk_s, xrow = 3 * a.chunk_s;
  if (tid < 3 * nrows) {
    const int r = tid / xrow;
    in.x0 = a.x[((size_t)(ray0 + r) * a.K + k0) * 3 + tid - r * xrow];
  }
  const int e = tid + kThreads;
  if (e < 3 * nrows) {
    const int r = e / xrow;
    in.x1 = a.x[((size_t)(ray0 + r) * a.K + k0) * 3 + e - r * xrow];
  }
  if (tid < nrows) {
    const int r = tid / cs;
    const size_t gi = (size_t)(ray0 + r) * a.K + k0 + tid - r * cs;
    in.t = a.t[gi];
    in.d = a.deltas[gi];
    in.m = a.mask[gi];
  }
}

// xs [rows, 3], ts/ds/ms [rows] in shared memory
__device__ __forceinline__ void chunk_store(const ChunkIn& in, float* xs,
                                            float* ts, float* ds, float* ms,
                                            int nrows) {
  const int tid = threadIdx.x;
  if (tid < 3 * nrows) xs[tid] = in.x0;
  if (tid + kThreads < 3 * nrows) xs[tid + kThreads] = in.x1;
  if (tid < nrows) {
    ts[tid] = in.t;
    ds[tid] = in.d;
    ms[tid] = in.m;
  }
}

__global__ void __launch_bounds__(kThreads, 1) ray_march_kernel(Args a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int W = a.width;
  const int DE = a.d_enc_pad, DD = a.d_dir_pad;
  // shared row strides, padded by 16 B so ldmatrix rows hit distinct banks
  const int LDH = W + kPad, LDE = DE + kPad, LDD = DD + kPad;
  bf16* buf0 = reinterpret_cast<bf16*>(smem_raw);
  bf16* buf1 = buf0 + kRows * LDH;
  bf16* encx = buf1 + kRows * LDH;
  bf16* encd = encx + kRows * LDE;
  bf16* slabs = encd + kRows * LDD;
  float* sig = reinterpret_cast<float*>(slabs + 2 * kSlabRows * kSlabLd);
  float* rgb = sig + kRows;
  float* od_acc = rgb + 3 * kRows;
  float* racc = od_acc + kRows;
  float* oacc = racc + 3 * kRows;
  float* dacc = oacc + kRows;
  float* xs = dacc + kRows;
  float* ts = xs + 3 * kRows;
  float* ds = ts + kRows;
  float* ms = ds + kRows;

  const int tid = threadIdx.x;
  const Mlp mlp = {a.wpack, a.bpack,     a.n_layers,  a.skip_mask,
                   a.width, a.d_enc_pad, a.d_dir_pad, a.density_act};
  const int bR = a.block_rows, cs = a.chunk_s, nrows = bR * cs;
  const int ray0 = blockIdx.x * bR;
  const int n_chunks = a.K / cs;
  const float* freq_x = a.enc;
  const float* mask_x = freq_x + a.n_freqs;
  const float* freq_d = mask_x + a.n_freqs;
  const float* mask_d = freq_d + a.n_freqs_views;

  if (tid < bR) {
    od_acc[tid] = oacc[tid] = dacc[tid] = 0.f;
    racc[3 * tid] = racc[3 * tid + 1] = racc[3 * tid + 2] = 0.f;
  }
  // rows past block_rows*chunk_s are never encoded: keep them zero
  for (int e = tid; e < (kRows - nrows) * LDE; e += kThreads)
    encx[nrows * LDE + e] = __float2bfloat16_rn(0.f);
  for (int e = tid; e < (kRows - nrows) * LDD; e += kThreads)
    encd[nrows * LDD + e] = __float2bfloat16_rn(0.f);
  // a ray's direction is the same for all its samples: encode it once
  for (int e = tid; e < nrows * DD; e += kThreads) {
    const int row = e / DD, col = e - row * DD;
    const float* v = a.dirs + (size_t)(ray0 + row / cs) * 3;
    encd[row * LDD + col] = __float2bfloat16_rn(
        encode_lane(v, col, a.n_freqs_views, freq_d, mask_d));
  }
  int executed = 0;
  ChunkIn in = {0.f, 0.f, 0.f, 0.f, 0.f};
  if (n_chunks > 0) chunk_fetch(in, a, ray0, 0, nrows);

  for (int c = 0; c < n_chunks; ++c) {
    const int k0 = c * cs;
    // exact early exit: skip unless a ray is alive and a sample is valid.
    // The first barrier also ends the previous step's reads of the staged
    // inputs; the second publishes this chunk's.
    const int alive = __syncthreads_or(tid < bR && od_acc[tid] < a.thresh);
    chunk_store(in, xs, ts, ds, ms, nrows);
    const int has_valid = __syncthreads_or(tid < nrows && in.m > 0.f);
    if (c + 1 < n_chunks) chunk_fetch(in, a, ray0, k0 + cs, nrows);
    if (!(alive && has_valid)) continue;
    ++executed;

    for (int e = tid; e < nrows * DE; e += kThreads) {
      const int row = e / DE, col = e - row * DE;
      encx[row * LDE + col] = __float2bfloat16_rn(
          encode_lane(xs + 3 * row, col, a.n_freqs, freq_x, mask_x));
    }
    __syncthreads();

    nerf_mlp_rows(mlp, encx, LDE, encd, LDD, buf0, buf1, slabs, nrows, sig,
                  rgb);

    // composite: per-ray serial scan over the chunk, od carried across chunks
    if (tid < bR) {
      const float acc = od_acc[tid];
      float cum = 0.f, r0 = 0.f, r1 = 0.f, r2 = 0.f, op = 0.f, dp = 0.f;
      for (int s = 0; s < cs; ++s) {
        const int row = tid * cs + s;
        const float od = __fmul_rn(__fmul_rn(sig[row], ds[row]), ms[row]);
        cum = __fadd_rn(cum, od);
        const float trans = expf(-__fsub_rn(__fadd_rn(acc, cum), od));
        const float wgt = __fmul_rn(trans, __fsub_rn(1.f, expf(-od)));
        r0 += wgt * rgb[3 * row];
        r1 += wgt * rgb[3 * row + 1];
        r2 += wgt * rgb[3 * row + 2];
        op += wgt;
        dp += wgt * ts[row];
      }
      racc[3 * tid] += r0;
      racc[3 * tid + 1] += r1;
      racc[3 * tid + 2] += r2;
      oacc[tid] += op;
      dacc[tid] += dp;
      od_acc[tid] = acc + cum;
    }
  }
  __syncthreads();
  if (tid < bR) {
    float* out = a.stats + (size_t)(ray0 + tid) * 8;
    out[0] = racc[3 * tid];
    out[1] = racc[3 * tid + 1];
    out[2] = racc[3 * tid + 2];
    out[3] = oacc[tid];
    out[4] = dacc[tid];
    out[5] = expf(-od_acc[tid]);
    out[6] = 0.f;
    out[7] = 0.f;
  }
  if (tid == 0) a.steps[blockIdx.x] = executed;
}

size_t smem_bytes(int width, int d_enc_pad, int d_dir_pad) {
  return sizeof(bf16) * ((size_t)kRows * (2 * width + d_enc_pad + d_dir_pad +
                                          4 * kPad) +
                         2 * kSlabRows * kSlabLd) +
         sizeof(float) * 16 * kRows;
}

}  // namespace
}  // namespace fsnerf

// Plain C entry for ctypes. Pointers are device pointers of contiguous
// tensors validated by the Python wrapper; launches on `stream` and returns
// cudaGetLastError() (0 = launched).
extern "C" int fsnerf_ray_march(
    const void* x, const void* dirs, const void* t, const void* deltas,
    const void* mask, const void* wpack, const void* bpack, const void* enc,
    void* stats, void* steps, int n_rays, int K, int block_rows, int chunk_s,
    int n_layers, int skip_mask, int width, int n_freqs, int n_freqs_views,
    int d_enc_pad, int d_dir_pad, int density_act, float thresh,
    void* stream) {
  using namespace fsnerf;
  Args a;
  a.x = static_cast<const float*>(x);
  a.dirs = static_cast<const float*>(dirs);
  a.t = static_cast<const float*>(t);
  a.deltas = static_cast<const float*>(deltas);
  a.mask = static_cast<const float*>(mask);
  a.wpack = static_cast<const bf16*>(wpack);
  a.bpack = static_cast<const float*>(bpack);
  a.enc = static_cast<const float*>(enc);
  a.stats = static_cast<float*>(stats);
  a.steps = static_cast<int*>(steps);
  a.K = K;
  a.block_rows = block_rows;
  a.chunk_s = chunk_s;
  a.n_layers = n_layers;
  a.skip_mask = skip_mask;
  a.width = width;
  a.n_freqs = n_freqs;
  a.n_freqs_views = n_freqs_views;
  a.d_enc_pad = d_enc_pad;
  a.d_dir_pad = d_dir_pad;
  a.density_act = density_act;
  a.thresh = thresh;
  const size_t smem = smem_bytes(width, d_enc_pad, d_dir_pad);
  cudaError_t err = cudaFuncSetAttribute(
      ray_march_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = n_rays / block_rows;
  if (n_blocks > 0)
    ray_march_kernel<<<n_blocks, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fsnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
