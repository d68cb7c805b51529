// Fused ray marches for Hopper (sm_90a): an MLP, exp/cumsum compositing and
// an exact per-(ray block x sample chunk) early exit, in one kernel. One
// shell (ray_march_kernel) runs either MLP:
//   NerfMarch:  positional encoding + the NeRF MLP. Replaces
//     fsnerf_tpu/ops/pallas/render.py::_fused_render_call (kernel 1).
//   SirenMarch: the raw points and directions as bf16 (no encoding) + the
//     SiNeRF MLP of siren_common.cuh. Replaces
//     fsnerf_tpu/ops/pallas/render.py::_fused_render_call_siren (kernel 2).
// Plain PyTorch twins: fsnerf_tpu_torch/ops/kernels/render.py::
// ray_march_reference / siren_ray_march_reference, which follow the same
// block x chunk skip rule and count the same executed steps.
//
// What bounds them on this card: the MLP. Each sample costs ~1.2 MFLOP of
// bf16 GEMMs (8x256 trunk and heads; the SIREN adds ~2,300 polynomial sines
// on the FP32 pipe) against 52 bytes of per-sample input, so the kernels are
// compute-bound by three orders of magnitude over HBM; every activation
// stays in shared memory. What the design does about it: one CTA of 8 warps
// owns a block of `block_rows` rays and loops over the sample chunks (the
// TPU's sequential grid axis); per chunk step it stages block_rows*chunk_s
// <= 128 rows into shared memory as bf16 (encoded for NeRF, raw for SIREN)
// and runs every layer on the tensor cores (mma.sync m16n8k16 bf16, f32
// accumulation), ping-ponging two [128 x width] bf16 activation buffers
// (132 KB at width 256 with row padding; ~190-202 KB in all, above the 48
// KB default, hence the dynamic shared-memory attribute). Weights (1.3 MB
// bf16, L2-resident) stream through shared memory in double-buffered 64-row
// slabs, the next slab fetched while the tensor cores consume the current
// one. With one CTA of 8 warps per SM there is little to hide memory latency
// behind, so each chunk's sample inputs (x, t, delta, mask; ~3 KB, read once
// from HBM) are fetched by all threads in one batch of loads issued a chunk
// ahead, and everything after reads them from shared memory.
// A chunk is skipped — GEMMs and staging included — unless some ray of the
// block is still below the transmittance cutoff (od < -log eps) AND some
// sample of the chunk is valid, which is where the depth-coherence sort of
// the caller pays. Measured, the NeRF march reaches ~160 TFLOP/s: with one
// CTA per SM the synchronous MMAs and the loads, barriers and epilogues
// around them barely overlap. Asynchronous wgmma fed by TMA is work for a
// later change.
//
// Numerics of the NeRF march, as the TPU kernel (render.py::_mlp_chunk):
// bf16 operands, f32 accumulation, bias rounded to bf16 then added in f32,
// ReLU, round to bf16. The encoding uses the polynomial sin of fastmath.cuh
// (cos x = sin(x+pi/2)) in the reference layout [x, sin f0 x, cos f0 x,
// ...], zero-padded. The GEMM, its epilogue and the encoding live in
// mlp_common.cuh, shared with the train kernels of mlp_train.cu; the MLP
// itself (nerf_mlp_rows) with the forward MLP of mlp.cu. The SIREN march's
// numerics are siren_common.cuh's, shared with the train kernels of
// siren.cu; sigma is the SiNeRF's ReLU head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"
#include "siren_common.cuh"

namespace fsnerf {
namespace {

// The shell's inputs and outputs.
struct Args {
  const float* x;       // [R, K, 3] sample points
  const float* dirs;    // [R, 3] per-ray directions
  const float* t;       // [R, K]
  const float* deltas;  // [R, K]
  const float* mask;    // [R, K] 0/1
  float* stats;         // [R, 8]: rgb, opacity, depth, trans_final, 0, 0
  int* steps;           // [R / block_rows] executed chunk steps per block
  int K, block_rows, chunk_s;
  float thresh;         // -log(early_stop_eps)
};

// The NeRF MLP of the march (kernel 1): encodes the rays' directions once
// and each chunk's points, then runs nerf_mlp_rows. Shared memory: two
// activation buffers, the two encodings, the weight slabs.
struct NerfMarch {
  struct Params {
    Mlp mlp;
    const float* enc;   // [2*F + 2*Fv]: freq_x, mask_x, freq_d, mask_d
    int n_freqs, n_freqs_views;
  };
  Params p;
  bf16 *buf0, *buf1, *encx, *encd, *slabs;
  int LDE, LDD;

  __host__ __device__ static size_t smem_bytes(const Params& p) {
    return sizeof(bf16) *
           ((size_t)kRows * (2 * p.mlp.width + p.mlp.d_enc_pad +
                             p.mlp.d_dir_pad + 4 * kPad) +
            2 * kSlabRows * kSlabLd);
  }

  __device__ NerfMarch(unsigned char* smem, const Params& params)
      : p(params) {
    const int LDH = p.mlp.width + kPad;
    LDE = p.mlp.d_enc_pad + kPad;
    LDD = p.mlp.d_dir_pad + kPad;
    buf0 = reinterpret_cast<bf16*>(smem);
    buf1 = buf0 + kRows * LDH;
    encx = buf1 + kRows * LDH;
    encd = encx + kRows * LDE;
    slabs = encd + kRows * LDD;
  }

  // rows past nrows are never encoded: keep them zero; a ray's direction is
  // the same for all its samples: encode it once
  __device__ void begin(const float* dirs, int ray0, int nrows, int cs) {
    const int tid = threadIdx.x, DD = p.mlp.d_dir_pad;
    const float* freq_d = p.enc + 2 * p.n_freqs;
    const float* mask_d = freq_d + p.n_freqs_views;
    for (int e = tid; e < (kRows - nrows) * LDE; e += kThreads)
      encx[nrows * LDE + e] = __float2bfloat16_rn(0.f);
    for (int e = tid; e < (kRows - nrows) * LDD; e += kThreads)
      encd[nrows * LDD + e] = __float2bfloat16_rn(0.f);
    for (int e = tid; e < nrows * DD; e += kThreads) {
      const int row = e / DD, col = e - row * DD;
      const float* v = dirs + (size_t)(ray0 + row / cs) * 3;
      encd[row * LDD + col] = __float2bfloat16_rn(
          encode_lane(v, col, p.n_freqs_views, freq_d, mask_d));
    }
  }

  // this chunk's points xs [nrows, 3] (shared) into the MLP's input
  __device__ void stage(const float* xs, int nrows) {
    const int DE = p.mlp.d_enc_pad;
    const float* freq_x = p.enc;
    const float* mask_x = freq_x + p.n_freqs;
    for (int e = threadIdx.x; e < nrows * DE; e += kThreads) {
      const int row = e / DE, col = e - row * DE;
      encx[row * LDE + col] = __float2bfloat16_rn(
          encode_lane(xs + 3 * row, col, p.n_freqs, freq_x, mask_x));
    }
  }

  __device__ void run(int nrows, float* sig, float* rgb) {
    nerf_mlp_rows(p.mlp, encx, LDE, encd, LDD, buf0, buf1, slabs, nrows, sig,
                  rgb);
  }
};

// The SiNeRF MLP of the march (kernel 2): the rays' directions and each
// chunk's points staged as bf16, zero-padded to 16 columns, then
// siren_mlp_rows. Shared memory: two activation buffers, the two staged
// inputs, the weight slabs.
struct SirenMarch {
  struct Params {
    Siren mlp;
  };
  Params p;
  bf16 *buf0, *buf1, *xin, *din, *slabs;

  __host__ __device__ static size_t smem_bytes(const Params& p) {
    return sizeof(bf16) * ((size_t)kRows * (2 * (p.mlp.width + kPad) +
                                            2 * kLdIn) +
                           2 * kSlabRows * kSlabLd);
  }

  __device__ SirenMarch(unsigned char* smem, const Params& params)
      : p(params) {
    const int LDH = p.mlp.width + kPad;
    buf0 = reinterpret_cast<bf16*>(smem);
    buf1 = buf0 + kRows * LDH;
    xin = buf1 + kRows * LDH;
    din = xin + kRows * kLdIn;
    slabs = din + kRows * kLdIn;
  }

  // zero both inputs (stage writes only columns 0..2 of rows < nrows), then
  // each row's ray direction
  __device__ void begin(const float* dirs, int ray0, int nrows, int cs) {
    for (int e = threadIdx.x; e < 2 * kRows * kLdIn; e += kThreads)
      xin[e] = __float2bfloat16_rn(0.f);     // xin and din are contiguous
    __syncthreads();
    for (int e = threadIdx.x; e < nrows * 3; e += kThreads) {
      const int row = e / 3, col = e - row * 3;
      din[row * kLdIn + col] =
          __float2bfloat16_rn(dirs[(size_t)(ray0 + row / cs) * 3 + col]);
    }
  }

  __device__ void stage(const float* xs, int nrows) {
    for (int e = threadIdx.x; e < nrows * 3; e += kThreads) {
      const int row = e / 3, col = e - row * 3;
      xin[row * kLdIn + col] = __float2bfloat16_rn(xs[e]);
    }
  }

  __device__ void run(int nrows, float* sig, float* rgb) {
    siren_mlp_rows(p.mlp, xin, din, buf0, buf1, slabs, nrows, sig, rgb,
                   nullptr, 0, false);
  }
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

template <class March>
__global__ void __launch_bounds__(kThreads, 1)
    ray_march_kernel(Args a, typename March::Params mp) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  March mlp(smem_raw, mp);
  float* sig = reinterpret_cast<float*>(smem_raw + March::smem_bytes(mp));
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
  const int bR = a.block_rows, cs = a.chunk_s, nrows = bR * cs;
  const int ray0 = blockIdx.x * bR;
  const int n_chunks = a.K / cs;

  if (tid < bR) {
    od_acc[tid] = oacc[tid] = dacc[tid] = 0.f;
    racc[3 * tid] = racc[3 * tid + 1] = racc[3 * tid + 2] = 0.f;
  }
  mlp.begin(a.dirs, ray0, nrows, cs);
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

    mlp.stage(xs, nrows);
    __syncthreads();

    mlp.run(nrows, sig, rgb);

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

// The shell's f32 arrays after the MLP's shared memory.
template <class March>
size_t march_smem_bytes(const typename March::Params& mp) {
  return March::smem_bytes(mp) + sizeof(float) * 16 * kRows;
}

template <class March>
int launch_march(const Args& a, const typename March::Params& mp, int n_rays,
                 void* stream) {
  const size_t smem = march_smem_bytes<March>(mp);
  cudaError_t err = cudaFuncSetAttribute(
      ray_march_kernel<March>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = n_rays / a.block_rows;
  if (n_blocks > 0)
    ray_march_kernel<March><<<n_blocks, kThreads, smem,
                              static_cast<cudaStream_t>(stream)>>>(a, mp);
  return static_cast<int>(cudaGetLastError());
}

void fill_args(Args& a, const void* x, const void* dirs, const void* t,
               const void* deltas, const void* mask, void* stats, void* steps,
               int K, int block_rows, int chunk_s, float thresh) {
  a.x = static_cast<const float*>(x);
  a.dirs = static_cast<const float*>(dirs);
  a.t = static_cast<const float*>(t);
  a.deltas = static_cast<const float*>(deltas);
  a.mask = static_cast<const float*>(mask);
  a.stats = static_cast<float*>(stats);
  a.steps = static_cast<int*>(steps);
  a.K = K;
  a.block_rows = block_rows;
  a.chunk_s = chunk_s;
  a.thresh = thresh;
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
  fill_args(a, x, dirs, t, deltas, mask, stats, steps, K, block_rows, chunk_s,
            thresh);
  NerfMarch::Params mp;
  mp.mlp = Mlp{static_cast<const bf16*>(wpack),
               static_cast<const float*>(bpack),
               n_layers,
               skip_mask,
               width,
               d_enc_pad,
               d_dir_pad,
               density_act};
  mp.enc = static_cast<const float*>(enc);
  mp.n_freqs = n_freqs;
  mp.n_freqs_views = n_freqs_views;
  return launch_march<NerfMarch>(a, mp, n_rays, stream);
}

// The SIREN march: wpack / bpack / alphas as ops/kernels/siren.py packs
// them; the rest as fsnerf_ray_march.
extern "C" int fsnerf_siren_ray_march(
    const void* x, const void* dirs, const void* t, const void* deltas,
    const void* mask, const void* wpack, const void* bpack,
    const void* alphas, void* stats, void* steps, int n_rays, int K,
    int block_rows, int chunk_s, int n_layers, int width, float thresh,
    void* stream) {
  using namespace fsnerf;
  Args a;
  fill_args(a, x, dirs, t, deltas, mask, stats, steps, K, block_rows, chunk_s,
            thresh);
  SirenMarch::Params mp;
  mp.mlp = Siren{static_cast<const bf16*>(wpack),
                 static_cast<const float*>(bpack),
                 static_cast<const float*>(alphas), n_layers, width};
  return launch_march<SirenMarch>(a, mp, n_rays, stream);
}

extern "C" const char* fsnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
