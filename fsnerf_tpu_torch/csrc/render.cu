// Fused ray marches for Hopper (sm_90a): an MLP, exp/cumsum compositing and
// an exact per-(ray block x sample chunk) early exit, in one kernel each:
//   nerf_march_kernel: positional encoding + the NeRF MLP on the
//     warp-specialized trunk of ws_trunk.cuh. Replaces
//     fsnerf_tpu/ops/pallas/render.py::_fused_render_call (kernel 1).
//   siren_march_kernel (widths 64, 128, 192, 256, 384, 512;
//     siren_march_kernel_stream at the streamed widths;
//     ray_march_kernel<SirenMarch> at 288 and 320): the raw points and
//     directions as bf16 (no encoding) + the SiNeRF MLP of
//     siren_common.cuh. Replaces
//     fsnerf_tpu/ops/pallas/render.py::_fused_render_call_siren (kernel 2).
// Plain PyTorch twins: fsnerf_tpu_torch/ops/kernels/render.py::
// ray_march_reference / siren_ray_march_reference, which follow the same
// block x chunk skip rule and count the same executed steps.
//
// What bounds them on this card: the MLP. Each sample costs ~1.2 MFLOP of
// bf16 GEMMs (8x256 trunk and heads; the SIREN adds ~2,300 polynomial sines
// on the FP32 pipe) against 52 bytes of per-sample input, so the kernels are
// compute-bound by three orders of magnitude over HBM; every activation
// stays in shared memory. Both own a block of `block_rows` rays per CTA and
// loop over the sample chunks (the TPU's sequential grid axis), a chunk
// step being block_rows * chunk_s <= 128 rows. A chunk is skipped, GEMMs
// and staging included, unless some ray of the block is still below the
// transmittance cutoff (od < -log eps) AND some sample of the chunk is
// valid, which is where the depth-coherence sort of the caller pays.
//
// The NeRF march (nerf_march_kernel, below) runs each chunk step on two
// consumer warpgroups of 64 rows (wgmma, A from shared memory) fed by a
// producer warpgroup's TMA weight ring; see the notes above it. At the packed
// widths 384 and 512 one consumer runs the step's two 64-row halves in turn
// on the column-split trunk (march_consume_split), at the streamed widths
// (768 and every multiple of 256 up) on the streamed trunk
// (nerf_march_kernel_stream), with the same skip decision per block x chunk
// step. The SIREN march at widths 64, 128, 192 and 256 (siren_march_kernel)
// is the same shell around the SIREN forward's warp-specialized MLP, at 384
// and 512 the split shell around its column-split MLP
// (siren_march_consume_split), and at the streamed widths the streamed shell
// around its streamed MLP (siren_march_kernel_stream). At 288 and 320, which
// no packer lays out any more, the SIREN march's shell (ray_march_kernel) is
// one CTA of 8 warps: per chunk step it stages the rows into shared memory as
// bf16 and runs every layer on mma.sync m16n8k16 (bf16, f32 accumulation),
// ping-ponging two [128 x width] bf16 activation buffers, the weights
// (L2-resident) streaming through shared memory in double-buffered 64-row
// slabs; each chunk's sample inputs (x, t, delta, mask; ~3 KB, read once from
// HBM) are fetched by all threads in one batch of loads issued a chunk ahead.
// Measured, that shell reached ~160 TFLOP/s: with one CTA per SM the
// synchronous MMAs and the loads, barriers and epilogues around them barely
// overlap.
//
// Numerics of the NeRF march, as the TPU kernel (render.py::_mlp_chunk):
// bf16 operands, f32 accumulation, bias rounded to bf16 then added in f32,
// ReLU, round to bf16; sigma raw, ReLU or exp(clip(., -15, 15)). The
// encoding uses the polynomial sin of fastmath.cuh (cos x = sin(x+pi/2)) in
// the reference layout [x, sin f0 x, cos f0 x, ...], zero-padded, as the
// train forward's. The SIREN march's numerics are siren_common.cuh's,
// shared with the train kernels of siren.cu; sigma is the SiNeRF's ReLU
// head. Both composite in the same f32 order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mlp_common.cuh"
#include "siren_common.cuh"
#include "ws_trunk.cuh"

namespace fsnerf {
namespace {

// A march's inputs and outputs.
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

// ---- the NeRF march (nerf_march_kernel) --------------------------------
//
// The warp-specialized MLP of ws_trunk.cuh looped over the sample chunks of
// one block of rays: a producer warpgroup streams the weights by TMA
// through the mbarrier ring, two consumer warpgroups of 64 rows run the
// MLP on wgmma. Row r of a chunk step is sample r % cs of ray r / cs;
// consumer wg owns rows 64 wg .. 64 wg + 63. Per chunk:
//   - the skip decision, over both consumers (256 threads) by two named
//     barriers that OR a predicate (bar.red.or, which leaves the producer
//     running): some ray of the block below the cutoff, some sample of
//     the chunk valid;
//   - each consumer encodes its rows' points into its encx tile (the rays'
//     directions were encoded into encd once, before the first chunk) and
//     runs the trunk, then the heads;
//   - once the trunk no longer reads encx, the tile holds each row's
//     compositing inputs [sigma, rgb, t, delta, mask] (32 bytes a row), and
//     after a barrier of both consumers one thread per ray composites its
//     chunk serially, in render.cu's f32 order, its sums in registers.
// Every executed chunk streams the same weight sequence, so a skipped
// chunk never reaches the producer: it runs ahead through the next
// executed chunk's stages, and the consumers just do not consume. At the
// end of the block the consumers wait for the stages it filled ahead
// (no TMA load is in flight when the CTA exits), raise `done` and free one
// more stage, which wakes the producer to read the flag and stop.
struct NerfMarchArgs {
  Args io;
  const bf16* wpack;
  const float* bpack;
  const float* enc;     // [2*F + 2*Fv]: freq_x, mask_x, freq_d, mask_d
  int n_layers, skip_mask, n_freqs, n_freqs_views, d_enc_pad, d_dir_pad;
  int density_act;
};

constexpr int kMarchBar = 3;          // both consumers' named barrier
constexpr int kMarchRowBytes = 32;    // a row's compositing inputs

// A ray's compositing, carried across its block's chunks.
struct RayAcc {
  float od = 0.f, r0 = 0.f, r1 = 0.f, r2 = 0.f, opa = 0.f, dep = 0.f;
};

// One chunk of ray ray_in_block (cs samples) composited serially in
// render.cu's f32 order from the rows' [sigma, rgb, t, delta, mask] (row g
// of the chunk step at rows0 + (g / 64) tile_bytes + (g % 64)
// kMarchRowBytes: each consumer's tile), od carried in acc.
__device__ __forceinline__ void composite_chunk(const unsigned char* rows0,
                                                int tile_bytes,
                                                int ray_in_block, int cs,
                                                RayAcc& acc) {
  const float acc0 = acc.od;
  float cum = 0.f, r0 = 0.f, r1 = 0.f, r2 = 0.f, op = 0.f, dp = 0.f;
  for (int s = 0; s < cs; ++s) {
    const int g = ray_in_block * cs + s;
    const float* q = reinterpret_cast<const float*>(
        rows0 + (g >> 6) * tile_bytes + (g & 63) * kMarchRowBytes);
    const float odv = __fmul_rn(__fmul_rn(q[0], q[5]), q[6]);
    cum = __fadd_rn(cum, odv);
    const float trans = expf(-__fsub_rn(__fadd_rn(acc0, cum), odv));
    const float wgt = __fmul_rn(trans, __fsub_rn(1.f, expf(-odv)));
    r0 += wgt * q[1];
    r1 += wgt * q[2];
    r2 += wgt * q[3];
    op += wgt;
    dp += wgt * q[4];
  }
  acc.r0 += r0;
  acc.r1 += r1;
  acc.r2 += r2;
  acc.opa += op;
  acc.dep += dp;
  acc.od = acc0 + cum;
}

// The block's end, by both consumers: ray ct's stats and the executed
// step count out; then the producer, which has filled (or will fill) the
// next n_stages stages and waits for stage r.it to be freed, is released:
// the lead waits for the stages fed ahead (no TMA load is in flight when
// the CTA exits), raises `done` and frees one more stage.
__device__ __forceinline__ void march_finish(const Args& a, int ct, int bR,
                                             const RayAcc& acc,
                                             int executed, FwdRing& r,
                                             volatile int* done) {
  if (ct < bR) {
    float* out = a.stats + (size_t)(blockIdx.x * bR + ct) * 8;
    out[0] = acc.r0;
    out[1] = acc.r1;
    out[2] = acc.r2;
    out[3] = acc.opa;
    out[4] = acc.dep;
    out[5] = expf(-acc.od);
    out[6] = 0.f;
    out[7] = 0.f;
  }
  if (ct == 0) a.steps[blockIdx.x] = executed;
  if (r.lead) {
    for (int k = r.it; k < r.it + r.n_stages; ++k)
      mbar_wait(&r.full[k % r.n_stages], (k / r.n_stages) & 1);
    *done = 1;
    mbar_arrive(&r.empty[r.it % r.n_stages]);
  }
}

template <int W, int NB>
__device__ __forceinline__ void march_consume(const NerfMarchArgs& m,
                                              FwdRing& r,
                                              unsigned char* act,
                                              unsigned char* encx0,
                                              int encx_bytes,
                                              unsigned char* encd,
                                              volatile int* done, int wg) {
  const Args& a = m.io;
  const int t = threadIdx.x & 127, lane = t & 31, ct = threadIdx.x;
  const int bR = a.block_rows, cs = a.chunk_s, nrows = bR * cs;
  const int ray0 = blockIdx.x * bR, n_chunks = a.K / cs;
  const int DE = m.d_enc_pad, DD = m.d_dir_pad, L = m.n_layers;
  const int bar = 1 + wg;
  unsigned char* encx = encx0 + wg * encx_bytes;
  const float* freq_x = m.enc;
  const float* mask_x = freq_x + m.n_freqs;
  const float* freq_d = mask_x + m.n_freqs;
  const float* mask_d = freq_d + m.n_freqs_views;

  // thread t owns row t % 64 of its warpgroup (and every other 16-byte
  // chunk of its encodings); rows past the chunk step's run on zeros
  const int row = t & 63, gr = 64 * wg + row;
  const bool in = gr < nrows;
  const size_t sample0 = (size_t)(ray0 + gr / cs) * a.K + gr % cs;
  {
    float dv[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dv[k] = in ? a.dirs[(size_t)(ray0 + gr / cs) * 3 + k] : 0.f;
    encode_row(encd, dv, row, t >> 6, enc_blocks(DD), m.n_freqs_views,
               freq_d, mask_d);
  }
  // the row's point and mask of chunk c (zeros past the block's rows):
  // fetched a chunk ahead, while the branch of the last executed chunk
  // runs (few registers are live there)
  float xn[3] = {0.f, 0.f, 0.f}, mn = 0.f;
  auto fetch = [&](int c) {
    if (in && c < n_chunks) {
      const size_t gi = sample0 + (size_t)c * cs;
#pragma unroll
      for (int k = 0; k < 3; ++k) xn[k] = a.x[gi * 3 + k];
      mn = a.mask[gi];
    }
  };
  fetch(0);

  const FwdShape sh{L, m.skip_mask, DE, DD};
  const bf16* w_sigma =
      m.wpack + (size_t)trunk_rows_of(L, m.skip_mask, W, DE) * W;
  const float b_sigma = m.bpack[L * W];
  const int quad_row = 16 * (t >> 5) + (lane >> 2);
  RayAcc ray;              // the compositing of ray ct (ct < bR)
  int executed = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const float xv[3] = {xn[0], xn[1], xn[2]};
    const float mv = mn;
    // exact early exit: skip unless a ray is alive and a sample is valid.
    // The first barrier also ends the last step's reads of the rows'
    // compositing inputs, which this step's encoding overwrites.
    const bool alive =
        named_bar_or(kMarchBar, 256, ct < bR && ray.od < a.thresh);
    const bool valid = named_bar_or(kMarchBar, 256, in && mv > 0.f);
    if (!(alive && valid)) {
      fetch(c + 1);
      continue;
    }
    ++executed;

    encode_row(encx, xv, row, t >> 6, enc_blocks(DE), m.n_freqs, freq_x,
               mask_x);
    fence_proxy_async();
    named_bar(bar, 128);
    float sig[2] = {0.f, 0.f};
    float acc[W / 2];
    fwd_trunk<W>(acc, r, act, smem_u32(encx), sh, m.bpack, w_sigma, sig,
                 bar, nullptr, 0);
    // the trunk's wgmma have retired in every warp: encx is free for each
    // row's compositing inputs
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float v =
          density_activate(quad_sum(sig[h]) + b_sigma, m.density_act);
      if ((lane & 3) == 0)
        reinterpret_cast<float*>(encx + (quad_row + 8 * h) *
                                            kMarchRowBytes)[0] = v;
    }
    fwd_conn<W>(acc, r, act, m.bpack + L * W + 1, bar);
    float tv = 0.f, dv = 0.f;
    if (t < 64 && in) {
      const size_t gi = sample0 + (size_t)c * cs;
      tv = a.t[gi];
      dv = a.deltas[gi];
    }
    fetch(c + 1);
    float rgb[2][3];
    fwd_branch<W, NB>(r, act, smem_u32(encd), DD, w_sigma + W,
                      m.bpack + L * W + 1, rgb);
    if (t < 64) {
      float* q = reinterpret_cast<float*>(encx + row * kMarchRowBytes);
      q[4] = tv;
      q[5] = dv;
      q[6] = mv;
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* q = reinterpret_cast<float*>(
            encx + (quad_row + 8 * h) * kMarchRowBytes);
        q[1] = rgb[h][0];
        q[2] = rgb[h][1];
        q[3] = rgb[h][2];
      }
    }
    named_bar(kMarchBar, 256);
    if (ct < bR) composite_chunk(encx0, encx_bytes, ct, cs, ray);
  }
  march_finish(a, ct, bR, ray, executed, r, done);
}

// The kernel's body at a width of whole-row consumers (up to 256).
template <int W>
__device__ __forceinline__ void nerf_march_whole(const CUtensorMap* map_w,
                                                 const CUtensorMap* map_br,
                                                 const NerfMarchArgs& m,
                                                 int n_stages,
                                                 unsigned char* smem_raw) {
  constexpr int NB = head_n(W);                   // the branch product's N
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nbx = enc_blocks(m.d_enc_pad), nbd = enc_blocks(m.d_dir_pad);
  unsigned char* act = ring + n_stages * W * 128;
  unsigned char* encx = act + kFwdConsumers * W * 128;
  unsigned char* encd = encx + kFwdConsumers * nbx * kBlock;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(encd + kFwdConsumers * nbd * kBlock);
  uint64_t* empty = full + n_stages;
  volatile int* done = reinterpret_cast<volatile int*>(empty + n_stages);
  fwd_init_barriers(full, empty, n_stages, nullptr, 0);
  if (threadIdx.x == 0) *done = 0;
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kFwdConsumers) {                       // the producer
    setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == 128 * kFwdConsumers) {
      const FwdShape sh{m.n_layers, m.skip_mask, m.d_enc_pad, m.d_dir_pad};
      int it = 0;
      while (produce_pass<W, NB>(map_w, map_br, sh, true, ring, full,
                                 empty, n_stages, it, done)) {
      }
    }
    return;
  }
  setmaxnreg_inc<kFwdConsumerRegs>();
  FwdRing r{smem_u32(ring), W * 128, full, empty, n_stages, 0,
            (threadIdx.x & 127) == 0};
  march_consume<W, NB>(m, r, act + wg * W * 128, encx, nbx * kBlock,
                       encd + wg * nbd * kBlock, done, wg);
}

// The march at a split width (FwdTraits<W>::kSplit: 384, 512): one
// consumer warpgroup of 64 rows, which runs each executed chunk step (up
// to 128 rows) as halves of 64 rows one after the other, each through the
// whole column-split MLP of ws_trunk.cuh. The skip decision stays the
// block x chunk step's, over all its rays and samples, so the early exit's
// blocking (and the plain version's) is the same as at every other width.
// Half h holds rows 64 h .. 64 h + 63 of the step: whole rays when chunk_s
// divides 64 (the entry refuses other chunks of more than 64 rows), which
// are composited right after the half's branch, from the rows' inputs in
// encx as march_consume's. encd holds one half's rows, so the directions
// are encoded again for each half.
template <int W, int NB>
__device__ __forceinline__ void march_consume_split(const NerfMarchArgs& m,
                                                    FwdRing& r,
                                                    SplitActs<W>& tiles,
                                                    unsigned char* encx,
                                                    unsigned char* encd,
                                                    volatile int* done) {
  const Args& a = m.io;
  const int t = threadIdx.x, lane = t & 31, ct = t;
  const int bR = a.block_rows, cs = a.chunk_s, nrows = bR * cs;
  const int ray0 = blockIdx.x * bR, n_chunks = a.K / cs;
  const int n_halves = (nrows + 63) / 64;
  const int DE = m.d_enc_pad, DD = m.d_dir_pad, L = m.n_layers;
  const int bar = 1;                                // the consumer's barrier
  const float* freq_x = m.enc;
  const float* mask_x = freq_x + m.n_freqs;
  const float* freq_d = mask_x + m.n_freqs;
  const float* mask_d = freq_d + m.n_freqs_views;

  // thread t owns row t % 64 of each half (and every other 16-byte chunk of
  // its encodings); rows past the chunk step's run on zeros. Unlike
  // march_consume, nothing is fetched a chunk ahead: beside the 128
  // accumulators of a half-width layer, registers held across the MLP
  // spill. A row's mask, point and direction are read where they are
  // used.
  const int row = t & 63;
  const bool in0 = row < nrows, in1 = 64 + row < nrows;
  auto sample = [&](int gr, int c) {
    return (size_t)(ray0 + gr / cs) * a.K + gr % cs + (size_t)c * cs;
  };

  const FwdShape sh{L, m.skip_mask, DE, DD};
  const bf16* w_sigma =
      m.wpack + (size_t)trunk_rows_of(L, m.skip_mask, W, DE) * W;
  const int quad_row = 16 * (t >> 5) + (lane >> 2);
  RayAcc ray;              // the compositing of ray ct (ct < bR)
  int executed = 0;
  for (int c = 0; c < n_chunks; ++c) {
    // exact early exit over the whole chunk step, as march_consume's. The
    // first barrier also ends the last half's compositing reads of encx.
    const bool live0 = in0 && a.mask[sample(row, c)] > 0.f;
    const bool live1 = in1 && a.mask[sample(64 + row, c)] > 0.f;
    const bool alive =
        named_bar_or(kMarchBar, 128, ct < bR && ray.od < a.thresh);
    const bool valid = named_bar_or(kMarchBar, 128, live0 || live1);
    if (!(alive && valid)) continue;
    ++executed;

    for (int h = 0; h < n_halves; ++h) {
      const int gr = 64 * h + row;
      const bool in = h == 0 ? in0 : in1;
      // the last half's compositing has read encx
      if (h > 0) named_bar(bar, 128);
      {
        float xv[3], dv[3];
        const size_t gi = sample(gr, c);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          xv[k] = in ? a.x[gi * 3 + k] : 0.f;
          dv[k] = in ? a.dirs[(size_t)(ray0 + gr / cs) * 3 + k] : 0.f;
        }
        encode_row(encx, xv, row, t >> 6, enc_blocks(DE), m.n_freqs,
                   freq_x, mask_x);
        encode_row(encd, dv, row, t >> 6, enc_blocks(DD), m.n_freqs_views,
                   freq_d, mask_d);
      }
      fence_proxy_async();
      named_bar(bar, 128);
      float sig[2] = {0.f, 0.f};
      float acc[W / 4];
      zero_acc(acc);
      fwd_trunk_split<W>(acc, r, tiles, smem_u32(encx), sh, m.bpack, w_sigma,
                         sig, bar, nullptr, 0);
      // the trunk's wgmma have retired in every warp: encx is free for
      // each row's compositing inputs
      const float b_sigma = m.bpack[L * W];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const float v =
            density_activate(quad_sum(sig[k]) + b_sigma, m.density_act);
        if ((lane & 3) == 0)
          reinterpret_cast<float*>(encx + (quad_row + 8 * k) *
                                              kMarchRowBytes)[0] = v;
      }
      fwd_conn_split<W>(acc, r, tiles, m.bpack + L * W + 1, bar);
      float rgb[2][3];
      fwd_branch_split<W, NB>(r, tiles, smem_u32(encd), DD, w_sigma + W,
                              m.bpack + L * W + 1, rgb);
      if (t < 64) {
        float* q = reinterpret_cast<float*>(encx + row * kMarchRowBytes);
        const size_t gi = sample(gr, c);
        q[4] = in ? a.t[gi] : 0.f;
        q[5] = in ? a.deltas[gi] : 0.f;
        q[6] = in ? a.mask[gi] : 0.f;
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float* q = reinterpret_cast<float*>(
              encx + (quad_row + 8 * k) * kMarchRowBytes);
          q[1] = rgb[k][0];
          q[2] = rgb[k][1];
          q[3] = rgb[k][2];
        }
      }
      named_bar(bar, 128);
      // ray ct's rows start at row ct * cs of the step: in half h
      if (ct < bR && ct * cs / 64 == h)
        composite_chunk(encx, 0, ct - 64 * h / cs, cs, ray);
    }
  }
  march_finish(a, ct, bR, ray, executed, r, done);
}

// The split kernel's body: the ring of W / 2-wide stages, the three
// activation tiles, the consumer's encodings, the barriers, the done flag.
template <int W>
__device__ __forceinline__ void nerf_march_split(const CUtensorMap* map_w,
                                                 const CUtensorMap* map_br,
                                                 const NerfMarchArgs& m,
                                                 int n_stages,
                                                 unsigned char* smem_raw) {
  using T = FwdTraits<W>;
  constexpr int NB = head_n(W);
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* act = ring + n_stages * T::kStageBytes;
  unsigned char* encx = act + T::kActBytes;
  unsigned char* encd = encx + enc_blocks(m.d_enc_pad) * kBlock;
  uint64_t* full = reinterpret_cast<uint64_t*>(
      encd + enc_blocks(m.d_dir_pad) * kBlock);
  uint64_t* empty = full + n_stages;
  volatile int* done = reinterpret_cast<volatile int*>(empty + n_stages);
  fwd_init_barriers(full, empty, n_stages, nullptr, 0, 1);
  if (threadIdx.x == 0) *done = 0;
  __syncthreads();
  if (threadIdx.x >= 128) {                        // the producer
    if (threadIdx.x == 128) {
      const FwdShape sh{m.n_layers, m.skip_mask, m.d_enc_pad, m.d_dir_pad};
      int it = 0;
      while (produce_pass_split<W, NB>(map_w, map_br, sh, true, ring, full,
                                       empty, n_stages, it, done)) {
      }
    }
    return;
  }
  SplitActs<W> tiles(act);
  FwdRing r{smem_u32(ring), T::kStageBytes, full, empty, n_stages, 0,
            threadIdx.x == 0};
  march_consume_split<W, NB>(m, r, tiles, encx, encd, done);
}

// grid: one CTA per block of block_rows rays; block: the consumer
// warpgroups + the producer's (FwdTraits<W>).
template <int W>
__global__ void __launch_bounds__(FwdTraits<W>::kThreads, 1)
    nerf_march_kernel(const __grid_constant__ CUtensorMap map_w,
                      const __grid_constant__ CUtensorMap map_br,
                      NerfMarchArgs m, int n_stages) {
  extern __shared__ unsigned char march_smem_raw[];
  if constexpr (FwdTraits<W>::kSplit)
    nerf_march_split<W>(&map_w, &map_br, m, n_stages, march_smem_raw);
  else
    nerf_march_whole<W>(&map_w, &map_br, m, n_stages, march_smem_raw);
}

template <int W>
int launch_nerf_march_w(const NerfMarchArgs& m, int trunk_rows, int n_rays,
                        cudaStream_t st) {
  CUtensorMap map_w, map_br;
  if (!encode_weight_maps<W>(&map_w, &map_br, m.wpack, trunk_rows,
                             m.d_dir_pad))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t extra = 16;                         // the done flag
  const int n_stages = fwd_stages(W, m.d_enc_pad, m.d_dir_pad, extra);
  if (n_stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      fwd_smem_bytes(W, m.d_enc_pad, m.d_dir_pad, n_stages) + extra;
  cudaError_t err = cudaFuncSetAttribute(
      nerf_march_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = n_rays / m.io.block_rows;
  if (n_blocks > 0)
    nerf_march_kernel<W><<<n_blocks, FwdTraits<W>::kThreads, smem, st>>>(
        map_w, map_br, m, n_stages);
  return static_cast<int>(cudaGetLastError());
}

// The march at a streamed width (W at run time): nerf_march_kernel_stream, one
// consumer warpgroup of 64 rows and the producer's, the CTAs persistent
// over the ray blocks (block blockIdx.x, then every gridDim.x-th). Each
// executed block x chunk step runs as march_consume_split's 64-row halves
// of whole rays, each half through ws_trunk.cuh's streamed trunk,
// connection and branch (every layer's output through the CTA's scratch
// slot and back from L2), with the same skip decision per step, so the
// early exit's blocking (and the plain version's) is every other width's.
// The producer runs ahead through the next executed half's weight stages
// as at the other widths; after the last block the consumer releases it
// as march_finish does.
__device__ __forceinline__ void march_consume_stream(
    const NerfMarchArgs& m, int W, int n_blocks, FwdRing& r, ARing& ar,
    const StreamTiles& s, const CUtensorMap* map_slab, volatile int* done) {
  const Args& a = m.io;
  const int t = threadIdx.x, lane = t & 31, ct = t;
  const int bR = a.block_rows, cs = a.chunk_s, nrows = bR * cs;
  const int n_chunks = a.K / cs, n_halves = (nrows + 63) / 64;
  const int DE = m.d_enc_pad, DD = m.d_dir_pad, L = m.n_layers;
  const int bar = 1;                                // the consumer's barrier
  const float* freq_x = m.enc;
  const float* mask_x = freq_x + m.n_freqs;
  const float* freq_d = mask_x + m.n_freqs;
  const float* mask_d = freq_d + m.n_freqs_views;
  const int row = t & 63;
  const bool in0 = row < nrows, in1 = 64 + row < nrows;
  const FwdShape sh{L, m.skip_mask, DE, DD};
  const bf16* w_sigma =
      m.wpack + (size_t)trunk_rows_of(L, m.skip_mask, W, DE) * W;
  const StreamBufs io{nullptr, map_slab, 0, (int)blockIdx.x * 64, W, L};
  const int quad_row = 16 * (t >> 5) + (lane >> 2);
  for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const int ray0 = blk * bR;
    auto sample = [&](int gr, int c) {
      return (size_t)(ray0 + gr / cs) * a.K + gr % cs + (size_t)c * cs;
    };
    RayAcc ray;              // the compositing of ray ct (ct < bR)
    int executed = 0;
    for (int c = 0; c < n_chunks; ++c) {
      // exact early exit over the whole chunk step; the first barrier also
      // ends the last half's compositing reads of encx
      const bool live0 = in0 && a.mask[sample(row, c)] > 0.f;
      const bool live1 = in1 && a.mask[sample(64 + row, c)] > 0.f;
      const bool alive =
          named_bar_or(kMarchBar, 128, ct < bR && ray.od < a.thresh);
      const bool valid = named_bar_or(kMarchBar, 128, live0 || live1);
      if (!(alive && valid)) continue;
      ++executed;
      for (int h = 0; h < n_halves; ++h) {
        const int gr = 64 * h + row;
        const bool in = h == 0 ? in0 : in1;
        // the last half's compositing has read encx
        if (h > 0) named_bar(bar, 128);
        {
          float xv[3], dv[3];
          const size_t gi = sample(gr, c);
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            xv[k] = in ? a.x[gi * 3 + k] : 0.f;
            dv[k] = in ? a.dirs[(size_t)(ray0 + gr / cs) * 3 + k] : 0.f;
          }
          encode_row(s.encx, xv, row, t >> 6, enc_blocks(DE), m.n_freqs,
                     freq_x, mask_x);
          encode_row(s.encd, dv, row, t >> 6, enc_blocks(DD),
                     m.n_freqs_views, freq_d, mask_d);
        }
        fence_proxy_async();
        named_bar(bar, 128);
        {
          float sig[2] = {0.f, 0.f};
          float acc[kStreamCols / 2];
          zero_acc(acc);
          stream_trunk(acc, r, ar, s, sh, W, m.bpack, w_sigma, sig, bar, io);
          // the trunk's wgmma have retired in every warp: encx is free for
          // each row's compositing inputs
          const float b_sigma = m.bpack[L * W];
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            const float v =
                density_activate(quad_sum(sig[k]) + b_sigma, m.density_act);
            if ((lane & 3) == 0)
              reinterpret_cast<float*>(s.encx + (quad_row + 8 * k) *
                                                    kMarchRowBytes)[0] = v;
          }
          stream_conn(acc, r, ar, s, W, m.bpack + L * W + 1, bar, io);
        }
        float rgb[2][3];
        stream_branch(r, ar, s, io.at(L), W, DD, w_sigma + W,
                      m.bpack + L * W + 1, rgb);
        if (t < 64) {
          float* q = reinterpret_cast<float*>(s.encx + row * kMarchRowBytes);
          const size_t gi = sample(gr, c);
          q[4] = in ? a.t[gi] : 0.f;
          q[5] = in ? a.deltas[gi] : 0.f;
          q[6] = in ? a.mask[gi] : 0.f;
        }
        if ((lane & 3) == 0) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float* q = reinterpret_cast<float*>(
                s.encx + (quad_row + 8 * k) * kMarchRowBytes);
            q[1] = rgb[k][0];
            q[2] = rgb[k][1];
            q[3] = rgb[k][2];
          }
        }
        named_bar(bar, 128);
        // ray ct's rows start at row ct * cs of the step: in half h
        if (ct < bR && ct * cs / 64 == h)
          composite_chunk(s.encx, 0, ct - 64 * h / cs, cs, ray);
      }
    }
    if (ct < bR) {
      float* out = a.stats + (size_t)(ray0 + ct) * 8;
      out[0] = ray.r0;
      out[1] = ray.r1;
      out[2] = ray.r2;
      out[3] = ray.opa;
      out[4] = ray.dep;
      out[5] = expf(-ray.od);
      out[6] = 0.f;
      out[7] = 0.f;
    }
    if (ct == 0) a.steps[blk] = executed;
  }
  if (r.lead) {              // release the producer, as march_finish
    for (int k = r.it; k < r.it + r.n_stages; ++k)
      mbar_wait(&r.full[k % r.n_stages], (k / r.n_stages) & 1);
    *done = 1;
    mbar_arrive(&r.empty[r.it % r.n_stages]);
  }
}

// grid: min(n_blocks, the scratch's slots) persistent CTAs over the
// n_blocks ray blocks; block: one consumer warpgroup + the producer's; W a
// streamed width.
__global__ void __launch_bounds__(256, 1)
    nerf_march_kernel_stream(const __grid_constant__ CUtensorMap map_w,
                             const __grid_constant__ CUtensorMap map_br,
                             const __grid_constant__ CUtensorMap map_slab,
                             NerfMarchArgs m, int W, int n_blocks,
                             int n_stages) {
  extern __shared__ unsigned char march_stream_smem_raw[];
  const StreamTiles s =
      stream_carve(march_stream_smem_raw, n_stages, m.d_enc_pad, m.d_dir_pad);
  volatile int* done = reinterpret_cast<volatile int*>(s.extra);
  fwd_init_barriers(s.full, s.empty, n_stages, s.afull, kStreamAStages, 1);
  if (threadIdx.x == 0) *done = 0;
  __syncthreads();
  if (threadIdx.x >= 128) {                        // the producer
    if (threadIdx.x == 128) {
      const FwdShape sh{m.n_layers, m.skip_mask, m.d_enc_pad, m.d_dir_pad};
      int it = 0;
      while (produce_pass_stream(&map_w, &map_br, W, sh, true, s.ring, s.full,
                                 s.empty, n_stages, it, done)) {
      }
    }
    return;
  }
  FwdRing r{smem_u32(s.ring), kStreamStageBytes, s.full, s.empty, n_stages,
            0, threadIdx.x == 0};
  ARing ar{smem_u32(s.a), s.a, s.afull, 0};
  march_consume_stream(m, W, n_blocks, r, ar, s, &map_slab, done);
}

// nerf_march_kernel_stream at a streamed W on `st`, slab the [slab_ctas *
// 64, 2 W] bf16 scratch.
int launch_nerf_march_stream(const NerfMarchArgs& m, int W, int trunk_rows,
                             int n_rays, const bf16* slab, int slab_ctas,
                             cudaStream_t st) {
  CUtensorMap map_w, map_br, map_slab;
  if (!encode_stream_maps(&map_w, &map_br, &map_slab, m.wpack, trunk_rows, W,
                          m.d_dir_pad, slab, slab_ctas))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t extra = 16;                         // the done flag
  const int n_stages = stream_stages(m.d_enc_pad, m.d_dir_pad, extra);
  if (n_stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      stream_smem_bytes(m.d_enc_pad, m.d_dir_pad, n_stages) + extra;
  cudaError_t err = cudaFuncSetAttribute(
      nerf_march_kernel_stream, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = n_rays / m.io.block_rows;
  if (n_blocks > 0)
    nerf_march_kernel_stream<<<min(n_blocks, slab_ctas), 256, smem, st>>>(
        map_w, map_br, map_slab, m, W, n_blocks, n_stages);
  return static_cast<int>(cudaGetLastError());
}

// ---- the SIREN march (siren_march_kernel) ------------------------------
//
// nerf_march_kernel's shell (the skip decision on named barriers, the
// producer never told of a skipped chunk and stopped by `done`, the serial
// per-ray composite from each row's inputs in the input tile) around the
// SIREN forward of siren_common.cuh: per executed chunk, each consumer
// writes its rows' points as bf16 into its one-block input tile (columns 0
// .. 2, zeros to 16), runs the sine trunk and the heads (siren_heads, the
// rows' ray directions, kept in shared memory, for the rgb head's rank-3
// term). Widths 64, 128, 192, 256, and 384, 512 on the column-split trunk
// (siren_march_consume_split), the streamed widths on the streamed one (below);
// 288 and 320 keep ray_march_kernel<SirenMarch> (its two activation
// buffers' shared memory).
struct SirenMarchArgs {
  Args io;
  Siren m;
};

template <int W>
__device__ __forceinline__ void siren_march_consume(const SirenMarchArgs& sa,
                                                    FwdRing& r,
                                                    unsigned char* act,
                                                    unsigned char* xt0,
                                                    float* dir_rows,
                                                    volatile int* done,
                                                    int wg) {
  const Args& a = sa.io;
  const int t = threadIdx.x & 127, lane = t & 31, ct = threadIdx.x;
  const int bR = a.block_rows, cs = a.chunk_s, nrows = bR * cs;
  const int ray0 = blockIdx.x * bR, n_chunks = a.K / cs;
  const int bar = 1 + wg;
  unsigned char* xt = xt0 + wg * kBlock;

  // thread t owns row t % 64 of its warpgroup's input tile (t < 64 its
  // columns 0..7, the others 8..15); rows past the chunk step's run on
  // zeros
  const int row = t & 63, gr = 64 * wg + row;
  const bool in = gr < nrows;
  const size_t sample0 = (size_t)(ray0 + gr / cs) * a.K + gr % cs;
  const int quad_row = 16 * (t >> 5) + (lane >> 2);
  // each row's bf16 direction, 4 floats a row (dir_rows: this
  // warpgroup's 64), read by the heads after the barriers of the first
  // executed chunk
  if (t < 64) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dir_rows[4 * row + k] =
          in ? __bfloat162float(__float2bfloat16_rn(
                   a.dirs[(size_t)(ray0 + gr / cs) * 3 + k]))
             : 0.f;
  }
  const SharedDirs dirs{dir_rows + 4 * quad_row};
  // the row's point and mask of chunk c (zeros past the block's rows),
  // fetched a chunk ahead
  float xn[3] = {0.f, 0.f, 0.f}, mn = 0.f;
  auto fetch = [&](int c) {
    if (in && c < n_chunks) {
      const size_t gi = sample0 + (size_t)c * cs;
#pragma unroll
      for (int k = 0; k < 3; ++k) xn[k] = a.x[gi * 3 + k];
      mn = a.mask[gi];
    }
  };
  fetch(0);

  const FwdShape sh{sa.m.n_layers, 0, kInPad, 0};
  const SineActs<false> acts{sa.m.alphas, W};
  RayAcc ray;              // the compositing of ray ct (ct < bR)
  int executed = 0;
  for (int c = 0; c < n_chunks; ++c) {
    const float mv = mn;
    // exact early exit, as nerf_march_kernel's
    const bool alive =
        named_bar_or(kMarchBar, 256, ct < bR && ray.od < a.thresh);
    const bool valid = named_bar_or(kMarchBar, 256, in && mv > 0.f);
    if (!(alive && valid)) {
      fetch(c + 1);
      continue;
    }
    ++executed;

    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (t < 64) {
      const __nv_bfloat162 p0 = __floats2bfloat162_rn(xn[0], xn[1]);
      const __nv_bfloat162 p1 = __floats2bfloat162_rn(xn[2], 0.f);
      v.x = *reinterpret_cast<const uint32_t*>(&p0);
      v.y = *reinterpret_cast<const uint32_t*>(&p1);
    }
    *reinterpret_cast<uint4*>(tile_at(xt, row, 8 * (t >> 6))) = v;
    fence_proxy_async();
    named_bar(bar, 128);
    float acc[W / 2], unused[2] = {0.f, 0.f};
    fwd_trunk<W>(acc, r, act, smem_u32(xt), sh, sa.m.bpack, nullptr, unused,
                 bar, nullptr, 0, acts);
    // the trunk's wgmma have retired in every warp: xt is free for each
    // row's compositing inputs
    float tv = 0.f, dv = 0.f;
    if (t < 64 && in) {
      const size_t gi = sample0 + (size_t)c * cs;
      tv = a.t[gi];
      dv = a.deltas[gi];
    }
    fetch(c + 1);
    float sigma[2], rgb[2][3];
    siren_heads<W>(acc, r, act, sa.m, dirs, bar, sigma, rgb);
    if (t < 64) {
      float* q = reinterpret_cast<float*>(xt + row * kMarchRowBytes);
      q[4] = tv;
      q[5] = dv;
      q[6] = mv;
    }
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* q = reinterpret_cast<float*>(
            xt + (quad_row + 8 * h) * kMarchRowBytes);
        q[0] = sigma[h];
        q[1] = rgb[h][0];
        q[2] = rgb[h][1];
        q[3] = rgb[h][2];
      }
    }
    named_bar(kMarchBar, 256);
    if (ct < bR) composite_chunk(xt0, kBlock, ct, cs, ray);
  }
  march_finish(a, ct, bR, ray, executed, r, done);
}

// The SIREN march at a split width (384, 512), as march_consume_split:
// one consumer warpgroup runs each executed chunk step (up to 128 rows) as
// halves of 64 rows, each through the column-split sine trunk and
// siren_heads_split, with one skip decision per block x chunk step; each
// half's rows' points are written into the input tile xt, which then holds
// their compositing inputs, composited right after the half (whole rays:
// the entry refuses a chunk_s that does not divide 64 when a step has more
// than 64 rows). dir_rows holds the step's 128 rows' bf16 directions.
template <int W>
__device__ __forceinline__ void siren_march_consume_split(
    const SirenMarchArgs& sa, FwdRing& r, SplitActs<W>& tiles,
    unsigned char* xt, float* dir_rows, volatile int* done) {
  const Args& a = sa.io;
  const int t = threadIdx.x, lane = t & 31, ct = t;
  const int bR = a.block_rows, cs = a.chunk_s, nrows = bR * cs;
  const int ray0 = blockIdx.x * bR, n_chunks = a.K / cs;
  const int n_halves = (nrows + 63) / 64;
  const int bar = 1;                                // the consumer's barrier

  // thread t owns row t % 64 of each half (t < 64 its columns 0..7, the
  // others 8..15); rows past the chunk step's run on zeros. As in
  // march_consume_split, nothing is fetched a chunk ahead.
  const int row = t & 63;
  const bool in0 = row < nrows, in1 = 64 + row < nrows;
  auto sample = [&](int gr, int c) {
    return (size_t)(ray0 + gr / cs) * a.K + gr % cs + (size_t)c * cs;
  };
  const int quad_row = 16 * (t >> 5) + (lane >> 2);
#pragma unroll
  for (int k = 0; k < 3; ++k)
    dir_rows[4 * t + k] =
        t < nrows ? __bfloat162float(__float2bfloat16_rn(
                        a.dirs[(size_t)(ray0 + t / cs) * 3 + k]))
                  : 0.f;

  const FwdShape sh{sa.m.n_layers, 0, kInPad, 0};
  const SineActs<false> acts{sa.m.alphas, W};
  RayAcc ray;              // the compositing of ray ct (ct < bR)
  int executed = 0;
  for (int c = 0; c < n_chunks; ++c) {
    // exact early exit over the whole chunk step, as march_consume's. The
    // first barrier also ends the last half's compositing reads of xt.
    const bool live0 = in0 && a.mask[sample(row, c)] > 0.f;
    const bool live1 = in1 && a.mask[sample(64 + row, c)] > 0.f;
    const bool alive =
        named_bar_or(kMarchBar, 128, ct < bR && ray.od < a.thresh);
    const bool valid = named_bar_or(kMarchBar, 128, live0 || live1);
    if (!(alive && valid)) continue;
    ++executed;

    for (int h = 0; h < n_halves; ++h) {
      const int gr = 64 * h + row;
      const bool in = h == 0 ? in0 : in1;
      // the last half's compositing has read xt
      if (h > 0) named_bar(bar, 128);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (t < 64 && in) {
        const size_t gi = sample(gr, c);
        const __nv_bfloat162 p0 =
            __floats2bfloat162_rn(a.x[gi * 3], a.x[gi * 3 + 1]);
        const __nv_bfloat162 p1 = __floats2bfloat162_rn(a.x[gi * 3 + 2], 0.f);
        v.x = *reinterpret_cast<const uint32_t*>(&p0);
        v.y = *reinterpret_cast<const uint32_t*>(&p1);
      }
      *reinterpret_cast<uint4*>(tile_at(xt, row, 8 * (t >> 6))) = v;
      fence_proxy_async();
      named_bar(bar, 128);
      float acc[W / 4], unused[2] = {0.f, 0.f};
      zero_acc(acc);
      fwd_trunk_split<W>(acc, r, tiles, smem_u32(xt), sh, sa.m.bpack, nullptr,
                         unused, bar, nullptr, 0, acts);
      float sigma[2], rgb[2][3];
      siren_heads_split<W>(acc, r, tiles, sa.m,
                           SharedDirs{dir_rows + 4 * (64 * h + quad_row)},
                           bar, sigma, rgb);
      // the trunk's wgmma have retired in every warp: xt is free for each
      // row's compositing inputs
      if (t < 64) {
        float* q = reinterpret_cast<float*>(xt + row * kMarchRowBytes);
        const size_t gi = sample(gr, c);
        q[4] = in ? a.t[gi] : 0.f;
        q[5] = in ? a.deltas[gi] : 0.f;
        q[6] = in ? a.mask[gi] : 0.f;
      }
      if ((lane & 3) == 0) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          float* q = reinterpret_cast<float*>(
              xt + (quad_row + 8 * k) * kMarchRowBytes);
          q[0] = sigma[k];
          q[1] = rgb[k][0];
          q[2] = rgb[k][1];
          q[3] = rgb[k][2];
        }
      }
      named_bar(bar, 128);
      // ray ct's rows start at row ct * cs of the step: in half h
      if (ct < bR && ct * cs / 64 == h)
        composite_chunk(xt, 0, ct - 64 * h / cs, cs, ray);
    }
  }
  march_finish(a, ct, bR, ray, executed, r, done);
}

// The split kernel's body: the ring of W / 2-wide stages, the three
// activation tiles, the input tile, the barriers, the done flag and the
// rows' directions.
template <int W>
__device__ __forceinline__ void siren_march_split(const SirenFwdMaps& mp,
                                                  const SirenMarchArgs& sa,
                                                  int n_stages,
                                                  unsigned char* smem_raw) {
  using T = FwdTraits<W>;
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* act = ring + n_stages * T::kStageBytes;
  unsigned char* xt = act + T::kActBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(xt + kBlock);
  uint64_t* empty = full + n_stages;
  volatile int* done = reinterpret_cast<volatile int*>(empty + n_stages);
  float* dir_rows = reinterpret_cast<float*>(empty + n_stages + 2);
  fwd_init_barriers(full, empty, n_stages, nullptr, 0, 1);
  if (threadIdx.x == 0) *done = 0;
  __syncthreads();
  if (threadIdx.x >= 128) {                        // the producer
    if (threadIdx.x == 128) {
      int it = 0;
      while (siren_produce_pass_split<W>(mp, sa.m.n_layers, ring, full,
                                         empty, n_stages, it, done)) {
      }
    }
    return;
  }
  SplitActs<W> tiles(act);
  FwdRing r{smem_u32(ring), T::kStageBytes, full, empty, n_stages, 0,
            threadIdx.x == 0};
  siren_march_consume_split<W>(sa, r, tiles, xt, dir_rows, done);
}

// The kernel's body at a width of whole-row consumers (up to 256).
template <int W>
__device__ __forceinline__ void siren_march_whole(const SirenFwdMaps& mp,
                                                  const SirenMarchArgs& sa,
                                                  int n_stages,
                                                  unsigned char*
                                                      siren_march_smem_raw) {
  unsigned char* ring =
      siren_march_smem_raw +
      ((1024 - (smem_u32(siren_march_smem_raw) & 1023)) & 1023);
  unsigned char* act = ring + n_stages * W * 128;
  unsigned char* xt = act + kFwdConsumers * W * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(xt + kFwdConsumers * kBlock);
  uint64_t* empty = full + n_stages;
  volatile int* done = reinterpret_cast<volatile int*>(empty + n_stages);
  float* dir_rows = reinterpret_cast<float*>(empty + n_stages + 2);
  fwd_init_barriers(full, empty, n_stages, nullptr, 0);
  if (threadIdx.x == 0) *done = 0;
  __syncthreads();
  const int wg = threadIdx.x / 128;
  if (wg == kFwdConsumers) {                       // the producer
    setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == 128 * kFwdConsumers) {
      int it = 0;
      while (siren_produce_pass<W>(mp, sa.m.n_layers, ring, full, empty,
                                   n_stages, it, done)) {
      }
    }
    return;
  }
  setmaxnreg_inc<kFwdConsumerRegs>();
  FwdRing r{smem_u32(ring), W * 128, full, empty, n_stages, 0,
            (threadIdx.x & 127) == 0};
  siren_march_consume<W>(sa, r, act + wg * W * 128, xt,
                         dir_rows + wg * 64 * 4, done, wg);
}

// grid: one CTA per block of block_rows rays; block: the consumer
// warpgroups + the producer's (FwdTraits<W>).
template <int W>
__global__ void __launch_bounds__(FwdTraits<W>::kThreads, 1)
    siren_march_kernel(const __grid_constant__ SirenFwdMaps mp,
                       SirenMarchArgs sa, int n_stages) {
  extern __shared__ unsigned char siren_march_smem_raw[];
  if constexpr (FwdTraits<W>::kSplit)
    siren_march_split<W>(mp, sa, n_stages, siren_march_smem_raw);
  else
    siren_march_whole<W>(mp, sa, n_stages, siren_march_smem_raw);
}

// The SIREN march's shared memory past ws_trunk.cuh's fwd_smem_bytes: the
// done flag, then the rows' directions (ops/kernels/siren.py::
// siren_smem_bytes mirrors the sizes, fsnerf_siren_march_stages reports the
// ring).
constexpr size_t kSirenMarchExtra = 16 + kRows * 4 * sizeof(float);

template <int W>
int launch_siren_march_w(const SirenMarchArgs& sa, int n_rays,
                         cudaStream_t st) {
  SirenFwdMaps mp;
  if (!encode_siren_fwd_maps(&mp, sa.m.wpack, sa.m.n_layers, W))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t extra = kSirenMarchExtra;
  const int n_stages = fwd_stages(W, kInPad, 0, extra);
  if (n_stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = fwd_smem_bytes(W, kInPad, 0, n_stages) + extra;
  cudaError_t err = cudaFuncSetAttribute(
      siren_march_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = n_rays / sa.io.block_rows;
  if (n_blocks > 0)
    siren_march_kernel<W><<<n_blocks, FwdTraits<W>::kThreads, smem, st>>>(
        mp, sa, n_stages);
  return static_cast<int>(cudaGetLastError());
}

// The SIREN march at a streamed width: siren_march_kernel_stream,
// nerf_march_kernel_stream's shell (persistent CTAs of one 64-row consumer
// and a producer, every executed block x chunk step as 64-row halves of
// whole rays with one skip decision per step, the producer released as
// march_finish does) around the SIREN forward of siren_fwd_kernel_stream:
// per half, the rows' points as bf16 into encx (columns 0 .. 2, zeros to
// 16), the sine trunk streamed through the CTA's scratch slot, then
// siren_heads_stream with the rows' bf16 directions from dir_rows (the
// block's, written at its start); encx then holds each row's compositing
// inputs, composited right after the half.
__device__ __forceinline__ void siren_march_consume_stream(
    const SirenMarchArgs& sa, int n_blocks, FwdRing& r, ARing& ar,
    const StreamTiles& s, const CUtensorMap* map_slab, float* dir_rows,
    volatile int* done) {
  const Args& a = sa.io;
  const int t = threadIdx.x, lane = t & 31, ct = t;
  const int bR = a.block_rows, cs = a.chunk_s, nrows = bR * cs;
  const int n_chunks = a.K / cs, n_halves = (nrows + 63) / 64;
  const int W = sa.m.width, L = sa.m.n_layers;
  const int bar = 1;                                // the consumer's barrier
  const int row = t & 63;
  const bool in0 = row < nrows, in1 = 64 + row < nrows;
  const FwdShape sh{L, 0, kInPad, 0};
  const SineActs<false> acts{sa.m.alphas, W};
  const StreamBufs io{nullptr, map_slab, 0, (int)blockIdx.x * 64, W, L};
  const int quad_row = 16 * (t >> 5) + (lane >> 2);
  for (int blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const int ray0 = blk * bR;
    auto sample = [&](int gr, int c) {
      return (size_t)(ray0 + gr / cs) * a.K + gr % cs + (size_t)c * cs;
    };
    // the block's rows' directions (the last block's heads have read
    // theirs: its last half ended on a barrier); read after the step's
    // barriers
#pragma unroll
    for (int k = 0; k < 3; ++k)
      dir_rows[4 * t + k] =
          t < nrows ? __bfloat162float(__float2bfloat16_rn(
                          a.dirs[(size_t)(ray0 + t / cs) * 3 + k]))
                    : 0.f;
    RayAcc ray;              // the compositing of ray ct (ct < bR)
    int executed = 0;
    for (int c = 0; c < n_chunks; ++c) {
      // exact early exit over the whole chunk step; the first barrier also
      // ends the last half's compositing reads of encx
      const bool live0 = in0 && a.mask[sample(row, c)] > 0.f;
      const bool live1 = in1 && a.mask[sample(64 + row, c)] > 0.f;
      const bool alive =
          named_bar_or(kMarchBar, 128, ct < bR && ray.od < a.thresh);
      const bool valid = named_bar_or(kMarchBar, 128, live0 || live1);
      if (!(alive && valid)) continue;
      ++executed;
      for (int h = 0; h < n_halves; ++h) {
        const int gr = 64 * h + row;
        const bool in = h == 0 ? in0 : in1;
        // the last half's compositing has read encx
        if (h > 0) named_bar(bar, 128);
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (t < 64 && in) {
          const size_t gi = sample(gr, c);
          const __nv_bfloat162 p0 =
              __floats2bfloat162_rn(a.x[gi * 3], a.x[gi * 3 + 1]);
          const __nv_bfloat162 p1 =
              __floats2bfloat162_rn(a.x[gi * 3 + 2], 0.f);
          v.x = *reinterpret_cast<const uint32_t*>(&p0);
          v.y = *reinterpret_cast<const uint32_t*>(&p1);
        }
        *reinterpret_cast<uint4*>(tile_at(s.encx, row, 8 * (t >> 6))) = v;
        fence_proxy_async();
        named_bar(bar, 128);
        float sigma[2], rgb[2][3];
        {
          float acc[kStreamCols / 2], unused[2] = {0.f, 0.f};
          zero_acc(acc);
          stream_trunk(acc, r, ar, s, sh, W, sa.m.bpack, nullptr, unused,
                       bar, io, acts);
          siren_heads_stream(acc, r, ar, s, sa.m,
                             SharedDirs{dir_rows + 4 * (64 * h + quad_row)},
                             bar, io, sigma, rgb);
        }
        // the trunk's wgmma have retired in every warp: encx is free for
        // each row's compositing inputs
        if (t < 64) {
          float* q = reinterpret_cast<float*>(s.encx + row * kMarchRowBytes);
          const size_t gi = sample(gr, c);
          q[4] = in ? a.t[gi] : 0.f;
          q[5] = in ? a.deltas[gi] : 0.f;
          q[6] = in ? a.mask[gi] : 0.f;
        }
        if ((lane & 3) == 0) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            float* q = reinterpret_cast<float*>(
                s.encx + (quad_row + 8 * k) * kMarchRowBytes);
            q[0] = sigma[k];
            q[1] = rgb[k][0];
            q[2] = rgb[k][1];
            q[3] = rgb[k][2];
          }
        }
        named_bar(bar, 128);
        // ray ct's rows start at row ct * cs of the step: in half h
        if (ct < bR && ct * cs / 64 == h)
          composite_chunk(s.encx, 0, ct - 64 * h / cs, cs, ray);
      }
    }
    if (ct < bR) {
      float* out = a.stats + (size_t)(ray0 + ct) * 8;
      out[0] = ray.r0;
      out[1] = ray.r1;
      out[2] = ray.r2;
      out[3] = ray.opa;
      out[4] = ray.dep;
      out[5] = expf(-ray.od);
      out[6] = 0.f;
      out[7] = 0.f;
    }
    if (ct == 0) a.steps[blk] = executed;
  }
  if (r.lead) {              // release the producer, as march_finish
    for (int k = r.it; k < r.it + r.n_stages; ++k)
      mbar_wait(&r.full[k % r.n_stages], (k / r.n_stages) & 1);
    *done = 1;
    mbar_arrive(&r.empty[r.it % r.n_stages]);
  }
}

// grid: min(n_blocks, the scratch's slots) persistent CTAs over the
// n_blocks ray blocks; block: one consumer warpgroup + the producer's;
// shared memory stream_carve's with no encd, then the done flag and the
// rows' directions (kSirenMarchExtra).
__global__ void __launch_bounds__(256, 1)
    siren_march_kernel_stream(const __grid_constant__ SirenFwdMaps mp,
                              const __grid_constant__ CUtensorMap map_slab,
                              SirenMarchArgs sa, int n_blocks,
                              int n_stages) {
  extern __shared__ unsigned char siren_stream_smem_raw[];
  const StreamTiles s =
      stream_carve(siren_stream_smem_raw, n_stages, kInPad, 0);
  volatile int* done = reinterpret_cast<volatile int*>(s.extra);
  float* dir_rows = reinterpret_cast<float*>(s.extra + 2);
  fwd_init_barriers(s.full, s.empty, n_stages, s.afull, kStreamAStages, 1);
  if (threadIdx.x == 0) *done = 0;
  __syncthreads();
  if (threadIdx.x >= 128) {                        // the producer
    if (threadIdx.x == 128) {
      int it = 0;
      while (siren_produce_pass_stream(mp, sa.m.n_layers, sa.m.width,
                                       s.ring, s.full, s.empty, n_stages, it,
                                       done)) {
      }
    }
    return;
  }
  FwdRing r{smem_u32(s.ring), kStreamStageBytes, s.full, s.empty, n_stages,
            0, threadIdx.x == 0};
  ARing ar{smem_u32(s.a), s.a, s.afull, 0};
  siren_march_consume_stream(sa, n_blocks, r, ar, s, &map_slab, dir_rows,
                             done);
}

// The streamed SIREN march's ring (ops/kernels/siren.py::siren_smem_bytes
// mirrors it).
int siren_march_stream_stages() {
  return stream_stages(kInPad, 0, kSirenMarchExtra);
}

// siren_march_kernel_stream at sa.m.width (a streamed width) on `st`, slab the
// [slab_ctas * 64, 2 W] bf16 scratch.
int launch_siren_march_stream(const SirenMarchArgs& sa, int n_rays,
                              const bf16* slab, int slab_ctas,
                              cudaStream_t st) {
  const int W = sa.m.width;
  SirenFwdMaps mp;
  CUtensorMap map_slab;
  if (slab == nullptr || slab_ctas <= 0 ||
      !encode_siren_fwd_maps(&mp, sa.m.wpack, sa.m.n_layers, W) ||
      !encode_bf16_map(&map_slab, slab, slab_ctas * 64, 2 * W, 2 * W, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_stages = siren_march_stream_stages();
  if (n_stages == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      stream_smem_bytes(kInPad, 0, n_stages) + kSirenMarchExtra;
  cudaError_t err = cudaFuncSetAttribute(
      siren_march_kernel_stream, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = n_rays / sa.io.block_rows;
  if (n_blocks > 0)
    siren_march_kernel_stream<<<min(n_blocks, slab_ctas), 256, smem, st>>>(
        mp, map_slab, sa, n_blocks, n_stages);
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

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors validated by the Python wrapper; each launches on `stream` and
// returns cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for
// a shape the kernel does not take.

// The NeRF march: width 64, 128, 192, 256, 384, 512 or a streamed width
// (768 and every multiple of 256 up, with slab, [slab_ctas * 64, 2 width]
// bf16 scratch; null elsewhere) whose packed weights number at most
// kMaxPackedWeights, encodings up to kMaxEnc (256) wide (at width 256 up to 6
// blocks of 64 together), block_rows * chunk_s <= 128 (above 256 chunk_s
// dividing 64 when the step has more than 64 rows); trunk_rows the rows of
// wpack's [rows, width] view (the trunk, w_sigma and w_conn:
// ops/kernels/mlp_train.py::TrainLayout.wpack_views).
extern "C" int fsnerf_ray_march(
    const void* x, const void* dirs, const void* t, const void* deltas,
    const void* mask, const void* wpack, const void* bpack, const void* enc,
    void* stats, void* steps, void* slab, int slab_ctas, int n_rays, int K,
    int block_rows, int chunk_s, int n_layers, int skip_mask, int width,
    int n_freqs, int n_freqs_views, int d_enc_pad, int d_dir_pad,
    int density_act, int trunk_rows, float thresh, void* stream) {
  using namespace fsnerf;
  NerfMarchArgs m;
  fill_args(m.io, x, dirs, t, deltas, mask, stats, steps, K, block_rows,
            chunk_s, thresh);
  m.wpack = static_cast<const bf16*>(wpack);
  m.bpack = static_cast<const float*>(bpack);
  m.enc = static_cast<const float*>(enc);
  m.n_layers = n_layers;
  m.skip_mask = skip_mask;
  m.n_freqs = n_freqs;
  m.n_freqs_views = n_freqs_views;
  m.d_enc_pad = d_enc_pad;
  m.d_dir_pad = d_dir_pad;
  m.density_act = density_act;
  if (d_enc_pad > kMaxEnc || d_dir_pad > kMaxEnc ||
      block_rows * chunk_s > kRows ||
      (width > kWholeMaxWidth && block_rows * chunk_s > 64 &&
       64 % chunk_s != 0) ||
      trunk_rows !=
          trunk_rows_of(n_layers, skip_mask, width, d_enc_pad) + 1 + width ||
      (size_t)trunk_rows * width +
              (size_t)(width + d_dir_pad) * (width / 2) + 3 * (width / 2) >
          kMaxPackedWeights)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (stream_width(width))
    return launch_nerf_march_stream(m, width, trunk_rows, n_rays,
                                    static_cast<const bf16*>(slab),
                                    slab_ctas, st);
  switch (width) {
    case 64:
      return launch_nerf_march_w<64>(m, trunk_rows, n_rays, st);
    case 128:
      return launch_nerf_march_w<128>(m, trunk_rows, n_rays, st);
    case 192:
      return launch_nerf_march_w<192>(m, trunk_rows, n_rays, st);
    case 256:
      return launch_nerf_march_w<256>(m, trunk_rows, n_rays, st);
    case 384:
      return launch_nerf_march_w<384>(m, trunk_rows, n_rays, st);
    case 512:
      return launch_nerf_march_w<512>(m, trunk_rows, n_rays, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The SIREN march: wpack / bpack / alphas as ops/kernels/siren.py packs
// them; the rest (slab at the streamed widths, the packed weights' limit)
// as fsnerf_ray_march.
extern "C" int fsnerf_siren_ray_march(
    const void* x, const void* dirs, const void* t, const void* deltas,
    const void* mask, const void* wpack, const void* bpack,
    const void* alphas, void* stats, void* steps, void* slab, int slab_ctas,
    int n_rays, int K, int block_rows, int chunk_s, int n_layers, int width,
    float thresh, void* stream) {
  using namespace fsnerf;
  SirenMarchArgs sa;
  fill_args(sa.io, x, dirs, t, deltas, mask, stats, steps, K, block_rows,
            chunk_s, thresh);
  sa.m = Siren{static_cast<const bf16*>(wpack),
               static_cast<const float*>(bpack),
               static_cast<const float*>(alphas), n_layers, width};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (siren_n_w(n_layers, width) > kMaxPackedWeights)
    return static_cast<int>(cudaErrorInvalidValue);
  if (block_rows * chunk_s <= kRows) {
    // from 384 up: run as 64-row halves of whole rays
    const bool halves_ok = block_rows * chunk_s <= 64 || 64 % chunk_s == 0;
    if (stream_width(width))
      return halves_ok ? launch_siren_march_stream(
                             sa, n_rays, static_cast<const bf16*>(slab),
                             slab_ctas, st)
                       : static_cast<int>(cudaErrorInvalidValue);
    switch (width) {
      case 64:
        return launch_siren_march_w<64>(sa, n_rays, st);
      case 128:
        return launch_siren_march_w<128>(sa, n_rays, st);
      case 192:
        return launch_siren_march_w<192>(sa, n_rays, st);
      case 256:
        return launch_siren_march_w<256>(sa, n_rays, st);
      case 384:
      case 512:
        if (!halves_ok) return static_cast<int>(cudaErrorInvalidValue);
        return width == 384 ? launch_siren_march_w<384>(sa, n_rays, st)
                            : launch_siren_march_w<512>(sa, n_rays, st);
      default:
        break;
    }
  }
  SirenMarch::Params mp;
  mp.mlp = sa.m;
  return launch_march<SirenMarch>(sa.io, mp, n_rays, stream);
}

// The ring of stages siren_march_kernel launches with at a packed width
// (its launcher's arithmetic), or 0 where that width has no such instance.
extern "C" int fsnerf_siren_march_stages(int width) {
  using namespace fsnerf;
  if (stream_width(width)) return siren_march_stream_stages();
  switch (width) {
    case 64:
    case 128:
    case 192:
    case 256:
    case 384:
    case 512:
      return fwd_stages(width, kInPad, 0, kSirenMarchExtra);
    default:
      return 0;
  }
}

extern "C" const char* fsnerf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
