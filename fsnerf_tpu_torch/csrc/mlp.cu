// Forward NeRF MLP on pre-encoded features for Hopper (sm_90a): the 8x256
// trunk with its skip, the sigma head, the connection, the view branch and
// the rgb head (nerf_mlp_kernel), and its density pass (trunk and sigma
// head only, nerf_density_kernel), both on the warp-specialized MLP of
// ws_trunk.cuh.
//
// nerf_mlp_kernel replaces fsnerf_tpu/ops/pallas/mlp.py::_fused_call (the
// Pallas TPU kernel reached from fused_nerf_mlp / make_fused_model_fn).
// Plain PyTorch twin: fsnerf_tpu_torch/ops/kernels/mlp.py::
// nerf_mlp_reference.
//
// What bounds it on this card: the GEMMs. A row costs ~1.19 MFLOP of bf16
// products at 8x256 against 208 bytes of HBM traffic (a 64-column and a
// 32-column bf16 encoding in, four floats out), so the kernel is
// compute-bound by three orders of magnitude. What the design does about
// it: the warp-specialized MLP of ws_trunk.cuh (a producer warpgroup
// feeding 64-row weight tiles by TMA through an mbarrier ring, two consumer
// warpgroups of 64 rows on wgmma, every activation in shared memory). The
// encodings are loaded, not computed: each consumer's lead thread loads its
// 64 rows of encx and encd by TMA (boxes of 64 rows x 64 columns,
// 128B-swizzled, the tile layout the products read; rows past N and, for a
// 32-wide encd, the columns past 32 arrive as TMA's zero fill, which no
// k16 step reads). The producer feeds the trunk, w_conn and the branch;
// sigma comes from the last trunk epilogue's quad sums and stays in two
// registers through the connection and the branch, whose epilogue makes
// rgb, and each row's [rgb, sigma] is written once as a float4 (rows past N
// never). Numerics: ws_trunk.cuh's (the TPU kernel's, mlp.py::
// _kernel_body); the encodings arrive already rounded to bf16 (exact f32
// sin/cos and the FreeNeRF band mask applied by the caller), unlike the
// ray march and the train forward, which encode inside with a polynomial
// sin; sigma raw, ReLU or exp(clip(., -15, 15)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ws_trunk.cuh"

namespace fsnerf {
namespace {

struct MlpArgs {
  const bf16* wpack;
  const float* bpack;
  float* out;         // [N, 4]: rgb, sigma (the density pass: [N] sigma)
  int N, n_layers, skip_mask, d_enc_pad, d_dir_pad, density_act;
};

// One CTA's 128 rows: kHeads the whole MLP into out [N, 4], else the
// density pass into out [N] (no view input: d_dir_pad 0, map_br and map_d
// unread). map_x / map_d view encx [N, d_enc_pad] / encd [N, d_dir_pad].
// Block: kFwdConsumers warpgroups + the producer's.
template <int W, bool kHeads>
__device__ __forceinline__ void mlp_rows(const CUtensorMap* map_w,
                                         const CUtensorMap* map_br,
                                         const CUtensorMap* map_x,
                                         const CUtensorMap* map_d,
                                         const MlpArgs& a, int n_stages,
                                         unsigned char* smem_raw) {
  constexpr int NB = W / 2 < 64 ? 64 : W / 2;     // the branch product's N
  unsigned char* ring =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int nbx = enc_blocks(a.d_enc_pad), nbd = enc_blocks(a.d_dir_pad);
  unsigned char* act = ring + n_stages * W * 128;
  unsigned char* encx = act + kFwdConsumers * W * 128;
  unsigned char* encd = encx + kFwdConsumers * nbx * kBlock;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(encd + kFwdConsumers * nbd * kBlock);
  uint64_t* empty = full + n_stages;
  uint64_t* loaded = empty + n_stages;           // each consumer's encodings
  fwd_init_barriers(full, empty, n_stages, loaded, kFwdConsumers);
  __syncthreads();
  const FwdShape sh{a.n_layers, a.skip_mask, a.d_enc_pad, a.d_dir_pad};
  const int wg = threadIdx.x / 128;
  if (wg == kFwdConsumers) {                       // the producer
    setmaxnreg_dec<kFwdProducerRegs>();
    if (threadIdx.x == 128 * kFwdConsumers) {
      int it = 0;
      produce_pass<W, NB>(map_w, map_br, sh, kHeads, ring, full, empty,
                          n_stages, it, nullptr);
    }
    return;
  }
  setmaxnreg_inc<kFwdConsumerRegs>();
  const int t = threadIdx.x & 127, lane = t & 31;
  const int row0 = blockIdx.x * kRows + 64 * wg;
  const int bar = 1 + wg;                           // this warpgroup's barrier
  unsigned char* tx = encx + wg * nbx * kBlock;
  unsigned char* td = encd + wg * nbd * kBlock;
  unsigned char* tile = act + wg * W * 128;
  FwdRing r{smem_u32(ring), W * 128, full, empty, n_stages, 0, t == 0};
  if (r.lead) {
    mbar_arrive_expect_tx(&loaded[wg], (nbx + nbd) * kBlock);
    for (int q = 0; q < nbx; ++q)
      tma_load_2d(tx + q * kBlock, map_x, &loaded[wg], 64 * q, row0);
    for (int q = 0; q < nbd; ++q)
      tma_load_2d(td + q * kBlock, map_d, &loaded[wg], 64 * q, row0);
  }
  mbar_wait(&loaded[wg], 0);
  const int L = a.n_layers;
  const bf16* w_sigma =
      a.wpack + (size_t)trunk_rows_of(L, a.skip_mask, W, a.d_enc_pad) * W;
  const int quad_row = 16 * (t >> 5) + (lane >> 2);
  float sig[2] = {0.f, 0.f};
  {
    float acc[W / 2];
    fwd_trunk<W>(acc, r, tile, smem_u32(tx), sh, a.bpack, w_sigma, sig, bar,
                 nullptr, row0);
    const float b_sigma = a.bpack[L * W];
#pragma unroll
    for (int h = 0; h < 2; ++h)
      sig[h] = density_activate(quad_sum(sig[h]) + b_sigma, a.density_act);
    if (!kHeads) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = row0 + quad_row + 8 * h;
        if ((lane & 3) == 0 && g < a.N) a.out[g] = sig[h];
      }
      return;
    }
    fwd_conn<W>(acc, r, tile, a.bpack + L * W + 1, bar);
  }
  float rgb[2][3];
  fwd_branch<W, NB>(r, tile, smem_u32(td), a.d_dir_pad, w_sigma + W,
                    a.bpack + L * W + 1, rgb);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int g = row0 + quad_row + 8 * h;
    if ((lane & 3) == 0 && g < a.N)
      reinterpret_cast<float4*>(a.out)[g] =
          make_float4(rgb[h][0], rgb[h][1], rgb[h][2], sig[h]);
  }
}

template <int W>
__global__ void __launch_bounds__(kFwdThreads, 1)
    nerf_mlp_kernel(const __grid_constant__ CUtensorMap map_w,
                    const __grid_constant__ CUtensorMap map_br,
                    const __grid_constant__ CUtensorMap map_x,
                    const __grid_constant__ CUtensorMap map_d, MlpArgs a,
                    int n_stages) {
  extern __shared__ unsigned char mlp_smem_raw[];
  mlp_rows<W, true>(&map_w, &map_br, &map_x, &map_d, a, n_stages,
                    mlp_smem_raw);
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
// What the design does about it: nerf_mlp_kernel's rows without the heads
// (the producer feeds only the trunk's matrices, no view encoding is
// loaded) and sigma straight from the last trunk epilogue's quad sums to
// out[N]. Numerics: the trunk's and sigma head's of ws_trunk.cuh; sigma
// raw, ReLU or exp(clip(., -15, 15)).
template <int W>
__global__ void __launch_bounds__(kFwdThreads, 1)
    nerf_density_kernel(const __grid_constant__ CUtensorMap map_w,
                        const __grid_constant__ CUtensorMap map_br,
                        const __grid_constant__ CUtensorMap map_x,
                        const __grid_constant__ CUtensorMap map_d,
                        MlpArgs a, int n_stages) {
  extern __shared__ unsigned char density_smem_raw[];
  mlp_rows<W, false>(&map_w, &map_br, &map_x, &map_d, a, n_stages,
                     density_smem_raw);
}

// nerf_mlp_kernel<W> (kHeads) or nerf_density_kernel<W> on `st`: the
// weight maps (the branch's only with the heads), the encodings' maps and
// the deepest ring that fits.
template <int W, bool kHeads>
cudaError_t launch_mlp_w(const MlpArgs& a, const bf16* encx,
                         const bf16* encd, int trunk_rows, cudaStream_t st) {
  const auto kernel = kHeads ? nerf_mlp_kernel<W> : nerf_density_kernel<W>;
  CUtensorMap map_w, map_br, map_x, map_d;
  if (!encode_weight_maps<W>(&map_w, kHeads ? &map_br : nullptr, a.wpack,
                             trunk_rows, a.d_dir_pad) ||
      !encode_bf16_map(&map_x, encx, a.N, a.d_enc_pad, a.d_enc_pad, 64) ||
      (kHeads &&
       !encode_bf16_map(&map_d, encd, a.N, a.d_dir_pad, a.d_dir_pad, 64)))
    return cudaErrorInvalidValue;
  if (!kHeads) map_br = map_d = map_w;             // unread
  const size_t extra = kFwdConsumers * sizeof(uint64_t);
  const int n_stages = fwd_stages(W, a.d_enc_pad, a.d_dir_pad, extra);
  const size_t smem =
      fwd_smem_bytes(W, a.d_enc_pad, a.d_dir_pad, n_stages) + extra;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<(a.N + kRows - 1) / kRows, kFwdThreads, smem, st>>>(
      map_w, map_br, map_x, map_d, a, n_stages);
  return cudaGetLastError();
}

// Both entries' width dispatch, after their checks.
template <bool kHeads>
int launch_mlp(const MlpArgs& a, int width, const void* encx,
               const void* encd, int trunk_rows, void* stream) {
  if (a.N == 0) return static_cast<int>(cudaGetLastError());
  const bf16* x = static_cast<const bf16*>(encx);
  const bf16* d = static_cast<const bf16*>(encd);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 64:
      return static_cast<int>(
          launch_mlp_w<64, kHeads>(a, x, d, trunk_rows, st));
    case 128:
      return static_cast<int>(
          launch_mlp_w<128, kHeads>(a, x, d, trunk_rows, st));
    case 256:
      return static_cast<int>(
          launch_mlp_w<256, kHeads>(a, x, d, trunk_rows, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace fsnerf

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors validated by the Python wrappers (ops/kernels/mlp.py); each
// launches on `stream` and returns cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape the kernels do not take.

// The forward MLP (ops/kernels/mlp.py::nerf_mlp): out [n_rows, 4]. Takes
// width 64, 128 or 256, d_enc_pad a multiple of 64 and d_dir_pad of 16,
// both up to 128; trunk_rows must be the rows of wpack's [rows, width] view
// (the trunk, w_sigma and w_conn: mlp_train.py::TrainLayout.wpack_views),
// the branch's [width + d_dir_pad, width / 2] view following it.
extern "C" int fsnerf_nerf_mlp(const void* encx, const void* encd,
                               const void* wpack, const void* bpack,
                               void* out, int n_rows, int n_layers,
                               int skip_mask, int width, int d_enc_pad,
                               int d_dir_pad, int density_act,
                               int trunk_rows, void* stream) {
  using namespace fsnerf;
  const MlpArgs a{static_cast<const bf16*>(wpack),
                  static_cast<const float*>(bpack),
                  static_cast<float*>(out),
                  n_rows,
                  n_layers,
                  skip_mask,
                  d_enc_pad,
                  d_dir_pad,
                  density_act};
  if (d_enc_pad % 64 || d_enc_pad > 128 || d_dir_pad % 16 ||
      d_dir_pad > 128 ||
      trunk_rows !=
          trunk_rows_of(n_layers, skip_mask, width, d_enc_pad) + 1 + width)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mlp<true>(a, width, encx, encd, trunk_rows, stream);
}

// The density pass (ops/kernels/mlp.py::nerf_density): the same packed
// weights, walked only through the sigma head; out [n_rows]. Takes width
// 64, 128 or 256 and d_enc_pad a multiple of 64 up to 128; trunk_rows as
// fsnerf_nerf_mlp's.
extern "C" int fsnerf_nerf_density(const void* encx, const void* wpack,
                                   const void* bpack, void* out, int n_rows,
                                   int n_layers, int skip_mask, int width,
                                   int d_enc_pad, int density_act,
                                   int trunk_rows, void* stream) {
  using namespace fsnerf;
  const MlpArgs a{static_cast<const bf16*>(wpack),
                  static_cast<const float*>(bpack),
                  static_cast<float*>(out),
                  n_rows,
                  n_layers,
                  skip_mask,
                  d_enc_pad,
                  0,
                  density_act};
  if (d_enc_pad % 64 || d_enc_pad > 128 ||
      trunk_rows !=
          trunk_rows_of(n_layers, skip_mask, width, d_enc_pad) + 1 + width)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_mlp<false>(a, width, encx, nullptr, trunk_rows, stream);
}
