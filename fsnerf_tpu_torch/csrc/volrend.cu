// Forward volume compositing over precomputed densities and colours for
// Hopper (sm_90a): per ray, od = sigma * delta (0 where masked), alpha =
// 1 - exp(-od), the exclusive transmittance exp(-(cumsum(od) - od)), the
// weights w = T * alpha, and the ray's rgb = sum w rgb, opacity = sum w,
// depth = sum w t and trans_final = exp(-sum od). The background is
// blended by the caller.
//
// Replaces fsnerf_tpu/ops/pallas/volrend.py::_volrend_call (reached from
// volume_render_pallas). Plain PyTorch twin:
// fsnerf_tpu_torch/ops/volrend.py::volume_render.
//
// Written for this card, not block by block as the TPU kernel: that one
// took seven [R, S] f32 planes (rgb split into three, the mask as floats)
// because a [R, S, 3] block wastes the TPU's 128-wide lanes. Here a warp
// owns a ray and its lanes walk the samples in chunks of 32: each lane
// reads its sample's sigma, delta, t and mask (a bool per sample, or none)
// and its three colours where they lie (a sample stride, so the [R, S, 4]
// output of the MLP is read in place), an inclusive __shfl_up_sync scan
// gives the optical depth within the chunk and a carry across chunks, the
// lane writes its weight and keeps partial sums of w rgb, w and w t, and
// shuffles reduce those at the end. Any R, any S. Bytes-bound: ~29 bytes
// per sample moved, a few dozen flops.
//
// Numerics: the products and sums that feed exp use the _rn intrinsics (no
// FMA contraction) and expf, as the compositing of render.cu does; the
// scan adds in another order than a sequential cumsum, which moves the
// optical depth by a few ulps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace fsnerf {
namespace {

constexpr int kWarps = 8;     // rays per CTA

struct VolrendArgs {
  const float* sig;           // sample (r, s) at sig[(r S + s) sig_stride]
  const float* rgb;           // colour c at rgb[(r S + s) rgb_stride + c]
  const float* t;             // [R, S]
  const float* delta;         // [R, S]
  const uint8_t* mask;        // [R, S] bool, or null: every sample valid
  float* stats;               // [R, 8]: rgb, opacity, depth, trans_final, 0, 0
  float* weights;             // [R, S]
  int sig_stride, rgb_stride, R, S;
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(32 * kWarps) volrend_kernel(VolrendArgs a) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (ray >= a.R) return;     // whole warps leave together
  const size_t base = (size_t)ray * a.S;
  float carry = 0.f;          // optical depth of the chunks before
  float r0 = 0.f, r1 = 0.f, r2 = 0.f, op = 0.f, dp = 0.f;
  for (int s0 = 0; s0 < a.S; s0 += 32) {
    const bool in = s0 + lane < a.S;
    const size_t i = base + s0 + lane;
    float od = 0.f;
    if (in && (a.mask == nullptr || a.mask[i]))
      od = __fmul_rn(a.sig[i * a.sig_stride], a.delta[i]);
    float cum = od;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, cum, o);
      if (lane >= o) cum = __fadd_rn(cum, v);
    }
    cum = __fadd_rn(carry, cum);
    carry = __shfl_sync(0xffffffffu, cum, 31);
    if (in) {
      const float w = __fmul_rn(expf(-__fsub_rn(cum, od)),
                                __fsub_rn(1.f, expf(-od)));
      a.weights[i] = w;
      const float* c = a.rgb + i * a.rgb_stride;
      r0 += w * c[0];
      r1 += w * c[1];
      r2 += w * c[2];
      op += w;
      dp += w * a.t[i];
    }
  }
  r0 = warp_sum(r0);
  r1 = warp_sum(r1);
  r2 = warp_sum(r2);
  op = warp_sum(op);
  dp = warp_sum(dp);
  if (lane == 0) {
    float4* st = reinterpret_cast<float4*>(a.stats + (size_t)ray * 8);
    st[0] = make_float4(r0, r1, r2, op);
    st[1] = make_float4(dp, expf(-carry), 0.f, 0.f);
  }
}

}  // namespace
}  // namespace fsnerf

// Plain C entry for ctypes. Pointers are device pointers validated by the
// Python wrapper (ops/kernels/volrend.py::volume_render_fused); mask may be
// null. Launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fsnerf_volrend(const void* sig, int sig_stride,
                              const void* rgb, int rgb_stride, const void* t,
                              const void* delta, const void* mask,
                              void* stats, void* weights, int n_rays,
                              int n_samples, void* stream) {
  using namespace fsnerf;
  VolrendArgs a;
  a.sig = static_cast<const float*>(sig);
  a.rgb = static_cast<const float*>(rgb);
  a.t = static_cast<const float*>(t);
  a.delta = static_cast<const float*>(delta);
  a.mask = static_cast<const uint8_t*>(mask);
  a.stats = static_cast<float*>(stats);
  a.weights = static_cast<float*>(weights);
  a.sig_stride = sig_stride;
  a.rgb_stride = rgb_stride;
  a.R = n_rays;
  a.S = n_samples;
  const int n_blocks = (n_rays + kWarps - 1) / kWarps;
  if (n_blocks > 0)
    volrend_kernel<<<n_blocks, 32 * kWarps, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
