// sin/cos by Cody-Waite range reduction + minimax polynomials: the device
// twin of fsnerf_tpu_torch/ops/kernels/fastmath.py::sincos_fast, itself a
// verbatim port of fsnerf_tpu/ops/pallas/fastmath.py::_sincos_fast.
//
// Why not __sinf: positional-encoding arguments reach |2^9 x| ~ 770, and
// __sinf's error bound holds only on [-pi, pi]. This reduction is exact for
// |x| <~ 1e4 and the polynomials stay within ~7e-5 (sin) / ~1.3e-5 (cos).
//
// Every step uses the _rn intrinsics so nvcc cannot contract a multiply and
// an add into an FMA: the kernel then rounds exactly as the eager PyTorch
// twin does, step for step. rintf rounds half to even, as torch.round.
#pragma once

namespace fsnerf {

struct Reduced {
  float r2, r, sign;
};

__device__ __forceinline__ Reduced reduce_pi(float x) {
  const float k = rintf(__fmul_rn(x, 0.3183098861837907f));        // 1/pi
  float r = __fsub_rn(x, __fmul_rn(k, 3.140625f));                 // 8-bit head
  r = __fsub_rn(r, __fmul_rn(k, 9.67653589793e-4f));               // correction
  const float km = __fsub_rn(k, __fmul_rn(2.0f, floorf(__fmul_rn(k, 0.5f))));
  Reduced out;
  out.sign = __fsub_rn(1.0f, __fmul_rn(2.0f, km));                 // (-1)^k
  out.r = r;
  out.r2 = __fmul_rn(r, r);
  return out;
}

__device__ __forceinline__ float sin_fast(float x) {
  const Reduced q = reduce_pi(x);
  const float p = __fadd_rn(9.99696825e-1f,
      __fmul_rn(q.r2, __fadd_rn(-1.65673162e-1f,
                                __fmul_rn(q.r2, 7.51440369e-3f))));
  return __fmul_rn(q.sign, __fmul_rn(q.r, p));
}

__device__ __forceinline__ float cos_fast(float x) {
  const Reduced q = reduce_pi(x);
  float p = __fadd_rn(-1.388731625e-3f, __fmul_rn(q.r2, 2.443315711e-5f));
  p = __fadd_rn(4.166664568e-2f, __fmul_rn(q.r2, p));
  p = __fadd_rn(-0.5f, __fmul_rn(q.r2, p));
  p = __fadd_rn(1.0f, __fmul_rn(q.r2, p));
  return __fmul_rn(q.sign, p);
}

// sin_fast(x) and, with kCos, cos_fast(x) (into *c) from one range
// reduction, the sign (-1)^k applied by flipping the sign bit from k's
// parity: bitwise the two functions' results (k is an integer of magnitude
// below 2^24 there, so k - 2 floor(k / 2) is its parity exactly, and the
// product by +-1 is a sign flip), in fewer instructions (the SIREN
// kernels' sine epilogues).
template <bool kCos>
__device__ __forceinline__ float sin_cos_fast(float x, float* c) {
  const float k = rintf(__fmul_rn(x, 0.3183098861837907f));
  float r = __fsub_rn(x, __fmul_rn(k, 3.140625f));
  r = __fsub_rn(r, __fmul_rn(k, 9.67653589793e-4f));
  const int flip = (__float2int_rn(k) & 1) << 31;
  const float r2 = __fmul_rn(r, r);
  if (kCos) {
    float p = __fadd_rn(-1.388731625e-3f, __fmul_rn(r2, 2.443315711e-5f));
    p = __fadd_rn(4.166664568e-2f, __fmul_rn(r2, p));
    p = __fadd_rn(-0.5f, __fmul_rn(r2, p));
    p = __fadd_rn(1.0f, __fmul_rn(r2, p));
    *c = __int_as_float(__float_as_int(p) ^ flip);
  }
  const float p = __fadd_rn(9.99696825e-1f,
      __fmul_rn(r2, __fadd_rn(-1.65673162e-1f,
                              __fmul_rn(r2, 7.51440369e-3f))));
  return __int_as_float(__float_as_int(__fmul_rn(r, p)) ^ flip);
}

}  // namespace fsnerf
