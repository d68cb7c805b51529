// NeRF MLP training kernels for Hopper (sm_90a): the forward with the
// positional encoding inside (optionally streaming the trunk activations to
// HBM) and the backward to bf16 weight and bias gradients.
//
// Replaces fsnerf_tpu/ops/pallas/mlp_train.py::make_fused_train_mlp, whose
// custom VJP runs two Pallas TPU kernels: fwd_call (the forward, kernel
// mlp_train_fwd_kernel here) and bwd_call (the backward, the three kernels
// mlp_train_bwd_rows_kernel here, then dw_tiles_kernel and dw_reduce_kernel
// of train_common.cuh). Plain PyTorch twins:
// fsnerf_tpu_torch/ops/kernels/mlp_train.py::mlp_train_fwd_reference /
// mlp_train_bwd_reference.
//
// What bounds them on this card: the GEMMs. A sample costs ~1.2 MFLOP
// forward and ~2.4 MFLOP backward (the head recompute, the input-cotangent
// products and the weight-gradient products) against ~10 KB of HBM traffic
// per sample in the backward, so all of it is compute-bound; the tensor
// cores run mma.sync m16n8k16 bf16 with f32 accumulation, as the ray march.
//
// What the design does about the TPU kernels' sequential grid. The Pallas
// backward keeps every weight-gradient block resident in VMEM across a
// sequential grid and adds each row block into it. CUDA blocks run in no
// order, and float atomics would make the gradients change from run to run.
// So the backward is split:
//   1. mlp_train_bwd_rows_kernel, row-parallel (128 rows per CTA): encodes
//      the inputs, takes the trunk activations from the forward's stream
//      (saved mode) or recomputes them and writes that stream itself
//      (recompute mode), recomputes the heads, and walks the layers back.
//      It writes every GEMM operand a weight gradient needs to HBM as bf16
//      (the encodings, feat, branch activation and each layer's bf16
//      cotangent) and each CTA's column sums of the f32 cotangents (the
//      bias-gradient partials).
//   2. dw_tiles_kernel: dW = X^T dY for every weight matrix, one CTA per
//      (64 x 64 output tile, split of rows), the rows of its split in a
//      fixed order; each split writes its own f32 partial.
//   3. dw_reduce_kernel: sums the partials of each gradient in a fixed
//      order and rounds to bf16, as the TPU kernel's caller does.
// Nothing is summed in an order that depends on scheduling, so two runs give
// bitwise-equal gradients, and both backward modes give bitwise-equal
// gradients (the activations they read are the same bits, and all other
// work is the same code).
//
// Numerics, as the TPU kernels (mlp_train.py::_fwd_compute, _bwd_grads):
// bf16 operands, f32 accumulation, bf16-rounded biases added in f32, trunk
// activations ReLU then bf16, feat bf16 without activation, branch ReLU then
// bf16, rgb an f32 sigmoid, sigma raw. Each cotangent is rounded to bf16
// before it enters a product; ReLU' is read from the bf16 activation being
// > 0; bias gradients are column sums of the f32 cotangents; at a skip layer
// the cotangent flows back only through W_h (the encoding gets none).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "train_common.cuh"

namespace fsnerf {
namespace {

struct TrainArgs {
  const float* x;        // [N, 3] sample points
  const float* d;        // [N, 3] view directions
  const bf16* wpack;     // packed [in, out] weights (ops/kernels/render.py)
  const float* bpack;    // packed biases (bf16-rounded values)
  const bf16* wtpack;    // [out, in] weights of the input-cotangent products
  const float* enc;      // [2F + 2Fv]: freq_x, mask_x, freq_d, mask_d
  float* out;            // [N, 4] rgb, sigma
  bf16* acts;            // [N_pad, L*W] trunk activations, or null
  const float* dout;     // [N, 4] output cotangent
  bf16* xs;              // [N_pad, XW]: encx | encd | feat | br
  bf16* dy;              // [N_pad, DYW]: dY_0..L-1 | conn | branch | sigma | rgb
  float* pbias;          // [N_pad / kRows, NB] bias-gradient partials
  int N, n_layers, skip_mask, width, n_freqs, n_freqs_views;
  int d_enc_pad, d_dir_pad, recompute;
};

// Offset of trunk layer i's first matrix in wpack (the walk of
// ops/kernels/render.py::pack_weights); i = n_layers gives the heads.
__host__ __device__ __forceinline__ size_t trunk_offset(const TrainArgs& a,
                                                      int i) {
  const int W = a.width, DE = a.d_enc_pad;
  if (i == 0) return 0;
  size_t off = (size_t)DE * W;
  for (int k = 1; k < i; ++k)
    off += (size_t)W * W + (((a.skip_mask >> k) & 1) ? (size_t)DE * W : 0);
  return off;
}

// Shared-memory carve-up common to the forward and the backward row kernel.
struct Smem {
  bf16 *buf0, *buf1, *encx, *encd, *slabs;
  float *xin, *din, *sig, *rgb, *drgb, *dsig, *colpart;
  int LDH, LDE, LDD;
};

__device__ __forceinline__ Smem carve(unsigned char* raw, const TrainArgs& a) {
  Smem s;
  s.LDH = a.width + kPad;
  s.LDE = a.d_enc_pad + kPad;
  s.LDD = a.d_dir_pad + kPad;
  s.buf0 = reinterpret_cast<bf16*>(raw);
  s.buf1 = s.buf0 + kRows * s.LDH;
  s.encx = s.buf1 + kRows * s.LDH;
  s.encd = s.encx + kRows * s.LDE;
  s.slabs = s.encd + kRows * s.LDD;
  s.xin = reinterpret_cast<float*>(s.slabs + 2 * kSlabRows * kSlabLd);
  s.din = s.xin + 3 * kRows;
  s.sig = s.din + 3 * kRows;
  s.rgb = s.sig + kRows;
  s.drgb = s.rgb + 3 * kRows;
  s.dsig = s.drgb + 3 * kRows;
  s.colpart = s.dsig + kRows;              // [4][width]
  return s;
}

size_t smem_bytes(int width, int d_enc_pad, int d_dir_pad) {
  return sizeof(bf16) * ((size_t)kRows * (2 * width + d_enc_pad + d_dir_pad +
                                          4 * kPad) +
                         2 * kSlabRows * kSlabLd) +
         sizeof(float) * (14 * kRows + 4 * (size_t)width);
}

// Rows r0 .. r0+127 of x and d into shared memory (zeros past N), then
// their encodings as bf16.
__device__ void stage_and_encode(const TrainArgs& a, const Smem& s, int r0) {
  const int tid = threadIdx.x;
  for (int e = tid; e < 3 * kRows; e += kThreads) {
    const bool in = r0 + e / 3 < a.N;
    s.xin[e] = in ? a.x[(size_t)r0 * 3 + e] : 0.f;
    s.din[e] = in ? a.d[(size_t)r0 * 3 + e] : 0.f;
  }
  __syncthreads();
  const float* freq_x = a.enc;
  const float* mask_x = freq_x + a.n_freqs;
  const float* freq_d = mask_x + a.n_freqs;
  const float* mask_d = freq_d + a.n_freqs_views;
  const int DE = a.d_enc_pad, DD = a.d_dir_pad;
  for (int e = tid; e < kRows * DE; e += kThreads) {
    const int row = e / DE, col = e - row * DE;
    s.encx[row * s.LDE + col] = __float2bfloat16_rn(
        encode_lane(s.xin + 3 * row, col, a.n_freqs, freq_x, mask_x));
  }
  for (int e = tid; e < kRows * DD; e += kThreads) {
    const int row = e / DD, col = e - row * DD;
    s.encd[row * s.LDD + col] = __float2bfloat16_rn(
        encode_lane(s.din + 3 * row, col, a.n_freqs_views, freq_d, mask_d));
  }
  __syncthreads();
}

// The trunk forward on the encoded rows; streams each activation to `acts`
// when given. Returns the buffer holding the last activation.
__device__ bf16* trunk_forward(const TrainArgs& a, const Smem& s, int r0,
                               bf16* acts) {
  const int W = a.width, DE = a.d_enc_pad, LA = a.n_layers * W;
  const bf16* w = a.wpack;
  const float* b = a.bpack;
  bf16* hin = nullptr;
  bf16* hout = s.buf0;
  const Seg none = {nullptr, 0, nullptr, 0};
  for (int i = 0; i < a.n_layers; ++i) {
    if (i == 0) {
      gemm_layer(Seg{s.encx, s.LDE, w, DE}, none, b, W, true, hout, s.LDH,
                 s.slabs);
      w += DE * W;
    } else if ((a.skip_mask >> i) & 1) {
      gemm_layer(Seg{hin, s.LDH, w, W}, Seg{s.encx, s.LDE, w + W * W, DE}, b,
                 W, true, hout, s.LDH, s.slabs);
      w += W * W + DE * W;
    } else {
      gemm_layer(Seg{hin, s.LDH, w, W}, none, b, W, true, hout, s.LDH,
                 s.slabs);
      w += W * W;
    }
    b += W;
    __syncthreads();
    if (acts) rows_to_global(hout, s.LDH, acts, LA, r0, i * W, W);
    hin = hout;
    hout = (hout == s.buf0) ? s.buf1 : s.buf0;
  }
  return hin;
}

// feat = bf16(h_last @ w_conn + b_conn) into `other`; then
// br = bf16(relu(feat @ w_branch_h + encd @ w_branch_d + b_branch)) into
// hl (h_last is dead by then); then rgb = sigmoid(br @ w_rgb + b_rgb) into
// s.rgb. With `xs`, feat and br also go to HBM for the weight gradients.
__device__ void heads_forward(const TrainArgs& a, const Smem& s, int r0,
                              bf16* hl, bf16* other, bf16* xs, int XW) {
  const int W = a.width, Wh = W / 2, DE = a.d_enc_pad, DD = a.d_dir_pad;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const Seg none = {nullptr, 0, nullptr, 0};
  const bf16* w = a.wpack + trunk_offset(a, a.n_layers) + W;   // past w_sigma
  const float* b = a.bpack + a.n_layers * W + 1;               // past b_sigma
  gemm_layer(Seg{hl, s.LDH, w, W}, none, b, W, false, other, s.LDH, s.slabs);
  w += W * W;
  b += W;
  __syncthreads();
  if (xs) rows_to_global(other, s.LDH, xs, XW, r0, DE + DD, W);
  gemm_layer(Seg{other, s.LDH, w, W}, Seg{s.encd, s.LDD, w + W * Wh, DD}, b,
             Wh, true, hl, s.LDH, s.slabs);
  w += W * Wh + DD * Wh;
  b += Wh;
  __syncthreads();
  if (xs) rows_to_global(hl, s.LDH, xs, XW, r0, DE + DD + W, Wh);
  for (int row = warp; row < kRows; row += kThreads / 32) {
    const bf16* h = hl + row * s.LDH;
    float v0 = 0.f, v1 = 0.f, v2 = 0.f;
    for (int k = lane; k < Wh; k += 32) {
      const float hv = __bfloat162float(h[k]);
      v0 += hv * __bfloat162float(w[3 * k]);
      v1 += hv * __bfloat162float(w[3 * k + 1]);
      v2 += hv * __bfloat162float(w[3 * k + 2]);
    }
    v0 = warp_sum(v0) + b[0];
    v1 = warp_sum(v1) + b[1];
    v2 = warp_sum(v2) + b[2];
    if (lane == 0) {
      s.rgb[3 * row] = 1.f / (1.f + expf(-v0));
      s.rgb[3 * row + 1] = 1.f / (1.f + expf(-v1));
      s.rgb[3 * row + 2] = 1.f / (1.f + expf(-v2));
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
    mlp_train_fwd_kernel(TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem s = carve(smem_raw, a);
  const int W = a.width, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r0 = blockIdx.x * kRows;
  stage_and_encode(a, s, r0);
  bf16* hl = trunk_forward(a, s, r0, a.acts);
  // sigma head from h_last: a warp per row, lanes across k
  const bf16* w_sigma = a.wpack + trunk_offset(a, a.n_layers);
  const float b_sigma = a.bpack[a.n_layers * W];
  for (int row = warp; row < kRows; row += kThreads / 32) {
    const bf16* h = hl + row * s.LDH;
    float v = 0.f;
    for (int k = lane; k < W; k += 32)
      v += __bfloat162float(h[k]) * __bfloat162float(w_sigma[k]);
    v = warp_sum(v) + b_sigma;
    if (lane == 0) s.sig[row] = v;
  }
  heads_forward(a, s, r0, hl, hl == s.buf0 ? s.buf1 : s.buf0, nullptr, 0);
  for (int e = threadIdx.x; e < 4 * kRows; e += kThreads) {
    const int row = e >> 2, c = e & 3;
    if (r0 + row < a.N)
      a.out[(size_t)r0 * 4 + e] = c < 3 ? s.rgb[3 * row + c] : s.sig[row];
  }
}

// The backward layer epilogue: v = acc (+ dsig[row] * w_sigma[col]),
// v = 0 where the activation already in C is not > 0 (ReLU'), C = bf16(v)
// in place, and this warp's column sums of the f32 v into
// colpart[warp row group][col] (fixed-order adds and shuffles).
struct CotangentEpi {
  bf16* C;
  int ldc;
  bool mask;
  const float* dsig;       // null: no rank-1 term
  const bf16* w_sigma;
  float* colpart;
  int width;
  __device__ __forceinline__ void operator()(int row, int col,
                                             const float (&c)[2][4]) const {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 16 * i + 8 * h;
        float v0 = c[i][2 * h], v1 = c[i][2 * h + 1];
        if (dsig) {
          const float ds = dsig[r];
          v0 += ds * __bfloat162float(w_sigma[col]);
          v1 += ds * __bfloat162float(w_sigma[col + 1]);
        }
        __nv_bfloat162* p =
            reinterpret_cast<__nv_bfloat162*>(C + r * ldc + col);
        if (mask) {
          const __nv_bfloat162 hv = *p;
          if (!(__bfloat162float(hv.x) > 0.f)) v0 = 0.f;
          if (!(__bfloat162float(hv.y) > 0.f)) v1 = 0.f;
        }
        *p = __floats2bfloat162_rn(v0, v1);
        s0 += v0;
        s1 += v1;
      }
    }
    warp_colsums(s0, s1, colpart, width, col);
  }
};

__global__ void __launch_bounds__(kThreads, 1)
    mlp_train_bwd_rows_kernel(TrainArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const Smem s = carve(smem_raw, a);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int W = a.width, Wh = W / 2, L = a.n_layers;
  const int DE = a.d_enc_pad, DD = a.d_dir_pad;
  const int XW = DE + DD + W + Wh, DYW = L * W + W + Wh + 16, LA = L * W;
  const int NB = L * W + 1 + W + Wh + 3;
  const int off_sigma = L * W, off_conn = L * W + 1;
  const int off_branch = off_conn + W, off_rgb = off_branch + Wh;
  const int dy_conn = L * W, dy_branch = dy_conn + W;
  const int dy_sigma = dy_branch + Wh, dy_rgb = dy_sigma + 8;
  const int r0 = blockIdx.x * kRows;
  float* pb = a.pbias + (size_t)blockIdx.x * NB;

  stage_and_encode(a, s, r0);
  rows_to_global(s.encx, s.LDE, a.xs, XW, r0, 0, DE);
  rows_to_global(s.encd, s.LDD, a.xs, XW, r0, DE, DD);
  bf16* hl;
  if (a.recompute) {
    hl = trunk_forward(a, s, r0, a.acts);
  } else {
    rows_from_global(a.acts, LA, r0, (L - 1) * W, s.buf0, s.LDH, W);
    __syncthreads();
    hl = s.buf0;
  }
  bf16* other = hl == s.buf0 ? s.buf1 : s.buf0;
  heads_forward(a, s, r0, hl, other, a.xs, XW);

  // rgb head: d rgb_pre = d rgb * r (1 - r); sigma: d sigma as it is
  if (tid < kRows) {
    const int g = r0 + tid;
    for (int c = 0; c < 3; ++c) {
      const float r = s.rgb[3 * tid + c];
      const float dv = g < a.N ? a.dout[(size_t)g * 4 + c] : 0.f;
      s.drgb[3 * tid + c] = dv * r * (1.f - r);
    }
    s.dsig[tid] = g < a.N ? a.dout[(size_t)g * 4 + 3] : 0.f;
  }
  __syncthreads();
  if (warp < 4) {            // b_rgb (3) and b_sigma (1): one warp each
    float v = 0.f;
    for (int row = lane; row < kRows; row += 32)
      v += warp < 3 ? s.drgb[3 * row + warp] : s.dsig[row];
    v = warp_sum(v);
    if (lane == 0) pb[warp < 3 ? off_rgb + warp : off_sigma] = v;
  }
  __syncthreads();
  if (tid < kRows) {         // bf16 cotangents of the two narrow heads
    bf16* dr = a.dy + (size_t)(r0 + tid) * DYW;
    for (int c = 0; c < 8; ++c) {
      const float v = c < 3 ? s.drgb[3 * tid + c] : 0.f;
      const bf16 vb = __float2bfloat16_rn(v);
      dr[dy_rgb + c] = vb;
      if (c < 3) s.drgb[3 * tid + c] = __bfloat162float(vb);
      dr[dy_sigma + c] = __float2bfloat16_rn(c == 0 ? s.dsig[tid] : 0.f);
    }
    s.dsig[tid] = __bfloat162float(__float2bfloat16_rn(s.dsig[tid]));
  }
  __syncthreads();
  // branch: d br = (d rgb_b @ w_rgb^T) * (br > 0), one column per thread,
  // rows in order, in place over br
  const bf16* w_rgb = a.wpack + trunk_offset(a, L) + W + W * W + W * Wh +
                      DD * Wh;
  for (int j = tid; j < Wh; j += kThreads) {
    const float w0 = __bfloat162float(w_rgb[3 * j]);
    const float w1 = __bfloat162float(w_rgb[3 * j + 1]);
    const float w2 = __bfloat162float(w_rgb[3 * j + 2]);
    float colsum = 0.f;
    for (int row = 0; row < kRows; ++row) {
      const float* dr = s.drgb + 3 * row;
      float v = dr[0] * w0 + dr[1] * w1 + dr[2] * w2;
      bf16* p = hl + row * s.LDH + j;
      if (!(__bfloat162float(*p) > 0.f)) v = 0.f;
      colsum += v;
      *p = __float2bfloat16_rn(v);
    }
    pb[off_branch + j] = colsum;
  }
  __syncthreads();
  rows_to_global(hl, s.LDH, a.dy, DYW, r0, dy_branch, Wh);

  // conn: d feat = d br_b @ w_branch_h^T (feat has no activation)
  const bf16* wt = a.wtpack;
  const bf16* wt_conn = wt + (size_t)(L - 1) * W * W;
  const bf16* wt_bh = wt_conn + (size_t)W * W;
  const Seg none = {nullptr, 0, nullptr, 0};
  CotangentEpi epi{other, s.LDH, false, nullptr, nullptr, s.colpart, W};
  gemm(Seg{hl, s.LDH, wt_bh, Wh}, none, W, s.slabs, epi);
  __syncthreads();
  store_colsums(s.colpart, pb, off_conn, W, W);
  rows_to_global(other, s.LDH, a.dy, DYW, r0, dy_conn, W);

  // last trunk layer: d h = d feat_b @ w_conn^T + d sigma_b w_sigma^T,
  // masked by h_{L-1} > 0, which is loaded into the output buffer first
  rows_from_global(a.acts, LA, r0, (L - 1) * W, hl, s.LDH, W);
  __syncthreads();
  epi = CotangentEpi{hl, s.LDH, true, s.dsig,
                     a.wpack + trunk_offset(a, L), s.colpart, W};
  gemm(Seg{other, s.LDH, wt_conn, W}, none, W, s.slabs, epi);
  __syncthreads();
  store_colsums(s.colpart, pb, (L - 1) * W, W, W);
  rows_to_global(hl, s.LDH, a.dy, DYW, r0, (L - 1) * W, W);

  // trunk: d h_{i-1} = d h_i_b @ W_i^T (the h part at a skip layer)
  bf16* cur = hl;
  bf16* nxt = other;
  for (int i = L - 1; i >= 1; --i) {
    rows_from_global(a.acts, LA, r0, (i - 1) * W, nxt, s.LDH, W);
    __syncthreads();
    epi = CotangentEpi{nxt, s.LDH, true, nullptr, nullptr, s.colpart, W};
    gemm(Seg{cur, s.LDH, wt + (size_t)(i - 1) * W * W, W}, none, W, s.slabs,
         epi);
    __syncthreads();
    store_colsums(s.colpart, pb, (i - 1) * W, W, W);
    rows_to_global(nxt, s.LDH, a.dy, DYW, r0, (i - 1) * W, W);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
}

void fill_args(TrainArgs& a, const void* x, const void* d, const void* wpack,
               const void* bpack, const void* enc, int n, int n_layers,
               int skip_mask, int width, int n_freqs, int n_freqs_views,
               int d_enc_pad, int d_dir_pad) {
  a = TrainArgs{};
  a.x = static_cast<const float*>(x);
  a.d = static_cast<const float*>(d);
  a.wpack = static_cast<const bf16*>(wpack);
  a.bpack = static_cast<const float*>(bpack);
  a.enc = static_cast<const float*>(enc);
  a.N = n;
  a.n_layers = n_layers;
  a.skip_mask = skip_mask;
  a.width = width;
  a.n_freqs = n_freqs;
  a.n_freqs_views = n_freqs_views;
  a.d_enc_pad = d_enc_pad;
  a.d_dir_pad = d_dir_pad;
}

}  // namespace
}  // namespace fsnerf

// Plain C entries for ctypes. Pointers are device pointers of contiguous
// tensors validated by the Python wrapper (ops/kernels/mlp_train.py), which
// also allocates every output and scratch buffer. Each launches on `stream`
// and returns cudaGetLastError() (0 = launched).

// out [n, 4]; acts [round_up(n, 128), n_layers * width] or null.
extern "C" int fsnerf_mlp_train_fwd(
    const void* x, const void* d, const void* wpack, const void* bpack,
    const void* enc, void* out, void* acts, int n, int n_layers,
    int skip_mask, int width, int n_freqs, int n_freqs_views, int d_enc_pad,
    int d_dir_pad, void* stream) {
  using namespace fsnerf;
  TrainArgs a;
  fill_args(a, x, d, wpack, bpack, enc, n, n_layers, skip_mask, width,
            n_freqs, n_freqs_views, d_enc_pad, d_dir_pad);
  a.out = static_cast<float*>(out);
  a.acts = static_cast<bf16*>(acts);
  const size_t smem = smem_bytes(width, d_enc_pad, d_dir_pad);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_blocks = (n + kRows - 1) / kRows;
  if (n_blocks > 0)
    mlp_train_fwd_kernel<<<n_blocks, kThreads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// dw [n_w], db [n_b]: bf16-rounded gradients in the wpack / bpack layouts.
// acts is read (recompute = 0) or written (recompute = 1); xs, dy, pbias
// and part are scratch of the shapes documented in TrainArgs and
// train_common.cuh::dw_tiles_kernel; jobs [n_jobs, 6] and tiles [n_tiles,
// 3] int32.
extern "C" int fsnerf_mlp_train_bwd(
    const void* x, const void* d, const void* dout, const void* wpack,
    const void* bpack, const void* wtpack, const void* enc, void* acts,
    int recompute, void* xs, void* dy, void* pbias, const void* jobs,
    const void* tiles, int n_tiles, void* part, int split_rows, void* dw,
    void* db, int n, int n_layers, int skip_mask, int width, int n_freqs,
    int n_freqs_views, int d_enc_pad, int d_dir_pad, void* stream) {
  using namespace fsnerf;
  TrainArgs a;
  fill_args(a, x, d, wpack, bpack, enc, n, n_layers, skip_mask, width,
            n_freqs, n_freqs_views, d_enc_pad, d_dir_pad);
  a.wtpack = static_cast<const bf16*>(wtpack);
  a.acts = static_cast<bf16*>(acts);
  a.dout = static_cast<const float*>(dout);
  a.xs = static_cast<bf16*>(xs);
  a.dy = static_cast<bf16*>(dy);
  a.pbias = static_cast<float*>(pbias);
  a.recompute = recompute;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_blocks = (n + kRows - 1) / kRows;
  if (n_blocks == 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = smem_bytes(width, d_enc_pad, d_dir_pad);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_train_bwd_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_train_bwd_rows_kernel<<<n_blocks, kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int Wh = width / 2;
  const int n_w = (int)(trunk_offset(a, n_layers)) + width + width * width +
                  width * Wh + d_dir_pad * Wh + Wh * 3;
  const int n_b = n_layers * width + 1 + width + Wh + 3;
  return static_cast<int>(launch_dw(
      static_cast<const bf16*>(acts), n_layers * width,
      static_cast<const bf16*>(xs), d_enc_pad + d_dir_pad + width + Wh,
      static_cast<const bf16*>(dy), n_layers * width + width + Wh + 16,
      static_cast<const int*>(tiles), n_tiles, static_cast<const int*>(jobs),
      static_cast<float*>(part), n_w, split_rows,
      static_cast<const float*>(pbias), n_blocks, n_b, 1,
      static_cast<float*>(dw), static_cast<float*>(db), st));
}
