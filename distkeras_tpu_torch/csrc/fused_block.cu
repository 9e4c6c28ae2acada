// The ResNet bottleneck's fused regions for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernels of distkeras_tpu/ops/fused_block.py:
//   conv_gn_fwd  <- _conv_gn_fwd_kernel (through _conv_gn):
//                   y = [relu](GN(x @ w));
//   conv_gn_bwd  <- _conv_gn_bwd_kernel (through _conv_gn_bwd):
//                   dx, dw, dgamma, dbeta, recomputing the forward;
//   tail_fwd     <- _tail_fwd_kernel (through _tail):
//                   out = relu(GN3(relu(GN2(y2)) @ w3) + res);
//   tail_bwd     <- _tail_bwd_kernel (through _tail_bwd):
//                   dy2, dw, dg2, db2, dg3, db3, dres, recomputing the
//                   forward chain.
// x, y2, res, out: [B, HW, C] rows (bf16 or f32), w [C_in, C_out] in their
// dtype, gamma and beta [C] f32.  The algebra and rounding points are the
// TPU kernels': f32 products; per-group statistics in f32 as E[y^2] -
// E[y]^2 clamped at 0, inv = rsqrt(var + eps); (y - mean) * inv * gamma +
// beta; the strict z > 0 ReLU tests recomputed in the backward; the tail's
// h rounded to the input dtype before its product; the backward's
// raw-input gradient rounded to the input dtype before both products; dw
// summed in f32 over every image.
//
// Bound on the H100.  Per call the products dominate the operations
// (2 * B*HW * C_in * C_out each; the backward recomputes the forward's
// and adds two) and the activations the bytes.  At ResNet-50's shapes the
// bf16 product's intensity (C_in * C_out / (C_in + C_out) operations a
// byte, 32 to 680) sits near or below the card's 295 for its first
// stages, so bytes bound most calls and operations the widest.
//
// Design.  On the TPU each grid step holds one whole image in VMEM, so
// the statistics, the product and the norm run in one pass over it.
// Here a block has at most 227 KB of shared memory and the batch's
// images are too few to fill 132 SMs one by one, so each direction is a
// chain of grids on the caller's stream: an image's GroupNorm statistics
// need all of its rows before anything can be applied.  One chain per
// dtype.
//
// bf16 (the *_tc functions): every product runs on fused_gemm.cuh, one
// wgmma body fed by TMA whose epilogue does the GroupNorm work on the
// accumulators (statistics; the apply, ReLU and residual; xhat, the ReLU
// tests, dz and its sums; dy_raw; the tail's dh behind h's ReLU).  What
// bounds these calls is bytes, so each call follows a pass plan
// (ops/fused_block.py fwd_plan, bwd_plan) whose rule is: write an f32
// intermediate only where that takes less time than recomputing it on
// the tensor cores from its bf16 input.  A forward is P1 (the product's
// statistics), the fold, then either a 16-byte apply pass over the kept
// f32 y (store) or P2, the same product again with the apply in its
// epilogue (recompute).  The tail's backward recomputes y3 = h @ w in
// each of its three passes and keeps dh (4 C_m bytes a row against 2
// C_out to recompute); conv_gn_bwd keeps y where its input is wide.
//
// f32 (the *_f32 functions): the products on CUDA cores (FMA, never
// TF32) into an f32 workspace, then the same 16-byte statistics, apply
// and gradient passes as bf16's kept intermediates.
//
// Passes outside a product move 16 bytes a thread; each image's group
// statistics and gradient terms are folded once into a [B, G] row; the
// weight gradient is a product over all B*HW rows cut into chunks of
// rows, each chunk's f32 partial written apart and folded in a fixed
// order, and dgamma and dbeta per image, folded the same way.
//
// No atomics: a run is deterministic.  Where the plain version rounds
// (the affine, the ReLU tests, dy_raw), the kernels round the same way
// with __fmul_rn / __fadd_rn / __fsub_rn, so nvcc fuses nothing there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "fused_gemm.cuh"

// A named namespace around the anonymous one, so a profiler tells these
// kernels from group_norm.cu's of the same names.
namespace fused_block {
namespace {

constexpr int NT = 256;        // threads of the statistics/apply blocks
constexpr int TILE = 64;       // FMA product tile edge (M and N)
constexpr int FMA_K = 16;      // FMA product depth step

using tc::APPLY_PLAIN;
using tc::APPLY_RELU;
using tc::APPLY_RESID_RELU;
using tc::MASK_NONE;
using tc::MASK_RELU;
using tc::MASK_RESID;

// ---- statistics folds ---------------------------------------------------

// Per-group mean and inv-std of image b from its per-tile channel sums
// part_b[T][2][C], in a fixed order: tiles per channel into csum[2][C],
// then the channels of each group.  Ends in a barrier.
__device__ void fold_stats(const float* part_b, int ntiles, int C, int G,
                           float count, float eps, float* csum,
                           float* gmean, float* ginv) {
  for (int c = threadIdx.x; c < C; c += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      s1 += part_b[(size_t)t * 2 * C + c];
      s2 += part_b[(size_t)t * 2 * C + C + c];
    }
    csum[c] = s1;
    csum[C + c] = s2;
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < cg; ++k) {
      s1 += csum[g * cg + k];
      s2 += csum[C + g * cg + k];
    }
    const float m = s1 / count;
    const float var = fmaxf(__fsub_rn(s2 / count, __fmul_rn(m, m)), 0.f);
    gmean[g] = m;
    ginv[g] = rsqrtf(var + eps);
  }
  __syncthreads();
}

// out[i] = sum over z of part[z * size + i], z in order.
__global__ void fold_kernel(const float* __restrict__ part,
                            float* __restrict__ out, int n, size_t size) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int z = 0; z < n; ++z) s += part[(size_t)z * size + i];
  out[i] = s;
}

// dgamma (y 0) and dbeta (y 1) of per_image[2][B][C], each summed over
// the images in order.
__global__ void fold2_kernel(const float* __restrict__ per_image,
                             float* __restrict__ dgamma,
                             float* __restrict__ dbeta, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* p = per_image + (size_t)blockIdx.y * B * C + c;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += p[(size_t)b * C];
  (blockIdx.y == 0 ? dgamma : dbeta)[c] = s;
}

// ---- 16-byte passes and once-per-image folds ---------------------------

// Thread t owns channels 8v .. 8v + 7, v = t % VC (VC = C / 8 vectors,
// at most NT by MAX_CHANNELS), and walks the rows rl, rl + RP, ... of its
// tile (RP = NT / VC row lanes; threads with rl >= RP idle).
struct Lanes8 {
  int VC, RP, v, rl;
  __device__ explicit Lanes8(int C) {
    VC = C / 8;
    RP = NT / VC;
    v = threadIdx.x % VC;
    rl = threadIdx.x / VC;
  }
};

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* x) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* x) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* x) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(x[2 * i], x[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float* x) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

// The parameters of the thread's 8 channels: mean, inv, gamma, beta from
// image b's folded rows gst[B][G][4] (and the group terms u1, u2).
struct Cols8 {
  float m[8], iv[8], ga[8], be[8], u1[8], u2[8];
  __device__ Cols8(const float* gst, const float* gamma, const float* beta,
                   int b, int c0, int C, int G, bool terms) {
    const int cg = C / G;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float* q = gst + ((size_t)b * G + (c0 + i) / cg) * 4;
      m[i] = q[0];
      iv[i] = q[1];
      ga[i] = gamma[c0 + i];
      be[i] = beta[c0 + i];
      u1[i] = terms ? q[2] : 0.f;
      u2[i] = terms ? q[3] : 0.f;
    }
  }
};

// Writes the row lanes' sums s1, s2 into red[2][RP][C], then folds them
// in lane order into out[0..C) and out[C..2C).  Ends in a barrier.
__device__ __forceinline__ void fold_lanes8(float* red, const float* s1,
                                            const float* s2, float* out,
                                            const Lanes8& L, int C) {
  if (L.rl < L.RP) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      red[L.rl * C + 8 * L.v + i] = s1[i];
      red[(L.RP + L.rl) * C + 8 * L.v + i] = s2[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += NT) {
    float a = 0.f, q = 0.f;
    for (int r = 0; r < L.RP; ++r) {
      a += red[r * C + c];
      q += red[(L.RP + r) * C + c];
    }
    out[c] = a;
    out[C + c] = q;
  }
  __syncthreads();
}

// Per-tile channel sums of a and a^2 -> part[B][T][2][C].
template <typename TI>
__global__ void __launch_bounds__(NT) stats8_kernel(
    const TI* __restrict__ a, float* __restrict__ part, int HW, int C, int R,
    int ntiles) {
  extern __shared__ float red[];  // [2][RP][C]
  const Lanes8 L(C);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  const TI* base = a + (size_t)b * HW * C + 8 * L.v;
  float s1[8] = {}, s2[8] = {};
  if (L.rl < L.RP) {
    for (int r = r0 + L.rl; r < r1; r += L.RP) {
      float x[8];
      load8(base + (size_t)r * C, x);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1[i] += x[i];
        s2[i] += x[i] * x[i];
      }
    }
  }
  fold_lanes8(red, s1, s2, part + ((size_t)b * ntiles + tile) * 2 * C, L, C);
}

// The norm: out = (a - mean) * inv * gamma + beta, then per mode a ReLU,
// or the residual added and a ReLU; one rounding to TO.
template <typename TI, typename TO>
__global__ void __launch_bounds__(NT) apply8_kernel(
    const TI* __restrict__ a, const float* __restrict__ gst,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const TO* __restrict__ res, TO* __restrict__ out, int HW, int C, int G,
    int R, int mode) {
  const Lanes8 L(C);
  if (L.rl >= L.RP) return;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  const Cols8 p(gst, gamma, beta, b, 8 * L.v, C, G, false);
  const size_t base = (size_t)b * HW * C + 8 * L.v;
  for (int r = r0 + L.rl; r < r1; r += L.RP) {
    float x[8], rv[8];
    load8(a + base + (size_t)r * C, x);
    if (mode == APPLY_RESID_RELU) load8(res + base + (size_t)r * C, rv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xh = __fmul_rn(__fsub_rn(x[i], p.m[i]), p.iv[i]);
      float o = __fadd_rn(__fmul_rn(xh, p.ga[i]), p.be[i]);
      if (mode == APPLY_RESID_RELU) o = __fadd_rn(o, rv[i]);
      x[i] = mode == APPLY_PLAIN ? o : fmaxf(o, 0.f);
    }
    store8(out + base + (size_t)r * C, x);
  }
}

// GroupNorm backward, first pass over a kept raw tensor: per-tile sums
// of the masked gradient dz and of dz * xhat -> partd[B][T][2][C].  With
// MASK_RESID the ReLU test adds the residual and the masked gradient is
// also written (the tail's dres).
template <typename TR, typename TG, typename TO>
__global__ void __launch_bounds__(NT) bwd_stats8_kernel(
    const TR* __restrict__ raw, const TG* __restrict__ grad,
    const float* __restrict__ gst, const float* __restrict__ gamma,
    const float* __restrict__ beta, const TO* __restrict__ res,
    TO* __restrict__ dz_out, float* __restrict__ partd, int HW, int C, int G,
    int R, int ntiles, int mask) {
  extern __shared__ float red[];  // [2][RP][C]
  const Lanes8 L(C);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  float s1[8] = {}, s2[8] = {};
  if (L.rl < L.RP) {
    const Cols8 p(gst, gamma, beta, b, 8 * L.v, C, G, false);
    const size_t base = (size_t)b * HW * C + 8 * L.v;
    for (int r = r0 + L.rl; r < r1; r += L.RP) {
      float x[8], d[8], rv[8];
      load8(raw + base + (size_t)r * C, x);
      load8(grad + base + (size_t)r * C, d);
      if (mask == MASK_RESID) load8(res + base + (size_t)r * C, rv);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xh = __fmul_rn(__fsub_rn(x[i], p.m[i]), p.iv[i]);
        if (mask != MASK_NONE) {
          float z = __fadd_rn(__fmul_rn(xh, p.ga[i]), p.be[i]);
          if (mask == MASK_RESID) z = __fadd_rn(z, rv[i]);
          if (!(z > 0.f)) d[i] = 0.f;
        }
        s1[i] += d[i];
        s2[i] += d[i] * xh;
      }
      if (mask == MASK_RESID) store8(dz_out + base + (size_t)r * C, d);
    }
  }
  fold_lanes8(red, s1, s2, partd + ((size_t)b * ntiles + tile) * 2 * C, L,
              C);
}

// GroupNorm backward, second pass over a kept raw tensor: dy_raw = inv *
// (dz * gamma - u1 - xhat * u2), rounded once to TO.
template <typename TR, typename TG, typename TO>
__global__ void __launch_bounds__(NT) bwd_apply8_kernel(
    const TR* __restrict__ raw, const TG* __restrict__ grad,
    const float* __restrict__ gst, const float* __restrict__ gamma,
    const float* __restrict__ beta, TO* __restrict__ out, int HW, int C,
    int G, int R, int mask) {
  const Lanes8 L(C);
  if (L.rl >= L.RP) return;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  const Cols8 p(gst, gamma, beta, b, 8 * L.v, C, G, true);
  const size_t base = (size_t)b * HW * C + 8 * L.v;
  for (int r = r0 + L.rl; r < r1; r += L.RP) {
    float x[8], d[8];
    load8(raw + base + (size_t)r * C, x);
    load8(grad + base + (size_t)r * C, d);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xh = __fmul_rn(__fsub_rn(x[i], p.m[i]), p.iv[i]);
      if (mask == MASK_RELU &&
          !(__fadd_rn(__fmul_rn(xh, p.ga[i]), p.be[i]) > 0.f))
        d[i] = 0.f;
      const float dzg = __fmul_rn(d[i], p.ga[i]);
      x[i] = __fmul_rn(p.iv[i], __fsub_rn(__fsub_rn(dzg, p.u1[i]),
                                          __fmul_rn(xh, p.u2[i])));
    }
    store8(out + base + (size_t)r * C, x);
  }
}

// Image b's per-group (mean, inv) from its per-tile channel sums, folded
// once: gst[b][g][0..1].
__global__ void __launch_bounds__(NT) group_stats_kernel(
    const float* __restrict__ part, int ntiles, int C, int G, float count,
    float eps, float* __restrict__ gst) {
  extern __shared__ float sh[];
  float* csum = sh;               // [2][C]
  float* gmean = sh + 2 * C;      // [G]
  float* ginv = gmean + G;        // [G]
  const int b = blockIdx.x;
  fold_stats(part + (size_t)b * ntiles * 2 * C, ntiles, C, G, count, eps,
             csum, gmean, ginv);
  for (int g = threadIdx.x; g < G; g += NT) {
    gst[((size_t)b * G + g) * 4] = gmean[g];
    gst[((size_t)b * G + g) * 4 + 1] = ginv[g];
  }
}

// Image b's gradient sums folded once: dgamma, dbeta per image into
// per_image[2][B][C], and the group terms u1 = sum(dz * gamma) / count,
// u2 = sum(dz * gamma * xhat) / count into gst[b][g][2..3].
__global__ void __launch_bounds__(NT) group_grad_kernel(
    const float* __restrict__ partd, int ntiles, int B, int C, int G,
    float count, const float* __restrict__ gamma,
    float* __restrict__ per_image, float* __restrict__ gst) {
  extern __shared__ float csum[];  // [2][C]
  const int b = blockIdx.x;
  const float* pd = partd + (size_t)b * ntiles * 2 * C;
  for (int c = threadIdx.x; c < C; c += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      s1 += pd[(size_t)t * 2 * C + c];
      s2 += pd[(size_t)t * 2 * C + C + c];
    }
    csum[c] = s1;
    csum[C + c] = s2;
    per_image[(size_t)b * C + c] = s2;            // dgamma
    per_image[((size_t)B + b) * C + c] = s1;      // dbeta
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < cg; ++k) {
      const int c = g * cg + k;
      s1 += gamma[c] * csum[c];
      s2 += gamma[c] * csum[C + c];
    }
    gst[((size_t)b * G + g) * 4 + 2] = s1 / count;
    gst[((size_t)b * G + g) * 4 + 3] = s2 / count;
  }
}

// ---- products -----------------------------------------------------------
//
// C[m, n] (+ z * zstride) = sum over k in [z * kc, min(K, (z + 1) * kc)) of
// A(m, k) * B(k, n), with A(m, k) = A[m * sam + k * sak] and B(k, n) =
// B[k * sbk + n * sbn] (one stride of each is 1), C[m * ldc + n].

struct Gemm {
  int M, N, K, kc;
  long long sam, sak, sbk, sbn, ldc, zstride;
};

// f32 on CUDA cores: 64 x 64 tiles, 256 threads of 4 x 4 outputs.
__global__ void __launch_bounds__(256) gemm_fma_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm,
    float* __restrict__ Cm, Gemm p) {
  __shared__ float As[FMA_K][TILE];
  __shared__ float Bs[FMA_K][TILE];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int kbeg = blockIdx.z * p.kc, kend = min(p.K, kbeg + p.kc);
  float acc[4][4] = {};
  for (int k0 = kbeg; k0 < kend; k0 += FMA_K) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = tid + i * 256;
      int m, k;
      if (p.sak == 1) { m = e / FMA_K; k = e % FMA_K; }
      else { k = e / TILE; m = e % TILE; }
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < p.M && gk < kend)
                     ? A[gm * p.sam + gk * p.sak] : 0.f;
      int n;
      if (p.sbn == 1) { k = e / TILE; n = e % TILE; }
      else { n = e / FMA_K; k = e % FMA_K; }
      const int gn = n0 + n, gk2 = k0 + k;
      Bs[k][n] = (gn < p.N && gk2 < kend)
                     ? Bm[gk2 * p.sbk + gn * p.sbn] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FMA_K; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = As[kk][ty + 16 * i];
        bv[i] = Bs[kk][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* c = Cm + blockIdx.z * p.zstride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < p.N) c[(size_t)gm * p.ldc + gn] = acc[i][j];
    }
  }
}

// ---- host side ----------------------------------------------------------

using bf16 = __nv_bfloat16;

// One launch's error, if any, returns from the caller.
#define CHECK(call)                  \
  do {                               \
    const int e_ = (call);           \
    if (e_ != 0) return e_;          \
  } while (0)

Gemm gemm_args(int M, int N, int K, long long sam, long long sak,
               long long sbk, long long sbn, long long ldc, int chunks,
               int kc) {
  Gemm p;
  p.M = M; p.N = N; p.K = K;
  p.kc = chunks > 1 ? kc : K;
  p.sam = sam; p.sak = sak; p.sbk = sbk; p.sbn = sbn; p.ldc = ldc;
  p.zstride = (long long)M * ldc;
  return p;
}

int gemm(const float* A, const float* B, float* C, Gemm p, int chunks,
         cudaStream_t s) {
  const dim3 grid((p.N + TILE - 1) / TILE, (p.M + TILE - 1) / TILE, chunks);
  gemm_fma_kernel<<<grid, 256, 0, s>>>(A, B, C, p);
  return (int)cudaGetLastError();
}

// The row tiles of the passes outside a product: R rows of an image each.
struct Rows {
  int B, HW, C, G, R, ntiles;
  float count;
  Rows(int b, int hw, int c, int g, int r)
      : B(b), HW(hw), C(c), G(g), R(r), ntiles((hw + r - 1) / r),
        count((float)hw * (float)(c / g)) {}
  dim3 grid() const { return dim3(ntiles, B); }
  size_t part() const { return (size_t)B * ntiles * 2 * C; }
};

// Shared memory of the 16-byte statistics passes: red[2][RP][C].
size_t red8_smem(int C) {
  return sizeof(float) * 2 * (NT / (C / 8)) * C;
}

int group_stats(const float* part, int ntiles, int B, int C, int G,
                float count, float eps, float* gst, cudaStream_t s) {
  group_stats_kernel<<<B, NT, sizeof(float) * (2 * C + 2 * G), s>>>(
      part, ntiles, C, G, count, eps, gst);
  return (int)cudaGetLastError();
}

// The gradient sums partd folded: the group terms into gst, dgamma and
// dbeta over the images in order.
int group_grad(const float* partd, int ntiles, int B, int C, int G,
               float count, const float* gamma, float* per_image,
               float* dgamma, float* dbeta, float* gst, cudaStream_t s) {
  group_grad_kernel<<<B, NT, sizeof(float) * 2 * C, s>>>(
      partd, ntiles, B, C, G, count, gamma, per_image, gst);
  CHECK((int)cudaGetLastError());
  fold2_kernel<<<dim3((C + 255) / 256, 2), 256, 0, s>>>(per_image, dgamma,
                                                        dbeta, B, C);
  return (int)cudaGetLastError();
}

// The statistics of a kept [B, HW, C] tensor: per-tile sums into part
// [B][T][2][C], folded once into gst[B][G][0..1].
template <typename TI>
int norm_stats(const TI* a, float* part, float* gst, const Rows& q,
               float eps, cudaStream_t s) {
  stats8_kernel<TI><<<q.grid(), NT, red8_smem(q.C), s>>>(a, part, q.HW, q.C,
                                                         q.R, q.ntiles);
  CHECK((int)cudaGetLastError());
  return group_stats(part, q.ntiles, q.B, q.C, q.G, q.count, eps, gst, s);
}

// The norm of a kept tensor from its folded statistics (mode APPLY_*; res
// read only by APPLY_RESID_RELU).
template <typename TI, typename TO>
int norm_apply(const TI* a, const float* gst, const float* gamma,
               const float* beta, const TO* res, TO* out, const Rows& q,
               int mode, cudaStream_t s) {
  apply8_kernel<TI, TO><<<q.grid(), NT, 0, s>>>(a, gst, gamma, beta, res,
                                                out, q.HW, q.C, q.G, q.R,
                                                mode);
  return (int)cudaGetLastError();
}

// The GroupNorm backward over a kept raw tensor whose statistics gst
// holds: the gradient's sums into partd [B][T][2][C], folded once (the
// group terms into gst, dgamma and dbeta over the images), then dy_raw
// into out.  With MASK_RESID the masked gradient goes to dz_out (the
// tail's dres), which the second pass reads.
template <typename TR, typename TG, typename TO>
int norm_grad(const TR* raw, const TG* grad, float* gst, const float* gamma,
              const float* beta, const TO* res, TO* dz_out, TO* out,
              float* partd, float* per_image, float* dgamma, float* dbeta,
              const Rows& q, int mask, cudaStream_t s) {
  bwd_stats8_kernel<TR, TG, TO><<<q.grid(), NT, red8_smem(q.C), s>>>(
      raw, grad, gst, gamma, beta, res, dz_out, partd, q.HW, q.C, q.G, q.R,
      q.ntiles, mask);
  CHECK((int)cudaGetLastError());
  CHECK(group_grad(partd, q.ntiles, q.B, q.C, q.G, q.count, gamma,
                   per_image, dgamma, dbeta, gst, s));
  if (mask == MASK_RESID) {
    bwd_apply8_kernel<TR, TO, TO><<<q.grid(), NT, 0, s>>>(
        raw, dz_out, gst, gamma, beta, out, q.HW, q.C, q.G, q.R, MASK_NONE);
  } else {
    bwd_apply8_kernel<TR, TG, TO><<<q.grid(), NT, 0, s>>>(
        raw, grad, gst, gamma, beta, out, q.HW, q.C, q.G, q.R, mask);
  }
  return (int)cudaGetLastError();
}

// ---- f32: FMA products into workspaces, the 16-byte passes around them ---

float* const NO_F32 = nullptr;

// The weight gradient a^T @ d over M rows of a [M, Ca] and d [M, Cd],
// in chunks of kc rows, folded in order into dw [Ca, Cd].
int weight_grad_f32(const float* a, const float* d, float* dw_part,
                    float* dw, int M, int Ca, int Cd, int chunks, int kc,
                    cudaStream_t s) {
  const Gemm p = gemm_args(Ca, Cd, M, 1, Ca, Cd, 1, Cd, chunks, kc);
  CHECK(gemm(a, d, dw_part, p, chunks, s));
  const size_t n = (size_t)Ca * Cd;
  fold_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(dw_part, dw, chunks, n);
  return (int)cudaGetLastError();
}

// #7 in f32.  Scratch: ws [B*HW, Cout], part [B][T][2][Cout] (R-row
// tiles), gst [B][G][4].
int conv_gn_fwd_f32(const float* x, const float* w, const float* gamma,
                    const float* beta, float* y, float* ws, float* part,
                    float* gst, int B, int HW, int Cin, int Cout, int G,
                    int R, float eps, int relu, cudaStream_t s) {
  const Rows q(B, HW, Cout, G, R);
  CHECK(gemm(x, w, ws,
             gemm_args(B * HW, Cout, Cin, Cin, 1, Cout, 1, Cout, 1, 0), 1,
             s));
  CHECK(norm_stats(ws, part, gst, q, eps, s));
  return norm_apply(ws, gst, gamma, beta, NO_F32, y, q,
                    relu ? APPLY_RELU : APPLY_PLAIN, s);
}

// #8 in f32.  Scratch: ws [B*HW, Cout], dyb [B*HW, Cout], part [2] x
// [B][T][2][Cout] (the product's sums, then the gradient's), per_image
// [2][B][Cout], dw_part [chunks][Cin][Cout], gst [B][G][4].
int conv_gn_bwd_f32(const float* x, const float* w, const float* gamma,
                    const float* beta, const float* dy, float* dx,
                    float* dw, float* dgamma, float* dbeta, float* ws,
                    float* dyb, float* part, float* per_image,
                    float* dw_part, float* gst, int B, int HW, int Cin,
                    int Cout, int G, int R, int chunks, int kc, float eps,
                    int relu, cudaStream_t s) {
  const int M = B * HW;
  const Rows q(B, HW, Cout, G, R);
  // recompute the forward's product and its statistics
  CHECK(gemm(x, w, ws, gemm_args(M, Cout, Cin, Cin, 1, Cout, 1, Cout, 1, 0),
             1, s));
  CHECK(norm_stats(ws, part, gst, q, eps, s));
  CHECK(norm_grad(ws, dy, gst, gamma, beta, NO_F32, NO_F32, dyb,
                  part + q.part(), per_image, dgamma, dbeta, q,
                  relu ? MASK_RELU : MASK_NONE, s));
  // dx = dy_raw @ w^T
  CHECK(gemm(dyb, w, dx, gemm_args(M, Cin, Cout, Cout, 1, 1, Cout, Cin, 1, 0),
             1, s));
  return weight_grad_f32(x, dyb, dw_part, dw, M, Cin, Cout, chunks, kc, s);
}

// #9 in f32.  Scratch: hb [B*HW, Cm], ws [B*HW, Cout], part2 [B][T][2]
// [Cm], part3 [B][T][2][Cout] (R-row tiles), gst2 [B][G2][4], gst3
// [B][G3][4].
int tail_fwd_f32(const float* y2, const float* w, const float* g2,
                 const float* b2, const float* g3, const float* b3,
                 const float* res, float* out, float* hb, float* ws,
                 float* part2, float* part3, float* gst2, float* gst3, int B,
                 int HW, int Cm, int Cout, int G2, int G3, int R, float eps,
                 cudaStream_t s) {
  const Rows q2(B, HW, Cm, G2, R), q3(B, HW, Cout, G3, R);
  CHECK(norm_stats(y2, part2, gst2, q2, eps, s));
  CHECK(norm_apply(y2, gst2, g2, b2, NO_F32, hb, q2, APPLY_RELU, s));
  CHECK(gemm(hb, w, ws,
             gemm_args(B * HW, Cout, Cm, Cm, 1, Cout, 1, Cout, 1, 0), 1, s));
  CHECK(norm_stats(ws, part3, gst3, q3, eps, s));
  return norm_apply(ws, gst3, g3, b3, res, out, q3, APPLY_RESID_RELU, s);
}

// #10 in f32.  Scratch: hb [B*HW, Cm], ws3 [B*HW, Cout], dy3b [B*HW,
// Cout], ws2 [B*HW, Cm], part2 [2][B][T][2][Cm], part3 [2][B][T][2]
// [Cout], per_image2 [2][B][Cm], per_image3 [2][B][Cout], dw_part
// [chunks][Cm][Cout], gst2 [B][G2][4], gst3 [B][G3][4].
int tail_bwd_f32(const float* y2, const float* w, const float* g2,
                 const float* b2, const float* g3, const float* b3,
                 const float* res, const float* dout, float* dy2, float* dw,
                 float* dg2, float* db2, float* dg3, float* db3, float* dres,
                 float* hb, float* ws3, float* dy3b, float* ws2,
                 float* part2, float* part3, float* per_image2,
                 float* per_image3, float* dw_part, float* gst2,
                 float* gst3, int B, int HW, int Cm, int Cout, int G2,
                 int G3, int R, int chunks, int kc, float eps,
                 cudaStream_t s) {
  const int M = B * HW;
  const Rows q2(B, HW, Cm, G2, R), q3(B, HW, Cout, G3, R);
  // recompute the forward chain up to y3
  CHECK(norm_stats(y2, part2, gst2, q2, eps, s));
  CHECK(norm_apply(y2, gst2, g2, b2, NO_F32, hb, q2, APPLY_RELU, s));
  CHECK(gemm(hb, w, ws3, gemm_args(M, Cout, Cm, Cm, 1, Cout, 1, Cout, 1, 0),
             1, s));
  CHECK(norm_stats(ws3, part3, gst3, q3, eps, s));
  // GN3's backward through the residual ReLU: dres, then dy3
  CHECK(norm_grad(ws3, dout, gst3, g3, b3, res, dres, dy3b, part3 + q3.part(),
                  per_image3, dg3, db3, q3, MASK_RESID, s));
  CHECK(weight_grad_f32(hb, dy3b, dw_part, dw, M, Cm, Cout, chunks, kc, s));
  // dh = dy3 @ w^T, then GN2's backward through h's ReLU
  CHECK(gemm(dy3b, w, ws2, gemm_args(M, Cm, Cout, Cout, 1, 1, Cout, Cm, 1, 0),
             1, s));
  return norm_grad(y2, ws2, gst2, g2, b2, NO_F32, NO_F32, dy2,
                   part2 + q2.part(), per_image2, dg2, db2, q2, MASK_RELU, s);
}

// ---- bf16: the products on the tensor cores (fused_gemm.cuh) -------------

bf16* const NO_BF16 = nullptr;

// #7 in bf16.  P1: y = x @ w and its statistics (y kept in f32 in ws
// where the plan stores it), the fold, then the apply: a 16-byte pass
// over ws (store), or P2, the same product with the apply in its
// epilogue (recompute; P1 and P2 run the same body in the same depth
// order, so the statistics are those of the y they are applied to).
// Scratch: ws [B*HW, Cout] f32 (null unless store); part [B][T][2][Cout]
// (T 64-row tiles); gst [B][G][4].
int conv_gn_fwd_tc(const bf16* x, const bf16* w, const float* gamma,
                   const float* beta, bf16* y, float* ws, float* part,
                   float* gst, int B, int HW, int Cin, int Cout, int G,
                   int R, int store, float eps, int relu, cudaStream_t s) {
  const float count = (float)HW * (float)(Cout / G);
  const int mode = relu ? APPLY_RELU : APPLY_PLAIN;
  CHECK(tc::rows_times_w(x, w, B, HW, Cin, Cout, tc::StatsEpi{part, Cout},
                         tc::Io{nullptr, nullptr, store ? ws : nullptr}, s));
  CHECK(group_stats(part, tc::tiles64(HW), B, Cout, G, count, eps, gst, s));
  if (store)
    return norm_apply(ws, gst, gamma, beta, NO_BF16, y,
                      Rows(B, HW, Cout, G, R), mode, s);
  return tc::rows_times_w(x, w, B, HW, Cin, Cout,
                          tc::ApplyEpi{gst, gamma, beta, Cout, G, mode},
                          tc::Io{nullptr, nullptr, y}, s);
}

// dw = a^T @ d over every row, in chunks folded in order.
int weight_grad_tc(const bf16* a, const bf16* d, float* dw_part, float* dw,
                   long long rows, int Ca, int Cd, int chunks, int kc,
                   cudaStream_t s) {
  CHECK(tc::rows_t_times_rows(a, d, dw_part, rows, Ca, Cd, chunks, kc, s));
  const size_t n = (size_t)Ca * Cd;
  fold_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(dw_part, dw, chunks, n);
  return (int)cudaGetLastError();
}

// #8 in bf16.  Scratch: ws [B*HW, Cout] f32 where y is kept (store),
// dyb [B*HW, Cout]; part: the product's sums [B][T][2][Cout] (T 64-row
// tiles), then the gradient's [B][T'][2][Cout] (T' = T, or the R-row
// tiles of the kept passes); per_image [2][B][Cout]; dw_part [chunks]
// [Cin][Cout]; gst [B][G][4].
int conv_gn_bwd_tc(const bf16* x, const bf16* w, const float* gamma,
                   const float* beta, const bf16* dy, bf16* dx, float* dw,
                   float* dgamma, float* dbeta, float* ws, bf16* dyb,
                   float* part, float* per_image, float* dw_part, float* gst,
                   int B, int HW, int Cin, int Cout, int G, int R,
                   int chunks, int kc, int store, float eps, int relu,
                   cudaStream_t s) {
  const int T = tc::tiles64(HW);
  const float count = (float)HW * (float)(Cout / G);
  const int mask = relu ? MASK_RELU : MASK_NONE;
  float* partd = part + (size_t)B * T * 2 * Cout;
  // P1: y = x @ w, its statistics (and y in f32 where it is kept)
  CHECK(tc::rows_times_w(x, w, B, HW, Cin, Cout, tc::StatsEpi{part, Cout},
                         tc::Io{nullptr, nullptr, store ? ws : nullptr}, s));
  CHECK(group_stats(part, T, B, Cout, G, count, eps, gst, s));
  if (store) {
    CHECK(norm_grad(ws, dy, gst, gamma, beta, NO_BF16, NO_BF16, dyb, partd,
                    per_image, dgamma, dbeta, Rows(B, HW, Cout, G, R), mask,
                    s));
  } else {
    // P2, P3: y recomputed for the gradient's sums, then for dy_raw
    CHECK(tc::rows_times_w(x, w, B, HW, Cin, Cout,
                           tc::BwdStatsEpi{gst, gamma, beta, partd, Cout, G,
                                           mask},
                           tc::Io{dy, nullptr, nullptr}, s));
    CHECK(group_grad(partd, T, B, Cout, G, count, gamma, per_image, dgamma,
                     dbeta, gst, s));
    CHECK(tc::rows_times_w(x, w, B, HW, Cin, Cout,
                           tc::BwdApplyEpi{gst, gamma, beta, Cout, G, mask},
                           tc::Io{dy, nullptr, dyb}, s));
  }
  // dx = dy_raw @ w^T, dw = x^T @ dy_raw
  CHECK(tc::rows_times_wt(dyb, w, B, HW, Cout, Cin, tc::StoreEpi{},
                          tc::Io{nullptr, nullptr, dx}, s));
  return weight_grad_tc(x, dyb, dw_part, dw, (long long)B * HW, Cin, Cout,
                        chunks, kc, s);
}

// #9 in bf16.  GN2 by the 16-byte passes: y2's statistics, then h =
// relu(GN2(y2)) rounded once to bf16; then #7's two passes on h @ w with
// the residual and the final ReLU in the apply.  Scratch: hb [B*HW, Cm];
// ws [B*HW, Cout] f32 (null unless store); part2 [B][T2][2][Cm] (R-row
// tiles), part3 [B][T][2][Cout] (64-row tiles); gst2 [B][G2][4], gst3
// [B][G3][4].
int tail_fwd_tc(const bf16* y2, const bf16* w, const float* g2,
                const float* b2, const float* g3, const float* b3,
                const bf16* res, bf16* out, bf16* hb, float* ws,
                float* part2, float* part3, float* gst2, float* gst3, int B,
                int HW, int Cm, int Cout, int G2, int G3, int R, int store,
                float eps, cudaStream_t s) {
  const Rows q2(B, HW, Cm, G2, R);
  const float count3 = (float)HW * (float)(Cout / G3);
  CHECK(norm_stats(y2, part2, gst2, q2, eps, s));
  CHECK(norm_apply(y2, gst2, g2, b2, NO_BF16, hb, q2, APPLY_RELU, s));
  CHECK(tc::rows_times_w(hb, w, B, HW, Cm, Cout, tc::StatsEpi{part3, Cout},
                         tc::Io{nullptr, nullptr, store ? ws : nullptr}, s));
  CHECK(group_stats(part3, tc::tiles64(HW), B, Cout, G3, count3, eps, gst3,
                    s));
  if (store)
    return norm_apply(ws, gst3, g3, b3, res, out, Rows(B, HW, Cout, G3, R),
                      APPLY_RESID_RELU, s);
  return tc::rows_times_w(hb, w, B, HW, Cm, Cout,
                          tc::ApplyEpi{gst3, g3, b3, Cout, G3,
                                       APPLY_RESID_RELU},
                          tc::Io{res, nullptr, out}, s);
}

// #10 in bf16.  Scratch: hb [B*HW, Cm], dy3b [B*HW, Cout], ws2 [B*HW, Cm]
// f32; part2: y2's sums [B][T2][2][Cm] (R-row tiles), then dh's
// [B][T][2][Cm]; part3 [2][B][T][2][Cout]; per_image2 [2][B][Cm],
// per_image3 [2][B][Cout]; dw_part [chunks][Cm][Cout]; gst2 [B][G2][4],
// gst3 [B][G3][4].  No [B*HW, Cout] f32 workspace: y3 = h @ w is
// recomputed by each of P1-P3.
int tail_bwd_tc(const bf16* y2, const bf16* w, const float* g2,
                const float* b2, const float* g3, const float* b3,
                const bf16* res, const bf16* dout, bf16* dy2, float* dw,
                float* dg2, float* db2, float* dg3, float* db3, bf16* dres,
                bf16* hb, bf16* dy3b, float* ws2, float* part2, float* part3,
                float* per_image2, float* per_image3, float* dw_part,
                float* gst2, float* gst3, int B, int HW, int Cm, int Cout,
                int G2, int G3, int R, int chunks, int kc, float eps,
                cudaStream_t s) {
  const int T = tc::tiles64(HW);
  const Rows q2(B, HW, Cm, G2, R);
  const float count3 = (float)HW * (float)(Cout / G3);
  // GN2 recomputed: y2's statistics, then h = relu(GN2(y2)) in bf16
  CHECK(norm_stats(y2, part2, gst2, q2, eps, s));
  CHECK(norm_apply(y2, gst2, g2, b2, NO_BF16, hb, q2, APPLY_RELU, s));
  // P1: y3 = h @ w and GN3's statistics
  CHECK(tc::rows_times_w(hb, w, B, HW, Cm, Cout, tc::StatsEpi{part3, Cout},
                         tc::Io{nullptr, nullptr, nullptr}, s));
  CHECK(group_stats(part3, T, B, Cout, G3, count3, eps, gst3, s));
  // P2: dres behind the residual ReLU and GN3's gradient sums
  float* partd3 = part3 + (size_t)B * T * 2 * Cout;
  CHECK(tc::rows_times_w(hb, w, B, HW, Cm, Cout,
                         tc::BwdStatsEpi{gst3, g3, b3, partd3, Cout, G3,
                                         MASK_RESID},
                         tc::Io{dout, res, dres}, s));
  CHECK(group_grad(partd3, T, B, Cout, G3, count3, g3, per_image3, dg3, db3,
                   gst3, s));
  // P3: dy3 rounded to bf16, from dres
  CHECK(tc::rows_times_w(hb, w, B, HW, Cm, Cout,
                         tc::BwdApplyEpi{gst3, g3, b3, Cout, G3,
                                         MASK_NONE},
                         tc::Io{dres, nullptr, dy3b}, s));
  CHECK(weight_grad_tc(hb, dy3b, dw_part, dw, (long long)B * HW, Cm, Cout,
                       chunks, kc, s));
  // P4: dh = dy3 @ w^T behind h's ReLU (kept in f32) and GN2's sums
  float* partd2 = part2 + (size_t)B * q2.ntiles * 2 * Cm;
  CHECK(tc::rows_times_wt(dy3b, w, B, HW, Cout, Cm,
                          tc::DhEpi{gst2, g2, b2, partd2, Cm, G2},
                          tc::Io{y2, nullptr, ws2}, s));
  CHECK(group_grad(partd2, T, B, Cm, G2, q2.count, g2, per_image2, dg2, db2,
                   gst2, s));
  // GN2's apply: dy2
  bwd_apply8_kernel<bf16, float, bf16><<<q2.grid(), NT, 0, s>>>(
      y2, ws2, gst2, g2, b2, dy2, HW, Cm, G2, R, MASK_NONE);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fused_block

using namespace fused_block;

// dtype: 0 float32, 1 bfloat16.  Scratch (allocated by the caller, in the
// order of ops/fused_block.py fwd_plan): f32: ws [B*HW, Cout] f32, part
// [B][T][2][Cout] f32 (R-row tiles), gst [B][G][4] f32; store unused.
// bf16: conv_gn_fwd_tc's scratch (ws null unless store).  Returns a
// cudaError_t (or -1 for an unknown dtype).
extern "C" int conv_gn_fwd(const void* x, const void* w, const float* gamma,
                           const float* beta, void* y, float* ws, float* part,
                           float* gst, int B, int HW, int Cin, int Cout,
                           int G, int R, int store, float eps, int relu,
                           int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return conv_gn_fwd_f32(static_cast<const float*>(x),
                           static_cast<const float*>(w), gamma, beta,
                           static_cast<float*>(y), ws, part, gst, B, HW, Cin,
                           Cout, G, R, eps, relu, s);
  if (dtype == 1)
    return conv_gn_fwd_tc(static_cast<const bf16*>(x),
                          static_cast<const bf16*>(w), gamma, beta,
                          static_cast<bf16*>(y), ws, part, gst, B, HW, Cin,
                          Cout, G, R, store, eps, relu, s);
  return -1;
}

// f32: conv_gn_bwd_f32's scratch; store unused.  bf16: conv_gn_bwd_tc's
// (ws null unless store).  chunks, kc: the weight gradient's row chunks
// (kc a multiple of 64).
extern "C" int conv_gn_bwd(const void* x, const void* w, const float* gamma,
                           const float* beta, const void* dy, void* dx,
                           float* dw, float* dgamma, float* dbeta, float* ws,
                           void* dyb, float* part, float* per_image,
                           float* dw_part, float* gst, int B, int HW,
                           int Cin, int Cout, int G, int R, int chunks,
                           int kc, int store, float eps, int relu, int dtype,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return conv_gn_bwd_f32(
        static_cast<const float*>(x), static_cast<const float*>(w), gamma,
        beta, static_cast<const float*>(dy), static_cast<float*>(dx), dw,
        dgamma, dbeta, ws, static_cast<float*>(dyb), part, per_image, dw_part,
        gst, B, HW, Cin, Cout, G, R, chunks, kc, eps, relu, s);
  if (dtype == 1)
    return conv_gn_bwd_tc(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), gamma, beta,
        static_cast<const bf16*>(dy), static_cast<bf16*>(dx), dw, dgamma,
        dbeta, ws, static_cast<bf16*>(dyb), part, per_image, dw_part, gst, B,
        HW, Cin, Cout, G, R, chunks, kc, store, eps, relu, s);
  return -1;
}

// f32: tail_fwd_f32's scratch; store unused.  bf16: tail_fwd_tc's (ws
// null unless store).
extern "C" int tail_fwd(const void* y2, const void* w, const float* g2,
                        const float* b2, const float* g3, const float* b3,
                        const void* res, void* out, void* hb, float* ws,
                        float* part2, float* part3, float* gst2, float* gst3,
                        int B, int HW, int Cm, int Cout, int G2, int G3,
                        int R, int store, float eps, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tail_fwd_f32(static_cast<const float*>(y2),
                        static_cast<const float*>(w), g2, b2, g3, b3,
                        static_cast<const float*>(res),
                        static_cast<float*>(out), static_cast<float*>(hb), ws,
                        part2, part3, gst2, gst3, B, HW, Cm, Cout, G2, G3, R,
                        eps, s);
  if (dtype == 1)
    return tail_fwd_tc(static_cast<const bf16*>(y2),
                       static_cast<const bf16*>(w), g2, b2, g3, b3,
                       static_cast<const bf16*>(res), static_cast<bf16*>(out),
                       static_cast<bf16*>(hb), ws, part2, part3, gst2, gst3,
                       B, HW, Cm, Cout, G2, G3, R, store, eps, s);
  return -1;
}

// f32: tail_bwd_f32's scratch.  bf16: tail_bwd_tc's (ws3 null).
extern "C" int tail_bwd(const void* y2, const void* w, const float* g2,
                        const float* b2, const float* g3, const float* b3,
                        const void* res, const void* dout, void* dy2,
                        float* dw, float* dg2, float* db2, float* dg3,
                        float* db3, void* dres, void* hb, float* ws3,
                        void* dy3b, float* ws2, float* part2, float* part3,
                        float* per_image2, float* per_image3, float* dw_part,
                        float* gst2, float* gst3, int B, int HW, int Cm,
                        int Cout, int G2, int G3, int R, int chunks, int kc,
                        float eps, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tail_bwd_f32(
        static_cast<const float*>(y2), static_cast<const float*>(w), g2, b2,
        g3, b3, static_cast<const float*>(res),
        static_cast<const float*>(dout), static_cast<float*>(dy2), dw, dg2,
        db2, dg3, db3, static_cast<float*>(dres), static_cast<float*>(hb),
        ws3, static_cast<float*>(dy3b), ws2, part2, part3, per_image2,
        per_image3, dw_part, gst2, gst3, B, HW, Cm, Cout, G2, G3, R, chunks,
        kc, eps, s);
  if (dtype == 1)
    return tail_bwd_tc(
        static_cast<const bf16*>(y2), static_cast<const bf16*>(w), g2, b2, g3,
        b3, static_cast<const bf16*>(res), static_cast<const bf16*>(dout),
        static_cast<bf16*>(dy2), dw, dg2, db2, dg3, db3,
        static_cast<bf16*>(dres), static_cast<bf16*>(hb),
        static_cast<bf16*>(dy3b), ws2, part2, part3, per_image2, per_image3,
        dw_part, gst2, gst3, B, HW, Cm, Cout, G2, G3, R, chunks, kc, eps, s);
  return -1;
}
