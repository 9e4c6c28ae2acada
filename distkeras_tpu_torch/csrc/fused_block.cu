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
// chain of grids on the caller's stream.
//
// The forwards (both dtypes) and the f32 backwards:
//   * products: a tiled matrix product with generic strides (so x @ w,
//     dy @ w^T and x^T @ dy are one kernel), f32 sums: for bf16 the
//     tensor cores through mma.sync.m16n8k16 (exact products, f32
//     accumulation), for f32 FMA on CUDA cores (never TF32).  The f32
//     product lands in a workspace rather than being recomputed for the
//     norm;
//   * statistics: per (row tile, image) blocks take f32 per-channel
//     partial sums; every block of the next grid folds its image's
//     partials in a fixed order, then groups them;
//   * apply: normalize, affine, ReLU, residual, one rounding;
//   * the weight gradient: a product over all B*HW rows, cut into
//     chunks of rows, each chunk's f32 partial written apart and folded
//     in a fixed order; dgamma and dbeta per image, folded the same way.
//
// The bf16 backwards (conv_gn_bwd, tail_bwd) were bound by bytes they
// need not move: f32 workspaces of the product written once and read
// three times (the tail's [B*HW, C_out] one alone 3.3 GB a call at the
// first stage), 2-byte loads into a 64 x 64 mma.sync tile, and one
// element a thread in the norm passes.  They run on fused_gemm.cuh: one
// wgmma product body fed by TMA, whose epilogue does the GroupNorm work
// on the accumulators (statistics; xhat, the ReLU tests, dz and its
// sums; dy_raw; the tail's dh behind h's ReLU).  The rule of each plan:
// write an f32 intermediate only where that takes less time than
// recomputing it on the tensor cores from its bf16 input.  So the tail
// recomputes y3 = h @ w three times (P1 statistics, P2 dres and GN3's
// sums, P3 dy3) instead of keeping it, and keeps dh (4 C_m bytes a row
// against 2 C_out to recompute); conv_gn_bwd recomputes y only where
// its input is narrow, since each recompute is a product of C_in depth
// as well as a read of x, and keeps it in f32 elsewhere
// (ops/fused_block.py _store_y, bwd_plan).  The passes left outside a
// product move 16 bytes a thread, and each image's group statistics are
// folded once into a [B, G] row.
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
constexpr int TILE = 64;       // product tile edge (M and N)
constexpr int FMA_K = 16;      // FMA product depth step
constexpr int MMA_K = 32;      // tensor-core product depth step
constexpr int MMA_LD = MMA_K + 8;  // padded shared row (bf16 elements)

enum { APPLY_PLAIN = 0, APPLY_RELU = 1, APPLY_RESID_RELU = 2 };
using tc::MASK_NONE;
using tc::MASK_RELU;
using tc::MASK_RESID;

__device__ __forceinline__ float ld(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void st(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

// ---- statistics and norm passes ---------------------------------------

// Thread t owns channel cb + t % CC of each chunk of CC = min(C, NT)
// channels and walks the rows rl, rl + RP, ... of its tile (RP = NT / CC
// row lanes; threads with rl >= RP idle).
struct Lanes {
  int CC, RP, cl, rl;
  __device__ explicit Lanes(int C) {
    CC = C < NT ? C : NT;
    RP = NT / CC;
    cl = threadIdx.x % CC;
    rl = threadIdx.x / CC;
  }
};

// Folds the row lanes' sums red[2][RP][CC] of the chunk at channel cb into
// out[cb + i] and out[C + cb + i].
__device__ __forceinline__ void fold_lanes(const float* red, float* out,
                                           const Lanes& L, int cb, int C) {
  for (int i = threadIdx.x; i < L.CC; i += NT) {
    if (cb + i >= C) continue;
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < L.RP; ++r) {
      s1 += red[r * L.CC + i];
      s2 += red[(L.RP + r) * L.CC + i];
    }
    out[cb + i] = s1;
    out[C + cb + i] = s2;
  }
}

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

// Per-tile channel sums of a and a^2 -> part[B][T][2][C].
template <typename TI>
__global__ void __launch_bounds__(NT) stats_kernel(
    const TI* __restrict__ a, float* __restrict__ part, int HW, int C, int R,
    int ntiles) {
  extern __shared__ float red[];  // [2][RP][CC]
  const Lanes L(C);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  const size_t base = (size_t)b * HW * C;
  float* out = part + ((size_t)b * ntiles + tile) * 2 * C;
  for (int cb = 0; cb < C; cb += L.CC) {
    const int c = cb + L.cl;
    float s1 = 0.f, s2 = 0.f;
    if (L.rl < L.RP && c < C) {
      for (int r = r0 + L.rl; r < r1; r += L.RP) {
        const float v = ld(a, base + (size_t)r * C + c);
        s1 += v;
        s2 += v * v;
      }
    }
    if (L.rl < L.RP) {
      red[L.rl * L.CC + L.cl] = s1;
      red[(L.RP + L.rl) * L.CC + L.cl] = s2;
    }
    __syncthreads();
    fold_lanes(red, out, L, cb, C);
    __syncthreads();
  }
}

// The norm: out = (a - mean) * inv * gamma + beta, then per mode a ReLU,
// or the residual added and a ReLU; one rounding to TO.
template <typename TI, typename TO>
__global__ void __launch_bounds__(NT) apply_kernel(
    const TI* __restrict__ a, const float* __restrict__ part,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const TO* __restrict__ res, TO* __restrict__ out, int HW, int C, int G,
    int R, int ntiles, float count, float eps, int mode) {
  extern __shared__ float sh[];
  float* csum = sh;                 // [2][C]
  float* gmean = sh + 2 * C;        // [G]
  float* ginv = gmean + G;          // [G]
  const int b = blockIdx.y, tile = blockIdx.x;
  fold_stats(part + (size_t)b * ntiles * 2 * C, ntiles, C, G, count, eps,
             csum, gmean, ginv);
  const Lanes L(C);
  if (L.rl >= L.RP) return;
  const int r0 = tile * R, r1 = min(HW, r0 + R), cg = C / G;
  const size_t base = (size_t)b * HW * C;
  for (int cb = 0; cb < C; cb += L.CC) {
    const int c = cb + L.cl;
    if (c >= C) continue;
    const float m = gmean[c / cg], iv = ginv[c / cg];
    const float ga = gamma[c], be = beta[c];
    for (int r = r0 + L.rl; r < r1; r += L.RP) {
      const size_t off = base + (size_t)r * C + c;
      const float xh = __fmul_rn(__fsub_rn(ld(a, off), m), iv);
      float o = __fadd_rn(__fmul_rn(xh, ga), be);
      if (mode == APPLY_RELU) {
        o = fmaxf(o, 0.f);
      } else if (mode == APPLY_RESID_RELU) {
        o = fmaxf(__fadd_rn(o, ld(res, off)), 0.f);
      }
      st(out, off, o);
    }
  }
}

// The gradient the ReLU test lets through: z = xhat * gamma + beta (+ res
// for MASK_RESID), rounded as the plain version rounds it.
template <typename TO>
__device__ __forceinline__ float masked(float d, float xh, float ga,
                                        float be, const TO* res, size_t off,
                                        int mask) {
  if (mask == MASK_NONE) return d;
  float z = __fadd_rn(__fmul_rn(xh, ga), be);
  if (mask == MASK_RESID) z = __fadd_rn(z, ld(res, off));
  return z > 0.f ? d : 0.f;
}

// GroupNorm backward, pass 1: per-tile channel sums of the masked
// gradient dz and of dz * xhat -> partd[B][T][2][C].  With MASK_RESID
// the masked gradient is also written (the tail's dres).
template <typename TR, typename TG, typename TO>
__global__ void __launch_bounds__(NT) bwd_stats_kernel(
    const TR* __restrict__ raw, const TG* __restrict__ grad,
    const float* __restrict__ part_raw, const float* __restrict__ gamma,
    const float* __restrict__ beta, const TO* __restrict__ res,
    TO* __restrict__ dz_out, float* __restrict__ partd, int HW, int C, int G,
    int R, int ntiles, float count, float eps, int mask) {
  extern __shared__ float sh[];
  float* csum = sh;                 // [2][C]
  float* gmean = sh + 2 * C;        // [G]
  float* ginv = gmean + G;          // [G]
  float* red = ginv + G;            // [2][RP][CC]
  const int b = blockIdx.y, tile = blockIdx.x;
  fold_stats(part_raw + (size_t)b * ntiles * 2 * C, ntiles, C, G, count,
             eps, csum, gmean, ginv);
  const Lanes L(C);
  const int r0 = tile * R, r1 = min(HW, r0 + R), cg = C / G;
  const size_t base = (size_t)b * HW * C;
  float* out = partd + ((size_t)b * ntiles + tile) * 2 * C;
  for (int cb = 0; cb < C; cb += L.CC) {
    const int c = cb + L.cl;
    float s1 = 0.f, s2 = 0.f;
    if (L.rl < L.RP && c < C) {
      const float m = gmean[c / cg], iv = ginv[c / cg];
      const float ga = gamma[c], be = beta[c];
      for (int r = r0 + L.rl; r < r1; r += L.RP) {
        const size_t off = base + (size_t)r * C + c;
        const float xh = __fmul_rn(__fsub_rn(ld(raw, off), m), iv);
        const float d = masked(ld(grad, off), xh, ga, be, res, off, mask);
        if (mask == MASK_RESID) st(dz_out, off, d);
        s1 += d;
        s2 += d * xh;
      }
    }
    if (L.rl < L.RP) {
      red[L.rl * L.CC + L.cl] = s1;
      red[(L.RP + L.rl) * L.CC + L.cl] = s2;
    }
    __syncthreads();
    fold_lanes(red, out, L, cb, C);
    __syncthreads();
  }
}

// GroupNorm backward, pass 2: dbeta, dgamma per image (the tile-0 block
// writes them to per_image[2][B][C]) and the group terms from the
// partials, then dy_raw = inv * (dz * gamma - t1 / count - xhat * t2 /
// count), rounded once to TO.
template <typename TR, typename TG, typename TO>
__global__ void __launch_bounds__(NT) bwd_apply_kernel(
    const TR* __restrict__ raw, const TG* __restrict__ grad,
    const float* __restrict__ part_raw, const float* __restrict__ partd,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    TO* __restrict__ out, float* __restrict__ per_image, int B, int HW,
    int C, int G, int R, int ntiles, float count, float eps, int mask) {
  extern __shared__ float sh[];
  float* csum = sh;                 // [2][C]: raw sums, then dbeta, dgamma
  float* gmean = sh + 2 * C;        // [G]
  float* ginv = gmean + G;          // [G]
  float* u1 = ginv + G;             // [G]  sum(dz * gamma) / count
  float* u2 = u1 + G;               // [G]  sum(dz * gamma * xhat) / count
  const int b = blockIdx.y, tile = blockIdx.x;
  fold_stats(part_raw + (size_t)b * ntiles * 2 * C, ntiles, C, G, count,
             eps, csum, gmean, ginv);
  const float* pd = partd + (size_t)b * ntiles * 2 * C;
  for (int c = threadIdx.x; c < C; c += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      s1 += pd[(size_t)t * 2 * C + c];
      s2 += pd[(size_t)t * 2 * C + C + c];
    }
    csum[c] = s1;
    csum[C + c] = s2;
    if (tile == 0) {
      per_image[(size_t)b * C + c] = s2;            // dgamma
      per_image[((size_t)B + b) * C + c] = s1;      // dbeta
    }
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
    u1[g] = s1 / count;
    u2[g] = s2 / count;
  }
  __syncthreads();
  const Lanes L(C);
  if (L.rl >= L.RP) return;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  const size_t base = (size_t)b * HW * C;
  for (int cb = 0; cb < C; cb += L.CC) {
    const int c = cb + L.cl;
    if (c >= C) continue;
    const int g = c / cg;
    const float m = gmean[g], iv = ginv[g], ga = gamma[c], be = beta[c];
    const float t1 = u1[g], t2 = u2[g];
    for (int r = r0 + L.rl; r < r1; r += L.RP) {
      const size_t off = base + (size_t)r * C + c;
      const float xh = __fmul_rn(__fsub_rn(ld(raw, off), m), iv);
      const float d = masked(ld(grad, off), xh, ga, be,
                             static_cast<const TO*>(nullptr), off, mask);
      const float dzg = __fmul_rn(d, ga);
      st(out, off, __fmul_rn(iv, __fsub_rn(__fsub_rn(dzg, t1),
                                           __fmul_rn(xh, t2))));
    }
  }
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

// ---- 16-byte passes and folds of the bf16 backwards ----------------------

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

// out = [relu]((a - mean) * inv * gamma + beta), one rounding to TO.
template <typename TI, typename TO>
__global__ void __launch_bounds__(NT) apply8_kernel(
    const TI* __restrict__ a, const float* __restrict__ gst,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    TO* __restrict__ out, int HW, int C, int G, int R, int relu) {
  const Lanes8 L(C);
  if (L.rl >= L.RP) return;
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  const Cols8 p(gst, gamma, beta, b, 8 * L.v, C, G, false);
  const size_t base = (size_t)b * HW * C + 8 * L.v;
  for (int r = r0 + L.rl; r < r1; r += L.RP) {
    float x[8];
    load8(a + base + (size_t)r * C, x);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float xh = __fmul_rn(__fsub_rn(x[i], p.m[i]), p.iv[i]);
      const float o = __fadd_rn(__fmul_rn(xh, p.ga[i]), p.be[i]);
      x[i] = relu ? fmaxf(o, 0.f) : o;
    }
    store8(out + base + (size_t)r * C, x);
  }
}

// GroupNorm backward, first pass over a kept raw tensor: per-tile sums
// of the masked gradient dz and of dz * xhat -> partd[B][T][2][C].
template <typename TR, typename TG>
__global__ void __launch_bounds__(NT) bwd_stats8_kernel(
    const TR* __restrict__ raw, const TG* __restrict__ grad,
    const float* __restrict__ gst, const float* __restrict__ gamma,
    const float* __restrict__ beta, float* __restrict__ partd, int HW, int C,
    int G, int R, int ntiles, int mask) {
  extern __shared__ float red[];  // [2][RP][C]
  const Lanes8 L(C);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  float s1[8] = {}, s2[8] = {};
  if (L.rl < L.RP) {
    const Cols8 p(gst, gamma, beta, b, 8 * L.v, C, G, false);
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
        s1[i] += d[i];
        s2[i] += d[i] * xh;
      }
    }
  }
  fold_lanes8(red, s1, s2, partd + ((size_t)b * ntiles + tile) * 2 * C, L,
              C);
}

// GroupNorm backward, second pass over a kept raw tensor: dy_raw = inv *
// (dz * gamma - u1 - xhat * u2), rounded once to bf16.
template <typename TR, typename TG>
__global__ void __launch_bounds__(NT) bwd_apply8_kernel(
    const TR* __restrict__ raw, const TG* __restrict__ grad,
    const float* __restrict__ gst, const float* __restrict__ gamma,
    const float* __restrict__ beta, __nv_bfloat16* __restrict__ out, int HW,
    int C, int G, int R, int mask) {
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
template <typename TC>
__global__ void __launch_bounds__(256) gemm_fma_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm,
    TC* __restrict__ Cm, Gemm p) {
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
  TC* c = Cm + blockIdx.z * p.zstride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + ty + 16 * i;
    if (gm >= p.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx + 16 * j;
      if (gn < p.N) st(c, (size_t)gm * p.ldc + gn, acc[i][j]);
    }
  }
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pair(const unsigned short* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16 on the tensor cores: 64 x 64 tiles, 4 warps of 32 x 32, each a
// 2 x 4 grid of m16n8k16 products per 16-deep step.  Shared tiles hold
// bf16 bits with k contiguous (As[m][k], Bs[n][k]), the fragment layout
// of mma.sync's row-major A and column-major B.
template <typename TC>
__global__ void __launch_bounds__(128) gemm_mma_kernel(
    const unsigned short* __restrict__ A,
    const unsigned short* __restrict__ Bm, TC* __restrict__ Cm, Gemm p) {
  __shared__ __align__(16) unsigned short As[TILE][MMA_LD];
  __shared__ __align__(16) unsigned short Bs[TILE][MMA_LD];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4, wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int kbeg = blockIdx.z * p.kc, kend = min(p.K, kbeg + p.kc);
  float acc[2][4][4] = {};
  for (int k0 = kbeg; k0 < kend; k0 += MMA_K) {
#pragma unroll 4
    for (int i = 0; i < TILE * MMA_K / 128; ++i) {
      const int e = tid + i * 128;
      int m, k;
      if (p.sak == 1) { m = e / MMA_K; k = e % MMA_K; }
      else { k = e / TILE; m = e % TILE; }
      const int gm = m0 + m, gk = k0 + k;
      As[m][k] = (gm < p.M && gk < kend) ? A[gm * p.sam + gk * p.sak]
                                         : (unsigned short)0;
      int n;
      if (p.sbk == 1) { n = e / MMA_K; k = e % MMA_K; }
      else { k = e / TILE; n = e % TILE; }
      const int gn = n0 + n, gk2 = k0 + k;
      Bs[n][k] = (gn < p.N && gk2 < kend) ? Bm[gk2 * p.sbk + gn * p.sbn]
                                          : (unsigned short)0;
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < MMA_K; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + g;
        a[mi][0] = pair(&As[r][ks + 2 * t]);
        a[mi][1] = pair(&As[r + 8][ks + 2 * t]);
        a[mi][2] = pair(&As[r][ks + 2 * t + 8]);
        a[mi][3] = pair(&As[r + 8][ks + 2 * t + 8]);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int n = wn * 32 + ni * 8 + g;
        const uint32_t b0 = pair(&Bs[n][ks + 2 * t]);
        const uint32_t b1 = pair(&Bs[n][ks + 2 * t + 8]);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
  }
  TC* c = Cm + blockIdx.z * p.zstride;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int row = m0 + wm * 32 + mi * 16 + g;
      const int col = n0 + wn * 32 + ni * 8 + 2 * t;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int gm = row + 8 * h;
        if (gm >= p.M) continue;
        if (col < p.N) st(c, (size_t)gm * p.ldc + col, acc[mi][ni][2 * h]);
        if (col + 1 < p.N)
          st(c, (size_t)gm * p.ldc + col + 1, acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

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

dim3 gemm_grid(const Gemm& p, int chunks) {
  return dim3((p.N + TILE - 1) / TILE, (p.M + TILE - 1) / TILE, chunks);
}

template <typename TC>
int gemm(const float* A, const float* B, TC* C, Gemm p, int chunks,
         cudaStream_t s) {
  gemm_fma_kernel<TC><<<gemm_grid(p, chunks), 256, 0, s>>>(A, B, C, p);
  return (int)cudaGetLastError();
}

template <typename TC>
int gemm(const __nv_bfloat16* A, const __nv_bfloat16* B, TC* C, Gemm p,
         int chunks, cudaStream_t s) {
  gemm_mma_kernel<TC><<<gemm_grid(p, chunks), 128, 0, s>>>(
      reinterpret_cast<const unsigned short*>(A),
      reinterpret_cast<const unsigned short*>(B), C, p);
  return (int)cudaGetLastError();
}

// Shared memory of the norm passes: csum[2C], four [G] rows, red[2][RP][CC].
size_t norm_smem(int C, int G) {
  const int cc = C < NT ? C : NT;
  return sizeof(float) * (2 * C + 4 * G + 2 * (NT / cc) * cc);
}

// One launch's error, if any, returns from the caller.
#define CHECK(call)                  \
  do {                               \
    const int e_ = (call);           \
    if (e_ != 0) return e_;          \
  } while (0)

struct Rows {
  int B, HW, C, G, R, ntiles;
  float count;
  Rows(int b, int hw, int c, int g, int r)
      : B(b), HW(hw), C(c), G(g), R(r), ntiles((hw + r - 1) / r),
        count((float)hw * (float)(c / g)) {}
  dim3 grid() const { return dim3(ntiles, B); }
  size_t part() const { return (size_t)B * ntiles * 2 * C; }
};

template <typename TI>
int stats(const TI* a, float* part, const Rows& q, cudaStream_t s) {
  const int cc = q.C < NT ? q.C : NT;
  stats_kernel<TI><<<q.grid(), NT, sizeof(float) * 2 * (NT / cc) * cc, s>>>(
      a, part, q.HW, q.C, q.R, q.ntiles);
  return (int)cudaGetLastError();
}

template <typename TI, typename TO>
int apply(const TI* a, const float* part, const float* gamma,
          const float* beta, const TO* res, TO* out, const Rows& q,
          float eps, int mode, cudaStream_t s) {
  apply_kernel<TI, TO><<<q.grid(), NT, norm_smem(q.C, q.G), s>>>(
      a, part, gamma, beta, res, out, q.HW, q.C, q.G, q.R, q.ntiles, q.count,
      eps, mode);
  return (int)cudaGetLastError();
}

// The GroupNorm backward of raw -> (dy_raw in out, dgamma and dbeta
// folded over the images); part: [2] x the statistics' size, raw's sums
// (already taken) then the gradient's.
template <typename TR, typename TG, typename TO>
int norm_bwd(const TR* raw, const TG* grad, float* part, const float* gamma,
             const float* beta, const TO* res, TO* dz_out, TO* out,
             float* per_image, float* dgamma, float* dbeta, const Rows& q,
             float eps, int mask, cudaStream_t s) {
  float* partd = part + q.part();
  bwd_stats_kernel<TR, TG, TO><<<q.grid(), NT, norm_smem(q.C, q.G), s>>>(
      raw, grad, part, gamma, beta, res, dz_out, partd, q.HW, q.C, q.G, q.R,
      q.ntiles, q.count, eps, mask);
  CHECK((int)cudaGetLastError());
  // after MASK_RESID the gradient is the masked one just written
  const int mask2 = mask == MASK_RESID ? MASK_NONE : mask;
  if (mask == MASK_RESID) {
    bwd_apply_kernel<TR, TO, TO><<<q.grid(), NT, norm_smem(q.C, q.G), s>>>(
        raw, dz_out, part, partd, gamma, beta, out, per_image, q.B, q.HW,
        q.C, q.G, q.R, q.ntiles, q.count, eps, mask2);
  } else {
    bwd_apply_kernel<TR, TG, TO><<<q.grid(), NT, norm_smem(q.C, q.G), s>>>(
        raw, grad, part, partd, gamma, beta, out, per_image, q.B, q.HW, q.C,
        q.G, q.R, q.ntiles, q.count, eps, mask2);
  }
  CHECK((int)cudaGetLastError());
  fold2_kernel<<<dim3((q.C + 255) / 256, 2), 256, 0, s>>>(
      per_image, dgamma, dbeta, q.B, q.C);
  return (int)cudaGetLastError();
}

// The weight gradient a^T @ d over M rows of a [M, Ca] and d [M, Cd],
// in chunks of kc rows, folded in order into dw [Ca, Cd] f32.
template <typename T>
int weight_grad(const T* a, const T* d, float* dw_part, float* dw, int M,
                int Ca, int Cd, int chunks, int kc, cudaStream_t s) {
  const Gemm p = gemm_args(Ca, Cd, M, 1, Ca, Cd, 1, Cd, chunks, kc);
  CHECK(gemm(a, d, dw_part, p, chunks, s));
  const size_t n = (size_t)Ca * Cd;
  fold_kernel<<<(int)((n + 255) / 256), 256, 0, s>>>(dw_part, dw, chunks, n);
  return (int)cudaGetLastError();
}

template <typename T>
int conv_gn_fwd_t(const T* x, const T* w, const float* gamma,
                  const float* beta, T* y, float* ws, float* part, int B,
                  int HW, int Cin, int Cout, int G, int R, float eps, int relu,
                  cudaStream_t s) {
  const int M = B * HW;
  const Rows q(B, HW, Cout, G, R);
  CHECK(gemm(x, w, ws, gemm_args(M, Cout, Cin, Cin, 1, Cout, 1, Cout, 1, 0),
             1, s));
  CHECK(stats(ws, part, q, s));
  return apply(ws, part, gamma, beta, static_cast<const T*>(nullptr), y, q,
               eps, relu ? APPLY_RELU : APPLY_PLAIN, s);
}

template <typename T>
int conv_gn_bwd_t(const T* x, const T* w, const float* gamma,
                  const float* beta, const T* dy, T* dx, float* dw,
                  float* dgamma, float* dbeta, float* ws, T* dyb, float* part,
                  float* per_image, float* dw_part, int B, int HW, int Cin,
                  int Cout, int G, int R, int chunks, int kc, float eps,
                  int relu, cudaStream_t s) {
  const int M = B * HW;
  const Rows q(B, HW, Cout, G, R);
  // recompute the forward's product and its statistics
  CHECK(gemm(x, w, ws, gemm_args(M, Cout, Cin, Cin, 1, Cout, 1, Cout, 1, 0),
             1, s));
  CHECK(stats(ws, part, q, s));
  CHECK(norm_bwd(ws, dy, part, gamma, beta, static_cast<const T*>(nullptr),
                 static_cast<T*>(nullptr), dyb, per_image, dgamma, dbeta, q,
                 eps, relu ? MASK_RELU : MASK_NONE, s));
  // dx = dy_raw @ w^T
  CHECK(gemm(dyb, w, dx, gemm_args(M, Cin, Cout, Cout, 1, 1, Cout, Cin, 1, 0),
             1, s));
  return weight_grad(x, dyb, dw_part, dw, M, Cin, Cout, chunks, kc, s);
}

template <typename T>
int tail_fwd_t(const T* y2, const T* w, const float* g2, const float* b2,
               const float* g3, const float* b3, const T* res, T* out, T* hb,
               float* ws, float* part2, float* part3, int B, int HW, int Cm,
               int Cout, int G2, int G3, int R, float eps, cudaStream_t s) {
  const int M = B * HW;
  const Rows q2(B, HW, Cm, G2, R), q3(B, HW, Cout, G3, R);
  CHECK(stats(y2, part2, q2, s));
  CHECK(apply(y2, part2, g2, b2, static_cast<const T*>(nullptr), hb, q2, eps,
              APPLY_RELU, s));
  CHECK(gemm(hb, w, ws, gemm_args(M, Cout, Cm, Cm, 1, Cout, 1, Cout, 1, 0),
             1, s));
  CHECK(stats(ws, part3, q3, s));
  return apply(ws, part3, g3, b3, res, out, q3, eps, APPLY_RESID_RELU, s);
}

template <typename T>
int tail_bwd_t(const T* y2, const T* w, const float* g2, const float* b2,
               const float* g3, const float* b3, const T* res, const T* dout,
               T* dy2, float* dw, float* dg2, float* db2, float* dg3,
               float* db3, T* dres, T* hb, float* ws3, T* dy3b, float* ws2,
               float* part2, float* part3, float* per_image2,
               float* per_image3, float* dw_part, int B, int HW, int Cm,
               int Cout, int G2, int G3, int R, int chunks, int kc, float eps,
               cudaStream_t s) {
  const int M = B * HW;
  const Rows q2(B, HW, Cm, G2, R), q3(B, HW, Cout, G3, R);
  // recompute the forward chain up to y3
  CHECK(stats(y2, part2, q2, s));
  CHECK(apply(y2, part2, g2, b2, static_cast<const T*>(nullptr), hb, q2, eps,
              APPLY_RELU, s));
  CHECK(gemm(hb, w, ws3, gemm_args(M, Cout, Cm, Cm, 1, Cout, 1, Cout, 1, 0),
             1, s));
  CHECK(stats(ws3, part3, q3, s));
  // GN3's backward through the residual ReLU: dres, then dy3 rounded
  CHECK(norm_bwd(ws3, dout, part3, g3, b3, res, dres, dy3b, per_image3, dg3,
                 db3, q3, eps, MASK_RESID, s));
  CHECK(weight_grad(hb, dy3b, dw_part, dw, M, Cm, Cout, chunks, kc, s));
  // dh = dy3 @ w^T in f32, then GN2's backward through h's ReLU
  CHECK(gemm(dy3b, w, ws2, gemm_args(M, Cm, Cout, Cout, 1, 1, Cout, Cm, 1, 0),
             1, s));
  return norm_bwd(y2, ws2, part2, g2, b2, static_cast<const T*>(nullptr),
                  static_cast<T*>(nullptr), dy2, per_image2, dg2, db2, q2, eps,
                  MASK_RELU, s);
}

// ---- the bf16 backwards on the tensor cores (fused_gemm.cuh) ------------

using bf16 = __nv_bfloat16;

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
    const Rows q(B, HW, Cout, G, R);
    bwd_stats8_kernel<float, bf16><<<q.grid(), NT, red8_smem(Cout), s>>>(
        ws, dy, gst, gamma, beta, partd, HW, Cout, G, R, q.ntiles, mask);
    CHECK((int)cudaGetLastError());
    CHECK(group_grad(partd, q.ntiles, B, Cout, G, count, gamma, per_image,
                     dgamma, dbeta, gst, s));
    bwd_apply8_kernel<float, bf16><<<q.grid(), NT, 0, s>>>(
        ws, dy, gst, gamma, beta, dyb, HW, Cout, G, R, mask);
    CHECK((int)cudaGetLastError());
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
  stats8_kernel<bf16><<<q2.grid(), NT, red8_smem(Cm), s>>>(y2, part2, HW, Cm,
                                                           R, q2.ntiles);
  CHECK((int)cudaGetLastError());
  CHECK(group_stats(part2, q2.ntiles, B, Cm, G2, q2.count, eps, gst2, s));
  apply8_kernel<bf16, bf16><<<q2.grid(), NT, 0, s>>>(y2, gst2, g2, b2, hb,
                                                     HW, Cm, G2, R, 1);
  CHECK((int)cudaGetLastError());
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
  bwd_apply8_kernel<bf16, float><<<q2.grid(), NT, 0, s>>>(
      y2, ws2, gst2, g2, b2, dy2, HW, Cm, G2, R, MASK_NONE);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace fused_block

using namespace fused_block;

// dtype: 0 float32, 1 bfloat16.  Scratch (allocated by the caller):
// ws [B*HW, Cout] f32; part [B][ceil(HW/R)][2][Cout] f32.  Returns a
// cudaError_t (or -1 for an unknown dtype).
extern "C" int conv_gn_fwd(const void* x, const void* w, const float* gamma,
                           const float* beta, void* y, float* ws, float* part,
                           int B, int HW, int Cin, int Cout, int G, int R,
                           float eps, int relu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return conv_gn_fwd_t(static_cast<const float*>(x),
                         static_cast<const float*>(w), gamma, beta,
                         static_cast<float*>(y), ws, part, B, HW, Cin, Cout,
                         G, R, eps, relu, s);
  if (dtype == 1)
    return conv_gn_fwd_t(static_cast<const __nv_bfloat16*>(x),
                         static_cast<const __nv_bfloat16*>(w), gamma, beta,
                         static_cast<__nv_bfloat16*>(y), ws, part, B, HW, Cin,
                         Cout, G, R, eps, relu, s);
  return -1;
}

// f32: scratch ws [B*HW, Cout] f32, dyb [B*HW, Cout], part [2] x [B][T]
// [2][Cout] f32 (R-row tiles), per_image [2][B][Cout] f32, dw_part
// [chunks][Cin][Cout] f32; gst and store unused.  bf16: the tensor-core
// plan, conv_gn_bwd_tc's scratch (ws null unless store).  chunks, kc: the
// weight gradient's row chunks (kc a multiple of 64).
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
    return conv_gn_bwd_t(
        static_cast<const float*>(x), static_cast<const float*>(w), gamma,
        beta, static_cast<const float*>(dy), static_cast<float*>(dx), dw,
        dgamma, dbeta, ws, static_cast<float*>(dyb), part, per_image, dw_part,
        B, HW, Cin, Cout, G, R, chunks, kc, eps, relu, s);
  if (dtype == 1)
    return conv_gn_bwd_tc(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w), gamma, beta,
        static_cast<const bf16*>(dy), static_cast<bf16*>(dx), dw, dgamma,
        dbeta, ws, static_cast<bf16*>(dyb), part, per_image, dw_part, gst, B,
        HW, Cin, Cout, G, R, chunks, kc, store, eps, relu, s);
  return -1;
}

// Scratch: hb [B*HW, Cm] in y2's dtype, ws [B*HW, Cout] f32, part2
// [B][T][2][Cm], part3 [B][T][2][Cout] f32.
extern "C" int tail_fwd(const void* y2, const void* w, const float* g2,
                        const float* b2, const float* g3, const float* b3,
                        const void* res, void* out, void* hb, float* ws,
                        float* part2, float* part3, int B, int HW, int Cm,
                        int Cout, int G2, int G3, int R, float eps, int dtype,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return tail_fwd_t(static_cast<const float*>(y2),
                      static_cast<const float*>(w), g2, b2, g3, b3,
                      static_cast<const float*>(res), static_cast<float*>(out),
                      static_cast<float*>(hb), ws, part2, part3, B, HW, Cm,
                      Cout, G2, G3, R, eps, s);
  if (dtype == 1)
    return tail_fwd_t(static_cast<const __nv_bfloat16*>(y2),
                      static_cast<const __nv_bfloat16*>(w), g2, b2, g3, b3,
                      static_cast<const __nv_bfloat16*>(res),
                      static_cast<__nv_bfloat16*>(out),
                      static_cast<__nv_bfloat16*>(hb), ws, part2, part3, B,
                      HW, Cm, Cout, G2, G3, R, eps, s);
  return -1;
}

// f32: scratch hb [B*HW, Cm] and dy3b [B*HW, Cout], ws3 [B*HW, Cout] and
// ws2 [B*HW, Cm] f32, part2 [2][B][T][2][Cm], part3 [2][B][T][2][Cout],
// per_image2 [2][B][Cm], per_image3 [2][B][Cout], dw_part [chunks][Cm]
// [Cout] f32; gst2, gst3 unused.  bf16: tail_bwd_tc's scratch (ws3 null).
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
    return tail_bwd_t(
        static_cast<const float*>(y2), static_cast<const float*>(w), g2, b2,
        g3, b3, static_cast<const float*>(res),
        static_cast<const float*>(dout), static_cast<float*>(dy2), dw, dg2,
        db2, dg3, db3, static_cast<float*>(dres), static_cast<float*>(hb),
        ws3, static_cast<float*>(dy3b), ws2, part2, part3, per_image2,
        per_image3, dw_part, B, HW, Cm, Cout, G2, G3, R, chunks, kc, eps, s);
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
