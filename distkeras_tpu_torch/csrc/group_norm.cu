// GroupNorm forward and backward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernels distkeras_tpu/ops/pallas_kernels.py
// _fwd_kernel (reached through _fwd_call) and _bwd_kernel (through
// _bwd_call).  The same functions, not a block-by-block copy:
//   forward:  x [B, HW, C] (bf16 or f32), gamma, beta [C] f32 ->
//             y [B, HW, C] in x's dtype, mean and inv-std [B, G] f32;
//             per-group statistics in f32 as E[x^2] - E[x]^2, clamped
//             at 0, inv = rsqrt(var + eps); y = x * scale + shift with
//             scale = inv * gamma, shift = beta - mean * scale; an
//             optional ReLU (max(y, 0)); y rounded once to x's dtype.
//   backward: x, dy [B, HW, C], gamma, beta, mean, inv ->
//             dx [B, HW, C] in x's dtype, dgamma and dbeta per image
//             [B, C] f32 (the caller sums them over B).  x-hat is
//             recomputed from the saved statistics; with the ReLU, dy
//             is masked by the strict test xhat * gamma + beta > 0;
//             dx = inv * (dy*gamma - t1/count - xhat * t2/count) with
//             t1, t2 the per-group sums of dy*gamma and dy*gamma*xhat.
//
// Bound on the H100: a few operations per element, so memory bounds
// both: the forward reads x and writes y (4 bytes an element in bf16),
// the backward reads x and dy and writes dx (6 bytes); at 3.35 TB/s the
// ResNet-50 stem's [32, 12544, 64] bf16 takes 15 us forward, 23 us
// backward.
//
// Design.  The TPU kernel holds one whole image in VMEM per grid step
// and reduces channels to groups with a [C, G] mask product (a lane
// layout trick).  Here a group is a run of C/G adjacent channels of
// every [HW, C] row, and one image per block would leave most of the
// 132 SMs idle at batch 32.  So each direction is two grid passes over
// (row tile, image) blocks of about TILE elements:
//   1. a statistics pass: each thread owns a fixed 16-byte vector of
//      channels and walks the tile's rows with coalesced loads,
//      accumulating f32 sums; the block folds its row lanes in shared
//      memory in a fixed order and writes per-tile partial sums
//      (forward: per group, sum x and sum x^2; backward: per channel,
//      sum dy and sum dy*xhat);
//   2. an apply pass: each block folds its image's tile partials in a
//      fixed order (the result is the same in every block, and the
//      tile-0 block writes mean/inv or dgamma/dbeta), then streams the
//      tile once more and writes y or dx.
// Sums are taken in a fixed order, so a run is deterministic.  Each
// element is read twice (once per pass) and written once; the second
// read often hits the 50 MB L2.  One fused pass (a cluster per image
// exchanging partials through distributed shared memory) is the
// later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;  // threads per block

template <typename T>
struct Pack {
  static constexpr int N = 16 / sizeof(T);  // elements in 16 bytes
};

template <typename T, int V>
__device__ __forceinline__ void load_v(const T* p, float* o);
template <>
__device__ __forceinline__ void load_v<float, 4>(const float* p, float* o) {
  float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
template <>
__device__ __forceinline__ void load_v<float, 1>(const float* p, float* o) {
  o[0] = *p;
}
template <>
__device__ __forceinline__ void load_v<__nv_bfloat16, 8>(
    const __nv_bfloat16* p, float* o) {
  uint4 a = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
template <>
__device__ __forceinline__ void load_v<__nv_bfloat16, 1>(
    const __nv_bfloat16* p, float* o) {
  o[0] = __bfloat162float(*p);
}

template <typename T, int V>
__device__ __forceinline__ void store_v(T* p, const float* o);
template <>
__device__ __forceinline__ void store_v<float, 4>(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
template <>
__device__ __forceinline__ void store_v<float, 1>(float* p, const float* o) {
  *p = o[0];
}
template <>
__device__ __forceinline__ void store_v<__nv_bfloat16, 8>(
    __nv_bfloat16* p, const float* o) {
  uint4 a;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&a);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = a;
}
template <>
__device__ __forceinline__ void store_v<__nv_bfloat16, 1>(
    __nv_bfloat16* p, const float* o) {
  *p = __float2bfloat16(o[0]);
}

// The pre-ReLU value the backward recomputes, xhat * gamma + beta,
// rounded after the product and after the sum as the plain version
// rounds it (no fused multiply-add), so both take the same ReLU mask
// from the same statistics.  The forward's y and the backward's dx are
// rounded the same way for the same reason.
__device__ __forceinline__ float relu_z(float xh, float ga, float be) {
  return __fadd_rn(__fmul_rn(xh, ga), be);
}

// The lane layout every kernel shares: a row holds CV = C/V vectors;
// CVc = min(CV, NT) of them are covered per chunk, by RP = NT/CVc row
// lanes.  Thread t owns vector vl = t % CVc of each chunk and walks the
// rows rl, rl + RP, ... of the tile (threads with rl >= RP idle).
struct Lanes {
  int CV, CVc, RP, vl, rl;
  __device__ Lanes(int C, int V) {
    CV = C / V;
    CVc = CV < NT ? CV : NT;
    RP = NT / CVc;
    vl = threadIdx.x % CVc;
    rl = threadIdx.x / CVc;
  }
};

// Folds the row lanes' per-vector sums (red: [2][RP][CVc*V], filled by
// every active thread) into out[0..C) and out[C..2C) for the chunk
// starting at vector vb, in a fixed order.
__device__ __forceinline__ void fold_lanes(const float* red, float* out,
                                           const Lanes& L, int V, int vb,
                                           int C) {
  int w = L.CVc * V;
  for (int i = threadIdx.x; i < w; i += NT) {
    int c = vb * V + i;
    if (c >= C) continue;
    float s1 = 0.f, s2 = 0.f;
    for (int r = 0; r < L.RP; ++r) {
      s1 += red[r * w + i];
      s2 += red[(L.RP + r) * w + i];
    }
    out[c] = s1;
    out[C + c] = s2;
  }
}

// Forward pass 1: per-tile group sums of x and x^2 -> part[B][T][2][G].
template <typename T, int V>
__global__ void __launch_bounds__(NT) fwd_stats_kernel(
    const T* __restrict__ x, float* __restrict__ part, int HW, int C,
    int G, int R, int ntiles) {
  extern __shared__ float sh[];
  const Lanes L(C, V);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  float* red = sh;                           // [2][RP][CVc*V]
  float* csum = sh + 2 * L.RP * L.CVc * V;   // [2][C]
  const T* xb = x + (size_t)b * HW * C;
  const int w = L.CVc * V;
  for (int vb = 0; vb < L.CV; vb += L.CVc) {
    const int v = vb + L.vl;
    float a1[V], a2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
    if (L.rl < L.RP && v < L.CV) {
#pragma unroll 4
      for (int r = r0 + L.rl; r < r1; r += L.RP) {
        float f[V];
        load_v<T, V>(xb + (size_t)r * C + v * V, f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          a1[j] += f[j];
          a2[j] += f[j] * f[j];
        }
      }
    }
    if (L.rl < L.RP) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[L.rl * w + L.vl * V + j] = a1[j];
        red[(L.RP + L.rl) * w + L.vl * V + j] = a2[j];
      }
    }
    __syncthreads();
    fold_lanes(red, csum, L, V, vb, C);
    __syncthreads();
  }
  const int cg = C / G;
  float* p = part + ((size_t)b * ntiles + tile) * 2 * G;
  for (int g = threadIdx.x; g < G; g += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < cg; ++k) {
      s1 += csum[g * cg + k];
      s2 += csum[C + g * cg + k];
    }
    p[g] = s1;
    p[G + g] = s2;
  }
}

// Forward pass 2: statistics from the partials, then y.
template <typename T, int V>
__global__ void __launch_bounds__(NT) fwd_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ part,
    T* __restrict__ y, float* __restrict__ mean_out,
    float* __restrict__ inv_out, int HW, int C, int G, int R, int ntiles,
    float count, float eps, int relu) {
  extern __shared__ float sh[];
  float* scale = sh;        // [C]
  float* shift = sh + C;    // [C]
  float* gmean = sh + 2 * C;      // [G]
  float* ginv = sh + 2 * C + G;   // [G]
  const int b = blockIdx.y, tile = blockIdx.x;
  const float* pb = part + (size_t)b * ntiles * 2 * G;
  for (int g = threadIdx.x; g < G; g += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < ntiles; ++k) {
      s1 += pb[k * 2 * G + g];
      s2 += pb[k * 2 * G + G + g];
    }
    const float m = s1 / count;
    const float var = fmaxf(s2 / count - m * m, 0.f);
    const float inv = rsqrtf(var + eps);
    gmean[g] = m;
    ginv[g] = inv;
    if (tile == 0) {
      mean_out[b * G + g] = m;
      inv_out[b * G + g] = inv;
    }
  }
  __syncthreads();
  const int cg = C / G;
  for (int c = threadIdx.x; c < C; c += NT) {
    const float s = ginv[c / cg] * gamma[c];
    scale[c] = s;
    shift[c] = __fsub_rn(beta[c], __fmul_rn(gmean[c / cg], s));
  }
  __syncthreads();
  const Lanes L(C, V);
  if (L.rl >= L.RP) return;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  const size_t base = (size_t)b * HW * C;
  for (int vb = 0; vb < L.CV; vb += L.CVc) {
    const int v = vb + L.vl;
    if (v >= L.CV) continue;
    float sc[V], sf[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      sc[j] = scale[v * V + j];
      sf[j] = shift[v * V + j];
    }
#pragma unroll 4
    for (int r = r0 + L.rl; r < r1; r += L.RP) {
      const size_t off = base + (size_t)r * C + v * V;
      float f[V];
      load_v<T, V>(x + off, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float o = __fadd_rn(__fmul_rn(f[j], sc[j]), sf[j]);
        f[j] = relu ? fmaxf(o, 0.f) : o;
      }
      store_v<T, V>(y + off, f);
    }
  }
}

// Backward pass 1: per-tile channel sums of the (masked) dy and of
// dy * xhat -> part[B][T][2][C].
template <typename T, int V>
__global__ void __launch_bounds__(NT) bwd_stats_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ mean, const float* __restrict__ inv,
    float* __restrict__ part, int HW, int C, int G, int R, int ntiles,
    int relu) {
  extern __shared__ float sh[];
  const Lanes L(C, V);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  float* red = sh;  // [2][RP][CVc*V]
  float* out = part + ((size_t)b * ntiles + tile) * 2 * C;
  const size_t base = (size_t)b * HW * C;
  const int w = L.CVc * V, cg = C / G;
  for (int vb = 0; vb < L.CV; vb += L.CVc) {
    const int v = vb + L.vl;
    float a1[V], a2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
    if (L.rl < L.RP && v < L.CV) {
      float mc[V], ic[V], ga[V], be[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int c = v * V + j;
        mc[j] = mean[b * G + c / cg];
        ic[j] = inv[b * G + c / cg];
        ga[j] = gamma[c];
        be[j] = beta[c];
      }
#pragma unroll 4
      for (int r = r0 + L.rl; r < r1; r += L.RP) {
        const size_t off = base + (size_t)r * C + v * V;
        float xf[V], df[V];
        load_v<T, V>(x + off, xf);
        load_v<T, V>(dy + off, df);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const float xh = (xf[j] - mc[j]) * ic[j];
          const float d = (relu && !(relu_z(xh, ga[j], be[j]) > 0.f))
                              ? 0.f : df[j];
          a1[j] += d;
          a2[j] += d * xh;
        }
      }
    }
    if (L.rl < L.RP) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        red[L.rl * w + L.vl * V + j] = a1[j];
        red[(L.RP + L.rl) * w + L.vl * V + j] = a2[j];
      }
    }
    __syncthreads();
    fold_lanes(red, out, L, V, vb, C);
    __syncthreads();
  }
}

// Backward pass 2: dbeta, dgamma and the group terms from the
// partials, then dx.
template <typename T, int V>
__global__ void __launch_bounds__(NT) bwd_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ mean, const float* __restrict__ inv,
    const float* __restrict__ part, T* __restrict__ dx,
    float* __restrict__ dgamma_b, float* __restrict__ dbeta_b, int HW,
    int C, int G, int R, int ntiles, float count, int relu) {
  extern __shared__ float sh[];
  float* db = sh;              // [C]
  float* dg = sh + C;          // [C]
  float* t1 = sh + 2 * C;      // [G]  sum(dy*gamma) / count
  float* t2 = sh + 2 * C + G;  // [G]  sum(dy*gamma*xhat) / count
  const int b = blockIdx.y, tile = blockIdx.x;
  const float* pb = part + (size_t)b * ntiles * 2 * C;
  for (int c = threadIdx.x; c < C; c += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < ntiles; ++k) {
      s1 += pb[k * 2 * C + c];
      s2 += pb[k * 2 * C + C + c];
    }
    db[c] = s1;
    dg[c] = s2;
    if (tile == 0) {
      dbeta_b[b * C + c] = s1;
      dgamma_b[b * C + c] = s2;
    }
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < cg; ++k) {
      const int c = g * cg + k;
      s1 += gamma[c] * db[c];
      s2 += gamma[c] * dg[c];
    }
    t1[g] = s1 / count;
    t2[g] = s2 / count;
  }
  __syncthreads();
  const Lanes L(C, V);
  if (L.rl >= L.RP) return;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  const size_t base = (size_t)b * HW * C;
  for (int vb = 0; vb < L.CV; vb += L.CVc) {
    const int v = vb + L.vl;
    if (v >= L.CV) continue;
    float mc[V], ic[V], ga[V], be[V], u1[V], u2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = v * V + j, g = c / cg;
      mc[j] = mean[b * G + g];
      ic[j] = inv[b * G + g];
      ga[j] = gamma[c];
      be[j] = beta[c];
      u1[j] = t1[g];
      u2[j] = t2[g];
    }
#pragma unroll 4
    for (int r = r0 + L.rl; r < r1; r += L.RP) {
      const size_t off = base + (size_t)r * C + v * V;
      float xf[V], df[V];
      load_v<T, V>(x + off, xf);
      load_v<T, V>(dy + off, df);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xf[j] - mc[j]) * ic[j];
        const float d = (relu && !(relu_z(xh, ga[j], be[j]) > 0.f))
                            ? 0.f : df[j];
        xf[j] = __fmul_rn(ic[j], __fsub_rn(__fsub_rn(__fmul_rn(d, ga[j]), u1[j]),
                                           __fmul_rn(xh, u2[j])));
      }
      store_v<T, V>(dx + off, xf);
    }
  }
}

inline int stats_smem(int C, int V) {
  int cv = C / V, cvc = cv < NT ? cv : NT, rp = NT / cvc;
  return (int)sizeof(float) * (2 * rp * cvc * V + 2 * C);
}

inline bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int V>
int fwd(const void* x, const float* gamma, const float* beta, void* y,
        float* mean, float* inv, float* part, int B, int HW, int C, int G,
        int R, float count, float eps, int relu, cudaStream_t s) {
  const int ntiles = (HW + R - 1) / R;
  dim3 grid(ntiles, B);
  fwd_stats_kernel<T, V><<<grid, NT, stats_smem(C, V), s>>>(
      static_cast<const T*>(x), part, HW, C, G, R, ntiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fwd_apply_kernel<T, V><<<grid, NT, sizeof(float) * (2 * C + 2 * G), s>>>(
      static_cast<const T*>(x), gamma, beta, part, static_cast<T*>(y),
      mean, inv, HW, C, G, R, ntiles, count, eps, relu);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int bwd(const void* x, const void* dy, const float* gamma,
        const float* beta, const float* mean, const float* inv, void* dx,
        float* dgamma_b, float* dbeta_b, float* part, int B, int HW, int C,
        int G, int R, float count, int relu, cudaStream_t s) {
  const int ntiles = (HW + R - 1) / R;
  dim3 grid(ntiles, B);
  // the backward's pass 1 folds into part directly: only [2][RP][CVc*V]
  const int smem1 = stats_smem(C, V) - (int)sizeof(float) * 2 * C;
  bwd_stats_kernel<T, V><<<grid, NT, smem1, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, beta,
      mean, inv, part, HW, C, G, R, ntiles, relu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_apply_kernel<T, V><<<grid, NT, sizeof(float) * (2 * C + 2 * G), s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, beta,
      mean, inv, part, static_cast<T*>(dx), dgamma_b, dbeta_b, HW, C, G, R,
      ntiles, count, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  R: rows per tile; part: scratch of
// B * ceil(HW/R) * 2 * G floats.  16-byte vectors where C and every
// pointer allow, single elements otherwise.  Returns a cudaError_t.
extern "C" int group_norm_fwd(const void* x, const float* gamma,
                              const float* beta, void* y, float* mean,
                              float* inv, float* part, int B, int HW,
                              int C, int G, int R, float count, float eps,
                              int relu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(x) && aligned(y);
  if (dtype == 0) {
    if (vec && C % Pack<float>::N == 0)
      return fwd<float, 4>(x, gamma, beta, y, mean, inv, part, B, HW, C, G,
                           R, count, eps, relu, s);
    return fwd<float, 1>(x, gamma, beta, y, mean, inv, part, B, HW, C, G,
                         R, count, eps, relu, s);
  }
  if (dtype == 1) {
    if (vec && C % Pack<__nv_bfloat16>::N == 0)
      return fwd<__nv_bfloat16, 8>(x, gamma, beta, y, mean, inv, part, B,
                                   HW, C, G, R, count, eps, relu, s);
    return fwd<__nv_bfloat16, 1>(x, gamma, beta, y, mean, inv, part, B, HW,
                                 C, G, R, count, eps, relu, s);
  }
  return -1;
}

// part: scratch of B * ceil(HW/R) * 2 * C floats.
extern "C" int group_norm_bwd(const void* x, const void* dy,
                              const float* gamma, const float* beta,
                              const float* mean, const float* inv, void* dx,
                              float* dgamma_b, float* dbeta_b, float* part,
                              int B, int HW, int C, int G, int R,
                              float count, int relu, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(x) && aligned(dy) && aligned(dx);
  if (dtype == 0) {
    if (vec && C % Pack<float>::N == 0)
      return bwd<float, 4>(x, dy, gamma, beta, mean, inv, dx, dgamma_b,
                           dbeta_b, part, B, HW, C, G, R, count, relu, s);
    return bwd<float, 1>(x, dy, gamma, beta, mean, inv, dx, dgamma_b,
                         dbeta_b, part, B, HW, C, G, R, count, relu, s);
  }
  if (dtype == 1) {
    if (vec && C % Pack<__nv_bfloat16>::N == 0)
      return bwd<__nv_bfloat16, 8>(x, dy, gamma, beta, mean, inv, dx,
                                   dgamma_b, dbeta_b, part, B, HW, C, G, R,
                                   count, relu, s);
    return bwd<__nv_bfloat16, 1>(x, dy, gamma, beta, mean, inv, dx,
                                 dgamma_b, dbeta_b, part, B, HW, C, G, R,
                                 count, relu, s);
  }
  return -1;
}
