// Flash-attention backward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernels distkeras_tpu/ops/attention.py:_dq_kernel and
// _dkv_kernel (reached through _bwd_call under the custom VJP of
// flash_attention).  The same split into two kernels, which needs no
// atomics: one computes dq, the other dk and dv.  Same function, not a
// block-by-block copy:
//   q, k, v, do, dq, dk, dv [B, H, T, D] in the input dtype (bf16 or
//   f32); lse and dsum = rowsum(f32(dout) * f32(out)) [B, H, T] f32,
//   computed outside the kernels as the TPU path does;
//   p = exp(f32 logits - lse), zero where masked; dp = do.v^T in f32;
//   ds = p * (dp - dsum) * scale in f32, rounded to the input dtype
//   before ds.k and ds^T.q; p rounded to the input dtype before p^T.do;
//   f32 accumulators, written once in the input dtype.
//
// Bound on the H100: the backward does five T x T x D products per head
// (q.k^T, do.v^T, p^T.do, ds.k, ds^T.q; 10*B*H*T*T*D operations, half
// that when causal) on 7 tensors of B*H*T*D elements (q, k, v, do read,
// dq, dk, dv written) plus two f32 rows.  At the training path's
// [8, 12, 1024, 64] bf16 causal that is 32 GFLOP against 89 MB: the
// tensor cores bound it (33 us at 989 TFLOP/s; the bytes take 27 us at
// 3.35 TB/s).  The split recomputes q.k^T and do.v^T in both kernels,
// 7 products instead of 5.
//
// Design: the forward kernel's layout, twice.  256 threads per block;
// four threads own one row of the block's resident 64-row tile and
// each scores 16 of the other operand's 64 columns; the tiles are
// staged in shared memory as f32 with rows padded by one word, so
// neighbouring rows sit in different banks.
//   dq kernel: one block per (b, h, 64-row q tile); q and do stay
//     resident, a loop over the k/v tiles up to the causal diagonal takes
//     the place of the TPU's sequential grid axis.  ds goes through
//     shared memory (the row's four threads share a warp, so a __syncwarp
//     orders it) and each thread accumulates D/4 columns of dq.
//   dkv kernel: one block per (b, h, 64-row k tile); k and v stay
//     resident, a loop over the q/do tiles from the diagonal to the end;
//     the thread that owns k row r computes column r of p and ds, and
//     dk and dv accumulate in f32 registers, D/4 columns each.
// Shared memory is the constraint at D=128: four f32 tiles of 64 x 129
// words plus the p/ds tiles take 162 KB in the dkv kernel, above the
// 48 KB default, so the first launch on a device raises the kernel's
// dynamic limit (cudaFuncAttributeMaxDynamicSharedMemorySize; one block
// per SM).  The
// products run as FMAs on the CUDA cores, not on the tensor cores, so
// this first version is bound by shared-memory reads and sits far from
// the bound above; mma/wgmma tiles with TMA staging are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;         // q rows per tile
constexpr int BN = 64;         // k rows per tile
constexpr int TPR = 4;         // threads per resident row
constexpr int NTHREADS = 64 * TPR;
constexpr float NEG = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to T and widened back: the TPU kernels' .astype(input dtype)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// rows [r0, r0 + 64) of a [T, D] slab into a padded f32 tile, zero past Tn
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int Tn, int tid) {
  constexpr int LD = D + 1;
  for (int i = tid; i < 64 * D; i += NTHREADS) {
    const int rr = i / D, dd = i % D, g = r0 + rr;
    dst[rr * LD + dd] = g < Tn ? to_f(src[(size_t)g * D + dd]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + BM * (BN + 1));
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BN * (BM + 1) + 2 * BM);
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ dq, int H, int Tn, float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LDS = BN + 1;
  constexpr int DPT = D / TPR;   // dq columns per thread
  constexpr int NPT = BN / TPR;  // score columns per thread
  extern __shared__ float smem[];
  float* qs = smem;              // [BM][LD]
  float* dos = qs + BM * LD;     // [BM][LD]
  float* ks = dos + BM * LD;     // [BN][LD]
  float* vs = ks + BN * LD;      // [BN][LD]
  float* dss = vs + BN * LD;     // [BM][LDS]

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t base = bh * (size_t)Tn * D;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x;
  const int r = tid / TPR, sub = tid % TPR;
  const int row = q0 + r;

  load_tile<T, D>(qs, q + base, q0, Tn, tid);
  load_tile<T, D>(dos, dout + base, q0, Tn, tid);
  const float lse_r = row < Tn ? lse[bh * Tn + row] : 0.f;
  const float dsum_r = row < Tn ? dsum[bh * Tn + row] : 0.f;

  float acc[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

  int n_tiles = (Tn + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(ks, k + base, k0, Tn, tid);
    load_tile<T, D>(vs, v + base, k0, Tn, tid);
    __syncthreads();

    float s[NPT], dp[NPT];
#pragma unroll
    for (int c = 0; c < NPT; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 8) {
      float qr[8], dr[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        qr[e] = qs[r * LD + d0 + e];
        dr[e] = dos[r * LD + d0 + e];
      }
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        const float* kr = ks + (sub + TPR * c) * LD + d0;
        const float* vr = vs + (sub + TPR * c) * LD + d0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s[c] = fmaf(qr[e], kr[e], s[c]);
          dp[c] = fmaf(dr[e], vr[e], dp[c]);
        }
      }
    }

#pragma unroll
    for (int c = 0; c < NPT; ++c) {
      const int col = k0 + sub + TPR * c;
      const bool masked = col >= Tn || row >= Tn || (causal && col > row);
      const float p = masked ? 0.f : expf(s[c] * scale - lse_r);
      const float ds = p * (dp[c] - dsum_r) * scale;
      dss[r * LDS + sub + TPR * c] = round_to<T>(ds);
    }
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < BN; ++c) {
      const float d = dss[r * LDS + c];
      const float* kr = ks + c * LD + sub;
#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] = fmaf(d, kr[TPR * i], acc[i]);
    }
  }

  if (row < Tn) {
    T* o = dq + base + (size_t)row * D + sub;
#pragma unroll
    for (int i = 0; i < DPT; ++i) o[TPR * i] = from_f<T>(acc[i]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dsum,
           T* __restrict__ dk, T* __restrict__ dv, int H, int Tn,
           float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int LDP = BM + 1;
  constexpr int DPT = D / TPR;   // dk and dv columns per thread
  constexpr int NPT = BM / TPR;  // q rows scored per thread
  extern __shared__ float smem[];
  float* ks = smem;              // [BN][LD]
  float* vs = ks + BN * LD;      // [BN][LD]
  float* qs = vs + BN * LD;      // [BM][LD]
  float* dos = qs + BM * LD;     // [BM][LD]
  float* ps = dos + BM * LD;     // [BN][LDP], p^T in the input dtype
  float* dss = ps + BN * LDP;    // [BN][LDP], ds^T in the input dtype
  float* lse_s = dss + BN * LDP; // [BM]
  float* dsum_s = lse_s + BM;    // [BM]

  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t base = bh * (size_t)Tn * D;
  const int k0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int r = tid / TPR, sub = tid % TPR;
  const int krow = k0 + r;

  load_tile<T, D>(ks, k + base, k0, Tn, tid);
  load_tile<T, D>(vs, v + base, k0, Tn, tid);

  float acc_k[DPT], acc_v[DPT];
#pragma unroll
  for (int i = 0; i < DPT; ++i) acc_k[i] = acc_v[i] = 0.f;

  const int n_q = (Tn + BM - 1) / BM;
  // the first q tile whose last row reaches this k tile's first row
  const int i0 = causal ? k0 / BM : 0;

  for (int it = i0; it < n_q; ++it) {
    const int q0 = it * BM;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(qs, q + base, q0, Tn, tid);
    load_tile<T, D>(dos, dout + base, q0, Tn, tid);
    if (tid < BM) {
      const int g = q0 + tid;
      lse_s[tid] = g < Tn ? lse[bh * Tn + g] : 0.f;
      dsum_s[tid] = g < Tn ? dsum[bh * Tn + g] : 0.f;
    }
    __syncthreads();

    float s[NPT], dp[NPT];
#pragma unroll
    for (int c = 0; c < NPT; ++c) s[c] = dp[c] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < D; d0 += 8) {
      float kr[8], vr[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        kr[e] = ks[r * LD + d0 + e];
        vr[e] = vs[r * LD + d0 + e];
      }
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        const float* qr = qs + (sub + TPR * c) * LD + d0;
        const float* dr = dos + (sub + TPR * c) * LD + d0;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          s[c] = fmaf(qr[e], kr[e], s[c]);
          dp[c] = fmaf(dr[e], vr[e], dp[c]);
        }
      }
    }

#pragma unroll
    for (int c = 0; c < NPT; ++c) {
      const int qi = sub + TPR * c, qrow = q0 + qi;
      const bool masked =
          qrow >= Tn || krow >= Tn || (causal && krow > qrow);
      const float p = masked ? 0.f : expf(s[c] * scale - lse_s[qi]);
      const float ds = p * (dp[c] - dsum_s[qi]) * scale;
      ps[r * LDP + qi] = round_to<T>(p);
      dss[r * LDP + qi] = round_to<T>(ds);
    }
    __syncwarp();

#pragma unroll 4
    for (int c = 0; c < BM; ++c) {
      const float p = ps[r * LDP + c];
      const float d = dss[r * LDP + c];
      const float* dr = dos + c * LD + sub;
      const float* qr = qs + c * LD + sub;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        acc_v[i] = fmaf(p, dr[TPR * i], acc_v[i]);
        acc_k[i] = fmaf(d, qr[TPR * i], acc_k[i]);
      }
    }
  }

  if (krow < Tn) {
    const size_t off = base + (size_t)krow * D + sub;
#pragma unroll
    for (int i = 0; i < DPT; ++i) {
      dk[off + TPR * i] = from_f<T>(acc_k[i]);
      dv[off + TPR * i] = from_f<T>(acc_v[i]);
    }
  }
}

// Raise the kernel's dynamic shared-memory limit once per device (and so
// outside any later CUDA-graph capture); setting the same value twice
// from racing threads is benign.
template <typename K>
int configure(K kernel, size_t smem, bool* configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return -1;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured[dev] = true;
  }
  return 0;
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, void* dq, int B, int H,
              int Tn, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<D>();
  static bool configured[64] = {};
  int err = configure(dq_kernel<T, D>, smem, configured);
  if (err != 0) return err;
  dim3 grid((Tn + BM - 1) / BM, H, B);
  dq_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dq), H, Tn, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* dsum,
               void* dk, void* dv, int B, int H, int Tn, float scale,
               int causal, cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  static bool configured[64] = {};
  int err = configure(dkv_kernel<T, D>, smem, configured);
  if (err != 0) return err;
  dim3 grid((Tn + BN - 1) / BN, H, B);
  dkv_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum,
      static_cast<T*>(dk), static_cast<T*>(dv), H, Tn, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError()
// after its launch (0 on success); -1 for a head size or dtype not
// built, or a device index past 63.
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* dsum,
                                      void* dq, int B, int H, int Tn, int D,
                                      float scale, int causal, int dtype,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, dsum, dq, B, H, Tn,
                                scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, dsum, dq, B, H, Tn,
                                 scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, dsum, dq, B, H,
                                        Tn, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, dsum, dq, B, H,
                                         Tn, scale, causal, s);
  return -1;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* dsum,
                                       void* dk, void* dv, int B, int H,
                                       int Tn, int D, float scale,
                                       int causal, int dtype,
                                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, dsum, dk, dv, B, H, Tn,
                                 scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, dsum, dk, dv, B, H,
                                  Tn, scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, dsum, dk, dv,
                                         B, H, Tn, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, dsum, dk, dv,
                                          B, H, Tn, scale, causal, s);
  return -1;
}
