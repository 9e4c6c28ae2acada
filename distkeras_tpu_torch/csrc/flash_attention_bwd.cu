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
// 7 products instead of 5: the dq kernel's 3 bound it at 20 us, the dk/dv
// kernel's 4 at 26 us.
//
// bf16 (the path's dtype): the tensor-core tile bodies of
// flash_bwd_mma.cuh.  128 threads per block, each of 4 warps owning 16
// rows of the resident 64-row tile; every product is mma.sync m16n8k16
// with f32 accumulators; operands stay bf16 in shared memory (rows padded
// by 16 bytes for ldmatrix), copied in by 16-byte cp.async, the streamed
// tiles double buffered; p and ds pass from one product's accumulators to
// the next product's A operand in registers.
//   dq kernel: one block per (b, h, 64-row q tile); q and do resident, a
//     loop over the k/v tiles up to the causal diagonal takes the place of
//     the TPU's sequential grid axis.
//   dkv kernel: one block per (b, h, 64-row k tile); k and v resident, a
//     loop over the q/do tiles from the diagonal to the end.
// mma.sync, not wgmma: the A operands p^T and ds^T come from registers of
// a 16-row warp tile, and the library's own flash backward is an mma.sync
// design; its rate leaves the bf16 kernels within a few times of it.
// Shared memory: 55 KB (D 64) and 102 KB (D 128) a block, above the 48 KB
// default, so the first launch on a device raises the kernel's dynamic
// limit (cudaFuncAttributeMaxDynamicSharedMemorySize).
//
// f32: the first version's layout, kept as it was (TF32 would miss the
// f32 limit of 1e-5).  256 threads per block; four threads own one row of
// the resident 64-row tile and each scores 16 of the other operand's 64
// columns; tiles staged in shared memory as f32 with rows padded by one
// word; the products run as FMAs on the CUDA cores, bound by shared-memory
// reads.  The dkv kernel's tiles take 162 KB at D 128, one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_bwd_mma.cuh"

namespace {

using flash_bwd_mma::configure;
using flash_bwd_mma::on_tensor_cores;

constexpr int BM = 64;         // q rows per tile
constexpr int BN = 64;         // k rows per tile
constexpr int TPR = 4;         // threads per resident row
constexpr int NTHREADS = 64 * TPR;

// threads per block: the mma tiles' 4 warps, or the FMA tiles' 256
template <typename T>
struct Threads {
  static constexpr int value =
      on_tensor_cores<T>() ? flash_bwd_mma::NTHREADS : NTHREADS;
};

// the FMA tiles run f32 only: no conversion on load, rounding or store
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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
__global__ void __launch_bounds__(Threads<T>::value)
dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, const T* __restrict__ dout,
          const float* __restrict__ lse, const float* __restrict__ dsum,
          T* __restrict__ dq, int H, int Tn, float scale, int causal) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t base = bh * (size_t)Tn * D;
  const int q0 = blockIdx.x * BM;
  int n_tiles = (Tn + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

  if constexpr (on_tensor_cores<T>()) {
    float acc[D / 8][4];
    flash_bwd_mma::dq_tile<D>(q + base, k + base, v + base, dout + base,
                              lse + bh * Tn, dsum + bh * Tn, q0, Tn, Tn, 0,
                              0, n_tiles, scale, causal, acc, smem);
    T* o = dq + base;
    flash_bwd_mma::for_each_pair<D>(
        acc, q0, [&](int row, int col, float a0, float a1) {
          if (row < Tn)
            *reinterpret_cast<__nv_bfloat162*>(o + (size_t)row * D + col) =
                __floats2bfloat162_rn(a0, a1);
        });
  } else {
    constexpr int LD = D + 1;
    constexpr int LDS = BN + 1;
    constexpr int DPT = D / TPR;   // dq columns per thread
    constexpr int NPT = BN / TPR;  // score columns per thread
    float* qs = smem;              // [BM][LD]
    float* dos = qs + BM * LD;     // [BM][LD]
    float* ks = dos + BM * LD;     // [BN][LD]
    float* vs = ks + BN * LD;      // [BN][LD]
    float* dss = vs + BN * LD;     // [BM][LDS]

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
}

template <typename T, int D>
__global__ void __launch_bounds__(Threads<T>::value)
dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dout,
           const float* __restrict__ lse, const float* __restrict__ dsum,
           T* __restrict__ dk, T* __restrict__ dv, int H, int Tn,
           float scale, int causal) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t base = bh * (size_t)Tn * D;
  const int k0 = blockIdx.x * BN;
  const int n_q = (Tn + BM - 1) / BM;
  // the first q tile whose last row reaches this k tile's first row
  const int i0 = causal ? k0 / BM : 0;

  if constexpr (on_tensor_cores<T>()) {
    float acc_k[D / 8][4], acc_v[D / 8][4];
    flash_bwd_mma::dkv_tile<D>(q + base, k + base, v + base, dout + base,
                               lse + bh * Tn, dsum + bh * Tn, k0, Tn, Tn, 0,
                               0, i0, n_q, scale, causal, acc_k, acc_v,
                               smem);
    T* ok = dk + base;
    T* ov = dv + base;
    flash_bwd_mma::for_each_pair<D>(
        acc_k, k0, [&](int row, int col, float a0, float a1) {
          if (row < Tn)
            *reinterpret_cast<__nv_bfloat162*>(ok + (size_t)row * D + col) =
                __floats2bfloat162_rn(a0, a1);
        });
    flash_bwd_mma::for_each_pair<D>(
        acc_v, k0, [&](int row, int col, float a0, float a1) {
          if (row < Tn)
            *reinterpret_cast<__nv_bfloat162*>(ov + (size_t)row * D + col) =
                __floats2bfloat162_rn(a0, a1);
        });
  } else {
    constexpr int LD = D + 1;
    constexpr int LDP = BM + 1;
    constexpr int DPT = D / TPR;   // dk and dv columns per thread
    constexpr int NPT = BM / TPR;  // q rows scored per thread
    float* ks = smem;              // [BN][LD]
    float* vs = ks + BN * LD;      // [BN][LD]
    float* qs = vs + BN * LD;      // [BM][LD]
    float* dos = qs + BM * LD;     // [BM][LD]
    float* ps = dos + BM * LD;     // [BN][LDP], p^T in the input dtype
    float* dss = ps + BN * LDP;    // [BN][LDP], ds^T in the input dtype
    float* lse_s = dss + BN * LDP; // [BM]
    float* dsum_s = lse_s + BM;    // [BM]

    const int tid = threadIdx.x;
    const int r = tid / TPR, sub = tid % TPR;
    const int krow = k0 + r;

    load_tile<T, D>(ks, k + base, k0, Tn, tid);
    load_tile<T, D>(vs, v + base, k0, Tn, tid);

    float acc_k[DPT], acc_v[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc_k[i] = acc_v[i] = 0.f;

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
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, void* dq, int B, int H,
              int Tn, float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = on_tensor_cores<T>()
                              ? flash_bwd_mma::dq_smem_bytes<D>()
                              : dq_smem_bytes<D>();
  static bool configured[64] = {};
  int err = configure(dq_kernel<T, D>, smem, configured);
  if (err != 0) return err;
  dim3 grid((Tn + BM - 1) / BM, H, B);
  dq_kernel<T, D><<<grid, Threads<T>::value, smem, stream>>>(
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
  constexpr size_t smem = on_tensor_cores<T>()
                              ? flash_bwd_mma::dkv_smem_bytes<D>()
                              : dkv_smem_bytes<D>();
  static bool configured[64] = {};
  int err = configure(dkv_kernel<T, D>, smem, configured);
  if (err != 0) return err;
  dim3 grid((Tn + BN - 1) / BN, H, B);
  dkv_kernel<T, D><<<grid, Threads<T>::value, smem, stream>>>(
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
