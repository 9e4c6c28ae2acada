// Flash-attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernel distkeras_tpu/ops/attention.py:_fwd_kernel
// (reached through _fwd_call and flash_attention).  Same function, not
// a block-by-block copy:
//   q, k, v, out [B, H, T, D] in the input dtype (bf16 or f32),
//   lse [B, H, T] f32;
//   logits, running max, denominator and output accumulator in f32;
//   P rounded to the input dtype before P.V, as the TPU kernel and the
//   dense path do; -1e30 as the mask value; k tiles wholly above the
//   causal diagonal are skipped;
//   out = acc / max(l, 1e-30) in the input dtype, lse = m + log(max(l,
//   1e-30)) in f32.
//
// Bound on the H100: causal attention does 4*B*H*T*T*D/2 operations on
// 4*B*H*T*D*2 bytes (bf16), i.e. T/2 operations per byte.  Past
// T ~ 600 that is above the card's ~295 operations per byte, so at the
// serving path's long prefills the tensor cores bound it (B=1, H=12,
// T=2048, D=64: 6.4 GFLOP -> 6.5 us at 989 TFLOP/s) and at short ones
// memory does (T=512: 3.1 MB -> 0.94 us at 3.35 TB/s); the training
// path's [8, 12, 1024, 64] does 12.9 GFLOP (13 us) on 50.7 MB (15 us),
// so memory bounds it too, narrowly.
//
// One block per (b, h, 64-row q tile); a loop inside the block walks the
// 64-row k/v tiles up to the causal diagonal, which takes the place of
// the TPU's sequential grid axis.
//
// bf16 (the paths' dtype): the tensor-core tile body of flash_fwd_mma.cuh,
// shared with the ring-hop forward.  128 threads, 4 warps of 16 q rows;
// q held as A fragments in registers, k and v streamed through padded
// bf16 shared memory by 16-byte cp.async, double buffered; s = q.k^T and
// round(p).v on mma.sync m16n8k16 with f32 accumulators; the online
// softmax state of each row in registers, reduced over the lane quad by
// shuffles; p passes from the s accumulators to the A operand of p.v in
// registers.  The state starts at (-1e30, 0, 0); the epilogue divides,
// rounds and writes out two columns a lane, and lse from the quad lane
// that holds columns 0 and 1.  Shared memory: 45 KB (D 64) and 85 KB
// (D 128) a block; above 48 KB the first launch on a device raises the
// kernel's dynamic limit.
//
// f32: FMA tiles on the CUDA cores (TF32 would miss the f32 limit of
// 2e-5).  256 threads; the tiles staged in shared memory as
// f32 (rows padded by one word so neighbouring rows sit in different
// banks); four threads own one q row: each scores 16 of the tile's 64
// columns, the row max and sum are exchanged with two warp shuffles, P
// goes through shared memory (the row's four threads share a warp, so a
// __syncwarp orders it) and each thread accumulates D/4 output columns.
// The products run as FMAs on the CUDA cores, bound by shared-memory
// reads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_fwd_mma.cuh"

namespace {

using flash_bwd_mma::configure;
using flash_bwd_mma::on_tensor_cores;

constexpr int BM = 64;         // q rows per block
constexpr int BN = 64;         // k rows per tile
constexpr int TPR = 4;         // threads per q row (FMA tiles)
constexpr int NTHREADS = BM * TPR;
constexpr float NEG = -1e30f;  // the TPU kernel's mask value

// threads per block: the mma tile's 4 warps, or the FMA tiles' 256
template <typename T>
struct Threads {
  static constexpr int value =
      on_tensor_cores<T>() ? flash_fwd_mma::NTHREADS : NTHREADS;
};

template <typename T, int D>
constexpr size_t smem_bytes() {
  return on_tensor_cores<T>()
             ? flash_fwd_mma::smem_bytes<D>()
             : sizeof(float) * (3 * BM * (D + 1) + BM * (BN + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(Threads<T>::value)
fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, T* __restrict__ out,
           float* __restrict__ lse, int H, int Tn, float scale,
           int causal) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t base = bh * (size_t)Tn * D;
  const int q0 = blockIdx.x * BM;
  int n_tiles = (Tn + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (q0 + BM - 1) / BN + 1);

  if constexpr (on_tensor_cores<T>()) {
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
    float acc[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    flash_fwd_mma::fwd_tile<D>(q + base, k + base, v + base, q0, Tn, Tn, 0,
                               0, n_tiles, scale, causal, m, l, acc, smem);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int t = lane & 3;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + 16 * warp + (lane >> 2) + 8 * hh;
      if (row >= Tn) continue;
      const float lc = fmaxf(l[hh], 1e-30f);
      T* o = out + base + (size_t)row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o + 8 * j) = __floats2bfloat162_rn(
            acc[j][2 * hh] / lc, acc[j][2 * hh + 1] / lc);
      if (t == 0) lse[bh * Tn + row] = m[hh] + logf(lc);
    }
  } else {
    constexpr int LD = D + 1;
    constexpr int LDP = BN + 1;
    constexpr int DPT = D / TPR;   // output columns per thread
    constexpr int NPT = BN / TPR;  // score columns per thread
    float* qs = smem;              // [BM][LD]
    float* ks = qs + BM * LD;      // [BN][LD]
    float* vs = ks + BN * LD;      // [BN][LD]
    float* ps = vs + BN * LD;      // [BM][LDP]

    const int tid = threadIdx.x;
    const int r = tid / TPR, sub = tid % TPR;
    const int row = q0 + r;

    for (int i = tid; i < BM * D; i += NTHREADS) {
      const int rr = i / D, dd = i % D, g = q0 + rr;
      qs[rr * LD + dd] = g < Tn ? q[base + (size_t)g * D + dd] : 0.f;
    }

    float m = NEG, l = 0.f;
    float acc[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc[i] = 0.f;

    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * BN;
      __syncthreads();  // the previous tile's readers are done
      for (int i = tid; i < BN * D; i += NTHREADS) {
        const int rr = i / D, dd = i % D, g = k0 + rr;
        const bool ok = g < Tn;
        const size_t off = base + (size_t)g * D + dd;
        ks[rr * LD + dd] = ok ? k[off] : 0.f;
        vs[rr * LD + dd] = ok ? v[off] : 0.f;
      }
      __syncthreads();

      float s[NPT];
#pragma unroll
      for (int c = 0; c < NPT; ++c) s[c] = 0.f;
#pragma unroll 2
      for (int d0 = 0; d0 < D; d0 += 8) {
        float qr[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) qr[e] = qs[r * LD + d0 + e];
#pragma unroll
        for (int c = 0; c < NPT; ++c) {
          const float* kr = ks + (sub + TPR * c) * LD + d0;
#pragma unroll
          for (int e = 0; e < 8; ++e) s[c] = fmaf(qr[e], kr[e], s[c]);
        }
      }

      float mt = NEG;
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        const int col = k0 + sub + TPR * c;
        float x = s[c] * scale;
        if (col >= Tn || (causal && col > row)) x = NEG;
        s[c] = x;
        mt = fmaxf(mt, x);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m, mt);
      const float corr = expf(m - m_new);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        const float p = expf(s[c] - m_new);
        ls += p;
        ps[r * LDP + sub + TPR * c] = p;
      }
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      l = l * corr + ls;
      m = m_new;
      __syncwarp();

#pragma unroll
      for (int i = 0; i < DPT; ++i) acc[i] *= corr;
#pragma unroll 4
      for (int c = 0; c < BN; ++c) {
        const float p = ps[r * LDP + c];
        const float* vr = vs + c * LD + sub;
#pragma unroll
        for (int i = 0; i < DPT; ++i) acc[i] = fmaf(p, vr[TPR * i], acc[i]);
      }
    }

    if (row < Tn) {
      const float lc = fmaxf(l, 1e-30f);
      T* o = out + base + (size_t)row * D + sub;
#pragma unroll
      for (int i = 0; i < DPT; ++i) o[TPR * i] = acc[i] / lc;
      if (sub == 0) lse[bh * Tn + row] = m + logf(lc);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out,
           float* lse, int B, int H, int Tn, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  static bool configured[64] = {};
  int err = configure(fwd_kernel<T, D>, smem, configured);
  if (err != 0) return err;
  dim3 grid((Tn + BM - 1) / BM, H, B);
  fwd_kernel<T, D><<<grid, Threads<T>::value, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, Tn, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after
// the launch (0 on success); -1 for a head size or dtype not built, or
// a device index past 63.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int B, int H, int Tn, int D,
                                   float scale, int causal, int dtype,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch<float, 64>(q, k, v, out, lse, B, H, Tn, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch<float, 128>(q, k, v, out, lse, B, H, Tn, scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, out, lse, B, H, Tn, scale,
                                     causal, s);
  if (dtype == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, out, lse, B, H, Tn, scale,
                                      causal, s);
  return -1;
}
