// Ring-hop flash attention for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the TPU kernels distkeras_tpu/ops/attention.py:_hop_fwd_kernel
// (reached through flash_hop_fwd), _hop_dq_kernel and _hop_dkv_kernel
// (through flash_hop_bwd).  One call is one hop of ring attention: the
// resident q block of this rank against the visiting k/v block of rank
// src.  Same functions, not block-by-block copies:
//   q [B, H, Tq, D], k, v [B, H, Tk, D] in the input dtype (bf16 or f32);
//   the causal mask compares GLOBAL positions, q_off + row >= k_off + col;
//   hop_fwd_kernel: the online-softmax state m, l [B, H, Tq] and
//     acc [B, H, Tq, D] (f32) is read in and written back in place,
//     never finalized; f32 logits; P rounded to the input dtype before
//     P.V while l sums the unrounded P, as the TPU kernel does;
//   hop_dq_kernel, hop_dkv_kernel: this hop's partial dq, dk, dv from the
//     FINAL lse and dsum = rowsum(dO.O) ([B, H, Tq] f32); ds rounded to
//     the input dtype before ds.k and ds^T.q, p before p^T.do; the f32
//     partial is written, or added to the carried f32 sum
//     (accumulate = 1), which the ring carries from hop to hop.
// The mask value is -1e30 and a masked p is exactly 0 in every kernel.
// (The TPU forward does not zero it: a row whose first live tile holds
// no key it may see, while m is still -1e30, would add exp(0) per
// masked column there.  No ring hop makes such a row, since the
// diagonal hop runs first and its first tile holds the row's own block
// start, but the zero keeps the function right for any offsets.)
// k tiles wholly above the diagonal in global positions are skipped, so a
// hop from a later rank (all of it in the future) launches, reads
// nothing and leaves the state as it was.
//
// Bound on the H100: a full (past) hop at the sequence-parallel path's
// [4, 12, 2048, 64] bf16 does 4*B*H*Tq*Tk*D = 51.5 GFLOP forward (52 us
// at 989 TFLOP/s) on 37.7 MB of q, k, v and 51.9 MB of state read and
// written (27 us at 3.35 TB/s): the tensor cores bound it, as they bound
// the backward's products.  A diagonal hop does half the work on the
// same bytes, which then bound it, narrowly.
//
// Bound of the backward: at that shape a past hop's dq kernel does 3
// Tq x Tk x D products (q.k^T, do.v^T, ds.k; 77.3 GFLOP, 78 us) on 101 MB
// of bf16 blocks, f32 rows and the carried f32 dq read and written (30
// us); the dk/dv kernel 4 (103.1 GFLOP, 104 us) on 152 MB (45 us): the
// tensor cores bound both, and a diagonal hop does half the products.
//
// The grids: hop_fwd_kernel and hop_dq_kernel one block per (b, h, q
// tile) with a loop over the k tiles up to the global diagonal (the
// forward loads its state at the start and stores it at the end);
// hop_dkv_kernel one block per (b, h, k tile), k and v resident, a loop
// over the q tiles from the first one that reaches the tile.
// bf16 (the path's dtype) runs on the tensor cores: the forward through
// the mma.sync tile body of flash_fwd_mma.cuh (shared with the
// device-local forward; its f32 state is read from global memory straight
// into the C fragments and written back from them, two columns a lane),
// the backward through those of flash_bwd_mma.cuh (shared with the
// device-local backward).  128 threads, 4 warps of 16 resident rows, bf16
// operands in padded shared memory by 16-byte cp.async, streamed tiles
// double buffered, p and ds repacked from accumulators to A operands in
// registers; the masking inputs (Tq, Tk, q_off, k_off, causal) pass as
// they are.  The backward's f32 partials are written, or added to the
// carried sums with one __fadd_rn each.
// f32 runs the tiling of flash_attention_fwd.cu's and
// flash_attention_bwd.cu's f32 kernels with the offsets added: 256
// threads per block, 64-row tiles staged in shared memory as f32 with rows
// padded by one word; four threads own one row of the resident tile and
// each scores 16 of the other operand's 64 columns; the row's four threads
// share a warp, so a __syncwarp orders the P or ds tile they exchange
// through shared memory.  The products run as FMAs on the CUDA cores,
// bound by shared-memory reads.
// No atomics: every output element has one owner, so runs are bit-equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "flash_bwd_mma.cuh"
#include "flash_fwd_mma.cuh"

namespace flash_hop {

using flash_bwd_mma::configure;
using flash_bwd_mma::on_tensor_cores;

constexpr int BM = 64;         // q rows per tile
constexpr int BN = 64;         // k rows per tile
constexpr int TPR = 4;         // threads per resident row
constexpr int NTHREADS = 64 * TPR;
constexpr float NEG = -1e30f;  // the TPU kernel's mask value

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

// rows [r0, r0 + 64) of a [Tn, D] slab into a padded f32 tile, zero past Tn
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int Tn, int tid) {
  constexpr int LD = D + 1;
  for (int i = tid; i < 64 * D; i += NTHREADS) {
    const int rr = i / D, dd = i % D, g = r0 + rr;
    dst[rr * LD + dd] = g < Tn ? to_f(src[(size_t)g * D + dd]) : 0.f;
  }
}

// k tiles a q tile [q0, q0 + 64) of Tq rows may see: all of them, or, when
// causal, those up to its last row's global position (0 for a dead tile)
__device__ __forceinline__ int live_k_tiles(int q0, int Tq, int Tk,
                                            int q_off, int k_off,
                                            int causal) {
  const int n = (Tk + BN - 1) / BN;
  if (!causal) return n;
  const int last = q_off + min(q0 + BM, Tq) - 1 - k_off;
  return last < 0 ? 0 : min(n, last / BN + 1);
}

// one pair of f32 outputs: written, or added to the carried sum with one
// round-to-nearest add each
__device__ __forceinline__ void put(float* x, float a0, float a1,
                                    int accumulate) {
  x[0] = accumulate ? __fadd_rn(x[0], a0) : a0;
  x[1] = accumulate ? __fadd_rn(x[1], a1) : a1;
}

template <typename T, int D>
constexpr size_t fwd_smem_bytes() {
  return on_tensor_cores<T>()
             ? flash_fwd_mma::smem_bytes<D>()
             : sizeof(float) * (3 * 64 * (D + 1) + BM * (BN + 1));
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
hop_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, float* __restrict__ m,
               float* __restrict__ l, float* __restrict__ acc, int H,
               int Tq, int Tk, int q_off, int k_off, float scale,
               int causal) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t qbase = bh * (size_t)Tq * D;
  const size_t kbase = bh * (size_t)Tk * D;
  const int q0 = blockIdx.x * BM;
  const int n_tiles = live_k_tiles(q0, Tq, Tk, q_off, k_off, causal);
  if (n_tiles == 0) return;  // a dead tile: the state stays as it was

  if constexpr (on_tensor_cores<T>()) {
    // this lane's rows q0 + 16 * warp + g and + 8: the state straight
    // into registers and the C fragments, and back
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int t = lane & 3;
    int rows[2];
    float mi[2], li[2], a[D / 8][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      rows[hh] = q0 + 16 * warp + (lane >> 2) + 8 * hh;
      const bool live = rows[hh] < Tq;
      mi[hh] = live ? m[bh * Tq + rows[hh]] : NEG;
      li[hh] = live ? l[bh * Tq + rows[hh]] : 0.f;
      const float* arow = acc + qbase + (size_t)rows[hh] * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 x = live ? *reinterpret_cast<const float2*>(arow + 8 * j)
                              : make_float2(0.f, 0.f);
        a[j][2 * hh] = x.x;
        a[j][2 * hh + 1] = x.y;
      }
    }
    flash_fwd_mma::fwd_tile<D>(q + qbase, k + kbase, v + kbase, q0, Tq, Tk,
                               q_off, k_off, n_tiles, scale, causal, mi, li,
                               a, smem);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      if (rows[hh] >= Tq) continue;
      if (t == 0) {
        m[bh * Tq + rows[hh]] = mi[hh];
        l[bh * Tq + rows[hh]] = li[hh];
      }
      float* arow = acc + qbase + (size_t)rows[hh] * D + 2 * t;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(arow + 8 * j) =
            make_float2(a[j][2 * hh], a[j][2 * hh + 1]);
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
    const bool live_row = row < Tq;

    load_tile<T, D>(qs, q + qbase, q0, Tq, tid);
    float mi = live_row ? m[bh * Tq + row] : NEG;
    float li = live_row ? l[bh * Tq + row] : 0.f;
    float a[DPT];
    float* arow = acc + qbase + (size_t)row * D + sub;
#pragma unroll
    for (int i = 0; i < DPT; ++i) a[i] = live_row ? arow[TPR * i] : 0.f;

    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * BN;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(ks, k + kbase, k0, Tk, tid);
      load_tile<T, D>(vs, v + kbase, k0, Tk, tid);
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

      bool masked[NPT];
      float mt = NEG;
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        const int col = k0 + sub + TPR * c;
        masked[c] = col >= Tk || (causal && k_off + col > q_off + row);
        s[c] = masked[c] ? NEG : s[c] * scale;
        mt = fmaxf(mt, s[c]);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(mi, mt);
      const float corr = expf(mi - m_new);
      float ls = 0.f;
#pragma unroll
      for (int c = 0; c < NPT; ++c) {
        const float p = masked[c] ? 0.f : expf(s[c] - m_new);
        ls += p;
        ps[r * LDP + sub + TPR * c] = round_to<T>(p);
      }
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      li = li * corr + ls;
      mi = m_new;
      __syncwarp();

#pragma unroll
      for (int i = 0; i < DPT; ++i) a[i] *= corr;
#pragma unroll 4
      for (int c = 0; c < BN; ++c) {
        const float p = ps[r * LDP + c];
        const float* vr = vs + c * LD + sub;
#pragma unroll
        for (int i = 0; i < DPT; ++i) a[i] = fmaf(p, vr[TPR * i], a[i]);
      }
    }

    if (live_row) {
      if (sub == 0) {
        m[bh * Tq + row] = mi;
        l[bh * Tq + row] = li;
      }
#pragma unroll
      for (int i = 0; i < DPT; ++i) arow[TPR * i] = a[i];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Threads<T>::value)
hop_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ dsum,
              float* __restrict__ dq, int H, int Tq, int Tk, int q_off,
              int k_off, float scale, int causal, int accumulate) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t qbase = bh * (size_t)Tq * D;
  const size_t kbase = bh * (size_t)Tk * D;
  const int q0 = blockIdx.x * BM;
  const int n_tiles = live_k_tiles(q0, Tq, Tk, q_off, k_off, causal);
  if (n_tiles == 0 && accumulate) return;  // adds nothing

  if constexpr (on_tensor_cores<T>()) {
    float acc[D / 8][4];
    flash_bwd_mma::dq_tile<D>(q + qbase, k + kbase, v + kbase, dout + qbase,
                              lse + bh * Tq, dsum + bh * Tq, q0, Tq, Tk,
                              q_off, k_off, n_tiles, scale, causal, acc,
                              smem);
    float* o = dq + qbase;
    flash_bwd_mma::for_each_pair<D>(
        acc, q0, [&](int row, int col, float a0, float a1) {
          if (row < Tq) put(o + (size_t)row * D + col, a0, a1, accumulate);
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

    float a[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) a[i] = 0.f;

    if (n_tiles > 0) {
      load_tile<T, D>(qs, q + qbase, q0, Tq, tid);
      load_tile<T, D>(dos, dout + qbase, q0, Tq, tid);
    }
    const float lse_r = row < Tq ? lse[bh * Tq + row] : 0.f;
    const float dsum_r = row < Tq ? dsum[bh * Tq + row] : 0.f;

    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * BN;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(ks, k + kbase, k0, Tk, tid);
      load_tile<T, D>(vs, v + kbase, k0, Tk, tid);
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
        const bool masked = col >= Tk || row >= Tq ||
                            (causal && k_off + col > q_off + row);
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
        for (int i = 0; i < DPT; ++i) a[i] = fmaf(d, kr[TPR * i], a[i]);
      }
    }

    if (row < Tq) {
      float* o = dq + qbase + (size_t)row * D + sub;
#pragma unroll
      for (int i = 0; i < DPT; ++i)
        o[TPR * i] = accumulate ? o[TPR * i] + a[i] : a[i];
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(Threads<T>::value)
hop_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ dout,
               const float* __restrict__ lse,
               const float* __restrict__ dsum, float* __restrict__ dk,
               float* __restrict__ dv, int H, int Tq, int Tk, int q_off,
               int k_off, float scale, int causal, int accumulate) {
  extern __shared__ float smem[];
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t qbase = bh * (size_t)Tq * D;
  const size_t kbase = bh * (size_t)Tk * D;
  const int k0 = blockIdx.x * BN;
  const int n_q = (Tq + BM - 1) / BM;
  // the first q tile whose last row reaches this k tile's first row
  int i0 = 0;
  if (causal) {
    const int x = k_off + k0 - q_off;
    i0 = x > 0 ? min(n_q, x / BM) : 0;
  }
  if (i0 == n_q && accumulate) return;  // adds nothing

  if constexpr (on_tensor_cores<T>()) {
    float acc_k[D / 8][4], acc_v[D / 8][4];
    flash_bwd_mma::dkv_tile<D>(q + qbase, k + kbase, v + kbase,
                               dout + qbase, lse + bh * Tq, dsum + bh * Tq,
                               k0, Tq, Tk, q_off, k_off, i0, n_q, scale,
                               causal, acc_k, acc_v, smem);
    float* ok = dk + kbase;
    float* ov = dv + kbase;
    flash_bwd_mma::for_each_pair<D>(
        acc_k, k0, [&](int row, int col, float a0, float a1) {
          if (row < Tk) put(ok + (size_t)row * D + col, a0, a1, accumulate);
        });
    flash_bwd_mma::for_each_pair<D>(
        acc_v, k0, [&](int row, int col, float a0, float a1) {
          if (row < Tk) put(ov + (size_t)row * D + col, a0, a1, accumulate);
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

    if (i0 < n_q) {
      load_tile<T, D>(ks, k + kbase, k0, Tk, tid);
      load_tile<T, D>(vs, v + kbase, k0, Tk, tid);
    }

    float acc_k[DPT], acc_v[DPT];
#pragma unroll
    for (int i = 0; i < DPT; ++i) acc_k[i] = acc_v[i] = 0.f;

    for (int it = i0; it < n_q; ++it) {
      const int q0 = it * BM;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(qs, q + qbase, q0, Tq, tid);
      load_tile<T, D>(dos, dout + qbase, q0, Tq, tid);
      if (tid < BM) {
        const int g = q0 + tid;
        lse_s[tid] = g < Tq ? lse[bh * Tq + g] : 0.f;
        dsum_s[tid] = g < Tq ? dsum[bh * Tq + g] : 0.f;
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
        const bool masked = qrow >= Tq || krow >= Tk ||
                            (causal && k_off + krow > q_off + qrow);
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

    if (krow < Tk) {
      const size_t off = kbase + (size_t)krow * D + sub;
#pragma unroll
      for (int i = 0; i < DPT; ++i) {
        const size_t o = off + TPR * i;
        dk[o] = accumulate ? dk[o] + acc_k[i] : acc_k[i];
        dv[o] = accumulate ? dv[o] + acc_v[i] : acc_v[i];
      }
    }
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, float* m,
               float* l, float* acc, int B, int H, int Tq, int Tk,
               int q_off, int k_off, float scale, int causal,
               cudaStream_t stream) {
  constexpr size_t smem = fwd_smem_bytes<T, D>();
  static bool configured[64] = {};
  int err = configure(hop_fwd_kernel<T, D>, smem, configured);
  if (err != 0) return err;
  dim3 grid((Tq + BM - 1) / BM, H, B);
  hop_fwd_kernel<T, D><<<grid, Threads<T>::value, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), m, l, acc, H, Tq, Tk, q_off, k_off, scale,
      causal);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* dsum, float* dq, int B, int H,
              int Tq, int Tk, int q_off, int k_off, float scale, int causal,
              int accumulate, cudaStream_t stream) {
  constexpr size_t smem = on_tensor_cores<T>()
                              ? flash_bwd_mma::dq_smem_bytes<D>()
                              : dq_smem_bytes<D>();
  static bool configured[64] = {};
  int err = configure(hop_dq_kernel<T, D>, smem, configured);
  if (err != 0) return err;
  dim3 grid((Tq + BM - 1) / BM, H, B);
  hop_dq_kernel<T, D><<<grid, Threads<T>::value, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum, dq,
      H, Tq, Tk, q_off, k_off, scale, causal, accumulate);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* dsum,
               float* dk, float* dv, int B, int H, int Tq, int Tk,
               int q_off, int k_off, float scale, int causal,
               int accumulate, cudaStream_t stream) {
  constexpr size_t smem = on_tensor_cores<T>()
                              ? flash_bwd_mma::dkv_smem_bytes<D>()
                              : dkv_smem_bytes<D>();
  static bool configured[64] = {};
  int err = configure(hop_dkv_kernel<T, D>, smem, configured);
  if (err != 0) return err;
  dim3 grid((Tk + BN - 1) / BN, H, B);
  hop_dkv_kernel<T, D><<<grid, Threads<T>::value, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, dsum, dk,
      dv, H, Tq, Tk, q_off, k_off, scale, causal, accumulate);
  return (int)cudaGetLastError();
}

}  // namespace flash_hop

using flash_hop::launch_dkv;
using flash_hop::launch_dq;
using flash_hop::launch_fwd;

// dtype: 0 = float32, 1 = bfloat16.  Each returns cudaGetLastError()
// after its launch (0 on success); -1 for a head size or dtype not
// built, or a device index past 63.
extern "C" int flash_hop_fwd(const void* q, const void* k, const void* v,
                             float* m, float* l, float* acc, int B, int H,
                             int Tq, int Tk, int D, int q_off, int k_off,
                             float scale, int causal, int dtype,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_fwd<float, 64>(q, k, v, m, l, acc, B, H, Tq, Tk, q_off,
                                 k_off, scale, causal, s);
  if (dtype == 0 && D == 128)
    return launch_fwd<float, 128>(q, k, v, m, l, acc, B, H, Tq, Tk, q_off,
                                  k_off, scale, causal, s);
  if (dtype == 1 && D == 64)
    return launch_fwd<__nv_bfloat16, 64>(q, k, v, m, l, acc, B, H, Tq, Tk,
                                         q_off, k_off, scale, causal, s);
  if (dtype == 1 && D == 128)
    return launch_fwd<__nv_bfloat16, 128>(q, k, v, m, l, acc, B, H, Tq, Tk,
                                          q_off, k_off, scale, causal, s);
  return -1;
}

extern "C" int flash_hop_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* dsum, float* dq, int B, int H,
                                int Tq, int Tk, int D, int q_off, int k_off,
                                float scale, int causal, int accumulate,
                                int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dq<float, 64>(q, k, v, dout, lse, dsum, dq, B, H, Tq, Tk,
                                q_off, k_off, scale, causal, accumulate, s);
  if (dtype == 0 && D == 128)
    return launch_dq<float, 128>(q, k, v, dout, lse, dsum, dq, B, H, Tq, Tk,
                                 q_off, k_off, scale, causal, accumulate, s);
  if (dtype == 1 && D == 64)
    return launch_dq<__nv_bfloat16, 64>(q, k, v, dout, lse, dsum, dq, B, H,
                                        Tq, Tk, q_off, k_off, scale, causal,
                                        accumulate, s);
  if (dtype == 1 && D == 128)
    return launch_dq<__nv_bfloat16, 128>(q, k, v, dout, lse, dsum, dq, B, H,
                                         Tq, Tk, q_off, k_off, scale, causal,
                                         accumulate, s);
  return -1;
}

extern "C" int flash_hop_bwd_dkv(const void* q, const void* k,
                                 const void* v, const void* dout,
                                 const float* lse, const float* dsum,
                                 float* dk, float* dv, int B, int H, int Tq,
                                 int Tk, int D, int q_off, int k_off,
                                 float scale, int causal, int accumulate,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return launch_dkv<float, 64>(q, k, v, dout, lse, dsum, dk, dv, B, H, Tq,
                                 Tk, q_off, k_off, scale, causal, accumulate,
                                 s);
  if (dtype == 0 && D == 128)
    return launch_dkv<float, 128>(q, k, v, dout, lse, dsum, dk, dv, B, H, Tq,
                                  Tk, q_off, k_off, scale, causal,
                                  accumulate, s);
  if (dtype == 1 && D == 64)
    return launch_dkv<__nv_bfloat16, 64>(q, k, v, dout, lse, dsum, dk, dv, B,
                                         H, Tq, Tk, q_off, k_off, scale,
                                         causal, accumulate, s);
  if (dtype == 1 && D == 128)
    return launch_dkv<__nv_bfloat16, 128>(q, k, v, dout, lse, dsum, dk, dv,
                                          B, H, Tq, Tk, q_off, k_off, scale,
                                          causal, accumulate, s);
  return -1;
}
