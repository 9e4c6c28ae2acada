// Tensor-core tile bodies of the bf16 flash-attention backward, shared by
// flash_attention_bwd.cu (dq_kernel, dkv_kernel) and flash_hop.cu
// (hop_dq_kernel, hop_dkv_kernel), and the helpers that flash_fwd_mma.cuh
// builds the forward's body from.  No kernels: each .cu keeps its own
// __global__ functions and its own epilogue (bf16 outputs written once,
// or f32 partials written or added to a carried sum); the one host
// helper raises a kernel's shared-memory limit.
//
// The function, for one (batch, head) slab of q, do [Tq, D] and k, v
// [Tk, D] in bf16, the final lse and dsum = rowsum(do * out) [Tq] in f32:
//   s = q.k^T in f32; p = exp(s * scale - lse), exactly 0 where masked;
//   dp = do.v^T in f32; ds = p * (dp - dsum) * scale;
//   dq = round_bf16(ds).k;  dk = round_bf16(ds)^T.q;  dv = round_bf16(p)^T.do
// with f32 sums.  The causal mask compares GLOBAL positions,
// q_off + row >= k_off + col; the device-local backward is q_off = k_off
// = 0, Tq = Tk.  Masked, and past the ragged edge, p is 0, as in the TPU
// kernels (distkeras_tpu/ops/attention.py _dq_kernel, _dkv_kernel,
// _hop_dq_kernel, _hop_dkv_kernel).
//
// Layout: 128 threads, 4 warps; the block's resident 64-row tile (q and
// do for dq; k and v for dk/dv) gives each warp 16 rows.  Every product
// is mma.sync.m16n8k16 bf16 x bf16 -> f32.  Operands stay bf16 in shared
// memory, rows padded by 8 elements (16 bytes) so the 8 row addresses of
// an ldmatrix fall in 8 different bank groups, and are copied in with
// 16-byte cp.async, zero-filled past the ragged edge.  The streamed tiles
// (k, v for dq; q, do with their lse and dsum rows for dk/dv) are double
// buffered: the next tile's copy is in flight while this tile's products
// run.  p and ds leave the f32 accumulators of one product as the bf16 A
// operand of the next without touching shared memory (the m16n8 C
// fragment of two neighbouring n tiles is the m16k16 A fragment).
// Fragments of the resident tile are reloaded from shared memory for each
// streamed tile rather than held, which keeps the dk/dv body (two D-wide
// f32 accumulators, 128 registers a thread at D 128) clear of spills; at
// D 128 it also scores the 64 streamed rows in two chunks of 32.
// No atomics: each output element has one owner, so reruns are bit-equal.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash_bwd_mma {

using bf16 = __nv_bfloat16;

// the including kernels run bf16 on these tile bodies, f32 on FMA tiles
template <typename T>
__host__ __device__ constexpr bool on_tensor_cores() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// Host side: raise the kernel's dynamic shared-memory limit once per
// device (and so outside any later CUDA-graph capture), where it needs
// more than the 48 KB default; setting the same value twice from racing
// threads is benign.
template <typename K>
int configure(K kernel, size_t smem, bool* configured) {
  if (smem <= 48 * 1024) return 0;
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

constexpr int BM = 64;            // q rows per tile
constexpr int BN = 64;            // k rows per tile
constexpr int NTHREADS = 128;     // 4 warps of 16 resident rows
constexpr int PAD = 8;            // bf16 elements of row padding

template <int D>
__host__ __device__ constexpr int ld() { return D + PAD; }

// one 64-row bf16 tile, padded
template <int D>
__host__ __device__ constexpr int tile_elems() { return 64 * ld<D>(); }

// q, do resident; k, v double buffered
template <int D>
constexpr size_t dq_smem_bytes() {
  return sizeof(bf16) * 6 * tile_elems<D>();
}

// k, v resident; q, do double buffered; lse, dsum double buffered
template <int D>
constexpr size_t dkv_smem_bytes() {
  return sizeof(bf16) * 6 * tile_elems<D>() + sizeof(float) * 4 * BM;
}

// ---------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give matrix i's row addresses
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// the same, each matrix transposed on the way into registers
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b on one m16n8k16 tile, f32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared; zeros when !valid (nothing is read then)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero when !valid
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// two f32 -> one register of two bf16 (round to nearest even), lo first
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The C fragments of n tiles 2j and 2j+1 (16 rows x 16 columns, f32)
// rounded to bf16 as the A fragment of a k16 step: the repack that lets
// p and ds feed the next product from registers.
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);  // row g,     k 2t, 2t+1
  a[1] = pack_bf16(c0[2], c0[3]);  // row g + 8, k 2t, 2t+1
  a[2] = pack_bf16(c1[0], c1[1]);  // row g,     k 2t + 8, 2t + 9
  a[3] = pack_bf16(c1[2], c1[3]);  // row g + 8, k 2t + 8, 2t + 9
}

// ---------------------------------------------------------------------
// fragment addresses in a padded [64][D + 8] bf16 tile
// ---------------------------------------------------------------------

// A fragment (16 x 16) of a row-major [row][k] tile at (r0, k0)
template <int D>
__device__ __forceinline__ const bf16* a_addr(const bf16* t, int r0, int k0,
                                              int lane) {
  return t + (r0 + (lane & 15)) * ld<D>() + k0 + ((lane >> 4) << 3);
}

// B fragments of n tiles n0 and n0 + 8 (k16 deep) from an [n][k] tile:
// r[0], r[1] for n0, r[2], r[3] for n0 + 8 (ldmatrix, no transpose)
template <int D>
__device__ __forceinline__ const bf16* bnk_addr(const bf16* t, int n0, int k0,
                                                int lane) {
  return t + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld<D>() + k0 +
         (((lane >> 3) & 1) << 3);
}

// the same from a [k][n] tile (ldmatrix .trans)
template <int D>
__device__ __forceinline__ const bf16* bkn_addr(const bf16* t, int k0, int n0,
                                                int lane) {
  return t + (k0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * ld<D>() + n0 +
         ((lane >> 4) << 3);
}

// rows [r0, r0 + 64) of a [Tn, D] bf16 slab into a padded tile, 16 bytes
// a copy, zeros past Tn
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int Tn, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int it = 0; it < 64 * CPR / NTHREADS; ++it) {
    const int i = tid + it * NTHREADS;
    const int rr = i / CPR, cc = (i % CPR) * 8, g = r0 + rr;
    const bool ok = g < Tn;
    cp_async16(dst + rr * ld<D>() + cc, src + (size_t)(ok ? g : 0) * D + cc,
               ok);
  }
}

// rows [r0, r0 + 64) of an f32 row vector [Tn], zeros past Tn
__device__ __forceinline__ void load_row(float* dst, const float* src, int r0,
                                         int Tn, int i) {
  const int g = r0 + i;
  cp_async4(dst + i, src + (g < Tn ? g : 0), g < Tn);
}

// ---------------------------------------------------------------------
// dq tile body
// ---------------------------------------------------------------------

// dq of q rows [q0, q0 + 64) over the k tiles [0, n_tiles): this warp's
// 16 rows land in acc (C fragments, n tile j = columns 8j..8j+7: row
// q0 + 16 * warp + g in acc[j][0..1], row + 8 in acc[j][2..3], columns
// 8j + 2t, 8j + 2t + 1).  Pointers are the (batch, head) slabs.  Every
// thread of the block must call it (it synchronizes); with n_tiles 0 it
// reads nothing and leaves acc 0.
template <int D>
__device__ __forceinline__ void dq_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum, int q0,
    int Tq, int Tk, int q_off, int k_off, int n_tiles, float scale,
    int causal, float (&acc)[D / 8][4], void* smem) {
  constexpr int TILE = tile_elems<D>();
  bf16* qs = static_cast<bf16*>(smem);  // [64][D + 8]
  bf16* dos = qs + TILE;                // [64][D + 8]
  bf16* ks = dos + TILE;                // [2][64][D + 8]
  bf16* vs = ks + 2 * TILE;             // [2][64][D + 8]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * warp;

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  if (n_tiles <= 0) return;

  load_tile<D>(qs, q, q0, Tq, tid);
  load_tile<D>(dos, dout, q0, Tq, tid);
  load_tile<D>(ks, k, 0, Tk, tid);
  load_tile<D>(vs, v, 0, Tk, tid);
  cp_async_commit();

  int rows[2];
  float lse_r[2], dsum_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rows[h] = q0 + rw + g + 8 * h;
    lse_r[h] = rows[h] < Tq ? lse[rows[h]] : 0.f;
    dsum_r[h] = rows[h] < Tq ? dsum[rows[h]] : 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int buf = j & 1;
    const int k0 = j * BN;
    if (j + 1 < n_tiles) {
      // the other buffer's readers finished at the end of tile j - 1
      load_tile<D>(ks + (buf ^ 1) * TILE, k, k0 + BN, Tk, tid);
      load_tile<D>(vs + (buf ^ 1) * TILE, v, k0 + BN, Tk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + buf * TILE;
    const bf16* vt = vs + buf * TILE;

    // s = q.k^T and dp = do.v^T: 16 rows x 64 keys, 8 n tiles
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, a_addr<D>(qs, rw, 16 * kk, lane));
      ldmatrix_x4(da, a_addr<D>(dos, rw, 16 * kk, lane));
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, bnk_addr<D>(kt, 16 * np, 16 * kk, lane));
        mma(s[2 * np], qa, b[0], b[1]);
        mma(s[2 * np + 1], qa, b[2], b[3]);
        ldmatrix_x4(b, bnk_addr<D>(vt, 16 * np, 16 * kk, lane));
        mma(dp[2 * np], da, b[0], b[1]);
        mma(dp[2 * np + 1], da, b[2], b[3]);
      }
    }

    // ds = p * (dp - dsum) * scale, in place of s
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        const bool masked = col >= Tk || rows[h] >= Tq ||
                            (causal && k_off + col > q_off + rows[h]);
        const float p = masked ? 0.f : expf(s[n][e] * scale - lse_r[h]);
        s[n][e] = p * (dp[n][e] - dsum_r[h]) * scale;
      }

    // dq += round(ds) . k: k is the [key][d] tile read as [k][n]
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bkn_addr<D>(kt, 16 * kk, 16 * np, lane));
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer's readers are done
  }
}

// ---------------------------------------------------------------------
// dk/dv tile body
// ---------------------------------------------------------------------

// dk and dv of k rows [k0, k0 + 64) over the q tiles [i0, n_q): this
// warp's 16 rows land in acc_k, acc_v (C fragments, as dq_tile's).
// Every thread of the block must call it; with i0 >= n_q it reads nothing
// and leaves both 0.
template <int D>
__device__ __forceinline__ void dkv_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dsum, int k0,
    int Tq, int Tk, int q_off, int k_off, int i0, int n_q, float scale,
    int causal, float (&acc_k)[D / 8][4], float (&acc_v)[D / 8][4],
    void* smem) {
  constexpr int TILE = tile_elems<D>();
  // q columns scored at once: all 64 at D 64; 32 at D 128, which keeps
  // s^T, dp^T and both D-wide accumulators in registers
  constexpr int NC = D <= 64 ? 64 : 32;
  bf16* ks = static_cast<bf16*>(smem);  // [64][D + 8]
  bf16* vs = ks + TILE;                 // [64][D + 8]
  bf16* qs = vs + TILE;                 // [2][64][D + 8]
  bf16* dos = qs + 2 * TILE;            // [2][64][D + 8]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE);  // [2][64]
  float* dsum_s = lse_s + 2 * BM;                            // [2][64]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * warp;

#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  if (i0 >= n_q) return;

  // one q tile's operands and rows into buffer b
  auto load_q = [&](int it, int b) {
    const int q0 = it * BM;
    load_tile<D>(qs + b * TILE, q, q0, Tq, tid);
    load_tile<D>(dos + b * TILE, dout, q0, Tq, tid);
    if (tid < BM)
      load_row(lse_s + b * BM, lse, q0, Tq, tid);
    else
      load_row(dsum_s + b * BM, dsum, q0, Tq, tid - BM);
  };

  load_tile<D>(ks, k, k0, Tk, tid);
  load_tile<D>(vs, v, k0, Tk, tid);
  load_q(i0, 0);
  cp_async_commit();

  int krows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) krows[h] = k0 + rw + g + 8 * h;

  for (int it = i0; it < n_q; ++it) {
    const int buf = (it - i0) & 1;
    const int q0 = it * BM;
    if (it + 1 < n_q) {
      load_q(it + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + buf * TILE;
    const bf16* dot = dos + buf * TILE;
    const float* lt = lse_s + buf * BM;
    const float* st = dsum_s + buf * BM;

#pragma unroll
    for (int c0 = 0; c0 < BM; c0 += NC) {
      // s^T = k.q^T and dp^T = v.do^T: 16 k rows x NC q columns
      float s[NC / 8][4], dp[NC / 8][4];
#pragma unroll
      for (int n = 0; n < NC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        ldmatrix_x4(ka, a_addr<D>(ks, rw, 16 * kk, lane));
        ldmatrix_x4(va, a_addr<D>(vs, rw, 16 * kk, lane));
#pragma unroll
        for (int np = 0; np < NC / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4(b, bnk_addr<D>(qt, c0 + 16 * np, 16 * kk, lane));
          mma(s[2 * np], ka, b[0], b[1]);
          mma(s[2 * np + 1], ka, b[2], b[3]);
          ldmatrix_x4(b, bnk_addr<D>(dot, c0 + 16 * np, 16 * kk, lane));
          mma(dp[2 * np], va, b[0], b[1]);
          mma(dp[2 * np + 1], va, b[2], b[3]);
        }
      }

      // p^T in place of s, ds^T in place of dp
#pragma unroll
      for (int n = 0; n < NC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1;
          const int qi = c0 + 8 * n + 2 * t + (e & 1), qcol = q0 + qi;
          const bool masked = qcol >= Tq || krows[h] >= Tk ||
                              (causal && k_off + krows[h] > q_off + qcol);
          const float p = masked ? 0.f : expf(s[n][e] * scale - lt[qi]);
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - st[qi]) * scale;
        }

      // dv += round(p^T) . do, dk += round(ds^T) . q: do and q are the
      // [q row][d] tiles read as [k][n]
#pragma unroll
      for (int kk = 0; kk < NC / 16; ++kk) {
        uint32_t pa[4], da[4];
        c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < D / 16; ++np) {
          uint32_t b[4];
          ldmatrix_x4_trans(b,
                            bkn_addr<D>(dot, c0 + 16 * kk, 16 * np, lane));
          mma(acc_v[2 * np], pa, b[0], b[1]);
          mma(acc_v[2 * np + 1], pa, b[2], b[3]);
          ldmatrix_x4_trans(b,
                            bkn_addr<D>(qt, c0 + 16 * kk, 16 * np, lane));
          mma(acc_k[2 * np], da, b[0], b[1]);
          mma(acc_k[2 * np + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();  // this buffer's readers are done
  }
}

// Each element (row, col, v0, v1) of a warp's C fragments: rows
// r0 + 16 * warp + g (+ 8), columns 8j + 2t, 8j + 2t + 1.
template <int D, typename F>
__device__ __forceinline__ void for_each_pair(const float (&acc)[D / 8][4],
                                              int r0, F&& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = r0 + 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    f(row, 8 * j + 2 * t, acc[j][0], acc[j][1]);
    f(row + 8, 8 * j + 2 * t, acc[j][2], acc[j][3]);
  }
}

}  // namespace flash_bwd_mma
