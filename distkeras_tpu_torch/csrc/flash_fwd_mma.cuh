// Tensor-core tile body of the bf16 flash-attention forward, shared by
// flash_attention_fwd.cu (fwd_kernel) and flash_hop.cu (hop_fwd_kernel).
// One device function, no kernel: each .cu keeps its own __global__
// function, its own start state and its own epilogue (out and lse
// finalized, or the online-softmax state written back as it is).
//
// The function, for one (batch, head) slab of q [Tq, D] and k, v [Tk, D]
// in bf16, on the online-softmax state (m, l, acc) of each q row in f32,
// one 64-row k tile at a time:
//   s = (q.k^T) * scale in f32; masked logits -1e30;
//   m_new = max(m, rowmax s); corr = exp(m - m_new);
//   l = l * corr + rowsum(p) over the unrounded p = exp(s - m_new);
//   acc = acc * corr + round_bf16(p).v with f32 sums;
// as the TPU kernels do (distkeras_tpu/ops/attention.py _fwd_kernel and
// _hop_fwd_kernel).  The mask compares GLOBAL positions, q_off + row >=
// k_off + col, and drops columns past Tk; the device-local forward is
// q_off = k_off = 0, Tq = Tk.
//
// A masked p is exactly 0 here: its logit enters the row max as the
// TPU's -1e30 (the running max starts each tile at -1e30, and m >= -1e30
// always) and p as exp(-inf) = 0.  The TPU does not zero it, and leaves
// exp(-1e30 - m_new).  For the device-local forward the two agree bit for
// bit: every row's first tile holds column 0, which it may see, so m_new
// is a finite logit from the first tile on and exp(-1e30 - m_new)
// underflows to exactly 0.  For a ring hop the TPU would add exp(0) per
// masked column to a row whose first tile holds no key it may see while m
// is still -1e30; no ring hop makes such a row (the diagonal hop runs
// first and its first tile holds the row's own block start), and the zero
// keeps the function right for any offsets.
//
// Layout: the 128 threads and padded bf16 tiles of flash_bwd_mma.cuh,
// whose helpers this reuses.  4 warps each own 16 rows of the block's
// 64-row q tile; q is copied into shared memory once and held as A
// fragments in registers; k and v stream in as 64-row tiles by 16-byte
// cp.async, double buffered and zero-filled past Tk.  s = q.k^T takes k as
// the B operand by plain ldmatrix (k's [key][d] tile is B's [n][k]); p.v
// takes p from the s accumulators (two neighbouring n8 C tiles are one
// m16k16 A fragment, rounded to bf16 in registers, the TPU's rounding
// point) and v by ldmatrix.trans ([key][d] is B's [k][n]).  Both products
// are mma.sync.m16n8k16 bf16 x bf16 -> f32.  Each lane holds two rows of
// its warp's 16, g and g + 8: their m and l live in registers, the row max
// and the row sum reduce over the lane quad by two xor shuffles, and corr
// rescales acc row by row before the tile's p.v.  Only tiles that hold a
// masked column for some row of the warp (the causal diagonal, the ragged
// edge) pay for the per-element mask test.  No atomics: each row has one
// owner, so reruns are bit-equal.

#pragma once

#include <math.h>

#include "flash_bwd_mma.cuh"

namespace flash_fwd_mma {

using flash_bwd_mma::bf16;
using flash_bwd_mma::BM;
using flash_bwd_mma::BN;
using flash_bwd_mma::NTHREADS;

constexpr float NEG = -1e30f;  // the TPU kernels' mask value

// q resident; k, v double buffered
template <int D>
constexpr size_t smem_bytes() {
  return sizeof(bf16) * 5 * flash_bwd_mma::tile_elems<D>();
}

// The state (m, l, acc) of this warp's rows q0 + 16 * warp + g and + 8
// (m[h], l[h] for row + 8h; acc as C fragments, n tile j = columns
// 8j..8j+7: row in acc[j][0..1], row + 8 in acc[j][2..3], columns 8j + 2t,
// 8j + 2t + 1) carried over the k tiles [0, n_tiles) of the slabs q, k, v.
// Every thread of the block must call it (it synchronizes); with n_tiles
// 0 it reads nothing and leaves the state as it was.
template <int D>
__device__ __forceinline__ void fwd_tile(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, int q0, int Tq, int Tk, int q_off,
    int k_off, int n_tiles, float scale, int causal, float (&m)[2],
    float (&l)[2], float (&acc)[D / 8][4], void* smem) {
  using namespace flash_bwd_mma;
  constexpr int TILE = tile_elems<D>();
  bf16* qs = static_cast<bf16*>(smem);  // [64][D + 8]
  bf16* ks = qs + TILE;                 // [2][64][D + 8]
  bf16* vs = ks + 2 * TILE;             // [2][64][D + 8]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rw = 16 * warp;
  if (n_tiles <= 0) return;

  load_tile<D>(qs, q, q0, Tq, tid);
  cp_async_commit();
  load_tile<D>(ks, k, 0, Tk, tid);
  load_tile<D>(vs, v, 0, Tk, tid);
  cp_async_commit();
  cp_async_wait<1>();  // q has landed; k, v tile 0 may still be in flight
  __syncthreads();
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qa[kk], a_addr<D>(qs, rw, 16 * kk, lane));

  int rows[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) rows[h] = q0 + rw + g + 8 * h;

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

    // s = q.k^T: 16 rows x 64 keys, 8 n tiles
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, bnk_addr<D>(kt, 16 * np, 16 * kk, lane));
        mma(s[2 * np], qa[kk], b[0], b[1]);
        mma(s[2 * np + 1], qa[kk], b[2], b[3]);
      }

    // scaled logits, -inf where masked (p = exp(-inf) = 0 below); the
    // test runs only where the warp's rows meet a masked column
    const bool edge = k0 + BN > Tk ||
                      (causal && k_off + k0 + BN - 1 > q_off + q0 + rw);
    if (edge) {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + 8 * n + 2 * t + (e & 1);
          const bool masked =
              col >= Tk || (causal && k_off + col > q_off + rows[e >> 1]);
          s[n][e] = masked ? -INFINITY : s[n][e] * scale;
        }
    } else {
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] *= scale;
    }

    // online softmax of rows g (h = 0) and g + 8 (h = 1) over the quad
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mt = NEG;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
        mt = fmaxf(mt, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m[h], mt);
      corr[h] = expf(m[h] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n)
#pragma unroll
        for (int e = 2 * h; e < 2 * h + 2; ++e) {
          s[n][e] = expf(s[n][e] - m_new);
          ls += s[n][e];
        }
      ls += __shfl_xor_sync(0xffffffffu, ls, 1);
      ls += __shfl_xor_sync(0xffffffffu, ls, 2);
      l[h] = l[h] * corr[h] + ls;
      m[h] = m_new;
    }
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jd][e] *= corr[e >> 1];

    // acc += round(p).v: v is the [key][d] tile read as [k][n]
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t a[4];
      c_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, bkn_addr<D>(vt, 16 * kk, 16 * np, lane));
        mma(acc[2 * np], a, b[0], b[1]);
        mma(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer's readers are done
  }
}

}  // namespace flash_fwd_mma
