// One tensor-core product body for the fused ResNet bottleneck's bf16
// kernels on Hopper (sm_90a), with the GroupNorm work in its epilogue.
//
//   C[m, n] = sum over k of A(m, k) * B(k, n),   bf16 in, f32 sums
//
// What bounds it on the H100: at the fused block's shapes the products
// are cheap (K and N of 64 to 2048) and the bytes around them are not,
// so a product moves the tensors its epilogue needs once and keeps the
// GroupNorm work on the accumulators.  The deep products are bound by
// the weight's traffic from L2 (every 64-row tile reads its column slice
// again), the shallow ones by device memory.
//
// Mainloop (one block = one or two 64-row tiles by BN columns): a ring
// of up to MAX_STAGES shared-memory stages, each a 64 x 64 A tile per
// consumer warpgroup and the 64 x BN B tile they share, brought in by TMA
// (cp.async.bulk.tensor, 128-byte swizzle) and signalled on mbarriers;
// one producer warp issues the copies; each consumer warpgroup runs
// wgmma.mma_async m64nBNk16 on its tile with both operands read from
// shared memory through matrix descriptors, one group kept in flight.
// Two warpgroups halve the weight's L2 traffic where two such blocks fit
// an SM; else one.  Several blocks share an SM, so one block's epilogue
// overlaps another's products.  Each product is a choice of operand
// major-ness in the descriptors (no transposition through registers):
//
//   x @ w       A K-major  (rows of [B, HW, C], a 3-D map)   B N-major
//   dy @ w^T    A K-major  (the same)                        B K-major
//   x^T @ dy    A M-major  (2-D [rows, C], row chunks)       B N-major
//
// Row tiles lie inside one image: the 3-D map over [B, HW, C] makes TMA
// zero-fill each image's ragged last tile, so its rows add nothing to a
// sum over the product.  Depth and width tails are zero-filled the same
// way, so a channel count only has to be a multiple of 8 (TMA's 16-byte
// row stride).
//
// Epilogue I/O goes through shared memory by TMA: the producer brings the
// epilogue's input tiles (an incoming gradient, the residual, y2) in
// while the mainloop runs, and the output tile (bf16 or f32, 128-byte
// swizzled, so the fragment-layout accesses hit 32 banks) leaves by one
// TMA store that clips the image's ragged rows.  Rows and columns past
// the tensor read as zeros, so they add nothing to a sum either.
//
// Epilogue: a functor that receives the accumulators in wgmma's fragment
// layout (warp w of the group holds rows 16w + g and 16w + g + 8, g =
// lane / 4, and columns 8j + 2t, 8j + 2t + 1 of each n8 block j, t = lane
// % 4, in registers 4j + 2h + e).  Per-channel sums over a tile's rows are
// taken in a fixed order: the thread's two rows, three halving shuffle
// steps over the eight row lanes (n8 blocks in pairs), then the four
// warps through shared memory.  No atomics.
// Where the plain version rounds, the functors round with __fmul_rn /
// __fadd_rn / __fsub_rn as the other passes of fused_block.cu do.
//
// Host side: the tensor maps are encoded for each call with
// cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (the
// libraries link no -lcuda), and passed as __grid_constant__ parameters.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace fused_block {
namespace tc {

constexpr int BM = 64;           // rows of a tile: one wgmma M
constexpr int BK = 64;           // depth of a stage: one 128-byte row of bf16
constexpr int MAX_STAGES = 4;
constexpr int WG = 128;          // threads of a consumer warpgroup
constexpr int A_BYTES = BM * BK * 2;
constexpr int SW_ATOM = 1024;    // 8 rows of 128 bytes: one swizzle atom
constexpr int EPI_FLOATS = 8 * 128 + 6 * 128;  // red [4][2][BN], cols [6][BN]
constexpr int BOX_BYTES = 8192;  // one box: 64 rows of 128 bytes
// shared memory a block aims to stay under, so that two fit an SM
constexpr int SMEM_BUDGET = 112 * 1024;

enum { MASK_NONE = 0, MASK_RELU = 1, MASK_RESID = 2 };
enum { APPLY_PLAIN = 0, APPLY_RELU = 1, APPLY_RESID_RELU = 2 };

// ---- PTX ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             const void* src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_3d(void* dst, const CUtensorMap* map,
                                       uint64_t* bar, int c0, int c1,
                                       int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma matrix descriptor for a 128-byte-swizzled tile at `p` (1024-byte
// aligned atoms): lbo, sbo in bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous product.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Barrier of consumer warpgroup wg alone (named barrier 1 + wg; 3 is the
// two groups').
__device__ __forceinline__ void sync_group(int wg) {
  if (wg == 0) {
    asm volatile("bar.sync 1, %0;\n" ::"n"(WG) : "memory");
  } else {
    asm volatile("bar.sync 2, %0;\n" ::"n"(WG) : "memory");
  }
}

// wgmma.mma_async m64nNk16, D += A * B; TA, TB: 1 for an M- or N-major
// operand, 0 for a K-major one.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da,
                                          uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int BN, int TA, int TB>
__device__ __forceinline__ void wgmma(float (&d)[BN / 2], uint64_t da,
                                      uint64_t db) {
  if constexpr (BN == 64) {
    wgmma_n64<TA, TB>(d, da, db);
  } else {
    wgmma_n128<TA, TB>(d, da, db);
  }
}

// ---- the product ----------------------------------------------------------

// K: depth; kc: depth per block along grid z (the weight gradient's row
// chunks; K otherwise); HW: rows per image (M for the 2-D product);
// ntiles: 64-row tiles per image (of M); N: columns; nin: the epilogue's
// input tiles; out: whether its output tile is stored; nz: images.
struct Geom {
  int K, kc, stages, HW, ntiles, N, nin, out, nz;
};

// What an epilogue knows of its tile.
struct Frag {
  int tid, wg;   // thread within its warpgroup, the warpgroup
  bool live;     // a tile of the tensor (not the zeros past its end)
  size_t row0;   // output row of the tile's first row
  int rows;      // rows of the tile that exist (the rest are TMA's zeros)
  int n0, N;     // first column, columns
  int b, tile, ntiles, z;
  float* red;    // shared [4][2][BN]: per-warp column sums
  float* cols;   // shared [6][BN]: per-column parameters
  const uint8_t* in[2];  // shared bf16 input tiles [64][BN]
  uint8_t* out;  // shared output tile [64][BN]
  bool store;    // whether the output tile is stored
};

// Byte offset of 16-byte chunk `chunk` of row r in a 128-byte-swizzled box.
__device__ __forceinline__ int sw128(int r, int chunk) {
  return r * 128 + ((chunk ^ (r & 7)) << 4);
}

// Columns c, c + 1 (c even) of row r of a bf16 tile kept as 64-column
// boxes.
__device__ __forceinline__ float2 tile_bf2(const uint8_t* t, int r, int c) {
  const int cc = c & 63;
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
      t + (c >> 6) * BOX_BYTES + sw128(r, cc >> 3) + (cc & 7) * 2));
}
__device__ __forceinline__ void tile_put(uint8_t* t, int r, int c,
                                         __nv_bfloat16, float a, float b) {
  const int cc = c & 63;
  *reinterpret_cast<__nv_bfloat162*>(t + (c >> 6) * BOX_BYTES +
                                     sw128(r, cc >> 3) + (cc & 7) * 2) =
      __floats2bfloat162_rn(a, b);
}
// ... of an f32 tile kept as 32-column boxes.
__device__ __forceinline__ void tile_put(uint8_t* t, int r, int c, float,
                                         float a, float b) {
  const int cc = c & 31;
  *reinterpret_cast<float2*>(t + (c >> 5) * BOX_BYTES + sw128(r, cc >> 2) +
                             (cc & 3) * 4) = make_float2(a, b);
}

// Block (x: BN-column tile; y: NWG 64-row tiles, numbered across the
// images, one a consumer warpgroup, or with A M-major the weight
// gradient's 64-row tile of M and z its chunk).  NWG * 128 + 32 threads:
// the consumer warpgroups, then the producer warp, whose one lane issues
// the copies: the tiles' depth stages through a ring of geo.stages (each
// stage: NWG A tiles and the B tile they share, which halves the
// weight's traffic from L2 at NWG 2), and the epilogue's input tiles
// (mi0, mi1: bf16 maps over [B, HW, N]) while the mainloop runs.  The
// output tiles (mo) reuse the stages' memory and leave by TMA stores.
// A tile numbered past the last image's (NWG 2, an odd count) reads
// zeros and writes nothing.  Registers are held so that two blocks of
// two warpgroups fit an SM.
template <int BN, int NWG, bool A_MN, bool B_MN, class Epi>
__global__ void __launch_bounds__(NWG * WG + 32, NWG > 1 ? 2 : 1)
    gemm_kernel(
    const __grid_constant__ CUtensorMap ma,
    const __grid_constant__ CUtensorMap mb,
    const __grid_constant__ CUtensorMap mi0,
    const __grid_constant__ CUtensorMap mi1,
    const __grid_constant__ CUtensorMap mo, const Geom geo, const Epi epi) {
  constexpr int B_BYTES = BN * BK * 2, STAGE = NWG * A_BYTES + B_BYTES;
  constexpr int IN_BYTES = BM * BN * 2;
  constexpr int OUT_BYTES = BM * BN * Epi::kOutBytes;
  constexpr int CONSUMERS = NWG * WG;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + SW_ATOM - 1) &
      ~static_cast<uintptr_t>(SW_ATOM - 1));
  const int S = geo.stages;
  // the stages, and after the mainloop the output tiles
  const int region0 =
      S * STAGE > NWG * OUT_BYTES ? S * STAGE : NWG * OUT_BYTES;
  uint8_t* in_tiles = smem + region0;  // [NWG][nin]
  uint64_t* full =
      reinterpret_cast<uint64_t*>(in_tiles + NWG * geo.nin * IN_BYTES);
  uint64_t* empty = full + MAX_STAGES;
  uint64_t* epi_bar = empty + MAX_STAGES;
  float* red = reinterpret_cast<float*>(epi_bar + 1);  // [NWG][EPI_FLOATS]
  const int n0 = blockIdx.x * BN, z = A_MN ? blockIdx.z : 0;
  const int kbeg = z * geo.kc;
  const int depth = min(geo.kc, geo.K - kbeg);
  const int ktiles = (depth + BK - 1) / BK;
  // warpgroup w's tile: its image (geo.nz of them; one for A M-major)
  // and its 64-row tile there
  auto tile_of = [&](int w, int& b, int& tile) {
    const int r = blockIdx.y * NWG + w;
    b = A_MN ? 0 : r / geo.ntiles;
    tile = A_MN ? r : r % geo.ntiles;
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NWG);
    }
    mbar_init(epi_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one lane issues
    if (threadIdx.x == CONSUMERS) {
      for (int kt = 0; kt < ktiles; ++kt) {
        const int s = kt % S;
        if (kt >= S) mbar_wait(&empty[s], ((kt / S) - 1) & 1);
        uint8_t* sa = smem + s * STAGE;
        uint8_t* sb = sa + NWG * A_BYTES;
        const int k0 = kbeg + kt * BK;
        mbar_expect_tx(&full[s], STAGE);
#pragma unroll
        for (int w = 0; w < NWG; ++w) {
          int b, tile;
          tile_of(w, b, tile);
          if constexpr (A_MN) {
            tma_2d(sa + w * A_BYTES, &ma, &full[s], tile * BM, k0);
          } else {
            tma_3d(sa + w * A_BYTES, &ma, &full[s], k0, tile * BM, b);
          }
        }
        if constexpr (B_MN) {
#pragma unroll
          for (int h = 0; h < BN / 64; ++h)
            tma_2d(sb + h * BOX_BYTES, &mb, &full[s], n0 + h * 64, k0);
        } else {
          tma_2d(sb, &mb, &full[s], k0, n0);
        }
        if (kt == 0 && geo.nin > 0) {  // the epilogue's inputs, meanwhile
          mbar_expect_tx(epi_bar, NWG * geo.nin * IN_BYTES);
#pragma unroll
          for (int w = 0; w < NWG; ++w) {
            int b, tile;
            tile_of(w, b, tile);
            for (int i = 0; i < geo.nin; ++i)
#pragma unroll
              for (int h = 0; h < BN / 64; ++h)
                tma_3d(in_tiles + (w * geo.nin + i) * IN_BYTES +
                           h * BOX_BYTES,
                       i == 0 ? &mi0 : &mi1, epi_bar, n0 + h * 64,
                       tile * BM, b);
          }
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x / WG;
  Frag f;
  int b, tile;
  tile_of(wg, b, tile);
  f.tid = threadIdx.x % WG;
  f.wg = wg;
  f.live = A_MN ? tile < geo.ntiles : b < geo.nz;
  f.row0 = A_MN ? static_cast<size_t>(tile) * BM
                : static_cast<size_t>(b) * geo.HW + tile * BM;
  f.rows = min(BM, geo.HW - tile * BM);
  f.n0 = n0;
  f.N = geo.N;
  f.b = b;
  f.tile = tile;
  f.ntiles = geo.ntiles;
  f.z = z;
  f.red = red + wg * EPI_FLOATS;
  f.cols = f.red + 8 * 128;
  f.in[0] = in_tiles + wg * geo.nin * IN_BYTES;
  f.in[1] = f.in[0] + (geo.nin > 1 ? IN_BYTES : 0);
  f.out = smem + wg * OUT_BYTES;
  f.store = geo.out != 0 && f.live;
  // the epilogue's per-column parameters, while the first tiles arrive
  epi.template begin<BN>(f);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < ktiles; ++kt) {
    const int s = kt % S;
    mbar_wait(&full[s], (kt / S) & 1);
    const uint8_t* sa = smem + s * STAGE + wg * A_BYTES;
    const uint8_t* sb = smem + s * STAGE + NWG * A_BYTES;
    fence_regs(acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // k16 steps: 32 bytes along a K-major row, 16 rows of 128 bytes
      // down an M/N-major tile
      const uint64_t da = A_MN ? desc(sa + kk * 2048, BOX_BYTES, SW_ATOM)
                               : desc(sa + kk * 32, 16, SW_ATOM);
      const uint64_t db = B_MN ? desc(sb + kk * 2048, BOX_BYTES, SW_ATOM)
                               : desc(sb + kk * 32, 16, SW_ATOM);
      wgmma<BN, A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
    }
    wg_commit();
    if (S > 1) {
      // one group stays in flight; the one before it has read its stage
      wg_wait<1>();
      fence_regs(acc);
      if (f.tid == 0 && kt > 0) mbar_arrive(&empty[(kt - 1) % S]);
    } else {
      wg_wait<0>();
      fence_regs(acc);
      if (f.tid == 0) mbar_arrive(&empty[s]);
    }
  }
  wg_wait<0>();
  fence_regs(acc);
  if (geo.nin > 0) mbar_wait(epi_bar, 0);
  // every stage has been read by both warpgroups' products: the output
  // tiles may overwrite them
  if constexpr (NWG > 1) {
    asm volatile("bar.sync 3, %0;\n" ::"n"(CONSUMERS) : "memory");
  } else {
    sync_group(wg);
  }
  epi.template run<BN>(acc, f);
  if constexpr (Epi::kOutBytes > 0) {
    if (geo.out) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      sync_group(wg);
      if (f.tid == 0 && f.live) {
        constexpr int W = 128 / Epi::kOutBytes;  // columns of a box
#pragma unroll
        for (int q = 0; q < BN / W; ++q)
          tma_store_3d(&mo, f.out + q * BOX_BYTES, n0 + q * W, tile * BM,
                       b);
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

// ---- epilogue helpers -----------------------------------------------------

struct Lane {
  int w, g, t;
  __device__ explicit Lane(const Frag& f)
      : w(f.tid / 32), g(f.tid % 32 / 4), t(f.tid % 4) {}
  __device__ int row(int h) const { return w * 16 + g + 8 * h; }
  __device__ int col(int j) const { return j * 8 + 2 * t; }
};

// Sums s[4 jj + k] (k: sum of column 2t, of 2t + 1, then the two squares)
// of n8 blocks j and j + 1 (jj = 0, 1) over the warp's 16 rows: three
// halving steps over the row lanes, each lane keeping the half its bit
// names and adding its partner's, so lane g ends with slot rev3(g)'s
// sum -> red[w][stat][column].  7 shuffles for 8 slots.
template <int BN>
__device__ __forceinline__ void reduce_pair(float (&s)[8], const Lane& L,
                                            float* red, int j) {
  const int lane = threadIdx.x % 32;
  float a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool hi = lane & 4;
    const float keep = hi ? s[i + 4] : s[i];
    const float send = hi ? s[i] : s[i + 4];
    a[i] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool hi = lane & 8;
    const float keep = hi ? a[i + 2] : a[i];
    const float send = hi ? a[i] : a[i + 2];
    b[i] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const bool hi = lane & 16;
  const float v = (hi ? b[1] : b[0]) +
                  __shfl_xor_sync(0xffffffffu, hi ? b[0] : b[1], 16);
  // slot q = 4 jj + 2 stat + e, with its bits taken from lane bits 2-4
  const int q = ((L.g & 1) << 2) | (L.g & 2) | ((L.g >> 2) & 1);
  const int jj = q >> 2, stat = (q >> 1) & 1, e = q & 1;
  red[(L.w * 2 + stat) * BN + (j + jj) * 8 + 2 * L.t + e] = v;
}

// The four warps' column sums, in order, -> part[b][tile][2][C] at the
// tile's columns.
template <int BN>
__device__ __forceinline__ void write_sums(float* part, const Frag& f,
                                           int C) {
  sync_group(f.wg);
  const int c = f.tid;
  if (f.live && c < BN && f.n0 + c < f.N) {
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s1 += f.red[w * 2 * BN + c];
      s2 += f.red[(w * 2 + 1) * BN + c];
    }
    float* out = part + (static_cast<size_t>(f.b) * f.ntiles + f.tile) * 2 *
                            C + f.n0 + c;
    out[0] = s1;
    out[C] = s2;
  }
}

// cols[0..5][BN] <- mean, inv, gamma, beta (and the group terms u1, u2)
// of each column of the tile, from the folded rows gst[B][G][4]; zeros
// past the last column.
template <int BN>
__device__ __forceinline__ void load_cols(const Frag& f, const float* gst,
                                          const float* gamma,
                                          const float* beta, int C, int G,
                                          bool terms) {
  const int c = f.tid, col = f.n0 + c;
  if (c < BN) {
    const bool in = f.live && col < f.N;
    const float* q = gst + (static_cast<size_t>(f.b) * G +
                            (in ? col / (C / G) : 0)) * 4;
    f.cols[c] = in ? q[0] : 0.f;
    f.cols[BN + c] = in ? q[1] : 0.f;
    f.cols[2 * BN + c] = in ? gamma[col] : 0.f;
    f.cols[3 * BN + c] = in ? beta[col] : 0.f;
    f.cols[4 * BN + c] = in && terms ? q[2] : 0.f;
    f.cols[5 * BN + c] = in && terms ? q[3] : 0.f;
  }
  sync_group(f.wg);
}

// ---- epilogues --------------------------------------------------------------
//
// kIn: bf16 input tiles the producer brings in; kOutBytes: the element
// size of the output tile (0: none).  Inputs past the tensor are zeros,
// and zeros add nothing to the sums; the output's are clipped by TMA.

// The product y and its per-tile channel sums of y and y^2 -> part[B][T]
// [2][C]; y itself in f32 where the output map is set (a kept y of #7,
// #8 or #9).
struct StatsEpi {
  static constexpr int kIn = 0, kOutBytes = 4;
  float* part;
  int C;
  template <int BN>
  __device__ __forceinline__ void begin(const Frag&) const {}
  template <int BN>
  __device__ __forceinline__ void run(float (&acc)[BN / 2],
                                      const Frag& f) const {
    const Lane L(f);
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
      float s[8];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int q = 4 * (j + jj);
        s[4 * jj] = acc[q] + acc[q + 2];
        s[4 * jj + 1] = acc[q + 1] + acc[q + 3];
        s[4 * jj + 2] = acc[q] * acc[q] + acc[q + 2] * acc[q + 2];
        s[4 * jj + 3] = acc[q + 1] * acc[q + 1] + acc[q + 3] * acc[q + 3];
        if (f.store) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            tile_put(f.out, L.row(h), L.col(j + jj), 0.f, acc[q + 2 * h],
                     acc[q + 2 * h + 1]);
        }
      }
      reduce_pair<BN>(s, L, f.red, j);
    }
    write_sums<BN>(part, f, C);
  }
};

// GroupNorm backward, first pass, on the recomputed product y: xhat from
// the folded (mean, inv); dz = grad (input 0) where the ReLU test z =
// xhat * gamma + beta (+ the residual, input 1) > 0 passes (mask); the
// per-tile sums of dz and dz * xhat -> partd; dz itself as the output
// tile where its map is set (the tail's dres).
struct BwdStatsEpi {
  static constexpr int kIn = 2, kOutBytes = 2;
  const float* gst;
  const float* gamma;
  const float* beta;
  float* partd;
  int C, G, mask;
  template <int BN>
  __device__ __forceinline__ void begin(const Frag& f) const {
    load_cols<BN>(f, gst, gamma, beta, C, G, false);
  }
  template <int BN>
  __device__ __forceinline__ void run(float (&acc)[BN / 2],
                                      const Frag& f) const {
    const Lane L(f);
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = L.row(h), c = L.col(j + jj);
          const float2 gd = tile_bf2(f.in[0], r, c);
          const float2 rs = mask == MASK_RESID ? tile_bf2(f.in[1], r, c)
                                               : make_float2(0.f, 0.f);
          float d[2] = {gd.x, gd.y};
          const float rv[2] = {rs.x, rs.y};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float* p = f.cols + c + e;
            const float xh = __fmul_rn(
                __fsub_rn(acc[4 * (j + jj) + 2 * h + e], p[0]), p[BN]);
            if (mask != MASK_NONE) {
              float zz = __fadd_rn(__fmul_rn(xh, p[2 * BN]), p[3 * BN]);
              if (mask == MASK_RESID) zz = __fadd_rn(zz, rv[e]);
              d[e] = zz > 0.f ? d[e] : 0.f;
            }
            s[4 * jj + e] += d[e];
            s[4 * jj + 2 + e] += d[e] * xh;
          }
          if (mask == MASK_RESID)
            tile_put(f.out, r, c, __nv_bfloat16(), d[0], d[1]);
        }
      }
      reduce_pair<BN>(s, L, f.red, j);
    }
    write_sums<BN>(partd, f, C);
  }
};

// GroupNorm backward, second pass, on the recomputed product y: dz from
// grad (input 0) behind the ReLU test (mask), dy_raw = inv * (dz * gamma
// - u1 - xhat * u2), rounded once to bf16 into the output tile.
struct BwdApplyEpi {
  static constexpr int kIn = 1, kOutBytes = 2;
  const float* gst;
  const float* gamma;
  const float* beta;
  int C, G, mask;
  template <int BN>
  __device__ __forceinline__ void begin(const Frag& f) const {
    load_cols<BN>(f, gst, gamma, beta, C, G, true);
  }
  template <int BN>
  __device__ __forceinline__ void run(float (&acc)[BN / 2],
                                      const Frag& f) const {
    const Lane L(f);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = L.row(h), c = L.col(j);
        const float2 gd = tile_bf2(f.in[0], r, c);
        const float d0[2] = {gd.x, gd.y};
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* p = f.cols + c + e;
          const float xh = __fmul_rn(__fsub_rn(acc[4 * j + 2 * h + e], p[0]),
                                     p[BN]);
          float d = d0[e];
          if (mask == MASK_RELU)
            d = __fadd_rn(__fmul_rn(xh, p[2 * BN]), p[3 * BN]) > 0.f ? d
                                                                      : 0.f;
          const float dzg = __fmul_rn(d, p[2 * BN]);
          o[e] = __fmul_rn(p[BN], __fsub_rn(__fsub_rn(dzg, p[4 * BN]),
                                            __fmul_rn(xh, p[5 * BN])));
        }
        tile_put(f.out, r, c, __nv_bfloat16(), o[0], o[1]);
      }
    }
  }
};

// The product itself, rounded to bf16, as the output tile (dx).
struct StoreEpi {
  static constexpr int kIn = 0, kOutBytes = 2;
  template <int BN>
  __device__ __forceinline__ void begin(const Frag&) const {}
  template <int BN>
  __device__ __forceinline__ void run(float (&acc)[BN / 2],
                                      const Frag& f) const {
    const Lane L(f);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        tile_put(f.out, L.row(h), L.col(j), __nv_bfloat16(),
                 acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
};

// The forward's GroupNorm on the recomputed product y (#7's and #9's
// second pass): (y - mean) * inv * gamma + beta from the folded rows
// gst, then per mode a ReLU, or the residual (input 0) added and a ReLU;
// rounded once to bf16 into the output tile.
struct ApplyEpi {
  static constexpr int kIn = 1, kOutBytes = 2;
  const float* gst;
  const float* gamma;
  const float* beta;
  int C, G, mode;
  template <int BN>
  __device__ __forceinline__ void begin(const Frag& f) const {
    load_cols<BN>(f, gst, gamma, beta, C, G, false);
  }
  template <int BN>
  __device__ __forceinline__ void run(float (&acc)[BN / 2],
                                      const Frag& f) const {
    const Lane L(f);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = L.row(h), c = L.col(j);
        const float2 rs = mode == APPLY_RESID_RELU ? tile_bf2(f.in[0], r, c)
                                                   : make_float2(0.f, 0.f);
        const float rv[2] = {rs.x, rs.y};
        float o[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* p = f.cols + c + e;
          const float xh = __fmul_rn(__fsub_rn(acc[4 * j + 2 * h + e], p[0]),
                                     p[BN]);
          float z = __fadd_rn(__fmul_rn(xh, p[2 * BN]), p[3 * BN]);
          if (mode == APPLY_RESID_RELU) z = __fadd_rn(z, rv[e]);
          o[e] = mode == APPLY_PLAIN ? z : fmaxf(z, 0.f);
        }
        tile_put(f.out, r, c, __nv_bfloat16(), o[0], o[1]);
      }
    }
  }
};

// The weight gradient's chunk partial in f32: part[z][row][col] of the
// [M, N] product, stored from the fragments.
struct ChunkEpi {
  static constexpr int kIn = 0, kOutBytes = 0;
  float* part;
  int M, N;
  template <int BN>
  __device__ __forceinline__ void begin(const Frag&) const {}
  template <int BN>
  __device__ __forceinline__ void run(float (&acc)[BN / 2],
                                      const Frag& f) const {
    const Lane L(f);
    float* o = part + static_cast<size_t>(f.z) * M * N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = L.row(h), col = f.n0 + L.col(j);
        if (r < f.rows && col < f.N)
          *reinterpret_cast<float2*>(o + (f.row0 + r) * N + col) =
              make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
    }
  }
};

// The tail's dh = dy3 @ w^T behind h's ReLU: u = xhat2 * g2 + b2 from y2
// (input 0) and GN2's folded statistics; dh = product where u > 0; dh as
// the f32 output tile (ws2) and GN2's per-tile sums of dh and dh * xhat2
// -> partd.
struct DhEpi {
  static constexpr int kIn = 1, kOutBytes = 4;
  const float* gst;
  const float* gamma;
  const float* beta;
  float* partd;
  int C, G;
  template <int BN>
  __device__ __forceinline__ void begin(const Frag& f) const {
    load_cols<BN>(f, gst, gamma, beta, C, G, false);
  }
  template <int BN>
  __device__ __forceinline__ void run(float (&acc)[BN / 2],
                                      const Frag& f) const {
    const Lane L(f);
#pragma unroll
    for (int j = 0; j < BN / 8; j += 2) {
      float s[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = L.row(h), c = L.col(j + jj);
          const float2 yv = tile_bf2(f.in[0], r, c);
          const float y[2] = {yv.x, yv.y};
          float dh[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float* p = f.cols + c + e;
            const float xh = __fmul_rn(__fsub_rn(y[e], p[0]), p[BN]);
            const float u = __fadd_rn(__fmul_rn(xh, p[2 * BN]), p[3 * BN]);
            dh[e] = u > 0.f ? acc[4 * (j + jj) + 2 * h + e] : 0.f;
            s[4 * jj + e] += dh[e];
            s[4 * jj + 2 + e] += dh[e] * xh;
          }
          tile_put(f.out, r, c, 0.f, dh[0], dh[1]);
        }
      }
      reduce_pair<BN>(s, L, f.red, j);
    }
    write_sums<BN>(partd, f, C);
  }
};

// ---- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// Error codes of this file's host side (cudaError_t values stay below).
enum { ERR_NO_ENCODER = 9000, ERR_ENCODE = 9100 };

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A tensor map of bf16 (esize 2) or f32 (4), 128-byte swizzle, zeros
// outside the tensor: dims and box innermost first, strides in bytes of
// every dim but the first.
inline int encode(CUtensorMap* m, const void* p, int esize, int rank,
                  const cuuint64_t* dims, const cuuint64_t* strides,
                  const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return ERR_NO_ENCODER;
  const cuuint32_t ones[3] = {1, 1, 1};
  const CUresult r = fn(
      m, esize == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                    : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      rank, const_cast<void*>(p), dims, strides, box, ones,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE + static_cast<int>(r);
}

// [B, HW, C] rows, boxes of 128 bytes of channels by 64 rows of one image.
inline int map_rows(CUtensorMap* m, const void* p, int B, int HW, int C,
                    int esize = 2) {
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)HW, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * esize,
                                 (cuuint64_t)HW * C * esize};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / esize), BM, 1};
  return encode(m, p, esize, 3, dims, strides, box);
}

// A row-major bf16 [outer, inner] matrix, boxes of 64 x box_outer.
inline int map_2d(CUtensorMap* m, const void* p, long long inner,
                  long long outer, int box_outer) {
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_outer};
  return encode(m, p, 2, 2, dims, strides, box);
}


// Dynamic shared memory of one block: the stages on 1024-byte atoms (and
// the slack to align them; the output tile reuses them), the input
// tiles, the barriers, the epilogue's rows.
inline size_t smem_bytes(int bn, int nwg, int stages, int in_tiles,
                         int out_bytes) {
  size_t region0 =
      static_cast<size_t>(stages) * (nwg * A_BYTES + bn * BK * 2);
  const size_t out = static_cast<size_t>(nwg) * BM * bn * out_bytes;
  if (out > region0) region0 = out;
  return SW_ATOM + region0 +
         static_cast<size_t>(nwg) * in_tiles * BM * bn * 2 +
         (2 * MAX_STAGES + 1) * sizeof(uint64_t) +
         static_cast<size_t>(nwg) * EPI_FLOATS * sizeof(float);
}

// Stages of a block over `depth`: as many as it has depth tiles, at most
// MAX_STAGES, fewer (but two, so a load overlaps a product) where two
// blocks would not fit an SM.
inline int stages_for(int bn, int nwg, int depth, int in_tiles,
                      int out_bytes) {
  const int kt = (depth + BK - 1) / BK;
  int st = kt < MAX_STAGES ? kt : MAX_STAGES;
  while (st > 2 &&
         smem_bytes(bn, nwg, st, in_tiles, out_bytes) > SMEM_BUDGET)
    --st;
  return st;
}

inline int tiles64(int hw) { return (hw + BM - 1) / BM; }
inline int width_for(int n) { return n >= 128 ? 128 : 64; }

// The epilogue's tensors on [B, HW, N]: up to two bf16 inputs and an
// output (of Epi::kOutBytes), null where unused.
struct Io {
  const void* in0;
  const void* in1;
  void* out;
};

// The epilogue's input tiles that io names.
template <class Epi>
int inputs_of(const Io& io) {
  return Epi::kIn == 0 || io.in0 == nullptr
             ? 0
             : (Epi::kIn > 1 && io.in1 != nullptr ? 2 : 1);
}

// Consumer warpgroups of a row product's block: two, each its own 64-row
// tile sharing the B stages (half the weight's traffic from L2), where
// two such blocks with two stages fit an SM; else one.
template <class Epi>
int row_warpgroups(int bn, int K, const Io& io) {
  const int st = (K + BK - 1) / BK < 2 ? 1 : 2;
  return smem_bytes(bn, 2, st, inputs_of<Epi>(io), Epi::kOutBytes) <=
                 SMEM_BUDGET
             ? 2
             : 1;
}

template <int BN, int NWG, bool A_MN, bool B_MN, class Epi>
int launch(const CUtensorMap& ma, const CUtensorMap& mb, Geom geo,
           dim3 grid, const Epi& epi, const Io& io, int B, cudaStream_t s) {
  CUtensorMap mi[2] = {}, mo = {};
  const void* ins[2] = {io.in0, io.in1};
  geo.nin = 0;
  for (int i = 0; i < 2 && i < Epi::kIn && ins[i] != nullptr; ++i) {
    const int e = map_rows(&mi[i], ins[i], B, geo.HW, geo.N);
    if (e != 0) return e;
    geo.nin = i + 1;
  }
  geo.out = io.out != nullptr && Epi::kOutBytes > 0;
  if (geo.out) {
    const int e = map_rows(&mo, io.out, B, geo.HW, geo.N, Epi::kOutBytes);
    if (e != 0) return e;
  }
  geo.stages = stages_for(BN, NWG, geo.kc, geo.nin, Epi::kOutBytes);
  const size_t smem =
      smem_bytes(BN, NWG, geo.stages, geo.nin, Epi::kOutBytes);
  auto kernel = gemm_kernel<BN, NWG, A_MN, B_MN, Epi>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, NWG * WG + 32, smem, s>>>(ma, mb, mi[0], mi[1], mo, geo,
                                           epi);
  return static_cast<int>(cudaGetLastError());
}

// A row product's launch at its width and warpgroups: blocks of BN
// columns by NWG 64-row tiles numbered across the B images.
template <int BN, bool B_MN, class Epi>
int rows_launch(const CUtensorMap& ma, const CUtensorMap& mb,
                const Geom& geo, const Epi& epi, const Io& io, int B,
                cudaStream_t s) {
  const int tiles = B * geo.ntiles, ncol = (geo.N + BN - 1) / BN;
  if (row_warpgroups<Epi>(BN, geo.K, io) == 2)
    return launch<BN, 2, false, B_MN>(ma, mb, geo,
                                      dim3(ncol, (tiles + 1) / 2), epi, io,
                                      B, s);
  return launch<BN, 1, false, B_MN>(ma, mb, geo, dim3(ncol, tiles), epi, io,
                                    B, s);
}

// a [B, HW, K] @ w [K, N] (w N-major); the epilogue's tensors io on
// [B, HW, N].
template <class Epi>
int rows_times_w(const __nv_bfloat16* a, const __nv_bfloat16* w, int B,
                 int HW, int K, int N, const Epi& epi, const Io& io,
                 cudaStream_t s) {
  CUtensorMap ma, mb;
  int e = map_rows(&ma, a, B, HW, K);
  if (e == 0) e = map_2d(&mb, w, N, K, 64);
  if (e != 0) return e;
  const Geom geo{K, K, 0, HW, tiles64(HW), N, 0, 0, B};
  if (width_for(N) == 128)
    return rows_launch<128, true>(ma, mb, geo, epi, io, B, s);
  return rows_launch<64, true>(ma, mb, geo, epi, io, B, s);
}

// a [B, HW, K] @ w^T for w [N, K] (w K-major).
template <class Epi>
int rows_times_wt(const __nv_bfloat16* a, const __nv_bfloat16* w, int B,
                  int HW, int K, int N, const Epi& epi, const Io& io,
                  cudaStream_t s) {
  const int bn = width_for(N);
  CUtensorMap ma, mb;
  int e = map_rows(&ma, a, B, HW, K);
  if (e == 0) e = map_2d(&mb, w, K, N, bn);
  if (e != 0) return e;
  const Geom geo{K, K, 0, HW, tiles64(HW), N, 0, 0, B};
  if (bn == 128) return rows_launch<128, false>(ma, mb, geo, epi, io, B, s);
  return rows_launch<64, false>(ma, mb, geo, epi, io, B, s);
}

// a^T @ d over `rows` rows of a [rows, M] and d [rows, N], in chunks of kc
// rows (a multiple of BK), each chunk's f32 sum -> part[chunk][M][N].
inline int rows_t_times_rows(const __nv_bfloat16* a, const __nv_bfloat16* d,
                             float* part, long long rows, int M, int N,
                             int chunks, int kc, cudaStream_t s) {
  CUtensorMap ma, mb;
  int e = map_2d(&ma, a, M, rows, 64);
  if (e == 0) e = map_2d(&mb, d, N, rows, 64);
  if (e != 0) return e;
  const Geom geo{static_cast<int>(rows), kc, 0, M, (M + BM - 1) / BM, N,
                 0, 0, 1};
  const ChunkEpi epi{part, M, N};
  const Io io{nullptr, nullptr, nullptr};
  const int bn = width_for(N);
  const dim3 grid((N + bn - 1) / bn, (M + BM - 1) / BM, chunks);
  if (bn == 128)
    return launch<128, 1, true, true>(ma, mb, geo, grid, epi, io, 1, s);
  return launch<64, 1, true, true>(ma, mb, geo, grid, epi, io, 1, s);
}

}  // namespace tc
}  // namespace fused_block
