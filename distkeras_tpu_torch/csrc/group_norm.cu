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
// ResNet-50 stem's [32, 12544, 64] bf16 takes 31 us forward, 46 us
// backward.
//
// Design.  The TPU kernel holds one whole image in VMEM per grid step,
// so it reads each input once.  An image does not fit one SM here (1.6
// MB of bf16 x at the ResNet-50 stem against 227 KB of shared memory),
// so the one-pass route spreads each image over a thread-block cluster
// of k blocks, which together hold it on chip.  Groups are independent,
// so an image may also be cut into S channel splits of whole groups,
// each its own cluster (grid k x S x B): more, smaller clusters fill the
// card's SMs in fewer waves.  In each cluster:
//   1. each block loads its R rows of x (and of dy) into its own shared
//      memory, each thread copying the 16-byte vectors it will read
//      (cp.async) in NCHUNK pieces, and starts its statistics on the
//      first piece while the rest arrive;
//   2. it reduces its rows to partial sums in a fixed order (each thread
//      owns a fixed 16-byte vector of channels; the row lanes fold by
//      warp shuffles, then through shared memory): per group sum x and
//      sum x^2 (forward); per channel sum dy and sum dy*xhat, and per
//      group their gamma-weighted t1, t2 parts (backward);
//   3. it stores its partials into every peer's shared memory
//      (distributed shared memory, one slot per rank; in the backward
//      each channel's sums only to the block that owns the channel),
//      then meets them at one cluster barrier; each block sums the slots
//      in rank order, so all compute the same statistics bit for bit,
//      with no atomics; rank 0 writes mean and inv-std, each rank its
//      share of the channels of dgamma and dbeta.  No block reads or
//      writes a peer after that barrier, so none waits for the others
//      before it exits;
//   4. it applies the result to the rows it holds and writes y or dx
//      with 16-byte stores.
// So each input is read once and each output written once, in one
// launch.  S and k are chosen per shape by ops/group_norm.py
// launch_plan, from the block's shared memory and the card's cluster
// capacity (k up to 8, the portable limit: the backward's x and dy of a
// 1.6 MB bf16 image go as 2 to 8 channel splits in clusters of 8 or
// fewer).
//
// Images no launch of clusters can hold (e.g. a 448-pixel stem), rows
// that do not split into 16-byte vectors and unaligned tensors take the
// two-pass route, also chosen before launch: a statistics grid over
// (row tile, image) blocks of about TILE_ELEMS elements writes per-tile
// partials, a fold grid folds them once per image in a fixed order
// (mean, inv-std; or dbeta, dgamma and the group terms), and an apply
// grid reads only the folded 2G values per image and streams the tile
// once more.  Sums are taken in a fixed order on both routes, so a run
// is deterministic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int NCHUNK = 4;    // load pieces of a cluster block's rows
constexpr int KMAX = 8;      // largest cluster (the portable limit)
constexpr int SMEM_MAX = 232448;  // dynamic shared memory a block may use

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
// rows rl, rl + RP, ... of the tile (threads with rl >= RP idle).  Where
// CVc is a power of two under 32, a warp holds RW = 32/CVc row lanes,
// which fold by shuffles first; E row lanes (or warps) are then left,
// and lane 0 folds the other E - 1 from a buffer of [2][E-1][CVc*V].
struct Lanes {
  int CV, CVc, RP, RW, E, vl, rl;
  __host__ __device__ Lanes(int C, int V, int t = 0) {
    CV = C / V;
    CVc = CV < NT ? CV : NT;
    RP = NT / CVc;
    RW = CVc < 32 && (CVc & (CVc - 1)) == 0 ? 32 / CVc : 1;
    E = RP / RW;
    vl = t % CVc;
    rl = t / CVc;
  }
};

// f32 of the row lanes' fold buffer, [2][E-1][CVc*V].
__host__ __device__ inline int fold_floats(int C, int V) {
  const Lanes L(C, V);
  return 2 * (L.E - 1) * L.CVc * V;
}

// Folds every row lane's per-vector sums a1, a2 into out[0..C) and
// out[C..2C) for the chunk starting at vector vb, in a fixed order:
// halving shuffles over the row lanes of a warp, then the E - 1 other
// (warps') lanes through red (16 bytes a store), added in order by the
// threads of row lane 0.  Ends with the block synchronized.
template <int V>
__device__ __forceinline__ void fold_rows(float* red, float* out,
                                          const Lanes& L, float* a1,
                                          float* a2, int vb, int C) {
  const int w = L.CVc * V;
  for (int o = L.CVc; o < L.CVc * L.RW; o *= 2) {
#pragma unroll
    for (int j = 0; j < V; ++j) {
      a1[j] += __shfl_xor_sync(0xffffffffu, a1[j], o);
      a2[j] += __shfl_xor_sync(0xffffffffu, a2[j], o);
    }
  }
  const int e = L.rl / L.RW;
  if (L.rl < L.RP && L.rl % L.RW == 0 && e > 0) {
    float* p1 = red + (e - 1) * w + L.vl * V;
    float* p2 = p1 + (L.E - 1) * w;
    if constexpr (V % 4 == 0) {
#pragma unroll
      for (int j = 0; j < V; j += 4) {
        reinterpret_cast<float4*>(p1)[j / 4] =
            make_float4(a1[j], a1[j + 1], a1[j + 2], a1[j + 3]);
        reinterpret_cast<float4*>(p2)[j / 4] =
            make_float4(a2[j], a2[j + 1], a2[j + 2], a2[j + 3]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        p1[j] = a1[j];
        p2[j] = a2[j];
      }
    }
  }
  __syncthreads();
  const int v = vb + L.vl;
  if (L.rl == 0 && v < L.CV) {
    for (int r = 0; r < L.E - 1; ++r) {
#pragma unroll
      for (int j = 0; j < V; ++j) {
        a1[j] += red[r * w + L.vl * V + j];
        a2[j] += red[(L.E - 1 + r) * w + L.vl * V + j];
      }
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      out[v * V + j] = a1[j];
      out[C + v * V + j] = a2[j];
    }
  }
  __syncthreads();
}

// Per-group sums of csum[0..C) and of csum[C..2C), each term times w[c]
// where w is given, into out[g] and out[G + g], in a fixed order: where
// a group's cg channels are a power of two, a warp sums runs of them by
// halving shuffles over 32 consecutive channels (bank-conflict free);
// otherwise one thread sums a group.
__device__ __forceinline__ void group_sums(const float* csum, const float* w,
                                           float* out, int C, int G) {
  const int cg = C / G, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (cg & (cg - 1)) {
    for (int g = threadIdx.x; g < G; g += NT) {
      float s1 = 0.f, s2 = 0.f;
      for (int i = 0; i < cg; ++i) {
        const int c = g * cg + i;
        const float m = w ? w[c] : 1.f;
        s1 += m * csum[c];
        s2 += m * csum[C + c];
      }
      out[g] = s1;
      out[G + g] = s2;
    }
    return;
  }
  if (cg <= 32) {  // each 32 channels hold 32 / cg whole groups
    for (int c0 = warp * 32; c0 < C; c0 += NT) {
      const int c = c0 + lane;
      const float m = c < C ? (w ? w[c] : 1.f) : 0.f;
      float s1 = c < C ? m * csum[c] : 0.f;
      float s2 = c < C ? m * csum[C + c] : 0.f;
      for (int o = cg / 2; o > 0; o /= 2) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        s2 += __shfl_xor_sync(0xffffffffu, s2, o);
      }
      if (c < C && lane % cg == 0) {
        out[c / cg] = s1;
        out[G + c / cg] = s2;
      }
    }
    return;
  }
  for (int g = warp; g < G; g += NT / 32) {  // a warp a group
    float s1 = 0.f, s2 = 0.f;
    for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
      const float m = w ? w[c] : 1.f;
      s1 += m * csum[c];
      s2 += m * csum[C + c];
    }
    for (int o = 16; o > 0; o /= 2) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      out[g] = s1;
      out[G + g] = s2;
    }
  }
}

// ---- the one-pass route: one cluster per image --------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The cluster barrier, split: arrive (relaxed, or releasing this
// thread's writes to the cluster) and wait (acquiring the others').
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Stores v at p's counterpart in the shared memory of cluster block
// `rank` (distributed shared memory).
__device__ __forceinline__ void put_peer(float* p, int rank, float v) {
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(a), "f"(v)
               : "memory");
}

// Byte offsets of a cluster block's shared memory, for a block of R rows
// of Cl channels (its split of C) and Gl groups: its rows of each input
// (x, then dy), each padded to 128 bytes; the row lanes' fold buffer
// [2][E-1][CVc*V] f32; f32 statistics (forward: channel sums [2Cl],
// group sums [2Gl], the peers' group sums [k][2Gl]; backward: channel
// sums [2Cl], group parts [2Gl], the peers' group parts [k][2Gl] and
// channel sums of this block's share [k][2][ceil(Cl/k)]).
// ops/group_norm.py _cluster_smem computes the same total.
struct Smem {
  long long in, red, small, total;
};

__host__ __device__ inline Smem cluster_smem(int R, int Cl, int Gl,
                                             int item, int V, int nin,
                                             int k) {
  const long long stats =
      nin == 1 ? 2LL * Cl + 2LL * Gl + 2LL * k * Gl
               : 2LL * Cl + 2LL * Gl + 2LL * k * Gl
                     + 2LL * k * ((Cl + k - 1) / k);
  Smem s;
  s.in = ((long long)R * Cl * item + 127) / 128 * 128;
  s.red = nin * s.in;
  s.small = s.red + 4LL * fold_floats(Cl, V);
  s.total = s.small + 4 * stats;
  return s;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

// Waits until this thread's copies of load pieces 0..p have landed
// (one commit group a piece, NCHUNK of them).
__device__ __forceinline__ void wait_piece(int p) {
  static_assert(NCHUNK == 4, "wait_piece waits on 4 groups");
  if (p == 0)
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
  else if (p == 1)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else if (p == 2)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows a load piece holds: a positive multiple of the row lanes, so each
// thread walks whole pieces.
__device__ __forceinline__ int piece_rows(int nrows, int RP) {
  const int per = (nrows + NCHUNK - 1) / NCHUNK;
  return max(1, (per + RP - 1) / RP) * RP;
}

// Each thread copies the 16-byte vectors it will read (its lanes' rows
// and vectors) of a (and of b, when given) from global rows of stride ld
// into shared rows of Cl elements, one commit group a piece of pr rows,
// so it waits on its own copies only.
template <typename T, int V>
__device__ __forceinline__ void start_loads(T* as, T* bs, const T* a,
                                            const T* b, int nrows, int pr,
                                            int Cl, int ld,
                                            const Lanes& L) {
  for (int p = 0; p < NCHUNK; ++p) {
    if (L.rl < L.RP) {
      const int e = min(nrows, (p + 1) * pr);
      for (int vb = 0; vb < L.CV; vb += L.CVc) {
        const int v = vb + L.vl;
        if (v >= L.CV) continue;
        for (int r = p * pr + L.rl; r < e; r += L.RP) {
          cp16(as + (size_t)r * Cl + v * V, a + (size_t)r * ld + v * V);
          if (b)
            cp16(bs + (size_t)r * Cl + v * V, b + (size_t)r * ld + v * V);
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
}

// Forward, one launch: grid (k, S, B) in clusters of k blocks along x.
// Block `rank` of split s of image b holds rows [rank*R, rank*R + R) of
// the split's Cl = C/S channels (Gl = G/S groups).
template <typename T, int V>
__global__ void __launch_bounds__(NT, 2) fwd_cluster_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, T* __restrict__ y,
    float* __restrict__ mean_out, float* __restrict__ inv_out, int HW,
    int C, int G, int R, float count, float eps, int relu) {
  extern __shared__ __align__(128) unsigned char held[];
  const int k = gridDim.x, rank = blockIdx.x, s = blockIdx.y;
  const int b = blockIdx.z, Cl = C / gridDim.y, Gl = G / gridDim.y;
  gamma += s * Cl;
  beta += s * Cl;
  mean_out += b * G + s * Gl;
  inv_out += b * G + s * Gl;
  const Smem S = cluster_smem(R, Cl, Gl, sizeof(T), V, 1, k);
  T* xs = reinterpret_cast<T*>(held);
  float* red = reinterpret_cast<float*>(held + S.red);
  float* csum = reinterpret_cast<float*>(held + S.small);  // [2][Cl]
  float* part = csum + 2 * Cl;     // [2][Gl] this block's group sums
  float* inbox = part + 2 * Gl;    // [k][2Gl], block q's group sums at [q]
  float* gmean = csum;             // [Gl], once the channel sums are spent
  float* ginv = csum + Gl;         // [Gl]
  const int r0 = rank * R, nrows = max(0, min(HW - r0, R));
  const Lanes L(Cl, V, threadIdx.x);
  const int pr = piece_rows(nrows, L.RP);
  const size_t base = ((size_t)b * HW + r0) * C + (size_t)s * Cl;
  start_loads<T, V>(xs, nullptr, x + base, nullptr, nrows, pr, Cl, C, L);
  cluster_arrive_relaxed();  // this block has started
  // gamma and beta of this thread's first vector, read while rows land
  float pg[V], pb[V];
#pragma unroll
  for (int j = 0; j < V; ++j) {
    pg[j] = gamma[L.vl * V + j];
    pb[j] = beta[L.vl * V + j];
  }

  // 2. this block's channel sums of x and x^2, then its group sums
  for (int vb = 0; vb < L.CV; vb += L.CVc) {
    const int v = vb + L.vl;
    float a1[V], a2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) a1[j] = a2[j] = 0.f;
    if (L.rl < L.RP && v < L.CV) {
      for (int p = 0; p * pr < nrows; ++p) {
        wait_piece(p);
        const int e = min(nrows, (p + 1) * pr);
#pragma unroll 4
        for (int r = p * pr + L.rl; r < e; r += L.RP) {
          float f[V];
          load_v<T, V>(xs + (size_t)r * Cl + v * V, f);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            a1[j] += f[j];
            a2[j] += f[j] * f[j];
          }
        }
      }
    }
    fold_rows<V>(red, csum, L, a1, a2, vb, Cl);
  }
  group_sums(csum, nullptr, part, Cl, Gl);
  cluster_wait();     // every block has started: its inbox can be written
  __syncthreads();

  // 3. this block's group sums into every block's inbox; then the
  // split's statistics from all of them, in rank order
  for (int i = threadIdx.x; i < 2 * Gl * k; i += NT)
    put_peer(inbox + rank * 2 * Gl + i % (2 * Gl), i / (2 * Gl),
             part[i % (2 * Gl)]);
  cluster_arrive();
  cluster_wait();
  for (int g = threadIdx.x; g < Gl; g += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int q = 0; q < k; ++q) {
      s1 += inbox[q * 2 * Gl + g];
      s2 += inbox[q * 2 * Gl + Gl + g];
    }
    const float m = s1 / count;
    const float var = fmaxf(s2 / count - m * m, 0.f);
    const float inv = rsqrtf(var + eps);
    gmean[g] = m;
    ginv[g] = inv;
    if (rank == 0) {
      mean_out[g] = m;
      inv_out[g] = inv;
    }
  }
  __syncthreads();

  // 4. y from the rows held in shared memory
  if (L.rl >= L.RP) return;
  const int cg = C / G;
  for (int vb = 0; vb < L.CV; vb += L.CVc) {
    const int v = vb + L.vl;
    if (v >= L.CV) continue;
    float sc[V], sf[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = v * V + j;
      sc[j] = ginv[c / cg] * (vb ? gamma[c] : pg[j]);
      sf[j] = __fsub_rn(vb ? beta[c] : pb[j], __fmul_rn(gmean[c / cg], sc[j]));
    }
#pragma unroll 4
    for (int r = L.rl; r < nrows; r += L.RP) {
      float f[V];
      load_v<T, V>(xs + (size_t)r * Cl + v * V, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float o = __fadd_rn(__fmul_rn(f[j], sc[j]), sf[j]);
        f[j] = relu ? fmaxf(o, 0.f) : o;
      }
      store_v<T, V>(y + base + (size_t)r * C + v * V, f);
    }
  }
}

// Backward, one launch, laid out as the forward.
template <typename T, int V>
__global__ void __launch_bounds__(NT, 2) bwd_cluster_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ mean, const float* __restrict__ inv,
    T* __restrict__ dx, float* __restrict__ dgamma_b,
    float* __restrict__ dbeta_b, int HW, int C, int G, int R, float count,
    int relu) {
  extern __shared__ __align__(128) unsigned char held[];
  const int k = gridDim.x, rank = blockIdx.x, s = blockIdx.y;
  const int b = blockIdx.z, Cl = C / gridDim.y, Gl = G / gridDim.y;
  gamma += s * Cl;
  beta += s * Cl;
  mean += b * G + s * Gl;
  inv += b * G + s * Gl;
  dgamma_b += b * C + s * Cl;
  dbeta_b += b * C + s * Cl;
  const Smem S = cluster_smem(R, Cl, Gl, sizeof(T), V, 2, k);
  const int share = (Cl + k - 1) / k;
  T* xs = reinterpret_cast<T*>(held);
  T* ds = reinterpret_cast<T*>(held + S.in);
  float* red = reinterpret_cast<float*>(held + S.red);
  float* csum = reinterpret_cast<float*>(held + S.small);  // [2][Cl]
  float* gpart = csum + 2 * Cl;     // [2][Gl] parts of t1, t2
  float* inbox_g = gpart + 2 * Gl;  // [k][2Gl], block q's parts at [q]
  float* inbox_c = inbox_g + 2 * k * Gl;  // [k][2][share] of this block's
                                          // channels, block q's at [q]
  float* t1 = csum;       // [Gl]  sum(dy*gamma) / count, once csum is spent
  float* t2 = csum + Gl;  // [Gl]  sum(dy*gamma*xhat) / count
  const int r0 = rank * R, nrows = max(0, min(HW - r0, R));
  const Lanes L(Cl, V, threadIdx.x);
  const int pr = piece_rows(nrows, L.RP);
  const size_t base = ((size_t)b * HW + r0) * C + (size_t)s * Cl;
  start_loads<T, V>(xs, ds, x + base, dy + base, nrows, pr, Cl, C, L);
  cluster_arrive_relaxed();  // this block has started
  const int cg = C / G;

  // 2. this block's channel sums of the (masked) dy and of dy * xhat
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
        mc[j] = mean[c / cg];
        ic[j] = inv[c / cg];
        ga[j] = gamma[c];
        be[j] = beta[c];
      }
      for (int p = 0; p * pr < nrows; ++p) {
        wait_piece(p);
        const int e = min(nrows, (p + 1) * pr);
#pragma unroll 4
        for (int r = p * pr + L.rl; r < e; r += L.RP) {
          float xf[V], df[V];
          load_v<T, V>(xs + (size_t)r * Cl + v * V, xf);
          load_v<T, V>(ds + (size_t)r * Cl + v * V, df);
#pragma unroll
          for (int j = 0; j < V; ++j) {
            const float xh = (xf[j] - mc[j]) * ic[j];
            if (relu && !(relu_z(xh, ga[j], be[j]) > 0.f)) df[j] = 0.f;
            a1[j] += df[j];
            a2[j] += df[j] * xh;
          }
          // the masked dy (dy or 0, exact in T) replaces dy, so step 4
          // does not test again
          if (relu) store_v<T, V>(ds + (size_t)r * Cl + v * V, df);
        }
      }
    }
    fold_rows<V>(red, csum, L, a1, a2, vb, Cl);
  }
  group_sums(csum, gamma, gpart, Cl, Gl);
  cluster_wait();  // every block has started: its inboxes can be written
  __syncthreads();

  // 3. this block's group parts into every block's inbox, and its
  // channel sums into the inbox of the block that owns each channel
  // (block q owns [q*share, q*share + share)); then the group terms and
  // this block's share of dbeta and dgamma, each summed in rank order
  for (int i = threadIdx.x; i < 2 * Gl * k; i += NT)
    put_peer(inbox_g + rank * 2 * Gl + i % (2 * Gl), i / (2 * Gl),
             gpart[i % (2 * Gl)]);
  for (int c = threadIdx.x; c < Cl; c += NT) {
    const int q = c / share, j = c - q * share;
    put_peer(inbox_c + (rank * 2) * share + j, q, csum[c]);
    put_peer(inbox_c + (rank * 2 + 1) * share + j, q, csum[Cl + c]);
  }
  cluster_arrive();
  cluster_wait();
  const int c0 = rank * share, nc = max(0, min(Cl - c0, share));
  for (int i = threadIdx.x; i < Gl + nc; i += NT) {
    float s1 = 0.f, s2 = 0.f;
    if (i < Gl) {
      for (int q = 0; q < k; ++q) {
        s1 += inbox_g[q * 2 * Gl + i];
        s2 += inbox_g[q * 2 * Gl + Gl + i];
      }
      t1[i] = s1 / count;
      t2[i] = s2 / count;
    } else {
      const int j = i - Gl;
      for (int q = 0; q < k; ++q) {
        s1 += inbox_c[(q * 2) * share + j];
        s2 += inbox_c[(q * 2 + 1) * share + j];
      }
      dbeta_b[c0 + j] = s1;
      dgamma_b[c0 + j] = s2;
    }
  }
  __syncthreads();

  // 4. dx from the rows held in shared memory
  if (L.rl >= L.RP) return;
  for (int vb = 0; vb < L.CV; vb += L.CVc) {
    const int v = vb + L.vl;
    if (v >= L.CV) continue;
    float mc[V], ic[V], ga[V], u1[V], u2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int c = v * V + j, g = c / cg;
      mc[j] = mean[g];
      ic[j] = inv[g];
      ga[j] = gamma[c];
      u1[j] = t1[g];
      u2[j] = t2[g];
    }
#pragma unroll 4
    for (int r = L.rl; r < nrows; r += L.RP) {
      float xf[V], df[V];  // df: dy, masked in step 2 under the ReLU
      load_v<T, V>(xs + (size_t)r * Cl + v * V, xf);
      load_v<T, V>(ds + (size_t)r * Cl + v * V, df);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xf[j] - mc[j]) * ic[j];
        xf[j] = __fmul_rn(ic[j], __fsub_rn(__fsub_rn(__fmul_rn(df[j], ga[j]), u1[j]),
                                           __fmul_rn(xh, u2[j])));
      }
      store_v<T, V>(dx + base + (size_t)r * C + v * V, xf);
    }
  }
}

// ---- the two-pass route: statistics, a fold once per image, apply -------

// Forward pass 1: per-tile group sums of x and x^2 -> part[B][T][2][G].
template <typename T, int V>
__global__ void __launch_bounds__(NT) fwd_stats_kernel(
    const T* __restrict__ x, float* __restrict__ part, int HW, int C,
    int G, int R, int ntiles) {
  extern __shared__ float sh[];
  const Lanes L(C, V, threadIdx.x);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  float* red = sh;                           // [2][E-1][CVc*V]
  float* csum = sh + fold_floats(C, V);  // [2][C]
  const T* xb = x + (size_t)b * HW * C;
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
    fold_rows<V>(red, csum, L, a1, a2, vb, C);
  }
  group_sums(csum, nullptr, part + ((size_t)b * ntiles + tile) * 2 * G, C,
             G);
}

// Forward fold, one block per image: the tiles' group sums in tile order
// -> mean and inv-std [B, G].
__global__ void __launch_bounds__(NT) fwd_fold_kernel(
    const float* __restrict__ part, float* __restrict__ mean_out,
    float* __restrict__ inv_out, int G, int ntiles, float count,
    float eps) {
  const int b = blockIdx.x;
  const float* pb = part + (size_t)b * ntiles * 2 * G;
  for (int g = threadIdx.x; g < G; g += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      s1 += pb[t * 2 * G + g];
      s2 += pb[t * 2 * G + G + g];
    }
    const float m = s1 / count;
    const float var = fmaxf(s2 / count - m * m, 0.f);
    mean_out[b * G + g] = m;
    inv_out[b * G + g] = rsqrtf(var + eps);
  }
}

// Forward pass 2: y from the folded statistics (2G values an image).
template <typename T, int V>
__global__ void __launch_bounds__(NT) fwd_apply_kernel(
    const T* __restrict__ x, const float* __restrict__ gamma,
    const float* __restrict__ beta, const float* __restrict__ mean,
    const float* __restrict__ inv, T* __restrict__ y, int HW, int C, int G,
    int R, int relu) {
  extern __shared__ float sh[];
  float* scale = sh;        // [C]
  float* shift = sh + C;    // [C]
  const int b = blockIdx.y, tile = blockIdx.x, cg = C / G;
  for (int c = threadIdx.x; c < C; c += NT) {
    const float s = inv[b * G + c / cg] * gamma[c];
    scale[c] = s;
    shift[c] = __fsub_rn(beta[c], __fmul_rn(mean[b * G + c / cg], s));
  }
  __syncthreads();
  const Lanes L(C, V, threadIdx.x);
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
  const Lanes L(C, V, threadIdx.x);
  const int b = blockIdx.y, tile = blockIdx.x;
  const int r0 = tile * R, r1 = min(HW, r0 + R);
  float* red = sh;  // [2][E-1][CVc*V]
  float* out = part + ((size_t)b * ntiles + tile) * 2 * C;
  const size_t base = (size_t)b * HW * C;
  const int cg = C / G;
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
    fold_rows<V>(red, out, L, a1, a2, vb, C);
  }
}

// Backward fold, one block per image: the tiles' channel sums in tile
// order -> dbeta, dgamma [B, C] and the group terms t1, t2 -> tg[B][2][G].
__global__ void __launch_bounds__(NT) bwd_fold_kernel(
    const float* __restrict__ part, const float* __restrict__ gamma,
    float* __restrict__ dgamma_b, float* __restrict__ dbeta_b,
    float* __restrict__ tg, int C, int G, int ntiles, float count) {
  extern __shared__ float sh[];
  float* db = sh;          // [C]
  float* dg = sh + C;      // [C]
  float* gs = sh + 2 * C;  // [2][G]
  const int b = blockIdx.x;
  const float* pb = part + (size_t)b * ntiles * 2 * C;
  for (int c = threadIdx.x; c < C; c += NT) {
    float s1 = 0.f, s2 = 0.f;
    for (int t = 0; t < ntiles; ++t) {
      s1 += pb[(size_t)t * 2 * C + c];
      s2 += pb[(size_t)t * 2 * C + C + c];
    }
    db[c] = s1;
    dg[c] = s2;
    dbeta_b[b * C + c] = s1;
    dgamma_b[b * C + c] = s2;
  }
  __syncthreads();
  group_sums(sh, gamma, gs, C, G);
  __syncthreads();
  for (int i = threadIdx.x; i < 2 * G; i += NT)
    tg[(size_t)b * 2 * G + i] = gs[i] / count;
}

// Backward pass 2: dx from the saved statistics and the folded group
// terms (2G values an image).
template <typename T, int V>
__global__ void __launch_bounds__(NT) bwd_apply_kernel(
    const T* __restrict__ x, const T* __restrict__ dy,
    const float* __restrict__ gamma, const float* __restrict__ beta,
    const float* __restrict__ mean, const float* __restrict__ inv,
    const float* __restrict__ tg, T* __restrict__ dx, int HW, int C, int G,
    int R, int relu) {
  const Lanes L(C, V, threadIdx.x);
  if (L.rl >= L.RP) return;
  const int b = blockIdx.y, tile = blockIdx.x, cg = C / G;
  const float* t1 = tg + (size_t)b * 2 * G;
  const float* t2 = t1 + G;
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
  return (int)sizeof(float) * (fold_floats(C, V) + 2 * C);
}

inline bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr int MAX_DEVICES = 64;

// Raises cluster kernel Kernel's dynamic shared-memory limit to SMEM_MAX
// on the current device, once per kernel, device and host thread (the
// flags are the thread's own), so that a launch makes no other host
// call than itself.
template <auto Kernel>
cudaError_t smem_ready() {
  thread_local bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool known = dev < MAX_DEVICES;
  if (known && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_MAX);
  if (e == cudaSuccess && known) done[dev] = true;
  return e;
}

// A cluster kernel's launch configuration: grid (k, S, B), clusters of
// k blocks along x, smem bytes of dynamic shared memory.
inline void cluster_config(int k, int S, int B, int smem, cudaStream_t s,
                           cudaLaunchConfig_t* cfg,
                           cudaLaunchAttribute* attr) {
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(k, S, B);
  cfg->blockDim = dim3(NT);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = k;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

// The one-pass route's shared memory per block for S channel splits of
// clusters of k, or -1 where the launch cannot take the shape: each
// split's channels a whole number of groups and of 16-byte vectors, at
// least 64 bytes of a row where the row is split, its rows held by k
// blocks.
inline long long one_pass_smem(int B, int HW, int C, int G, int R, int k,
                               int S, int item, int nin) {
  if (k < 1 || k > KMAX || S < 1 || C % S || G % S || R < 1 || B < 1 ||
      (long long)R * k < HW || (C / S) * item % 16 ||
      (S > 1 && (C / S) * item < 64))
    return -1;
  const long long s =
      cluster_smem(R, C / S, G / S, item, 16 / item, nin, k).total;
  return s <= SMEM_MAX ? s : -1;
}

template <typename T, int V>
int fwd(const void* x, const float* gamma, const float* beta, void* y,
        float* mean, float* inv, float* part, int B, int HW, int C, int G,
        int R, int k, int S, float count, float eps, int relu,
        cudaStream_t s) {
  if constexpr (V == 1) {
    if (k > 0) return (int)cudaErrorInvalidValue;
  } else if (k > 0) {
    const long long smem =
        one_pass_smem(B, HW, C, G, R, k, S, sizeof(T), 1);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = smem_ready<fwd_cluster_kernel<T, V>>();
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(k, S, B, (int)smem, s, &cfg, &attr);
    e = cudaLaunchKernelEx(&cfg, fwd_cluster_kernel<T, V>,
                           static_cast<const T*>(x), gamma, beta,
                           static_cast<T*>(y), mean, inv, HW, C, G, R, count,
                           eps, relu);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const int ntiles = (HW + R - 1) / R;
  dim3 grid(ntiles, B);
  fwd_stats_kernel<T, V><<<grid, NT, stats_smem(C, V), s>>>(
      static_cast<const T*>(x), part, HW, C, G, R, ntiles);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fwd_fold_kernel<<<B, NT, 0, s>>>(part, mean, inv, G, ntiles, count, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fwd_apply_kernel<T, V><<<grid, NT, sizeof(float) * 2 * C, s>>>(
      static_cast<const T*>(x), gamma, beta, mean, inv, static_cast<T*>(y),
      HW, C, G, R, relu);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int bwd(const void* x, const void* dy, const float* gamma,
        const float* beta, const float* mean, const float* inv, void* dx,
        float* dgamma_b, float* dbeta_b, float* part, int B, int HW, int C,
        int G, int R, int k, int S, float count, int relu, cudaStream_t s) {
  if constexpr (V == 1) {
    if (k > 0) return (int)cudaErrorInvalidValue;
  } else if (k > 0) {
    const long long smem =
        one_pass_smem(B, HW, C, G, R, k, S, sizeof(T), 2);
    if (smem < 0) return (int)cudaErrorInvalidValue;
    cudaError_t e = smem_ready<bwd_cluster_kernel<T, V>>();
    if (e != cudaSuccess) return (int)e;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cluster_config(k, S, B, (int)smem, s, &cfg, &attr);
    e = cudaLaunchKernelEx(&cfg, bwd_cluster_kernel<T, V>,
                           static_cast<const T*>(x),
                           static_cast<const T*>(dy), gamma, beta, mean, inv,
                           static_cast<T*>(dx), dgamma_b, dbeta_b, HW, C, G,
                           R, count, relu);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const int ntiles = (HW + R - 1) / R;
  dim3 grid(ntiles, B);
  float* tg = part + (size_t)B * ntiles * 2 * C;
  // the backward's pass 1 folds into part directly: only [2][E-1][CVc*V]
  const int smem1 = stats_smem(C, V) - (int)sizeof(float) * 2 * C;
  bwd_stats_kernel<T, V><<<grid, NT, smem1, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, beta,
      mean, inv, part, HW, C, G, R, ntiles, relu);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_fold_kernel<<<B, NT, sizeof(float) * 2 * (C + G), s>>>(
      part, gamma, dgamma_b, dbeta_b, tg, C, G, ntiles, count);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  bwd_apply_kernel<T, V><<<grid, NT, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy), gamma, beta,
      mean, inv, tg, static_cast<T*>(dx), HW, C, G, R, relu);
  return (int)cudaGetLastError();
}

// cudaOccupancyMaxActiveClusters of a one-pass launch.
template <auto Kernel>
int max_clusters(int k, int S, int B, long long smem, int* out) {
  cudaError_t e = smem_ready<Kernel>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(k, S, B, (int)smem, 0, &cfg, &attr);
  return (int)cudaOccupancyMaxActiveClusters(out, Kernel, &cfg);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  k > 0: the one-pass route, clusters of
// k blocks of R rows each (R * k >= HW) over S channel splits (each a
// whole number of groups; 16-byte vectors, so C / S a multiple of 16
// bytes and x, y aligned to 16); part unused.  k == 0: the two-pass
// route, R rows per tile, part a scratch of B * ceil(HW/R) * 2 * G
// floats; 16-byte vectors where C and every pointer allow, single
// elements otherwise.  Returns a cudaError_t.
extern "C" int group_norm_fwd(const void* x, const float* gamma,
                              const float* beta, void* y, float* mean,
                              float* inv, float* part, int B, int HW,
                              int C, int G, int R, int k, int S, float count,
                              float eps, int relu, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(x) && aligned(y);
  if (dtype == 0) {
    if (vec && C % Pack<float>::N == 0)
      return fwd<float, 4>(x, gamma, beta, y, mean, inv, part, B, HW, C, G,
                           R, k, S, count, eps, relu, s);
    return fwd<float, 1>(x, gamma, beta, y, mean, inv, part, B, HW, C, G,
                         R, k, S, count, eps, relu, s);
  }
  if (dtype == 1) {
    if (vec && C % Pack<__nv_bfloat16>::N == 0)
      return fwd<__nv_bfloat16, 8>(x, gamma, beta, y, mean, inv, part, B,
                                   HW, C, G, R, k, S, count, eps, relu, s);
    return fwd<__nv_bfloat16, 1>(x, gamma, beta, y, mean, inv, part, B, HW,
                                 C, G, R, k, S, count, eps, relu, s);
  }
  return -1;
}

// As the forward; the two-pass route's part: a scratch of
// B * ceil(HW/R) * 2 * C + B * 2 * G floats.
extern "C" int group_norm_bwd(const void* x, const void* dy,
                              const float* gamma, const float* beta,
                              const float* mean, const float* inv, void* dx,
                              float* dgamma_b, float* dbeta_b, float* part,
                              int B, int HW, int C, int G, int R, int k,
                              int S, float count, int relu, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = aligned(x) && aligned(dy) && aligned(dx);
  if (dtype == 0) {
    if (vec && C % Pack<float>::N == 0)
      return bwd<float, 4>(x, dy, gamma, beta, mean, inv, dx, dgamma_b,
                           dbeta_b, part, B, HW, C, G, R, k, S, count, relu,
                           s);
    return bwd<float, 1>(x, dy, gamma, beta, mean, inv, dx, dgamma_b,
                         dbeta_b, part, B, HW, C, G, R, k, S, count, relu,
                         s);
  }
  if (dtype == 1) {
    if (vec && C % Pack<__nv_bfloat16>::N == 0)
      return bwd<__nv_bfloat16, 8>(x, dy, gamma, beta, mean, inv, dx,
                                   dgamma_b, dbeta_b, part, B, HW, C, G, R,
                                   k, S, count, relu, s);
    return bwd<__nv_bfloat16, 1>(x, dy, gamma, beta, mean, inv, dx,
                                 dgamma_b, dbeta_b, part, B, HW, C, G, R,
                                 k, S, count, relu, s);
  }
  return -1;
}

// The one-pass route's dynamic shared memory per block for a call
// (backward: 0 forward, 1 backward), or -1 where it cannot take it.
extern "C" long long group_norm_smem(int backward, int dtype, int B, int HW,
                                     int C, int G, int R, int k, int S) {
  const int item = dtype == 0 ? 4 : 2;
  return one_pass_smem(B, HW, C, G, R, k, S, item, backward ? 2 : 1);
}

// cudaOccupancyMaxActiveClusters of the one-pass launch of a call: how
// many of its clusters the card can hold at once (0: none can be
// scheduled).  Returns a cudaError_t.
extern "C" int group_norm_max_clusters(int backward, int dtype, int B,
                                       int HW, int C, int G, int R, int k,
                                       int S, int* out) {
  const long long smem =
      group_norm_smem(backward, dtype, B, HW, C, G, R, k, S);
  if (smem < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return backward
               ? max_clusters<bwd_cluster_kernel<float, 4>>(k, S, B, smem, out)
               : max_clusters<fwd_cluster_kernel<float, 4>>(k, S, B, smem, out);
  return backward ? max_clusters<bwd_cluster_kernel<__nv_bfloat16, 8>>(
                        k, S, B, smem, out)
                  : max_clusters<fwd_cluster_kernel<__nv_bfloat16, 8>>(
                        k, S, B, smem, out);
}
