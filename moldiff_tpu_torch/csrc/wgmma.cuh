// Hopper's warpgroup tensor-core products (wgmma) and asynchronous copies
// (cp.async, mbarrier), as the redesigned backward kernels use them
// (node_block_bwd.cu, edge_pair_bwd.cu, grad.cu).
//
// Shared-memory operands use wgmma's no-swizzle layout: a "core matrix" is
// 8 rows of 16 bytes (8 bf16), 128 contiguous bytes. A tile is a grid of
// core matrices; the descriptor gives the byte stride between core
// matrices adjacent along K (LBO) and along M or N (SBO). Every tile here
// puts the core matrices of one M/N group next to each other along K, so
// LBO = 128 and SBO = 128 * (K extent / 8). A K-major tile (an activation
// [rows][K], or a weight used as x @ W^T) holds 8 K-values of one row in a
// 16-byte line; an MN-major tile (a weight used as x @ W, or the per-pair
// operands of the weight-gradient product, both [K][MN] in memory) holds 8
// M/N-values of one K index in a line, and wgmma reads it transposed.
//
// An m64nNk16 accumulator of a warpgroup (128 threads): thread t, warp
// w = t / 32, lane l, holds d[4j + e] = D[16w + l/4 + 8(e >> 1)][8j + 2(l % 4) + (e & 1)]
// for j < N / 8, e < 4 (acc_row, acc_col).
#pragma once

#include "common.cuh"

namespace md {
namespace wg {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Descriptor of a no-swizzle operand starting at p (16-byte aligned).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  return d;
}

__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from moving accesses to accumulator registers across
// the asynchronous products (CUTLASS's warpgroup_fence_operand): called
// before the first wgmma of a batch and after its wait.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// Orders this thread's generic-proxy shared-memory writes (plain stores,
// cp.async) before wgmma's reads of them (the async proxy).
__device__ __forceinline__ void proxy_fence() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 16-byte asynchronous copy global -> shared; bytes < 16 fills the rest
// with zeros (0: a zero chunk, nothing read).
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarrier in shared memory
__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// The barrier's phase completes (for this thread's share) once this
// thread's earlier cp.async copies have landed; counts as one arrival.
__device__ __forceinline__ void bar_arrive_cp(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Element offsets inside a tile of core matrices (see above): K-major
// [rows][k] with K columns, MN-major [k][mn] with K rows.
__host__ __device__ __forceinline__ int kmaj(int r, int k, int K) {
  return (((r >> 3) * (K >> 3) + (k >> 3)) << 6) + ((r & 7) << 3) + (k & 7);
}
__host__ __device__ __forceinline__ int mnmaj(int k, int mn, int K) {
  return (((mn >> 3) * (K >> 3) + (k >> 3)) << 6) + ((k & 7) << 3) + (mn & 7);
}

__device__ __forceinline__ int acc_row(int i) {
  const int t = threadIdx.x & 127;
  return ((t >> 5) << 4) + ((t & 31) >> 2) + ((i >> 1) & 1) * 8;
}
__device__ __forceinline__ int acc_col(int i) {
  return ((i >> 2) << 3) + ((threadIdx.x & 3) << 1) + (i & 1);
}

// D[64 x N] (+)= A B with A and B given by descriptors. TA / TB = 1: the
// operand is MN-major. acc = 0 overwrites D.
template <int N, int TA, int TB>
struct Mma;

template <int TA, int TB>
struct Mma<16, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[8], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "%8, %9, p, 1, 1, %11, %12;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<32, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[16], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "%16, %17, p, 1, 1, %19, %20;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<64, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[32], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};

template <int TA, int TB>
struct Mma<128, TA, TB> {
  __device__ __forceinline__ static void run(float (&d)[64], uint64_t da, uint64_t db, int acc) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
          "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
          "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
          "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(da), "l"(db), "r"(acc), "n"(TA), "n"(TB));
  }
};


// ---- the pair kernels' products: a CTA of two warpgroups on a 64-row tile ----

constexpr int kTileRows = 64;    // rows (pairs) of a tile: one wgmma M
constexpr int kSlice = 64;       // weight rows (K) staged per step
constexpr int kRingCols = 256;   // widest product output a ring buffer holds

// Stage rows [k0, k0 + ks) of W's K dimension, all nout columns, into buf.
// TRANS = 0: W is [K][nout] (x @ W), buf the MN-major tile [ks][nout];
// TRANS = 1: W is [nout][K] (x @ W^T), buf the K-major tile [nout][ks].
// Eight consecutive threads fill the eight lines of one core matrix.
template <int TRANS>
__device__ __forceinline__ void stage_weight(bf16* buf, const bf16* W, int k0, int ks, int K,
                                             int nout) {
  const int chunks = ks * nout / 8;
  for (int idx = threadIdx.x; idx < chunks; idx += blockDim.x) {
    const int line = idx & 7, rest = idx >> 3;
    if (TRANS == 0) {
      const int nc = nout >> 3;
      const int k = (rest / nc) * 8 + line, c = (rest % nc) * 8;
      cp16(buf + mnmaj(k, c, ks), W + (size_t)(k0 + k) * nout + c, 16);
    } else {
      const int kc = ks >> 3;
      const int n = (rest / kc) * 8 + line, k = (rest % kc) * 8;
      cp16(buf + kmaj(n, k, ks), W + (size_t)n * K + k0 + k, 16);
    }
  }
}

// acc (+)= (A (+ A2)) @ W (TRANS = 0) or @ W^T (TRANS = 1) for this warpgroup's
// columns [g * NW, (g + 1) * NW) of nout = 2 * NW, g = threadIdx.x / 128.
// A: bf16 K-major tile [64][K] in shared memory (kmaj), K a multiple of 16;
// W: bf16 in global memory, staged K-slice by K-slice into the two ring
// buffers (kSlice x kRingCols each) by cp.async, the next slice in flight
// while the tensor cores run on this one. A2 (same layout, or null) is the
// low half of a split float32 operand. Called by all 256 threads; the
// caller's shared-memory writes before the call are visible to the
// product, and the ring is free again on return.
template <int NW, int TRANS>
__device__ __forceinline__ void cta_mma(float (&acc)[NW / 2], const bf16* A, int K, const bf16* W,
                                        bf16* ring, bool add, const bf16* A2 = nullptr) {
  const int nout = 2 * NW;
  const int g = threadIdx.x >> 7;
  const int nsl = (K + kSlice - 1) / kSlice;
  stage_weight<TRANS>(ring, W, 0, min(K, kSlice), K, nout);
  cp_commit();
  for (int s = 0; s < nsl; ++s) {
    const int k0 = s * kSlice, ks = min(K - k0, kSlice);
    const bf16* buf = ring + (s & 1) * (kSlice * kRingCols);
    if (s + 1 < nsl) {
      stage_weight<TRANS>(ring + ((s + 1) & 1) * (kSlice * kRingCols), W, k0 + kSlice,
                          min(K - k0 - kSlice, kSlice), K, nout);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    proxy_fence();
    __syncthreads();
    fence_acc(acc);
    fence();
    for (int kk = 0; kk < ks; kk += 16) {
      const uint64_t da = desc(A + kmaj(0, k0 + kk, K), 128, (K >> 3) * 128);
      const uint64_t db =
          desc(buf + (TRANS ? kmaj(g * NW, kk, ks) : mnmaj(kk, g * NW, ks)), 128, (ks >> 3) * 128);
      Mma<NW, 0, TRANS ? 0 : 1>::run(acc, da, db, (add || s > 0 || kk > 0) ? 1 : 0);
      if (A2 != nullptr)
        Mma<NW, 0, TRANS ? 0 : 1>::run(acc, desc(A2 + kmaj(0, k0 + kk, K), 128, (K >> 3) * 128), db,
                                       1);
    }
    commit();
    wait_all();
    fence_acc(acc);
    __syncthreads();
  }
}

// Copy a bf16 tile [64][K] (kmaj layout, shared memory) to global rows:
// tile row r with valid(r) goes to dst + row(r) * K. Eight consecutive
// threads read the eight lines of one core matrix and four of those groups
// write 64 contiguous bytes of a row. Called by all 256 threads after a
// barrier that follows the tile's writes.
template <typename Valid, typename Row>
__device__ __forceinline__ void tile_out(const bf16* X, int K, bf16* dst, Valid valid, Row row) {
  const int kc = K >> 3;
  for (int idx = threadIdx.x; idx < kTileRows * kc; idx += blockDim.x) {
    const int q = idx >> 3, r = (q / kc) * 8 + (idx & 7), c = (q % kc) * 8;
    if (valid(r))
      *reinterpret_cast<uint4*>(dst + (size_t)row(r) * K + c) =
          *reinterpret_cast<const uint4*>(X + kmaj(r, c, K));
  }
}

// Row sums over both warpgroups' columns: v[h][x] holds this thread's
// partial of value x for its row h (acc_row(2h)); on return the row's
// total, added in a fixed order (quad, then warpgroup 0 + warpgroup 1).
// red: 2 * 64 * V floats of shared memory. Called by all 256 threads.
template <int V>
__device__ __forceinline__ void row_sums(float (&v)[2][V], float* red) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int x = 0; x < V; ++x) {
      v[h][x] += __shfl_xor_sync(0xffffffffu, v[h][x], 1);
      v[h][x] += __shfl_xor_sync(0xffffffffu, v[h][x], 2);
    }
  const int g = threadIdx.x >> 7;
  if ((threadIdx.x & 3) == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int x = 0; x < V; ++x) red[(g * 64 + acc_row(2 * h)) * V + x] = v[h][x];
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int x = 0; x < V; ++x) {
      const int r = acc_row(2 * h);
      v[h][x] = red[r * V + x] + red[(64 + r) * V + x];
    }
  __syncthreads();
}

// Column sums of val(i) (one value per accumulator element i of this
// thread's warpgroup, NW columns each) over the rows of each segment: row r
// belongs to segment seg(r) (< 0: none); for s < nseg the sums of segment
// s go to out(s)[c], c < 2 * NW. Rows are added in a fixed order (lane
// shuffles, then the warpgroup's four warps in order). part: 4 * 2 * NW floats of shared memory. Called by all 256
// threads.
template <int NW, typename Val, typename Seg, typename Out>
__device__ __forceinline__ void col_sums(Val val, int nseg, Seg seg, Out out, float* part) {
  const int g = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int nout = 2 * NW;
  const int s0 = seg(acc_row(0)), s1 = seg(acc_row(2));
  for (int s = 0; s < nseg; ++s) {
    float* o = out(s);
#pragma unroll
    for (int j = 0; j < NW / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float c = (s0 == s ? val(4 * j + e) : 0.0f) + (s1 == s ? val(4 * j + 2 + e) : 0.0f);
        c += __shfl_xor_sync(0xffffffffu, c, 4);
        c += __shfl_xor_sync(0xffffffffu, c, 8);
        c += __shfl_xor_sync(0xffffffffu, c, 16);
        if (lane < 4) part[w * nout + g * NW + acc_col(4 * j + e)] = c;
      }
    __syncthreads();
    for (int c = threadIdx.x; c < nout; c += blockDim.x)
      o[c] = ((part[c] + part[nout + c]) + part[2 * nout + c]) + part[3 * nout + c];
    __syncthreads();
  }
}

// LayerNorm statistics of the accumulator rows (width columns over both
// warpgroups; pallas _ln_fwd_stats): v becomes xhat = (v - mean) * inv,
// inv[h] is row h's 1 / std. Two passes, float32. red: see row_sums.
template <int NA>
__device__ __forceinline__ void ln_stats(float (&v)[NA], float (&inv)[2], int width, float* red) {
  float s[2][1] = {};
#pragma unroll
  for (int i = 0; i < NA; ++i) s[(i >> 1) & 1][0] += v[i];
  row_sums<1>(s, red);
  const float mean[2] = {s[0][0] / width, s[1][0] / width};
  float q[2][1] = {};
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const float d = v[i] - mean[(i >> 1) & 1];
    q[(i >> 1) & 1][0] += d * d;
  }
  row_sums<1>(q, red);
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(q[h][0] / width + 1e-5f);
#pragma unroll
  for (int i = 0; i < NA; ++i) v[i] = (v[i] - mean[(i >> 1) & 1]) * inv[(i >> 1) & 1];
}

// LayerNorm backward of the accumulator rows (pallas _ln_bwd): dy becomes
// d_h given xhat, inv and the LN scale (bf16, indexed by column col(i)).
template <int NA, typename Col>
__device__ __forceinline__ void ln_bwd(float (&dy)[NA], const float (&xhat)[NA],
                                       const float (&inv)[2], const bf16* scale, Col col,
                                       int width, float* red) {
  float m[2][2] = {};
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    dy[i] *= bf(scale[col(i)]);
    m[(i >> 1) & 1][0] += dy[i];
    m[(i >> 1) & 1][1] += dy[i] * xhat[i];
  }
  row_sums<2>(m, red);
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int h = (i >> 1) & 1;
    dy[i] = inv[h] * (dy[i] - m[h][0] / width - xhat[i] * (m[h][1] / width));
  }
}

}  // namespace wg
}  // namespace md
