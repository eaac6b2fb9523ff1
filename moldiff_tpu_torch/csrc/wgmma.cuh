// Hopper's warpgroup tensor-core products (wgmma) and asynchronous copies
// (cp.async, mbarrier), as the redesigned kernels use them (node_block.cu,
// edge_pair.cu, pos_update.cu, node_block_bwd.cu, edge_pair_bwd.cu,
// pos_update_bwd.cu, grad.cu, and the own kernels of edge_block_full.cu
// and fused_block.cu).
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


// CTAs of a persistent grid for kernel (256 threads, smem bytes of dynamic
// shared memory): the SMs times the CTAs one SM holds; 0 on an error.
template <typename Kernel>
int persistent_slots(Kernel kernel, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

// A cap on every persistent grid (0: none), set by md_set_persistent_slots
// (node_block.cu) so that a check can rerun the persistent kernels at other
// grid sizes: their sums are added in partner order whatever the tiles a
// CTA takes, so the outputs must not change.
int& persistent_cap();
// slots, or the cap where one is set and smaller
inline int capped(int slots) {
  const int cap = persistent_cap();
  return cap > 0 && cap < slots ? cap : slots;
}

// ---- the pair kernels' products: a CTA of two warpgroups on a 64-row tile ----

constexpr int kTileRows = 64;    // rows (pairs) of a tile: one wgmma M
constexpr int kSlice = 64;       // weight rows (K) staged per step
constexpr int kRingCols = 256;   // widest product output a ring buffer holds

// Stage rows [k0, k0 + ks) of W's K dimension, all nout columns, into buf.
// TRANS = 0: W is [K][nout] (x @ W) with rows ldw apart (0: nout; a column
// slice of a wider weight), buf the MN-major tile [ks][nout];
// TRANS = 1: W is [nout][K] (x @ W^T), buf the K-major tile [nout][ks].
// Eight consecutive threads fill the eight lines of one core matrix.
template <int TRANS>
__device__ __forceinline__ void stage_weight(bf16* buf, const bf16* W, int k0, int ks, int K,
                                             int nout, int ldw = 0) {
  const int chunks = ks * nout / 8;
  const size_t ld = ldw > 0 ? ldw : nout;
  for (int idx = threadIdx.x; idx < chunks; idx += blockDim.x) {
    const int line = idx & 7, rest = idx >> 3;
    if (TRANS == 0) {
      const int nc = nout >> 3;
      const int k = (rest / nc) * 8 + line, c = (rest % nc) * 8;
      cp16(buf + mnmaj(k, c, ks), W + (k0 + k) * ld + c, 16);
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
// while the tensor cores run on this one; ldw: see stage_weight. A2 (same
// layout, or null) is the low half of a split float32 operand. Called by
// all 256 threads; the caller's shared-memory writes before the call are
// visible to the product, and the ring is free again on return.
template <int NW, int TRANS>
__device__ __forceinline__ void cta_mma(float (&acc)[NW / 2], const bf16* A, int K, const bf16* W,
                                        bf16* ring, bool add, const bf16* A2 = nullptr,
                                        int ldw = 0) {
  const int nout = 2 * NW;
  const int g = threadIdx.x >> 7;
  const int nsl = (K + kSlice - 1) / kSlice;
  stage_weight<TRANS>(ring, W, 0, min(K, kSlice), K, nout, ldw);
  cp_commit();
  for (int s = 0; s < nsl; ++s) {
    const int k0 = s * kSlice, ks = min(K - k0, kSlice);
    const bf16* buf = ring + (s & 1) * (kSlice * kRingCols);
    if (s + 1 < nsl) {
      stage_weight<TRANS>(ring + ((s + 1) & 1) * (kSlice * kRingCols), W, k0 + kSlice,
                          min(K - k0 - kSlice, kSlice), K, nout, ldw);
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

// Copy the bf16 rows of a 64-row activation tile into shared memory in
// the K-major layout (kmaj, K columns) by cp.async, without committing:
// tile row r < nv comes from src(r) (16-byte aligned), the rest are zeros.
template <typename Src>
__device__ __forceinline__ void tile_in_async(bf16* dst, int K, int nv, Src src) {
  const int kc = K >> 3;
  for (int idx = threadIdx.x; idx < kTileRows * kc; idx += blockDim.x) {
    const int r = idx / kc, c = (idx % kc) * 8;
    const bf16* from = src(r < nv ? r : 0) + c;
    cp16(dst + kmaj(r, c, K), from, r < nv ? 16 : 0);
  }
}

// Stage a weight W whole into shared memory at dst as consecutive
// K-slices of kSlice rows, each the tile that cta_mma's ring holds (the
// layout res_mma reads): TRANS = 0, W [K][nout] (x @ W), MN-major slices;
// TRANS = 1, W [nout][K] (x @ W^T), K-major slices. ceil(K / kSlice)
// slices, K * nout values. Asynchronous: the caller commits the copies and
// waits for them (cp_commit, cp_wait) before the first product reads dst.
template <int TRANS = 0>
__device__ __forceinline__ void stage_resident(bf16* dst, const bf16* W, int K, int nout) {
  for (int k0 = 0; k0 < K; k0 += kSlice)
    stage_weight<TRANS>(dst + k0 * nout, W, k0, min(K - k0, kSlice), K, nout);
}

// acc (+)= A @ W (TRANS = 0) or A @ W^T (TRANS = 1) for this warpgroup's
// columns [n0 + g * NW, n0 + (g + 1) * NW) of W's nout columns (2 * NW by
// default), g = threadIdx.x / 128, with W resident in shared memory (Ws,
// stage_resident's layout, same TRANS) and A a bf16 K-major tile [64][K]
// (kmaj), K a multiple of 16; add = false overwrites acc. Called by all 256
// threads; the caller's shared-memory writes before the call are visible
// to the product, and A may be overwritten on return.
template <int NW, int TRANS = 0>
__device__ __forceinline__ void res_mma(float (&acc)[NW / 2], const bf16* A, int K,
                                        const bf16* Ws, bool add = false, int nout = 2 * NW,
                                        int n0 = 0) {
  const int g = threadIdx.x >> 7;
  const int n = n0 + g * NW;
  proxy_fence();
  __syncthreads();
  fence_acc(acc);
  fence();
  for (int k0 = 0; k0 < K; k0 += kSlice) {
    const int ks = min(K - k0, kSlice);
    const bf16* buf = Ws + k0 * nout;
    for (int kk = 0; kk < ks; kk += 16) {
      const uint64_t da = desc(A + kmaj(0, k0 + kk, K), 128, (K >> 3) * 128);
      const uint64_t db =
          desc(buf + (TRANS ? kmaj(n, kk, ks) : mnmaj(kk, n, ks)), 128, (ks >> 3) * 128);
      Mma<NW, 0, TRANS ? 0 : 1>::run(acc, da, db, (add || k0 > 0 || kk > 0) ? 1 : 0);
    }
  }
  commit();
  wait_all();
  fence_acc(acc);
  __syncthreads();
}

// Copy a bf16 tile [64][K] (kmaj layout, shared memory) to global rows:
// tile row r with valid(r) goes to dst + row(r) * ld (ld = 0: K; a column
// slice of wider rows). Eight consecutive threads read the eight lines of
// one core matrix and four of those groups write 64 contiguous bytes of a
// row. Called by all 256 threads after a barrier that follows the tile's
// writes.
template <typename Valid, typename Row>
__device__ __forceinline__ void tile_out(const bf16* X, int K, bf16* dst, Valid valid, Row row,
                                         int ld = 0) {
  const int kc = K >> 3;
  const size_t l = ld > 0 ? ld : K;
  for (int idx = threadIdx.x; idx < kTileRows * kc; idx += blockDim.x) {
    const int q = idx >> 3, r = (q / kc) * 8 + (idx & 7), c = (q % kc) * 8;
    if (valid(r))
      *reinterpret_cast<uint4*>(dst + (size_t)row(r) * l + c) =
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

// Column sums of V values at once over the tile's valid rows (r < nv):
// val(i, x) sets x[v] for accumulator element i; out(v)[c] receives value
// v's sum of column c < 2 * NW, added in col_sums' order. One pass, one
// pair of barriers for all V. part: 4 * V * 2 * NW floats of shared memory.
// Called by all 256 threads.
template <int NW, int V, typename Val, typename Out>
__device__ __forceinline__ void col_sums_tile(Val val, int nv, Out out, float* part) {
  const int g = threadIdx.x >> 7, w = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int nout = 2 * NW;
  const bool ok0 = acc_row(0) < nv, ok1 = acc_row(2) < nv;
#pragma unroll
  for (int j = 0; j < NW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0[V], x1[V], c[V];
      val(4 * j + e, x0);
      val(4 * j + 2 + e, x1);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        c[v] = (ok0 ? x0[v] : 0.0f) + (ok1 ? x1[v] : 0.0f);
        c[v] += __shfl_xor_sync(0xffffffffu, c[v], 4);
        c[v] += __shfl_xor_sync(0xffffffffu, c[v], 8);
        c[v] += __shfl_xor_sync(0xffffffffu, c[v], 16);
      }
      if (lane < 4)
#pragma unroll
        for (int v = 0; v < V; ++v) part[(w * V + v) * nout + g * NW + acc_col(4 * j + e)] = c[v];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < V * nout; idx += blockDim.x) {
    const int v = idx / nout, c = idx % nout;
    const float* p = part + v * nout + c;
    out(v)[c] = ((p[0] + p[V * nout]) + p[2 * V * nout]) + p[3 * V * nout];
  }
  __syncthreads();
}

// The pair kernels' forward tiles: rows rho = o * N + m of one chain, in
// output-major order (o the flattened output node b * N + k, whose sum
// runs over the partners m), cut into tiles of 64 rows. A CTA takes an
// even share of the output nodes, [o0, o1) with o0 = blockIdx.x * BN /
// gridDim.x, and walks its rows tile by tile; tile_range gives its rows
// [begin, end). A node's rows end in the tile where they began or in the
// next one (N <= 64), so its sum closes inside the CTA: tile_sums carries
// the open part from one tile to the next in shared memory (carry: one
// float per column), with no atomics.
struct TileRange {
  uint32_t begin, end;
};
__device__ __forceinline__ TileRange tile_range(uint32_t BN, uint32_t N) {
  const uint32_t o0 = (uint32_t)((uint64_t)blockIdx.x * BN / gridDim.x);
  const uint32_t o1 = (uint32_t)((uint64_t)(blockIdx.x + 1) * BN / gridDim.x);
  return {o0 * N, o1 * N};
}

// The sums over each output node's rows of one tile starting at row rho0
// with nv valid rows, column by column: V holds the tile's float32 values
// [64][ld] in shared memory (ld >= ncol), put there by tile_values; the
// rows of a node are added one by one in row (partner) order, from 0 or
// from the part carried over from the previous tile, as a single loop
// over the node's N rows would add them. write(node, c, sum) receives each
// node's total once it closes; one thread adds one (node, column). Called
// by all 256 threads after a barrier that follows tile_values, with ncol
// <= 256; returns after one, so V may be written again. The first
// segment's carried part is read into a register before a barrier, since
// another thread may write the last segment's carry[c] (ncol < 256).
template <typename Write>
__device__ __forceinline__ void tile_sums(const float* V, int ld, int ncol, uint32_t rho0,
                                          int nv, uint32_t N, float* carry, Write write) {
  const uint32_t node0 = rho0 / N;
  const int nseg = (int)((rho0 + nv - 1) / N - node0) + 1;
  // segment 0's column c is idx = c < ncol <= blockDim.x: thread c adds it
  const float carried =
      (rho0 % N != 0 && (int)threadIdx.x < ncol) ? carry[threadIdx.x] : 0.0f;
  __syncthreads();
  for (int idx = threadIdx.x; idx < nseg * ncol; idx += blockDim.x) {
    const int s = idx / ncol, c = idx % ncol;
    const uint32_t node = node0 + s;
    const int lo = s == 0 ? 0 : (int)(node * N - rho0);
    const int hi = min(nv, (int)((node + 1) * N - rho0));
    float v = s == 0 ? carried : 0.0f;
    for (int r = lo; r < hi; ++r) v += V[r * ld + c];
    if ((rho0 + hi) % N != 0)
      carry[c] = v;  // the node goes on in the next tile
    else
      write(node, c, v);
  }
  __syncthreads();
}

// The values val(i) of this thread's accumulator elements (the warpgroups
// splitting 2 * NW columns) into V [64][ld] float32, for tile_sums.
template <int NW, typename Val>
__device__ __forceinline__ void tile_values(float* V, int ld, Val val) {
  const int g = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < NW / 2; i += 2)
    *reinterpret_cast<float2*>(V + acc_row(i) * ld + g * NW + acc_col(i)) =
        make_float2(val(i), val(i + 1));
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

// What row_sums_seq adds per column: the value, its squared deviation, or
// a product.
enum SeqTerm { kSeqSum = 0, kSeqSq = 1, kSeqDot = 2 };

// The 64 accumulator row sums of f(i) (one value per element i of this
// thread's warpgroup, the warpgroups splitting 2 * NW columns) in
// md::warp_layernorm's order: for each lane l of a warp holding a row, the
// columns l, l + 32, l + 64, ... added one by one from 0, then the 32 lane
// sums in warp_sum's tree (xor 16, 8, 4, 2, 1). kSeqSq: the sum of squared
// deviations from m[row half] instead, each term added as fmaf(d, d, s)
// as the compiler contracts s += d * d; kSeqDot: f(i) is a float2 (x, w)
// and each term is added as fmaf(x, w, s), as the compiler contracts a
// warp's one-column layer s += x * w (md::warp_sum after it). out[h]: row
// acc_row(2 h)'s sum.
// A thread holds, for each of its rows, lanes l = 8 mm + 2 (t % 4) + e.
// For NW >= 32 warpgroup 0 holds the lower columns of every lane and adds
// first, and warpgroup 1 goes on from its sums and closes the tree; for
// NW = 16 each lane's one column lies in one warpgroup, and warpgroup 0
// closes the tree with warpgroup 1's lanes 16-31. The tree's levels 16, 8
// and 1 are a thread's own values, 4 and 2 its lane quad's. buf: 64 * 33
// floats, S: 64 floats of shared memory (S is read on return: the next
// call writes it only after a barrier). Called by all 256 threads; buf is
// free on return.
template <int NW, int TERM, typename F>
__device__ __forceinline__ void row_sums_seq(F f, const float (&m)[2], float (&out)[2],
                                             float* buf, float* S) {
  constexpr int NJ = NW / 8;                // column groups of 8 in a warpgroup
  constexpr int NM = NJ < 4 ? NJ : 4;       // lane groups of 8 a thread holds
  constexpr int CLOSER = NW >= 32 ? 1 : 0;  // the warpgroup that closes the tree
  const int g = threadIdx.x >> 7, ql = threadIdx.x & 3;
  const int row[2] = {acc_row(0), acc_row(2)};
  const int first = (g * NJ) & 3;  // the lane group of this warpgroup's first column group
  float p[2][4][2] = {};
  auto slot = [&](int h, int mm, int e) { return row[h] * 33 + 8 * mm + 2 * ql + e; };
  // p[h][jj][e]: lane group first + jj (jj < NM; first is 0 where NM = 4),
  // so that every index is known at compile time
  auto add = [&]() {  // this warpgroup's columns, in column order
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int mm = j & 3;
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if constexpr (TERM == kSeqDot) {
            const float2 xw = f(4 * j + 2 * h + e);
            p[h][mm][e] = fmaf(xw.x, xw.y, p[h][mm][e]);
          } else if constexpr (TERM == kSeqSq) {
            const float d = f(4 * j + 2 * h + e) - m[h];
            p[h][mm][e] = fmaf(d, d, p[h][mm][e]);
          } else {
            p[h][mm][e] += f(4 * j + 2 * h + e);
          }
        }
    }
  };
  if (g != CLOSER) {  // add this warpgroup's columns from 0 and hand the lane sums over
    add();
#pragma unroll
    for (int j = 0; j < NM; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) buf[slot(h, (first + j) & 3, e)] = p[h][j][e];
  }
  __syncthreads();
  if (g == CLOSER) {
    if (NW >= 32) {  // go on from warpgroup 0's lane sums: its columns come first
#pragma unroll
      for (int mm = 0; mm < 4; ++mm)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) p[h][mm][e] = buf[slot(h, mm, e)];
      add();
    } else {  // own lane groups 0, 1; warpgroup 1's 2, 3
      add();
#pragma unroll
      for (int mm = 2; mm < 4; ++mm)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) p[h][mm][e] = buf[slot(h, mm, e)];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float y[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float u0 = p[h][0][e] + p[h][2][e];  // xor 16
        const float u1 = p[h][1][e] + p[h][3][e];
        y[e] = u0 + u1;                                      // xor 8
        y[e] = y[e] + __shfl_xor_sync(0xffffffffu, y[e], 2);  // xor 4
        y[e] = y[e] + __shfl_xor_sync(0xffffffffu, y[e], 1);  // xor 2
      }
      if (ql == 0) S[row[h]] = y[0] + y[1];  // xor 1
    }
  }
  __syncthreads();
  out[0] = S[row[0]];
  out[1] = S[row[1]];
}

// LayerNorm statistics of the accumulator rows (width = 2 * NW columns over
// both warpgroups) in md::warp_layernorm's order (row_sums_seq), so that
// they equal that function's bit for bit: v becomes xhat = (v - mean) *
// inv, inv[h] is row h's 1 / std; two passes, float32. buf, S: see
// row_sums_seq.
template <int NA>
__device__ __forceinline__ void ln_stats_seq(float (&v)[NA], float (&inv)[2], float* buf,
                                             float* S) {
  constexpr int NW = 2 * NA;
  const float width = 2.0f * NW;
  const float zero[2] = {0.0f, 0.0f};
  float mean[2], sq[2];
  row_sums_seq<NW, kSeqSum>([&](int i) { return v[i]; }, zero, mean, buf, S);
  mean[0] /= width;
  mean[1] /= width;
  row_sums_seq<NW, kSeqSq>([&](int i) { return v[i]; }, mean, sq, buf, S);
#pragma unroll
  for (int h = 0; h < 2; ++h) inv[h] = rsqrtf(sq[h] / width + 1e-5f);
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
