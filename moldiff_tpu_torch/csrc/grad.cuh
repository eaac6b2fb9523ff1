// Shared pieces of the backward kernels (node_block_bwd.cu,
// edge_pair_bwd.cu, pos_update_bwd.cu, edge_block_full.cu): transposed-weight
// tile products, the float32 split into two bf16 halves, the LayerNorm
// backward of one row held by a warp, per-tile column sums (the node-level
// kernels and the EdgeBlock-tail kernels, on 32-row tiles; the redesigned
// pair kernels use wgmma.cuh), the
// weight-gradient operands' form, the host launchers of the
// weight-gradient, reduction and time kernels of grad.cu, and the host
// launchers that the full-EdgeBlock and whole-block entry points
// (edge_block_full.cu, fused_block.cu) share with the others.
//
// Parameter gradients are sums over every pair of the batch. A CTA of the
// pair kernels owns one tile of pairs and has no room for 256 x 256 float32
// accumulators, and the TPU's pattern (accumulating into one output block
// across a sequential grid) has no counterpart on a parallel grid. So the
// pair kernels write, per pair, the activations and cotangents that the
// weight gradients need, and a weight-gradient kernel computes each A^T B
// over all pairs in split-K slices, each slice into a slot of its own; a
// reduction kernel then adds the slots in a fixed order. Bias and
// LayerNorm gradients (column sums) are summed per tile the same way. No
// float atomics anywhere: every result is reproducible.
#pragma once

#include "common.cuh"

namespace md {

constexpr int kBwdRows = 32;            // pairs (or nodes) per backward tile
constexpr int kBwdRowTiles = kBwdRows / 16;

// C[16*mt x nout] (op)= (A (+ A2)) @ W^T, W row-major [nout x k] in global
// memory (the transpose of a weight used as x @ W). A, A2: bf16 in shared
// memory, leading dimension lda; A2 may be null (the low half of a split
// float32 operand). Called by every thread; the caller synchronises.
__device__ __forceinline__ void cta_gemm_t(const bf16* A, const bf16* A2, int lda,
                                           const bf16* W, int k, int nout, float* C, int ldc,
                                           int mt, GemmMode mode) {
  const int warp = threadIdx.x >> 5;
  for (int ct = warp; ct < nout / 16; ct += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kBwdRowTiles];
#pragma unroll
    for (int m = 0; m < kBwdRowTiles; ++m) wmma::fill_fragment(acc[m], 0.0f);
    for (int kk = 0; kk < k; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bfrag;
      wmma::load_matrix_sync(bfrag, W + (size_t)ct * 16 * k + kk, k);
#pragma unroll
      for (int m = 0; m < kBwdRowTiles; ++m) {
        if (m < mt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
          wmma::load_matrix_sync(afrag, A + (size_t)m * 16 * lda + kk, lda);
          wmma::mma_sync(acc[m], afrag, bfrag, acc[m]);
          if (A2 != nullptr) {
            wmma::load_matrix_sync(afrag, A2 + (size_t)m * 16 * lda + kk, lda);
            wmma::mma_sync(acc[m], afrag, bfrag, acc[m]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kBwdRowTiles; ++m) {
      if (m < mt) {
        float* cp = C + (size_t)m * 16 * ldc + ct * 16;
        if (mode == kAdd) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> old;
          wmma::load_matrix_sync(old, cp, ldc, wmma::mem_row_major);
          for (int e = 0; e < old.num_elements; ++e) acc[m].x[e] += old.x[e];
        }
        wmma::store_matrix_sync(cp, acc[m], ldc, wmma::mem_row_major);
      }
    }
  }
}

// Split float32 rows into bf16 hi = bf16(v) and lo = bf16(v - hi): hi + lo
// holds v to about 2^-16 of its size, so two bf16 tensor-core products
// stand in for one float32 product against a bf16 weight.
__device__ __forceinline__ void split_rows(const float* F, int ldf, bf16* hi, bf16* lo, int ldb,
                                           int rows, int width) {
  for (int idx = threadIdx.x; idx < rows * width; idx += blockDim.x) {
    const int r = idx / width, c = idx % width;
    const float v = F[r * ldf + c];
    const bf16 h = tobf(v);
    hi[r * ldb + c] = h;
    lo[r * ldb + c] = tobf(v - bf(h));
  }
}

// bf16 copy of float32 rows.
__device__ __forceinline__ void round_rows(const float* F, int ldf, bf16* out, int ldb, int rows,
                                           int width) {
  for (int idx = threadIdx.x; idx < rows * width; idx += blockDim.x) {
    const int r = idx / width, c = idx % width;
    out[r * ldb + c] = tobf(F[r * ldf + c]);
  }
}

// LayerNorm statistics of one row held by a warp (v[q] = column lane+32q):
// v becomes xhat = (v - mean) * inv; returns inv (pallas _ln_fwd_stats).
__device__ __forceinline__ float warp_ln_stats(float* v, int nq) {
  const float width = 32.0f * nq;
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxPerLane; ++q)
    if (q < nq) s += v[q];
  const float mean = warp_sum(s) / width;
  float s2 = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxPerLane; ++q)
    if (q < nq) {
      const float d = v[q] - mean;
      s2 += d * d;
    }
  const float inv = rsqrtf(warp_sum(s2) / width + 1e-5f);
#pragma unroll
  for (int q = 0; q < kMaxPerLane; ++q)
    if (q < nq) v[q] = (v[q] - mean) * inv;
  return inv;
}

// LayerNorm backward of one warp-held row (pallas _ln_bwd): dy[q] becomes
// d_h given xhat[q], inv and the LN scale.
__device__ __forceinline__ void warp_ln_bwd(float* dy, const float* xhat, float inv, int nq,
                                            const bf16* scale, int lane) {
  const float width = 32.0f * nq;
  float dxh[kMaxPerLane];
  float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
  for (int q = 0; q < kMaxPerLane; ++q)
    if (q < nq) {
      dxh[q] = dy[q] * bf(scale[lane + 32 * q]);
      s1 += dxh[q];
      s2 += dxh[q] * xhat[q];
    }
  const float m1 = warp_sum(s1) / width, m2 = warp_sum(s2) / width;
#pragma unroll
  for (int q = 0; q < kMaxPerLane; ++q)
    if (q < nq) dy[q] = inv * (dxh[q] - m1 - xhat[q] * m2);
}

// Column sums of a tile, deterministic: warp w holds in acc[v][q] its sum
// over rows w, w+8, ... of vector v at column lane+32q; the warps' sums go
// through shared memory (part: kWarps x nv x width floats) and are added
// in warp order, then written to out + v * stride. Called by every thread.
template <int NV>
__device__ __forceinline__ void flush_columns(const float (&acc)[NV][kMaxPerLane], int nq,
                                              float* part, float* out, int stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int width = 32 * nq;
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int q = 0; q < kMaxPerLane; ++q)
      if (q < nq) part[(warp * NV + v) * width + lane + 32 * q] = acc[v][q];
  __syncthreads();
  for (int idx = threadIdx.x; idx < NV * width; idx += blockDim.x) {
    const int v = idx / width, c = idx % width;
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += part[(w * NV + v) * width + c];
    out[(size_t)v * stride + c] = s;
  }
  __syncthreads();
}

// ---- grad.cu ---------------------------------------------------------------

constexpr int kMaxWgradJobs = 16;
constexpr int kMaxReduceJobs = 32;
constexpr int kMaxTimeJobs = 2;

// A float32 operand of the weight-gradient product, stored as two bf16
// planes of the same shape: hi = bf16(v), lo = bf16(v - hi). hi + lo holds
// v to about 2^-16 of its size.
struct Split {
  bf16* hi;
  bf16* lo;
};
__device__ __forceinline__ void put(const Split& s, size_t i, float v) {
  const bf16 h = tobf(v);
  s.hi[i] = h;
  s.lo[i] = tobf(v - bf(h));
}
// bf16 of two neighbouring values (p 4-byte aligned)
__device__ __forceinline__ void store2(bf16* p, float v0, float v1) {
  __nv_bfloat162 h;
  h.x = tobf(v0);
  h.y = tobf(v1);
  *reinterpret_cast<__nv_bfloat162*>(p) = h;
}

// slots[s] = A[rows of slice s]^T @ B[rows of slice s]  ([k1 x k2] float32)
// with A = a (+ a_lo) and B = b (+ b_lo): bf16 planes, row-major with row
// strides lda, ldb (elements, multiples of 8; rows 16-byte aligned). A
// plane pair is a float32 operand split (Split); a_lo, b_lo may be null.
// The product adds hi*hi + hi*lo (+ lo*hi for a split A): within ~2^-16 of
// float32. k1, k2: multiples of 32.
struct WgradJob {
  const bf16* a;
  const bf16* a_lo;
  const bf16* b;
  const bf16* b_lo;
  float* slots;
  int rows, k1, k2, lda, ldb;
};

// out[i] = sum_{s < S} src[s * stride + i], i < n, in a fixed order (eight
// runs of consecutive s, each in order, then the runs in order).
struct ReduceJob {
  const float* src;
  float* out;
  int S, n, stride;
};

// The time row of a gate's first layer, per molecule b: tot[c] = sum over
// its per_mol partials part[(b * per_mol + k) * stride + c] (c < n, k in
// order); d_t[b] gets tot . wt (bf16 row) summed over the jobs in order;
// dwpart[b * n + c] = t[b] * tot[c] (null: not formed), which a reduction
// job adds over molecules into the weight's gradient row.
struct TimeJob {
  const float* part;
  const bf16* wt;
  float* dwpart;
  int stride, per_mol, n;
};

// Split-K slices of a weight-gradient job over `rows` rows.
__host__ __device__ inline int wgrad_slices(int rows) {
  const int per = 512, most = 64;
  const int s = (rows + per - 1) / per;
  return s < 1 ? 1 : (s > most ? most : s);
}
// Floats of workspace the slots of a job need.
size_t wgrad_slot_floats(int rows, int k1, int k2);
cudaError_t launch_wgrad(const WgradJob* jobs, int njobs, cudaStream_t s);
cudaError_t launch_reduce(const ReduceJob* jobs, int njobs, cudaStream_t s);
// One CTA per molecule; d_t may be null (not formed).
cudaError_t launch_time(const TimeJob* jobs, int njobs, int B, const float* t, float* d_t,
                        cudaStream_t s);

// Carve 256-byte aligned buffers out of a workspace; with base == nullptr it
// only counts the bytes.
struct Carve {
  unsigned char* base;
  size_t off = 0;
  template <typename T>
  T* take(size_t count) {
    T* p = base ? reinterpret_cast<T*>(base + off) : nullptr;
    off += (count * sizeof(T) + 255) / 256 * 256;
    return p;
  }
  Split split(size_t count) {
    Split s;
    s.hi = take<bf16>(count);
    s.lo = take<bf16>(count);
    return s;
  }
};

// The node-level prep kernels of the forward entry points (node_block.cu,
// edge_pair.cu, pos_update.cu), which the backward entry points reuse.
cudaError_t node_block_prep(const void* const* weights, const bf16* x, const float* t,
                            bf16* xn, float* gpre, int B, int N, int Dn, int De, int H,
                            cudaStream_t s);
cudaError_t edge_pair_prep(const void* const* weights, const bf16* x, const float* t, float* np,
                           float* gpre, int B, int N, int Dn, int De, int I, int G, int Do,
                           cudaStream_t s);
// pos_update.cu: the two node MLPs L, R -> lr [2, B*N, Dl] (weights: the
// 6 left and 6 right MLP leaves).
cudaError_t pos_update_prep(const void* const* weights, const bf16* x, bf16* lr, int B, int N,
                            int Dn, int Dl, cudaStream_t s);

// Whether the NodeBlock and EdgeBlock pair kernels, forward and backward, are
// instantiated for these widths (else node_block_run / edge_pair_run and the
// backward entry points return cudaErrorInvalidValue before any launch).
bool node_block_built(int H, int De);
bool edge_pair_built(int De, int I, int G, int Do);
// Whether the PosUpdate pair kernels, forward and backward, are instantiated
// for these widths (else pos_update_run and the backward entry point return
// cudaErrorInvalidValue before any launch).
bool pos_update_built(int Dn, int De, int Dl, int I, int G);

// The three forward kernels whole (prep, then pair), each adding its
// launches to *launched; the flags select the whole-block kernel's
// roundings (fused_block.cu): node_block's sum as float32 into out32 (out
// unused), edge_pair's messages rounded to bf16 before their sums,
// pos_update's weight rounded to bf16 and the force as w * rel / d / (d + 1).
cudaError_t node_block_run(const void* const* weights, const bf16* x, const bf16* e,
                           const float* mask, const float* t, bf16* xn, float* gpre, bf16* out,
                           float* out32, int B, int N, int Dn, int De, int H, cudaStream_t s,
                           int* launched);
cudaError_t edge_pair_run(const void* const* weights, const bf16* e, const bf16* x,
                          const float* mask, const float* t, float* np, float* gpre, bf16* out,
                          int B, int N, int Dn, int De, int I, int G, int Do, int round_msg,
                          cudaStream_t s, int* launched);
cudaError_t pos_update_run(const void* const* weights, const bf16* x, const bf16* e,
                           const float* rel, const float* dist, const float* mask,
                           const float* t, bf16* lr, float* out, int B, int N, int Dn, int De,
                           int Dl, int I, int G, int fused, cudaStream_t s, int* launched);

// edge_pair_bwd.cu: the two chains' backward given the cotangents of their
// endpoint sums, bf16 (ct16) or float32 (ct32), with the prep's np and gpre
// already computed (np, gpre non-null: no prep launch) or not; dbond_add
// [B*N*N, De] and dnode_add [B*N, Dn] (float32, or null) are added to
// d_bond and d_node before they are rounded (edge_block_full.cu's tail).
struct EdgeChainBwd {
  const void* const* weights;   // 28: left, then right (BondFfn order)
  const bf16* e;
  const bf16* x;
  const float* mask;
  const float* t;
  const bf16* ct16[2];
  const float* ct32[2];
  const float* np;
  const float* gpre;
  const float* dbond_add;
  const float* dnode_add;
  bf16* d_bond;
  bf16* d_node;
  float* d_time;                // null: not formed
  float* d_mask;
  float* const* grads;          // 28 float32 outputs in the weights' order; null: not formed
  void* workspace;              // edge_chain_bwd_bytes
};
size_t edge_chain_bwd_bytes(int B, int N, int Dn, int De, int I, int G, int Do,
                            int need_params);
cudaError_t edge_chain_bwd(const EdgeChainBwd& c, int B, int N, int Dn, int De, int I, int G,
                           int Do, cudaStream_t s, int* launched);

// edge_block_full.cu: the EdgeBlock tail given the chains' sums tu [2, B*N,
// De] (t by row, u by column): proj [2, B*N, De] = the node FFNs of x,
// then per pair relu(LN(t[i] + u[j] + proj_l[i] + proj_r[j] + e @ Wsf + bsf))
// @ Wo + bo into out [B*N*N, De]; with residual, the four broadcast terms
// are added in bf16 and out = e + the delta (the whole-block kernel's
// tail). weights: the tail's 10 (node_ffn_left, node_ffn_right, self_ffn,
// ln, out).
cudaError_t edge_tail_forward(const void* const* weights, const bf16* e, const bf16* x,
                              const bf16* tu, bf16* proj, bf16* out, int residual, int B, int N,
                              int Dn, int De, cudaStream_t s, int* launched);

}  // namespace md
