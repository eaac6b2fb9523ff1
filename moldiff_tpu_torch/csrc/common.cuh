// Shared device helpers of the kernels still on synchronous WMMA: the
// node-level prep kernels (node_block.cu, edge_pair.cu, pos_update.cu) and
// the node-level backward kernels. (The NodeBlock, EdgeBlock and PosUpdate
// pair kernels, forward and backward, and the whole-block and
// full-EdgeBlock kernels' own kernels run on wgmma: wgmma.cuh.)
//
// Every kernel here works on a tile of at most kMaxRows rows (pairs or
// nodes) held in shared memory, and runs a chain of small matrix products
// against weights that stay in global memory (they are small and live in
// L2). A product is done by all eight warps of the CTA with bf16 WMMA
// fragments (16x16x16, float32 accumulation); warp w owns the output
// column tiles w, w+8, ... and loads each weight fragment once for all row
// tiles. Row-wise epilogues (bias, LayerNorm, ReLU, gates) run one warp per
// row, each lane holding the columns lane, lane+32, ...
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <cstdint>

namespace md {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 64;          // rows of one tile
constexpr int kMaxRowTiles = kMaxRows / 16;
constexpr int kMaxWidth = 256;        // widest row an epilogue holds
constexpr int kMaxPerLane = kMaxWidth / 32;

enum GemmMode { kStore = 0, kAdd = 1, kMul = 2 };

__device__ __forceinline__ float bf(const bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ bf16 tobf(const float v) { return __float2bfloat16(v); }
// round a float32 value to bf16 and back: the value a bf16 tensor would hold
__device__ __forceinline__ float rbf(const float v) { return bf(tobf(v)); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float sigmoidf(const float x) { return 1.0f / (1.0f + expf(-x)); }

// C[16*mt x nout] (op)= A[16*mt x k] @ W[k x nout].
// A: bf16, shared memory, leading dimension lda (multiple of 8).
// W: bf16, row-major, global memory, 32-byte aligned, leading dimension nout.
// C: float32, shared memory, leading dimension ldc (multiple of 4).
// kStore writes the product, kAdd adds it to C, kMul multiplies C by it.
// k and nout are multiples of 16. Called by every thread of the CTA; the
// caller synchronises before reading C.
__device__ __forceinline__ void cta_gemm(const bf16* A, int lda, const bf16* W, int k,
                                         int nout, float* C, int ldc, int mt, GemmMode mode) {
  const int warp = threadIdx.x >> 5;
  for (int ct = warp; ct < nout / 16; ct += kWarps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kMaxRowTiles];
#pragma unroll
    for (int m = 0; m < kMaxRowTiles; ++m) wmma::fill_fragment(acc[m], 0.0f);
    for (int kk = 0; kk < k; kk += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag;
      wmma::load_matrix_sync(bfrag, W + (size_t)kk * nout + ct * 16, nout);
#pragma unroll
      for (int m = 0; m < kMaxRowTiles; ++m) {
        if (m < mt) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
          wmma::load_matrix_sync(afrag, A + (size_t)m * 16 * lda + kk, lda);
          wmma::mma_sync(acc[m], afrag, bfrag, acc[m]);
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kMaxRowTiles; ++m) {
      if (m < mt) {
        float* cp = C + (size_t)m * 16 * ldc + ct * 16;
        if (mode != kStore) {
          wmma::fragment<wmma::accumulator, 16, 16, 16, float> old;
          wmma::load_matrix_sync(old, cp, ldc, wmma::mem_row_major);
          for (int e = 0; e < old.num_elements; ++e)
            acc[m].x[e] = (mode == kAdd) ? old.x[e] + acc[m].x[e] : old.x[e] * acc[m].x[e];
        }
        wmma::store_matrix_sync(cp, acc[m], ldc, wmma::mem_row_major);
      }
    }
  }
}

// In-place LayerNorm of one row held by a warp: v[q] is column lane + 32q,
// width = 32 * nq. float32 statistics, two passes (mean, then the mean of
// squared deviations), as models/nn.py layernorm.
__device__ __forceinline__ void warp_layernorm(float* v, int nq, const bf16* scale,
                                               const bf16* bias, int lane) {
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
    if (q < nq) {
      const int c = lane + 32 * q;
      v[q] = (v[q] - mean) * inv * bf(scale[c]) + bf(bias[c]);
    }
}

// Copy `rows` rows of `width` bf16 values into shared memory (leading
// dimension ld) and zero the rows [rows, pad_rows). Row r starts at
// src(r), which must be 16-byte aligned; width is a multiple of 8.
template <typename RowPtr>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, int rows, int pad_rows, int width,
                                          RowPtr src) {
  const int chunks = width / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < pad_rows * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = idx % chunks;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) val = reinterpret_cast<const uint4*>(src(r))[c];
    *reinterpret_cast<uint4*>(dst + (size_t)r * ld + c * 8) = val;
  }
}

// Bytes of a shared-memory buffer, rounded up to 128 so that every buffer
// (and every WMMA tile in it) is aligned.
__host__ __device__ constexpr size_t smem_bytes(size_t rows, size_t ld, size_t elem) {
  return (rows * ld * elem + 127) / 128 * 128;
}

}  // namespace md
