// Weight-gradient, reduction and time kernels shared by the backward
// entry points (see grad.cuh for why parameter gradients take this route).
//
// wgrad_kernel: one CTA per (job, 64x64 output block, split-K slice). It
// walks its slice's rows 32 at a time, stages A (bf16, or float32 split into
// hi + lo) and B (float32 split into hi + lo) in shared memory, and
// accumulates A^T B on tensor cores in float32 (hi*hi + hi*lo, plus lo*hi
// for a float32 A): within ~2^-16 of a float32 product. Each slice writes
// its own slot; reduce_kernel adds the slots in order.
#include "grad.cuh"

using namespace nvcuda;

namespace {

using md::bf16;

constexpr int kTile = 64;      // output block edge
constexpr int kChunk = 32;     // rows staged per step
constexpr int kLd = kTile + 8; // staged row length (bf16)

struct WgradTable {
  md::WgradJob job[md::kMaxWgradJobs];
  int cta_begin[md::kMaxWgradJobs + 1];
  int njobs;
};

struct ReduceTable {
  md::ReduceJob job[md::kMaxReduceJobs];
  int block_begin[md::kMaxReduceJobs + 1];
  int njobs;
};

__global__ void __launch_bounds__(md::kThreads) wgrad_kernel(const WgradTable tab) {
  __shared__ __align__(128) bf16 sAh[kChunk * kLd];
  __shared__ __align__(128) bf16 sAl[kChunk * kLd];
  __shared__ __align__(128) bf16 sBh[kChunk * kLd];
  __shared__ __align__(128) bf16 sBl[kChunk * kLd];
  int j = 0;
  while (j + 1 < tab.njobs && (int)blockIdx.x >= tab.cta_begin[j + 1]) ++j;
  const md::WgradJob& job = tab.job[j];
  const int tm = (job.k1 + kTile - 1) / kTile, tn = (job.k2 + kTile - 1) / kTile;
  const int local = blockIdx.x - tab.cta_begin[j];
  const int slice = local / (tm * tn), tile = local % (tm * tn);
  const int m0 = (tile / tn) * kTile, n0 = (tile % tn) * kTile;
  const int S = md::wgrad_slices(job.rows);
  const int per = (job.rows + S - 1) / S;
  const int r_begin = slice * per, r_end = min(job.rows, r_begin + per);
  const int warp = threadIdx.x >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int r0 = r_begin; r0 < r_end; r0 += kChunk) {
    for (int idx = threadIdx.x; idx < kChunk * kTile; idx += blockDim.x) {
      const int r = idx / kTile, c = idx % kTile;
      const int row = r0 + r;
      const bool ok = row < r_end;
      float a = 0.0f, b = 0.0f;
      if (ok && m0 + c < job.k1)
        a = job.a_f32 ? static_cast<const float*>(job.a)[(size_t)row * job.lda + m0 + c]
                      : md::bf(static_cast<const bf16*>(job.a)[(size_t)row * job.lda + m0 + c]);
      if (ok && n0 + c < job.k2) b = job.b[(size_t)row * job.ldb + n0 + c];
      const bf16 ah = md::tobf(a), bh = md::tobf(b);
      sAh[r * kLd + c] = ah;
      sAl[r * kLd + c] = md::tobf(a - md::bf(ah));
      sBh[r * kLd + c] = bh;
      sBl[r * kLd + c] = md::tobf(b - md::bf(bh));
    }
    __syncthreads();
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      const int frag = warp + f * md::kWarps;
      const int fm = frag / 4, fn = frag % 4;
      if (m0 + fm * 16 >= job.k1 || n0 + fn * 16 >= job.k2) continue;
      for (int kk = 0; kk < kChunk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> ah, al;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bh, bl;
        wmma::load_matrix_sync(ah, sAh + kk * kLd + fm * 16, kLd);
        wmma::load_matrix_sync(bh, sBh + kk * kLd + fn * 16, kLd);
        wmma::load_matrix_sync(bl, sBl + kk * kLd + fn * 16, kLd);
        wmma::mma_sync(acc[f], ah, bh, acc[f]);
        wmma::mma_sync(acc[f], ah, bl, acc[f]);
        if (job.a_f32) {
          wmma::load_matrix_sync(al, sAl + kk * kLd + fm * 16, kLd);
          wmma::mma_sync(acc[f], al, bh, acc[f]);
        }
      }
    }
    __syncthreads();
  }
  float* slot = job.slots + (size_t)slice * job.k1 * job.k2;
#pragma unroll
  for (int f = 0; f < 2; ++f) {
    const int frag = warp + f * md::kWarps;
    const int fm = frag / 4, fn = frag % 4;
    if (m0 + fm * 16 >= job.k1 || n0 + fn * 16 >= job.k2) continue;
    wmma::store_matrix_sync(slot + (size_t)(m0 + fm * 16) * job.k2 + n0 + fn * 16, acc[f],
                            job.k2, wmma::mem_row_major);
  }
}

__global__ void reduce_kernel(const ReduceTable tab) {
  int j = 0;
  while (j + 1 < tab.njobs && (int)blockIdx.x >= tab.block_begin[j + 1]) ++j;
  const md::ReduceJob& job = tab.job[j];
  const int i = (blockIdx.x - tab.block_begin[j]) * blockDim.x + threadIdx.x;
  if (i >= job.n) return;
  float s = 0.0f;
  for (int k = 0; k < job.S; ++k) s += job.src[(size_t)k * job.stride + i];
  job.out[i] = s;
}

// One CTA of 256 threads; n <= 256.
__global__ void __launch_bounds__(256) time_kernel(const float* part, int stride,
                                                   int tiles_per_mol, int n, int B,
                                                   const bf16* wt, const float* t, float* d_t,
                                                   float* dwt, int accumulate) {
  __shared__ float red[256];
  const int c = threadIdx.x;
  const float w = c < n ? md::bf(wt[c]) : 0.0f;
  float dw = 0.0f;
  for (int b = 0; b < B; ++b) {
    float tot = 0.0f;
    if (c < n)
      for (int k = 0; k < tiles_per_mol; ++k)
        tot += part[((size_t)b * tiles_per_mol + k) * stride + c];
    dw += t[b] * tot;
    red[c] = tot * w;
    __syncthreads();
    for (int h = 128; h > 0; h >>= 1) {
      if (c < h) red[c] += red[c + h];
      __syncthreads();
    }
    if (c == 0) d_t[b] = accumulate ? d_t[b] + red[0] : red[0];
    __syncthreads();
  }
  if (c < n) dwt[c] = dw;
}

}  // namespace

namespace md {

size_t wgrad_slot_floats(int rows, int k1, int k2) {
  return (size_t)wgrad_slices(rows) * k1 * k2;
}

cudaError_t launch_wgrad(const WgradJob* jobs, int njobs, cudaStream_t s) {
  if (njobs > kMaxWgradJobs) return cudaErrorInvalidValue;
  WgradTable tab;
  tab.njobs = njobs;
  int ctas = 0;
  for (int j = 0; j < njobs; ++j) {
    tab.job[j] = jobs[j];
    tab.cta_begin[j] = ctas;
    const int tm = (jobs[j].k1 + kTile - 1) / kTile, tn = (jobs[j].k2 + kTile - 1) / kTile;
    ctas += tm * tn * wgrad_slices(jobs[j].rows);
  }
  tab.cta_begin[njobs] = ctas;
  wgrad_kernel<<<ctas, kThreads, 0, s>>>(tab);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const ReduceJob* jobs, int njobs, cudaStream_t s) {
  if (njobs > kMaxReduceJobs) return cudaErrorInvalidValue;
  ReduceTable tab;
  tab.njobs = njobs;
  int blocks = 0;
  for (int j = 0; j < njobs; ++j) {
    tab.job[j] = jobs[j];
    tab.block_begin[j] = blocks;
    blocks += (jobs[j].n + 255) / 256;
  }
  tab.block_begin[njobs] = blocks;
  reduce_kernel<<<blocks, 256, 0, s>>>(tab);
  return cudaGetLastError();
}

cudaError_t launch_time(const float* part, int stride, int tiles_per_mol, int n, int B,
                        const bf16* wt, const float* t, float* d_t, float* dwt, int accumulate,
                        cudaStream_t s) {
  if (n > 256) return cudaErrorInvalidValue;
  time_kernel<<<1, 256, 0, s>>>(part, stride, tiles_per_mol, n, B, wt, t, d_t, dwt, accumulate);
  return cudaGetLastError();
}

}  // namespace md
