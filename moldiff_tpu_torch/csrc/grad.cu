// Weight-gradient, reduction and time kernels shared by the backward
// entry points (see grad.cuh for why parameter gradients take this route).
//
// wgrad_kernel: one CTA per (job, output block, split-K slice); a block is
// all k1 rows (up to 256) by 128 columns (or 64, 32 for narrower outputs),
// so B is streamed once and A once per column block; each of its four
// warpgroups owns 64 rows of it (64 x 128 where k2 allows; warpgroups past
// k1 only copy). The pair kernels store every operand in
// the form the product takes (bf16 planes, a float32 cotangent as hi +
// lo), so the kernel only streams: 32-row chunks of A and B go by cp.async
// into a ring of kStages shared-memory stages, each guarded by a "full"
// mbarrier (the copies landed) and an "empty" one (the tensor cores are
// done with it); every thread copies a share of each chunk, kStages - 1
// chunks ahead, and the warpgroups multiply each chunk with wgmma (bf16 in,
// float32 accumulators in registers; both operands MN-major, read
// transposed). Each slice writes its own slot; reduce_kernel adds the
// slots in a fixed order. No float atomics: the result is the same from
// run to run.
//
// Bound: the bytes of the operands (4 bytes per element of a float32
// operand, 2 of a bf16 one); the products are far below the tensor cores'
// rate.
//
// time_kernel: one CTA per molecule forms d_t[b] and that molecule's share
// of the gate weight's time-row gradient; a reduction job adds the shares
// over molecules in order.
#include "grad.cuh"
#include "wgmma.cuh"

namespace {

using md::bf16;
namespace wg = md::wg;

constexpr int kChunk = 32;   // rows (K) per stage
constexpr int kStages = 4;
constexpr int kConsumers = 4;                 // warpgroups, 64 output rows each
constexpr int kM = 64 * kConsumers;           // output block rows (k1)
constexpr int kMaxN = 128;                    // output block columns (k2)
constexpr int kAElems = kChunk * kM;
constexpr int kBElems = kChunk * kMaxN;
constexpr int kStageElems = 2 * kAElems + 2 * kBElems;   // A hi, lo; B hi, lo
constexpr int kBarBytes = 128;
constexpr int kWgradThreads = 128 * kConsumers;
constexpr size_t kWgradSmem = kBarBytes + (size_t)kStages * kStageElems * sizeof(bf16);

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

struct TimeTable {
  md::TimeJob job[md::kMaxTimeJobs];
  int njobs;
};

__host__ __device__ inline int block_cols(int k2) { return k2 >= 128 ? 128 : (k2 > 32 ? 64 : 32); }

// rows per slice: the slice count of wgrad_slices, rounded to whole chunks
__host__ __device__ inline int slice_rows(int rows) {
  const int S = md::wgrad_slices(rows);
  const int per = (rows + S - 1) / S;
  return (per + kChunk - 1) / kChunk * kChunk;
}

// Copy rows [r0, r0 + kChunk) x columns [c0, c0 + cols) of a row-major
// bf16 plane into an MN-major stage tile [kChunk][cols]; rows past r_end
// and columns past width are zeros. Every thread of the CTA takes a share;
// eight consecutive threads fill the eight lines of one core matrix.
__device__ __forceinline__ void load_chunk(bf16* dst, const bf16* src, int ld, int r0, int r_end,
                                           int c0, int width, int cols) {
  const int nc = cols >> 3;
  for (int idx = threadIdx.x; idx < kChunk * nc; idx += blockDim.x) {
    const int line = idx & 7, rest = idx >> 3;
    const int k = (rest / nc) * 8 + line, c = (rest % nc) * 8;
    const int row = r0 + k, col = c0 + c;
    const bool ok = row < r_end && col < width;
    wg::cp16(dst + wg::mnmaj(k, c, kChunk), ok ? src + (size_t)row * ld + col : src, ok ? 16 : 0);
  }
}

// The CTA's slice, software-pipelined over 32-row chunks: every thread
// copies its share of chunk c into stage c % kStages once the tensor cores
// are done with that stage (its "empty" barrier), and the busy consumer
// warpgroups multiply chunk c - (kStages - 1) once it has landed (its
// "full" barrier). The stage holds columns [ma, ma + acols) of A and
// [n0, n0 + NT) of B; this warpgroup's part of the output block is rows
// [m0, m0 + 64) (column am of the stage's A tile), all NT columns.
template <int NT>
__device__ __forceinline__ void run_slice(const md::WgradJob& job, bf16* stages, uint64_t* full,
                                          uint64_t* empty, int r_begin, int r_end, int nchunks,
                                          int ma, int acols, int n0, bool busy, int m0, int am,
                                          float* slot) {
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.0f;
  const uint32_t sbo = (kChunk / 8) * 128;
  for (int c = 0; c < nchunks + kStages - 1; ++c) {
    if (c < nchunks) {
      const int st = c % kStages;
      wg::bar_wait(&empty[st], ((c / kStages) & 1) ^ 1);
      bf16* base = stages + (size_t)st * kStageElems;
      const int r0 = r_begin + c * kChunk;
      load_chunk(base, job.a, job.lda, r0, r_end, ma, job.k1, acols);
      if (job.a_lo != nullptr)
        load_chunk(base + kAElems, job.a_lo, job.lda, r0, r_end, ma, job.k1, acols);
      load_chunk(base + 2 * kAElems, job.b, job.ldb, r0, r_end, n0, job.k2, NT);
      if (job.b_lo != nullptr)
        load_chunk(base + 2 * kAElems + kBElems, job.b_lo, job.ldb, r0, r_end, n0, job.k2, NT);
      wg::bar_arrive_cp(&full[st]);
    }
    const int cc = c - (kStages - 1);
    if (!busy || cc < 0) continue;
    const int st = cc % kStages;
    wg::bar_wait(&full[st], (cc / kStages) & 1);
    const bf16* base = stages + (size_t)st * kStageElems;
    const bf16* ah = base;
    const bf16* al = base + kAElems;
    const bf16* bh = base + 2 * kAElems;
    const bf16* bl = bh + kBElems;
    wg::fence_acc(acc);
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kChunk; kk += 16) {
      const int ao = wg::mnmaj(kk, am, kChunk), bo = wg::mnmaj(kk, 0, kChunk);
      const uint64_t dah = wg::desc(ah + ao, 128, sbo), dbh = wg::desc(bh + bo, 128, sbo);
      wg::Mma<NT, 1, 1>::run(acc, dah, dbh, 1);
      if (job.b_lo != nullptr) wg::Mma<NT, 1, 1>::run(acc, dah, wg::desc(bl + bo, 128, sbo), 1);
      if (job.a_lo != nullptr) wg::Mma<NT, 1, 1>::run(acc, wg::desc(al + ao, 128, sbo), dbh, 1);
    }
    wg::commit();
    wg::wait_all();
    wg::fence_acc(acc);
    if ((threadIdx.x & 31) == 0) wg::bar_arrive(&empty[st]);
  }
  wg::cp_wait<0>();
  if (!busy) return;
#pragma unroll
  for (int i = 0; i < NT / 2; i += 2) {
    const int row = m0 + wg::acc_row(i), col = n0 + wg::acc_col(i);
    if (row < job.k1 && col < job.k2)
      *reinterpret_cast<float2*>(slot + (size_t)row * job.k2 + col) = make_float2(acc[i], acc[i + 1]);
  }
}

__global__ void __launch_bounds__(kWgradThreads) wgrad_kernel(const WgradTable tab) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  bf16* stages = reinterpret_cast<bf16*>(smem + kBarBytes);

  int j = 0;
  while (j + 1 < tab.njobs && (int)blockIdx.x >= tab.cta_begin[j + 1]) ++j;
  const md::WgradJob& job = tab.job[j];
  const int nt = block_cols(job.k2);
  const int tm = (job.k1 + kM - 1) / kM, tn = (job.k2 + nt - 1) / nt;
  const int local = blockIdx.x - tab.cta_begin[j];
  const int slice = local / (tm * tn), tile = local % (tm * tn);
  const int m0 = (tile / tn) * kM, n0 = (tile % tn) * nt;
  const int per = slice_rows(job.rows);
  const int r_begin = slice * per, r_end = min(job.rows, r_begin + per);
  const int nchunks = r_end > r_begin ? (r_end - r_begin + kChunk - 1) / kChunk : 0;
  const int wgs = min(kConsumers, (job.k1 - m0 + 63) / 64);  // warpgroups with rows

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      wg::bar_init(&full[s], blockDim.x);
      wg::bar_init(&empty[s], 4 * wgs);
    }
    wg::bar_init_fence();
  }
  __syncthreads();

  const int w = threadIdx.x >> 7;
  const bool busy = w < wgs;
  const int am = busy ? 64 * w : 0;
  float* slot = job.slots + (size_t)slice * job.k1 * job.k2;
  if (nt == 128)
    run_slice<128>(job, stages, full, empty, r_begin, r_end, nchunks, m0, 64 * wgs, n0, busy,
                   m0 + am, am, slot);
  else if (nt == 64)
    run_slice<64>(job, stages, full, empty, r_begin, r_end, nchunks, m0, 64 * wgs, n0, busy,
                  m0 + am, am, slot);
  else
    run_slice<32>(job, stages, full, empty, r_begin, r_end, nchunks, m0, 64 * wgs, n0, busy,
                  m0 + am, am, slot);
}

// One CTA of 256 threads per 32 outputs of a job: warp p adds the slots
// [p * S / 8, (p + 1) * S / 8) in order, then the eight parts are added in
// order; a fixed order, whatever S (up to B * N tiles for the column sums).
constexpr int kReduceCols = 32, kReduceParts = 8;

__global__ void __launch_bounds__(256) reduce_kernel(const ReduceTable tab) {
  __shared__ float part[kReduceParts][kReduceCols];
  int j = 0;
  while (j + 1 < tab.njobs && (int)blockIdx.x >= tab.block_begin[j + 1]) ++j;
  const md::ReduceJob& job = tab.job[j];
  const int c = threadIdx.x & 31, p = threadIdx.x >> 5;
  const int i = (blockIdx.x - tab.block_begin[j]) * kReduceCols + c;
  const int k0 = (int)((long long)job.S * p / kReduceParts);
  const int k1 = (int)((long long)job.S * (p + 1) / kReduceParts);
  float s = 0.0f;
  if (i < job.n) {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) s += job.src[(size_t)k * job.stride + i];
  }
  part[p][c] = s;
  __syncthreads();
  if (p == 0 && i < job.n) {
    float t = part[0][c];
    for (int q = 1; q < kReduceParts; ++q) t += part[q][c];
    job.out[i] = t;
  }
}

// One CTA of 256 threads per molecule; n <= 256.
__global__ void __launch_bounds__(256) time_kernel(const TimeTable tab, const float* t,
                                                   float* d_t) {
  __shared__ float red[256];
  const int b = blockIdx.x, c = threadIdx.x;
  float d = 0.0f;
  for (int j = 0; j < tab.njobs; ++j) {
    const md::TimeJob& job = tab.job[j];
    float tot = 0.0f;
    if (c < job.n)
      for (int k = 0; k < job.per_mol; ++k)
        tot += job.part[((size_t)b * job.per_mol + k) * job.stride + c];
    if (job.dwpart != nullptr && c < job.n) job.dwpart[(size_t)b * job.n + c] = t[b] * tot;
    if (d_t != nullptr) {
      red[c] = c < job.n ? tot * md::bf(job.wt[c]) : 0.0f;
      __syncthreads();
      for (int h = 128; h > 0; h >>= 1) {
        if (c < h) red[c] += red[c + h];
        __syncthreads();
      }
      d += red[0];
      __syncthreads();
    }
  }
  if (d_t != nullptr && c == 0) d_t[b] = d;
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
    const WgradJob& jb = jobs[j];
    if (jb.k1 % 32 || jb.k2 % 32 || jb.lda % 8 || jb.ldb % 8) return cudaErrorInvalidValue;
    tab.job[j] = jb;
    tab.cta_begin[j] = ctas;
    const int tm = (jb.k1 + kM - 1) / kM, tn = (jb.k2 + block_cols(jb.k2) - 1) / block_cols(jb.k2);
    ctas += tm * tn * wgrad_slices(jb.rows);
  }
  tab.cta_begin[njobs] = ctas;
  cudaError_t err = cudaFuncSetAttribute(wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(kWgradSmem));
  if (err != cudaSuccess) return err;
  wgrad_kernel<<<ctas, kWgradThreads, kWgradSmem, s>>>(tab);
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
    blocks += (jobs[j].n + kReduceCols - 1) / kReduceCols;
  }
  tab.block_begin[njobs] = blocks;
  reduce_kernel<<<blocks, 256, 0, s>>>(tab);
  return cudaGetLastError();
}

cudaError_t launch_time(const TimeJob* jobs, int njobs, int B, const float* t, float* d_t,
                        cudaStream_t s) {
  if (njobs > kMaxTimeJobs) return cudaErrorInvalidValue;
  TimeTable tab;
  tab.njobs = njobs;
  for (int j = 0; j < njobs; ++j) {
    if (jobs[j].n > 256) return cudaErrorInvalidValue;
    tab.job[j] = jobs[j];
  }
  time_kernel<<<B, 256, 0, s>>>(tab, t, d_t);
  return cudaGetLastError();
}

}  // namespace md
