// The whole EdgeBlock, forward and backward, for Hopper (sm_90a).
//
// Replaces moldiff_tpu/ops/pallas_kernels.py:_edge_block_full_kernel
// (launched by _pallas_edge_block_full) and _edge_block_full_bwd_kernel
// (launched by _pallas_edge_block_full_bwd, the VJP _ebf_bwd). The forward:
//   t[j], u[i] = the two gated BondFFN chains' endpoint sums (edge_pair.cu)
//   proj_l, proj_r = x @ Wnl + bnl, x @ Wnr + bnr          (bf16, per node)
//   h   = t[i] + u[j] + proj_l[i] + proj_r[j] + e @ Wsf + bsf  (float32 adds)
//   out = relu(LN(h)) @ Wo + bo                              (bf16 delta)
// The backward recomputes the forward, runs the tail's backward to d_h per
// pair, sums d_h over columns (the cotangent of t[i] and proj_l[i]) and over
// rows (of u[j] and proj_r[j]), and hands those float32 sums to the chains'
// backward of edge_pair_bwd.cu as their cotangents, with the tail's terms of
// d_bond (d_h @ Wsf^T) and d_node (the node FFNs' input gradients) added
// before they are rounded; parameter gradients of the tail (self_ffn and
// out over pairs, the node FFNs over nodes, LN scale and bias) go through
// grad.cu as the chains' do.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), De = 64,
// Dn = 256, I = 128, G = 32: the chains' products (edge_pair.cu) plus
// 16,384 FLOPs per pair and 65,536 per node for the tail, about 10 % more
// than edge_pair.cu; the backward about three times that (the recompute,
// the input-gradient and the weight-gradient products). Both bound by
// operations; chip_smoke.py work() counts them for a call.
//
// Design. The tail needs both chains' sums for every pair, and those sums
// cross the forward's tiles (a column's sum over rows, a row's over
// columns), so the simple design is a sequence of launches over global
// memory (the intermediates per molecule stay in L2 at these sizes):
// forward = edge_pair.cu's prep and pair kernels, a node kernel for proj_l
// and proj_r, and a pair kernel of 64 flat pairs per CTA for the tail (4
// launches). Backward = the same prep and pair kernels, the proj kernel, a
// tail backward pair kernel (32 pairs per CTA) that writes d_h, the relu
// output and the self term of d_bond per pair, a node kernel that forms
// both sums of d_h in order and the node FFNs' d_node, the chains' backward
// (6 launches, no prep) and the tail's weight gradients and reductions
// (2): 13 launches. The tail's weight-gradient operands are stored in the
// form grad.cu's product takes (bf16; float32 ones also as hi + lo planes). Every element has one writer; no float atomics.
// Outputs go to fresh buffers.
#include "grad.cuh"

using md::bf16;

namespace {

constexpr int kTailVecs = 4;  // per-tile column sums: out bias, LN scale, LN bias, self bias

struct TailWeights {
  // node_ffn_left, node_ffn_right: Linear(Dn,De); self_ffn: Linear(De,De);
  // ln: LN(De); out: Linear(De,De)
  const bf16 *wnl, *bnl, *wnr, *bnr, *wsf, *bsf, *sle, *cle, *wo, *bo;
};

struct TailArgs {
  TailWeights w;
  const bf16* e;       // [B,N,N,De]
  const bf16* x;       // [B,N,Dn]
  const bf16* tu;      // [2,B,N,De]: t by row i, u by column j
  bf16* proj;          // [2,B,N,De]
  bf16* out;           // [B,N,N,De]
  int residual;        // 1: bf16 adds of the broadcast terms, out = e + delta
  // backward
  const bf16* ct;      // [B,N,N,De] cotangent of the delta
  bf16* dct;           // [B,N,N,De] ct, the out weight's gradient operand
  bf16* r;             // [B,N,N,De] relu output
  float* dh;           // [B,N,N,De] cotangent of h
  md::Split dhs;       // the same as the self_ffn weight's gradient operand
  float* dbond;        // [B,N,N,De] d_h @ Wsf^T
  float* vecpart;      // [pair tiles, kTailVecs, De]
  float* dproj;        // [2,B,N,De] d_h summed over columns (0) and rows (1)
  md::Split dprojs;    // the same as the node FFNs' gradient operand
  float* dnode;        // [B,N,Dn] the node FFNs' d_node
  float* nodepart;     // [node tiles, 2, De] column sums of dproj
  int B, N, Dn, De;
};

// One CTA per (64 nodes, side): proj[side] = bf16(x @ Wn + bn).
__global__ void __launch_bounds__(md::kThreads) tail_prep_kernel(const TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = a.Dn + 8, ldc = a.De + 4;
  bf16* sX = reinterpret_cast<bf16*>(smem);
  float* sC = reinterpret_cast<float*>(smem + md::smem_bytes(md::kMaxRows, ldx, 2));
  const int side = blockIdx.y;
  const bf16* wn = side == 0 ? a.w.wnl : a.w.wnr;
  const bf16* bn = side == 0 ? a.w.bnl : a.w.bnr;
  const int total = a.B * a.N;
  const int row0 = blockIdx.x * md::kMaxRows;
  const int rows = min(md::kMaxRows, total - row0);
  const int mt = (rows + 15) / 16;
  bf16* proj = a.proj + (size_t)side * total * a.De;

  md::load_rows(sX, ldx, rows, mt * 16, a.Dn,
                [&](int r) { return a.x + (size_t)(row0 + r) * a.Dn; });
  __syncthreads();
  md::cta_gemm(sX, ldx, wn, a.Dn, a.De, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * a.De; idx += blockDim.x) {
    const int r = idx / a.De, c = idx % a.De;
    proj[(size_t)(row0 + r) * a.De + c] = md::tobf(sC[r * ldc + c] + md::bf(bn[c]));
  }
}

// h of pair p, column c (sC holding e @ Wsf without its bias): the tail's
// sum of the four broadcast terms and the self term.
__device__ __forceinline__ float tail_input(const TailArgs& a, size_t p, int c, float self) {
  const size_t BN = (size_t)a.B * a.N, NN = (size_t)a.N * a.N;
  const size_t b = p / NN, i = (p / a.N) % a.N, j = p % a.N;
  const size_t ni = (b * a.N + i) * a.De + c, nj = (b * a.N + j) * a.De + c;
  const float t = md::bf(a.tu[ni]), u = md::bf(a.tu[BN * a.De + nj]);
  const float pl = md::bf(a.proj[ni]), pr = md::bf(a.proj[BN * a.De + nj]);
  const float selfe = self + md::bf(a.w.bsf[c]);
  if (a.residual) return md::rbf(md::rbf(md::rbf(t + u) + pl) + pr) + selfe;
  return t + u + pl + pr + selfe;
}

// One CTA per 64 flat pairs: the tail, then (residual) e + delta.
__global__ void __launch_bounds__(md::kThreads) tail_fwd_kernel(const TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int De = a.De, lde = De + 8, ldc = De + 4;
  bf16* sE = reinterpret_cast<bf16*>(smem);
  bf16* sAct = reinterpret_cast<bf16*>(smem + md::smem_bytes(md::kMaxRows, lde, 2));
  float* sC = reinterpret_cast<float*>(smem + 2 * md::smem_bytes(md::kMaxRows, lde, 2));
  const size_t P = (size_t)a.B * a.N * a.N;
  const size_t p0 = (size_t)blockIdx.x * md::kMaxRows;
  const int rows = P - p0 < (size_t)md::kMaxRows ? (int)(P - p0) : md::kMaxRows;
  const int mt = (rows + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = De / 32;

  md::load_rows(sE, lde, rows, mt * 16, De, [&](int r) { return a.e + (p0 + r) * De; });
  __syncthreads();
  md::cta_gemm(sE, lde, a.w.wsf, De, De, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int r = warp; r < mt * 16; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) {
        const int c = lane + 32 * q;
        v[q] = r < rows ? tail_input(a, p0 + r, c, sC[r * ldc + c]) : 0.0f;
      }
    md::warp_layernorm(v, nq, a.w.sle, a.w.cle, lane);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) sAct[r * lde + lane + 32 * q] = md::tobf(r < rows ? fmaxf(v[q], 0.0f) : 0.0f);
  }
  __syncthreads();
  md::cta_gemm(sAct, lde, a.w.wo, De, De, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * De; idx += blockDim.x) {
    const int r = idx / De, c = idx % De;
    const float delta = md::rbf(sC[r * ldc + c] + md::bf(a.w.bo[c]));
    a.out[(p0 + r) * De + c] = md::tobf(a.residual ? md::bf(sE[r * lde + c]) + delta : delta);
  }
}

// One CTA per 32 flat pairs: the tail's forward recompute and backward to
// d_h; writes r, ct (float32), d_h and d_h @ Wsf^T per pair and the tile's
// column sums.
__global__ void __launch_bounds__(md::kThreads) tail_bwd_pair_kernel(const TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int De = a.De, ldb = De + 8, ldf = De + 4;
  size_t off = 0;
  bf16* X[3];
  for (int k = 0; k < 3; ++k) {
    X[k] = reinterpret_cast<bf16*>(smem + off);
    off += md::smem_bytes(md::kBwdRows, ldb, 2);
  }
  float* F[3];
  for (int k = 0; k < 3; ++k) {
    F[k] = reinterpret_cast<float*>(smem + off);
    off += md::smem_bytes(md::kBwdRows, ldf, 4);
  }
  float* sInv = reinterpret_cast<float*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, 1, 4);
  float* sPart = reinterpret_cast<float*>(smem + off);

  const size_t P = (size_t)a.B * a.N * a.N;
  const size_t p0 = (size_t)blockIdx.x * md::kBwdRows;
  const int ri = P - p0 < (size_t)md::kBwdRows ? (int)(P - p0) : md::kBwdRows;
  const int mt = (ri + 15) / 16, rp = mt * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = De / 32;
  bf16* sE = X[0];
  bf16* sCt = X[1];

  md::load_rows(sE, ldb, ri, rp, De, [&](int r) { return a.e + (p0 + r) * De; });
  md::load_rows(sCt, ldb, ri, rp, De, [&](int r) { return a.ct + (p0 + r) * De; });
  __syncthreads();
  md::cta_gemm(sE, ldb, a.w.wsf, De, De, F[0], ldf, mt, md::kStore);    // e @ Wsf
  md::cta_gemm_t(sCt, nullptr, ldb, a.w.wo, De, De, F[2], ldf, mt, md::kStore);  // d_r
  __syncthreads();
  // forward recompute: F0 <- xhat, F1 <- LN output, X2 <- relu output
  for (int r = warp; r < rp; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) {
        const int c = lane + 32 * q;
        v[q] = r < ri ? tail_input(a, p0 + r, c, F[0][r * ldf + c]) : 0.0f;
      }
    const float inv = md::warp_ln_stats(v, nq);
    if (lane == 0) sInv[r] = inv;
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) {
        const int c = lane + 32 * q;
        const float ln = v[q] * md::bf(a.w.sle[c]) + md::bf(a.w.cle[c]);
        const bf16 h = md::tobf(fmaxf(ln, 0.0f));
        F[0][r * ldf + c] = v[q];
        F[1][r * ldf + c] = ln;
        X[2][r * ldb + c] = h;
        if (r < ri) {
          const size_t o = (p0 + r) * De + c;
          a.r[o] = h;
          a.dct[o] = sCt[r * ldb + c];
        }
      }
  }
  __syncthreads();
  // LN and relu backward; column sums of ct, d_ln * xhat, d_ln, d_h
  {
    float acc[kTailVecs][md::kMaxPerLane] = {};
    for (int r = warp; r < rp; r += md::kWarps) {
      float xh[md::kMaxPerLane], dy[md::kMaxPerLane];
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          xh[q] = F[0][r * ldf + c];
          dy[q] = F[1][r * ldf + c] > 0.0f ? F[2][r * ldf + c] : 0.0f;
          acc[0][q] += md::bf(sCt[r * ldb + c]);
          acc[1][q] += dy[q] * xh[q];
          acc[2][q] += dy[q];
        }
      md::warp_ln_bwd(dy, xh, sInv[r], nq, a.w.sle, lane);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          const float d = r < ri ? dy[q] : 0.0f;
          acc[3][q] += d;
          X[2][r * ldb + c] = md::tobf(d);
          if (r < ri) {
            a.dh[(p0 + r) * De + c] = d;
            md::put(a.dhs, (p0 + r) * De + c, d);
          }
        }
    }
    md::flush_columns<kTailVecs>(acc, nq, sPart, a.vecpart + (size_t)blockIdx.x * kTailVecs * De,
                                 De);
  }
  md::cta_gemm_t(X[2], nullptr, ldb, a.w.wsf, De, De, F[2], ldf, mt, md::kStore);  // d_e self
  __syncthreads();
  for (int idx = threadIdx.x; idx < ri * De; idx += blockDim.x) {
    const int r = idx / De, c = idx % De;
    a.dbond[(p0 + r) * De + c] = F[2][r * ldf + c];
  }
}

// One CTA per 32 nodes: d_h summed over columns (row k) and over rows
// (column k), in order; the node FFNs' d_node; the tile's column sums.
__global__ void __launch_bounds__(md::kThreads) tail_bwd_node_kernel(const TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int De = a.De, Dn = a.Dn, N = a.N, ldb = De + 8, ldf = Dn + 4;
  bf16* X0 = reinterpret_cast<bf16*>(smem);
  bf16* X1 = reinterpret_cast<bf16*>(smem + md::smem_bytes(md::kBwdRows, ldb, 2));
  float* F0 = reinterpret_cast<float*>(smem + 2 * md::smem_bytes(md::kBwdRows, ldb, 2));
  const int total = a.B * N;
  const int n0 = blockIdx.x * md::kBwdRows;
  const int rows = min(md::kBwdRows, total - n0);
  const int mt = (rows + 15) / 16, rp = mt * 16;
  for (int idx = threadIdx.x; idx < rp * De; idx += blockDim.x) {
    const int r = idx / De, c = idx % De;
    float sl = 0.0f, sr = 0.0f;
    if (r < rows) {
      const size_t node = n0 + r, b = node / N, k = node % N;
      const float* row = a.dh + (node * N) * De + c;          // pairs (k, j)
      const float* col = a.dh + (b * N * N + k) * De + c;     // pairs (i, k)
      for (int m = 0; m < N; ++m) {
        sl += row[(size_t)m * De];
        sr += col[(size_t)m * N * De];
      }
      a.dproj[node * De + c] = sl;
      a.dproj[((size_t)total + node) * De + c] = sr;
      md::put(a.dprojs, node * De + c, sl);
      md::put(a.dprojs, ((size_t)total + node) * De + c, sr);
    }
    X0[r * ldb + c] = md::tobf(sl);
    X1[r * ldb + c] = md::tobf(sr);
  }
  __syncthreads();
  md::cta_gemm_t(X0, nullptr, ldb, a.w.wnl, De, Dn, F0, ldf, mt, md::kStore);
  __syncthreads();
  md::cta_gemm_t(X1, nullptr, ldb, a.w.wnr, De, Dn, F0, ldf, mt, md::kAdd);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * Dn; idx += blockDim.x) {
    const int r = idx / Dn, c = idx % Dn;
    a.dnode[(size_t)(n0 + r) * Dn + c] = F0[r * ldf + c];
  }
  for (int idx = threadIdx.x; idx < 2 * De; idx += blockDim.x) {
    const int side = idx / De, c = idx % De;
    float s = 0.0f;
    for (int r = 0; r < rows; ++r) s += a.dproj[((size_t)side * total + n0 + r) * De + c];
    a.nodepart[((size_t)blockIdx.x * 2 + side) * De + c] = s;
  }
}

void set_tail_weights(TailArgs& a, const void* const* w) {
  const bf16** dst = &a.w.wnl;
  for (int k = 0; k < 10; ++k) dst[k] = static_cast<const bf16*>(w[k]);
}

cudaError_t launch_tail_prep(const TailArgs& a, cudaStream_t s) {
  const size_t smem = md::smem_bytes(md::kMaxRows, a.Dn + 8, 2) +
                      md::smem_bytes(md::kMaxRows, a.De + 4, 4);
  cudaError_t err = cudaFuncSetAttribute(tail_prep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((a.B * a.N + md::kMaxRows - 1) / md::kMaxRows, 2);
  tail_prep_kernel<<<grid, md::kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

struct FullBwdWork {
  float* np;
  float* gpre;
  bf16* tu;
  bf16* proj;
  bf16* dct;
  bf16* r;
  float* dh;
  md::Split dhs;
  float* dbond;
  float* vecpart;
  float* dproj;
  md::Split dprojs;
  float* dnode;
  float* nodepart;
  float* slots[4];
  void* chain;
  size_t bytes;
};

// The tail's weight-gradient jobs: out (r^T ct), self_ffn (e^T d_h), the
// node FFNs (x^T dproj), each [k1 x k2] over `rows` rows.
struct TailJob {
  int rows, k1, k2;
};

void tail_jobs(int B, int N, int Dn, int De, TailJob (&j)[4]) {
  const int P = B * N * N, BN = B * N;
  j[0] = {P, De, De};
  j[1] = {P, De, De};
  j[2] = {BN, Dn, De};
  j[3] = {BN, Dn, De};
}

FullBwdWork carve_full(unsigned char* base, int B, int N, int Dn, int De, int I, int G) {
  md::Carve cv{base};
  const size_t P = (size_t)B * N * N, BN = (size_t)B * N;
  const size_t tiles = (P + md::kBwdRows - 1) / md::kBwdRows;
  const size_t ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  FullBwdWork w;
  w.np = cv.take<float>(2 * BN * I);
  w.gpre = cv.take<float>(2 * BN * G);
  w.tu = cv.take<bf16>(2 * BN * De);
  w.proj = cv.take<bf16>(2 * BN * De);
  w.dct = cv.take<bf16>(P * De);
  w.r = cv.take<bf16>(P * De);
  w.dh = cv.take<float>(P * De);
  w.dhs = cv.split(P * De);
  w.dbond = cv.take<float>(P * De);
  w.vecpart = cv.take<float>(tiles * kTailVecs * De);
  w.dproj = cv.take<float>(2 * BN * De);
  w.dprojs = cv.split(2 * BN * De);
  w.dnode = cv.take<float>(BN * Dn);
  w.nodepart = cv.take<float>(ntiles * 2 * De);
  TailJob jobs[4];
  tail_jobs(B, N, Dn, De, jobs);
  for (int k = 0; k < 4; ++k)
    w.slots[k] = cv.take<float>(md::wgrad_slot_floats(jobs[k].rows, jobs[k].k1, jobs[k].k2));
  w.chain = cv.take<unsigned char>(md::edge_chain_bwd_bytes(B, N, Dn, De, I, G, De, 1));
  w.bytes = cv.off;
  return w;
}

}  // namespace

namespace md {

cudaError_t edge_tail_forward(const void* const* weights, const bf16* e, const bf16* x,
                              const bf16* tu, bf16* proj, bf16* out, int residual, int B, int N,
                              int Dn, int De, cudaStream_t s, int* launched) {
  TailArgs a = {};
  set_tail_weights(a, weights);
  a.e = e;
  a.x = x;
  a.tu = tu;
  a.proj = proj;
  a.out = out;
  a.residual = residual;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De;
  cudaError_t err = launch_tail_prep(a, s);
  if (err != cudaSuccess) return err;
  ++*launched;
  const size_t smem = 2 * md::smem_bytes(md::kMaxRows, De + 8, 2) +
                      md::smem_bytes(md::kMaxRows, De + 4, 4);
  err = cudaFuncSetAttribute(tail_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const size_t P = (size_t)B * N * N;
  tail_fwd_kernel<<<(unsigned)((P + md::kMaxRows - 1) / md::kMaxRows), md::kThreads, smem, s>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace md

extern "C" {

// p: 14 left and 14 right chain weights (BondFfn order), the tail's 10
// (node_ffn_left, node_ffn_right, self_ffn, ln, out), then e, x, mask, t,
// np, gpre, tu, proj (scratch) and out. De = Do.
// *launched: edge_pair.cu's prep and pair kernels, the proj and tail kernels.
int md_edge_block_full_forward(const void* const* p, int B, int N, int Dn, int De, int I, int G,
                               void* stream, int* launched) {
  const bf16* e = static_cast<const bf16*>(p[38]);
  const bf16* x = static_cast<const bf16*>(p[39]);
  bf16* tu = static_cast<bf16*>(const_cast<void*>(p[44]));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;
  cudaError_t err = md::edge_pair_run(
      p, e, x, static_cast<const float*>(p[40]), static_cast<const float*>(p[41]),
      static_cast<float*>(const_cast<void*>(p[42])), static_cast<float*>(const_cast<void*>(p[43])),
      tu, B, N, Dn, De, I, G, De, 0, s, launched);
  if (err != cudaSuccess) return err;
  return md::edge_tail_forward(p + 28, e, x, tu, static_cast<bf16*>(const_cast<void*>(p[45])),
                               static_cast<bf16*>(const_cast<void*>(p[46])), 0, B, N, Dn, De, s,
                               launched);
}

long long md_edge_block_full_backward_workspace(int B, int N, int Dn, int De, int I, int G) {
  return (long long)carve_full(nullptr, B, N, Dn, De, I, G).bytes;
}

// p: the 38 weights (as md_edge_block_full_forward), e, x, mask, t, ct, then
// the outputs d_bond, d_node, d_time, d_mask and the 38 float32 parameter
// gradients in the weights' order (each gate's first-layer weight as one
// [De+Dn+1, G] matrix), then the workspace
// (md_edge_block_full_backward_workspace bytes). The chains' pair kernel is
// built for the widths of md::edge_chain_bwd_built.
int md_edge_block_full_backward(const void* const* p, int B, int N, int Dn, int De, int I, int G,
                                void* stream, int* launched) {
  if (!md::edge_chain_bwd_built(De, I, G, De)) return cudaErrorInvalidValue;
  const bf16* e = static_cast<const bf16*>(p[38]);
  const bf16* x = static_cast<const bf16*>(p[39]);
  const float* mask = static_cast<const float*>(p[40]);
  const float* t = static_cast<const float*>(p[41]);
  float* grads[38];
  for (int k = 0; k < 38; ++k) grads[k] = static_cast<float*>(const_cast<void*>(p[47 + k]));
  FullBwdWork w = carve_full(static_cast<unsigned char*>(const_cast<void*>(p[85])), B, N, Dn,
                             De, I, G);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;

  // forward recompute: the chains' sums, the node FFNs
  cudaError_t err = md::edge_pair_run(p, e, x, mask, t, w.np, w.gpre, w.tu, B, N, Dn, De, I, G,
                                      De, 0, s, launched);
  if (err != cudaSuccess) return err;
  TailArgs a = {};
  set_tail_weights(a, p + 28);
  a.e = e;
  a.x = x;
  a.tu = w.tu;
  a.proj = w.proj;
  a.ct = static_cast<const bf16*>(p[42]);
  a.dct = w.dct;
  a.r = w.r;
  a.dh = w.dh;
  a.dhs = w.dhs;
  a.dbond = w.dbond;
  a.vecpart = w.vecpart;
  a.dproj = w.dproj;
  a.dprojs = w.dprojs;
  a.dnode = w.dnode;
  a.nodepart = w.nodepart;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De;
  err = launch_tail_prep(a, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  // the tail's backward: per pair, then its sums per node
  const size_t P = (size_t)B * N * N;
  const int BN = B * N;
  const int tiles = (int)((P + md::kBwdRows - 1) / md::kBwdRows);
  const int ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  const size_t ps = 3 * md::smem_bytes(md::kBwdRows, De + 8, 2) +
                    3 * md::smem_bytes(md::kBwdRows, De + 4, 4) +
                    md::smem_bytes(md::kBwdRows, 1, 4) +
                    (size_t)md::kWarps * kTailVecs * De * sizeof(float);
  err = cudaFuncSetAttribute(tail_bwd_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ps));
  if (err != cudaSuccess) return err;
  tail_bwd_pair_kernel<<<tiles, md::kThreads, ps, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  const size_t ns = 2 * md::smem_bytes(md::kBwdRows, De + 8, 2) +
                    md::smem_bytes(md::kBwdRows, Dn + 4, 4);
  err = cudaFuncSetAttribute(tail_bwd_node_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ns));
  if (err != cudaSuccess) return err;
  tail_bwd_node_kernel<<<ntiles, md::kThreads, ns, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;

  // the chains' backward on the float32 sums, with the tail's terms added
  md::EdgeChainBwd c = {};
  c.weights = p;
  c.e = e;
  c.x = x;
  c.mask = mask;
  c.t = t;
  c.ct32[0] = w.dproj;
  c.ct32[1] = w.dproj + (size_t)BN * De;
  c.np = w.np;
  c.gpre = w.gpre;
  c.dbond_add = w.dbond;
  c.dnode_add = w.dnode;
  c.d_bond = static_cast<bf16*>(const_cast<void*>(p[43]));
  c.d_node = static_cast<bf16*>(const_cast<void*>(p[44]));
  c.d_time = static_cast<float*>(const_cast<void*>(p[45]));
  c.d_mask = static_cast<float*>(const_cast<void*>(p[46]));
  c.grads = grads;
  c.workspace = w.chain;
  err = md::edge_chain_bwd(c, B, N, Dn, De, I, G, De, s, launched);
  if (err != cudaSuccess) return err;

  // the tail's parameter gradients, in the weights' order 28..37:
  // node_ffn_left w, b; node_ffn_right w, b; self_ffn w, b; ln scale, bias; out w, b
  TailJob tj[4];
  tail_jobs(B, N, Dn, De, tj);
  md::WgradJob jobs[4] = {
      {w.r, nullptr, w.dct, nullptr, w.slots[0], tj[0].rows, De, De, De, De},
      {e, nullptr, w.dhs.hi, w.dhs.lo, w.slots[1], tj[1].rows, De, De, De, De},
      {x, nullptr, w.dprojs.hi, w.dprojs.lo, w.slots[2], tj[2].rows, Dn, De, Dn, De},
      {x, nullptr, w.dprojs.hi + (size_t)BN * De, w.dprojs.lo + (size_t)BN * De, w.slots[3],
       tj[3].rows, Dn, De, Dn, De}};
  err = md::launch_wgrad(jobs, 4, s);
  if (err != cudaSuccess) return err;
  ++*launched;
  float* const* g = grads + 28;
  const int wout[4] = {8, 4, 0, 2};
  md::ReduceJob red[10];
  int nr = 0;
  for (int k = 0; k < 4; ++k) {
    const int n = jobs[k].k1 * jobs[k].k2;
    red[nr++] = {jobs[k].slots, g[wout[k]], md::wgrad_slices(jobs[k].rows), n, n};
  }
  const int vec_out[kTailVecs] = {9, 6, 7, 5};   // out bias, LN scale, LN bias, self bias
  for (int v = 0; v < kTailVecs; ++v)
    red[nr++] = {w.vecpart + (size_t)v * De, g[vec_out[v]], tiles, De, kTailVecs * De};
  for (int side = 0; side < 2; ++side)
    red[nr++] = {w.nodepart + (size_t)side * De, g[1 + 2 * side], ntiles, De, 2 * De};
  err = md::launch_reduce(red, nr, s);
  if (err != cudaSuccess) return err;
  ++*launched;
  return cudaSuccess;
}

}  // extern "C"
