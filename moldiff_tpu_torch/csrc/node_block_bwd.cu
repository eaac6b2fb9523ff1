// NodeBlock gated message aggregate, backward, for Hopper (sm_90a).
//
// Replaces moldiff_tpu/ops/pallas_kernels.py:_node_block_bwd_kernel (launched
// by _pallas_node_block_bwd): given dout [B,N,H] it recomputes the forward
// chain of node_block.cu per pair and returns dx [B,N,Dn] and d_edge
// [B,N,N,De] (bf16), d_t [B] and d_mask [B,N,N] (float32) and the 20
// parameter gradients (float32; the gate's first-layer weight as one
// [De+Dn+1, H] matrix). It keeps the Pallas body's roundings: activations
// rounded to bf16 where it casts, the recomputed sigmoid and message in
// float32, every product accumulated in float32. Where the Pallas body
// multiplies a float32 cotangent by a bf16 weight (d_msg @ Wm^T, d_h @
// We2^T, d_xn @ Wn2^T), the cotangent is split into bf16 hi + lo and both
// halves go through the tensor cores (grad.cuh).
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), bond-predictor
// widths Dn = H = 256, De = 64: the recompute (the forward's 458,752 FLOPs
// per pair) plus the input-gradient products (2 x H x H twice, one of them
// split, plus the H x H gate product and two H x De products) plus the
// weight-gradient products (A^T B for five pair matrices) come to about
// 1.6 MFLOP per pair and 0.8 MFLOP per node; chip_smoke.py work() counts
// them for the call. Bytes: e, mask and d_edge, d_mask per pair, x, dout
// and dx per node, weights and their gradients once: bound by operations.
//
// Design. The forward sums over senders j inside a receiver-row tile; the
// backward's sums run the other way: dx[j] gets, through xn[j] and the
// gate's x_j part, a sum over receivers i. So a CTA here owns one sender j
// and a chunk of at most 32 receivers (one chunk for N <= 32, two for N <=
// 64): those sums close inside the CTA per chunk, and a node-level kernel
// adds the chunks in order. d_t is a per-molecule sum of the gate's d_g1;
// each tile writes its column sums, and a one-CTA kernel adds them per
// molecule. Parameter gradients: the pair kernel writes per pair the
// activations (r1, hh, rg, bf16) and cotangents (d_h1, d_h, d_msg, d_g1,
// d_g2, float32) their weight gradients need, and grad.cu's split-K
// weight-gradient and reduction kernels form them: no float atomics, the
// result is reproducible. Launches per call: prep (node_block.cu), pair,
// node, weight gradients, reduction, time = 6.
#include "grad.cuh"

using md::bf16;

namespace {

constexpr int kVecs = 9;  // per-tile column sums, in this order:
enum { kBm = 0, kBg2, kBe2, kBe1, kSe1, kBe1n, kBg1, kSg1, kBg1n };
constexpr int kNodeVecs = 4;  // per node tile: bn1, sn1, bn1n, bn2

struct NodeBwdArgs {
  // the 20 weights of node_block.cu's NodeBlockArgs, in its order
  const bf16 *we1, *be1, *se1, *be1n, *we2, *be2;
  const bf16 *wn1, *bn1, *sn1, *bn1n, *wn2, *bn2;
  const bf16 *wm, *bm;
  const bf16 *wg1, *bg1, *sg1, *bg1n, *wg2, *bg2;
  const bf16* x;       // [B,N,Dn]
  const bf16* e;       // [B,N,N,De]
  const float* mask;   // [B,N,N]
  const bf16* dout;    // [B,N,H]
  const bf16* xn;      // prep: sender MLP [B,N,H]
  const float* gpre;   // prep: x @ Wg1x + t Wg1t + bg1 [B,N,H]
  bf16* dx;            // [B,N,Dn]
  bf16* d_edge;        // [B,N,N,De]
  float* d_mask;       // [B,N,N]
  // per pair, for the weight gradients
  bf16 *r1, *hh, *rg;
  float *dh1, *dh, *dmsg, *dg1, *dg2;
  float* vecpart;      // [tiles, kVecs, H]
  float* dxnpart;      // [tiles, H]
  // per node
  bf16* rn;
  float *dhn1, *dxn, *ssend;
  float* nodepart;     // [node tiles, kNodeVecs, H]
  int B, N, Dn, De, H, nch;
};

__host__ __device__ inline int ldf_of(int H, int D) { return (H > D ? H : D) + 4; }

__host__ inline size_t pair_smem(int De, int H) {
  return md::smem_bytes(md::kBwdRows, De + 8, 2) + 4 * md::smem_bytes(md::kBwdRows, H + 8, 2) +
         3 * md::smem_bytes(md::kBwdRows, ldf_of(H, De), 4) +
         (size_t)md::kWarps * 3 * H * sizeof(float);
}

__host__ inline size_t node_smem(int Dn, int H) {
  return md::smem_bytes(md::kBwdRows, Dn + 8, 2) + 3 * md::smem_bytes(md::kBwdRows, H + 8, 2) +
         2 * md::smem_bytes(md::kBwdRows, ldf_of(H, Dn), 4) +
         (size_t)md::kWarps * 3 * H * sizeof(float);
}

// One CTA per (molecule b, sender j, chunk c of receivers); row r of the
// tile is the pair (i0 + r, j).
__global__ void __launch_bounds__(md::kThreads) node_bwd_pair_kernel(const NodeBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, H = a.H, De = a.De;
  const int lde = De + 8, ldb = H + 8, ldf = ldf_of(H, De);
  size_t off = 0;
  bf16* sE = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, lde, 2);
  bf16* X[4];
  for (int k = 0; k < 4; ++k) {
    X[k] = reinterpret_cast<bf16*>(smem + off);
    off += md::smem_bytes(md::kBwdRows, ldb, 2);
  }
  float* F[3];
  for (int k = 0; k < 3; ++k) {
    F[k] = reinterpret_cast<float*>(smem + off);
    off += md::smem_bytes(md::kBwdRows, ldf, 4);
  }
  float* sPart = reinterpret_cast<float*>(smem + off);

  const int tile = blockIdx.x;
  const int node = tile / a.nch, chunk = tile % a.nch;
  const int b = node / N, j = node % N;
  const int i0 = chunk * md::kBwdRows;
  const int ri = min(md::kBwdRows, N - i0);
  const int mt = (ri + 15) / 16, rp = mt * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = H / 32;
  auto pair = [&](int r) -> size_t { return ((size_t)b * N + i0 + r) * N + j; };
  const float* gp = a.gpre + (size_t)node * H;
  const bf16* xnj = a.xn + (size_t)node * H;
  float* vpart = a.vecpart + (size_t)tile * kVecs * H;

  md::load_rows(sE, lde, ri, rp, De, [&](int r) { return a.e + pair(r) * De; });
  __syncthreads();

  // ---- forward recompute: gate (rg, float32 sigmoid) ----------------------
  md::cta_gemm(sE, lde, a.wg1, De, H, F[0], ldf, mt, md::kStore);
  __syncthreads();
  for (int r = warp; r < rp; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) v[q] = F[0][r * ldf + lane + 32 * q] + gp[lane + 32 * q];
    md::warp_ln_stats(v, nq);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) {
        const int c = lane + 32 * q;
        const bf16 g = md::tobf(fmaxf(v[q] * md::bf(a.sg1[c]) + md::bf(a.bg1n[c]), 0.0f));
        X[0][r * ldb + c] = g;
        if (r < ri) a.rg[pair(r) * H + c] = g;
      }
  }
  __syncthreads();
  md::cta_gemm(X[0], ldb, a.wg2, H, H, F[0], ldf, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rp * H; idx += blockDim.x) {
    const int r = idx / H, c = idx % H;
    F[0][r * ldf + c] = md::sigmoidf(F[0][r * ldf + c] + md::bf(a.bg2[c]));
  }
  // ---- edge MLP (r1, h) and the bilinear product hh ------------------------
  md::cta_gemm(sE, lde, a.we1, De, H, F[1], ldf, mt, md::kStore);
  __syncthreads();
  for (int r = warp; r < rp; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) v[q] = F[1][r * ldf + lane + 32 * q] + md::bf(a.be1[lane + 32 * q]);
    md::warp_ln_stats(v, nq);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) {
        const int c = lane + 32 * q;
        const bf16 h = md::tobf(fmaxf(v[q] * md::bf(a.se1[c]) + md::bf(a.be1n[c]), 0.0f));
        X[1][r * ldb + c] = h;
        if (r < ri) a.r1[pair(r) * H + c] = h;
      }
  }
  __syncthreads();
  md::cta_gemm(X[1], ldb, a.we2, H, H, F[1], ldf, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rp * H; idx += blockDim.x) {
    const int r = idx / H, c = idx % H;
    const float h = md::rbf(F[1][r * ldf + c] + md::bf(a.be2[c]));
    X[1][r * ldb + c] = md::tobf(h);
    const bf16 hh = md::tobf(h * md::bf(xnj[c]));
    X[2][r * ldb + c] = hh;
    if (r < ri) a.hh[pair(r) * H + c] = hh;
  }
  __syncthreads();
  md::cta_gemm(X[2], ldb, a.wm, H, H, F[1], ldf, mt, md::kStore);
  __syncthreads();

  // ---- cotangents at the message and the gate ------------------------------
  {
    float acc[2][md::kMaxPerLane] = {};
    for (int r = warp; r < rp; r += md::kWarps) {
      const bool valid = r < ri;
      const float m = valid ? a.mask[pair(r)] : 0.0f;
      const bf16* dout = a.dout + ((size_t)b * N + i0 + (valid ? r : 0)) * H;
      float dm = 0.0f;
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          const float msg = md::rbf(F[1][r * ldf + c] + md::bf(a.bm[c]));
          const float sig = F[0][r * ldf + c];
          const float d = valid ? md::bf(dout[c]) : 0.0f;
          const float dg = d * m;
          const float dmsg = dg * sig;
          const float dg2 = dg * msg * sig * (1.0f - sig);
          dm += d * (msg * sig);
          F[1][r * ldf + c] = dmsg;
          F[0][r * ldf + c] = dg2;
          acc[0][q] += dmsg;
          acc[1][q] += dg2;
          if (valid) {
            a.dmsg[pair(r) * H + c] = dmsg;
            a.dg2[pair(r) * H + c] = dg2;
          }
        }
      dm = md::warp_sum(dm);
      if (valid && lane == 0) a.d_mask[pair(r)] = dm;
    }
    md::flush_columns<2>(acc, nq, sPart, vpart + kBm * H, H);
  }

  // ---- d_hh = d_msg @ Wm^T; d_h and the sender sum d_xn --------------------
  md::split_rows(F[1], ldf, X[2], X[3], ldb, rp, H);
  __syncthreads();
  md::cta_gemm_t(X[2], X[3], ldb, a.wm, H, H, F[2], ldf, mt, md::kStore);
  __syncthreads();
  {
    float acc[1][md::kMaxPerLane] = {};
    float axn[1][md::kMaxPerLane] = {};
    for (int r = warp; r < rp; r += md::kWarps) {
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          const float dhh = F[2][r * ldf + c];
          const float dh = dhh * md::bf(xnj[c]);
          F[2][r * ldf + c] = dh;
          acc[0][q] += dh;
          axn[0][q] += dhh * md::bf(X[1][r * ldb + c]);
          if (r < ri) a.dh[pair(r) * H + c] = dh;
        }
    }
    md::flush_columns<1>(acc, nq, sPart, vpart + kBe2 * H, H);
    md::flush_columns<1>(axn, nq, sPart, a.dxnpart + (size_t)tile * H, H);
  }

  // ---- edge MLP backward: d_r1 = d_h @ We2^T, LayerNorm, d_h1 --------------
  md::split_rows(F[2], ldf, X[2], X[3], ldb, rp, H);
  __syncthreads();
  md::cta_gemm_t(X[2], X[3], ldb, a.we2, H, H, F[1], ldf, mt, md::kStore);
  md::cta_gemm(sE, lde, a.we1, De, H, F[2], ldf, mt, md::kStore);
  __syncthreads();
  {
    float acc[3][md::kMaxPerLane] = {};  // be1, se1, be1n
    for (int r = warp; r < rp; r += md::kWarps) {
      float xh[md::kMaxPerLane], dy[md::kMaxPerLane];
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) xh[q] = F[2][r * ldf + lane + 32 * q] + md::bf(a.be1[lane + 32 * q]);
      const float inv = md::warp_ln_stats(xh, nq);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          const float ln = xh[q] * md::bf(a.se1[c]) + md::bf(a.be1n[c]);
          dy[q] = ln > 0.0f ? F[1][r * ldf + c] : 0.0f;
          acc[1][q] += dy[q] * xh[q];
          acc[2][q] += dy[q];
        }
      md::warp_ln_bwd(dy, xh, inv, nq, a.se1, lane);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          acc[0][q] += dy[q];
          X[2][r * ldb + c] = md::tobf(dy[q]);
          if (r < ri) a.dh1[pair(r) * H + c] = dy[q];
        }
    }
    md::flush_columns<3>(acc, nq, sPart, vpart + kBe1 * H, H);
  }
  // d_e (edge part) = bf16(d_h1) @ We1^T; the gate's d_rg = bf16(d_g2) @ Wg2^T
  md::round_rows(F[0], ldf, X[3], ldb, rp, H);
  md::cta_gemm_t(X[2], nullptr, ldb, a.we1, H, De, F[2], ldf, mt, md::kStore);
  __syncthreads();
  md::cta_gemm_t(X[3], nullptr, ldb, a.wg2, H, H, F[1], ldf, mt, md::kStore);
  md::cta_gemm(sE, lde, a.wg1, De, H, F[0], ldf, mt, md::kStore);
  __syncthreads();

  // ---- gate backward: LayerNorm, d_g1 --------------------------------------
  {
    float acc[3][md::kMaxPerLane] = {};  // bg1 (= this tile's sender sum), sg1, bg1n
    for (int r = warp; r < rp; r += md::kWarps) {
      float xh[md::kMaxPerLane], dy[md::kMaxPerLane];
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) xh[q] = F[0][r * ldf + lane + 32 * q] + gp[lane + 32 * q];
      const float inv = md::warp_ln_stats(xh, nq);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          const float ln = xh[q] * md::bf(a.sg1[c]) + md::bf(a.bg1n[c]);
          dy[q] = ln > 0.0f ? F[1][r * ldf + c] : 0.0f;
          acc[1][q] += dy[q] * xh[q];
          acc[2][q] += dy[q];
        }
      md::warp_ln_bwd(dy, xh, inv, nq, a.sg1, lane);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          acc[0][q] += dy[q];
          X[2][r * ldb + c] = md::tobf(dy[q]);
          if (r < ri) a.dg1[pair(r) * H + c] = dy[q];
        }
    }
    md::flush_columns<3>(acc, nq, sPart, vpart + kBg1 * H, H);
  }
  // d_e += bf16(d_g1) @ Wg1e^T
  md::cta_gemm_t(X[2], nullptr, ldb, a.wg1, H, De, F[2], ldf, mt, md::kAdd);
  __syncthreads();
  for (int idx = threadIdx.x; idx < ri * De; idx += blockDim.x) {
    const int r = idx / De, c = idx % De;
    a.d_edge[pair(r) * De + c] = md::tobf(F[2][r * ldf + c]);
  }
}

// One CTA per 32 nodes (flattened over molecules): the sender sums of the
// chunks, the node MLP backward and dx.
__global__ void __launch_bounds__(md::kThreads) node_bwd_node_kernel(const NodeBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int H = a.H, Dn = a.Dn, De = a.De;
  const int ldx = Dn + 8, ldb = H + 8, ldf = ldf_of(H, Dn);
  size_t off = 0;
  bf16* sX = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldx, 2);
  bf16* X[3];
  for (int k = 0; k < 3; ++k) {
    X[k] = reinterpret_cast<bf16*>(smem + off);
    off += md::smem_bytes(md::kBwdRows, ldb, 2);
  }
  float* F[2];
  for (int k = 0; k < 2; ++k) {
    F[k] = reinterpret_cast<float*>(smem + off);
    off += md::smem_bytes(md::kBwdRows, ldf, 4);
  }
  float* sPart = reinterpret_cast<float*>(smem + off);

  const int total = a.B * a.N;
  const int n0 = blockIdx.x * md::kBwdRows;
  const int rows = min(md::kBwdRows, total - n0);
  const int mt = (rows + 15) / 16, rp = mt * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = H / 32;
  float* npart = a.nodepart + (size_t)blockIdx.x * kNodeVecs * H;

  md::load_rows(sX, ldx, rows, rp, Dn, [&](int r) { return a.x + (size_t)(n0 + r) * Dn; });
  {
    float acc[1][md::kMaxPerLane] = {};  // bn2
    for (int r = warp; r < rp; r += md::kWarps) {
      const bool valid = r < rows;
      const size_t t0 = (size_t)(n0 + (valid ? r : 0)) * a.nch;
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          float dxn = 0.0f, ss = 0.0f;
          if (valid)
            for (int k = 0; k < a.nch; ++k) {
              dxn += a.dxnpart[(t0 + k) * H + c];
              ss += a.vecpart[((t0 + k) * kVecs + kBg1) * H + c];
            }
          F[0][r * ldf + c] = dxn;
          F[1][r * ldf + c] = ss;
          acc[0][q] += dxn;
          if (valid) {
            a.dxn[(size_t)(n0 + r) * H + c] = dxn;
            a.ssend[(size_t)(n0 + r) * H + c] = ss;
          }
        }
    }
    md::flush_columns<1>(acc, nq, sPart, npart + 3 * H, H);
  }
  md::round_rows(F[1], ldf, X[2], ldb, rp, H);
  md::split_rows(F[0], ldf, X[0], X[1], ldb, rp, H);
  __syncthreads();
  md::cta_gemm_t(X[0], X[1], ldb, a.wn2, H, H, F[1], ldf, mt, md::kStore);  // d_rn
  md::cta_gemm(sX, ldx, a.wn1, Dn, H, F[0], ldf, mt, md::kStore);           // hn1 - bn1
  __syncthreads();
  {
    float acc[3][md::kMaxPerLane] = {};  // bn1, sn1, bn1n
    for (int r = warp; r < rp; r += md::kWarps) {
      float xh[md::kMaxPerLane], dy[md::kMaxPerLane];
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) xh[q] = F[0][r * ldf + lane + 32 * q] + md::bf(a.bn1[lane + 32 * q]);
      const float inv = md::warp_ln_stats(xh, nq);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          const float ln = xh[q] * md::bf(a.sn1[c]) + md::bf(a.bn1n[c]);
          if (r < rows) a.rn[(size_t)(n0 + r) * H + c] = md::tobf(fmaxf(ln, 0.0f));
          dy[q] = ln > 0.0f ? F[1][r * ldf + c] : 0.0f;
          acc[1][q] += dy[q] * xh[q];
          acc[2][q] += dy[q];
        }
      md::warp_ln_bwd(dy, xh, inv, nq, a.sn1, lane);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          acc[0][q] += dy[q];
          X[0][r * ldb + c] = md::tobf(dy[q]);
          if (r < rows) a.dhn1[(size_t)(n0 + r) * H + c] = dy[q];
        }
    }
    md::flush_columns<3>(acc, nq, sPart, npart, H);
  }
  // dx = bf16(d_hn1) @ Wn1^T + bf16(sender sum of d_g1) @ Wg1x^T
  md::cta_gemm_t(X[0], nullptr, ldb, a.wn1, H, Dn, F[0], ldf, mt, md::kStore);
  __syncthreads();
  md::cta_gemm_t(X[2], nullptr, ldb, a.wg1 + (size_t)De * H, H, Dn, F[0], ldf, mt, md::kAdd);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * Dn; idx += blockDim.x) {
    const int r = idx / Dn, c = idx % Dn;
    a.dx[(size_t)(n0 + r) * Dn + c] = md::tobf(F[0][r * ldf + c]);
  }
}

// Workspace of one call; with base == nullptr only its size.
struct NodeBwdWork {
  bf16* xn;
  float* gpre;
  float* slots[8];
  size_t bytes;
};

NodeBwdWork carve(NodeBwdArgs& a, unsigned char* base, int B, int N, int Dn, int De, int H) {
  md::Carve cv{base};
  const size_t P = (size_t)B * N * N, BN = (size_t)B * N;
  const int nch = (N + md::kBwdRows - 1) / md::kBwdRows;
  const size_t tiles = BN * nch, ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  NodeBwdWork w;
  w.xn = cv.take<bf16>(BN * H);
  w.gpre = cv.take<float>(BN * H);
  a.r1 = cv.take<bf16>(P * H);
  a.hh = cv.take<bf16>(P * H);
  a.rg = cv.take<bf16>(P * H);
  a.dh1 = cv.take<float>(P * H);
  a.dh = cv.take<float>(P * H);
  a.dmsg = cv.take<float>(P * H);
  a.dg1 = cv.take<float>(P * H);
  a.dg2 = cv.take<float>(P * H);
  a.vecpart = cv.take<float>(tiles * kVecs * H);
  a.dxnpart = cv.take<float>(tiles * H);
  a.rn = cv.take<bf16>(BN * H);
  a.dhn1 = cv.take<float>(BN * H);
  a.dxn = cv.take<float>(BN * H);
  a.ssend = cv.take<float>(BN * H);
  a.nodepart = cv.take<float>(ntiles * kNodeVecs * H);
  const int P_ = (int)P, BN_ = (int)BN;
  const int dims[8][3] = {{P_, De, H}, {P_, H, H}, {P_, H, H}, {P_, De, H},
                          {P_, H, H},  {BN_, Dn, H}, {BN_, H, H}, {BN_, Dn, H}};
  for (int k = 0; k < 8; ++k)
    w.slots[k] = cv.take<float>(md::wgrad_slot_floats(dims[k][0], dims[k][1], dims[k][2]));
  a.nch = nch;
  w.bytes = cv.off;
  return w;
}

}  // namespace

extern "C" {

long long md_node_block_backward_workspace(int B, int N, int Dn, int De, int H) {
  NodeBwdArgs a = {};
  return (long long)carve(a, nullptr, B, N, Dn, De, H).bytes;
}

// p: the 20 weights (NodeBlockArgs order), x, e, mask, t, dout, then the
// outputs dx, d_edge, d_t, d_mask and the 20 float32 parameter gradients in
// the weights' order (the gate's first-layer weight as one [De+Dn+1, H]
// matrix), then the workspace (md_node_block_backward_workspace bytes).
int md_node_block_backward(const void* const* p, int B, int N, int Dn, int De, int H,
                           void* stream, int* launched) {
  NodeBwdArgs a = {};
  const bf16** w = &a.we1;
  for (int k = 0; k < 20; ++k) w[k] = static_cast<const bf16*>(p[k]);
  a.x = static_cast<const bf16*>(p[20]);
  a.e = static_cast<const bf16*>(p[21]);
  a.mask = static_cast<const float*>(p[22]);
  const float* t = static_cast<const float*>(p[23]);
  a.dout = static_cast<const bf16*>(p[24]);
  a.dx = static_cast<bf16*>(const_cast<void*>(p[25]));
  a.d_edge = static_cast<bf16*>(const_cast<void*>(p[26]));
  float* d_t = static_cast<float*>(const_cast<void*>(p[27]));
  a.d_mask = static_cast<float*>(const_cast<void*>(p[28]));
  float* g[20];
  for (int k = 0; k < 20; ++k) g[k] = static_cast<float*>(const_cast<void*>(p[29 + k]));
  NodeBwdWork ws = carve(a, static_cast<unsigned char*>(const_cast<void*>(p[49])), B, N, Dn,
                         De, H);
  a.xn = ws.xn;
  a.gpre = ws.gpre;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;

  cudaError_t err = md::node_block_prep(p, a.x, t, ws.xn, ws.gpre, B, N, Dn, De, H, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  const int BN = B * N, P = BN * N;
  const int tiles = BN * a.nch, ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  const size_t ps = pair_smem(De, H), ns = node_smem(Dn, H);
  err = cudaFuncSetAttribute(node_bwd_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ps));
  if (err != cudaSuccess) return err;
  node_bwd_pair_kernel<<<tiles, md::kThreads, ps, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;

  err = cudaFuncSetAttribute(node_bwd_node_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ns));
  if (err != cudaSuccess) return err;
  node_bwd_node_kernel<<<ntiles, md::kThreads, ns, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;

  // gradient outputs, in the weights' order
  enum { We1, Be1, Se1, Be1n, We2, Be2, Wn1, Bn1, Sn1, Bn1n, Wn2, Bn2, Wm, Bm,
         Wg1, Bg1, Sg1, Bg1n, Wg2, Bg2 };
  const md::WgradJob jobs[8] = {
      {a.e, a.dh1, ws.slots[0], P, De, H, De, H, 0},
      {a.r1, a.dh, ws.slots[1], P, H, H, H, H, 0},
      {a.hh, a.dmsg, ws.slots[2], P, H, H, H, H, 0},
      {a.e, a.dg1, ws.slots[3], P, De, H, De, H, 0},
      {a.rg, a.dg2, ws.slots[4], P, H, H, H, H, 0},
      {a.x, a.dhn1, ws.slots[5], BN, Dn, H, Dn, H, 0},
      {a.rn, a.dxn, ws.slots[6], BN, H, H, H, H, 0},
      {a.x, a.ssend, ws.slots[7], BN, Dn, H, Dn, H, 0},
  };
  float* const job_out[8] = {g[We1], g[We2], g[Wm], g[Wg1], g[Wg2], g[Wn1], g[Wn2],
                             g[Wg1] + (size_t)De * H};
  err = md::launch_wgrad(jobs, 8, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  md::ReduceJob red[21];
  int nr = 0;
  for (int k = 0; k < 8; ++k) {
    const int n = jobs[k].k1 * jobs[k].k2;
    red[nr++] = {ws.slots[k], job_out[k], md::wgrad_slices(jobs[k].rows), n, n};
  }
  const int vec_out[kVecs] = {Bm, Bg2, Be2, Be1, Se1, Be1n, Bg1, Sg1, Bg1n};
  for (int v = 0; v < kVecs; ++v)
    red[nr++] = {a.vecpart + (size_t)v * H, g[vec_out[v]], tiles, H, kVecs * H};
  const int node_out[kNodeVecs] = {Bn1, Sn1, Bn1n, Bn2};
  for (int v = 0; v < kNodeVecs; ++v)
    red[nr++] = {a.nodepart + (size_t)v * H, g[node_out[v]], ntiles, H, kNodeVecs * H};
  err = md::launch_reduce(red, nr, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  // d_t and the gate weight's time row
  const size_t trow = (size_t)(De + Dn) * H;
  err = md::launch_time(a.vecpart + (size_t)kBg1 * H, kVecs * H, N * a.nch, H, B, a.wg1 + trow,
                        t, d_t, g[Wg1] + trow, 0, s);
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // extern "C"
