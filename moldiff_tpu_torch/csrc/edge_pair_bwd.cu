// EdgeBlock pair aggregate, backward, for Hopper (sm_90a).
//
// Replaces moldiff_tpu/ops/pallas_kernels.py:_edge_pair_bwd_kernel (launched
// by _pallas_edge_pair_bwd, its chains by _edge_side_bwd): given the
// cotangents of t [B,N,Do] (left chain, summed over rows) and u (right
// chain, summed over columns) it recomputes both gated BondFFN chains of
// edge_pair.cu per pair and returns d_bond [B,N,N,De] and d_node [B,N,Dn]
// (bf16), d_time [B] and d_mask [B,N,N] (float32) and both chains' 14
// parameter gradients (float32; each gate's first-layer weight as one
// [De+Dn+1, G] matrix), with the Pallas body's roundings.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), De = Do = 64,
// Dn = 256, I = 128, G = 32: per pair and chain the recompute (the
// forward's products), the input-gradient products (the same shapes
// transposed) and the weight-gradient products (A^T B for five pair
// matrices, one of them with a float32 A) come to about 0.5 MFLOP;
// chip_smoke.py work() counts them for the call. Bound by operations.
//
// Design. The left chain's cotangent broadcasts back over rows and its node
// sums (the gate's x part, node_linear) run over columns, so a left-chain
// CTA owns one row i and a chunk of at most 32 columns; the right chain
// owns one column and a chunk of rows (the opposite of the forward's
// split). Those sums close per chunk and a node-level kernel adds the
// chunks in order and forms d_node for both chains. The two chains are two
// launches of one pair kernel: the first writes its d_bond and d_mask terms
// in float32, the second adds its own and writes the results, so every
// element is written by one CTA and nothing races. Parameter gradients go
// through grad.cu as in node_block_bwd.cu. Launches per call: prep
// (edge_pair.cu), pair x 2, node, weight gradients, reduction, time x 2 = 8.
// The chains' backward (md::edge_chain_bwd) also serves the full-EdgeBlock
// backward (edge_block_full.cu), which gives it float32 cotangents, its
// own prep and the tail's terms of d_bond and d_node.
#include "grad.cuh"

using md::bf16;

namespace {

constexpr int kVecs = 8;  // per-tile column sums, in this order:
enum { kB2 = 0, kBg2, kBg1, kSg1, kBg1n, kB1, kS1, kB1n };

struct BondFfn {
  const bf16 *wb, *wn, *w1, *b1, *s1, *b1n, *w2, *b2, *wg1, *bg1, *sg1, *bg1n, *wg2, *bg2;
};

// per-chain buffers for the weight gradients
struct SideWork {
  float* inter0;   // [P, I]
  bf16* r1;        // [P, I]
  bf16* rg;        // [P, G]
  float* dh1;      // [P, I]
  float* dout;     // [P, Do]
  float* dg2;      // [P, Do]
  float* dg1;      // [P, G]
  float* dbp;      // [P, I]
  float* vecpart;  // [tiles, kVecs, I]
  float* nppart;   // [tiles, I]
  float* snode;    // [B*N, G]
  float* dnp;      // [B*N, I]
};

struct EdgeBwdArgs {
  BondFfn side[2];
  const bf16* e;       // [B,N,N,De]
  const bf16* x;       // [B,N,Dn]
  const float* mask;   // [B,N,N]
  const bf16* ct[2];   // cotangents of t and u, [B,N,Do], bf16
  const float* ct32[2];  // or float32 (when not null)
  const float* dbond_add;  // [B,N,N,De] float32 added to d_bond, or null
  const float* dnode_add;  // [B,N,Dn] float32 added to d_node, or null
  const float* np;     // prep: [2,B,N,I] x @ Wn
  const float* gpre;   // prep: [2,B,N,G] x @ Wg1x + t Wg1t + bg1
  bf16* d_bond;        // [B,N,N,De]
  bf16* d_node;        // [B,N,Dn]
  float* d_mask;       // [B,N,N]
  float* dbond32;      // [B,N,N,De] the left chain's term
  SideWork w[2];
  int B, N, Dn, De, I, G, Do, nch;
};

__host__ __device__ inline int ldf_of(int I, int De) { return (I > De ? I : De) + 4; }

__host__ inline size_t pair_smem(int De, int I) {
  return md::smem_bytes(md::kBwdRows, De + 8, 2) + 4 * md::smem_bytes(md::kBwdRows, I + 8, 2) +
         4 * md::smem_bytes(md::kBwdRows, ldf_of(I, De), 4) +
         (size_t)md::kWarps * 3 * I * sizeof(float);
}

__host__ inline size_t node_smem(int Dn, int I) {
  return 2 * md::smem_bytes(md::kBwdRows, I + 8, 2) + md::smem_bytes(md::kBwdRows, Dn + 4, 4);
}

// One CTA per (molecule b, owned node k, chunk of 32 nodes m) of one chain:
// row r of the tile is the pair (k, m) for the left chain (side 0), (m, k)
// for the right chain; the chain's node features are k's.
__global__ void __launch_bounds__(md::kThreads) edge_bwd_pair_kernel(const EdgeBwdArgs a,
                                                                     const int side) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, De = a.De, I = a.I, G = a.G, Do = a.Do;
  const int lde = De + 8, ldb = I + 8, ldf = ldf_of(I, De);
  size_t off = 0;
  bf16* sE = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, lde, 2);
  bf16* X[4];
  for (int k = 0; k < 4; ++k) {
    X[k] = reinterpret_cast<bf16*>(smem + off);
    off += md::smem_bytes(md::kBwdRows, ldb, 2);
  }
  float* F[4];
  for (int k = 0; k < 4; ++k) {
    F[k] = reinterpret_cast<float*>(smem + off);
    off += md::smem_bytes(md::kBwdRows, ldf, 4);
  }
  float* sPart = reinterpret_cast<float*>(smem + off);

  const BondFfn& W = a.side[side];
  const SideWork& S = a.w[side];
  const int tile = blockIdx.x;
  const int node = tile / a.nch, chunk = tile % a.nch;
  const int b = node / N, k = node % N;
  const int m0 = chunk * md::kBwdRows;
  const int ri = min(md::kBwdRows, N - m0);
  const int mt = (ri + 15) / 16, rp = mt * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int iq = I / 32, gq = G / 32, oq = Do / 32;
  const size_t BN = (size_t)a.B * N;
  auto pair = [&](int r) -> size_t {
    return side == 0 ? (size_t)node * N + m0 + r : ((size_t)b * N + m0 + r) * N + k;
  };
  const float* npk = a.np + side * BN * I + (size_t)node * I;
  const float* gpk = a.gpre + side * BN * G + (size_t)node * G;
  float* vpart = S.vecpart + (size_t)tile * kVecs * I;

  md::load_rows(sE, lde, ri, rp, De, [&](int r) { return a.e + pair(r) * De; });
  __syncthreads();

  // ---- forward recompute ----------------------------------------------------
  md::cta_gemm(sE, lde, W.wb, De, I, F[0], ldf, mt, md::kStore);  // bp, kept in F0
  __syncthreads();
  for (int idx = threadIdx.x; idx < rp * I; idx += blockDim.x) {
    const int r = idx / I, c = idx % I;
    const float inter0 = F[0][r * ldf + c] * npk[c];
    X[3][r * ldb + c] = md::tobf(inter0);  // kept for the recompute below
    if (r < ri) S.inter0[pair(r) * I + c] = inter0;
  }
  __syncthreads();
  md::cta_gemm(X[3], ldb, W.w1, I, I, F[1], ldf, mt, md::kStore);
  __syncthreads();
  for (int r = warp; r < rp; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < iq) v[q] = F[1][r * ldf + lane + 32 * q] + md::bf(W.b1[lane + 32 * q]);
    md::warp_ln_stats(v, iq);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < iq) {
        const int c = lane + 32 * q;
        const bf16 h = md::tobf(fmaxf(v[q] * md::bf(W.s1[c]) + md::bf(W.b1n[c]), 0.0f));
        X[1][r * ldb + c] = h;
        if (r < ri) S.r1[pair(r) * I + c] = h;
      }
  }
  __syncthreads();
  md::cta_gemm(X[1], ldb, W.w2, I, Do, F[1], ldf, mt, md::kStore);   // out_i - b2
  md::cta_gemm(sE, lde, W.wg1, De, G, F[2], ldf, mt, md::kStore);    // gate, edge part
  __syncthreads();
  for (int r = warp; r < rp; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < gq) v[q] = F[2][r * ldf + lane + 32 * q] + gpk[lane + 32 * q];
    md::warp_ln_stats(v, gq);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < gq) {
        const int c = lane + 32 * q;
        const bf16 g = md::tobf(fmaxf(v[q] * md::bf(W.sg1[c]) + md::bf(W.bg1n[c]), 0.0f));
        X[2][r * ldb + c] = g;
        if (r < ri) S.rg[pair(r) * G + c] = g;
      }
  }
  __syncthreads();
  md::cta_gemm(X[2], ldb, W.wg2, G, Do, F[2], ldf, mt, md::kStore);
  __syncthreads();

  // ---- cotangents at the message, d_mask -------------------------------------
  {
    float acc[2][md::kMaxPerLane] = {};  // b2, bg2
    for (int r = warp; r < rp; r += md::kWarps) {
      const bool valid = r < ri;
      const float m = valid ? a.mask[pair(r)] : 0.0f;
      const size_t ct_row = ((size_t)b * N + m0 + (valid ? r : 0)) * Do;
      const bf16* ct = a.ct32[side] ? nullptr : a.ct[side] + ct_row;
      const float* ct32 = a.ct32[side] ? a.ct32[side] + ct_row : nullptr;
      float dm = 0.0f;
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < oq) {
          const int c = lane + 32 * q;
          const float sig = md::sigmoidf(F[2][r * ldf + c] + md::bf(W.bg2[c]));
          const float out = F[1][r * ldf + c] + md::bf(W.b2[c]);
          const float dr = !valid ? 0.0f : ct32 ? ct32[c] : md::bf(ct[c]);
          dm += dr * (out * sig);
          const float dmsg = dr * m;
          const float dout = dmsg * sig;
          const float dg2 = dmsg * out * sig * (1.0f - sig);
          F[1][r * ldf + c] = dout;
          F[2][r * ldf + c] = dg2;
          acc[0][q] += dout;
          acc[1][q] += dg2;
          if (valid) {
            S.dout[pair(r) * Do + c] = dout;
            S.dg2[pair(r) * Do + c] = dg2;
          }
        }
      dm = md::warp_sum(dm);
      if (valid && lane == 0) {
        if (side == 0)
          a.d_mask[pair(r)] = dm;
        else
          a.d_mask[pair(r)] += dm;
      }
    }
    md::flush_columns<2>(acc, oq, sPart, vpart + kB2 * I, I);
  }

  // ---- gate backward ----------------------------------------------------------
  md::round_rows(F[2], ldf, X[2], ldb, rp, Do);
  md::round_rows(F[1], ldf, X[0], ldb, rp, Do);
  __syncthreads();
  md::cta_gemm_t(X[2], nullptr, ldb, W.wg2, Do, G, F[3], ldf, mt, md::kStore);  // d_rg
  md::cta_gemm_t(X[0], nullptr, ldb, W.w2, Do, I, F[1], ldf, mt, md::kStore);   // d_r1
  md::cta_gemm(sE, lde, W.wg1, De, G, F[2], ldf, mt, md::kStore);               // recompute
  __syncthreads();
  {
    float acc[3][md::kMaxPerLane] = {};  // bg1 (= this tile's node sum), sg1, bg1n
    for (int r = warp; r < rp; r += md::kWarps) {
      float xh[md::kMaxPerLane], dy[md::kMaxPerLane];
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < gq) xh[q] = F[2][r * ldf + lane + 32 * q] + gpk[lane + 32 * q];
      const float inv = md::warp_ln_stats(xh, gq);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < gq) {
          const int c = lane + 32 * q;
          const float ln = xh[q] * md::bf(W.sg1[c]) + md::bf(W.bg1n[c]);
          dy[q] = ln > 0.0f ? F[3][r * ldf + c] : 0.0f;
          acc[1][q] += dy[q] * xh[q];
          acc[2][q] += dy[q];
        }
      md::warp_ln_bwd(dy, xh, inv, gq, W.sg1, lane);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < gq) {
          const int c = lane + 32 * q;
          acc[0][q] += dy[q];
          X[2][r * ldb + c] = md::tobf(dy[q]);
          if (r < ri) S.dg1[pair(r) * G + c] = dy[q];
        }
    }
    md::flush_columns<3>(acc, gq, sPart, vpart + kBg1 * I, I);
  }
  md::cta_gemm_t(X[2], nullptr, ldb, W.wg1, G, De, F[3], ldf, mt, md::kStore);  // d_e (gate)
  md::cta_gemm(X[3], ldb, W.w1, I, I, F[2], ldf, mt, md::kStore);               // recompute h1
  __syncthreads();

  // ---- inter MLP backward -----------------------------------------------------
  {
    float acc[3][md::kMaxPerLane] = {};  // b1, s1, b1n
    for (int r = warp; r < rp; r += md::kWarps) {
      float xh[md::kMaxPerLane], dy[md::kMaxPerLane];
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < iq) xh[q] = F[2][r * ldf + lane + 32 * q] + md::bf(W.b1[lane + 32 * q]);
      const float inv = md::warp_ln_stats(xh, iq);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < iq) {
          const int c = lane + 32 * q;
          const float ln = xh[q] * md::bf(W.s1[c]) + md::bf(W.b1n[c]);
          dy[q] = ln > 0.0f ? F[1][r * ldf + c] : 0.0f;
          acc[1][q] += dy[q] * xh[q];
          acc[2][q] += dy[q];
        }
      md::warp_ln_bwd(dy, xh, inv, iq, W.s1, lane);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < iq) {
          const int c = lane + 32 * q;
          acc[0][q] += dy[q];
          X[0][r * ldb + c] = md::tobf(dy[q]);
          if (r < ri) S.dh1[pair(r) * I + c] = dy[q];
        }
    }
    md::flush_columns<3>(acc, iq, sPart, vpart + kB1 * I, I);
  }
  md::cta_gemm_t(X[0], nullptr, ldb, W.w1, I, I, F[1], ldf, mt, md::kStore);  // d_inter0
  __syncthreads();
  {
    float acc[1][md::kMaxPerLane] = {};  // node_linear's node sum
    for (int r = warp; r < rp; r += md::kWarps) {
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < iq) {
          const int c = lane + 32 * q;
          const float di = F[1][r * ldf + c];
          const float dbp = di * npk[c];
          acc[0][q] += di * F[0][r * ldf + c];
          X[0][r * ldb + c] = md::tobf(dbp);
          if (r < ri) S.dbp[pair(r) * I + c] = dbp;
        }
    }
    md::flush_columns<1>(acc, iq, sPart, S.nppart + (size_t)tile * I, I);
  }
  md::cta_gemm_t(X[0], nullptr, ldb, W.wb, I, De, F[3], ldf, mt, md::kAdd);  // d_e (inter)
  __syncthreads();
  for (int idx = threadIdx.x; idx < ri * De; idx += blockDim.x) {
    const int r = idx / De, c = idx % De;
    const size_t o = pair(r) * De + c;
    if (side == 0)
      a.dbond32[o] = (a.dbond_add ? a.dbond_add[o] : 0.0f) + F[3][r * ldf + c];
    else
      a.d_bond[o] = md::tobf(a.dbond32[o] + F[3][r * ldf + c]);
  }
}

// One CTA per 32 nodes: both chains' node sums and d_node.
__global__ void __launch_bounds__(md::kThreads) edge_bwd_node_kernel(const EdgeBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int I = a.I, G = a.G, Dn = a.Dn, De = a.De;
  const int ldb = I + 8, ldf = Dn + 4;
  bf16* X0 = reinterpret_cast<bf16*>(smem);
  bf16* X1 = reinterpret_cast<bf16*>(smem + md::smem_bytes(md::kBwdRows, ldb, 2));
  float* F0 = reinterpret_cast<float*>(smem + 2 * md::smem_bytes(md::kBwdRows, ldb, 2));
  const int total = a.B * a.N;
  const int n0 = blockIdx.x * md::kBwdRows;
  const int rows = min(md::kBwdRows, total - n0);
  const int mt = (rows + 15) / 16, rp = mt * 16;
  if (a.dnode_add != nullptr) {
    for (int idx = threadIdx.x; idx < rp * Dn; idx += blockDim.x) {
      const int r = idx / Dn, c = idx % Dn;
      F0[r * ldf + c] = r < rows ? a.dnode_add[(size_t)(n0 + r) * Dn + c] : 0.0f;
    }
  }
  for (int side = 0; side < 2; ++side) {
    const SideWork& S = a.w[side];
    const BondFfn& W = a.side[side];
    for (int idx = threadIdx.x; idx < rp * G; idx += blockDim.x) {
      const int r = idx / G, c = idx % G;
      float s = 0.0f;
      if (r < rows) {
        for (int k = 0; k < a.nch; ++k)
          s += S.vecpart[(((size_t)(n0 + r) * a.nch + k) * kVecs + kBg1) * I + c];
        S.snode[(size_t)(n0 + r) * G + c] = s;
      }
      X0[r * ldb + c] = md::tobf(s);
    }
    for (int idx = threadIdx.x; idx < rp * I; idx += blockDim.x) {
      const int r = idx / I, c = idx % I;
      float s = 0.0f;
      if (r < rows) {
        for (int k = 0; k < a.nch; ++k) s += S.nppart[((size_t)(n0 + r) * a.nch + k) * I + c];
        S.dnp[(size_t)(n0 + r) * I + c] = s;
      }
      X1[r * ldb + c] = md::tobf(s);
    }
    __syncthreads();
    md::cta_gemm_t(X0, nullptr, ldb, W.wg1 + (size_t)De * G, G, Dn, F0, ldf, mt,
                   side == 0 && a.dnode_add == nullptr ? md::kStore : md::kAdd);
    __syncthreads();
    md::cta_gemm_t(X1, nullptr, ldb, W.wn, I, Dn, F0, ldf, mt, md::kAdd);
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < rows * Dn; idx += blockDim.x) {
    const int r = idx / Dn, c = idx % Dn;
    a.d_node[(size_t)(n0 + r) * Dn + c] = md::tobf(F0[r * ldf + c]);
  }
}

struct EdgeBwdWork {
  float* np;
  float* gpre;
  float* slots[2][7];
  size_t bytes;
};

EdgeBwdWork carve(EdgeBwdArgs& a, unsigned char* base, int B, int N, int Dn, int De, int I,
                  int G, int Do) {
  md::Carve cv{base};
  const size_t P = (size_t)B * N * N, BN = (size_t)B * N;
  const int nch = (N + md::kBwdRows - 1) / md::kBwdRows;
  const size_t tiles = BN * nch;
  EdgeBwdWork w;
  w.np = cv.take<float>(2 * BN * I);
  w.gpre = cv.take<float>(2 * BN * G);
  a.dbond32 = cv.take<float>(P * De);
  const int P_ = (int)P, BN_ = (int)BN;
  const int dims[7][3] = {{P_, De, I}, {P_, I, I},   {P_, I, Do}, {P_, De, G},
                          {P_, G, Do}, {BN_, Dn, I}, {BN_, Dn, G}};
  for (int s = 0; s < 2; ++s) {
    SideWork& S = a.w[s];
    S.inter0 = cv.take<float>(P * I);
    S.r1 = cv.take<bf16>(P * I);
    S.rg = cv.take<bf16>(P * G);
    S.dh1 = cv.take<float>(P * I);
    S.dout = cv.take<float>(P * Do);
    S.dg2 = cv.take<float>(P * Do);
    S.dg1 = cv.take<float>(P * G);
    S.dbp = cv.take<float>(P * I);
    S.vecpart = cv.take<float>(tiles * kVecs * I);
    S.nppart = cv.take<float>(tiles * I);
    S.snode = cv.take<float>(BN * G);
    S.dnp = cv.take<float>(BN * I);
    for (int k = 0; k < 7; ++k)
      w.slots[s][k] = cv.take<float>(md::wgrad_slot_floats(dims[k][0], dims[k][1], dims[k][2]));
  }
  a.nch = nch;
  w.bytes = cv.off;
  return w;
}

}  // namespace

namespace md {

size_t edge_chain_bwd_bytes(int B, int N, int Dn, int De, int I, int G, int Do) {
  EdgeBwdArgs a = {};
  return carve(a, nullptr, B, N, Dn, De, I, G, Do).bytes;
}

cudaError_t edge_chain_bwd(const EdgeChainBwd& c, int B, int N, int Dn, int De, int I, int G,
                           int Do, cudaStream_t s, int* launched) {
  EdgeBwdArgs a = {};
  const bf16** w = &a.side[0].wb;
  for (int k = 0; k < 28; ++k) w[k] = static_cast<const bf16*>(c.weights[k]);
  a.e = c.e;
  a.x = c.x;
  a.mask = c.mask;
  for (int sd = 0; sd < 2; ++sd) {
    a.ct[sd] = c.ct16[sd];
    a.ct32[sd] = c.ct32[sd];
  }
  a.dbond_add = c.dbond_add;
  a.dnode_add = c.dnode_add;
  a.d_bond = c.d_bond;
  a.d_node = c.d_node;
  a.d_mask = c.d_mask;
  const float* t = c.t;
  float* d_time = c.d_time;
  float* g[2][14];
  for (int sd = 0; sd < 2; ++sd)
    for (int k = 0; k < 14; ++k) g[sd][k] = c.grads[14 * sd + k];
  EdgeBwdWork ws = carve(a, static_cast<unsigned char*>(c.workspace), B, N, Dn, De, I, G, Do);
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.I = I; a.G = G; a.Do = Do;

  cudaError_t err;
  if (c.np != nullptr) {
    a.np = c.np;
    a.gpre = c.gpre;
  } else {
    a.np = ws.np;
    a.gpre = ws.gpre;
    err = md::edge_pair_prep(c.weights, a.x, t, ws.np, ws.gpre, B, N, Dn, De, I, G, Do, s);
    if (err != cudaSuccess) return err;
    ++*launched;
  }

  const int BN = B * N, P = BN * N;
  const int tiles = BN * a.nch, ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  const size_t ps = pair_smem(De, I), ns = node_smem(Dn, I);
  err = cudaFuncSetAttribute(edge_bwd_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ps));
  if (err != cudaSuccess) return err;
  for (int side = 0; side < 2; ++side) {
    edge_bwd_pair_kernel<<<tiles, md::kThreads, ps, s>>>(a, side);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  err = cudaFuncSetAttribute(edge_bwd_node_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ns));
  if (err != cudaSuccess) return err;
  edge_bwd_node_kernel<<<ntiles, md::kThreads, ns, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;

  // gradient outputs per chain, in the weights' order
  enum { Wb, Wn, W1, B1, S1, B1n, W2, B2, Wg1, Bg1, Sg1, Bg1n, Wg2, Bg2 };
  md::WgradJob jobs[14];
  float* job_out[14];
  for (int sd = 0; sd < 2; ++sd) {
    const SideWork& S = a.w[sd];
    md::WgradJob* j = jobs + 7 * sd;
    j[0] = {a.e, S.dbp, ws.slots[sd][0], P, De, I, De, I, 0};
    j[1] = {S.inter0, S.dh1, ws.slots[sd][1], P, I, I, I, I, 1};
    j[2] = {S.r1, S.dout, ws.slots[sd][2], P, I, Do, I, Do, 0};
    j[3] = {a.e, S.dg1, ws.slots[sd][3], P, De, G, De, G, 0};
    j[4] = {S.rg, S.dg2, ws.slots[sd][4], P, G, Do, G, Do, 0};
    j[5] = {a.x, S.dnp, ws.slots[sd][5], BN, Dn, I, Dn, I, 0};
    j[6] = {a.x, S.snode, ws.slots[sd][6], BN, Dn, G, Dn, G, 0};
    float** o = job_out + 7 * sd;
    o[0] = g[sd][Wb]; o[1] = g[sd][W1]; o[2] = g[sd][W2]; o[3] = g[sd][Wg1];
    o[4] = g[sd][Wg2]; o[5] = g[sd][Wn]; o[6] = g[sd][Wg1] + (size_t)De * G;
  }
  err = md::launch_wgrad(jobs, 14, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  md::ReduceJob red[30];
  int nr = 0;
  for (int k = 0; k < 14; ++k) {
    const int n = jobs[k].k1 * jobs[k].k2;
    red[nr++] = {jobs[k].slots, job_out[k], md::wgrad_slices(jobs[k].rows), n, n};
  }
  const int vec_out[kVecs] = {B2, Bg2, Bg1, Sg1, Bg1n, B1, S1, B1n};
  const int vec_n[kVecs] = {Do, Do, G, G, G, I, I, I};
  for (int sd = 0; sd < 2; ++sd)
    for (int v = 0; v < kVecs; ++v)
      red[nr++] = {a.w[sd].vecpart + (size_t)v * I, g[sd][vec_out[v]], tiles, vec_n[v],
                   kVecs * I};
  err = md::launch_reduce(red, nr, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  // d_time = left + right; each gate weight's time row
  const size_t trow = (size_t)(De + Dn) * G;
  for (int sd = 0; sd < 2; ++sd) {
    err = md::launch_time(a.w[sd].vecpart + (size_t)kBg1 * I, kVecs * I, N * a.nch, G, B,
                          a.side[sd].wg1 + trow, t, d_time, g[sd][Wg1] + trow, sd, s);
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

}  // namespace md

extern "C" {

long long md_edge_pair_backward_workspace(int B, int N, int Dn, int De, int I, int G, int Do) {
  return (long long)md::edge_chain_bwd_bytes(B, N, Dn, De, I, G, Do);
}

// p: 14 left and 14 right weights (BondFfn order), e, x, mask, t, dt_ct,
// du_ct, then the outputs d_bond, d_node, d_time, d_mask and the 28 float32
// parameter gradients in the weights' order (each gate's first-layer weight
// as one [De+Dn+1, G] matrix), then the workspace
// (md_edge_pair_backward_workspace bytes).
int md_edge_pair_backward(const void* const* p, int B, int N, int Dn, int De, int I, int G,
                          int Do, void* stream, int* launched) {
  float* grads[28];
  for (int k = 0; k < 28; ++k) grads[k] = static_cast<float*>(const_cast<void*>(p[38 + k]));
  md::EdgeChainBwd c = {};
  c.weights = p;
  c.e = static_cast<const bf16*>(p[28]);
  c.x = static_cast<const bf16*>(p[29]);
  c.mask = static_cast<const float*>(p[30]);
  c.t = static_cast<const float*>(p[31]);
  c.ct16[0] = static_cast<const bf16*>(p[32]);
  c.ct16[1] = static_cast<const bf16*>(p[33]);
  c.d_bond = static_cast<bf16*>(const_cast<void*>(p[34]));
  c.d_node = static_cast<bf16*>(const_cast<void*>(p[35]));
  c.d_time = static_cast<float*>(const_cast<void*>(p[36]));
  c.d_mask = static_cast<float*>(const_cast<void*>(p[37]));
  c.grads = grads;
  c.workspace = const_cast<void*>(p[66]);
  *launched = 0;
  return md::edge_chain_bwd(c, B, N, Dn, De, I, G, Do, static_cast<cudaStream_t>(stream),
                            launched);
}

}  // extern "C"
