// PosUpdate, backward, for Hopper (sm_90a).
//
// Replaces moldiff_tpu/ops/pallas_kernels.py:_pos_update_bwd_kernel
// (launched by _pallas_pos_update_bwd): given the cotangent ct [B,N,3] of
// pos_update.cu's force sum it recomputes the chain per pair (the node MLPs
// L and R, xp = bf16(L[i] R[j]), the gated BondFFN of interior width I and
// its one weight w per pair, the force factors q = 1/d', r = 1/(d'+1)) and
// returns d_node [B,N,Dn] and d_edge [B,N,N,De] (bf16), d_rel [B,N,N,3],
// d_dist [B,N,N], d_time [B] and d_mask [B,N,N] (float32), and the 26
// parameter gradients (float32; the gate's first-layer weight as one
// [De+Dl+1, G] matrix), with the Pallas body's roundings: the recomputed
// sigmoid and message in float32, every cotangent rounded to bf16 where the
// Pallas body casts it before a product with a weight.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), Dn = I = 256,
// De = Dl = 64, G = 32: per pair the recompute (about 0.2 MFLOP), the
// input-gradient products (the same shapes transposed) and the
// weight-gradient products (A^T B of e, xp and inter0 against d_bp, d_np,
// d_h1 and d_g1) come to about 0.6 MFLOP; chip_smoke.py work() counts them
// for the call. Bound by operations.
//
// Design.
// - The weight w is a scalar per pair: the inter MLP's and the gate's last
//   layers are warp dot products in the forward, and in the backward an
//   outer product (d_r1 = bf16(d_out) w2) and column sums (d_w2 = sum r1
//   d_out), so one warp does a pair row's whole LayerNorm, relu, last
//   layer, force backward and LayerNorm backward of both MLPs in registers.
// - Node sums cross tiles both ways: d_L[i] sums d_xp[i,j] R[j] over j and
//   d_R[j] sums d_xp[i,j] L[i] over i. The pair kernel (one CTA per row i
//   and a chunk of at most 32 columns) writes d_xp per pair in float32, and
//   a node kernel (one CTA per 32 nodes) forms both sums in order, then the
//   two node MLPs' backward and d_node. No element has two writers.
// - Parameter gradients go through grad.cu as in edge_pair_bwd.cu: the pair
//   and node kernels write the operands of each A^T B (about 4.6 KB per
//   pair at flagship widths), the weight-gradient kernel forms them in
//   split-K slots, and the reduction adds slots and per-tile column sums in
//   a fixed order. No float atomics.
// Launches per call: prep (pos_update.cu), pair, node, weight gradients,
// reduction, time = 6.
#include "grad.cuh"

using md::bf16;

namespace {

constexpr int kVecs = 10;  // per-tile column sums of the pair kernel, in this order:
enum { kB1 = 0, kS1, kB1n, kW2, kBg1, kSg1, kBg1n, kWg2, kB2, kBg2 };
constexpr int kNodeVecs = 4;  // per node tile and side: b1, s1, b1n, b2

struct Mlp {
  // Linear(Dn,Dl), LN(Dl), Linear(Dl,Dl)
  const bf16 *w1, *b1, *s1, *b1n, *w2, *b2;
};

struct BondFfn {
  const bf16 *wb, *wn, *w1, *b1, *s1, *b1n, *w2, *b2, *wg1, *bg1, *sg1, *bg1n, *wg2, *bg2;
};

struct PosBwdArgs {
  Mlp side[2];
  BondFfn f;
  const bf16* x;       // [B,N,Dn]
  const bf16* e;       // [B,N,N,De]
  const float* rel;    // [B,N,N,3]
  const float* dist;   // [B,N,N]
  const float* mask;   // [B,N,N]
  const float* t;      // [B]
  const float* ct;     // [B,N,3]
  bf16* d_node;        // [B,N,Dn]
  bf16* d_edge;        // [B,N,N,De]
  float* d_rel;        // [B,N,N,3]
  float* d_dist;       // [B,N,N]
  float* d_mask;       // [B,N,N]
  // workspace
  bf16* lr;            // [2,B*N,Dl] L and R
  float* inter0;       // [P,I]
  float* dh1;          // [P,I]
  float* dbp;          // [P,I]
  float* dnp;          // [P,I]
  float* dg1;          // [P,G]
  bf16* xp;            // [P,Dl]
  float* dxp;          // [P,Dl]
  float* vecpart;      // [tiles, kVecs, I]
  float* dout;         // [2,B*N,Dl] d_L, d_R
  bf16* r1n;           // [2,B*N,Dl]
  float* dh1n;         // [2,B*N,Dl]
  float* nodepart;     // [node tiles, 2, kNodeVecs, Dl]
  int B, N, Dn, De, Dl, I, G, nch;
};

__host__ inline size_t pair_smem(int De, int Dl, int I, int G) {
  return md::smem_bytes(md::kBwdRows, De + 8, 2) + md::smem_bytes(md::kBwdRows, Dl + 8, 2) +
         2 * md::smem_bytes(md::kBwdRows, I + 8, 2) + md::smem_bytes(md::kBwdRows, G + 8, 2) +
         4 * md::smem_bytes(md::kBwdRows, I + 4, 4);
}

__host__ inline size_t node_smem(int Dn, int Dl) {
  return md::smem_bytes(md::kBwdRows, Dn + 8, 2) + 2 * md::smem_bytes(md::kBwdRows, Dl + 8, 2) +
         3 * md::smem_bytes(md::kBwdRows, Dl + 4, 4) + md::smem_bytes(md::kBwdRows, Dn + 4, 4) +
         (size_t)md::kWarps * kNodeVecs * Dl * sizeof(float);
}

// One CTA per (molecule b, receiver i, chunk of at most 32 senders): row r
// of the tile is the pair (i, m0 + r).
__global__ void __launch_bounds__(md::kThreads) pos_bwd_pair_kernel(const PosBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, De = a.De, Dl = a.Dl, I = a.I, G = a.G;
  const int lde = De + 8, ldx = Dl + 8, ldb = I + 8, ldg = G + 8, ldf = I + 4;
  size_t off = 0;
  bf16* sE = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, lde, 2);
  bf16* sXp = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldx, 2);
  bf16* XA = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldb, 2);
  bf16* XB = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldb, 2);
  bf16* XG = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldg, 2);
  float* F[4];
  for (int k = 0; k < 4; ++k) {
    F[k] = reinterpret_cast<float*>(smem + off);
    off += md::smem_bytes(md::kBwdRows, ldf, 4);
  }
  float* sPart = F[2];  // column-sum scratch once h1 is consumed

  const BondFfn& W = a.f;
  const int tile = blockIdx.x;
  const int node = tile / a.nch, chunk = tile % a.nch;
  const int b = node / N;
  const int m0 = chunk * md::kBwdRows;
  const int ri = min(md::kBwdRows, N - m0);
  const int mt = (ri + 15) / 16, rp = mt * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int iq = I / 32, gq = G / 32;
  const size_t BN = (size_t)a.B * N;
  const size_t pair0 = (size_t)node * N + m0;
  const bf16* lft = a.lr + (size_t)node * Dl;
  const bf16* rgt = a.lr + (BN + (size_t)b * N + m0) * Dl;
  const bf16* wg1x = W.wg1 + (size_t)De * G;
  const bf16* wg1t = W.wg1 + (size_t)(De + Dl) * G;

  // ---- forward recompute ----------------------------------------------------
  md::load_rows(sE, lde, ri, rp, De, [&](int r) { return a.e + (pair0 + r) * De; });
  for (int idx = threadIdx.x; idx < rp * Dl; idx += blockDim.x) {
    const int r = idx / Dl, c = idx % Dl;
    bf16 v = md::tobf(0.0f);
    if (r < ri) {
      v = md::tobf(md::bf(lft[c]) * md::bf(rgt[(size_t)r * Dl + c]));
      a.xp[(pair0 + r) * Dl + c] = v;
    }
    sXp[r * ldx + c] = v;
  }
  __syncthreads();
  md::cta_gemm(sE, lde, W.wb, De, I, F[0], ldf, mt, md::kStore);   // bp
  md::cta_gemm(sXp, ldx, W.wn, Dl, I, F[1], ldf, mt, md::kStore);  // np
  md::cta_gemm(sE, lde, W.wg1, De, G, F[3], ldf, mt, md::kStore);  // gate, e part
  __syncthreads();
  md::cta_gemm(sXp, ldx, wg1x, Dl, G, F[3], ldf, mt, md::kAdd);    // gate, xp part
  for (int idx = threadIdx.x; idx < rp * I; idx += blockDim.x) {
    const int r = idx / I, c = idx % I;
    const float inter0 = F[0][r * ldf + c] * F[1][r * ldf + c];
    XA[r * ldb + c] = md::tobf(inter0);
    if (r < ri) a.inter0[(pair0 + r) * I + c] = inter0;
  }
  __syncthreads();
  md::cta_gemm(XA, ldb, W.w1, I, I, F[2], ldf, mt, md::kStore);    // h1 - b1
  __syncthreads();

  // ---- per pair row: the two one-column layers, the force backward and the
  // LayerNorm backward of both MLPs, one warp per row -------------------------
  const float tb = a.t[b];
  const float* ct = a.ct + (size_t)node * 3;
  const float c0 = ct[0], c1 = ct[1], c2 = ct[2];
  float accI[4][md::kMaxPerLane] = {};  // b1, s1, b1n, w2
  float accG[4][md::kMaxPerLane] = {};  // bg1, sg1, bg1n, wg2
  float accS[2][md::kMaxPerLane] = {};  // b2, bg2 (lane 0, column 0)
  for (int r = warp; r < rp; r += md::kWarps) {
    float xh[md::kMaxPerLane], r1v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < iq) xh[q] = F[2][r * ldf + lane + 32 * q] + md::bf(W.b1[lane + 32 * q]);
    const float inv1 = md::warp_ln_stats(xh, iq);
    float out = 0.0f;
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < iq) {
        const int c = lane + 32 * q;
        r1v[q] = md::rbf(fmaxf(xh[q] * md::bf(W.s1[c]) + md::bf(W.b1n[c]), 0.0f));
        out += r1v[q] * md::bf(W.w2[c]);
      }
    out = md::warp_sum(out) + md::bf(W.b2[0]);

    float xg[md::kMaxPerLane], rgv[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < gq) {
        const int c = lane + 32 * q;
        xg[q] = F[3][r * ldf + c] + tb * md::bf(wg1t[c]) + md::bf(W.bg1[c]);
      }
    const float invg = md::warp_ln_stats(xg, gq);
    float g2 = 0.0f;
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < gq) {
        const int c = lane + 32 * q;
        rgv[q] = md::rbf(fmaxf(xg[q] * md::bf(W.sg1[c]) + md::bf(W.bg1n[c]), 0.0f));
        g2 += rgv[q] * md::bf(W.wg2[c]);
      }
    const float sig = md::sigmoidf(md::warp_sum(g2) + md::bf(W.bg2[0]));
    const float w = out * sig;

    // force backward
    float d_w = 0.0f;
    if (r < ri) {
      const size_t p = pair0 + r;
      const float m = a.mask[p];
      const float d = m > 0.0f ? a.dist[p] : 1.0f;
      const float qq = 1.0f / d, rr = 1.0f / (d + 1.0f), qr = qq * rr;
      const float* rv = a.rel + p * 3;
      const float cdr = c0 * rv[0] + c1 * rv[1] + c2 * rv[2];
      d_w = cdr * qr * m;
      if (lane < 3) a.d_rel[p * 3 + lane] = (lane == 0 ? c0 : lane == 1 ? c1 : c2) * w * qr * m;
      if (lane == 0) {
        a.d_mask[p] = cdr * w * qr;
        a.d_dist[p] = cdr * w * m * (-qr) * (qq + rr);
      }
    }
    const float d_out = d_w * sig;
    const float d_g2 = d_w * out * sig * (1.0f - sig);
    if (lane == 0) {
      accS[0][0] += d_out;
      accS[1][0] += d_g2;
    }

    // gate: d_rg = bf16(d_g2) wg2, relu, LayerNorm backward -> d_g1
    float dy[md::kMaxPerLane];
    const float dg2r = md::rbf(d_g2);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < gq) {
        const int c = lane + 32 * q;
        const float ln = xg[q] * md::bf(W.sg1[c]) + md::bf(W.bg1n[c]);
        dy[q] = ln > 0.0f ? dg2r * md::bf(W.wg2[c]) : 0.0f;
        accG[1][q] += dy[q] * xg[q];
        accG[2][q] += dy[q];
        accG[3][q] += rgv[q] * d_g2;
      }
    md::warp_ln_bwd(dy, xg, invg, gq, W.sg1, lane);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < gq) {
        const int c = lane + 32 * q;
        accG[0][q] += dy[q];
        XG[r * ldg + c] = md::tobf(dy[q]);
        if (r < ri) a.dg1[(pair0 + r) * G + c] = dy[q];
      }

    // inter MLP: d_r1 = bf16(d_out) w2, relu, LayerNorm backward -> d_h1
    const float dor = md::rbf(d_out);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < iq) {
        const int c = lane + 32 * q;
        const float ln = xh[q] * md::bf(W.s1[c]) + md::bf(W.b1n[c]);
        dy[q] = ln > 0.0f ? dor * md::bf(W.w2[c]) : 0.0f;
        accI[1][q] += dy[q] * xh[q];
        accI[2][q] += dy[q];
        accI[3][q] += r1v[q] * d_out;
      }
    md::warp_ln_bwd(dy, xh, inv1, iq, W.s1, lane);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < iq) {
        const int c = lane + 32 * q;
        accI[0][q] += dy[q];
        XB[r * ldb + c] = md::tobf(dy[q]);
        if (r < ri) a.dh1[(pair0 + r) * I + c] = dy[q];
      }
  }
  __syncthreads();
  float* vpart = a.vecpart + (size_t)tile * kVecs * I;
  md::flush_columns<4>(accI, iq, sPart, vpart + kB1 * I, I);
  md::flush_columns<4>(accG, gq, sPart, vpart + kBg1 * I, I);
  md::flush_columns<2>(accS, 1, sPart, vpart + kB2 * I, I);

  // ---- input-gradient products ----------------------------------------------
  md::cta_gemm_t(XG, nullptr, ldg, W.wg1, G, De, F[3], ldf, mt, md::kStore);  // d_e (gate)
  md::cta_gemm_t(XB, nullptr, ldb, W.w1, I, I, F[2], ldf, mt, md::kStore);    // d_inter0
  __syncthreads();
  for (int idx = threadIdx.x; idx < rp * I; idx += blockDim.x) {
    const int r = idx / I, c = idx % I;
    const float di = F[2][r * ldf + c];
    const float dbp = di * F[1][r * ldf + c];
    const float dnp = di * F[0][r * ldf + c];
    XA[r * ldb + c] = md::tobf(dbp);
    XB[r * ldb + c] = md::tobf(dnp);
    if (r < ri) {
      a.dbp[(pair0 + r) * I + c] = dbp;
      a.dnp[(pair0 + r) * I + c] = dnp;
    }
  }
  __syncthreads();
  md::cta_gemm_t(XA, nullptr, ldb, W.wb, I, De, F[3], ldf, mt, md::kAdd);     // d_e (inter)
  md::cta_gemm_t(XB, nullptr, ldb, W.wn, I, Dl, F[0], ldf, mt, md::kStore);   // d_xp (inter)
  __syncthreads();
  md::cta_gemm_t(XG, nullptr, ldg, wg1x, G, Dl, F[0], ldf, mt, md::kAdd);     // d_xp (gate)
  __syncthreads();
  for (int idx = threadIdx.x; idx < ri * De; idx += blockDim.x) {
    const int r = idx / De, c = idx % De;
    a.d_edge[(pair0 + r) * De + c] = md::tobf(F[3][r * ldf + c]);
  }
  for (int idx = threadIdx.x; idx < ri * Dl; idx += blockDim.x) {
    const int r = idx / Dl, c = idx % Dl;
    a.dxp[(pair0 + r) * Dl + c] = F[0][r * ldf + c];
  }
}

// One CTA per 32 nodes: d_L and d_R from d_xp, the backward of both node
// MLPs (recomputed), and d_node.
__global__ void __launch_bounds__(md::kThreads) pos_bwd_node_kernel(const PosBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, Dn = a.Dn, Dl = a.Dl;
  const int ldx = Dn + 8, ldd = Dl + 8, ldl = Dl + 4, ldn = Dn + 4;
  size_t off = 0;
  bf16* sX = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldx, 2);
  bf16* XD = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldd, 2);
  bf16* XH = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldd, 2);
  float* FA = reinterpret_cast<float*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldl, 4);
  float* FB = reinterpret_cast<float*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldl, 4);
  float* FD = reinterpret_cast<float*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldl, 4);
  float* FX = reinterpret_cast<float*>(smem + off);
  off += md::smem_bytes(md::kBwdRows, ldn, 4);
  float* sPart = reinterpret_cast<float*>(smem + off);

  const int total = a.B * N;
  const int n0 = blockIdx.x * md::kBwdRows;
  const int rows = min(md::kBwdRows, total - n0);
  const int mt = (rows + 15) / 16, rp = mt * 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int dq = Dl / 32;
  const size_t BN = (size_t)total;

  md::load_rows(sX, ldx, rows, rp, Dn, [&](int r) { return a.x + (size_t)(n0 + r) * Dn; });
  for (int side = 0; side < 2; ++side) {
    const Mlp& W = a.side[side];
    // d_L[i] = sum_j d_xp[i,j] R[j];  d_R[j] = sum_i d_xp[i,j] L[i]
    const bf16* other = a.lr + (side == 0 ? BN : 0) * Dl;
    for (int idx = threadIdx.x; idx < rp * Dl; idx += blockDim.x) {
      const int r = idx / Dl, c = idx % Dl;
      float s = 0.0f;
      if (r < rows) {
        const int nd = n0 + r, b = nd / N, k = nd % N;
        const size_t mol = (size_t)b * N;
        for (int j = 0; j < N; ++j) {
          const size_t p = side == 0 ? ((size_t)nd * N + j) : ((mol + j) * N + k);
          s += a.dxp[p * Dl + c] * md::bf(other[(mol + j) * Dl + c]);
        }
        a.dout[((size_t)side * BN + nd) * Dl + c] = s;
      }
      FD[r * ldl + c] = s;
      XD[r * ldd + c] = md::tobf(s);
    }
    __syncthreads();
    md::cta_gemm(sX, ldx, W.w1, Dn, Dl, FA, ldl, mt, md::kStore);               // h1 - b1
    md::cta_gemm_t(XD, nullptr, ldd, W.w2, Dl, Dl, FB, ldl, mt, md::kStore);    // d_r1
    __syncthreads();
    float acc[kNodeVecs][md::kMaxPerLane] = {};  // b1, s1, b1n, b2
    for (int r = warp; r < rp; r += md::kWarps) {
      float xh[md::kMaxPerLane], dy[md::kMaxPerLane];
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < dq) xh[q] = FA[r * ldl + lane + 32 * q] + md::bf(W.b1[lane + 32 * q]);
      const float inv = md::warp_ln_stats(xh, dq);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < dq) {
          const int c = lane + 32 * q;
          const float ln = xh[q] * md::bf(W.s1[c]) + md::bf(W.b1n[c]);
          if (r < rows) a.r1n[((size_t)side * BN + n0 + r) * Dl + c] = md::tobf(fmaxf(ln, 0.0f));
          dy[q] = ln > 0.0f ? FB[r * ldl + c] : 0.0f;
          acc[1][q] += dy[q] * xh[q];
          acc[2][q] += dy[q];
          acc[3][q] += FD[r * ldl + c];
        }
      md::warp_ln_bwd(dy, xh, inv, dq, W.s1, lane);
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < dq) {
          const int c = lane + 32 * q;
          acc[0][q] += dy[q];
          XH[r * ldd + c] = md::tobf(dy[q]);
          if (r < rows) a.dh1n[((size_t)side * BN + n0 + r) * Dl + c] = dy[q];
        }
    }
    md::flush_columns<kNodeVecs>(
        acc, dq, sPart, a.nodepart + ((size_t)blockIdx.x * 2 + side) * kNodeVecs * Dl, Dl);
    md::cta_gemm_t(XH, nullptr, ldd, W.w1, Dl, Dn, FX, ldn, mt,
                   side == 0 ? md::kStore : md::kAdd);                          // d_x
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < rows * Dn; idx += blockDim.x) {
    const int r = idx / Dn, c = idx % Dn;
    a.d_node[(size_t)(n0 + r) * Dn + c] = md::tobf(FX[r * ldn + c]);
  }
}

struct PosBwdWork {
  float* slots[9];
  size_t bytes;
};

PosBwdWork carve(PosBwdArgs& a, unsigned char* base, int B, int N, int Dn, int De, int Dl,
                 int I, int G) {
  md::Carve cv{base};
  const size_t P = (size_t)B * N * N, BN = (size_t)B * N;
  const int nch = (N + md::kBwdRows - 1) / md::kBwdRows;
  const size_t tiles = BN * nch, ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  a.lr = cv.take<bf16>(2 * BN * Dl);
  a.inter0 = cv.take<float>(P * I);
  a.dh1 = cv.take<float>(P * I);
  a.dbp = cv.take<float>(P * I);
  a.dnp = cv.take<float>(P * I);
  a.dg1 = cv.take<float>(P * G);
  a.xp = cv.take<bf16>(P * Dl);
  a.dxp = cv.take<float>(P * Dl);
  a.vecpart = cv.take<float>(tiles * kVecs * I);
  a.dout = cv.take<float>(2 * BN * Dl);
  a.r1n = cv.take<bf16>(2 * BN * Dl);
  a.dh1n = cv.take<float>(2 * BN * Dl);
  a.nodepart = cv.take<float>(ntiles * 2 * kNodeVecs * Dl);
  const int P_ = (int)P, BN_ = (int)BN;
  const int dims[9][3] = {{P_, De, I}, {P_, Dl, I},  {P_, I, I},    {P_, De, G},   {P_, Dl, G},
                          {BN_, Dn, Dl}, {BN_, Dl, Dl}, {BN_, Dn, Dl}, {BN_, Dl, Dl}};
  PosBwdWork w;
  for (int k = 0; k < 9; ++k)
    w.slots[k] = cv.take<float>(md::wgrad_slot_floats(dims[k][0], dims[k][1], dims[k][2]));
  a.nch = nch;
  w.bytes = cv.off;
  return w;
}

}  // namespace

extern "C" {

long long md_pos_update_backward_workspace(int B, int N, int Dn, int De, int Dl, int I, int G) {
  PosBwdArgs a = {};
  return (long long)carve(a, nullptr, B, N, Dn, De, Dl, I, G).bytes;
}

// p: 6 left-MLP, 6 right-MLP and 14 edge_lin weights (BondFfn order), x, e,
// rel, dist, mask, t, ct, then the outputs d_node, d_edge, d_rel, d_dist,
// d_time, d_mask and the 26 float32 parameter gradients in the weights'
// order (the gate's first-layer weight as one [De+Dl+1, G] matrix), then
// the workspace (md_pos_update_backward_workspace bytes).
int md_pos_update_backward(const void* const* p, int B, int N, int Dn, int De, int Dl, int I,
                           int G, void* stream, int* launched) {
  PosBwdArgs a = {};
  const bf16** w = &a.side[0].w1;
  for (int k = 0; k < 26; ++k) w[k] = static_cast<const bf16*>(p[k]);
  a.x = static_cast<const bf16*>(p[26]);
  a.e = static_cast<const bf16*>(p[27]);
  a.rel = static_cast<const float*>(p[28]);
  a.dist = static_cast<const float*>(p[29]);
  a.mask = static_cast<const float*>(p[30]);
  a.t = static_cast<const float*>(p[31]);
  a.ct = static_cast<const float*>(p[32]);
  a.d_node = static_cast<bf16*>(const_cast<void*>(p[33]));
  a.d_edge = static_cast<bf16*>(const_cast<void*>(p[34]));
  a.d_rel = static_cast<float*>(const_cast<void*>(p[35]));
  a.d_dist = static_cast<float*>(const_cast<void*>(p[36]));
  float* d_time = static_cast<float*>(const_cast<void*>(p[37]));
  a.d_mask = static_cast<float*>(const_cast<void*>(p[38]));
  float* g[26];
  for (int k = 0; k < 26; ++k) g[k] = static_cast<float*>(const_cast<void*>(p[39 + k]));
  PosBwdWork ws = carve(a, static_cast<unsigned char*>(const_cast<void*>(p[65])), B, N, Dn, De,
                        Dl, I, G);
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.Dl = Dl; a.I = I; a.G = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;

  cudaError_t err = md::pos_update_prep(p, a.x, a.lr, B, N, Dn, Dl, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  const int BN = B * N, P = BN * N;
  const int tiles = BN * a.nch, ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  const size_t ps = pair_smem(De, Dl, I, G), ns = node_smem(Dn, Dl);
  err = cudaFuncSetAttribute(pos_bwd_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ps));
  if (err != cudaSuccess) return err;
  pos_bwd_pair_kernel<<<tiles, md::kThreads, ps, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;
  err = cudaFuncSetAttribute(pos_bwd_node_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(ns));
  if (err != cudaSuccess) return err;
  pos_bwd_node_kernel<<<ntiles, md::kThreads, ns, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;

  // gradient outputs in the weights' order: left MLP 0-5, right 6-11, edge_lin 12-25
  enum { W1 = 0, B1, S1, B1n, W2, B2 };
  enum { FWb = 12, FWn, FW1, FB1, FS1, FB1n, FW2, FB2, FWg1, FBg1, FSg1, FBg1n, FWg2, FBg2 };
  const size_t BNs = (size_t)BN;
  md::WgradJob jobs[9] = {
      {a.e, a.dbp, ws.slots[0], P, De, I, De, I, 0},
      {a.xp, a.dnp, ws.slots[1], P, Dl, I, Dl, I, 0},
      {a.inter0, a.dh1, ws.slots[2], P, I, I, I, I, 1},
      {a.e, a.dg1, ws.slots[3], P, De, G, De, G, 0},
      {a.xp, a.dg1, ws.slots[4], P, Dl, G, Dl, G, 0},
      {a.x, a.dh1n, ws.slots[5], BN, Dn, Dl, Dn, Dl, 0},
      {a.r1n, a.dout, ws.slots[6], BN, Dl, Dl, Dl, Dl, 0},
      {a.x, a.dh1n + BNs * Dl, ws.slots[7], BN, Dn, Dl, Dn, Dl, 0},
      {a.r1n + BNs * Dl, a.dout + BNs * Dl, ws.slots[8], BN, Dl, Dl, Dl, Dl, 0},
  };
  float* job_out[9] = {g[FWb], g[FWn], g[FW1], g[FWg1], g[FWg1] + (size_t)De * G,
                       g[W1], g[W2], g[6 + W1], g[6 + W2]};
  err = md::launch_wgrad(jobs, 9, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  md::ReduceJob red[27];
  int nr = 0;
  for (int k = 0; k < 9; ++k) {
    const int n = jobs[k].k1 * jobs[k].k2;
    red[nr++] = {jobs[k].slots, job_out[k], md::wgrad_slices(jobs[k].rows), n, n};
  }
  const int vec_out[kVecs] = {FB1, FS1, FB1n, FW2, FBg1, FSg1, FBg1n, FWg2, FB2, FBg2};
  const int vec_n[kVecs] = {I, I, I, I, G, G, G, G, 1, 1};
  for (int v = 0; v < kVecs; ++v)
    red[nr++] = {a.vecpart + (size_t)v * I, g[vec_out[v]], tiles, vec_n[v], kVecs * I};
  const int node_out[kNodeVecs] = {B1, S1, B1n, B2};
  for (int sd = 0; sd < 2; ++sd)
    for (int v = 0; v < kNodeVecs; ++v)
      red[nr++] = {a.nodepart + (size_t)(sd * kNodeVecs + v) * Dl, g[6 * sd + node_out[v]],
                   ntiles, Dl, 2 * kNodeVecs * Dl};
  err = md::launch_reduce(red, nr, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  // d_time and the gate weight's time row
  const size_t trow = (size_t)(De + Dl) * G;
  err = md::launch_time(a.vecpart + (size_t)kBg1 * I, kVecs * I, N * a.nch, G, B, a.f.wg1 + trow,
                        a.t, d_time, g[FWg1] + trow, 0, s);
  if (err != cudaSuccess) return err;
  ++*launched;
  return cudaSuccess;
}

}  // extern "C"
