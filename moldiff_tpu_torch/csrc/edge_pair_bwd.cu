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
// forward's products) and the input-gradient products (the same shapes
// transposed) come to about 0.25 MFLOP, the weight-gradient products (A^T B
// for five pair matrices, one of them with a float32 A) to about 0.2
// MFLOP more; chip_smoke.py work() counts them for the call, in both
// modes. Bound by operations.
//
// Design (redesigned for Hopper's tensor cores). The left chain's cotangent
// broadcasts back over rows and its node sums (the gate's x part,
// node_linear) run over columns, so a left-chain tile owns rows i and holds
// all their columns; the right chain owns columns (the opposite of the
// forward's split). The pairs are taken in owned-node-major order (row rho
// = (b * N + k) * N + m) and cut into tiles of 64 rows, one wgmma M,
// holding whole and partial owned nodes, so no row idles (N = 32: two
// whole nodes; N = 40: parts of two or three). A CTA is two warpgroups;
// every product of the chain runs as wgmma with the 64-row activation tile
// as A and a weight as B, the warpgroups splitting the output columns, the
// weights' K-slices staged by cp.async into a double-buffered ring shared
// by both, the accumulators in registers (bp, kept for d_np, included).
// The epilogues (LayerNorm forward and backward, sigmoid and relu gates,
// the cotangents) run on the registers; only the bf16 A operand of the
// next product goes to shared memory. The node sums close per owned node
// inside the CTA in a fixed order, in two parts (the tile of the node's
// first row, the next one), and a node-level kernel adds the parts and
// forms d_node. The two chains are two launches of one pair kernel: the
// first writes its d_bond and d_mask terms in float32, the second adds its
// own and writes the results, so every element is written by one CTA and
// nothing races.
//
// Two modes, as node_block_bwd.cu: with parameter gradients the pair
// kernel also writes, in tile order, the per-pair operands of grad.cu's
// weight-gradient product (bf16, float32 ones as hi + lo planes; the right
// chain also e in its order) and per-tile column sums.
// Launches: prep (edge_pair.cu), pair x 2, node, weight gradients, time,
// reduction = 7. Inputs only: prep, pair x 2, node, and the time kernel if
// d_time is asked for = 5 (4 without). The chains' backward
// (md::edge_chain_bwd) also serves the full-EdgeBlock backward
// (edge_block_full.cu), which gives it float32 cotangents, its own prep
// and the tail's terms of d_bond and d_node.
#include "grad.cuh"
#include "wgmma.cuh"

using md::bf16;
namespace wg = md::wg;

namespace {

constexpr int kVecs = 7;  // per-tile column sums for the parameter gradients, in this order:
enum { kB2 = 0, kBg2, kSg1, kBg1n, kB1, kS1, kB1n };

struct BondFfn {
  const bf16 *wb, *wn, *w1, *b1, *s1, *b1n, *w2, *b2, *wg1, *bg1, *sg1, *bg1n, *wg2, *bg2;
};

// per-chain buffers
struct SideWork {
  float* nppart;     // [B*N, 2, I] per owned node: sum of d_inter0 * bp, in two
                     // parts (the tile of its first row, the next tile)
  float* sendpart;   // [B*N, 2, G] the same for d_g1
  float* ssum;       // [B*N, G] the two parts of sendpart added
  // for the weight gradients (need_params), per pair in tile order
  bf16* eT;          // [P, De] e in the right chain's order (side 1)
  md::Split inter0;  // [P, I]
  bf16* r1;          // [P, I]
  bf16* rg;          // [P, G]
  md::Split dh1;     // [P, I]
  md::Split dout;    // [P, Do]
  md::Split dg2;     // [P, Do]
  md::Split dg1;     // [P, G]
  md::Split dbp;     // [P, I]
  float* vecpart;    // [tiles, kVecs, I]
  md::Split snode;   // [B*N, G]
  md::Split dnp;     // [B*N, I]
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
  int B, N, Dn, De, I, G, Do;
  int need_params;
};

template <int DE, int I>
constexpr size_t pair_smem() {
  return (size_t)wg::kTileRows * (DE + 3 * I) * sizeof(bf16) +
         (size_t)2 * wg::kSlice * wg::kRingCols * sizeof(bf16) +
         (size_t)(2 * 64 * 2 + 4 * I) * sizeof(float);
}

__host__ inline size_t node_smem(int Dn, int I) {
  return 2 * md::smem_bytes(md::kBwdRows, I + 8, 2) + md::smem_bytes(md::kBwdRows, Dn + 4, 4);
}

// One CTA (two warpgroups) per tile of 64 consecutive rows of one chain:
// row rho = (b * N + k) * N + m is the pair of owned node k and partner m
// of molecule b, (k, m) for the left chain (side 0), (m, k) for the right
// one; the chain's node features are k's, its cotangent row is m's.
template <int DE, int I, int G, int DO>
__global__ void __launch_bounds__(256, 1) edge_bwd_pair_kernel(const EdgeBwdArgs a,
                                                               const int side) {
  constexpr int R = wg::kTileRows;
  constexpr int NI = I / 2, AI = NI / 2, NO = DO / 2, AO = NO / 2;
  constexpr int NG = G / 2, AG = NG / 2, NE = DE / 2, AE = NE / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sE = reinterpret_cast<bf16*>(smem);
  bf16* XI = sE + R * DE;   // bf16(inter0), kept for the recompute of h1
  bf16* XA = XI + R * I;
  bf16* XG = XA + R * I;
  bf16* ring = XG + R * I;
  float* red = reinterpret_cast<float*>(ring + 2 * wg::kSlice * wg::kRingCols);
  float* part = red + 2 * 64 * 2;

  const BondFfn& W = a.side[side];
  const SideWork& S = a.w[side];
  const uint32_t N = a.N, NN = N * N;
  const uint32_t rho0 = blockIdx.x * R;
  const int nv = min((uint32_t)R, a.B * NN - rho0);
  const uint32_t node0 = rho0 / N;
  const int nseg = (rho0 + nv - 1) / N - node0 + 1;
  const bool P = a.need_params;
  const size_t BN = (size_t)a.B * N;
  auto valid = [&](int r) { return r < nv; };
  // the per-pair operands' row: rho itself, so a tile's rows are
  // contiguous (the left chain's order is e's, the right chain's e's
  // transposed)
  auto at = [&](int r) { return rho0 + r; };
  auto pair = [&](int r) -> uint32_t {
    const uint32_t rho = rho0 + r;
    return side == 0 ? rho : (rho / NN * N + rho % N) * N + (rho / N) % N;
  };
  auto seg_tile = [&](int r) { return valid(r) ? 0 : -1; };
  auto seg_node = [&](int r) { return valid(r) ? (int)((rho0 + r) / N - node0) : -1; };
  auto vec = [&](int v) { return S.vecpart + ((size_t)blockIdx.x * kVecs + v) * I; };
  // an owned node's sums: part 0 from the tile of its first row, part 1
  // from the next
  auto per_node = [&](float* base, int width) {
    return [=](int s) {
      const uint32_t node = node0 + s;
      return base + ((size_t)node * 2 + (node * N < rho0 ? 1 : 0)) * width;
    };
  };
  const float* npk = a.np + side * BN * I;
  const float* gpk = a.gpre + side * BN * G;

  for (int idx = threadIdx.x; idx < R * (DE / 8); idx += blockDim.x) {
    const int r = idx / (DE / 8), c = (idx % (DE / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (valid(r)) v = *reinterpret_cast<const uint4*>(a.e + (size_t)pair(r) * DE + c);
    *reinterpret_cast<uint4*>(sE + wg::kmaj(r, c, DE)) = v;
  }
  if (P && side == 1) {  // e in the right chain's order, the A of two products
    __syncthreads();
    wg::tile_out(sE, DE, S.eT, valid, at);
  }

  const int g = threadIdx.x >> 7;
  auto colI = [&](int i) { return g * NI + wg::acc_col(i); };
  auto colO = [&](int i) { return g * NO + wg::acc_col(i); };
  auto colG = [&](int i) { return g * NG + wg::acc_col(i); };
  int rw[2];
  bool ok[2];
  uint32_t pr[2], nd[2], crow[2];  // pair and node indices (B * N * N < 2^32)
  float msk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rw[h] = wg::acc_row(2 * h);
    ok[h] = valid(rw[h]);
    const uint32_t rho = ok[h] ? rho0 + rw[h] : 0;
    pr[h] = ok[h] ? pair(rw[h]) : 0;
    nd[h] = rho / N;
    crow[h] = rho / NN * N + rho % N;
    msk[h] = ok[h] ? a.mask[pr[h]] : 0.0f;
  }
#define ROW(i) (((i) >> 1) & 1)
  float bp[AI], t1[AI], dr1[AI], ot[AO], st[AO], gt[AG], dg[AG], de[AE], inv[2], invg[2];

  // ---- forward recompute ----------------------------------------------------
  wg::cta_mma<NI, 0>(bp, sE, DE, W.wb, ring, false);  // bp, kept for d_np
#pragma unroll
  for (int i = 0; i < AI; i += 2) {
    const int c = colI(i), h = ROW(i);
    const float v0 = bp[i] * npk[nd[h] * I + c], v1 = bp[i + 1] * npk[nd[h] * I + c + 1];
    const int o = wg::kmaj(rw[h], c, I);
    const bf16 h0 = md::tobf(v0), h1 = md::tobf(v1);
    md::store2(XI + o, md::bf(h0), md::bf(h1));
    if (P) md::store2(ring + o, v0 - md::bf(h0), v1 - md::bf(h1));
  }
  if (P) {  // the operands as hi + lo planes; low halves staged in the ring
    __syncthreads();
    wg::tile_out(XI, I, S.inter0.hi, valid, at);
    wg::tile_out(ring, I, S.inter0.lo, valid, at);
    __syncthreads();
  }
  wg::cta_mma<NI, 0>(t1, XI, I, W.w1, ring, false);
#pragma unroll
  for (int i = 0; i < AI; ++i) t1[i] += md::bf(W.b1[colI(i)]);
  wg::ln_stats(t1, inv, I, red);
#pragma unroll
  for (int i = 0; i < AI; i += 2) {
    const int c = colI(i), h = ROW(i);
    const float r0 = fmaxf(t1[i] * md::bf(W.s1[c]) + md::bf(W.b1n[c]), 0.0f);
    const float r1 = fmaxf(t1[i + 1] * md::bf(W.s1[c + 1]) + md::bf(W.b1n[c + 1]), 0.0f);
    md::store2(XA + wg::kmaj(rw[h], c, I), r0, r1);
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XA, I, S.r1, valid, at);
  }
  wg::cta_mma<NO, 0>(ot, XA, I, W.w2, ring, false);    // out_i - b2
  wg::cta_mma<NG, 0>(gt, sE, DE, W.wg1, ring, false);  // gate, edge part
#pragma unroll
  for (int i = 0; i < AG; ++i) gt[i] += gpk[nd[ROW(i)] * G + colG(i)];
  wg::ln_stats(gt, invg, G, red);
#pragma unroll
  for (int i = 0; i < AG; i += 2) {
    const int c = colG(i), h = ROW(i);
    const float g0 = fmaxf(gt[i] * md::bf(W.sg1[c]) + md::bf(W.bg1n[c]), 0.0f);
    const float g1 = fmaxf(gt[i + 1] * md::bf(W.sg1[c + 1]) + md::bf(W.bg1n[c + 1]), 0.0f);
    md::store2(XG + wg::kmaj(rw[h], c, G), g0, g1);
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XG, G, S.rg, valid, at);
  }
  wg::cta_mma<NO, 0>(st, XG, G, W.wg2, ring, false);   // gate logits - bg2

  // ---- cotangents at the message: d_out (ot), d_g2 (st), d_mask -------------
  {
    float dm[2][1] = {};
#pragma unroll
    for (int i = 0; i < AO; ++i) {
      const int c = colO(i), h = ROW(i);
      const float sig = md::sigmoidf(st[i] + md::bf(W.bg2[c]));
      const float out = ot[i] + md::bf(W.b2[c]);
      float dr = 0.0f;
      if (ok[h])
        dr = a.ct32[side] ? a.ct32[side][crow[h] * DO + c] : md::bf(a.ct[side][crow[h] * DO + c]);
      dm[h][0] += dr * (out * sig);
      const float dmsg = dr * msk[h];
      ot[i] = dmsg * sig;
      st[i] = dmsg * out * sig * (1.0f - sig);
    }
    wg::row_sums<1>(dm, red);
    if (g == 0 && (threadIdx.x & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ok[h]) {
          if (side == 0)
            a.d_mask[pr[h]] = dm[h][0];
          else
            a.d_mask[pr[h]] += dm[h][0];
        }
  }
  if (P) {
    wg::col_sums<NO>([&](int i) { return ot[i]; }, 1, seg_tile, [&](int) { return vec(kB2); },
                     part);
    wg::col_sums<NO>([&](int i) { return st[i]; }, 1, seg_tile, [&](int) { return vec(kBg2); },
                     part);
  }
#pragma unroll
  for (int i = 0; i < AO; i += 2) {
    const int o = wg::kmaj(rw[ROW(i)], colO(i), DO);
    const bf16 g0 = md::tobf(st[i]), g1 = md::tobf(st[i + 1]);
    const bf16 o0 = md::tobf(ot[i]), o1 = md::tobf(ot[i + 1]);
    md::store2(XG + o, md::bf(g0), md::bf(g1));
    md::store2(XA + o, md::bf(o0), md::bf(o1));
    if (P) {
      md::store2(ring + o, st[i] - md::bf(g0), st[i + 1] - md::bf(g1));
      md::store2(ring + R * DO + o, ot[i] - md::bf(o0), ot[i + 1] - md::bf(o1));
    }
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XG, DO, S.dg2.hi, valid, at);
    wg::tile_out(ring, DO, S.dg2.lo, valid, at);
    wg::tile_out(XA, DO, S.dout.hi, valid, at);
    wg::tile_out(ring + R * DO, DO, S.dout.lo, valid, at);
    __syncthreads();
  }

  // ---- gate backward ----------------------------------------------------------
  wg::cta_mma<NG, 1>(dg, XG, DO, W.wg2, ring, false);   // d_rg = bf16(d_g2) @ Wg2^T
  wg::cta_mma<NI, 1>(dr1, XA, DO, W.w2, ring, false);   // d_r1 = bf16(d_out) @ W2^T
  wg::cta_mma<NG, 0>(gt, sE, DE, W.wg1, ring, false);   // recompute
#pragma unroll
  for (int i = 0; i < AG; ++i) gt[i] += gpk[nd[ROW(i)] * G + colG(i)];
  wg::ln_stats(gt, invg, G, red);
#pragma unroll
  for (int i = 0; i < AG; ++i) {
    const int c = colG(i);
    const float ln = gt[i] * md::bf(W.sg1[c]) + md::bf(W.bg1n[c]);
    dg[i] = ln > 0.0f ? dg[i] : 0.0f;
  }
  if (P) {
    wg::col_sums<NG>([&](int i) { return dg[i] * gt[i]; }, 1, seg_tile,
                     [&](int) { return vec(kSg1); }, part);
    wg::col_sums<NG>([&](int i) { return dg[i]; }, 1, seg_tile, [&](int) { return vec(kBg1n); },
                     part);
  }
  wg::ln_bwd(dg, gt, invg, W.sg1, colG, G, red);
  wg::col_sums<NG>([&](int i) { return dg[i]; }, nseg, seg_node, per_node(S.sendpart, G), part);
#pragma unroll
  for (int i = 0; i < AG; i += 2) {
    const int o = wg::kmaj(rw[ROW(i)], colG(i), G);
    const bf16 h0 = md::tobf(dg[i]), h1 = md::tobf(dg[i + 1]);
    md::store2(XG + o, md::bf(h0), md::bf(h1));
    if (P) md::store2(ring + o, dg[i] - md::bf(h0), dg[i + 1] - md::bf(h1));
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XG, G, S.dg1.hi, valid, at);
    wg::tile_out(ring, G, S.dg1.lo, valid, at);
    __syncthreads();
  }
  wg::cta_mma<NE, 1>(de, XG, G, W.wg1, ring, false);    // d_e (gate) = bf16(d_g1) @ Wg1e^T
  wg::cta_mma<NI, 0>(t1, XI, I, W.w1, ring, false);     // recompute h1

  // ---- inter MLP backward -----------------------------------------------------
#pragma unroll
  for (int i = 0; i < AI; ++i) t1[i] += md::bf(W.b1[colI(i)]);
  wg::ln_stats(t1, inv, I, red);
#pragma unroll
  for (int i = 0; i < AI; ++i) {
    const int c = colI(i);
    const float ln = t1[i] * md::bf(W.s1[c]) + md::bf(W.b1n[c]);
    dr1[i] = ln > 0.0f ? dr1[i] : 0.0f;
  }
  if (P) {
    wg::col_sums<NI>([&](int i) { return dr1[i] * t1[i]; }, 1, seg_tile,
                     [&](int) { return vec(kS1); }, part);
    wg::col_sums<NI>([&](int i) { return dr1[i]; }, 1, seg_tile, [&](int) { return vec(kB1n); },
                     part);
  }
  wg::ln_bwd(dr1, t1, inv, W.s1, colI, I, red);
  if (P)
    wg::col_sums<NI>([&](int i) { return dr1[i]; }, 1, seg_tile, [&](int) { return vec(kB1); },
                     part);
#pragma unroll
  for (int i = 0; i < AI; i += 2) {
    const int o = wg::kmaj(rw[ROW(i)], colI(i), I);
    const bf16 h0 = md::tobf(dr1[i]), h1 = md::tobf(dr1[i + 1]);
    md::store2(XA + o, md::bf(h0), md::bf(h1));
    if (P) md::store2(ring + o, dr1[i] - md::bf(h0), dr1[i + 1] - md::bf(h1));
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XA, I, S.dh1.hi, valid, at);
    wg::tile_out(ring, I, S.dh1.lo, valid, at);
    __syncthreads();
  }
  wg::cta_mma<NI, 1>(t1, XA, I, W.w1, ring, false);     // d_inter0 = bf16(d_h1) @ W1^T
  wg::col_sums<NI>([&](int i) { return t1[i] * bp[i]; }, nseg, seg_node, per_node(S.nppart, I),
                   part);
#pragma unroll
  for (int i = 0; i < AI; i += 2) {
    const int c = colI(i), h = ROW(i);
    const float v0 = t1[i] * npk[nd[h] * I + c], v1 = t1[i + 1] * npk[nd[h] * I + c + 1];
    const int o = wg::kmaj(rw[h], c, I);
    const bf16 h0 = md::tobf(v0), h1 = md::tobf(v1);
    md::store2(XA + o, md::bf(h0), md::bf(h1));
    if (P) md::store2(ring + o, v0 - md::bf(h0), v1 - md::bf(h1));
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XA, I, S.dbp.hi, valid, at);
    wg::tile_out(ring, I, S.dbp.lo, valid, at);
    __syncthreads();
  }
  wg::cta_mma<NE, 1>(de, XA, I, W.wb, ring, true);      // d_e += bf16(d_bp) @ Wb^T
#pragma unroll
  for (int i = 0; i < AE; i += 2) {
    const int h = ROW(i);
    if (!ok[h]) continue;
    const size_t o = pr[h] * DE + g * NE + wg::acc_col(i);
    if (side == 0) {
      const float add0 = a.dbond_add ? a.dbond_add[o] : 0.0f;
      const float add1 = a.dbond_add ? a.dbond_add[o + 1] : 0.0f;
      *reinterpret_cast<float2*>(a.dbond32 + o) = make_float2(add0 + de[i], add1 + de[i + 1]);
    } else {
      const float2 l = *reinterpret_cast<const float2*>(a.dbond32 + o);
      md::store2(a.d_bond + o, l.x + de[i], l.y + de[i + 1]);
    }
  }
#undef ROW
}

// One CTA per 32 nodes: d_node from both chains' node sums (not redesigned:
// a small share of the call).
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
  // does the node's run of N rows cross a pair tile's edge?
  auto two = [&](size_t node) {
    return (node * a.N) / wg::kTileRows != (node * a.N + a.N - 1) / wg::kTileRows;
  };
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
        const size_t node = n0 + r;
        s = S.sendpart[node * 2 * G + c];
        if (two(node)) s += S.sendpart[(node * 2 + 1) * G + c];
        S.ssum[node * G + c] = s;
        if (a.need_params) md::put(S.snode, node * G + c, s);
      }
      X0[r * ldb + c] = md::tobf(s);
    }
    for (int idx = threadIdx.x; idx < rp * I; idx += blockDim.x) {
      const int r = idx / I, c = idx % I;
      float s = 0.0f;
      if (r < rows) {
        const size_t node = n0 + r;
        s = S.nppart[node * 2 * I + c];
        if (two(node)) s += S.nppart[(node * 2 + 1) * I + c];
        if (a.need_params) md::put(S.dnp, node * I + c, s);
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
  float* dwt[2];       // [B, G] per-molecule shares of each gate's time row
  float* slots[2][7];
  size_t bytes;
};

EdgeBwdWork carve(EdgeBwdArgs& a, unsigned char* base, int B, int N, int Dn, int De, int I,
                  int G, int Do, int need_params) {
  md::Carve cv{base};
  const size_t P = (size_t)B * N * N, BN = (size_t)B * N;
  const size_t tiles = (P + wg::kTileRows - 1) / wg::kTileRows;
  EdgeBwdWork w = {};
  w.np = cv.take<float>(2 * BN * I);
  w.gpre = cv.take<float>(2 * BN * G);
  a.dbond32 = cv.take<float>(P * De);
  const int P_ = (int)P, BN_ = (int)BN;
  const int dims[7][3] = {{P_, De, I}, {P_, I, I},   {P_, I, Do}, {P_, De, G},
                          {P_, G, Do}, {BN_, Dn, I}, {BN_, Dn, G}};
  for (int s = 0; s < 2; ++s) {
    SideWork& S = a.w[s];
    S = SideWork{};
    S.nppart = cv.take<float>(BN * 2 * I);
    S.sendpart = cv.take<float>(BN * 2 * G);
    S.ssum = cv.take<float>(BN * G);
    if (!need_params) continue;
    if (s == 1) S.eT = cv.take<bf16>(P * De);
    S.inter0 = cv.split(P * I);
    S.r1 = cv.take<bf16>(P * I);
    S.rg = cv.take<bf16>(P * G);
    S.dh1 = cv.split(P * I);
    S.dout = cv.split(P * Do);
    S.dg2 = cv.split(P * Do);
    S.dg1 = cv.split(P * G);
    S.dbp = cv.split(P * I);
    S.vecpart = cv.take<float>(tiles * kVecs * I);
    S.snode = cv.split(BN * G);
    S.dnp = cv.split(BN * I);
    w.dwt[s] = cv.take<float>((size_t)B * G);
    for (int k = 0; k < 7; ++k)
      w.slots[s][k] = cv.take<float>(md::wgrad_slot_floats(dims[k][0], dims[k][1], dims[k][2]));
  }
  a.need_params = need_params;
  w.bytes = cv.off;
  return w;
}

// The pair kernel is instantiated for the widths of the repo's models
// (edge_dim 64 and 32: De = Do = edge_dim, I = 2 edge_dim, G = 32);
// ops/kernels.py's EDGE_BWD_WIDTHS lists the same.
template <int DE, int I, int G, int DO>
cudaError_t launch_pair(const EdgeBwdArgs& a, int tiles, cudaStream_t s, int* launched) {
  constexpr size_t ps = pair_smem<DE, I>();
  cudaError_t err = cudaFuncSetAttribute(edge_bwd_pair_kernel<DE, I, G, DO>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(ps));
  if (err != cudaSuccess) return err;
  for (int side = 0; side < 2; ++side) {
    edge_bwd_pair_kernel<DE, I, G, DO><<<tiles, 256, ps, s>>>(a, side);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

}  // namespace

namespace md {

bool edge_chain_bwd_built(int De, int I, int G, int Do) {
  return (De == 64 && I == 128 && G == 32 && Do == 64) ||
         (De == 32 && I == 64 && G == 32 && Do == 32);
}

size_t edge_chain_bwd_bytes(int B, int N, int Dn, int De, int I, int G, int Do, int need_params) {
  EdgeBwdArgs a = {};
  return carve(a, nullptr, B, N, Dn, De, I, G, Do, need_params).bytes;
}

cudaError_t edge_chain_bwd(const EdgeChainBwd& c, int B, int N, int Dn, int De, int I, int G,
                           int Do, cudaStream_t s, int* launched) {
  if (!edge_chain_bwd_built(De, I, G, Do)) return cudaErrorInvalidValue;
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
  const int need_params = c.grads != nullptr;
  EdgeBwdWork ws = carve(a, static_cast<unsigned char*>(c.workspace), B, N, Dn, De, I, G, Do,
                         need_params);
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
  const int tiles = (P + wg::kTileRows - 1) / wg::kTileRows;
  const int ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  err = De == 64 ? launch_pair<64, 128, 32, 64>(a, tiles, s, launched)
                 : launch_pair<32, 64, 32, 32>(a, tiles, s, launched);
  if (err != cudaSuccess) return err;
  const size_t ns = node_smem(Dn, I);
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
  if (need_params) {
    for (int sd = 0; sd < 2; ++sd) {
      const SideWork& S = a.w[sd];
      float* const* g = c.grads + 14 * sd;
      md::WgradJob* j = jobs + 7 * sd;
      const bf16* e = sd == 0 ? a.e : S.eT;
      j[0] = {e, nullptr, S.dbp.hi, S.dbp.lo, ws.slots[sd][0], P, De, I, De, I};
      j[1] = {S.inter0.hi, S.inter0.lo, S.dh1.hi, S.dh1.lo, ws.slots[sd][1], P, I, I, I, I};
      j[2] = {S.r1, nullptr, S.dout.hi, S.dout.lo, ws.slots[sd][2], P, I, Do, I, Do};
      j[3] = {e, nullptr, S.dg1.hi, S.dg1.lo, ws.slots[sd][3], P, De, G, De, G};
      j[4] = {S.rg, nullptr, S.dg2.hi, S.dg2.lo, ws.slots[sd][4], P, G, Do, G, Do};
      j[5] = {a.x, nullptr, S.dnp.hi, S.dnp.lo, ws.slots[sd][5], BN, Dn, I, Dn, I};
      j[6] = {a.x, nullptr, S.snode.hi, S.snode.lo, ws.slots[sd][6], BN, Dn, G, Dn, G};
      float** o = job_out + 7 * sd;
      o[0] = g[Wb]; o[1] = g[W1]; o[2] = g[W2]; o[3] = g[Wg1];
      o[4] = g[Wg2]; o[5] = g[Wn]; o[6] = g[Wg1] + (size_t)De * G;
    }
    err = md::launch_wgrad(jobs, 14, s);
    if (err != cudaSuccess) return err;
    ++*launched;
  }

  // d_time = left + right, and the molecules' shares of each gate's time row
  const size_t trow = (size_t)(De + Dn) * G;
  if (need_params || c.d_time != nullptr) {
    md::TimeJob tj[2];
    for (int sd = 0; sd < 2; ++sd)
      tj[sd] = {a.w[sd].ssum, a.side[sd].wg1 + trow, need_params ? ws.dwt[sd] : nullptr, G, N, G};
    err = md::launch_time(tj, 2, B, t, c.d_time, s);
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  if (!need_params) return cudaSuccess;

  md::ReduceJob red[32];
  int nr = 0;
  for (int k = 0; k < 14; ++k) {
    const int n = jobs[k].k1 * jobs[k].k2;
    red[nr++] = {jobs[k].slots, job_out[k], md::wgrad_slices(jobs[k].rows), n, n};
  }
  const int vec_out[kVecs] = {B2, Bg2, Sg1, Bg1n, B1, S1, B1n};
  const int vec_n[kVecs] = {Do, Do, G, G, I, I, I};
  for (int sd = 0; sd < 2; ++sd) {
    float* const* g = c.grads + 14 * sd;
    for (int v = 0; v < kVecs; ++v)
      red[nr++] = {a.w[sd].vecpart + (size_t)v * I, g[vec_out[v]], tiles, vec_n[v], kVecs * I};
    red[nr++] = {a.w[sd].ssum, g[Bg1], BN, G, G};
    red[nr++] = {ws.dwt[sd], g[Wg1] + trow, B, G, G};
  }
  err = md::launch_reduce(red, nr, s);
  if (err != cudaSuccess) return err;
  ++*launched;
  return cudaSuccess;
}

}  // namespace md

extern "C" {

long long md_edge_pair_backward_workspace(int B, int N, int Dn, int De, int I, int G, int Do,
                                          int need_params) {
  return (long long)md::edge_chain_bwd_bytes(B, N, Dn, De, I, G, Do, need_params);
}

// p: 14 left and 14 right weights (BondFfn order), e, x, mask, t, dt_ct,
// du_ct, then the outputs d_bond, d_node, d_time, d_mask and the 28 float32
// parameter gradients in the weights' order (each gate's first-layer weight
// as one [De+Dn+1, G] matrix), then the workspace
// (md_edge_pair_backward_workspace bytes). need_params = 0: the parameter
// gradients are not formed (their pointers may be null); need_time = 0:
// d_time is not formed (may be null). The pair kernel is built for the
// widths of md::edge_chain_bwd_built.
int md_edge_pair_backward(const void* const* p, int B, int N, int Dn, int De, int I, int G,
                          int Do, int need_params, int need_time, void* stream, int* launched) {
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
  c.d_time = need_time ? static_cast<float*>(const_cast<void*>(p[36])) : nullptr;
  c.d_mask = static_cast<float*>(const_cast<void*>(p[37]));
  c.grads = need_params ? grads : nullptr;
  c.workspace = const_cast<void*>(p[66]);
  *launched = 0;
  return md::edge_chain_bwd(c, B, N, Dn, De, I, G, Do, static_cast<cudaStream_t>(stream),
                            launched);
}

}  // extern "C"
