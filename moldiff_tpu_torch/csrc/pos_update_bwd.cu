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
// Design (redesigned for Hopper's tensor cores, after node_block_bwd.cu and
// edge_pair_bwd.cu).
// - Tiles. The pairs are taken in receiver-major order (row rho = (b * N +
//   i) * N + j, e's own order) and cut into tiles of 64 rows, one wgmma M,
//   one CTA each, so no row idles but the last tile's. A CTA is two
//   warpgroups; the ten products (the recompute's e @ Wb, xp @ Wn, inter @
//   W1 and the gate's e and xp parts, and the transposed d_g1 @ Wg1e^T,
//   d_h1 @ W1^T, d_bp @ Wb^T, d_np @ Wn^T, d_g1 @ Wg1x^T) run as wgmma with
//   the 64-row activation tile (bf16, shared memory) as A and a weight as
//   B, the warpgroups splitting the output columns, the weights' K-slices
//   staged by cp.async into a double-buffered ring (wgmma.cuh cta_mma), the
//   accumulators in registers. The cotangents of the bilinear, d_bp =
//   d_inter0 * np and d_np = d_inter0 * bp, run over column slices of 64
//   per warpgroup with bp and np recomputed there, so that no 64 x I
//   float32 tile is kept and three accumulators of a slice fit the
//   registers. The per-column parameters (biases, LayerNorm scales, the
//   one-column weights) are read from a float32 copy in shared memory.
// - The weight w is a scalar per pair: the recompute's LayerNorm statistics
//   and one-column layers close their row sums in the lane quads and
//   across the two warpgroups (wg::ln_stats, wg::row_sums), and the
//   backward of the one-column layers is an outer product with w2 or wg2
//   and column sums. The per-row epilogues (LayerNorm backward of both MLPs,
//   the force backward, d_rel, d_dist, d_mask) run on the registers.
// - Sums over pairs, with no float atomics. Per-tile column sums (bias,
//   LayerNorm and one-column weights) go through wg::col_sums_tile in a
//   fixed order, the three of a LayerNorm in one pass. d_L[i] = sum_j
//   d_xp[i,j] R[j] and the receiver's sum of d_g1 (for d_t and the gate's
//   bias) close per receiver inside the tile in a fixed order, in two parts (the tile of the receiver's first row, the
//   next one: N <= 64); d_R[j] = sum_i d_xp[i,j] L[i] runs across tiles, so
//   the pair kernel writes its terms in sender-major order and the node
//   kernel adds them in receiver order, reading each sender's N rows
//   contiguously. The tiles are fixed by P alone, so every sum's order
//   is the same on any card; the grid is not persistent.
// - The node kernel (one CTA per 32 nodes) adds those parts, then runs the
//   two node MLPs' backward and d_node on synchronous WMMA (md::cta_gemm):
//   it is a small share of the call (two Dn -> Dl -> Dl chains over B * N
//   rows), and only its sums changed with the pair kernel's redesign.
// - Parameter gradients go through grad.cu as in edge_pair_bwd.cu: the pair
//   and node kernels write the operands of each A^T B (xp, inter0, d_h1,
//   d_bp, d_np, d_g1 per pair: about 4.6 KB per pair at flagship widths,
//   the float32 ones as bf16 hi + lo planes), the weight-gradient kernel
//   forms them in split-K slots, and the reduction adds slots and per-tile
//   column sums in a fixed order.
// Launches per call: prep (pos_update.cu), pair, node, weight gradients,
// time, reduction = 6.
#include "grad.cuh"
#include "wgmma.cuh"

using md::bf16;
namespace wg = md::wg;

namespace {

constexpr int kVecs = 9;  // per-tile column sums of the pair kernel, in this order:
enum { kB1 = 0, kS1, kB1n, kW2, kSg1, kBg1n, kWg2, kB2, kBg2 };
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
  md::Split inter0;    // [P,I]
  md::Split dh1;       // [P,I]
  md::Split dbp;       // [P,I]
  md::Split dnp;       // [P,I]
  md::Split dg1;       // [P,G]
  bf16* xp;            // [P,Dl]
  float* dlpart;       // [B*N,2,Dl] per receiver: sum of d_xp * R[j], in two parts (the
                       // tile of its first row, the next tile)
  float* gpart;        // [B*N,2,G] the same for d_g1
  float* gsum;         // [B*N,G] the two parts of gpart added
  float* qT;           // [P,Dl] d_xp[i,j] * L[i] at row (b * N + j) * N + i
  float* vecpart;      // [tiles, kVecs, I]
  md::Split dout;      // [2,B*N,Dl] d_L, d_R
  bf16* r1n;           // [2,B*N,Dl]
  md::Split dh1n;      // [2,B*N,Dl]
  float* nodepart;     // [node tiles, 2, kNodeVecs, Dl]
  int B, N, Dn, De, Dl, I, G;
};

template <int DE, int DL, int I, int G>
constexpr size_t pair_smem() {
  return ((size_t)wg::kTileRows * (DE + DL + 3 * I + G) + 2 * wg::kSlice * wg::kRingCols) *
             sizeof(bf16) +
         (size_t)(2 * 64 * 2 + 4 * 3 * I + 2 * 64 + 4 * I + 5 * G) * sizeof(float);
}

__host__ inline size_t node_smem(int Dn, int Dl) {
  return md::smem_bytes(md::kBwdRows, Dn + 8, 2) + 2 * md::smem_bytes(md::kBwdRows, Dl + 8, 2) +
         3 * md::smem_bytes(md::kBwdRows, Dl + 4, 4) + md::smem_bytes(md::kBwdRows, Dn + 4, 4) +
         (size_t)md::kWarps * kNodeVecs * Dl * sizeof(float);
}

// One CTA (two warpgroups) per tile of 64 consecutive rows in receiver-major
// order: row rho = (b * N + i) * N + j is the pair (receiver i, sender j) of
// molecule b, so a tile holds whole and partial receivers (at most three at
// N >= 32).
template <int DE, int DL, int I, int G>
__global__ void __launch_bounds__(256, 1) pos_bwd_pair_kernel(const PosBwdArgs a) {
  constexpr int R = wg::kTileRows;
  constexpr int NW = I / 2, NA = NW / 2;              // I-wide products
  constexpr int NS = NW < 64 ? NW : 64, AS = NS / 2;  // the bilinear's column slices
  constexpr int NG = G / 2, AG = NG / 2, NE = DE / 2, AE = NE / 2, NX = DL / 2, AX = NX / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sE = reinterpret_cast<bf16*>(smem);  // e, then d_e
  bf16* sX = sE + R * DE;                    // xp
  bf16* XA = sX + R * DL;                    // bf16(inter0), then bf16(d_bp)
  bf16* XB = XA + R * I;                     // bf16(d_h1)
  bf16* XC = XB + R * I;                     // bf16(d_np)
  bf16* XG = XC + R * I;                     // bf16(d_g1)
  bf16* ring = XG + R * G;
  float* red = reinterpret_cast<float*>(ring + 2 * wg::kSlice * wg::kRingCols);
  float* part = red + 2 * 64 * 2;
  float* rowv = part + 4 * 3 * I;            // [2][64] d_out, d_g2 per row
  // the per-column parameters as float32 (read per element by the epilogues)
  float* pb1 = rowv + 2 * 64;
  float* ps1 = pb1 + I;
  float* pb1n = ps1 + I;
  float* pw2 = pb1n + I;
  float* pbg1 = pw2 + I;
  float* psg1 = pbg1 + G;
  float* pbg1n = psg1 + G;
  float* pwg2 = pbg1n + G;
  float* pwg1t = pwg2 + G;
  // (the low halves of the split operands are staged in the ring, free
  // between products)
  static_assert(I <= wg::kRingCols, "I is wider than the ring");

  const BondFfn& W = a.f;
  const uint32_t N = a.N, NN = N * N;
  const uint32_t rho0 = blockIdx.x * R;
  const int nv = min((uint32_t)R, a.B * NN - rho0);
  const uint32_t node0 = rho0 / N;
  const int nseg = (rho0 + nv - 1) / N - node0 + 1;
  const size_t BN = (size_t)a.B * N;
  const bf16* lft = a.lr;
  const bf16* rgt = a.lr + BN * DL;
  const bf16* wg1x = W.wg1 + (size_t)DE * G;
  const bf16* wg1t = W.wg1 + (size_t)(DE + DL) * G;
  auto valid = [&](int r) { return r < nv; };
  auto at = [&](int r) { return rho0 + r; };  // the per-pair operands' row: the pair itself
  auto seg_rcv = [&](int r) { return valid(r) ? (int)((rho0 + r) / N - node0) : -1; };
  auto vec = [&](int v) { return a.vecpart + ((size_t)blockIdx.x * kVecs + v) * I; };
  // a receiver's sums: part 0 from the tile of its first row, part 1 from the next
  auto per_rcv = [&](float* base, int width) {
    return [=](int s) {
      const uint32_t node = node0 + s;
      return base + ((size_t)node * 2 + (node * N < rho0 ? 1 : 0)) * width;
    };
  };

  for (int c = threadIdx.x; c < I; c += blockDim.x) {
    pb1[c] = md::bf(W.b1[c]);
    ps1[c] = md::bf(W.s1[c]);
    pb1n[c] = md::bf(W.b1n[c]);
    pw2[c] = md::bf(W.w2[c]);
  }
  for (int c = threadIdx.x; c < G; c += blockDim.x) {
    pbg1[c] = md::bf(W.bg1[c]);
    psg1[c] = md::bf(W.sg1[c]);
    pbg1n[c] = md::bf(W.bg1n[c]);
    pwg2[c] = md::bf(W.wg2[c]);
    pwg1t[c] = md::bf(wg1t[c]);
  }
  // e, and xp = bf16(L[i] R[j]) (also written out, the A of two weight-gradient
  // products), eight columns a thread
  for (int idx = threadIdx.x; idx < R * (DE / 8); idx += blockDim.x) {
    const int r = idx / (DE / 8), c = (idx % (DE / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (valid(r)) v = *reinterpret_cast<const uint4*>(a.e + (size_t)(rho0 + r) * DE + c);
    *reinterpret_cast<uint4*>(sE + wg::kmaj(r, c, DE)) = v;
  }
  for (int idx = threadIdx.x; idx < R * (DL / 8); idx += blockDim.x) {
    const int r = idx / (DL / 8), c = (idx % (DL / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (valid(r)) {
      const uint32_t rho = rho0 + r;
      const size_t snd = rho / NN * N + rho % N;  // the sender, b * N + j
      const uint4 l = *reinterpret_cast<const uint4*>(lft + (size_t)(rho / N) * DL + c);
      const uint4 q = *reinterpret_cast<const uint4*>(rgt + snd * DL + c);
      const bf16* lv = reinterpret_cast<const bf16*>(&l);
      const bf16* rv = reinterpret_cast<const bf16*>(&q);
      bf16* xv = reinterpret_cast<bf16*>(&v);
#pragma unroll
      for (int k = 0; k < 8; ++k) xv[k] = md::tobf(md::bf(lv[k]) * md::bf(rv[k]));
      *reinterpret_cast<uint4*>(a.xp + (size_t)rho * DL + c) = v;
    }
    *reinterpret_cast<uint4*>(sX + wg::kmaj(r, c, DL)) = v;
  }

  const int g = threadIdx.x >> 7, ql = threadIdx.x & 3;
  auto col = [&](int i) { return g * NW + wg::acc_col(i); };
  auto colG = [&](int i) { return g * NG + wg::acc_col(i); };
  int rw[2];
  bool ok[2];
  uint32_t rho[2], rcv[2], snd[2];  // pair, receiver and sender (B * N * N < 2^32)
  float tb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rw[h] = wg::acc_row(2 * h);
    ok[h] = valid(rw[h]);
    rho[h] = ok[h] ? rho0 + rw[h] : rho0;
    rcv[h] = rho[h] / N;
    snd[h] = rho[h] / NN * N + rho[h] % N;
    tb[h] = a.t[rho[h] / NN];
  }
#define ROW(i) (((i) >> 1) & 1)

  // ---- forward recompute: the gate (xg: xhat, sig), then the interior ---------
  float xg[AG], ginv[2], sig[2];
  {
    float gx[AG], gd[2];
    wg::cta_mma<NG, 0>(xg, sE, DE, W.wg1, ring, false);
    wg::cta_mma<NG, 0>(gx, sX, DL, wg1x, ring, false);
#pragma unroll
    for (int i = 0; i < AG; ++i) {
      const int c = colG(i);
      xg[i] = xg[i] + gx[i] + tb[ROW(i)] * pwg1t[c] + pbg1[c];
    }
    wg::ln_stats(xg, ginv, G, red);
    float dot[2][1] = {};
#pragma unroll
    for (int i = 0; i < AG; ++i) {
      const int c = colG(i);
      dot[ROW(i)][0] += md::rbf(fmaxf(xg[i] * psg1[c] + pbg1n[c], 0.0f)) * pwg2[c];
    }
    wg::row_sums<1>(dot, red);
#pragma unroll
    for (int h = 0; h < 2; ++h) sig[h] = md::sigmoidf(dot[h][0] + md::bf(W.bg2[0]));
  }
  // inter0 = (e @ Wb) * (xp @ Wn), float32: bf16 in XA, and as hi + lo planes
  // for the weight gradient of W1 (the low half staged in the ring)
  {
    float bp[NA], np[NA];
    wg::cta_mma<NW, 0>(bp, sE, DE, W.wb, ring, false);
    wg::cta_mma<NW, 0>(np, sX, DL, W.wn, ring, false);
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int o = wg::kmaj(rw[ROW(i)], col(i), I);
      const float v0 = bp[i] * np[i], v1 = bp[i + 1] * np[i + 1];
      const bf16 h0 = md::tobf(v0), h1 = md::tobf(v1);
      md::store2(XA + o, md::bf(h0), md::bf(h1));
      md::store2(ring + o, v0 - md::bf(h0), v1 - md::bf(h1));
    }
    __syncthreads();
    wg::tile_out(XA, I, a.inter0.hi, valid, at);
    wg::tile_out(ring, I, a.inter0.lo, valid, at);
    __syncthreads();
  }
  float acc[NA], inv1[2], out[2];
  wg::cta_mma<NW, 0>(acc, XA, I, W.w1, ring, false);
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] += pb1[col(i)];
  wg::ln_stats(acc, inv1, I, red);
  {
    float dot[2][1] = {};
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int c = col(i);
      dot[ROW(i)][0] += md::rbf(fmaxf(acc[i] * ps1[c] + pb1n[c], 0.0f)) * pw2[c];
    }
    wg::row_sums<1>(dot, red);
    out[0] = dot[0][0];
    out[1] = dot[1][0];
  }

  // ---- the force backward: d_rel, d_dist, d_mask; d_out and d_g2 per row -----
  float d_out[2], d_g2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float o = out[h] + md::bf(W.b2[0]);
    const float w = o * sig[h];
    float d_w = 0.0f;
    if (ok[h]) {
      const size_t p = rho[h];
      const float m = a.mask[p];
      const float d = m > 0.0f ? a.dist[p] : 1.0f;
      const float qq = 1.0f / d, rr = 1.0f / (d + 1.0f), qr = qq * rr;
      const float* rv = a.rel + p * 3;
      const float* ct = a.ct + (size_t)rcv[h] * 3;
      const float cdr = ct[0] * rv[0] + ct[1] * rv[1] + ct[2] * rv[2];
      d_w = cdr * qr * m;
      if (g == 0 && ql < 3) a.d_rel[p * 3 + ql] = ct[ql] * w * qr * m;
      if (g == 0 && ql == 0) {
        a.d_mask[p] = cdr * w * qr;
        a.d_dist[p] = cdr * w * m * (-qr) * (qq + rr);
      }
    }
    d_out[h] = d_w * sig[h];
    d_g2[h] = d_w * o * sig[h] * (1.0f - sig[h]);
    if (g == 0 && ql == 0) {
      rowv[rw[h]] = d_out[h];
      rowv[64 + rw[h]] = d_g2[h];
    }
  }
  __syncthreads();
  if (threadIdx.x < 2) {  // b2 and bg2: the tile's rows in order
    float sum = 0.0f;
    for (int r = 0; r < nv; ++r) sum += rowv[threadIdx.x * 64 + r];
    vec(threadIdx.x == 0 ? kB2 : kBg2)[0] = sum;
  }

  // ---- gate backward: d_rg = bf16(d_g2) wg2, relu, LayerNorm -> d_g1 --------
  // (pallas _ln_bwd, with the column sums in its two passes: the relu-gated
  // cotangent dy, the sums for sg1, bg1n and wg2 and the row sums of dy *
  // sg1 and of that times xhat; then d_g1 and its sum per receiver)
  {
    float dy[AG], m[2][2] = {};
    const float dgr[2] = {md::rbf(d_g2[0]), md::rbf(d_g2[1])};
    wg::col_sums_tile<NG, 3>(
        [&](int i, float (&x)[3]) {
          const int c = colG(i), h = ROW(i);
          const float ln = xg[i] * psg1[c] + pbg1n[c];
          dy[i] = ln > 0.0f ? dgr[h] * pwg2[c] : 0.0f;
          x[0] = dy[i] * xg[i];
          x[1] = dy[i];
          x[2] = md::rbf(fmaxf(ln, 0.0f)) * d_g2[h];
          const float ds = dy[i] * psg1[c];
          m[h][0] += ds;
          m[h][1] += ds * xg[i];
        },
        nv, [&](int v) { return vec(kSg1 + v); }, part);
    wg::row_sums<2>(m, red);
#pragma unroll
    for (int i = 0; i < AG; ++i) {
      const int h = ROW(i);
      dy[i] = ginv[h] * (dy[i] * psg1[colG(i)] - m[h][0] / G - xg[i] * (m[h][1] / G));
    }
    wg::col_sums<NG>([&](int i) { return dy[i]; }, nseg, seg_rcv, per_rcv(a.gpart, G), part);
#pragma unroll
    for (int i = 0; i < AG; i += 2) {
      const int o = wg::kmaj(rw[ROW(i)], colG(i), G);
      const bf16 h0 = md::tobf(dy[i]), h1 = md::tobf(dy[i + 1]);
      md::store2(XG + o, md::bf(h0), md::bf(h1));
      md::store2(ring + o, dy[i] - md::bf(h0), dy[i + 1] - md::bf(h1));
    }
    __syncthreads();
    wg::tile_out(XG, G, a.dg1.hi, valid, at);
    wg::tile_out(ring, G, a.dg1.lo, valid, at);
    __syncthreads();
  }

  // ---- inter MLP backward: d_r1 = bf16(d_out) w2, relu, LayerNorm -> d_h1 ---
  // (as the gate's: two passes, the second giving d_h1 and its sum for b1)
  {
    float dy[NA], m[2][2] = {};
    const float dor[2] = {md::rbf(d_out[0]), md::rbf(d_out[1])};
    wg::col_sums_tile<NW, 3>(
        [&](int i, float (&x)[3]) {
          const int c = col(i), h = ROW(i);
          const float ln = acc[i] * ps1[c] + pb1n[c];
          dy[i] = ln > 0.0f ? dor[h] * pw2[c] : 0.0f;
          x[0] = dy[i] * acc[i];
          x[1] = dy[i];
          x[2] = md::rbf(fmaxf(ln, 0.0f)) * d_out[h];
          const float ds = dy[i] * ps1[c];
          m[h][0] += ds;
          m[h][1] += ds * acc[i];
        },
        nv, [&](int v) { return vec(kS1 + v); }, part);
    wg::row_sums<2>(m, red);
    wg::col_sums_tile<NW, 1>(
        [&](int i, float (&x)[1]) {
          const int h = ROW(i);
          dy[i] = inv1[h] * (dy[i] * ps1[col(i)] - m[h][0] / I - acc[i] * (m[h][1] / I));
          x[0] = dy[i];
        },
        nv, [&](int) { return vec(kB1); }, part);
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int o = wg::kmaj(rw[ROW(i)], col(i), I);
      const bf16 h0 = md::tobf(dy[i]), h1 = md::tobf(dy[i + 1]);
      md::store2(XB + o, md::bf(h0), md::bf(h1));
      md::store2(ring + o, dy[i] - md::bf(h0), dy[i + 1] - md::bf(h1));
    }
    __syncthreads();
    wg::tile_out(XB, I, a.dh1.hi, valid, at);
    wg::tile_out(ring, I, a.dh1.lo, valid, at);
    __syncthreads();
  }

  // ---- d_inter0 = bf16(d_h1) @ W1^T; d_bp = d_inter0 * np, d_np = d_inter0 *
  // bp (bp, np recomputed), slice by slice: bf16 in XA, XC, low halves out ----
#pragma unroll 1
  for (int c0 = 0; c0 < I; c0 += 2 * NS) {
    float di[AS], bp[AS], np[AS];
    wg::cta_mma<NS, 1>(di, XB, I, W.w1 + (size_t)c0 * I, ring, false);
    wg::cta_mma<NS, 0>(bp, sE, DE, W.wb + c0, ring, false, nullptr, I);
    wg::cta_mma<NS, 0>(np, sX, DL, W.wn + c0, ring, false, nullptr, I);
    bf16* lo = ring + R * 2 * NS;
#pragma unroll
    for (int i = 0; i < AS; i += 2) {
      const int cs = g * NS + wg::acc_col(i), h = ROW(i);
      const int o = wg::kmaj(rw[h], c0 + cs, I), os = wg::kmaj(rw[h], cs, 2 * NS);
      const float b0 = di[i] * np[i], b1 = di[i + 1] * np[i + 1];
      const float n0 = di[i] * bp[i], n1 = di[i + 1] * bp[i + 1];
      const bf16 hb0 = md::tobf(b0), hb1 = md::tobf(b1), hn0 = md::tobf(n0), hn1 = md::tobf(n1);
      md::store2(XA + o, md::bf(hb0), md::bf(hb1));
      md::store2(XC + o, md::bf(hn0), md::bf(hn1));
      md::store2(ring + os, b0 - md::bf(hb0), b1 - md::bf(hb1));
      md::store2(lo + os, n0 - md::bf(hn0), n1 - md::bf(hn1));
    }
    __syncthreads();
    wg::tile_out(ring, 2 * NS, a.dbp.lo + c0, valid, at, I);
    wg::tile_out(lo, 2 * NS, a.dnp.lo + c0, valid, at, I);
    __syncthreads();
  }
  wg::tile_out(XA, I, a.dbp.hi, valid, at);
  wg::tile_out(XC, I, a.dnp.hi, valid, at);

  // ---- d_e = bf16(d_g1) @ Wg1e^T + bf16(d_bp) @ Wb^T ---------------------------
  {
    float de[AE];
    wg::cta_mma<NE, 1>(de, XG, G, W.wg1, ring, false);
    wg::cta_mma<NE, 1>(de, XA, I, W.wb, ring, true);
#pragma unroll
    for (int i = 0; i < AE; i += 2)
      md::store2(sE + wg::kmaj(rw[ROW(i)], g * NE + wg::acc_col(i), DE), de[i], de[i + 1]);
    __syncthreads();
    wg::tile_out(sE, DE, a.d_edge, valid, at);
  }

  // ---- d_xp = bf16(d_np) @ Wn^T + bf16(d_g1) @ Wg1x^T; d_L's parts and d_R's
  // terms ----------------------------------------------------------------------
  {
    float dx[AX];
    wg::cta_mma<NX, 1>(dx, XC, I, W.wn, ring, false);
    wg::cta_mma<NX, 1>(dx, XG, G, wg1x, ring, true);
    wg::col_sums<NX>(
        [&](int i) {
          return dx[i] * md::bf(rgt[(size_t)snd[ROW(i)] * DL + g * NX + wg::acc_col(i)]);
        },
        nseg, seg_rcv, per_rcv(a.dlpart, DL), part);
#pragma unroll
    for (int i = 0; i < AX; i += 2) {
      const int h = ROW(i);
      if (!ok[h]) continue;
      const int c = g * NX + wg::acc_col(i);
      const __nv_bfloat162 l =
          *reinterpret_cast<const __nv_bfloat162*>(lft + (size_t)rcv[h] * DL + c);
      *reinterpret_cast<float2*>(a.qT + ((size_t)snd[h] * N + rcv[h] % N) * DL + c) =
          make_float2(dx[i] * md::bf(l.x), dx[i + 1] * md::bf(l.y));
    }
  }
#undef ROW
}

// One CTA per 32 nodes: d_L from the pair kernel's two parts, d_R as the sum
// of its terms over receivers, the receivers' sums of d_g1, the backward of
// both node MLPs (recomputed), and d_node.
__global__ void __launch_bounds__(md::kThreads) pos_bwd_node_kernel(const PosBwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, Dn = a.Dn, Dl = a.Dl, G = a.G;
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
  // does node nd's run of N pair rows cross a pair tile's edge?
  auto two = [&](size_t nd) {
    return (nd * N) / wg::kTileRows != (nd * N + N - 1) / wg::kTileRows;
  };

  for (int idx = threadIdx.x; idx < rows * G; idx += blockDim.x) {
    const size_t nd = n0 + idx / G;
    const int c = idx % G;
    const float* p = a.gpart + nd * 2 * G + c;
    a.gsum[nd * G + c] = two(nd) ? p[0] + p[G] : p[0];
  }
  md::load_rows(sX, ldx, rows, rp, Dn, [&](int r) { return a.x + (size_t)(n0 + r) * Dn; });
  for (int side = 0; side < 2; ++side) {
    const Mlp& W = a.side[side];
    // d_L[i] = sum_j d_xp[i,j] R[j] (two parts);  d_R[j] = sum_i d_xp[i,j] L[i]
    for (int idx = threadIdx.x; idx < rp * Dl; idx += blockDim.x) {
      const int r = idx / Dl, c = idx % Dl;
      float s = 0.0f;
      if (r < rows) {
        const size_t nd = n0 + r;
        if (side == 0) {
          const float* p = a.dlpart + nd * 2 * Dl + c;
          s = two(nd) ? p[0] + p[Dl] : p[0];
        } else {
          const float* q = a.qT + nd * N * Dl + c;
          for (int i = 0; i < N; ++i) s += q[(size_t)i * Dl];
        }
        md::put(a.dout, ((size_t)side * BN + nd) * Dl + c, s);
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
          if (r < rows) md::put(a.dh1n, ((size_t)side * BN + n0 + r) * Dl + c, dy[q]);
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
  float* dwt;          // [B, G] per-molecule shares of the gate's time row
  size_t bytes;
};

PosBwdWork carve(PosBwdArgs& a, unsigned char* base, int B, int N, int Dn, int De, int Dl,
                 int I, int G) {
  md::Carve cv{base};
  const size_t P = (size_t)B * N * N, BN = (size_t)B * N;
  const size_t tiles = (P + wg::kTileRows - 1) / wg::kTileRows;
  const size_t ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  a.lr = cv.take<bf16>(2 * BN * Dl);
  a.inter0 = cv.split(P * I);
  a.dh1 = cv.split(P * I);
  a.dbp = cv.split(P * I);
  a.dnp = cv.split(P * I);
  a.dg1 = cv.split(P * G);
  a.xp = cv.take<bf16>(P * Dl);
  a.dlpart = cv.take<float>(BN * 2 * Dl);
  a.gpart = cv.take<float>(BN * 2 * G);
  a.gsum = cv.take<float>(BN * G);
  a.qT = cv.take<float>(P * Dl);
  a.vecpart = cv.take<float>(tiles * kVecs * I);
  a.dout = cv.split(2 * BN * Dl);
  a.r1n = cv.take<bf16>(2 * BN * Dl);
  a.dh1n = cv.split(2 * BN * Dl);
  a.nodepart = cv.take<float>(ntiles * 2 * kNodeVecs * Dl);
  const int P_ = (int)P, BN_ = (int)BN;
  const int dims[9][3] = {{P_, De, I}, {P_, Dl, I},  {P_, I, I},    {P_, De, G},   {P_, Dl, G},
                          {BN_, Dn, Dl}, {BN_, Dl, Dl}, {BN_, Dn, Dl}, {BN_, Dl, Dl}};
  PosBwdWork w;
  w.dwt = cv.take<float>((size_t)B * G);
  for (int k = 0; k < 9; ++k)
    w.slots[k] = cv.take<float>(md::wgrad_slot_floats(dims[k][0], dims[k][1], dims[k][2]));
  w.bytes = cv.off;
  return w;
}

template <int DE, int DL, int I, int G>
cudaError_t launch_pair(const PosBwdArgs& a, int tiles, cudaStream_t s) {
  constexpr size_t ps = pair_smem<DE, DL, I, G>();
  cudaError_t err = cudaFuncSetAttribute(pos_bwd_pair_kernel<DE, DL, I, G>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(ps));
  if (err != cudaSuccess) return err;
  pos_bwd_pair_kernel<DE, DL, I, G><<<tiles, 256, ps, s>>>(a);
  return cudaGetLastError();
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
// the workspace (md_pos_update_backward_workspace bytes). The pair kernel is
// built for the widths of md::pos_update_built (else cudaErrorInvalidValue,
// before any launch).
int md_pos_update_backward(const void* const* p, int B, int N, int Dn, int De, int Dl, int I,
                           int G, void* stream, int* launched) {
  *launched = 0;
  if (!md::pos_update_built(Dn, De, Dl, I, G)) return cudaErrorInvalidValue;
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

  cudaError_t err = md::pos_update_prep(p, a.x, a.lr, B, N, Dn, Dl, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  const int BN = B * N, P = BN * N;
  const int tiles = (P + wg::kTileRows - 1) / wg::kTileRows;
  const int ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  err = De == 64 ? launch_pair<64, 64, 256, 32>(a, tiles, s)
                 : launch_pair<32, 32, 128, 32>(a, tiles, s);
  if (err != cudaSuccess) return err;
  ++*launched;
  const size_t ns = node_smem(Dn, Dl);
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
      {a.e, nullptr, a.dbp.hi, a.dbp.lo, ws.slots[0], P, De, I, De, I},
      {a.xp, nullptr, a.dnp.hi, a.dnp.lo, ws.slots[1], P, Dl, I, Dl, I},
      {a.inter0.hi, a.inter0.lo, a.dh1.hi, a.dh1.lo, ws.slots[2], P, I, I, I, I},
      {a.e, nullptr, a.dg1.hi, a.dg1.lo, ws.slots[3], P, De, G, De, G},
      {a.xp, nullptr, a.dg1.hi, a.dg1.lo, ws.slots[4], P, Dl, G, Dl, G},
      {a.x, nullptr, a.dh1n.hi, a.dh1n.lo, ws.slots[5], BN, Dn, Dl, Dn, Dl},
      {a.r1n, nullptr, a.dout.hi, a.dout.lo, ws.slots[6], BN, Dl, Dl, Dl, Dl},
      {a.x, nullptr, a.dh1n.hi + BNs * Dl, a.dh1n.lo + BNs * Dl, ws.slots[7], BN, Dn, Dl, Dn,
       Dl},
      {a.r1n + BNs * Dl, nullptr, a.dout.hi + BNs * Dl, a.dout.lo + BNs * Dl, ws.slots[8], BN,
       Dl, Dl, Dl, Dl},
  };
  float* job_out[9] = {g[FWb], g[FWn], g[FW1], g[FWg1], g[FWg1] + (size_t)De * G,
                       g[W1], g[W2], g[6 + W1], g[6 + W2]};
  err = md::launch_wgrad(jobs, 9, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  // d_time and the molecules' shares of the gate weight's time row
  const size_t trow = (size_t)(De + Dl) * G;
  const md::TimeJob tj = {a.gsum, a.f.wg1 + trow, ws.dwt, G, N, G};
  err = md::launch_time(&tj, 1, B, a.t, d_time, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  md::ReduceJob red[28];
  int nr = 0;
  for (int k = 0; k < 9; ++k) {
    const int n = jobs[k].k1 * jobs[k].k2;
    red[nr++] = {jobs[k].slots, job_out[k], md::wgrad_slices(jobs[k].rows), n, n};
  }
  const int vec_out[kVecs] = {FB1, FS1, FB1n, FW2, FSg1, FBg1n, FWg2, FB2, FBg2};
  const int vec_n[kVecs] = {I, I, I, I, G, G, G, 1, 1};
  for (int v = 0; v < kVecs; ++v)
    red[nr++] = {a.vecpart + (size_t)v * I, g[vec_out[v]], tiles, vec_n[v], kVecs * I};
  red[nr++] = {a.gsum, g[FBg1], BN, G, G};
  const int node_out[kNodeVecs] = {B1, S1, B1n, B2};
  for (int sd = 0; sd < 2; ++sd)
    for (int v = 0; v < kNodeVecs; ++v)
      red[nr++] = {a.nodepart + (size_t)(sd * kNodeVecs + v) * Dl, g[6 * sd + node_out[v]],
                   ntiles, Dl, 2 * kNodeVecs * Dl};
  red[nr++] = {ws.dwt, g[FWg1] + trow, B, G, G};
  err = md::launch_reduce(red, nr, s);
  if (err != cudaSuccess) return err;
  ++*launched;
  return cudaSuccess;
}

}  // extern "C"
