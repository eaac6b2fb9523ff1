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
// split, plus the H x H gate product and two H x De products) come to about
// 1.0 MFLOP per pair; the weight-gradient products (A^T B for five pair
// matrices) add about 0.6 MFLOP per pair and 0.8 MFLOP per node.
// chip_smoke.py work() counts them for the call, in both modes. Bytes: e,
// mask and d_edge, d_mask per pair, x, dout and dx per node, weights and
// their gradients once: bound by operations.
//
// Design (redesigned for Hopper's tensor cores). The forward sums over
// senders j inside a receiver-row tile; the backward's sums run the other
// way: dx[j] gets, through xn[j] and the gate's x_j part, a sum over
// receivers i. So the pairs are taken in sender-major order (row rho =
// (b * N + j) * N + i) and cut into tiles of 64 rows, one wgmma M; a tile
// holds whole and partial senders, so no row idles (at N = 32 two whole
// senders; at N = 40 a tile's 64 rows span two or three). A CTA is two
// warpgroups; each product of the chain runs as wgmma with the 64-row
// activation tile (bf16, shared memory) as A and a weight as B, the
// warpgroups splitting the output columns; the weights' K-slices are
// staged into shared memory by cp.async, double-buffered and shared by
// both warpgroups, and the accumulators stay in registers. The epilogues
// (bias, LayerNorm forward and backward, sigmoid and relu gates, the
// cotangents, the hi/lo splits) run on the registers; row statistics close
// in the lane quads and across the two warpgroups through a few hundred
// bytes of shared memory, and only the bf16 A operand of the next product
// goes to shared memory. The sums over receivers close per sender inside
// the CTA (col_sums, a fixed order) into two parts, the tile of the
// sender's first row and the next one; the node-level kernel adds the
// parts in order and forms dx. d_t is a per-molecule sum of the senders'
// d_g1 sums (grad.cu's time kernel).
//
// Two modes. With parameter gradients (training) the pair kernel also
// writes per pair, in tile order (contiguous rows, staged through shared
// memory), the activations (e, r1, hh, rg, bf16) and cotangents (d_h1, d_h,
// d_msg, d_g1, d_g2, float32 as bf16 hi + lo planes) their weight
// gradients need, and per-tile column sums; grad.cu's weight-gradient and
// reduction kernels form the parameter gradients (no float atomics: the
// result is reproducible). Launches: prep (node_block.cu), pair, node,
// weight gradients, time, reduction = 6. Inputs only (guidance: nothing
// reads the parameter gradients): prep, pair, node, and the time kernel
// if d_t is asked for = 4 (3 without d_t); every output it forms equals
// the full mode's bit for bit, since the same arithmetic makes it.
#include "grad.cuh"
#include "wgmma.cuh"

using md::bf16;
namespace wg = md::wg;

namespace {

constexpr int kVecs = 8;  // per-tile column sums for the parameter gradients, in this order:
enum { kBm = 0, kBg2, kBe2, kBe1, kSe1, kBe1n, kSg1, kBg1n };
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
  float* dxnpart;      // [B*N, 2, H] per sender: sum over receivers of d_hh * h, in two
                       // parts (the tile of its first row, the next tile)
  float* sendpart;     // [B*N, 2, H] the same for d_g1
  float* ssum;         // [B*N, H] the two parts of sendpart added
  // per pair in tile order (see node_bwd_pair_kernel), for the weight
  // gradients (need_params)
  bf16 *eT, *r1, *hh, *rg;
  md::Split dh1, dh, dmsg, dg1, dg2;
  float* vecpart;      // [tiles, kVecs, H]
  // per node (need_params)
  bf16* rn;
  md::Split dhn1, dxn, ssend;
  float* nodepart;     // [node tiles, kNodeVecs, H]
  int B, N, Dn, De, H;
  int need_params;
};

__host__ __device__ inline int ldf_of(int H, int D) { return (H > D ? H : D) + 4; }

template <int H, int DE>
constexpr size_t pair_smem() {
  return (size_t)wg::kTileRows * (DE + 4 * H) * sizeof(bf16) +
         (size_t)2 * wg::kSlice * wg::kRingCols * sizeof(bf16) +
         (size_t)(2 * 64 * 2 + 4 * H) * sizeof(float);
}

__host__ inline size_t node_smem(int Dn, int H) {
  return md::smem_bytes(md::kBwdRows, Dn + 8, 2) + 3 * md::smem_bytes(md::kBwdRows, H + 8, 2) +
         2 * md::smem_bytes(md::kBwdRows, ldf_of(H, Dn), 4) +
         (size_t)md::kWarps * 3 * H * sizeof(float);
}

// One CTA (two warpgroups) per tile of 64 consecutive rows in sender-major
// order: row rho = (b * N + j) * N + i is the pair (receiver i, sender j)
// of molecule b, so a tile holds whole and partial senders (at most three
// at N >= 32) and no row idles but the last tile's.
template <int H, int DE>
__global__ void __launch_bounds__(256, 1) node_bwd_pair_kernel(const NodeBwdArgs a) {
  constexpr int R = wg::kTileRows;
  constexpr int NW = H / 2, NA = NW / 2, NWE = DE / 2, NAE = NWE / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sE = reinterpret_cast<bf16*>(smem);
  bf16* XA = sE + R * DE;
  bf16* XB = XA + R * H;
  bf16* XC = XB + R * H;
  bf16* XD = XC + R * H;
  bf16* ring = XD + R * H;
  float* red = reinterpret_cast<float*>(ring + 2 * wg::kSlice * wg::kRingCols);
  float* part = red + 2 * 64 * 2;

  const uint32_t N = a.N, NN = N * N;
  const uint32_t rho0 = blockIdx.x * R;
  const int nv = min((uint32_t)R, a.B * NN - rho0);
  const uint32_t node0 = rho0 / N;
  const int nseg = (rho0 + nv - 1) / N - node0 + 1;
  const bool P = a.need_params;
  auto valid = [&](int r) { return r < nv; };
  auto at = [&](int r) { return rho0 + r; };  // the per-pair operands' row
  auto pair = [&](int r) -> uint32_t {
    const uint32_t rho = rho0 + r, b = rho / NN;
    return (b * N + rho % N) * N + (rho / N) % N;
  };
  auto seg_tile = [&](int r) { return valid(r) ? 0 : -1; };
  auto seg_send = [&](int r) { return valid(r) ? (int)((rho0 + r) / N - node0) : -1; };
  auto vec = [&](int v) { return a.vecpart + ((size_t)blockIdx.x * kVecs + v) * H; };
  // a sender's sums: part 0 from the tile of its first row, part 1 from the next
  auto per_send = [&](float* base) {
    return [=](int s) {
      const uint32_t node = node0 + s;
      return base + ((size_t)node * 2 + (node * N < rho0 ? 1 : 0)) * H;
    };
  };

  for (int idx = threadIdx.x; idx < R * (DE / 8); idx += blockDim.x) {
    const int r = idx / (DE / 8), c = (idx % (DE / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (valid(r)) v = *reinterpret_cast<const uint4*>(a.e + (size_t)pair(r) * DE + c);
    *reinterpret_cast<uint4*>(sE + wg::kmaj(r, c, DE)) = v;
  }
  if (P) {  // e in tile order, the A of two weight-gradient products
    __syncthreads();
    wg::tile_out(sE, DE, a.eT, valid, at);
  }

  const int g = threadIdx.x >> 7;
  auto col = [&](int i) { return g * NW + wg::acc_col(i); };
  int rw[2];
  bool ok[2];
  uint32_t pr[2], nd[2], rcv[2];  // pair, sender and receiver (B * N * N < 2^32)
  float msk[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rw[h] = wg::acc_row(2 * h);
    ok[h] = valid(rw[h]);
    const uint32_t rho = ok[h] ? rho0 + rw[h] : 0;
    pr[h] = ok[h] ? pair(rw[h]) : 0;
    nd[h] = rho / N;
    rcv[h] = rho / NN * N + rho % N;
    msk[h] = ok[h] ? a.mask[pr[h]] : 0.0f;
  }
#define ROW(i) (((i) >> 1) & 1)
  float acc[NA], aux[NA], de[NAE], inv[2];

  // ---- forward recompute: gate (rg), its float32 sigmoid kept in aux -------
  wg::cta_mma<NW, 0>(acc, sE, DE, a.wg1, ring, false);
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] += a.gpre[nd[ROW(i)] * H + col(i)];
  wg::ln_stats(acc, inv, H, red);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int c = col(i), h = ROW(i);
    const float g0 = fmaxf(acc[i] * md::bf(a.sg1[c]) + md::bf(a.bg1n[c]), 0.0f);
    const float g1 = fmaxf(acc[i + 1] * md::bf(a.sg1[c + 1]) + md::bf(a.bg1n[c + 1]), 0.0f);
    md::store2(XA + wg::kmaj(rw[h], c, H), g0, g1);
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XA, H, a.rg, valid, at);
  }
  wg::cta_mma<NW, 0>(acc, XA, H, a.wg2, ring, false);
#pragma unroll
  for (int i = 0; i < NA; ++i) aux[i] = md::sigmoidf(acc[i] + md::bf(a.bg2[col(i)]));

  // ---- edge MLP (r1, h) and the bilinear product hh ------------------------
  wg::cta_mma<NW, 0>(acc, sE, DE, a.we1, ring, false);
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] += md::bf(a.be1[col(i)]);
  wg::ln_stats(acc, inv, H, red);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int c = col(i), h = ROW(i);
    const float r0 = fmaxf(acc[i] * md::bf(a.se1[c]) + md::bf(a.be1n[c]), 0.0f);
    const float r1 = fmaxf(acc[i + 1] * md::bf(a.se1[c + 1]) + md::bf(a.be1n[c + 1]), 0.0f);
    md::store2(XA + wg::kmaj(rw[h], c, H), r0, r1);
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XA, H, a.r1, valid, at);
  }
  wg::cta_mma<NW, 0>(acc, XA, H, a.we2, ring, false);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int c = col(i), h = ROW(i);
    const float h0 = md::rbf(acc[i] + md::bf(a.be2[c]));
    const float h1 = md::rbf(acc[i + 1] + md::bf(a.be2[c + 1]));
    const bf16* xn = a.xn + nd[h] * H + c;
    const float q0 = h0 * md::bf(xn[0]), q1 = h1 * md::bf(xn[1]);
    md::store2(XA + wg::kmaj(rw[h], c, H), h0, h1);  // h, kept for d_xn
    md::store2(XB + wg::kmaj(rw[h], c, H), q0, q1);
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XB, H, a.hh, valid, at);
  }
  wg::cta_mma<NW, 0>(acc, XB, H, a.wm, ring, false);

  // ---- cotangents at the message (acc) and the gate (aux), d_mask ----------
  {
    float dm[2][1] = {};
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int c = col(i), h = ROW(i);
      const float msg = md::rbf(acc[i] + md::bf(a.bm[c]));
      const float sig = aux[i];
      const float d = ok[h] ? md::bf(a.dout[rcv[h] * H + c]) : 0.0f;
      const float dg = d * msk[h];
      acc[i] = dg * sig;
      aux[i] = dg * msg * sig * (1.0f - sig);
      dm[h][0] += d * (msg * sig);
    }
    wg::row_sums<1>(dm, red);
    if (g == 0 && (threadIdx.x & 3) == 0)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (ok[h]) a.d_mask[pr[h]] = dm[h][0];
  }
  if (P) {
    wg::col_sums<NW>([&](int i) { return acc[i]; }, 1, seg_tile, [&](int) { return vec(kBm); },
                     part);
    wg::col_sums<NW>([&](int i) { return aux[i]; }, 1, seg_tile, [&](int) { return vec(kBg2); },
                     part);
  }
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int h = ROW(i), o = wg::kmaj(rw[h], col(i), H);
    const bf16 h0 = md::tobf(acc[i]), h1 = md::tobf(acc[i + 1]);
    md::store2(XB + o, md::bf(h0), md::bf(h1));
    md::store2(XC + o, acc[i] - md::bf(h0), acc[i + 1] - md::bf(h1));
    const bf16 g0 = md::tobf(aux[i]), g1 = md::tobf(aux[i + 1]);
    md::store2(XD + o, md::bf(g0), md::bf(g1));
    if (P) md::store2(ring + o, aux[i] - md::bf(g0), aux[i + 1] - md::bf(g1));
  }
  if (P) {  // the operands as hi + lo planes; d_g2's low half staged in the ring
    __syncthreads();
    wg::tile_out(XB, H, a.dmsg.hi, valid, at);
    wg::tile_out(XC, H, a.dmsg.lo, valid, at);
    wg::tile_out(XD, H, a.dg2.hi, valid, at);
    wg::tile_out(ring, H, a.dg2.lo, valid, at);
    __syncthreads();
  }

  // ---- d_hh = d_msg @ Wm^T; d_h and the sender sums of d_hh * h ------------
  wg::cta_mma<NW, 1>(acc, XB, H, a.wm, ring, false, XC);
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int c = col(i), h = ROW(i);
    aux[i] = acc[i] * md::bf(XA[wg::kmaj(rw[h], c, H)]);
    acc[i] *= md::bf(a.xn[nd[h] * H + c]);
  }
  wg::col_sums<NW>([&](int i) { return aux[i]; }, nseg, seg_send, per_send(a.dxnpart), part);
  if (P)
    wg::col_sums<NW>([&](int i) { return acc[i]; }, 1, seg_tile, [&](int) { return vec(kBe2); },
                     part);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int o = wg::kmaj(rw[ROW(i)], col(i), H);
    const bf16 h0 = md::tobf(acc[i]), h1 = md::tobf(acc[i + 1]);
    md::store2(XB + o, md::bf(h0), md::bf(h1));
    md::store2(XC + o, acc[i] - md::bf(h0), acc[i + 1] - md::bf(h1));
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XB, H, a.dh.hi, valid, at);
    wg::tile_out(XC, H, a.dh.lo, valid, at);
  }

  // ---- edge MLP backward: d_r1 = d_h @ We2^T, LayerNorm, d_h1 --------------
  wg::cta_mma<NW, 1>(acc, XB, H, a.we2, ring, false, XC);
  wg::cta_mma<NW, 0>(aux, sE, DE, a.we1, ring, false);
#pragma unroll
  for (int i = 0; i < NA; ++i) aux[i] += md::bf(a.be1[col(i)]);
  wg::ln_stats(aux, inv, H, red);
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int c = col(i);
    const float ln = aux[i] * md::bf(a.se1[c]) + md::bf(a.be1n[c]);
    acc[i] = ln > 0.0f ? acc[i] : 0.0f;
  }
  if (P) {
    wg::col_sums<NW>([&](int i) { return acc[i] * aux[i]; }, 1, seg_tile,
                     [&](int) { return vec(kSe1); }, part);
    wg::col_sums<NW>([&](int i) { return acc[i]; }, 1, seg_tile, [&](int) { return vec(kBe1n); },
                     part);
  }
  wg::ln_bwd(acc, aux, inv, a.se1, col, H, red);
  if (P)
    wg::col_sums<NW>([&](int i) { return acc[i]; }, 1, seg_tile, [&](int) { return vec(kBe1); },
                     part);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int o = wg::kmaj(rw[ROW(i)], col(i), H);
    const bf16 h0 = md::tobf(acc[i]), h1 = md::tobf(acc[i + 1]);
    md::store2(XA + o, md::bf(h0), md::bf(h1));
    if (P) md::store2(ring + o, acc[i] - md::bf(h0), acc[i + 1] - md::bf(h1));
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XA, H, a.dh1.hi, valid, at);
    wg::tile_out(ring, H, a.dh1.lo, valid, at);
    __syncthreads();
  }
  // d_e (edge part) = bf16(d_h1) @ We1^T
  wg::cta_mma<NWE, 1>(de, XA, H, a.we1, ring, false);

  // ---- gate backward: d_rg = bf16(d_g2) @ Wg2^T, LayerNorm, d_g1 -----------
  wg::cta_mma<NW, 1>(acc, XD, H, a.wg2, ring, false);
  wg::cta_mma<NW, 0>(aux, sE, DE, a.wg1, ring, false);
#pragma unroll
  for (int i = 0; i < NA; ++i) aux[i] += a.gpre[nd[ROW(i)] * H + col(i)];
  wg::ln_stats(aux, inv, H, red);
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int c = col(i);
    const float ln = aux[i] * md::bf(a.sg1[c]) + md::bf(a.bg1n[c]);
    acc[i] = ln > 0.0f ? acc[i] : 0.0f;
  }
  if (P) {
    wg::col_sums<NW>([&](int i) { return acc[i] * aux[i]; }, 1, seg_tile,
                     [&](int) { return vec(kSg1); }, part);
    wg::col_sums<NW>([&](int i) { return acc[i]; }, 1, seg_tile, [&](int) { return vec(kBg1n); },
                     part);
  }
  wg::ln_bwd(acc, aux, inv, a.sg1, col, H, red);
  wg::col_sums<NW>([&](int i) { return acc[i]; }, nseg, seg_send, per_send(a.sendpart), part);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int o = wg::kmaj(rw[ROW(i)], col(i), H);
    const bf16 h0 = md::tobf(acc[i]), h1 = md::tobf(acc[i + 1]);
    md::store2(XD + o, md::bf(h0), md::bf(h1));
    if (P) md::store2(ring + o, acc[i] - md::bf(h0), acc[i + 1] - md::bf(h1));
  }
  if (P) {
    __syncthreads();
    wg::tile_out(XD, H, a.dg1.hi, valid, at);
    wg::tile_out(ring, H, a.dg1.lo, valid, at);
    __syncthreads();
  }
  // d_e += bf16(d_g1) @ Wg1e^T
  wg::cta_mma<NWE, 1>(de, XD, H, a.wg1, ring, true);
#pragma unroll
  for (int i = 0; i < NAE; i += 2)
    md::store2(sE + wg::kmaj(rw[ROW(i)], g * NWE + wg::acc_col(i), DE), de[i], de[i + 1]);
  __syncthreads();
  wg::tile_out(sE, DE, a.d_edge, valid, pair);
#undef ROW
}

// One CTA per 32 nodes (flattened over molecules): the node MLP backward
// and dx from the pair kernel's sender sums (not redesigned: a small share
// of the call).
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
      const size_t node = n0 + (valid ? r : 0), nrow = node * H;
      // does the sender's run of N rows cross a pair tile's edge?
      const bool two = (node * a.N) / wg::kTileRows != (node * a.N + a.N - 1) / wg::kTileRows;
      auto parts = [&](const float* p, int c) {
        const float s0 = p[2 * nrow + c];
        return two ? s0 + p[2 * nrow + H + c] : s0;
      };
#pragma unroll
      for (int q = 0; q < md::kMaxPerLane; ++q)
        if (q < nq) {
          const int c = lane + 32 * q;
          const float dxn = valid ? parts(a.dxnpart, c) : 0.0f;
          const float ss = valid ? parts(a.sendpart, c) : 0.0f;
          if (valid) a.ssum[nrow + c] = ss;
          F[0][r * ldf + c] = dxn;
          F[1][r * ldf + c] = ss;
          acc[0][q] += dxn;
          if (valid && a.need_params) {
            md::put(a.dxn, nrow + c, dxn);
            md::put(a.ssend, nrow + c, ss);
          }
        }
    }
    if (a.need_params)
      md::flush_columns<1>(acc, nq, sPart, npart + 3 * H, H);
    else
      __syncthreads();
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
          if (r < rows && a.need_params)
            a.rn[(size_t)(n0 + r) * H + c] = md::tobf(fmaxf(ln, 0.0f));
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
          if (r < rows && a.need_params) md::put(a.dhn1, (size_t)(n0 + r) * H + c, dy[q]);
        }
    }
    if (a.need_params)
      md::flush_columns<3>(acc, nq, sPart, npart, H);
    else
      __syncthreads();
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
  float* dwt;          // [B, H] per-molecule shares of the gate's time row
  float* slots[8];
  size_t bytes;
};

NodeBwdWork carve(NodeBwdArgs& a, unsigned char* base, int B, int N, int Dn, int De, int H,
                  int need_params) {
  md::Carve cv{base};
  const size_t P = (size_t)B * N * N, BN = (size_t)B * N;
  const size_t tiles = (P + wg::kTileRows - 1) / wg::kTileRows;
  const size_t ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  NodeBwdWork w = {};
  w.xn = cv.take<bf16>(BN * H);
  w.gpre = cv.take<float>(BN * H);
  a.dxnpart = cv.take<float>(BN * 2 * H);
  a.sendpart = cv.take<float>(BN * 2 * H);
  a.ssum = cv.take<float>(BN * H);
  if (need_params) {
    a.eT = cv.take<bf16>(P * De);
    a.r1 = cv.take<bf16>(P * H);
    a.hh = cv.take<bf16>(P * H);
    a.rg = cv.take<bf16>(P * H);
    a.dh1 = cv.split(P * H);
    a.dh = cv.split(P * H);
    a.dmsg = cv.split(P * H);
    a.dg1 = cv.split(P * H);
    a.dg2 = cv.split(P * H);
    a.vecpart = cv.take<float>(tiles * kVecs * H);
    a.rn = cv.take<bf16>(BN * H);
    a.dhn1 = cv.split(BN * H);
    a.dxn = cv.split(BN * H);
    a.ssend = cv.split(BN * H);
    a.nodepart = cv.take<float>(ntiles * kNodeVecs * H);
    w.dwt = cv.take<float>((size_t)B * H);
    const int P_ = (int)P, BN_ = (int)BN;
    const int dims[8][3] = {{P_, De, H}, {P_, H, H}, {P_, H, H}, {P_, De, H},
                            {P_, H, H},  {BN_, Dn, H}, {BN_, H, H}, {BN_, Dn, H}};
    for (int k = 0; k < 8; ++k)
      w.slots[k] = cv.take<float>(md::wgrad_slot_floats(dims[k][0], dims[k][1], dims[k][2]));
  }
  a.need_params = need_params;
  w.bytes = cv.off;
  return w;
}

template <int H, int DE>
cudaError_t launch_pair(const NodeBwdArgs& a, int tiles, cudaStream_t s) {
  constexpr size_t ps = pair_smem<H, DE>();
  cudaError_t err = cudaFuncSetAttribute(node_bwd_pair_kernel<H, DE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(ps));
  if (err != cudaSuccess) return err;
  node_bwd_pair_kernel<H, DE><<<tiles, 256, ps, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

long long md_node_block_backward_workspace(int B, int N, int Dn, int De, int H,
                                           int need_params) {
  NodeBwdArgs a = {};
  return (long long)carve(a, nullptr, B, N, Dn, De, H, need_params).bytes;
}

// p: the 20 weights (NodeBlockArgs order), x, e, mask, t, dout, then the
// outputs dx, d_edge, d_t, d_mask and the 20 float32 parameter gradients in
// the weights' order (the gate's first-layer weight as one [De+Dn+1, H]
// matrix), then the workspace (md_node_block_backward_workspace bytes).
// need_params = 0: the parameter gradients are not formed (their pointers
// may be null); need_time = 0: d_t is not formed (may be null). The pair
// kernel is built for the widths of md::node_block_built.
int md_node_block_backward(const void* const* p, int B, int N, int Dn, int De, int H,
                           int need_params, int need_time, void* stream, int* launched) {
  if (!md::node_block_built(H, De)) return cudaErrorInvalidValue;
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
  float* d_t = need_time ? static_cast<float*>(const_cast<void*>(p[27])) : nullptr;
  a.d_mask = static_cast<float*>(const_cast<void*>(p[28]));
  float* g[20];
  for (int k = 0; k < 20; ++k) g[k] = static_cast<float*>(const_cast<void*>(p[29 + k]));
  NodeBwdWork ws = carve(a, static_cast<unsigned char*>(const_cast<void*>(p[49])), B, N, Dn,
                         De, H, need_params);
  a.xn = ws.xn;
  a.gpre = ws.gpre;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;

  cudaError_t err = md::node_block_prep(p, a.x, t, ws.xn, ws.gpre, B, N, Dn, De, H, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  const int BN = B * N, P = BN * N;
  const int tiles = (P + wg::kTileRows - 1) / wg::kTileRows;
  const int ntiles = (BN + md::kBwdRows - 1) / md::kBwdRows;
  err = H == 256 ? launch_pair<256, 64>(a, tiles, s) : launch_pair<128, 32>(a, tiles, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  const size_t ns = node_smem(Dn, H);
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
      {a.eT, nullptr, a.dh1.hi, a.dh1.lo, ws.slots[0], P, De, H, De, H},
      {a.r1, nullptr, a.dh.hi, a.dh.lo, ws.slots[1], P, H, H, H, H},
      {a.hh, nullptr, a.dmsg.hi, a.dmsg.lo, ws.slots[2], P, H, H, H, H},
      {a.eT, nullptr, a.dg1.hi, a.dg1.lo, ws.slots[3], P, De, H, De, H},
      {a.rg, nullptr, a.dg2.hi, a.dg2.lo, ws.slots[4], P, H, H, H, H},
      {a.x, nullptr, a.dhn1.hi, a.dhn1.lo, ws.slots[5], BN, Dn, H, Dn, H},
      {a.rn, nullptr, a.dxn.hi, a.dxn.lo, ws.slots[6], BN, H, H, H, H},
      {a.x, nullptr, a.ssend.hi, a.ssend.lo, ws.slots[7], BN, Dn, H, Dn, H},
  };
  if (need_params) {
    err = md::launch_wgrad(jobs, 8, s);
    if (err != cudaSuccess) return err;
    ++*launched;
  }

  // d_t and the molecules' shares of the gate weight's time row
  const size_t trow = (size_t)(De + Dn) * H;
  if (need_params || need_time) {
    const md::TimeJob tj = {a.ssum, a.wg1 + trow, need_params ? ws.dwt : nullptr, H, N, H};
    err = md::launch_time(&tj, 1, B, t, d_t, s);
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  if (!need_params) return cudaSuccess;

  float* const job_out[8] = {g[We1], g[We2], g[Wm], g[Wg1], g[Wg2], g[Wn1], g[Wn2],
                             g[Wg1] + (size_t)De * H};
  md::ReduceJob red[22];
  int nr = 0;
  for (int k = 0; k < 8; ++k) {
    const int n = jobs[k].k1 * jobs[k].k2;
    red[nr++] = {ws.slots[k], job_out[k], md::wgrad_slices(jobs[k].rows), n, n};
  }
  const int vec_out[kVecs] = {Bm, Bg2, Be2, Be1, Se1, Be1n, Sg1, Bg1n};
  for (int v = 0; v < kVecs; ++v)
    red[nr++] = {a.vecpart + (size_t)v * H, g[vec_out[v]], tiles, H, kVecs * H};
  red[nr++] = {a.ssum, g[Bg1], BN, H, H};
  const int node_out[kNodeVecs] = {Bn1, Sn1, Bn1n, Bn2};
  for (int v = 0; v < kNodeVecs; ++v)
    red[nr++] = {a.nodepart + (size_t)v * H, g[node_out[v]], ntiles, H, kNodeVecs * H};
  red[nr++] = {ws.dwt, g[Wg1] + trow, B, H, H};
  err = md::launch_reduce(red, nr, s);
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // extern "C"
