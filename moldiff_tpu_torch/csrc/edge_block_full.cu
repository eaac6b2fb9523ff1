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
// operations; chip_smoke.py work() counts them for a call. The tail's own
// kernels alone are bound by bytes: two or three 64-wide products per pair
// against e, ct and the per-pair outputs (about 55 MB forward at B = 128,
// N = 40: 16 us at 3.35 TB/s).
//
// Design (the tail redesigned for Hopper, after edge_pair.cu). The tail
// needs both chains' sums for every pair, and those sums cross the chains'
// tiles, so it runs after edge_pair.cu's prep and pair kernels:
// - tail_prep_kernel: proj_l, proj_r, one CTA per (64 nodes, side), the
//   node FFN's weight and the x tile staged by cp.async, one wgmma chain.
// - tail_fwd_kernel: a persistent grid, each CTA an even share of the
//   tiles of 64 flat pairs, in order (three CTAs per SM); Wsf and Wo stay
//   in shared memory, the next tile's e rows load by cp.async while this
//   one runs, both products run as wgmma (two warpgroups splitting the De
//   columns), h and the LayerNorm in registers, the broadcast terms read
//   per element from L1 and L2 (loaded before the first product).
// Forward launches: chains 2, tail 2 = 4. Its outputs equal those of the
// first design (a warp per row, WMMA products) bit for bit: the tensor
// cores' products equal WMMA's, the LayerNorm takes md::warp_layernorm's
// order (wgmma.cuh ln_stats_seq), and h and the residual add as
// tail_input below does, term by term.
// - tail_bwd_pair_kernel: CTA (b, s) takes an even share (1 / S) of
//   molecule b's rows and walks their pairs in tiles of 64: the recompute
//   (e @ Wsf, h, LayerNorm, relu), ct @ Wo^T, the relu and LayerNorm
//   backward to d_h, d_h @ Wsf^T, its three weights resident. It writes
//   per pair only what later kernels read (the relu output and d_h's hi +
//   lo planes for grad.cu, d_h @ Wsf^T for the chains' backward), closes
//   d_h's sum over a row node's columns inside the CTA (wgmma.cuh
//   tile_sums) and keeps the sum over a column node's rows as a running
//   sum in shared memory, rows in order, written once per CTA. S is about
//   256 / B (2 at B = 128), two CTAs per SM, so a small batch still fills
//   the card.
// - tail_bwd_node_kernel: per 64 nodes, adds a column node's S parts in
//   order and forms the node FFNs' d_node on wgmma, Wnl and Wnr resident.
// Every sum runs in an order fixed by the shapes and every element has one
// writer: no float atomics, a result that does not change from run to run.
// Backward launches: chains 2, tail prep, pair and node 3, the chains'
// backward 6 (no prep), the tail's weight gradients and reductions 2 = 13.
// The out weight's gradient reads ct itself. Outputs go to fresh buffers.
#include "grad.cuh"
#include "wgmma.cuh"

using md::bf16;
namespace wg = md::wg;

namespace {

constexpr int kRows = wg::kTileRows;
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
  const bf16* ct;      // [B,N,N,De] cotangent of the delta (with r, the out weight's operand)
  bf16* r;             // [B,N,N,De] relu output
  md::Split dhs;       // [B,N,N,De] d_h, the self_ffn weight's gradient operand
  float* dbond;        // [B,N,N,De] bf16(d_h) @ Wsf^T
  float* vecpart;      // [B, S, tps, kTailVecs, De] per-tile column sums
  float* colpart;      // [B, S, N, De] d_h over a column node's rows, per row split
  float* dproj;        // [2,B,N,De] d_h summed over columns (0) and rows (1)
  md::Split dprojs;    // the same as the node FFNs' gradient operand
  float* dnode;        // [B,N,Dn] the node FFNs' d_node
  float* nodepart;     // [node tiles, 2, De] column sums of dproj
  int B, N, Dn, De;
  int S, tps;          // row splits of a molecule, tiles a split's slots hold
};

// One CTA per (64 nodes, side): proj[side] = bf16(x @ Wn + bn).
template <int DE>
__global__ void __launch_bounds__(256) tail_prep_kernel(const TailArgs a) {
  constexpr int NW = DE / 2, NA = NW / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dn = a.Dn, side = blockIdx.y;
  bf16* sW = reinterpret_cast<bf16*>(smem);  // [Dn][DE], stage_resident's layout
  bf16* sX = sW + Dn * DE;                   // [64][Dn]
  bf16* sO = sX + kRows * Dn;                // [64][DE]
  const bf16* bn = side == 0 ? a.w.bnl : a.w.bnr;
  const int total = a.B * a.N, row0 = blockIdx.x * kRows;
  const int nv = min(kRows, total - row0);
  wg::stage_resident(sW, side == 0 ? a.w.wnl : a.w.wnr, Dn, DE);
  wg::tile_in_async(sX, Dn, nv, [&](int r) { return a.x + (size_t)(row0 + r) * Dn; });
  wg::cp_commit();
  wg::cp_wait<0>();
  float acc[NA];
  wg::res_mma<NW>(acc, sX, Dn, sW);
  const int g = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int c = g * NW + wg::acc_col(i);
    md::store2(sO + wg::kmaj(wg::acc_row(i), c, DE), acc[i] + md::bf(bn[c]),
               acc[i + 1] + md::bf(bn[c + 1]));
  }
  __syncthreads();
  wg::tile_out(sO, DE, a.proj + (size_t)side * total * DE, [&](int r) { return r < nv; },
               [&](int r) { return row0 + r; });
}

// h of one column: the four broadcast terms and the self term s (e @ Wsf +
// bsf), added as the Pallas body adds them.
__device__ __forceinline__ float tail_h(float t, float u, float pl, float pr, float s,
                                        int residual) {
  if (residual) return md::rbf(md::rbf(md::rbf(t + u) + pl) + pr) + s;
  return t + u + pl + pr + s;
}

// The broadcast terms t[i], u[j], proj_l[i], proj_r[j] of this thread's
// accumulator elements (the warpgroups splitting the De columns), two
// neighbouring columns at a time: row h's row node starts at element ni[h]
// = (b * N + i) * De of tu and proj, its column node at nj[h]. Loaded
// before the product whose epilogue adds them.
template <int NW>
struct TailTerms {
  __nv_bfloat162 v[NW / 4][4];
};

template <int NW>
__device__ __forceinline__ void tail_terms(const TailArgs& a, const size_t (&ni)[2],
                                           const size_t (&nj)[2], TailTerms<NW>& tt) {
  typedef __nv_bfloat162 bf2;
  const size_t side = (size_t)a.B * a.N * a.De;
  const int g = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < NW / 2; i += 2) {
    const int h = (i >> 1) & 1, c = g * NW + wg::acc_col(i);
    tt.v[i / 2][0] = *reinterpret_cast<const bf2*>(a.tu + ni[h] + c);
    tt.v[i / 2][1] = *reinterpret_cast<const bf2*>(a.tu + side + nj[h] + c);
    tt.v[i / 2][2] = *reinterpret_cast<const bf2*>(a.proj + ni[h] + c);
    tt.v[i / 2][3] = *reinterpret_cast<const bf2*>(a.proj + side + nj[h] + c);
  }
}

// v[i] (e @ Wsf at this thread's accumulator element i) becomes h.
template <int NW>
__device__ __forceinline__ void tail_input(const TailArgs& a, float (&v)[NW / 2],
                                           const TailTerms<NW>& tt, const float* pbsf) {
  const int g = threadIdx.x >> 7;
#pragma unroll
  for (int i = 0; i < NW / 2; i += 2) {
    const int c = g * NW + wg::acc_col(i);
    const __nv_bfloat162* x = tt.v[i / 2];
    v[i] = tail_h(md::bf(x[0].x), md::bf(x[1].x), md::bf(x[2].x), md::bf(x[3].x),
                  v[i] + pbsf[c], a.residual);
    v[i + 1] = tail_h(md::bf(x[0].y), md::bf(x[1].y), md::bf(x[2].y), md::bf(x[3].y),
                      v[i + 1] + pbsf[c + 1], a.residual);
  }
}

// Where row h of a tile lies: the element offsets of its row and column
// nodes in tu and proj. Rows past the tile's nv take row 0's. Pair indices
// are 32-bit (B N^2 < 2^32).
__device__ __forceinline__ void tail_nodes(uint32_t p0, int nv, uint32_t N, int De,
                                           size_t (&ni)[2], size_t (&nj)[2]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int rw = wg::acc_row(2 * h);
    const uint32_t p = p0 + (rw < nv ? rw : 0), bi = p / N;  // bi = b * N + i
    ni[h] = (size_t)bi * De;
    nj[h] = ((size_t)(bi / N) * N + (p - bi * N)) * De;
  }
}

template <int DE>
constexpr size_t fwd_smem() {
  return ((size_t)2 * DE * DE + 3 * kRows * DE) * sizeof(bf16) +
         ((size_t)64 * 33 + 64 + 4 * DE) * sizeof(float);
}

// A persistent CTA walks an even share of the tiles of 64 flat pairs, in
// order: the tail, then (residual) e + delta.
template <int DE>
__global__ void __launch_bounds__(256, 3) tail_fwd_kernel(const TailArgs a) {
  constexpr int NW = DE / 2, NA = NW / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sWsf = reinterpret_cast<bf16*>(smem);  // stage_resident's layout
  bf16* sWo = sWsf + DE * DE;
  bf16* sE = sWo + DE * DE;                    // two tiles of e
  bf16* sA = sE + 2 * kRows * DE;              // the relu output, then the output tile
  float* lnbuf = reinterpret_cast<float*>(sA + kRows * DE);  // row_sums_seq's lane sums
  float* S = lnbuf + 64 * 33;
  float* pbsf = S + 64;  // the per-column parameters as float32
  float* psle = pbsf + DE;
  float* pcle = psle + DE;
  float* pbo = pcle + DE;
  wg::stage_resident(sWsf, a.w.wsf, DE, DE);
  wg::stage_resident(sWo, a.w.wo, DE, DE);
  for (int c = threadIdx.x; c < DE; c += blockDim.x) {
    pbsf[c] = md::bf(a.w.bsf[c]);
    psle[c] = md::bf(a.w.sle[c]);
    pcle[c] = md::bf(a.w.cle[c]);
    pbo[c] = md::bf(a.w.bo[c]);
  }
  const size_t N = a.N, P = (size_t)a.B * N * N, tiles = (P + kRows - 1) / kRows;
  const int g = threadIdx.x >> 7;
  auto load = [&](size_t tile, int buf) {
    const size_t p0 = tile * kRows;
    wg::tile_in_async(sE + buf * kRows * DE, DE, (int)min((size_t)kRows, P - p0),
                      [&](int r) { return a.e + (p0 + r) * DE; });
  };
  // this CTA's tiles: an even share of them, in order (neighbouring tiles
  // share a molecule's broadcast rows, which then stay in L1)
  const size_t t0 = tiles * blockIdx.x / gridDim.x, t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  if (t0 < t1) load(t0, 0);
  wg::cp_commit();  // the resident weights and the first tile's e
  int k = 0;
  for (size_t tile = t0; tile < t1; ++tile, ++k) {
    const size_t p0 = tile * kRows;
    const int nv = (int)min((size_t)kRows, P - p0);
    const bf16* sEt = sE + (k & 1) * kRows * DE;
    if (tile + 1 < t1) load(tile + 1, (k + 1) & 1);
    wg::cp_commit();
    wg::cp_wait<1>();  // all but the newest group: this tile's e (and the weights) landed
    size_t ni[2], nj[2];
    tail_nodes((uint32_t)p0, nv, (uint32_t)N, DE, ni, nj);
    TailTerms<NW> tt;
    tail_terms(a, ni, nj, tt);
    float v[NA], inv[2];
    wg::res_mma<NW>(v, sEt, DE, sWsf);
    tail_input(a, v, tt, pbsf);
    wg::ln_stats_seq(v, inv, lnbuf, S);
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int c = g * NW + wg::acc_col(i);
      md::store2(sA + wg::kmaj(wg::acc_row(i), c, DE), fmaxf(v[i] * psle[c] + pcle[c], 0.0f),
                 fmaxf(v[i + 1] * psle[c + 1] + pcle[c + 1], 0.0f));
    }
    wg::res_mma<NW>(v, sA, DE, sWo);
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int c = g * NW + wg::acc_col(i), o = wg::kmaj(wg::acc_row(i), c, DE);
      float d0 = md::rbf(v[i] + pbo[c]), d1 = md::rbf(v[i + 1] + pbo[c + 1]);
      if (a.residual) {
        d0 = md::bf(sEt[o]) + d0;
        d1 = md::bf(sEt[o + 1]) + d1;
      }
      md::store2(sA + o, d0, d1);
    }
    __syncthreads();
    wg::tile_out(sA, DE, a.out, [&](int r) { return r < nv; }, [&](size_t r) { return p0 + r; });
    __syncthreads();  // sA and this tile's e buffer are free
  }
}

template <int DE>
constexpr size_t pair_bwd_smem() {
  return ((size_t)3 * DE * DE + (size_t)6 * kRows * DE) * sizeof(bf16) +
         ((size_t)kRows * (DE + 4) + 64 * DE + 4 * kTailVecs * DE + 4 * DE) * sizeof(float);
}

// CTA (b, s) takes the rows i in [s N / S, (s + 1) N / S) of molecule b (S
// = gridDim.y) and walks their pairs in tiles of 64 (local pair p = (i -
// i0) * N + j, e's order).
template <int DE>
__global__ void __launch_bounds__(256, 2) tail_bwd_pair_kernel(const TailArgs a) {
  constexpr int NW = DE / 2, NA = NW / 2, LDV = DE + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  const int N = a.N, b = blockIdx.x, s = blockIdx.y, S = gridDim.y;
  bf16* sWsf = reinterpret_cast<bf16*>(smem);  // e @ Wsf (MN-major)
  bf16* sWsfT = sWsf + DE * DE;                // d_h @ Wsf^T (K-major)
  bf16* sWoT = sWsfT + DE * DE;                // ct @ Wo^T
  bf16* sE = sWoT + DE * DE;                   // two tiles of e
  bf16* sCt = sE + 2 * kRows * DE;             // two tiles of ct
  bf16* sHi = sCt + 2 * kRows * DE;            // bf16(d_h)
  bf16* sLo = sHi + kRows * DE;                // d_h - bf16(d_h)
  float* V = reinterpret_cast<float*>(sLo + kRows * DE);  // [64][LDV] float32 tile
  float* lnbuf = V;                            // the LayerNorms' sums, before V is written
  float* S64 = V + 64 * 33;
  float* sCol = V + kRows * LDV;               // [N][DE] d_h over a column node's rows
  float* part = sCol + 64 * DE;                // col_sums_tile's
  float* carry = part + 4 * kTailVecs * DE;    // tile_sums'
  float* pbsf = carry + DE;
  float* psle = pbsf + DE;
  float* pcle = psle + DE;
  static_assert(64 * 33 + 64 <= kRows * LDV, "the LayerNorms' sums overrun V");

  wg::stage_resident(sWsf, a.w.wsf, DE, DE);
  wg::stage_resident<1>(sWsfT, a.w.wsf, DE, DE);
  wg::stage_resident<1>(sWoT, a.w.wo, DE, DE);
  for (int c = threadIdx.x; c < DE; c += blockDim.x) {
    pbsf[c] = md::bf(a.w.bsf[c]);
    psle[c] = md::bf(a.w.sle[c]);
    pcle[c] = md::bf(a.w.cle[c]);
  }
  for (int idx = threadIdx.x; idx < N * DE; idx += blockDim.x) sCol[idx] = 0.0f;
  const int i0 = s * N / S, np = ((s + 1) * N / S - i0) * N, nt = (np + kRows - 1) / kRows;
  const size_t base = ((size_t)b * N + i0) * N;  // the CTA's first pair
  auto load = [&](int t, int buf) {
    const size_t p0 = base + (size_t)t * kRows;
    const int nv = min(kRows, np - t * kRows);
    wg::tile_in_async(sE + buf * kRows * DE, DE, nv, [&](int r) { return a.e + (p0 + r) * DE; });
    wg::tile_in_async(sCt + buf * kRows * DE, DE, nv,
                      [&](int r) { return a.ct + (p0 + r) * DE; });
  };
  load(0, 0);
  wg::cp_commit();  // the resident weights and the first tile
  const int g = threadIdx.x >> 7;
  auto col = [&](int i) { return g * NW + wg::acc_col(i); };
  for (int t = 0; t < nt; ++t) {
    const int p0 = t * kRows, nv = min(kRows, np - p0);
    const size_t gp0 = base + p0;
    const bf16* sEt = sE + (t & 1) * kRows * DE;
    const bf16* sCtt = sCt + (t & 1) * kRows * DE;
    if (t + 1 < nt) load(t + 1, (t + 1) & 1);
    wg::cp_commit();
    wg::cp_wait<1>();
    size_t ni[2], nj[2];
    tail_nodes((uint32_t)gp0, nv, (uint32_t)N, DE, ni, nj);
    TailTerms<NW> tt;
    tail_terms(a, ni, nj, tt);

    // the forward recompute: xh <- xhat; the relu output r, stored per pair
    float xh[NA], inv[2];
    wg::res_mma<NW>(xh, sEt, DE, sWsf);
    tail_input(a, xh, tt, pbsf);
    wg::ln_stats_seq(xh, inv, lnbuf, S64);
    unsigned live = 0;  // bit i: element i's LayerNorm output > 0
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int c = col(i), rw = wg::acc_row(i);
      const float l0 = xh[i] * psle[c] + pcle[c], l1 = xh[i + 1] * psle[c + 1] + pcle[c + 1];
      live |= (l0 > 0.0f ? 1u : 0u) << i | (l1 > 0.0f ? 1u : 0u) << (i + 1);
      if (rw < nv) md::store2(a.r + (gp0 + rw) * DE + c, fmaxf(l0, 0.0f), fmaxf(l1, 0.0f));
    }

    // ct @ Wo^T, the relu's backward (dy), the LayerNorm's (d to d_h)
    float dy[NA], d[NA];
    wg::res_mma<NW, 1>(dy, sCtt, DE, sWoT);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      dy[i] = (live >> i) & 1u ? dy[i] : 0.0f;
      d[i] = dy[i];
    }
    wg::ln_bwd(d, xh, inv, a.w.sle, col, DE, lnbuf);
    // this tile's column sums: ct, dy * xhat, dy, d_h
    wg::col_sums_tile<NW, kTailVecs>(
        [&](int i, float (&x)[kTailVecs]) {
          x[0] = md::bf(sCtt[wg::kmaj(wg::acc_row(i), col(i), DE)]);
          x[1] = dy[i] * xh[i];
          x[2] = dy[i];
          x[3] = d[i];
        },
        nv, [&](int v) { return a.vecpart + ((((size_t)b * S + s) * a.tps + t) * kTailVecs + v) * DE; },
        part);

    // d_h as bf16 hi + lo tiles and as float32 (for the node sums)
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int o = wg::kmaj(wg::acc_row(i), col(i), DE);
      const bf16 h0 = md::tobf(d[i]), h1 = md::tobf(d[i + 1]);
      __nv_bfloat162 hv;
      hv.x = h0;
      hv.y = h1;
      *reinterpret_cast<__nv_bfloat162*>(sHi + o) = hv;
      md::store2(sLo + o, d[i] - md::bf(h0), d[i + 1] - md::bf(h1));
    }
    wg::tile_values<NW>(V, LDV, [&](int i) { return d[i]; });
    // d_bond's self term bf16(d_h) @ Wsf^T (its barriers publish the tiles above)
    float ds[NA];
    wg::res_mma<NW, 1>(ds, sHi, DE, sWsfT);
    auto valid = [&](int r) { return r < nv; };
    auto row = [&](int r) { return gp0 + r; };
    wg::tile_out(sHi, DE, a.dhs.hi, valid, row);
    wg::tile_out(sLo, DE, a.dhs.lo, valid, row);
    // d_h over rows: column node j adds this tile's pairs (i, j) in i order
    // (a thread takes column c of every (256 / DE)-th node)
    {
      const int c = threadIdx.x % DE, shift = p0 % N;
      for (int j = threadIdx.x / DE; j < N; j += blockDim.x / DE) {
        int r = j - shift;
        if (r < 0) r += N;
        float sum = sCol[j * DE + c];
        for (; r < nv; r += N) sum += V[r * LDV + c];
        sCol[j * DE + c] = sum;
      }
    }
    // d_h over columns: row node i's pairs in j order, closed inside the CTA
    wg::tile_sums(V, LDV, DE, p0, nv, N, carry, [&](uint32_t node, int c, float v) {
      a.dproj[((size_t)b * N + i0 + node) * DE + c] = v;
    });
    wg::tile_values<NW>(V, LDV, [&](int i) { return ds[i]; });
    __syncthreads();
    for (int idx = threadIdx.x; idx < nv * (DE / 4); idx += blockDim.x) {
      const int r = idx / (DE / 4), c = (idx % (DE / 4)) * 4;
      *reinterpret_cast<float4*>(a.dbond + (gp0 + r) * DE + c) =
          *reinterpret_cast<const float4*>(V + r * LDV + c);
    }
    __syncthreads();  // V and this tile's buffers are free
  }
  // the slots of tiles this CTA does not have, and its part of the column sums
  for (int idx = threadIdx.x; idx < (a.tps - nt) * kTailVecs * DE; idx += blockDim.x)
    a.vecpart[(((size_t)b * S + s) * a.tps + nt) * kTailVecs * DE + idx] = 0.0f;
  for (int idx = threadIdx.x; idx < N * DE; idx += blockDim.x)
    a.colpart[((size_t)b * S + s) * N * DE + idx] = sCol[idx];
}

template <int DE>
size_t node_bwd_smem(int Dn) {
  return ((size_t)2 * Dn * DE + (size_t)2 * kRows * DE) * sizeof(bf16);
}

// One CTA per 64 nodes: d_h over a node's rows (its S parts added in order),
// dproj in float32 and split, the tile's column sums of dproj, and the node
// FFNs' d_node = bf16(dproj_l) @ Wnl^T + bf16(dproj_r) @ Wnr^T.
template <int DE>
__global__ void __launch_bounds__(256) tail_bwd_node_kernel(const TailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dn = a.Dn, N = a.N, S = a.S, total = a.B * N;
  bf16* sWn = reinterpret_cast<bf16*>(smem);  // [2][Dn][DE]: d @ Wnl^T, d @ Wnr^T
  bf16* sL = sWn + 2 * Dn * DE;               // bf16(dproj_l)
  bf16* sR = sL + kRows * DE;                 // bf16(dproj_r)
  wg::stage_resident<1>(sWn, a.w.wnl, DE, Dn);
  wg::stage_resident<1>(sWn + Dn * DE, a.w.wnr, DE, Dn);
  wg::cp_commit();
  const int row0 = blockIdx.x * kRows, nv = min(kRows, total - row0);
  const size_t side = (size_t)total * DE;
  for (int idx = threadIdx.x; idx < kRows * DE; idx += blockDim.x) {
    const int k = idx / DE, c = idx % DE;
    float l = 0.0f, r = 0.0f;
    if (k < nv) {
      const size_t node = row0 + k, o = node * DE + c;
      const float* src = a.colpart + ((node / N) * S * N + node % N) * DE + c;
      for (int q0 = 0; q0 < S; q0 += 8) {  // eight parts' loads in flight, added in order
        float part[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) part[q] = q0 + q < S ? src[(size_t)(q0 + q) * N * DE] : 0.0f;
#pragma unroll
        for (int q = 0; q < 8; ++q)
          if (q0 + q < S) r += part[q];
      }
      l = a.dproj[o];
      a.dproj[side + o] = r;
      md::put(a.dprojs, o, l);
      md::put(a.dprojs, side + o, r);
    }
    sL[wg::kmaj(k, c, DE)] = md::tobf(l);
    sR[wg::kmaj(k, c, DE)] = md::tobf(r);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < 2 * DE; idx += blockDim.x) {
    const int q = idx / DE, c = idx % DE;
    float sum = 0.0f;
    for (int k = 0; k < nv; ++k) sum += a.dproj[q * side + (size_t)(row0 + k) * DE + c];
    a.nodepart[((size_t)blockIdx.x * 2 + q) * DE + c] = sum;
  }
  wg::cp_wait<0>();
  const int g = threadIdx.x >> 7;
  for (int c0 = 0; c0 < Dn; c0 += 32) {  // 32 columns of d_node at a time
    float dn[8];
    wg::res_mma<16, 1>(dn, sL, DE, sWn, false, Dn, c0);
    wg::res_mma<16, 1>(dn, sR, DE, sWn + Dn * DE, true, Dn, c0);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const int r = wg::acc_row(i);
      if (r < nv)
        *reinterpret_cast<float2*>(a.dnode + (size_t)(row0 + r) * Dn + c0 + g * 16 +
                                   wg::acc_col(i)) = make_float2(dn[i], dn[i + 1]);
    }
  }
}

void set_tail_weights(TailArgs& a, const void* const* w) {
  const bf16** dst = &a.w.wnl;
  for (int k = 0; k < 10; ++k) dst[k] = static_cast<const bf16*>(w[k]);
}

// Sets a kernel's dynamic shared memory once, then launches it.
template <typename Kernel>
cudaError_t launch(Kernel kernel, dim3 grid, size_t smem, const TailArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<grid, 256, smem, s>>>(a);
  return cudaGetLastError();
}

template <int DE>
cudaError_t launch_tail_prep(const TailArgs& a, cudaStream_t s) {
  const size_t smem = ((size_t)a.Dn * DE + (size_t)kRows * a.Dn + kRows * DE) * sizeof(bf16);
  return launch(tail_prep_kernel<DE>, dim3((a.B * a.N + kRows - 1) / kRows, 2), smem, a, s);
}

template <int DE>
cudaError_t launch_tail_fwd(const TailArgs& a, cudaStream_t s) {
  constexpr size_t smem = fwd_smem<DE>();
  // a persistent grid: as many CTAs as the SMs hold, at most one per tile
  static int slots = 0;
  if (slots == 0) {
    cudaError_t err = cudaFuncSetAttribute(tail_fwd_kernel<DE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    slots = wg::persistent_slots(tail_fwd_kernel<DE>, smem);
    if (slots == 0) return cudaErrorInvalidConfiguration;
  }
  const size_t tiles = ((size_t)a.B * a.N * a.N + kRows - 1) / kRows;
  tail_fwd_kernel<DE><<<(unsigned)min((size_t)wg::capped(slots), tiles), 256, smem, s>>>(a);
  return cudaGetLastError();
}

// The tail's kernels are instantiated for the chains' widths (De = 64 and
// 32, md::edge_pair_built); Dn is a runtime width (a multiple of 32 up to
// 256, as ops/kernels.py checks).
cudaError_t tail_prep(const TailArgs& a, cudaStream_t s) {
  return a.De == 64 ? launch_tail_prep<64>(a, s) : launch_tail_prep<32>(a, s);
}

struct FullBwdWork {
  float* np;
  float* gpre;
  bf16* tu;
  bf16* proj;
  bf16* r;
  md::Split dhs;
  float* dbond;
  float* vecpart;
  float* colpart;
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

// The tail backward's grid: S CTAs per molecule, each on N / S of its rows
// (about 256 CTAs in all, two per SM, so that a small batch still fills
// the card; the split depends on the shapes alone), and the tiles of 64
// pairs a split's slots hold.
int row_splits(int B, int N) { return max(1, min(N, (256 + B - 1) / B)); }
int split_tiles(int N, int S) { return (((N + S - 1) / S) * N + kRows - 1) / kRows; }

FullBwdWork carve_full(unsigned char* base, int B, int N, int Dn, int De, int I, int G) {
  md::Carve cv{base};
  const size_t P = (size_t)B * N * N, BN = (size_t)B * N;
  FullBwdWork w;
  w.np = cv.take<float>(2 * BN * I);
  w.gpre = cv.take<float>(2 * BN * G);
  w.tu = cv.take<bf16>(2 * BN * De);
  w.proj = cv.take<bf16>(2 * BN * De);
  w.r = cv.take<bf16>(P * De);
  w.dhs = cv.split(P * De);
  w.dbond = cv.take<float>(P * De);
  const int S = row_splits(B, N);
  w.vecpart = cv.take<float>((size_t)B * S * split_tiles(N, S) * kTailVecs * De);
  w.colpart = cv.take<float>((size_t)B * S * N * De);
  w.dproj = cv.take<float>(2 * BN * De);
  w.dprojs = cv.split(2 * BN * De);
  w.dnode = cv.take<float>(BN * Dn);
  w.nodepart = cv.take<float>((BN + kRows - 1) / kRows * 2 * De);
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
  if (De != 64 && De != 32) return cudaErrorInvalidValue;
  TailArgs a = {};
  set_tail_weights(a, weights);
  a.e = e;
  a.x = x;
  a.tu = tu;
  a.proj = proj;
  a.out = out;
  a.residual = residual;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De;
  cudaError_t err = tail_prep(a, s);
  if (err != cudaSuccess) return err;
  ++*launched;
  err = De == 64 ? launch_tail_fwd<64>(a, s) : launch_tail_fwd<32>(a, s);
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
// built for the widths of md::edge_pair_built.
int md_edge_block_full_backward(const void* const* p, int B, int N, int Dn, int De, int I, int G,
                                void* stream, int* launched) {
  if (!md::edge_pair_built(De, I, G, De)) return cudaErrorInvalidValue;
  const bf16* e = static_cast<const bf16*>(p[38]);
  const bf16* x = static_cast<const bf16*>(p[39]);
  const float* mask = static_cast<const float*>(p[40]);
  const float* t = static_cast<const float*>(p[41]);
  const bf16* ct = static_cast<const bf16*>(p[42]);
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
  a.ct = ct;
  a.r = w.r;
  a.dhs = w.dhs;
  a.dbond = w.dbond;
  a.vecpart = w.vecpart;
  a.colpart = w.colpart;
  a.dproj = w.dproj;
  a.dprojs = w.dprojs;
  a.dnode = w.dnode;
  a.nodepart = w.nodepart;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De;
  a.S = row_splits(B, N);
  a.tps = split_tiles(N, a.S);
  err = tail_prep(a, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  // the tail's backward: per pair (the row sums of d_h closed, the column
  // sums in parts), then per node
  const int BN = B * N, ntiles = (BN + kRows - 1) / kRows;
  err = De == 64 ? launch(tail_bwd_pair_kernel<64>, dim3(B, a.S), pair_bwd_smem<64>(), a, s)
                 : launch(tail_bwd_pair_kernel<32>, dim3(B, a.S), pair_bwd_smem<32>(), a, s);
  if (err != cudaSuccess) return err;
  ++*launched;
  err = De == 64 ? launch(tail_bwd_node_kernel<64>, dim3(ntiles), node_bwd_smem<64>(Dn), a, s)
                 : launch(tail_bwd_node_kernel<32>, dim3(ntiles), node_bwd_smem<32>(Dn), a, s);
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
      {w.r, nullptr, ct, nullptr, w.slots[0], tj[0].rows, De, De, De, De},
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
    red[nr++] = {w.vecpart + (size_t)v * De, g[vec_out[v]], B * a.S * a.tps, De,
                 kTailVecs * De};
  for (int side = 0; side < 2; ++side)
    red[nr++] = {w.nodepart + (size_t)side * De, g[1 + 2 * side], ntiles, De, 2 * De};
  err = md::launch_reduce(red, nr, s);
  if (err != cudaSuccess) return err;
  ++*launched;
  return cudaSuccess;
}

}  // extern "C"
