// PosUpdate, forward, for Hopper (sm_90a).
//
// Replaces moldiff_tpu/ops/pallas_kernels.py:_pos_update_kernel (launched by
// _pallas_pos_update). For every molecule b and receiver i:
//   L, R    = two node MLPs on x (Dn -> Dl -> Dl, bf16)
//   xp[i,j] = bf16(L[i] * R[j])
//   inter   = bf16((e[i,j] @ Wb) * (xp @ Wn))              (interior I = Dn)
//   w       = (relu(LN(inter @ W1 + b1)) @ w2 + b2)         (one scalar per pair)
//           * sigmoid(relu(LN(e @ Wg1e + xp @ Wg1x + t Wg1t + bg1)) @ wg2 + bg2)
//   d'      = mask > 0 ? d : 1
//   out[i]  = sum_j w * rel[i,j] / d' / (d' + 1) * mask     (float32)
// with the bf16 roundings of the Pallas body.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), Dn = I = 256,
// De = Dl = 64, gate hidden 32:
//   FLOPs per molecule: 205,504 per pair + 81,920 per node
//     N = 32: 213.0 MFLOP      N = 40: 332.0 MFLOP
//   bytes per molecule (x, e, rel, dist, mask read once, out written once):
//     N = 32: 168 KB           N = 40: 258 KB   (+ 0.29 MB of weights per call)
//   At B = 16: 3.41 GFLOP / 2.98 MB (N = 32), 5.31 GFLOP / 4.41 MB (N = 40):
//   bound by operations, 3.4 us and 5.4 us (chip_smoke.py work()).
//
// Design (redesigned for Hopper's tensor cores, after node_block.cu and
// edge_pair.cu). A node-level kernel computes L and R once per node (not
// redesigned: two small MLPs over B * N rows). The pair kernel takes the
// pairs in receiver-major order (row rho = (b * N + i) * N + j, e's own
// order) cut into tiles of 64 rows, one wgmma M, so no row idles but a
// CTA's last tile's. A CTA is two warpgroups; each product runs as wgmma
// with the 64-row activation tile (bf16, shared memory) as A and a weight
// as B, the warpgroups splitting the output columns, float32 accumulators
// in registers. Wb, Wn and the gate's e and xp rows (72 KB of bf16 at
// flagship widths) are staged once into shared memory and stay there
// while the CTA walks its tiles; W1 (128 KB) does not fit beside them and
// the tiles, so it streams through the double-buffered cp.async ring
// (wgmma.cuh cta_mma). The next tile's e rows load by cp.async while this
// one runs; xp = bf16(L[i] R[j]) is built per tile from the prep's L and R.
// The bilinear inter = bf16((e @ Wb) * (xp @ Wn)) multiplies the two
// products' float32 accumulators before it rounds, both alive at once (128
// registers a thread at I = 256; nothing else is). The per-column
// parameters (biases, LayerNorm scales, the one-column weights) are staged
// once as float32 in shared memory, where the epilogues read them per
// element. The grid is persistent (one CTA
// per SM): a CTA takes an even share of whole receivers (wgmma.cuh
// tile_range), so a receiver's force closes inside it, its senders' terms
// added one by one in sender order from 0 (wgmma.cuh tile_sums), with no
// atomics and no further launch. Launches: prep, pair = 2.
// The outputs equal those of the first design (a warp per row, WMMA
// products) bit for bit, as a bf16 training gradient can move a leaf by
// half its scale from one-ulp forward differences (chip_smoke.py phase 9):
// the tensor cores' products equal WMMA's, both LayerNorms take md::warp_layernorm's order
// (wgmma.cuh ln_stats_seq), the two one-column layers its lane sums and
// warp_sum tree (row_sums_seq, kSeqDot), and the force sum the serial
// sender order.
#include "grad.cuh"
#include "wgmma.cuh"

using md::bf16;
namespace wg = md::wg;

namespace {

struct Mlp {
  // Linear(Dn,Dl), LN(Dl), Linear(Dl,Dl)
  const bf16 *w1, *b1, *s1, *b1n, *w2, *b2;
};

struct PosArgs {
  Mlp side[2];  // left_lin_edge, right_lin_edge
  // edge_lin BondFFN: bond_linear [De,I], node_linear [Dl,I]; inter:
  // Linear(I,I), LN(I), Linear(I,1); gate: Linear(De+Dl+1,G), LN(G), Linear(G,1)
  const bf16 *wb, *wn, *w1, *b1, *s1, *b1n, *w2, *b2, *wg1, *bg1, *sg1, *bg1n, *wg2, *bg2;
  const bf16* x;       // [B,N,Dn]
  const bf16* e;       // [B,N,N,De]
  const float* rel;    // [B,N,N,3]
  const float* dist;   // [B,N,N]
  const float* mask;   // [B,N,N]
  const float* t;      // [B]
  bf16* lr;            // scratch [2,B,N,Dl]: L and R
  float* out;          // [B,N,3]
  int B, N, Dn, De, Dl, I, G;
  int fused;           // 1: the whole-block kernel's bf16 weight, force w * rel / d / (d + 1)
};

// One CTA per (64 nodes, side): L (side 0) or R (side 1).
__global__ void __launch_bounds__(md::kThreads) pos_prep_kernel(const PosArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = a.Dn + 8, lda = a.Dl + 8, ldc = a.Dl + 4;
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sAct = reinterpret_cast<bf16*>(smem + md::smem_bytes(md::kMaxRows, ldx, 2));
  float* sC = reinterpret_cast<float*>(smem + md::smem_bytes(md::kMaxRows, ldx, 2) +
                                       md::smem_bytes(md::kMaxRows, lda, 2));
  const Mlp& w = a.side[blockIdx.y];
  const int total = a.B * a.N;
  const int row0 = blockIdx.x * md::kMaxRows;
  const int rows = min(md::kMaxRows, total - row0);
  const int mt = (rows + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = a.Dl / 32;
  bf16* lr = a.lr + (size_t)blockIdx.y * total * a.Dl;

  md::load_rows(sX, ldx, rows, mt * 16, a.Dn,
                [&](int r) { return a.x + (size_t)(row0 + r) * a.Dn; });
  __syncthreads();
  md::cta_gemm(sX, ldx, w.w1, a.Dn, a.Dl, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int r = warp; r < mt * 16; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) v[q] = sC[r * ldc + lane + 32 * q] + md::bf(w.b1[lane + 32 * q]);
    md::warp_layernorm(v, nq, w.s1, w.b1n, lane);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) sAct[r * lda + lane + 32 * q] = md::tobf(fmaxf(v[q], 0.0f));
  }
  __syncthreads();
  md::cta_gemm(sAct, lda, w.w2, a.Dl, a.Dl, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * a.Dl; idx += blockDim.x) {
    const int r = idx / a.Dl, c = idx % a.Dl;
    lr[(size_t)(row0 + r) * a.Dl + c] = md::tobf(sC[r * ldc + c] + md::bf(w.b2[c]));
  }
}

template <int DE, int DL, int I, int G>
constexpr size_t pair_smem() {
  return ((size_t)(DE + DL) * (I + G) + 2 * wg::kSlice * wg::kRingCols +
          (size_t)wg::kTileRows * (2 * DE + DL + I)) * sizeof(bf16) +
         (size_t)(64 + 64 * 4 + 4 + 4 * I + 5 * G) * sizeof(float);
}

// A persistent CTA (two warpgroups) per share of the receivers; it walks
// their rows in tiles of 64 (wgmma.cuh tile_range): row rho = (b * N + i)
// * N + j is the pair (receiver i, sender j) of molecule b.
template <int DE, int DL, int I, int G>
__global__ void __launch_bounds__(256, 1) pos_pair_kernel(const PosArgs a) {
  constexpr int R = wg::kTileRows;
  constexpr int NW = I / 2, NA = NW / 2;  // the I-wide products
  constexpr int NG = G / 2, AG = NG / 2;  // the gate's hidden layer
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sWb = reinterpret_cast<bf16*>(smem);  // the resident weights, stage_resident's layout
  bf16* sWn = sWb + DE * I;
  bf16* sWge = sWn + DL * I;                  // the gate's first layer, e rows
  bf16* sWgx = sWge + DE * G;                 // and xp rows
  bf16* ring = sWgx + DL * G;                 // W1, streamed
  bf16* sE = ring + 2 * wg::kSlice * wg::kRingCols;  // two tiles of e
  bf16* sX = sE + 2 * R * DE;                 // xp
  bf16* XI = sX + R * DL;                     // inter (bf16), W1's A
  float* S = reinterpret_cast<float*>(XI + R * I);  // row_sums_seq's row sums
  float* V = S + 64;                          // [64][4] the force terms of a tile
  float* carry = V + 64 * 4;
  // the per-column parameters as float32 (read per element by the epilogues)
  float* pb1 = carry + 4;
  float* ps1 = pb1 + I;
  float* pb1n = ps1 + I;
  float* pw2 = pb1n + I;
  float* pbg1 = pw2 + I;
  float* psg1 = pbg1 + G;
  float* pbg1n = psg1 + G;
  float* pwg2 = pbg1n + G;
  float* pwg1t = pwg2 + G;
  // LayerNorm's and the one-column layers' lane sums, in the ring (free
  // between W1's products)
  float* lnbuf = reinterpret_cast<float*>(ring);
  static_assert(64 * 33 * sizeof(float) <= 2 * wg::kSlice * wg::kRingCols * sizeof(bf16),
                "the lane sums overrun the ring");
  static_assert(I <= wg::kRingCols, "W1 is wider than the ring");

  wg::stage_resident(sWb, a.wb, DE, I);
  wg::stage_resident(sWn, a.wn, DL, I);
  wg::stage_resident(sWge, a.wg1, DE, G);
  wg::stage_resident(sWgx, a.wg1 + (size_t)DE * G, DL, G);
  const bf16* wg1t = a.wg1 + (size_t)(DE + DL) * G;
  for (int c = threadIdx.x; c < I; c += blockDim.x) {
    pb1[c] = md::bf(a.b1[c]);
    ps1[c] = md::bf(a.s1[c]);
    pb1n[c] = md::bf(a.b1n[c]);
    pw2[c] = md::bf(a.w2[c]);
  }
  for (int c = threadIdx.x; c < G; c += blockDim.x) {
    pbg1[c] = md::bf(a.bg1[c]);
    psg1[c] = md::bf(a.sg1[c]);
    pbg1n[c] = md::bf(a.bg1n[c]);
    pwg2[c] = md::bf(a.wg2[c]);
    pwg1t[c] = md::bf(wg1t[c]);
  }

  const uint32_t N = a.N, NN = N * N;
  const size_t BN = (size_t)a.B * N;
  const bf16* lft = a.lr;
  const bf16* rgt = a.lr + BN * DL;
  const wg::TileRange range = wg::tile_range(a.B * N, N);
  const uint32_t tiles = (range.end - range.begin + R - 1) / R;
  const int g = threadIdx.x >> 7, ql = threadIdx.x & 3;
  auto col = [&](int i) { return g * NW + wg::acc_col(i); };
  auto colG = [&](int i) { return g * NG + wg::acc_col(i); };
  auto write = [&](uint32_t node, int c, float v) { a.out[(size_t)node * 3 + c] = v; };
  auto load_e = [&](uint32_t t) {  // tile t's e rows, into buffer t % 2
    const uint32_t rho0 = range.begin + t * R;
    wg::tile_in_async(sE + (t & 1) * R * DE, DE, (int)min((uint32_t)R, range.end - rho0),
                      [&](int r) { return a.e + (size_t)(rho0 + r) * DE; });
  };
  const float zero[2] = {0.0f, 0.0f};
  load_e(0);
  wg::cp_commit();  // the resident weights and tile 0's e
#define ROW(i) (((i) >> 1) & 1)
  for (uint32_t t = 0; t < tiles; ++t) {
    const uint32_t rho0 = range.begin + t * R;
    const int nv = min((uint32_t)R, range.end - rho0);
    const bf16* sEt = sE + (t & 1) * R * DE;
    if (t + 1 < tiles) load_e(t + 1);
    wg::cp_commit();
    wg::cp_wait<1>();  // all but the newest group: this tile's e (and the weights) landed

    // xp = bf16(L[i] R[j]), eight columns a thread
    for (int idx = threadIdx.x; idx < R * (DL / 8); idx += blockDim.x) {
      const int r = idx / (DL / 8), c = (idx % (DL / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nv) {
        const uint32_t rho = rho0 + r;
        const size_t snd = rho / NN * N + rho % N;  // the sender, b * N + j
        const uint4 l = *reinterpret_cast<const uint4*>(lft + (size_t)(rho / N) * DL + c);
        const uint4 q = *reinterpret_cast<const uint4*>(rgt + snd * DL + c);
        const bf16* lv = reinterpret_cast<const bf16*>(&l);
        const bf16* rv = reinterpret_cast<const bf16*>(&q);
        bf16* xv = reinterpret_cast<bf16*>(&v);
#pragma unroll
        for (int k = 0; k < 8; ++k) xv[k] = md::tobf(md::bf(lv[k]) * md::bf(rv[k]));
      }
      *reinterpret_cast<uint4*>(sX + wg::kmaj(r, c, DL)) = v;
    }
    int rw[2];
    float tb[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rw[h] = wg::acc_row(2 * h);
      tb[h] = a.t[(rw[h] < nv ? rho0 + rw[h] : rho0) / NN];
    }

    // inter = bf16((e @ Wb) * (xp @ Wn)), both float32
    {
      float bp[NA], np[NA];
      wg::res_mma<NW>(bp, sEt, DE, sWb);
      wg::res_mma<NW>(np, sX, DL, sWn);
#pragma unroll
      for (int i = 0; i < NA; i += 2)
        md::store2(XI + wg::kmaj(rw[ROW(i)], col(i), I), bp[i] * np[i], bp[i + 1] * np[i + 1]);
    }

    // gate: (e @ Wg1e + xp @ Wg1x) + t Wg1t + bg1, LN, relu, the one-column
    // layer; its sum per row in gsum
    float gsum[2];
    {
      float ge[AG], gx[AG], inv[2];
      wg::res_mma<NG>(ge, sEt, DE, sWge);
      wg::res_mma<NG>(gx, sX, DL, sWgx);
#pragma unroll
      for (int i = 0; i < AG; ++i) {
        const int c = colG(i);
        ge[i] = ge[i] + gx[i] + tb[ROW(i)] * pwg1t[c] + pbg1[c];
      }
      wg::ln_stats_seq(ge, inv, lnbuf, S);
      wg::row_sums_seq<NG, wg::kSeqDot>(
          [&](int i) {
            const int c = colG(i);
            return make_float2(md::rbf(fmaxf(ge[i] * psg1[c] + pbg1n[c], 0.0f)), pwg2[c]);
          },
          zero, gsum, lnbuf, S);
    }

    // inter MLP: Linear -> LN -> relu, then the one-column layer
    float isum[2];
    {
      float acc[NA], inv[2];
      wg::cta_mma<NW, 0>(acc, XI, I, a.w1, ring, false);
#pragma unroll
      for (int i = 0; i < NA; ++i) acc[i] += pb1[col(i)];
      wg::ln_stats_seq(acc, inv, lnbuf, S);
      wg::row_sums_seq<NW, wg::kSeqDot>(
          [&](int i) {
            const int c = col(i);
            return make_float2(md::rbf(fmaxf(acc[i] * ps1[c] + pb1n[c], 0.0f)), pw2[c]);
          },
          zero, isum, lnbuf, S);
    }

    // the force terms w * rel / d' / (d' + 1) * mask, one thread per (row, axis)
    if (g == 0 && ql < 3)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        if (rw[h] < nv) {
          const size_t p = rho0 + rw[h];
          const float sw = isum[h] + md::bf(a.b2[0]);
          const float w = sw * md::sigmoidf(gsum[h] + md::bf(a.bg2[0]));
          const float m = a.mask[p];
          const float d = m > 0.0f ? a.dist[p] : 1.0f;
          const float r = a.rel[p * 3 + ql];
          V[rw[h] * 4 + ql] = a.fused ? md::rbf(w) * r / d / (d + 1.0f) * m
                                      : w * r * (1.0f / d) * (1.0f / (d + 1.0f)) * m;
        }
    __syncthreads();
    // the force sum over senders, in order, per receiver
    wg::tile_sums(V, 4, 3, rho0, nv, N, carry, write);
  }
#undef ROW
}

cudaError_t launch_prep(const PosArgs& a, cudaStream_t s) {
  const size_t prep_smem = md::smem_bytes(md::kMaxRows, a.Dn + 8, 2) +
                           md::smem_bytes(md::kMaxRows, a.Dl + 8, 2) +
                           md::smem_bytes(md::kMaxRows, a.Dl + 4, 4);
  cudaError_t err = cudaFuncSetAttribute(pos_prep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(prep_smem));
  if (err != cudaSuccess) return err;
  dim3 prep_grid((a.B * a.N + md::kMaxRows - 1) / md::kMaxRows, 2);
  pos_prep_kernel<<<prep_grid, md::kThreads, prep_smem, s>>>(a);
  return cudaGetLastError();
}

template <int DE, int DL, int I, int G>
cudaError_t launch_pair(const PosArgs& a, cudaStream_t s) {
  constexpr size_t ps = pair_smem<DE, DL, I, G>();
  // one CTA per SM (the shared memory allows no more), at most one per receiver
  static int slots = 0;
  if (slots == 0) {
    cudaError_t err = cudaFuncSetAttribute(pos_pair_kernel<DE, DL, I, G>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(ps));
    if (err != cudaSuccess) return err;
    slots = wg::persistent_slots(pos_pair_kernel<DE, DL, I, G>, ps);
    if (slots == 0) return cudaErrorInvalidConfiguration;
  }
  pos_pair_kernel<DE, DL, I, G><<<min(wg::capped(slots), a.B * a.N), 256, ps, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

namespace md {

// L and R of every node (the prep kernel), for the backward entry point.
cudaError_t pos_update_prep(const void* const* weights, const bf16* x, bf16* lr, int B, int N,
                            int Dn, int Dl, cudaStream_t s) {
  PosArgs a = {};
  const bf16** w = &a.side[0].w1;
  for (int k = 0; k < 12; ++k) w[k] = static_cast<const bf16*>(weights[k]);
  a.x = x;
  a.lr = lr;
  a.B = B; a.N = N; a.Dn = Dn; a.Dl = Dl;
  return launch_prep(a, s);
}

// The pair kernels, forward and backward (here and in pos_update_bwd.cu),
// are instantiated for the widths of the repo's models (node_dim / edge_dim
// 256 / 64 and 128 / 32: Dn = I = node_dim, De = Dl = edge_dim, G = 32);
// ops/kernels.py's POS_WIDTHS lists the same.
bool pos_update_built(int Dn, int De, int Dl, int I, int G) {
  return (Dn == 256 && De == 64 && Dl == 64 && I == 256 && G == 32) ||
         (Dn == 128 && De == 32 && Dl == 32 && I == 128 && G == 32);
}

cudaError_t pos_update_run(const void* const* weights, const bf16* x, const bf16* e,
                           const float* rel, const float* dist, const float* mask,
                           const float* t, bf16* lr, float* out, int B, int N, int Dn, int De,
                           int Dl, int I, int G, int fused, cudaStream_t s, int* launched) {
  if (!pos_update_built(Dn, De, Dl, I, G)) return cudaErrorInvalidValue;
  PosArgs a;
  const bf16** w = &a.side[0].w1;
  for (int k = 0; k < 26; ++k) w[k] = static_cast<const bf16*>(weights[k]);
  a.x = x;
  a.e = e;
  a.rel = rel;
  a.dist = dist;
  a.mask = mask;
  a.t = t;
  a.lr = lr;
  a.out = out;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.Dl = Dl; a.I = I; a.G = G;
  a.fused = fused;

  cudaError_t err = launch_prep(a, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  err = De == 64 ? launch_pair<64, 64, 256, 32>(a, s) : launch_pair<32, 32, 128, 32>(a, s);
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace md

extern "C" {

// p: 6 left-MLP, 6 right-MLP, 14 edge_lin weights, then x, e, rel, dist,
// mask, t, lr, out.
// *launched: the kernels this call launched (the prep kernel, then the pair
// kernel). The pair kernel is built for the widths of md::pos_update_built
// (else cudaErrorInvalidValue, before any launch).
int md_pos_update_forward(const void* const* p, int B, int N, int Dn, int De, int Dl, int I,
                          int G, void* stream, int* launched) {
  *launched = 0;
  return md::pos_update_run(
      p, static_cast<const bf16*>(p[26]), static_cast<const bf16*>(p[27]),
      static_cast<const float*>(p[28]), static_cast<const float*>(p[29]),
      static_cast<const float*>(p[30]), static_cast<const float*>(p[31]),
      static_cast<bf16*>(const_cast<void*>(p[32])), static_cast<float*>(const_cast<void*>(p[33])),
      B, N, Dn, De, Dl, I, G, 0, static_cast<cudaStream_t>(stream), launched);
}

}  // extern "C"
