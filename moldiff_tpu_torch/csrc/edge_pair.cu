// EdgeBlock pair aggregate, forward, for Hopper (sm_90a).
//
// Replaces moldiff_tpu/ops/pallas_kernels.py:_edge_pair_kernel (launched by
// _pallas_edge_pair_aggregate). Two gated BondFFN chains run over every
// directed pair (i, j) of a molecule, interior width I = 2 De:
//   left : node features of the row i,    t[j] = sum_i mask * msg_left[i,j]
//   right: node features of the column j, u[i] = sum_j mask * msg_right[i,j]
// with, per chain,
//   inter = bf16((e @ Wb) * (x[node] @ Wn))          (both float32)
//   out   = relu(LN(inter @ W1 + b1)) @ W2 + b2      (float32)
//   gate  = sigmoid(relu(LN(e @ Wg1e + x[node] @ Wg1x + t Wg1t + bg1)) @ Wg2 + bg2)
//   msg   = out * gate                               (float32)
// and bf16 results, as the Pallas body computes them.
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), De = 64,
// Dn = 256, I = 128, gate hidden 32, both chains:
//   FLOPs per molecule: 147,456 per pair + 163,840 per node
//     N = 32: 156.2 MFLOP      N = 40: 242.5 MFLOP
//   bytes per molecule (e, x, mask read once, t and u written once):
//     N = 32: 160 KB           N = 40: 242 KB   (+ 0.31 MB of weights per call)
//   At B = 16: 2.50 GFLOP / 2.87 MB (N = 32), 3.88 GFLOP / 4.18 MB (N = 40):
//   bound by operations, 2.5 us and 3.9 us (chip_smoke.py work()).
//
// Design (redesigned for Hopper's tensor cores, after edge_pair_bwd.cu).
// A node-level kernel computes x @ Wn and the node and time part of the
// gate's first layer once per node and side (not redesigned: a small
// share of the call). The left chain's sum runs over rows and the right
// chain's over columns, so each chain takes its pairs in its own
// output-major order: row rho = (b * N + k) * N + m is the pair (m, k) for
// the left chain and (k, m) for the right one (e's order), summed into
// output node k, with m's node features. The rows are cut into tiles of
// 64, one wgmma M, so no row idles but a CTA's last tile's (N = 32: two
// whole output nodes; N = 40: parts of two or three). A CTA is two
// warpgroups on one chain; its five weights (74 KB of bf16 at flagship
// widths) are staged once by cp.async into shared memory and stay there
// while the CTA walks its tiles (a persistent grid, two CTAs per SM, one
// half of them per chain). Each product runs as wgmma with the 64-row
// activation tile (bf16, shared memory) as A and the resident weight as
// B, the warpgroups splitting the output columns, the accumulators in
// registers; the epilogues (the bilinear bond-node product, LayerNorms
// with their statistics across the warpgroups, relu, the sigmoid gate,
// the mask) run on the registers and only the bf16 A operand of the next
// product goes to shared memory. A CTA takes an even share of whole output
// nodes, so every sum closes inside it, a node's rows added one by one in
// partner order (wgmma.cuh tile_sums): no atomics, no further launch, a
// deterministic result. With the LayerNorm statistics in
// md::warp_layernorm's order (wgmma.cuh ln_stats_seq) the outputs equal a
// warp-per-row design's bit for bit (see node_block.cu).
// Launches: prep, pair = 2.
#include "grad.cuh"
#include "wgmma.cuh"

using md::bf16;
namespace wg = md::wg;

namespace {

struct BondFfn {
  // bond_linear [De,I], node_linear [Dn,I]; inter: Linear(I,I), LN(I),
  // Linear(I,Do); gate: Linear(De+Dn+1,G), LN(G), Linear(G,Do)
  const bf16 *wb, *wn, *w1, *b1, *s1, *b1n, *w2, *b2, *wg1, *bg1, *sg1, *bg1n, *wg2, *bg2;
};

struct EdgePairArgs {
  BondFfn side[2];     // 0 = left, 1 = right
  const bf16* e;       // [B,N,N,De]
  const bf16* x;       // [B,N,Dn]
  const float* mask;   // [B,N,N]
  const float* t;      // [B]
  float* np;           // scratch [2,B,N,I]: x @ Wn
  float* gpre;         // scratch [2,B,N,G]: x @ Wg1x + t Wg1t + bg1
  bf16* out;           // [2,B,N,Do]: t (left), u (right)
  int B, N, Dn, De, I, G, Do;
  int round_msg;       // 1: msg rounded to bf16 before the sum (the whole-block kernel)
};

// One CTA per (64 nodes, side).
__global__ void __launch_bounds__(md::kThreads) edge_prep_kernel(const EdgePairArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = a.Dn + 8, ldc = a.I + 4;
  bf16* sX = reinterpret_cast<bf16*>(smem);
  float* sC = reinterpret_cast<float*>(smem + md::smem_bytes(md::kMaxRows, ldx, 2));
  const BondFfn& w = a.side[blockIdx.y];
  const int total = a.B * a.N;
  const int row0 = blockIdx.x * md::kMaxRows;
  const int rows = min(md::kMaxRows, total - row0);
  const int mt = (rows + 15) / 16;
  float* np = a.np + (size_t)blockIdx.y * total * a.I;
  float* gpre = a.gpre + (size_t)blockIdx.y * total * a.G;

  md::load_rows(sX, ldx, rows, mt * 16, a.Dn,
                [&](int r) { return a.x + (size_t)(row0 + r) * a.Dn; });
  __syncthreads();
  md::cta_gemm(sX, ldx, w.wn, a.Dn, a.I, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * a.I; idx += blockDim.x) {
    const int r = idx / a.I, c = idx % a.I;
    np[(size_t)(row0 + r) * a.I + c] = sC[r * ldc + c];
  }
  __syncthreads();
  const bf16* wg1x = w.wg1 + (size_t)a.De * a.G;
  const bf16* wg1t = w.wg1 + (size_t)(a.De + a.Dn) * a.G;
  md::cta_gemm(sX, ldx, wg1x, a.Dn, a.G, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * a.G; idx += blockDim.x) {
    const int r = idx / a.G, c = idx % a.G;
    const int b = (row0 + r) / a.N;
    gpre[(size_t)(row0 + r) * a.G + c] =
        sC[r * ldc + c] + a.t[b] * md::bf(wg1t[c]) + md::bf(w.bg1[c]);
  }
}

template <int DE, int I, int G, int DO>
constexpr size_t pair_weights() {
  return (size_t)DE * I + I * I + I * DO + DE * G + G * DO;
}

template <int DE, int I, int G, int DO>
constexpr size_t pair_smem() {
  return (pair_weights<DE, I, G, DO>() + (size_t)wg::kTileRows * (2 * DE + I + G)) * sizeof(bf16) +
         (size_t)(2 * 64 + DO) * sizeof(float);
}

// A persistent CTA (two warpgroups) per share of one chain's output nodes
// (blockIdx.y: 0 = left, 1 = right); it walks their rows in tiles of 64
// (wgmma.cuh tile_range): row rho = (b * N + k) * N + m is the pair (m, k)
// of the left chain or (k, m) of the right one, output node k, node
// features m's. The next tile's e rows load by cp.async into the second of
// two buffers while this tile runs.
template <int DE, int I, int G, int DO>
__global__ void __launch_bounds__(256, 2) edge_pair_kernel(const EdgePairArgs a) {
  constexpr int R = wg::kTileRows;
  constexpr int NI = I / 2, AI = NI / 2, NO = DO / 2, AO = NO / 2, NG = G / 2, AG = NG / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sWb = reinterpret_cast<bf16*>(smem);  // the resident weights, stage_resident's layout
  bf16* sW1 = sWb + DE * I;
  bf16* sW2 = sW1 + I * I;
  bf16* sWg1 = sW2 + I * DO;
  bf16* sWg2 = sWg1 + DE * G;
  bf16* sE = sWg2 + G * DO;  // two tiles of e
  bf16* XI = sE + 2 * R * DE;
  bf16* XG = XI + R * I;
  float* red = reinterpret_cast<float*>(XG + R * G);
  float* carry = red + 2 * 64;
  // the messages summed per output node, float32, in XI and XG (free
  // after the gate's last product)
  float* V = reinterpret_cast<float*>(XI);
  constexpr int ldv = DO + 8;
  // LayerNorm's lane sums, in XI and XG (free while a LayerNorm runs: the
  // products before it have read them, and they take its outputs after it)
  float* lnbuf = reinterpret_cast<float*>(XI);
  static_assert(64 * 33 * sizeof(float) <= R * (I + G) * sizeof(bf16),
                "the LayerNorm buffer overruns XI and XG");
  static_assert(R * ldv * sizeof(float) <= R * (I + G) * sizeof(bf16), "V overruns XI, XG");

  const int side = blockIdx.y;
  const BondFfn& W = a.side[side];
  wg::stage_resident(sWb, W.wb, DE, I);
  wg::stage_resident(sW1, W.w1, I, I);
  wg::stage_resident(sW2, W.w2, I, DO);
  wg::stage_resident(sWg1, W.wg1, DE, G);  // the edge rows of the gate's first layer
  wg::stage_resident(sWg2, W.wg2, G, DO);

  const uint32_t N = a.N, NN = N * N;
  const size_t BN = (size_t)a.B * N;
  const float* np = a.np + side * BN * I;
  const float* gpre = a.gpre + side * BN * G;
  bf16* out = a.out + side * BN * DO;
  const wg::TileRange range = wg::tile_range(a.B * N, N);
  const int g = threadIdx.x >> 7;
  auto colI = [&](int i) { return g * NI + wg::acc_col(i); };
  auto colO = [&](int i) { return g * NO + wg::acc_col(i); };
  auto colG = [&](int i) { return g * NG + wg::acc_col(i); };
  // e's row of tile row rho
  auto pair = [&](uint32_t rho) -> uint32_t {
    return side == 1 ? rho : (rho / NN * N + rho % N) * N + (rho / N) % N;
  };
  auto write = [&](uint32_t node, int c, float v) { out[(size_t)node * DO + c] = md::tobf(v); };
  const uint32_t tiles = (range.end - range.begin + R - 1) / R;
  auto load_e = [&](uint32_t t) {  // tile t's e rows, into buffer t % 2
    const uint32_t rho0 = range.begin + t * R;
    wg::tile_in_async(sE + (t & 1) * R * DE, DE, (int)min((uint32_t)R, range.end - rho0),
                      [&](int r) { return a.e + (size_t)pair(rho0 + r) * DE; });
  };
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
    int rw[2];
    uint32_t nd[2];  // the row's node features, b * N + m
    float msk[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rw[h] = wg::acc_row(2 * h);
      const bool ok = rw[h] < nv;
      const uint32_t rho = ok ? rho0 + rw[h] : 0;
      nd[h] = rho / NN * N + rho % N;
      msk[h] = ok ? a.mask[pair(rho)] : 0.0f;
    }
    float ai[AI], ot[AO], st[AO], gt[AG], inv[2];

    // inter = bf16(bond projection * node projection), both float32
    wg::res_mma<NI>(ai, sEt, DE, sWb);
#pragma unroll
    for (int i = 0; i < AI; i += 2) {
      const int c = colI(i);
      const float2 n2 = *reinterpret_cast<const float2*>(np + (size_t)nd[ROW(i)] * I + c);
      md::store2(XI + wg::kmaj(rw[ROW(i)], c, I), ai[i] * n2.x, ai[i + 1] * n2.y);
    }
    // inter MLP: Linear -> LN -> relu -> Linear (float32 out, bias later)
    wg::res_mma<NI>(ai, XI, I, sW1);
#pragma unroll
    for (int i = 0; i < AI; ++i) ai[i] += md::bf(W.b1[colI(i)]);
    wg::ln_stats_seq(ai, inv, lnbuf, red);
#pragma unroll
    for (int i = 0; i < AI; i += 2) {
      const int c = colI(i);
      const float r0 = fmaxf(ai[i] * md::bf(W.s1[c]) + md::bf(W.b1n[c]), 0.0f);
      const float r1 = fmaxf(ai[i + 1] * md::bf(W.s1[c + 1]) + md::bf(W.b1n[c + 1]), 0.0f);
      md::store2(XI + wg::kmaj(rw[ROW(i)], c, I), r0, r1);
    }
    wg::res_mma<NO>(ot, XI, I, sW2);
    // gate hidden: edge part + the node and time part, LN, relu
    wg::res_mma<NG>(gt, sEt, DE, sWg1);
#pragma unroll
    for (int i = 0; i < AG; i += 2) {
      const float2 gp = *reinterpret_cast<const float2*>(gpre + (size_t)nd[ROW(i)] * G + colG(i));
      gt[i] += gp.x;
      gt[i + 1] += gp.y;
    }
    wg::ln_stats_seq(gt, inv, lnbuf, red);
#pragma unroll
    for (int i = 0; i < AG; i += 2) {
      const int c = colG(i);
      const float g0 = fmaxf(gt[i] * md::bf(W.sg1[c]) + md::bf(W.bg1n[c]), 0.0f);
      const float g1 = fmaxf(gt[i + 1] * md::bf(W.sg1[c + 1]) + md::bf(W.bg1n[c + 1]), 0.0f);
      md::store2(XG + wg::kmaj(rw[ROW(i)], c, G), g0, g1);
    }
    wg::res_mma<NO>(st, XG, G, sWg2);
    // msg = (out + b2) * sigmoid(gate), masked, summed over the partners
#pragma unroll
    for (int i = 0; i < AO; ++i) {
      const int c = colO(i);
      const float sig = md::sigmoidf(st[i] + md::bf(W.bg2[c]));
      const float msg = (ot[i] + md::bf(W.b2[c])) * sig;
      ot[i] = (a.round_msg ? md::rbf(msg) : msg) * msk[ROW(i)];
    }
    wg::tile_values<NO>(V, ldv, [&](int i) { return ot[i]; });
    __syncthreads();
    wg::tile_sums(V, ldv, DO, rho0, nv, N, carry, write);
  }
#undef ROW
}

template <int DE, int I, int G, int DO>
cudaError_t launch_pair(const EdgePairArgs& a, cudaStream_t s) {
  constexpr size_t ps = pair_smem<DE, I, G, DO>();
  // the CTAs the card holds at once, half per chain, at most one per output node
  static int slots = 0;
  if (slots == 0) {
    cudaError_t err = cudaFuncSetAttribute(edge_pair_kernel<DE, I, G, DO>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(ps));
    if (err != cudaSuccess) return err;
    slots = wg::persistent_slots(edge_pair_kernel<DE, I, G, DO>, ps);
    if (slots < 2) return cudaErrorInvalidConfiguration;
  }
  const int ctas = min(wg::capped(slots / 2), a.B * a.N);
  edge_pair_kernel<DE, I, G, DO><<<dim3(ctas, 2), 256, ps, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

namespace md {

// The prep kernel alone (np, gpre of both sides), for the backward entry
// point; weights: the 28 BondFfn pointers, left then right.
cudaError_t edge_pair_prep(const void* const* weights, const bf16* x, const float* t, float* np,
                           float* gpre, int B, int N, int Dn, int De, int I, int G, int Do,
                           cudaStream_t s) {
  EdgePairArgs a = {};
  const bf16** w = &a.side[0].wb;
  for (int k = 0; k < 28; ++k) w[k] = static_cast<const bf16*>(weights[k]);
  a.x = x;
  a.t = t;
  a.np = np;
  a.gpre = gpre;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.I = I; a.G = G; a.Do = Do;
  const size_t smem = md::smem_bytes(md::kMaxRows, Dn + 8, 2) +
                      md::smem_bytes(md::kMaxRows, I + 4, 4);
  cudaError_t err = cudaFuncSetAttribute(edge_prep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid((B * N + md::kMaxRows - 1) / md::kMaxRows, 2);
  edge_prep_kernel<<<grid, md::kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

}  // namespace md

namespace md {

// The forward and backward pair kernels (here and in edge_pair_bwd.cu) are
// instantiated for the widths of the repo's models (edge_dim 64 and 32:
// De = Do = edge_dim, I = 2 edge_dim, G = 32); ops/kernels.py's
// EDGE_WIDTHS lists the same.
bool edge_pair_built(int De, int I, int G, int Do) {
  return (De == 64 && I == 128 && G == 32 && Do == 64) ||
         (De == 32 && I == 64 && G == 32 && Do == 32);
}

cudaError_t edge_pair_run(const void* const* weights, const bf16* e, const bf16* x,
                          const float* mask, const float* t, float* np, float* gpre, bf16* out,
                          int B, int N, int Dn, int De, int I, int G, int Do, int round_msg,
                          cudaStream_t s, int* launched) {
  if (!edge_pair_built(De, I, G, Do)) return cudaErrorInvalidValue;
  EdgePairArgs a;
  const bf16** w = &a.side[0].wb;
  for (int k = 0; k < 28; ++k) w[k] = static_cast<const bf16*>(weights[k]);
  a.e = e;
  a.x = x;
  a.mask = mask;
  a.t = t;
  a.np = np;
  a.gpre = gpre;
  a.out = out;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.I = I; a.G = G; a.Do = Do;
  a.round_msg = round_msg;

  cudaError_t err = edge_pair_prep(weights, x, t, np, gpre, B, N, Dn, De, I, G, Do, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  err = De == 64 ? launch_pair<64, 128, 32, 64>(a, s) : launch_pair<32, 64, 32, 32>(a, s);
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace md

extern "C" {

// p: 14 left weights, 14 right weights (BondFfn order), then e, x, mask, t,
// np, gpre, out.
// *launched: the kernels this call launched (the prep kernel, then the pair
// kernel). The pair kernel is built for the widths of md::edge_pair_built
// (else cudaErrorInvalidValue, before any launch).
int md_edge_pair_forward(const void* const* p, int B, int N, int Dn, int De, int I, int G,
                         int Do, void* stream, int* launched) {
  *launched = 0;
  return md::edge_pair_run(
      p, static_cast<const bf16*>(p[28]), static_cast<const bf16*>(p[29]),
      static_cast<const float*>(p[30]), static_cast<const float*>(p[31]),
      static_cast<float*>(const_cast<void*>(p[32])), static_cast<float*>(const_cast<void*>(p[33])),
      static_cast<bf16*>(const_cast<void*>(p[34])), B, N, Dn, De, I, G, Do, 0,
      static_cast<cudaStream_t>(stream), launched);
}

}  // extern "C"
