// One whole denoiser block, forward, for Hopper (sm_90a).
//
// Replaces moldiff_tpu/ops/pallas_kernels.py:_fused_block_kernel (launched
// by _pallas_fused_block, fused_block_tpu): for every molecule,
//   he     = bf16([h_edge || h_dist] @ Wee + bee)                 edge_emb
//   aggr   = NodeBlock's gated message sum over senders (float32)
//   h_node_new = x + bf16(relu(LN(x @ Wc + bc + aggr)) @ Wo + bo)   (bf16 add)
//   t, u   = the EdgeBlock's two chains on he and x, messages rounded to bf16
//   h_edge_new = he + the EdgeBlock tail (broadcast terms added in bf16)
//   pos_delta  = PosUpdate on h_node_new and h_edge_new, its pair weight
//                rounded to bf16, force w * rel / d / (d + 1), summed over j
// with the node time as the one time input and the Pallas body's roundings
// (fused_block_plain in ops/kernels.py follows it line by line).
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), flagship_v2's
// widths (Dn = H = 256, De = 64, 16 Gaussians, I = 128, G = 32, PosUpdate
// Dl = 64, interior 256, gate 32): about 0.84 MFLOP per pair and 0.97 MFLOP
// per node (edge_emb 10,240 per pair; the NodeBlock, EdgeBlock and PosUpdate
// products of node_block.cu, edge_pair.cu, edge_block_full.cu and
// pos_update.cu; the NodeBlock tail 262,144 per node): at B = 16, N = 32
// about 14 GFLOP, 14 us, a little above the sum of rows 1, 4 and 8's bounds.
// Bound by operations; chip_smoke.py work() counts it for a call.
//
// Design. Each stage of the block needs a reduction that crosses pair tiles
// before the next can run: the NodeBlock's sum over senders, the two
// chains' sums over rows and columns, the EdgeBlock tail (which needs t[i]
// and u[j] of every pair) and PosUpdate (which needs h_node_new of both
// endpoints and h_edge_new). One molecule's he alone is 200 KB at N = 40,
// more than an SM's shared memory holds with any intermediate. So the
// stages run as a fixed sequence of hand-written kernels over global
// memory, the intermediates (he, the node MLP, the sums, the node FFNs, L
// and R) staying in L2 at these sizes: edge_emb (here), the NodeBlock's
// prep and pair kernels (node_block.cu, its sum kept in float32), the
// NodeBlock tail with the node residual (here), the chains' prep and pair
// kernels (edge_pair.cu, messages rounded), the tail's proj and pair
// kernels with the edge residual (edge_block_full.cu) and PosUpdate's prep
// and pair kernels (pos_update.cu, its weight rounded): 10 launches, no
// PyTorch op between them. Outputs go to fresh buffers (the Pallas
// kernel's aliasing of h_node and h_edge is not ported: under row tiles an
// in-place write would race with readers of other tiles).
// This file's own two kernels (redesigned for Hopper, after edge_pair.cu):
// - edge_emb_kernel streams e and hd (bound by bytes: 59 MB at B = 128,
//   N = 40, 18 us at 3.35 TB/s): a persistent grid, each CTA an even share
//   of the tiles of 64 pairs, in order, Wee resident in shared memory, the
//   next tile loading by cp.async while this one runs its two wgmma
//   products.
// - node_tail_kernel has only BN / 64 node tiles (80 at B = 128, N = 40)
//   for 132 SMs, so each tile's second product is split over two CTAs by
//   output columns (both run the first product and the LayerNorm); Wc and
//   Wo (128 KB each) stream through wgmma.cuh's cp.async ring.
// Their outputs equal those of the first design (a warp per row, WMMA
// products) bit for bit: the tensor cores' products equal WMMA's, edge_emb
// keeps its two products apart and adds them in the first design's order,
// the LayerNorm takes md::warp_layernorm's order (wgmma.cuh ln_stats_seq).
#include "grad.cuh"
#include "wgmma.cuh"

using md::bf16;
namespace wg = md::wg;

namespace {

enum { kB, kN, kDn, kDe, kDh, kH, kI, kG, kDl, kIp, kGp };

struct EmbArgs {
  const bf16 *w, *b;   // edge_emb: Linear(De + Dh, De)
  const bf16* e;       // [P, De]
  const bf16* hd;      // [P, Dh]
  bf16* he;            // [P, De]
  long long P;
  int Dh;
};

struct NodeTailArgs {
  // centroid_lin: Linear(Dn,H); ln: LN(H); out: Linear(H,Dn)
  const bf16 *wc, *bc, *sl, *cl, *wo, *bo;
  const bf16* x;       // [BN, Dn]
  const float* aggr;   // [BN, H]
  bf16* out;           // [BN, Dn]: x + delta
  int BN;
};

constexpr int kRows = wg::kTileRows;

template <int DE>
size_t emb_smem(int Dh) {
  return ((size_t)DE * DE + (size_t)Dh * DE + 3 * kRows * DE + 2 * kRows * Dh) * sizeof(bf16) +
         DE * sizeof(float);
}

// A persistent CTA walks an even share of the tiles of 64 flat pairs, in
// order: he = bf16((e @ Wee[:De] + hd @ Wee[De:]) + bee), the two products
// kept apart and added as the first design's two WMMA passes add them.
template <int DE>
__global__ void __launch_bounds__(256) edge_emb_kernel(const EmbArgs a) {
  constexpr int NW = DE / 2, NA = NW / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dh = a.Dh;
  bf16* sWe = reinterpret_cast<bf16*>(smem);  // stage_resident's layout
  bf16* sWh = sWe + DE * DE;
  bf16* sE = sWh + Dh * DE;                   // two tiles of e
  bf16* sH = sE + 2 * kRows * DE;             // two tiles of hd
  bf16* sO = sH + 2 * kRows * Dh;             // the output tile
  float* pb = reinterpret_cast<float*>(sO + kRows * DE);
  wg::stage_resident(sWe, a.w, DE, DE);
  wg::stage_resident(sWh, a.w + DE * DE, Dh, DE);
  for (int c = threadIdx.x; c < DE; c += blockDim.x) pb[c] = md::bf(a.b[c]);
  const size_t P = a.P, tiles = (P + kRows - 1) / kRows;
  const int g = threadIdx.x >> 7;
  auto load = [&](size_t tile, int buf) {
    const size_t p0 = tile * kRows;
    const int nv = (int)min((size_t)kRows, P - p0);
    wg::tile_in_async(sE + buf * kRows * DE, DE, nv, [&](int r) { return a.e + (p0 + r) * DE; });
    wg::tile_in_async(sH + buf * kRows * Dh, Dh, nv, [&](int r) { return a.hd + (p0 + r) * Dh; });
  };
  // this CTA's tiles: an even share of them, in order
  const size_t t0 = tiles * blockIdx.x / gridDim.x, t1 = tiles * (blockIdx.x + 1) / gridDim.x;
  if (t0 < t1) load(t0, 0);
  wg::cp_commit();  // the resident weights and the first tile
  int k = 0;
  for (size_t tile = t0; tile < t1; ++tile, ++k) {
    const size_t p0 = tile * kRows;
    const int nv = (int)min((size_t)kRows, P - p0);
    if (tile + 1 < t1) load(tile + 1, (k + 1) & 1);
    wg::cp_commit();
    wg::cp_wait<1>();  // all but the newest group: this tile (and the weights) landed
    float ae[NA], ah[NA];
    wg::res_mma<NW>(ae, sE + (k & 1) * kRows * DE, DE, sWe);
    wg::res_mma<NW>(ah, sH + (k & 1) * kRows * Dh, Dh, sWh);
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int c = g * NW + wg::acc_col(i);
      md::store2(sO + wg::kmaj(wg::acc_row(i), c, DE), (ae[i] + ah[i]) + pb[c],
                 (ae[i + 1] + ah[i + 1]) + pb[c + 1]);
    }
    __syncthreads();
    wg::tile_out(sO, DE, a.he, [&](int r) { return r < nv; }, [&](size_t r) { return p0 + r; });
    __syncthreads();  // sO and this tile's buffers are free
  }
}

template <int DN, int H>
constexpr size_t node_tail_smem() {
  return ((size_t)2 * wg::kSlice * wg::kRingCols + (size_t)kRows * (DN > H ? DN : H)) *
             sizeof(bf16) +
         ((size_t)64 + 3 * H + DN) * sizeof(float);
}

// One CTA per (64 nodes, half of Dn): the NodeBlock after its message sum
// and the node residual, for the output columns [half * Dn / 2, (half + 1)
// * Dn / 2). Both halves run the first product and the LayerNorm, so that
// 2 * BN / 64 CTAs (160 at B = 128, N = 40) share the card's 132 SMs.
template <int DN, int H>
__global__ void __launch_bounds__(256) node_tail_kernel(const NodeTailArgs a) {
  constexpr int NW = H / 2, NA = NW / 2;   // the first product: H columns
  constexpr int NO = DN / 4, NB = NO / 2;  // the second: this CTA's Dn / 2 columns
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);          // Wc, then Wo, streamed
  bf16* sX = ring + 2 * wg::kSlice * wg::kRingCols;   // x, the relu output, the output tile
  float* S = reinterpret_cast<float*>(sX + kRows * (DN > H ? DN : H));
  float* pbc = S + 64;  // the per-column parameters as float32
  float* psl = pbc + H;
  float* pcl = psl + H;
  float* pbo = pcl + H;
  float* lnbuf = reinterpret_cast<float*>(ring);  // free between the two products
  const int half = blockIdx.y, row0 = blockIdx.x * kRows, nv = min(kRows, a.BN - row0);
  for (int c = threadIdx.x; c < H; c += blockDim.x) {
    pbc[c] = md::bf(a.bc[c]);
    psl[c] = md::bf(a.sl[c]);
    pcl[c] = md::bf(a.cl[c]);
  }
  for (int c = threadIdx.x; c < DN; c += blockDim.x) pbo[c] = md::bf(a.bo[c]);
  wg::tile_in_async(sX, DN, nv, [&](int r) { return a.x + (size_t)(row0 + r) * DN; });
  wg::cp_commit();  // cta_mma waits for it with its first weight slice
  const int g = threadIdx.x >> 7;
  const int rw[2] = {wg::acc_row(0), wg::acc_row(2)};

  // x @ Wc + bc + aggr, LayerNorm, relu
  float acc[NA], inv[2];
  wg::cta_mma<NW, 0>(acc, sX, DN, a.wc, ring, false);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int r = rw[(i >> 1) & 1], c = g * NW + wg::acc_col(i);
    if (r < nv) {
      const float2 ag = *reinterpret_cast<const float2*>(a.aggr + (size_t)(row0 + r) * H + c);
      acc[i] = (acc[i] + pbc[c]) + ag.x;
      acc[i + 1] = (acc[i + 1] + pbc[c + 1]) + ag.y;
    } else {
      acc[i] = acc[i + 1] = 0.0f;
    }
  }
  wg::ln_stats_seq(acc, inv, lnbuf, S);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int c = g * NW + wg::acc_col(i);
    md::store2(sX + wg::kmaj(rw[(i >> 1) & 1], c, H), fmaxf(acc[i] * psl[c] + pcl[c], 0.0f),
               fmaxf(acc[i + 1] * psl[c + 1] + pcl[c + 1], 0.0f));
  }

  // @ Wo + bo for this CTA's columns, then x + delta
  float o[NB];
  wg::cta_mma<NO, 0>(o, sX, H, a.wo + half * (DN / 2), ring, false, nullptr, DN);
#pragma unroll
  for (int i = 0; i < NB; i += 2) {
    const int r = rw[(i >> 1) & 1], cl = g * NO + wg::acc_col(i), c = half * (DN / 2) + cl;
    float x0 = 0.0f, x1 = 0.0f;
    if (r < nv) {
      const __nv_bfloat162 xv =
          *reinterpret_cast<const __nv_bfloat162*>(a.x + (size_t)(row0 + r) * DN + c);
      x0 = md::bf(xv.x);
      x1 = md::bf(xv.y);
    }
    md::store2(sX + wg::kmaj(r, cl, DN / 2), x0 + md::rbf(o[i] + pbo[c]),
               x1 + md::rbf(o[i + 1] + pbo[c + 1]));
  }
  __syncthreads();
  wg::tile_out(sX, DN / 2, a.out + half * (DN / 2), [&](int r) { return r < nv; },
               [&](int r) { return row0 + r; }, DN);
}

template <int DE>
cudaError_t launch_edge_emb(const EmbArgs& a, cudaStream_t s) {
  const size_t smem = emb_smem<DE>(a.Dh);
  // a persistent grid: as many CTAs as the SMs hold, at most one per tile
  // (the shared memory grows with Dh: the slots are counted again when Dh
  // changes)
  static size_t counted = 0;
  static int slots = 0;
  if (counted != smem) {
    cudaError_t err = cudaFuncSetAttribute(edge_emb_kernel<DE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    slots = wg::persistent_slots(edge_emb_kernel<DE>, smem);
    if (slots == 0) return cudaErrorInvalidConfiguration;
    counted = smem;
  }
  const size_t tiles = ((size_t)a.P + kRows - 1) / kRows;
  edge_emb_kernel<DE><<<(unsigned)min((size_t)wg::capped(slots), tiles), 256, smem, s>>>(a);
  return cudaGetLastError();
}

template <int DN, int H>
cudaError_t launch_node_tail(const NodeTailArgs& a, cudaStream_t s) {
  constexpr size_t smem = node_tail_smem<DN, H>();
  static bool set = false;
  if (!set) {
    cudaError_t err = cudaFuncSetAttribute(node_tail_kernel<DN, H>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    set = true;
  }
  node_tail_kernel<DN, H><<<dim3((a.BN + kRows - 1) / kRows, 2), 256, smem, s>>>(a);
  return cudaGetLastError();
}

struct BlockWork {
  bf16* he;
  bf16* xn;
  float* gpre_n;
  float* aggr;
  float* np;
  float* gpre_e;
  bf16* tu;
  bf16* proj;
  bf16* lr;
  size_t bytes;
};

BlockWork carve_block(unsigned char* base, const int* d) {
  md::Carve cv{base};
  const size_t BN = (size_t)d[kB] * d[kN], P = BN * d[kN];
  BlockWork w;
  w.he = cv.take<bf16>(P * d[kDe]);
  w.xn = cv.take<bf16>(BN * d[kH]);
  w.gpre_n = cv.take<float>(BN * d[kH]);
  w.aggr = cv.take<float>(BN * d[kH]);
  w.np = cv.take<float>(2 * BN * d[kI]);
  w.gpre_e = cv.take<float>(2 * BN * d[kG]);
  w.tu = cv.take<bf16>(2 * BN * d[kDe]);
  w.proj = cv.take<bf16>(2 * BN * d[kDe]);
  w.lr = cv.take<bf16>(2 * BN * d[kDl]);
  w.bytes = cv.off;
  return w;
}

}  // namespace

extern "C" {

long long md_fused_block_forward_workspace(const int* dims) {
  return (long long)carve_block(nullptr, dims).bytes;
}

// p: the 92 weights in pallas_kernels.py:flatten_block_weights order
// (edge_emb 2; NodeBlock 26: edge_net, node_net, msg_net, gate, centroid_lin,
// ln, out; EdgeBlock 38: both chains, node_ffn_left, node_ffn_right,
// self_ffn, ln, out; PosUpdate 26), then x, e, hd, rel, dist, mask, t, the
// outputs h_node_new, h_edge_new, pos_delta, then the workspace
// (md_fused_block_forward_workspace bytes).
// dims: B, N, Dn, De, Dh, H, I, G, Dl, Ip, Gp (_fused_block_dims in ops/kernels.py).
// *launched: the 10 kernels this call launched.
int md_fused_block_forward(const void* const* p, const int* dims, void* stream, int* launched) {
  const int B = dims[kB], N = dims[kN], Dn = dims[kDn], De = dims[kDe], Dh = dims[kDh];
  const int H = dims[kH], I = dims[kI], G = dims[kG], Dl = dims[kDl], Ip = dims[kIp];
  const int Gp = dims[kGp];
  // the NodeBlock, EdgeBlock and PosUpdate pair kernels' widths, before any launch
  if (!md::node_block_built(H, De) || !md::edge_pair_built(De, I, G, De) ||
      !md::pos_update_built(Dn, De, Dl, Ip, Gp))
    return cudaErrorInvalidValue;
  const bf16* x = static_cast<const bf16*>(p[92]);
  const bf16* e = static_cast<const bf16*>(p[93]);
  const bf16* hd = static_cast<const bf16*>(p[94]);
  const float* rel = static_cast<const float*>(p[95]);
  const float* dist = static_cast<const float*>(p[96]);
  const float* mask = static_cast<const float*>(p[97]);
  const float* t = static_cast<const float*>(p[98]);
  bf16* node_out = static_cast<bf16*>(const_cast<void*>(p[99]));
  bf16* edge_out = static_cast<bf16*>(const_cast<void*>(p[100]));
  float* pos_out = static_cast<float*>(const_cast<void*>(p[101]));
  BlockWork w = carve_block(static_cast<unsigned char*>(const_cast<void*>(p[102])), dims);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t BN = (size_t)B * N, P = BN * N;
  *launched = 0;

  // edge_emb
  EmbArgs ea = {static_cast<const bf16*>(p[0]), static_cast<const bf16*>(p[1]), e, hd, w.he,
                (long long)P, Dh};
  cudaError_t err = De == 64 ? launch_edge_emb<64>(ea, s) : launch_edge_emb<32>(ea, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  // NodeBlock: the float32 message sum, then its tail and the node residual
  err = md::node_block_run(p + 2, x, w.he, mask, t, w.xn, w.gpre_n, nullptr, w.aggr, B, N, Dn,
                           De, H, s, launched);
  if (err != cudaSuccess) return err;
  NodeTailArgs na = {static_cast<const bf16*>(p[22]), static_cast<const bf16*>(p[23]),
                     static_cast<const bf16*>(p[24]), static_cast<const bf16*>(p[25]),
                     static_cast<const bf16*>(p[26]), static_cast<const bf16*>(p[27]),
                     x, w.aggr, node_out, (int)BN};
  err = De == 64 ? launch_node_tail<256, 256>(na, s) : launch_node_tail<128, 128>(na, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  // EdgeBlock on the old node features, then the edge residual
  err = md::edge_pair_run(p + 28, w.he, x, mask, t, w.np, w.gpre_e, w.tu, B, N, Dn, De, I, G, De,
                          1, s, launched);
  if (err != cudaSuccess) return err;
  err = md::edge_tail_forward(p + 56, w.he, x, w.tu, w.proj, edge_out, 1, B, N, Dn, De, s,
                              launched);
  if (err != cudaSuccess) return err;

  // PosUpdate on the new node and edge features
  return md::pos_update_run(p + 66, node_out, edge_out, rel, dist, mask, t, w.lr, pos_out, B, N,
                            Dn, De, Dl, Ip, Gp, 1, s, launched);
}

}  // extern "C"
