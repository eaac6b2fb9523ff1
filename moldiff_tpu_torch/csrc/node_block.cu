// NodeBlock gated message aggregate, forward, for Hopper (sm_90a).
//
// Replaces moldiff_tpu/ops/pallas_kernels.py:_node_block_kernel (launched by
// _pallas_node_block_aggregate). For every molecule b and receiver i:
//   h[i,j]  = Linear(relu(LN(e[i,j] @ We1 + be1))) (edge MLP, De -> H -> H)
//   xn[j]   = the same MLP shape on the sender's node features x[j]
//   msg     = (h[i,j] * xn[j]) @ Wm + bm
//   gate    = sigmoid(MLP(e[i,j] || x[j] || t))   (first layer split in parts)
//   out[i]  = sum_j mask[i,j] * msg * gate        (float32 sum, bf16 result)
// with the bf16 roundings of the Pallas body (activations rounded to bf16
// where it casts, every product accumulated in float32).
//
// Bound on the H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s), flagship
// widths Dn = H = 256, De = 64:
//   FLOPs per molecule: 458,752 per pair + 393,216 per node
//     N = 32: 482.3 MFLOP      N = 40: 749.7 MFLOP
//   bytes per molecule (e, x, mask read once, out written once):
//     N = 32: 168 KB           N = 40: 252 KB   (+ 0.86 MB of weights per call)
//   At B = 16: 7.72 GFLOP / 3.55 MB (N = 32), 12.00 GFLOP / 4.89 MB (N = 40):
//   bound by operations, 7.8 us and 12.1 us (chip_smoke.py work()).
//
// Design (redesigned for Hopper's tensor cores, after node_block_bwd.cu).
// A node-level kernel computes the sender MLP xn[j] and the sender part of
// the gate's first layer once per node (not redesigned: a small share of
// the call). The pair kernel takes the pairs in
// receiver-major order (row rho = (b * N + i) * N + j, e's own order) cut
// into tiles of 64 rows, one wgmma M, so no row idles but a CTA's last
// tile's: at N = 32 a tile holds two whole receivers, at N = 40 parts of
// two or three. A CTA is two warpgroups; each of the five products runs
// as wgmma with the 64-row activation tile (bf16, shared memory) as A and
// a weight as B, the warpgroups splitting the output columns; the
// weights' K-slices are staged into shared memory by cp.async,
// double-buffered and shared by both warpgroups (wgmma.cuh cta_mma), and
// the accumulators stay in registers. The epilogues (bias, LayerNorm with
// its statistics across the two warpgroups, relu, the bilinear h * xn[j],
// the message bias, the sigmoid gate and the mask) run on the registers;
// only the bf16 A operand of the next product goes to shared memory. The
// grid is persistent (one CTA per SM): a CTA takes an even share of whole
// receivers and walks their rows tile by tile, so a receiver's sum over
// senders closes inside the CTA, its rows added one by one in sender order
// (wgmma.cuh tile_sums, carried from the tile where the receiver began to
// the next), with no float atomics and no further launch. Launches: prep,
// pair = 2. The LayerNorm statistics (wgmma.cuh ln_stats_seq) and the sums
// take md::warp_layernorm's and a serial loop's order, as a warp-per-row
// design takes them, so the outputs equal that design's bit for bit: the
// tensor cores' products already do, and a bf16 training gradient can move
// a leaf by half its scale from one-ulp differences at a few outputs
// (chip_smoke.py phase 9). A deeper weight pipeline (a four-buffer ring
// streaming across products and tiles) and 128-row tiles with each
// warpgroup owning whole rows (half the weight traffic per pair) each read
// the same time at B = 128, N = 40 (PERF.md), so the simple form stays.
#include "grad.cuh"
#include "wgmma.cuh"

using md::bf16;
namespace wg = md::wg;

namespace {

struct NodeBlockArgs {
  // edge_net: Linear(De,H), LN(H), Linear(H,H)
  const bf16 *we1, *be1, *se1, *be1n, *we2, *be2;
  // node_net: Linear(Dn,H), LN(H), Linear(H,H)
  const bf16 *wn1, *bn1, *sn1, *bn1n, *wn2, *bn2;
  // msg_net: Linear(H,H)
  const bf16 *wm, *bm;
  // gate: Linear(De+Dn+1,H), LN(H), Linear(H,H)
  const bf16 *wg1, *bg1, *sg1, *bg1n, *wg2, *bg2;
  const bf16* x;       // [B,N,Dn]
  const bf16* e;       // [B,N,N,De]
  const float* mask;   // [B,N,N]
  const float* t;      // [B]
  bf16* xn;            // scratch [B,N,H]: sender MLP
  float* gpre;         // scratch [B,N,H]: x[j] @ Wg1x + t Wg1t + bg1
  bf16* out;           // [B,N,H]
  float* out32;        // [B,N,H] the float32 sum in place of out (the whole-block kernel), or null
  int B, N, Dn, De, H;
};

// One CTA per 64 nodes (flattened over molecules).
__global__ void __launch_bounds__(md::kThreads) node_prep_kernel(const NodeBlockArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ldx = a.Dn + 8, lda = a.H + 8, ldc = a.H + 4;
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sAct = reinterpret_cast<bf16*>(smem + md::smem_bytes(md::kMaxRows, ldx, 2));
  float* sC = reinterpret_cast<float*>(smem + md::smem_bytes(md::kMaxRows, ldx, 2) +
                                       md::smem_bytes(md::kMaxRows, lda, 2));
  const int total = a.B * a.N;
  const int row0 = blockIdx.x * md::kMaxRows;
  const int rows = min(md::kMaxRows, total - row0);
  const int mt = (rows + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = a.H / 32;

  md::load_rows(sX, ldx, rows, mt * 16, a.Dn,
                [&](int r) { return a.x + (size_t)(row0 + r) * a.Dn; });
  __syncthreads();

  // node MLP, first layer + LN + relu
  md::cta_gemm(sX, ldx, a.wn1, a.Dn, a.H, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int r = warp; r < mt * 16; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) v[q] = sC[r * ldc + lane + 32 * q] + md::bf(a.bn1[lane + 32 * q]);
    md::warp_layernorm(v, nq, a.sn1, a.bn1n, lane);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) sAct[r * lda + lane + 32 * q] = md::tobf(fmaxf(v[q], 0.0f));
  }
  __syncthreads();
  md::cta_gemm(sAct, lda, a.wn2, a.H, a.H, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * a.H; idx += blockDim.x) {
    const int r = idx / a.H, c = idx % a.H;
    a.xn[(size_t)(row0 + r) * a.H + c] = md::tobf(sC[r * ldc + c] + md::bf(a.bn2[c]));
  }
  __syncthreads();

  // sender part of the gate's first layer, plus the time row and the bias
  const bf16* wg1x = a.wg1 + (size_t)a.De * a.H;
  const bf16* wg1t = a.wg1 + (size_t)(a.De + a.Dn) * a.H;
  md::cta_gemm(sX, ldx, wg1x, a.Dn, a.H, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * a.H; idx += blockDim.x) {
    const int r = idx / a.H, c = idx % a.H;
    const int b = (row0 + r) / a.N;
    a.gpre[(size_t)(row0 + r) * a.H + c] =
        sC[r * ldc + c] + a.t[b] * md::bf(wg1t[c]) + md::bf(a.bg1[c]);
  }
}

template <int H, int DE>
constexpr size_t pair_smem() {
  return (size_t)wg::kTileRows * (DE + H) * sizeof(bf16) +
         (size_t)2 * wg::kSlice * wg::kRingCols * sizeof(bf16) +
         (size_t)(2 * 64 + H) * sizeof(float);
}

// A persistent CTA (two warpgroups) per share of the receivers; it walks
// their rows in tiles of 64 (wgmma.cuh tile_range): row rho = (b * N + i)
// * N + j is the pair (receiver i, sender j) of molecule b.
template <int H, int DE>
__global__ void __launch_bounds__(256, 1) node_pair_kernel(const NodeBlockArgs a) {
  constexpr int R = wg::kTileRows;
  constexpr int NW = H / 2, NA = NW / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sE = reinterpret_cast<bf16*>(smem);
  bf16* XA = sE + R * DE;
  bf16* ring = XA + R * H;
  float* red = reinterpret_cast<float*>(ring + 2 * wg::kSlice * wg::kRingCols);
  float* carry = red + 2 * 64;
  // the values summed over senders, float32, in XA and the ring (free
  // between the message product and the next tile's first product)
  float* V = reinterpret_cast<float*>(XA);
  constexpr int ldv = H + 8;
  // LayerNorm's lane sums, in the ring (free between products)
  float* lnbuf = reinterpret_cast<float*>(ring);
  static_assert(R * ldv * sizeof(float) <= (R * H + 2 * wg::kSlice * wg::kRingCols) * sizeof(bf16),
                "V overruns XA and the ring");

  const uint32_t N = a.N, NN = N * N;
  const wg::TileRange range = wg::tile_range(a.B * N, N);
  const int g = threadIdx.x >> 7;
  auto col = [&](int i) { return g * NW + wg::acc_col(i); };
  auto write = [&](uint32_t node, int c, float v) {
    const size_t o = (size_t)node * H + c;
    if (a.out32 != nullptr)
      a.out32[o] = v;
    else
      a.out[o] = md::tobf(v);
  };
#define ROW(i) (((i) >> 1) & 1)
  for (uint32_t rho0 = range.begin; rho0 < range.end; rho0 += R) {
    const int nv = min((uint32_t)R, range.end - rho0);
    for (int idx = threadIdx.x; idx < R * (DE / 8); idx += blockDim.x) {
      const int r = idx / (DE / 8), c = (idx % (DE / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < nv) v = *reinterpret_cast<const uint4*>(a.e + (size_t)(rho0 + r) * DE + c);
      *reinterpret_cast<uint4*>(sE + wg::kmaj(r, c, DE)) = v;
    }
    int rw[2];
    uint32_t snd[2];  // the row's sender, b * N + j (B * N * N < 2^32)
    float msk[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      rw[h] = wg::acc_row(2 * h);
      const bool ok = rw[h] < nv;
      const uint32_t rho = ok ? rho0 + rw[h] : 0;
      snd[h] = rho / NN * N + rho % N;
      msk[h] = ok ? a.mask[rho] : 0.0f;
    }
    float acc[NA], sig[NA], inv[2];

    // gate: edge part of the first layer + the sender and time part, LN,
    // relu, second layer; its sigmoid (rounded to bf16) kept in sig
    wg::cta_mma<NW, 0>(acc, sE, DE, a.wg1, ring, false);
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const float2 gp = *reinterpret_cast<const float2*>(a.gpre + snd[ROW(i)] * H + col(i));
      acc[i] += gp.x;
      acc[i + 1] += gp.y;
    }
    wg::ln_stats_seq(acc, inv, lnbuf, red);
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int c = col(i);
      const float g0 = fmaxf(acc[i] * md::bf(a.sg1[c]) + md::bf(a.bg1n[c]), 0.0f);
      const float g1 = fmaxf(acc[i + 1] * md::bf(a.sg1[c + 1]) + md::bf(a.bg1n[c + 1]), 0.0f);
      md::store2(XA + wg::kmaj(rw[ROW(i)], c, H), g0, g1);
    }
    wg::cta_mma<NW, 0>(acc, XA, H, a.wg2, ring, false);
#pragma unroll
    for (int i = 0; i < NA; ++i) sig[i] = md::rbf(md::sigmoidf(acc[i] + md::bf(a.bg2[col(i)])));

    // edge MLP: Linear -> LN -> relu -> Linear, then h * xn[j]
    wg::cta_mma<NW, 0>(acc, sE, DE, a.we1, ring, false);
#pragma unroll
    for (int i = 0; i < NA; ++i) acc[i] += md::bf(a.be1[col(i)]);
    wg::ln_stats_seq(acc, inv, lnbuf, red);
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int c = col(i);
      const float r0 = fmaxf(acc[i] * md::bf(a.se1[c]) + md::bf(a.be1n[c]), 0.0f);
      const float r1 = fmaxf(acc[i + 1] * md::bf(a.se1[c + 1]) + md::bf(a.be1n[c + 1]), 0.0f);
      md::store2(XA + wg::kmaj(rw[ROW(i)], c, H), r0, r1);
    }
    wg::cta_mma<NW, 0>(acc, XA, H, a.we2, ring, false);
#pragma unroll
    for (int i = 0; i < NA; i += 2) {
      const int c = col(i), h = ROW(i);
      const __nv_bfloat162 xn = *reinterpret_cast<const __nv_bfloat162*>(a.xn + snd[h] * H + c);
      const float h0 = md::rbf(acc[i] + md::bf(a.be2[c]));
      const float h1 = md::rbf(acc[i + 1] + md::bf(a.be2[c + 1]));
      md::store2(XA + wg::kmaj(rw[h], c, H), h0 * md::bf(xn.x), h1 * md::bf(xn.y));
    }

    // message, gated and masked (float32), summed over the senders
    wg::cta_mma<NW, 0>(acc, XA, H, a.wm, ring, false);
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const float msg = md::rbf(acc[i] + md::bf(a.bm[col(i)]));
      acc[i] = md::rbf(msg * sig[i]) * msk[ROW(i)];
    }
    wg::tile_values<NW>(V, ldv, [&](int i) { return acc[i]; });
    __syncthreads();
    wg::tile_sums(V, ldv, H, rho0, nv, N, carry, write);
  }
#undef ROW
}

template <int H, int DE>
cudaError_t launch_pair(const NodeBlockArgs& a, cudaStream_t s) {
  constexpr size_t ps = pair_smem<H, DE>();
  // one CTA per SM (the occupancy its registers allow), at most one per receiver
  static int slots = 0;
  if (slots == 0) {
    cudaError_t err = cudaFuncSetAttribute(node_pair_kernel<H, DE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(ps));
    if (err != cudaSuccess) return err;
    slots = wg::persistent_slots(node_pair_kernel<H, DE>, ps);
    if (slots == 0) return cudaErrorInvalidConfiguration;
  }
  node_pair_kernel<H, DE><<<min(wg::capped(slots), a.B * a.N), 256, ps, s>>>(a);
  return cudaGetLastError();
}

}  // namespace

namespace md {

int& wg::persistent_cap() {
  static int cap = 0;
  return cap;
}

// The prep kernel alone (xn, gpre), for the backward entry point.
cudaError_t node_block_prep(const void* const* weights, const bf16* x, const float* t,
                            bf16* xn, float* gpre, int B, int N, int Dn, int De, int H,
                            cudaStream_t s) {
  NodeBlockArgs a = {};
  const bf16** w = &a.we1;
  for (int k = 0; k < 20; ++k) w[k] = static_cast<const bf16*>(weights[k]);
  a.x = x;
  a.t = t;
  a.xn = xn;
  a.gpre = gpre;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.H = H;
  const size_t smem = md::smem_bytes(md::kMaxRows, Dn + 8, 2) +
                      md::smem_bytes(md::kMaxRows, H + 8, 2) +
                      md::smem_bytes(md::kMaxRows, H + 4, 4);
  cudaError_t err = cudaFuncSetAttribute(node_prep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  node_prep_kernel<<<(B * N + md::kMaxRows - 1) / md::kMaxRows, md::kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

// The forward and backward pair kernels (here and in node_block_bwd.cu) are
// instantiated for the widths of the repo's models (node_dim / edge_dim
// 256 / 64 and 128 / 32: H = node_dim, De = edge_dim); ops/kernels.py's
// NODE_WIDTHS lists the same.
bool node_block_built(int H, int De) { return (H == 256 && De == 64) || (H == 128 && De == 32); }

cudaError_t node_block_run(const void* const* weights, const bf16* x, const bf16* e,
                           const float* mask, const float* t, bf16* xn, float* gpre, bf16* out,
                           float* out32, int B, int N, int Dn, int De, int H, cudaStream_t s,
                           int* launched) {
  if (!node_block_built(H, De)) return cudaErrorInvalidValue;
  NodeBlockArgs a;
  const bf16** w = &a.we1;
  for (int k = 0; k < 20; ++k) w[k] = static_cast<const bf16*>(weights[k]);
  a.x = x;
  a.e = e;
  a.mask = mask;
  a.t = t;
  a.xn = xn;
  a.gpre = gpre;
  a.out = out;
  a.out32 = out32;
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.H = H;

  cudaError_t err = node_block_prep(weights, x, t, xn, gpre, B, N, Dn, De, H, s);
  if (err != cudaSuccess) return err;
  ++*launched;

  err = H == 256 ? launch_pair<256, 64>(a, s) : launch_pair<128, 32>(a, s);
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace md

extern "C" {

const char* md_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Caps the grid of every persistent pair kernel (rows 1, 4 and 8, and the
// whole-block and full-EdgeBlock kernels that run them) at slots CTAs; 0:
// the card's own (wgmma.cuh persistent_cap). For checks only: the outputs
// do not depend on it.
int md_set_persistent_slots(int slots) {
  md::wg::persistent_cap() = slots > 0 ? slots : 0;
  return 0;
}

// p: 20 weight pointers in NodeBlockArgs order, then x, e, mask, t, xn, gpre, out.
// *launched: the kernels this call launched (the prep kernel, then the pair
// kernel). The pair kernel is built for the widths of md::node_block_built
// (else cudaErrorInvalidValue, before any launch).
int md_node_block_forward(const void* const* p, int B, int N, int Dn, int De, int H,
                          void* stream, int* launched) {
  *launched = 0;
  return md::node_block_run(
      p, static_cast<const bf16*>(p[20]), static_cast<const bf16*>(p[21]),
      static_cast<const float*>(p[22]), static_cast<const float*>(p[23]),
      static_cast<bf16*>(const_cast<void*>(p[24])), static_cast<float*>(const_cast<void*>(p[25])),
      static_cast<bf16*>(const_cast<void*>(p[26])), nullptr, B, N, Dn, De, H,
      static_cast<cudaStream_t>(stream), launched);
}

}  // extern "C"
