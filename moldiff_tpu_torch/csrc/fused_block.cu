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
// simple design runs the stages as a fixed sequence of hand-written
// kernels over global memory, the intermediates (he, the node MLP, the
// sums, the node FFNs, L and R) staying in L2 at these sizes: edge_emb (a
// pair kernel here), the NodeBlock's prep and pair kernels (node_block.cu,
// its sum kept in float32), the NodeBlock tail with the node residual (a
// node kernel here), the chains' prep and pair kernels (edge_pair.cu,
// messages rounded), the tail's proj and pair kernels with the edge
// residual (edge_block_full.cu) and PosUpdate's prep and pair kernels
// (pos_update.cu, its weight rounded): 10 launches, no PyTorch op between
// them. Outputs go to fresh buffers (the Pallas kernel's aliasing of
// h_node and h_edge is not ported: under row tiles an in-place write would
// race with readers of other tiles). A thread-block cluster holding a
// molecule in distributed shared memory is the fast design, for later.
#include "grad.cuh"

using md::bf16;

namespace {

enum { kB, kN, kDn, kDe, kDh, kH, kI, kG, kDl, kIp, kGp };

struct EmbArgs {
  const bf16 *w, *b;   // edge_emb: Linear(De + Dh, De)
  const bf16* e;       // [P, De]
  const bf16* hd;      // [P, Dh]
  bf16* he;            // [P, De]
  long long P;
  int De, Dh;
};

struct NodeTailArgs {
  // centroid_lin: Linear(Dn,H); ln: LN(H); out: Linear(H,Dn)
  const bf16 *wc, *bc, *sl, *cl, *wo, *bo;
  const bf16* x;       // [BN, Dn]
  const float* aggr;   // [BN, H]
  bf16* out;           // [BN, Dn]: x + delta
  int BN, Dn, H;
};

// One CTA per 64 flat pairs: he = bf16(e @ Wee[:De] + hd @ Wee[De:] + bee).
__global__ void __launch_bounds__(md::kThreads) edge_emb_kernel(const EmbArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int De = a.De, lde = De + 8, ldh = a.Dh + 8, ldc = De + 4;
  bf16* sE = reinterpret_cast<bf16*>(smem);
  bf16* sH = reinterpret_cast<bf16*>(smem + md::smem_bytes(md::kMaxRows, lde, 2));
  float* sC = reinterpret_cast<float*>(smem + md::smem_bytes(md::kMaxRows, lde, 2) +
                                       md::smem_bytes(md::kMaxRows, ldh, 2));
  const long long p0 = (long long)blockIdx.x * md::kMaxRows;
  const int rows = (int)min((long long)md::kMaxRows, a.P - p0);
  const int mt = (rows + 15) / 16;
  md::load_rows(sE, lde, rows, mt * 16, De, [&](int r) { return a.e + (p0 + r) * De; });
  md::load_rows(sH, ldh, rows, mt * 16, a.Dh, [&](int r) { return a.hd + (p0 + r) * a.Dh; });
  __syncthreads();
  md::cta_gemm(sE, lde, a.w, De, De, sC, ldc, mt, md::kStore);
  __syncthreads();
  md::cta_gemm(sH, ldh, a.w + (size_t)De * De, a.Dh, De, sC, ldc, mt, md::kAdd);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * De; idx += blockDim.x) {
    const int r = idx / De, c = idx % De;
    a.he[(p0 + r) * De + c] = md::tobf(sC[r * ldc + c] + md::bf(a.b[c]));
  }
}

// One CTA per 64 nodes: the NodeBlock after its message sum, and the node
// residual.
__global__ void __launch_bounds__(md::kThreads) node_tail_kernel(const NodeTailArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Dn = a.Dn, H = a.H, ldx = Dn + 8, lda = H + 8, ldc = (Dn > H ? Dn : H) + 4;
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sAct = reinterpret_cast<bf16*>(smem + md::smem_bytes(md::kMaxRows, ldx, 2));
  float* sC = reinterpret_cast<float*>(smem + md::smem_bytes(md::kMaxRows, ldx, 2) +
                                       md::smem_bytes(md::kMaxRows, lda, 2));
  const int row0 = blockIdx.x * md::kMaxRows;
  const int rows = min(md::kMaxRows, a.BN - row0);
  const int mt = (rows + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = H / 32;
  md::load_rows(sX, ldx, rows, mt * 16, Dn,
                [&](int r) { return a.x + (size_t)(row0 + r) * Dn; });
  __syncthreads();
  md::cta_gemm(sX, ldx, a.wc, Dn, H, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int r = warp; r < mt * 16; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) {
        const int c = lane + 32 * q;
        const float aggr = r < rows ? a.aggr[(size_t)(row0 + r) * H + c] : 0.0f;
        v[q] = r < rows ? sC[r * ldc + c] + md::bf(a.bc[c]) + aggr : 0.0f;
      }
    md::warp_layernorm(v, nq, a.sl, a.cl, lane);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) sAct[r * lda + lane + 32 * q] = md::tobf(r < rows ? fmaxf(v[q], 0.0f) : 0.0f);
  }
  __syncthreads();
  md::cta_gemm(sAct, lda, a.wo, H, Dn, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < rows * Dn; idx += blockDim.x) {
    const int r = idx / Dn, c = idx % Dn;
    const float delta = md::rbf(sC[r * ldc + c] + md::bf(a.bo[c]));
    a.out[(size_t)(row0 + r) * Dn + c] = md::tobf(md::bf(sX[r * ldx + c]) + delta);
  }
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
                (long long)P, De, Dh};
  const size_t emb_smem = md::smem_bytes(md::kMaxRows, De + 8, 2) +
                          md::smem_bytes(md::kMaxRows, Dh + 8, 2) +
                          md::smem_bytes(md::kMaxRows, De + 4, 4);
  cudaError_t err = cudaFuncSetAttribute(edge_emb_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(emb_smem));
  if (err != cudaSuccess) return err;
  edge_emb_kernel<<<(unsigned)((P + md::kMaxRows - 1) / md::kMaxRows), md::kThreads, emb_smem,
                    s>>>(ea);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ++*launched;

  // NodeBlock: the float32 message sum, then its tail and the node residual
  err = md::node_block_run(p + 2, x, w.he, mask, t, w.xn, w.gpre_n, nullptr, w.aggr, B, N, Dn,
                           De, H, s, launched);
  if (err != cudaSuccess) return err;
  NodeTailArgs na = {static_cast<const bf16*>(p[22]), static_cast<const bf16*>(p[23]),
                     static_cast<const bf16*>(p[24]), static_cast<const bf16*>(p[25]),
                     static_cast<const bf16*>(p[26]), static_cast<const bf16*>(p[27]),
                     x, w.aggr, node_out, (int)BN, Dn, H};
  const size_t tail_smem = md::smem_bytes(md::kMaxRows, Dn + 8, 2) +
                           md::smem_bytes(md::kMaxRows, H + 8, 2) +
                           md::smem_bytes(md::kMaxRows, (Dn > H ? Dn : H) + 4, 4);
  err = cudaFuncSetAttribute(node_tail_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(tail_smem));
  if (err != cudaSuccess) return err;
  node_tail_kernel<<<(unsigned)((BN + md::kMaxRows - 1) / md::kMaxRows), md::kThreads, tail_smem,
                     s>>>(na);
  err = cudaGetLastError();
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
