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
// The left chain's sum runs over rows and the right chain's over columns,
// so a tile of rows cannot close both. The simple design gives each chain
// its own CTAs: one CTA per (molecule, group of columns) for the left chain
// and one per (molecule, group of rows) for the right chain (grid z = side).
// Each CTA holds all N pairs of its columns (rows), so every sum closes
// inside the CTA: no atomics, no CTA waits on another, and the result is
// deterministic. A node-level kernel first computes x @ Wn and the node and
// time part of the gate's first layer once per node and side.
#include "grad.cuh"

using md::bf16;

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

// One CTA per (group of R output indices k, molecule b, side). Row r of the
// tile is group g = r / N and node m = r % N: the pair (m, k) for the left
// chain, (k, m) for the right chain. The chain's node features are m's.
__global__ void __launch_bounds__(md::kThreads) edge_pair_kernel(const EdgePairArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lde = a.De + 8, lda = a.I + 8, ldc = a.I + 4, ldo = a.Do + 4;
  size_t off = 0;
  bf16* sE = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kMaxRows, lde, 2);
  bf16* sAct = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kMaxRows, lda, 2);
  float* sC = reinterpret_cast<float*>(smem + off);
  off += md::smem_bytes(md::kMaxRows, ldc, 4);
  float* sOut = reinterpret_cast<float*>(smem + off);

  const int N = a.N, I = a.I, G = a.G, Do = a.Do;
  const int side = blockIdx.z;
  const BondFfn& w = a.side[side];
  const int R = md::groups_per_cta(N);
  const int b = blockIdx.y;
  const int k0 = blockIdx.x * R;
  const int nk = min(R, N - k0);
  const int rows = nk * N;
  const int mt = (rows + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t node0 = (size_t)b * N;
  const size_t total = (size_t)a.B * N;
  const float* np = a.np + side * total * I + node0 * I;
  const float* gpre = a.gpre + side * total * G + node0 * G;
  // pair index (b, i, j) of tile row r
  auto pair_of = [&](int r) -> size_t {
    const int k = k0 + r / N, m = r % N;
    return side == 0 ? (node0 + m) * N + k : (node0 + k) * N + m;
  };

  md::load_rows(sE, lde, rows, mt * 16, a.De,
                [&](int r) { return a.e + pair_of(r) * a.De; });
  __syncthreads();

  // inter = bf16(bond projection * node projection)
  md::cta_gemm(sE, lde, w.wb, a.De, I, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < mt * 16 * I; idx += blockDim.x) {
    const int r = idx / I, c = idx % I;
    const float v = r < rows ? sC[r * ldc + c] * np[(r % N) * I + c] : 0.0f;
    sAct[r * lda + c] = md::tobf(v);
  }
  __syncthreads();
  // inter MLP: Linear -> LN -> relu -> Linear (float32 out, bias later)
  md::cta_gemm(sAct, lda, w.w1, I, I, sC, ldc, mt, md::kStore);
  __syncthreads();
  const int nq = I / 32;
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
  md::cta_gemm(sAct, lda, w.w2, I, Do, sOut, ldo, mt, md::kStore);
  __syncthreads();
  // gate hidden: edge part + precomputed node/time part, LN, relu
  md::cta_gemm(sE, lde, w.wg1, a.De, G, sC, ldc, mt, md::kStore);
  __syncthreads();
  const int gq = G / 32;
  for (int r = warp; r < mt * 16; r += md::kWarps) {
    const float* gp = gpre + (size_t)(r < rows ? r % N : 0) * G;
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < gq) v[q] = sC[r * ldc + lane + 32 * q] + gp[lane + 32 * q];
    md::warp_layernorm(v, gq, w.sg1, w.bg1n, lane);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < gq) sAct[r * lda + lane + 32 * q] = md::tobf(fmaxf(v[q], 0.0f));
  }
  __syncthreads();
  md::cta_gemm(sAct, lda, w.wg2, G, Do, sC, ldc, mt, md::kStore);
  __syncthreads();
  // msg = (out + b2) * sigmoid(gate), masked
  for (int idx = threadIdx.x; idx < rows * Do; idx += blockDim.x) {
    const int r = idx / Do, c = idx % Do;
    const float sig = md::sigmoidf(sC[r * ldc + c] + md::bf(w.bg2[c]));
    const float msg = (sOut[r * ldo + c] + md::bf(w.b2[c])) * sig;
    sOut[r * ldo + c] = (a.round_msg ? md::rbf(msg) : msg) * a.mask[pair_of(r)];
  }
  __syncthreads();
  // sum over the N pairs of each group, in order
  bf16* out = a.out + (size_t)side * total * Do;
  for (int idx = threadIdx.x; idx < nk * Do; idx += blockDim.x) {
    const int g = idx / Do, c = idx % Do;
    float s = 0.0f;
    for (int m = 0; m < N; ++m) s += sOut[(g * N + m) * ldo + c];
    out[(node0 + k0 + g) * Do + c] = md::tobf(s);
  }
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

cudaError_t edge_pair_run(const void* const* weights, const bf16* e, const bf16* x,
                          const float* mask, const float* t, float* np, float* gpre, bf16* out,
                          int B, int N, int Dn, int De, int I, int G, int Do, int round_msg,
                          cudaStream_t s, int* launched) {
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

  const size_t pair_smem = md::smem_bytes(md::kMaxRows, De + 8, 2) +
                           md::smem_bytes(md::kMaxRows, I + 8, 2) +
                           md::smem_bytes(md::kMaxRows, I + 4, 4) +
                           md::smem_bytes(md::kMaxRows, Do + 4, 4);
  err = cudaFuncSetAttribute(edge_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pair_smem));
  if (err != cudaSuccess) return err;
  const int R = md::groups_per_cta(N);
  dim3 grid((N + R - 1) / R, B, 2);
  edge_pair_kernel<<<grid, md::kThreads, pair_smem, s>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return err;
}

}  // namespace md

extern "C" {

// p: 14 left weights, 14 right weights (BondFfn order), then e, x, mask, t,
// np, gpre, out.
// *launched: the kernels this call launched (the prep kernel, then the pair
// kernel).
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
