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
// The simple design: a node-level kernel computes L and R once per node;
// then one CTA per (molecule, group of receivers) builds xp for its pairs in
// shared memory and runs the pair chain there, the widest pair products
// (64 x 256 and 256 x 256) on tensor cores (WMMA), the two one-column
// layers as warp dot products. The force sum over senders closes inside
// the CTA: no CTA waits on another, and the result is deterministic.
#include "common.cuh"

using md::bf16;

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

// One CTA per (group of R receivers, molecule b); row r of the tile is the
// pair (i0 + r / N, r % N).
__global__ void __launch_bounds__(md::kThreads) pos_pair_kernel(const PosArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lde = a.De + 8, ldx = a.Dl + 8, lda = a.I + 8, ldc = a.I + 4;
  size_t off = 0;
  bf16* sE = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kMaxRows, lde, 2);
  bf16* sX = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kMaxRows, ldx, 2);
  bf16* sAct = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kMaxRows, lda, 2);
  float* sC = reinterpret_cast<float*>(smem + off);
  off += md::smem_bytes(md::kMaxRows, ldc, 4);
  float* sW = reinterpret_cast<float*>(smem + off);       // [kMaxRows] pair weight
  off += md::smem_bytes(md::kMaxRows, 1, 4);
  float* sF = reinterpret_cast<float*>(smem + off);       // [kMaxRows, 3] force

  const int N = a.N, I = a.I, G = a.G, Dl = a.Dl;
  const int R = md::groups_per_cta(N);
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * R;
  const int nrec = min(R, N - i0);
  const int rows = nrec * N;
  const int mt = (rows + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t node0 = (size_t)b * N;
  const size_t pair0 = (node0 + i0) * N;
  const size_t total = (size_t)a.B * N;
  const bf16* lft = a.lr + node0 * Dl;
  const bf16* rgt = a.lr + (total + node0) * Dl;

  md::load_rows(sE, lde, rows, mt * 16, a.De,
                [&](int r) { return a.e + (pair0 + r) * a.De; });
  for (int idx = threadIdx.x; idx < mt * 16 * Dl; idx += blockDim.x) {
    const int r = idx / Dl, c = idx % Dl;
    float v = 0.0f;
    if (r < rows) v = md::bf(lft[(size_t)(i0 + r / N) * Dl + c]) * md::bf(rgt[(size_t)(r % N) * Dl + c]);
    sX[r * ldx + c] = md::tobf(v);
  }
  __syncthreads();

  // inter = bf16((e @ Wb) * (xp @ Wn))
  md::cta_gemm(sE, lde, a.wb, a.De, I, sC, ldc, mt, md::kStore);
  __syncthreads();
  md::cta_gemm(sX, ldx, a.wn, Dl, I, sC, ldc, mt, md::kMul);
  __syncthreads();
  for (int idx = threadIdx.x; idx < mt * 16 * I; idx += blockDim.x) {
    const int r = idx / I, c = idx % I;
    sAct[r * lda + c] = md::tobf(sC[r * ldc + c]);
  }
  __syncthreads();
  // inter MLP: Linear -> LN -> relu, then the one-column layer
  md::cta_gemm(sAct, lda, a.w1, I, I, sC, ldc, mt, md::kStore);
  __syncthreads();
  const int nq = I / 32;
  for (int r = warp; r < mt * 16; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) v[q] = sC[r * ldc + lane + 32 * q] + md::bf(a.b1[lane + 32 * q]);
    md::warp_layernorm(v, nq, a.s1, a.b1n, lane);
    float dot = 0.0f;
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) dot += md::rbf(fmaxf(v[q], 0.0f)) * md::bf(a.w2[lane + 32 * q]);
    dot = md::warp_sum(dot);
    if (lane == 0) sW[r] = dot + md::bf(a.b2[0]);
  }
  __syncthreads();
  // gate hidden: e @ Wg1e + xp @ Wg1x (one float32 sum), + t Wg1t + bg1
  const bf16* wg1x = a.wg1 + (size_t)a.De * G;
  const bf16* wg1t = a.wg1 + (size_t)(a.De + Dl) * G;
  md::cta_gemm(sE, lde, a.wg1, a.De, G, sC, ldc, mt, md::kStore);
  __syncthreads();
  md::cta_gemm(sX, ldx, wg1x, Dl, G, sC, ldc, mt, md::kAdd);
  __syncthreads();
  const int gq = G / 32;
  const float tb = a.t[b];
  for (int r = warp; r < rows; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < gq) {
        const int c = lane + 32 * q;
        v[q] = sC[r * ldc + c] + tb * md::bf(wg1t[c]) + md::bf(a.bg1[c]);
      }
    md::warp_layernorm(v, gq, a.sg1, a.bg1n, lane);
    float dot = 0.0f;
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < gq) dot += md::rbf(fmaxf(v[q], 0.0f)) * md::bf(a.wg2[lane + 32 * q]);
    dot = md::warp_sum(dot);
    if (lane < 3) {
      const float w = sW[r] * md::sigmoidf(dot + md::bf(a.bg2[0]));
      const size_t p = pair0 + r;
      const float m = a.mask[p];
      const float d = m > 0.0f ? a.dist[p] : 1.0f;
      sF[r * 3 + lane] = w * a.rel[p * 3 + lane] * (1.0f / d) * (1.0f / (d + 1.0f)) * m;
    }
  }
  __syncthreads();
  // force sum over senders j, in order, per receiver
  for (int idx = threadIdx.x; idx < nrec * 3; idx += blockDim.x) {
    const int rec = idx / 3, k = idx % 3;
    float s = 0.0f;
    for (int j = 0; j < N; ++j) s += sF[(rec * N + j) * 3 + k];
    a.out[(node0 + i0 + rec) * 3 + k] = s;
  }
}

}  // namespace

extern "C" {

// p: 6 left-MLP, 6 right-MLP, 14 edge_lin weights, then x, e, rel, dist,
// mask, t, lr, out.
// *launched: the kernels this call launched (the prep kernel, then the pair
// kernel).
int md_pos_update_forward(const void* const* p, int B, int N, int Dn, int De, int Dl, int I,
                          int G, void* stream, int* launched) {
  PosArgs a;
  const bf16** w = &a.side[0].w1;
  for (int k = 0; k < 26; ++k) w[k] = static_cast<const bf16*>(p[k]);
  a.x = static_cast<const bf16*>(p[26]);
  a.e = static_cast<const bf16*>(p[27]);
  a.rel = static_cast<const float*>(p[28]);
  a.dist = static_cast<const float*>(p[29]);
  a.mask = static_cast<const float*>(p[30]);
  a.t = static_cast<const float*>(p[31]);
  a.lr = static_cast<bf16*>(const_cast<void*>(p[32]));
  a.out = static_cast<float*>(const_cast<void*>(p[33]));
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.Dl = Dl; a.I = I; a.G = G;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;

  const size_t prep_smem = md::smem_bytes(md::kMaxRows, Dn + 8, 2) +
                           md::smem_bytes(md::kMaxRows, Dl + 8, 2) +
                           md::smem_bytes(md::kMaxRows, Dl + 4, 4);
  cudaError_t err = cudaFuncSetAttribute(pos_prep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(prep_smem));
  if (err != cudaSuccess) return err;
  dim3 prep_grid((B * N + md::kMaxRows - 1) / md::kMaxRows, 2);
  pos_prep_kernel<<<prep_grid, md::kThreads, prep_smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *launched = 1;

  const size_t pair_smem = md::smem_bytes(md::kMaxRows, De + 8, 2) +
                           md::smem_bytes(md::kMaxRows, Dl + 8, 2) +
                           md::smem_bytes(md::kMaxRows, I + 8, 2) +
                           md::smem_bytes(md::kMaxRows, I + 4, 4) +
                           md::smem_bytes(md::kMaxRows, 1, 4) +
                           md::smem_bytes(md::kMaxRows, 3, 4);
  err = cudaFuncSetAttribute(pos_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pair_smem));
  if (err != cudaSuccess) return err;
  const int R = md::groups_per_cta(N);
  dim3 grid((N + R - 1) / R, B);
  pos_pair_kernel<<<grid, md::kThreads, pair_smem, s>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return err;
}

}  // extern "C"
