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
// The simple design: a node-level kernel computes the sender MLP xn[j] and
// the sender part of the gate's first layer once per node; then one CTA per
// (molecule, group of receivers) holds up to 64 pairs in shared memory and
// runs the five pair products on tensor cores (WMMA, not wgmma), reading
// weights from L2. The sum over senders closes inside the CTA, so no CTA
// waits on another and the result is deterministic. It moves no [N, N, H]
// intermediate through device memory; its distance from the bound is the
// WMMA path, the weight reloads per CTA and one CTA per SM.
#include "common.cuh"

using md::bf16;

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

// One CTA per (molecule b, group of R receivers); row r of the tile is the
// pair (i0 + r / N, r % N).
__global__ void __launch_bounds__(md::kThreads) node_pair_kernel(const NodeBlockArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int lde = a.De + 8, lda = a.H + 8, ldc = a.H + 4;
  size_t off = 0;
  bf16* sE = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kMaxRows, lde, 2);
  bf16* sAct = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kMaxRows, lda, 2);
  bf16* sMsg = reinterpret_cast<bf16*>(smem + off);
  off += md::smem_bytes(md::kMaxRows, lda, 2);
  float* sC = reinterpret_cast<float*>(smem + off);

  const int N = a.N, H = a.H;
  const int R = md::groups_per_cta(N);
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * R;
  const int nrec = min(R, N - i0);
  const int rows = nrec * N;
  const int mt = (rows + 15) / 16;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nq = H / 32;
  const size_t pair0 = ((size_t)b * N + i0) * N;  // first pair of the tile

  md::load_rows(sE, lde, rows, mt * 16, a.De,
                [&](int r) { return a.e + (pair0 + r) * a.De; });
  __syncthreads();

  // edge MLP: Linear -> LN -> relu
  md::cta_gemm(sE, lde, a.we1, a.De, H, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int r = warp; r < mt * 16; r += md::kWarps) {
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) v[q] = sC[r * ldc + lane + 32 * q] + md::bf(a.be1[lane + 32 * q]);
    md::warp_layernorm(v, nq, a.se1, a.be1n, lane);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) sAct[r * lda + lane + 32 * q] = md::tobf(fmaxf(v[q], 0.0f));
  }
  __syncthreads();
  // edge MLP second layer, then the bilinear product with the sender MLP
  md::cta_gemm(sAct, lda, a.we2, H, H, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < mt * 16 * H; idx += blockDim.x) {
    const int r = idx / H, c = idx % H;
    float hh = 0.0f;
    if (r < rows) {
      const float h = md::rbf(sC[r * ldc + c] + md::bf(a.be2[c]));
      hh = h * md::bf(a.xn[((size_t)b * N + r % N) * H + c]);
    }
    sAct[r * lda + c] = md::tobf(hh);
  }
  __syncthreads();
  // message
  md::cta_gemm(sAct, lda, a.wm, H, H, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int idx = threadIdx.x; idx < mt * 16 * H; idx += blockDim.x) {
    const int r = idx / H, c = idx % H;
    sMsg[r * lda + c] = md::tobf(sC[r * ldc + c] + md::bf(a.bm[c]));
  }
  __syncthreads();
  // gate: edge part of the first layer + precomputed sender/time part
  md::cta_gemm(sE, lde, a.wg1, a.De, H, sC, ldc, mt, md::kStore);
  __syncthreads();
  for (int r = warp; r < mt * 16; r += md::kWarps) {
    const float* gp = a.gpre + ((size_t)b * N + (r < rows ? r % N : 0)) * H;
    float v[md::kMaxPerLane];
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) v[q] = sC[r * ldc + lane + 32 * q] + gp[lane + 32 * q];
    md::warp_layernorm(v, nq, a.sg1, a.bg1n, lane);
#pragma unroll
    for (int q = 0; q < md::kMaxPerLane; ++q)
      if (q < nq) sAct[r * lda + lane + 32 * q] = md::tobf(fmaxf(v[q], 0.0f));
  }
  __syncthreads();
  md::cta_gemm(sAct, lda, a.wg2, H, H, sC, ldc, mt, md::kStore);
  __syncthreads();
  // gated, masked message (float32), in place of the gate logits
  for (int idx = threadIdx.x; idx < rows * H; idx += blockDim.x) {
    const int r = idx / H, c = idx % H;
    const float g = md::rbf(md::sigmoidf(sC[r * ldc + c] + md::bf(a.bg2[c])));
    const float gated = md::rbf(md::bf(sMsg[r * lda + c]) * g);
    sC[r * ldc + c] = gated * a.mask[pair0 + r];
  }
  __syncthreads();
  // sum over senders j, in order, per receiver
  for (int idx = threadIdx.x; idx < nrec * H; idx += blockDim.x) {
    const int rec = idx / H, c = idx % H;
    float s = 0.0f;
    for (int j = 0; j < N; ++j) s += sC[(rec * N + j) * ldc + c];
    a.out[((size_t)b * N + i0 + rec) * H + c] = md::tobf(s);
  }
}

}  // namespace

extern "C" {

const char* md_error_name(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// p: 20 weight pointers in NodeBlockArgs order, then x, e, mask, t, xn, gpre, out.
// *launched: the kernels this call launched (the prep kernel, then the pair
// kernel).
int md_node_block_forward(const void* const* p, int B, int N, int Dn, int De, int H,
                          void* stream, int* launched) {
  NodeBlockArgs a;
  const bf16** w = &a.we1;
  for (int k = 0; k < 20; ++k) w[k] = static_cast<const bf16*>(p[k]);
  a.x = static_cast<const bf16*>(p[20]);
  a.e = static_cast<const bf16*>(p[21]);
  a.mask = static_cast<const float*>(p[22]);
  a.t = static_cast<const float*>(p[23]);
  a.xn = static_cast<bf16*>(const_cast<void*>(p[24]));
  a.gpre = static_cast<float*>(const_cast<void*>(p[25]));
  a.out = static_cast<bf16*>(const_cast<void*>(p[26]));
  a.B = B; a.N = N; a.Dn = Dn; a.De = De; a.H = H;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  *launched = 0;

  const size_t prep_smem = md::smem_bytes(md::kMaxRows, Dn + 8, 2) +
                           md::smem_bytes(md::kMaxRows, H + 8, 2) +
                           md::smem_bytes(md::kMaxRows, H + 4, 4);
  cudaError_t err = cudaFuncSetAttribute(node_prep_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(prep_smem));
  if (err != cudaSuccess) return err;
  const int prep_blocks = (B * N + md::kMaxRows - 1) / md::kMaxRows;
  node_prep_kernel<<<prep_blocks, md::kThreads, prep_smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  *launched = 1;

  const size_t pair_smem = md::smem_bytes(md::kMaxRows, De + 8, 2) +
                           2 * md::smem_bytes(md::kMaxRows, H + 8, 2) +
                           md::smem_bytes(md::kMaxRows, H + 4, 4);
  err = cudaFuncSetAttribute(node_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(pair_smem));
  if (err != cudaSuccess) return err;
  const int R = md::groups_per_cta(N);
  dim3 grid((N + R - 1) / R, B);
  node_pair_kernel<<<grid, md::kThreads, pair_smem, s>>>(a);
  err = cudaGetLastError();
  if (err == cudaSuccess) *launched = 2;
  return err;
}

}  // extern "C"
