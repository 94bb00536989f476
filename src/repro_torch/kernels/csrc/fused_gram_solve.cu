// Fused Gram accumulation and composed-precision inverse, one CTA per
// feature block.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_gram_solve.py
// (_kernel, called from fused_gram_inv). For activations a (T, nb, n),
// fp32 or bf16, and each block i, on n <= 128 as given:
//   G_i   = (a_hi^T a_hi + a_hi^T a_lo + a_lo^T a_hi) / T   (a = a[:, i, :])
//   lam_i = rel_damp * tr(G_i) / n + 1e-8
//   out_i = composed inverse of G_i + lam_i I   (composed_inv.cuh)
// every product a sum of bf16 partial products on the tensor cores with
// fp32 accumulation. The Gram never goes to device memory.
//
// Unlike the TPU kernel, n is not padded to 128 with a lam-damped tail: the
// padded block is block-diagonal with the same norms, so its top-left
// inverse is the unpadded one; here the tail is zero in shared memory only,
// as in neumann_inv.cu. Ragged T: the last token tile is zero-filled, which
// adds nothing to the Gram.
//
// Bound: operations. Per block, 3 partial (n x T) (T x n) Gram products and
// the 127 partial 128^3 GEMMs of the inverse at the K-FAC counts 20/4/2;
// at the main path's largest A leaf (T 2048, nb 528, n 128) that is
// 106 + 281 GFLOP (0.39 ms at 989 TFLOP/s) against 588 MB (0.18 ms).
// Design: the CTA streams its block's (128, n) token tiles through the X
// and W tile pairs of composed_inv.cuh (free until the inverse starts),
// alternating between the two so that one barrier a tile suffices; the
// next tile's fp32 values are loaded into registers before this tile's
// products (the inverse needs more registers than this phase, so the
// prefetch costs no occupancy). gemm3 reads the transposed operand with
// ldmatrix.trans and accumulates the Gram in the mma accumulator registers.
// The trace is reduced from the accumulator diagonal through shared memory,
// lam added on the diagonal, and the damped Gram split into the A_H / A_L
// tiles, where composed_inverse takes over. One CTA per SM; splitting T
// across CTAs for few-block, many-token calls is later work.
#include "composed_inv.cuh"

using namespace hilo;

namespace {

constexpr int BT = NP;                                // tokens per tile
constexpr int TOK_PER_THREAD = BT * NP / THREADS;    // 64
constexpr int ROWS_PER_PASS = THREADS / NP;           // 2

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// This thread's values of the token tile at t0: column tid % NP of rows
// tid / NP + i * ROWS_PER_PASS, zero outside T x n.
template <class T>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
                                          size_t row_stride, int t_tok,
                                          int n, int t0,
                                          float v[TOK_PER_THREAD]) {
  const int c = threadIdx.x % NP;
  const int r0 = t0 + threadIdx.x / NP;
#pragma unroll
  for (int i = 0; i < TOK_PER_THREAD; ++i) {
    const int t = r0 + i * ROWS_PER_PASS;
    v[i] = (t < t_tok && c < n)
               ? to_f32(src[static_cast<size_t>(t) * row_stride + c])
               : 0.f;
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
fused_gram_inv_kernel(const T* __restrict__ a, float* __restrict__ out,
                      int t_tok, int nb, int n, float rel_damp, int ns_iters,
                      int taylor_terms, int refine_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ComposedTiles s = carve_tiles(smem);
  const int tid = threadIdx.x;
  const size_t row_stride = static_cast<size_t>(nb) * n;
  const T* src = a + static_cast<size_t>(blockIdx.x) * n;

  // Gram: acc += tile^T tile over the token tiles, 3 hi/lo partials
  Acc acc;
  zero(acc);
  float v[TOK_PER_THREAD];
  load_tile(src, row_stride, t_tok, n, 0, v);
  for (int t0 = 0, tile = 0; t0 < t_tok; t0 += BT, ++tile) {
    bf16* H = (tile & 1) ? s.WH : s.XH;
    bf16* L = (tile & 1) ? s.WL : s.XL;
#pragma unroll
    for (int i = 0; i < TOK_PER_THREAD; ++i) {
      const int off = (tid / NP + i * ROWS_PER_PASS) * LDS + tid % NP;
      split(v[i], H[off], L[off]);
    }
    __syncthreads();
    if (t0 + BT < t_tok) load_tile(src, row_stride, t_tok, n, t0 + BT, v);
    const int kd = (min(BT, t_tok - t0) + 15) & ~15;
    gemm3<true, false>(acc, H, L, H, L, kd, n, n);
  }

  // G = acc / T; lam = rel_damp * tr(G) / n + 1e-8 on the diagonal
  const float tf = static_cast<float>(t_tok);
  for_each(acc, [&](int r, int c, float& x) {
    x = x / tf;
    if (r == c && r < n) s.red[r] = x;
  });
  __syncthreads();
  if (tid == 0) {
    float tr = 0.f;
    for (int k = 0; k < n; ++k) tr += s.red[k];
    s.red[2 * NP] = rel_damp * tr / static_cast<float>(n) + 1e-8f;
  }
  __syncthreads();
  const float lam = s.red[2 * NP];
  for_each(acc, [&](int r, int c, float& x) {
    if (r == c && r < n) x += lam;
  });
  store_split(acc, s.AH, s.AL);
  __syncthreads();
  composed_inverse(s, n, ns_iters, taylor_terms, refine_steps,
                   out + static_cast<size_t>(blockIdx.x) * n * n);
}

template <class T>
int launch(const T* a, float* out, int t_tok, int nb, int n, float rel_damp,
           int ns_iters, int taylor_terms, int refine_steps, void* stream) {
  if (n < 1 || n > NP || t_tok < 1 || nb < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_gram_inv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      COMPOSED_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_gram_inv_kernel<T><<<nb, THREADS, COMPOSED_SMEM_BYTES,
                             static_cast<cudaStream_t>(stream)>>>(
      a, out, t_tok, nb, n, rel_damp, ns_iters, taylor_terms, refine_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` for contiguous a (T, nb, n) and out (nb, n, n);
// returns the cudaError_t of the launch (0 = success).
extern "C" int fused_gram_inv_f32_launch(const float* a, float* out, int t_tok,
                                         int nb, int n, float rel_damp,
                                         int ns_iters, int taylor_terms,
                                         int refine_steps, void* stream) {
  return launch(a, out, t_tok, nb, n, rel_damp, ns_iters, taylor_terms,
                refine_steps, stream);
}

extern "C" int fused_gram_inv_bf16_launch(const bf16* a, float* out,
                                          int t_tok, int nb, int n,
                                          float rel_damp, int ns_iters,
                                          int taylor_terms, int refine_steps,
                                          void* stream) {
  return launch(a, out, t_tok, nb, n, rel_damp, ns_iters, taylor_terms,
                refine_steps, stream);
}

extern "C" const char* fused_gram_inv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
