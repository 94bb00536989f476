// Composed-precision inverse of damped SPD blocks, one CTA per block.
//
// Replaces the Pallas TPU kernel repro/kernels/neumann_inv.py (_kernel,
// called from neumann_inv). Per block, on n <= 128 as given (no identity
// padding; the kernel zero-pads to 128 in shared memory only, which is
// exact):
//   Ad = A + lam I, split Ad = A_H + A_L (bf16),
//   X0 = A_H / (|A_H|_1 |A_H|_inf),
//   ns_iters Newton-Schulz steps   X <- X (2I - A_H X),
//   taylor_terms-1 Neumann terms   T <- -X (A_L T),  M += T,
//   refine_steps refinements       M <- M + M (I - Ad M),
// every product a sum of bf16 partial products on the tensor cores with
// fp32 accumulation (2 partials against an exact bf16 slice, 3 otherwise).
//
// Bound: operations. A block does 5*ns + 5*(taylor-1) + 6*refine partial
// 128^3 GEMMs (127 at the K-FAC counts 20/4/2, 533 MFLOP) against 128 KB of
// input and output, ~4000 FLOP per byte, far right of the H100's ~295 bf16
// FLOP/byte ridge.
// Design against that bound: the whole iteration stays on chip. Six bf16
// 128x136 tiles (A_H, A_L, X hi/lo, W hi/lo = 204 KB of shared memory)
// hold every operand; fp32 state (the product being formed, the Neumann
// sum M) lives in registers in the mma accumulator layout, so device
// memory is touched once to load the block and once to store its inverse.
// The shared-memory budget is met by reusing the W pair for every
// right-hand operand (2I - A_H X, T, A_L T, I - Ad M), each step fully
// consuming it before it is overwritten, and by holding M only in
// registers. One CTA per SM (8 warps, mma.sync); wgmma/TMA pipelining is
// later work.
#include "hilo_mma.cuh"

using namespace hilo;

namespace {

constexpr int SMEM_BYTES = 6 * TILE_BYTES + (2 * NP + 1) * 4;

__global__ void __launch_bounds__(THREADS, 1)
neumann_inv_kernel(const float* __restrict__ a,
                   const float* __restrict__ damping,
                   float* __restrict__ out, int n, int ns_iters,
                   int taylor_terms, int refine_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* AH = reinterpret_cast<bf16*>(smem);
  bf16* AL = AH + TILE_ELEMS;
  bf16* XH = AL + TILE_ELEMS;
  bf16* XL = XH + TILE_ELEMS;
  bf16* WH = XL + TILE_ELEMS;
  bf16* WL = WH + TILE_ELEMS;
  float* red = reinterpret_cast<float*>(WL + TILE_ELEMS);

  const int tid = threadIdx.x;
  const size_t blk = static_cast<size_t>(blockIdx.x) * n * n;

  // Ad = A + lam I, split into the A_H / A_L slices
  load_split(a + blk, n, n, n, damping[blockIdx.x], AH, AL);
  __syncthreads();

  // |A_H|_1 (max column sum) and |A_H|_inf (max row sum)
  {
    float s = 0.f;
    const int r = tid & (NP - 1);
    if (r < n) {
      for (int k = 0; k < n; ++k) {
        const bf16 v = tid < NP ? AH[k * LDS + r] : AH[r * LDS + k];
        s += fabsf(__bfloat162float(v));
      }
    }
    red[tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float n1 = 0.f, ninf = 0.f;
    for (int k = 0; k < NP; ++k) {
      n1 = fmaxf(n1, red[k]);
      ninf = fmaxf(ninf, red[NP + k]);
    }
    red[2 * NP] = n1 * ninf;
  }
  __syncthreads();
  const float bound = red[2 * NP];

  Acc x, m;
  for_each(x, [&](int r, int c, float& v) {
    v = __bfloat162float(AH[r * LDS + c]) / bound;
  });
  store_split(x, XH, XL);
  __syncthreads();

  // (2) Newton-Schulz on the hi slice: X <- X (2I - A_H X)
  for (int it = 0; it < ns_iters; ++it) {
    zero(x);
    gemm(x, AH, XH);
    gemm(x, AH, XL);
    for_each(x, [&](int r, int c, float& v) {
      v = (r == c && r < n ? 2.f : 0.f) - v;
    });
    store_split(x, WH, WL);
    __syncthreads();
    zero(x);
    gemm(x, XH, WH);
    gemm(x, XH, WL);
    gemm(x, XL, WH);
    __syncthreads();
    store_split(x, XH, XL);
    __syncthreads();
  }

  // (3) Neumann series over the lo slice: M = X, T = X, T <- -X (A_L T)
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[mi][ni][e] = x[mi][ni][e];
  store_split(x, WH, WL);
  __syncthreads();
  for (int it = 0; it + 1 < taylor_terms; ++it) {
    zero(x);
    gemm(x, AL, WH);
    gemm(x, AL, WL);
    __syncthreads();
    store_split(x, WH, WL);
    __syncthreads();
    zero(x);
    gemm(x, XH, WH);
    gemm(x, XH, WL);
    gemm(x, XL, WH);
    for_each(x, [&](int r, int c, float& v) { v = -v; });
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[mi][ni][e] += x[mi][ni][e];
    __syncthreads();
    store_split(x, WH, WL);
    __syncthreads();
  }

  // (4) refinement against the full block: M <- M + M (I - Ad M); the X
  // pair now holds M's slices (split(Ad) = (A_H, A_L))
  for (int it = 0; it < refine_steps; ++it) {
    __syncthreads();
    store_split(m, XH, XL);
    __syncthreads();
    zero(x);
    gemm(x, AH, XH);
    gemm(x, AH, XL);
    gemm(x, AL, XH);
    for_each(x, [&](int r, int c, float& v) {
      v = (r == c && r < n ? 1.f : 0.f) - v;
    });
    store_split(x, WH, WL);
    __syncthreads();
    zero(x);
    gemm(x, XH, WH);
    gemm(x, XH, WL);
    gemm(x, XL, WH);
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[mi][ni][e] += x[mi][ni][e];
  }

  float* o = out + blk;
  for_each(m, [&](int r, int c, float& v) {
    if (r < n && c < n) o[r * n + c] = v;
  });
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int neumann_inv_launch(const float* a, const float* damping,
                                  float* out, int nb, int n, int ns_iters,
                                  int taylor_terms, int refine_steps,
                                  void* stream) {
  if (n < 1 || n > NP) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      neumann_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  neumann_inv_kernel<<<nb, THREADS, SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      a, damping, out, n, ns_iters, taylor_terms, refine_steps);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* neumann_inv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
