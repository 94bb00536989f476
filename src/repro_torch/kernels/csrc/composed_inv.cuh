// The composed-precision inverse of one damped block, as a CTA-wide device
// function shared by neumann_inv.cu and fused_gram_solve.cu.
//
// On entry the A_H / A_L tiles hold the hi/lo bf16 slices of the damped
// block Ad = A + lam I (zero outside n x n) and the CTA is synchronised.
// Then, on n <= 128 as given:
//   X0 = A_H / (|A_H|_1 |A_H|_inf),
//   ns_iters Newton-Schulz steps   X <- X (2I - A_H X),
//   taylor_terms-1 Neumann terms   T <- -X (A_L T),  M += T,
//   refine_steps refinements       M <- M + M (I - Ad M),
// every product a sum of bf16 partial products on the tensor cores with
// fp32 accumulation (2 partials against an exact bf16 slice, 3 otherwise),
// and M's n x n corner is written row-major to `out`.
//
// Six bf16 128x136 tiles (A_H, A_L, X hi/lo, W hi/lo = 204 KB of shared
// memory) hold every operand; fp32 state (the product being formed, the
// Neumann sum M) lives in registers in the mma accumulator layout. The W
// pair is reused for every right-hand operand (2I - A_H X, T, A_L T,
// I - Ad M), each step fully consuming it before it is overwritten.
#pragma once

#include "hilo_mma.cuh"

namespace hilo {

// Dynamic shared memory of a CTA running composed_inverse.
constexpr int COMPOSED_SMEM_BYTES = 6 * TILE_BYTES + (2 * NP + 1) * 4;

struct ComposedTiles {
  bf16 *AH, *AL, *XH, *XL, *WH, *WL;
  float* red;  // 2 * NP + 1 floats of scratch
};

__device__ __forceinline__ ComposedTiles carve_tiles(unsigned char* smem) {
  ComposedTiles s;
  s.AH = reinterpret_cast<bf16*>(smem);
  s.AL = s.AH + TILE_ELEMS;
  s.XH = s.AL + TILE_ELEMS;
  s.XL = s.XH + TILE_ELEMS;
  s.WH = s.XL + TILE_ELEMS;
  s.WL = s.WH + TILE_ELEMS;
  s.red = reinterpret_cast<float*>(s.WL + TILE_ELEMS);
  return s;
}

__device__ __forceinline__ void composed_inverse(const ComposedTiles& s,
                                                 int n, int ns_iters,
                                                 int taylor_terms,
                                                 int refine_steps,
                                                 float* __restrict__ o) {
  bf16* AH = s.AH;
  bf16* AL = s.AL;
  bf16* XH = s.XH;
  bf16* XL = s.XL;
  bf16* WH = s.WH;
  bf16* WL = s.WL;
  float* red = s.red;
  const int tid = threadIdx.x;

  // |A_H|_1 (max column sum) and |A_H|_inf (max row sum)
  {
    float sum = 0.f;
    const int r = tid & (NP - 1);
    if (r < n) {
      for (int k = 0; k < n; ++k) {
        const bf16 v = tid < NP ? AH[k * LDS + r] : AH[r * LDS + k];
        sum += fabsf(__bfloat162float(v));
      }
    }
    red[tid] = sum;
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

  // Newton-Schulz on the hi slice: X <- X (2I - A_H X)
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

  // Neumann series over the lo slice: M = X, T = X, T <- -X (A_L T)
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

  // refinement against the full block: M <- M + M (I - Ad M); the X pair
  // now holds M's slices (split(Ad) = (A_H, A_L))
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

  for_each(m, [&](int r, int c, float& v) {
    if (r < n && c < n) o[r * n + c] = v;
  });
}

}  // namespace hilo
