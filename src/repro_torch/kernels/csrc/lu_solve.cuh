// The k x k solve of the SMW update inside one CTA: LU with partial
// pivoting of a capacitance S held in shared memory, applied to a block of
// right-hand sides B there. The one-CTA kernel of smw_update.cu solves its
// whole (k x bs) Y with it, and the large route's slab kernel (bs above 128,
// k <= 128) one slab of at most 128 columns of Y a CTA: every slab factors
// the same S in the same way, and a column's arithmetic does not depend on
// the other columns, so Z does not depend on the slab.
#pragma once

#include "hilo_mma.cuh"

namespace smw {

constexpr int SLD = hilo::NP + 1;  // fp32 row stride (words)
constexpr int ILP = 8;             // rows a thread updates between stores

// Z = S^-1 B in place: S (k x k) and B (k x bs), both row stride SLD in
// shared memory; k + bs <= THREADS. LU with partial pivoting (the first
// largest |pivot| of the column), the forward substitution folded into the
// elimination. At step j a warp finds the pivot row p; then each thread
// owns one column of [S | B] right of j, swaps rows j and p in it and
// eliminates below row j with multipliers S[i][j] / S[p][j] (taken as a
// product with the pivot's reciprocal, as LAPACK's getf2 scales them), read
// from column j, which nobody writes during the step: no thread waits on
// another inside a step. U's diagonal goes to udiag (column j keeps its
// unswapped values). Back substitution: a thread per column of B. Every
// update is an explicit fp32 fma(-l, u, x), the arithmetic of the large
// route's blocked LU (lu_blocked.cuh), which is bitwise this solve.
__device__ void lu_solve(float* S, float* B, int k, int bs, float* scratch) {
  int* piv = reinterpret_cast<int*>(scratch);
  float* udiag = scratch + 1;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < k; ++j) {
    if (threadIdx.x < 32) {
      float best = -1.f;
      int p = j;
      for (int i = j + lane; i < k; i += 32) {
        const float a = fabsf(S[i * SLD + j]);
        if (a > best) {
          best = a;
          p = i;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int op = __shfl_xor_sync(0xffffffffu, p, off);
        if (ob > best || (ob == best && op < p)) {
          best = ob;
          p = op;
        }
      }
      if (lane == 0) {
        *piv = p;
        udiag[j] = S[p * SLD + j];
      }
    }
    __syncthreads();
    const int p = *piv;
    const float r = 1.f / udiag[j];
    const int ws = k - j - 1;          // S columns right of j
    if (threadIdx.x < ws + bs) {
      float* col = threadIdx.x < ws ? S + j + 1 + threadIdx.x
                                    : B + threadIdx.x - ws;
      const float top = col[p * SLD];
      const float was = col[j * SLD];
      col[j * SLD] = top;
      col[p * SLD] = was;
      // rows in batches of ILP: all loads of a batch before its stores
      for (int i0 = j + 1; i0 < k; i0 += ILP) {
        float l[ILP], x[ILP];
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          const int i = i0 + u < k ? i0 + u : j;
          l[u] = S[(i == p ? j : i) * SLD + j] * r;
          x[u] = col[i * SLD];
        }
#pragma unroll
        for (int u = 0; u < ILP; ++u)
          if (i0 + u < k) col[(i0 + u) * SLD] = __fmaf_rn(-l[u], top, x[u]);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < bs) {
    float* col = B + threadIdx.x;
    for (int j = k - 1; j >= 0; --j) {
      const float x = col[j * SLD] / udiag[j];
      col[j * SLD] = x;
      for (int i0 = 0; i0 < j; i0 += ILP) {
        float u_[ILP], y[ILP];
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          const int i = i0 + u < j ? i0 + u : 0;
          u_[u] = S[i * SLD + j];
          y[u] = col[i * SLD];
        }
#pragma unroll
        for (int u = 0; u < ILP; ++u)
          if (i0 + u < j) col[(i0 + u) * SLD] = __fmaf_rn(-u_[u], x, y[u]);
      }
    }
  }
  __syncthreads();
}

}  // namespace smw
