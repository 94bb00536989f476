// The composed-precision inverse of one damped block, as a CTA-wide device
// function shared by neumann_inv.cu and fused_gram_solve.cu, on wgmma
// (wgmma.cuh). fused_precond.cu and smw_update.cu keep the mma.sync helpers
// of hilo_mma.cuh; this file takes only split2 and the cp.async helpers from
// there.
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
// Six bf16 128 x 128 tiles in wgmma's 128-byte-swizzle layout (A_H, A_L,
// X hi/lo, W hi/lo: 192 KB) hold every operand; fp32 state (the product
// being formed, the Neumann sum M) lives in registers in the wgmma
// accumulator layout. Each of the two warpgroups owns 64 rows of every
// product, both operands read from shared memory: the 2 or 3 partials of a
// product are one chain of wgmma into one accumulator, one commit, one
// wait. A warpgroup reads only its own rows of the left operand and writes
// only its own rows of each result, so a barrier is needed only where a
// tile read as a right operand (all rows) is written: once it is whole
// before it is read, and, where a product's own right operand is
// overwritten, once every warpgroup has read it. A Newton-Schulz step takes
// two barriers, W whole and X whole. The W pair is reused for every
// right-hand operand (2I - A_H X, T, A_L T, I - Ad M).
//
// Registers: near the 255-register limit ptxas leaves too few for the
// wgmma pipeline and serialises every wgmma of the kernel; a first version
// with 64-bit generic tile pointers and unrolled k-loops did, and took
// 1.15 ms at 528 blocks on an H100 SXM against 0.55 ms. So tiles are named
// by 32-bit shared addresses, descriptors are built inside a k-loop that is
// not unrolled, and once M is live (Neumann terms, refinements) the
// products run on one 64-column half at a time (m64n64, 32 accumulators),
// so that 96 and not 128 accumulators are live (200 against 248 registers
// a thread, at the same speed), which leaves the pipeline room.
#pragma once

#include "hilo_mma.cuh"
#include "wgmma.cuh"

namespace composed {

using wgmma::Acc;
using wgmma::Acc32;
using wgmma::bf16;

constexpr int NP = 128;                             // largest block side
constexpr int THREADS = wgmma::THREADS;             // two warpgroups
constexpr int TILE_BYTES = wgmma::tile_bytes<NP>();  // 32 KB
constexpr int RED_FLOATS = 2 * NP + 16;
// Dynamic shared memory of a CTA running inverse(): six tiles, the scratch,
// and the slack that puts the tiles on a 1024-byte boundary.
constexpr int SMEM_BYTES = 1024 + 6 * TILE_BYTES + RED_FLOATS * 4;

struct Tiles {
  uint32_t AH, AL, XH, XL, WH, WL;  // shared addresses, 1024-byte aligned
  unsigned char* base;              // generic address of AH
  float* red;                       // RED_FLOATS of scratch
};

__device__ __forceinline__ Tiles carve(unsigned char* smem) {
  const uint32_t a = wgmma::smem_addr(smem);
  const uint32_t pad = (1024u - (a & 1023u)) & 1023u;
  Tiles s;
  s.AH = a + pad;
  s.AL = s.AH + TILE_BYTES;
  s.XH = s.AL + TILE_BYTES;
  s.XL = s.XH + TILE_BYTES;
  s.WH = s.XL + TILE_BYTES;
  s.WL = s.WH + TILE_BYTES;
  s.base = smem + pad;
  s.red = reinterpret_cast<float*>(smem + pad + 6 * TILE_BYTES);
  return s;
}

// Write the hi/lo slices of this thread's accumulators (columns from c0)
// into H and L (its warpgroup's 64 rows), then fence them for wgmma; a
// barrier must follow before another warpgroup reads them. stmatrix stores
// four 8 x 8 blocks of a warp's accumulator layout an instruction (16 bytes
// of a swizzled row from each lane's address): accumulators 8k .. 8k+7 are
// the rows 0-7 and 8-15 of the warp's 16 at columns 16k .. +8, then 8 on.
template <int N>
__device__ __forceinline__ void store_split(const float (&x)[N], uint32_t H,
                                            uint32_t L, int c0 = 0) {
  const int t = wgmma::opaque_tid();
  const int lane = t & 31;
  const int row = (t >> 7) * 64 + ((t >> 5) & 3) * 16 +
                  ((lane >> 3) & 1) * 8 + (lane & 7);
  const int r7 = row & 7;
#pragma unroll
  for (int k = 0; k < N / 8; ++k) {
    const int col = c0 + 16 * k + 8 * (lane >> 4);
    const uint32_t o = (col >> 6) * wgmma::half_bytes<NP>() + row * 128 +
                       ((((col >> 3) & 7) ^ r7) << 4);
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      hilo::split2(x[8 * k + 2 * e], x[8 * k + 2 * e + 1], h[e], l[e]);
    wgmma::stmatrix(H + o, h);
    wgmma::stmatrix(L + o, l);
  }
  wgmma::fence_smem();
}

// Load the fp32 n x n row-major block src, plus diag on its diagonal, as
// hi/lo slices into H and L, zero outside n x n; fenced for wgmma.
__device__ __forceinline__ void load_split(const float* __restrict__ src,
                                           int n, float diag, uint32_t H,
                                           uint32_t L) {
#pragma unroll 8
  for (int k = 0; k < NP * NP / 2 / THREADS; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    const int i = idx >> 6;
    const int j = (idx & 63) << 1;
    float v0 = 0.f, v1 = 0.f;
    if (i < n) {
      if (j < n) v0 = src[i * n + j] + (i == j ? diag : 0.f);
      if (j + 1 < n) v1 = src[i * n + j + 1] + (i == j + 1 ? diag : 0.f);
    }
    uint32_t h, l;
    hilo::split2(v0, v1, h, l);
    const uint32_t o = wgmma::swz<NP>(i, j);
    wgmma::st_shared(H + o, h);
    wgmma::st_shared(L + o, l);
  }
  wgmma::fence_smem();
}

// x = sum over the partials p of L[p] R[p]: this warpgroup's 64 rows of the
// left tiles, times all 128 columns of the right tiles (x of 64) or the
// half h of them (x of 32). The depth is stepped in a loop that is not
// unrolled: unrolled, the compiler hoists every k-step's descriptors out
// of the iteration loops, into registers the wgmma pipeline needs.
template <bool NEG = false, int N, int P>
__device__ __forceinline__ void product(float (&x)[N],
                                        const uint32_t (&L)[P],
                                        const uint32_t (&R)[P], int h = 0) {
  const int wg = threadIdx.x >> 7;
  wgmma::fence_operand(x);
  wgmma::fence();
#pragma unroll 1
  for (int ks = 0; ks < NP / 16; ++ks) {
#pragma unroll
    for (int p = 0; p < P; ++p)
      wgmma::mma<0, 1, NEG ? -1 : 1>(x, wgmma::desc_k(L[p], wg, ks),
                                     wgmma::desc_mn<NP>(R[p], ks, h),
                                     ks > 0 || p > 0);
  }
  wgmma::commit();
  wgmma::wait<0>();
  wgmma::fence_operand(x);
}

// x = L R0 + L R1 (L an exact bf16 slice: two partials); with NEG the
// negated product, from -L (exact: the same sums with the sign flipped).
template <bool NEG = false, int N>
__device__ __forceinline__ void prod2(float (&x)[N], uint32_t L, uint32_t R0,
                                      uint32_t R1, int h = 0) {
  const uint32_t l[2] = {L, L}, r[2] = {R0, R1};
  product<NEG>(x, l, r, h);
}

// x = LH RH + LH RL + LL RH (three partials of an fp32 product).
template <int N>
__device__ __forceinline__ void prod3(float (&x)[N], uint32_t LH, uint32_t LL,
                                      uint32_t RH, uint32_t RL, int h = 0) {
  const uint32_t l[3] = {LH, LH, LL}, r[3] = {RH, RL, RH};
  product(x, l, r, h);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ void inverse(const Tiles& s, int n, int ns_iters,
                                        int taylor_terms, int refine_steps,
                                        float* __restrict__ o) {
  const uint32_t AH = s.AH, AL = s.AL, XH = s.XH, XL = s.XL, WH = s.WH,
                 WL = s.WL;
  const int tid = threadIdx.x;

  // |A_H|_1 (max column sum: threads 0..127) and |A_H|_inf (max row sum:
  // threads 128..255), each over all 128 entries in order (the zero
  // padding adds nothing), then a shuffle max a warp and one over warps
  {
    float sum = 0.f;
    if (tid < NP) {
      for (int k = 0; k < NP; ++k)
        sum += fabsf(wgmma::ld_shared_bf16(AH + wgmma::swz<NP>(k, tid)));
    } else {
      const int r = tid - NP;
#pragma unroll 4
      for (int c = 0; c < NP; c += 8) {
        const uint4 u = wgmma::ld_shared_b128(AH + wgmma::swz<NP>(r, c));
        const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(&w[e]));
          sum += fabsf(f.x);
          sum += fabsf(f.y);
        }
      }
    }
    sum = warp_max(sum);
    if ((tid & 31) == 0) s.red[tid >> 5] = sum;
  }
  __syncthreads();
  const float bound = fmaxf(fmaxf(s.red[0], s.red[1]),
                            fmaxf(s.red[2], s.red[3])) *
                      fmaxf(fmaxf(s.red[4], s.red[5]),
                            fmaxf(s.red[6], s.red[7]));

  Acc x;
  {
    const int t = wgmma::opaque_tid();
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const uint32_t u = wgmma::ld_shared_b32(
          AH + wgmma::swz<NP>(wgmma::acc_row(j, t), wgmma::acc_col(j, t)));
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&u));
      x[j] = a.x / bound;
      x[j + 1] = a.y / bound;
    }
  }
  store_split(x, XH, XL);
  __syncthreads();                                  // X whole

  // Newton-Schulz on the hi slice: X <- X (2I - A_H X)
  for (int it = 0; it < ns_iters; ++it) {
    prod2<true>(x, AH, XH, XL);                     // -A_H X
    wgmma::for_each(x, [&](int r, int c, float& v) {
      if (r == c && r < n) v = 2.f + v;
    });
    store_split(x, WH, WL);
    __syncthreads();                                // W whole
    prod3(x, XH, XL, WH, WL);
    store_split(x, XH, XL);
    __syncthreads();                                // X whole
  }

  // Neumann series over the lo slice: M = X, T = X, T <- -X (A_L T)
  Acc m;
#pragma unroll
  for (int j = 0; j < 64; ++j) m[j] = x[j];
  // T = X into W; then per term, half by half: U = A_L T into W, then
  // T = -X U into W (a barrier before each half is overwritten: the
  // other warpgroup may still read it)
  if (taylor_terms > 1) {
    store_split(x, WH, WL);
    __syncthreads();                              // W whole (T)
  }
  for (int it = 0; it + 1 < taylor_terms; ++it) {
    const bool more = it + 2 < taylor_terms;
    Acc32 y;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      prod2(y, AL, WH, WL, h);
      __syncthreads();                            // W half h read
      store_split(y, WH, WL, 64 * h);
    }
    __syncthreads();                              // W whole (U)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      prod3(y, XH, XL, WH, WL, h);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        y[j] = -y[j];
        m[32 * h + j] += y[j];
      }
      if (more) {
        __syncthreads();                          // W half h read
        store_split(y, WH, WL, 64 * h);
      }
    }
    if (more) __syncthreads();                    // W whole (T)
  }

  // refinement against the full block: M <- M + M (I - Ad M); the X pair
  // now holds M's slices (split(Ad) = (A_H, A_L)). X was last read as a
  // right operand before a barrier that every warpgroup has passed.
  for (int it = 0; it < refine_steps; ++it) {
    store_split(m, XH, XL);
    __syncthreads();                                // X whole, W read
    Acc32 y;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      prod3(y, AH, AL, XH, XL, h);
      wgmma::for_each(y, [&](int r, int c, float& v) {
        v = (r == c && r < n ? 1.f : 0.f) - v;
      }, 64 * h);
      store_split(y, WH, WL, 64 * h);
    }
    __syncthreads();                              // W whole
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      prod3(y, XH, XL, WH, WL, h);
#pragma unroll
      for (int j = 0; j < 32; ++j) m[32 * h + j] += y[j];
    }
  }

  const bool pairs = (n & 1) == 0;
  const int t = wgmma::opaque_tid();
#pragma unroll
  for (int j = 0; j < 64; j += 2) {
    const int r = wgmma::acc_row(j, t);
    const int c = wgmma::acc_col(j, t);
    if (r >= n) continue;
    float* d = o + r * n + c;
    if (pairs && c + 1 < n) {
      *reinterpret_cast<float2*>(d) = make_float2(m[j], m[j + 1]);
    } else {
      if (c < n) d[0] = m[j];
      if (c + 1 < n) d[1] = m[j + 1];
    }
  }
}

}  // namespace composed
