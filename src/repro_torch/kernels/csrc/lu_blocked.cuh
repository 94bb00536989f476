// The k x k solve of the SMW update's large route for k of 129..1024 (the
// kernels take any k from 1): Z = (S + I/c)^-1 Y for every block of a
// chunk, S (k x k, rows lds apart) factored in place in the workspace, Y
// and Z (k x bs, rows ldy apart), as a blocked right-looking LU with
// partial pivoting over panels of PANEL columns, then a blocked back
// substitution. The launches, in the order kernels/smw_update.py's
// smw_schedule lists them, for each panel [j0, j1):
//   panel_kernel   one CTA a block holds the panel's rows j0..k-1 in
//                  registers (one or two rows a thread) and runs its
//                  PANEL pivot steps there: the first largest |x| at or
//                  below the diagonal (lu_solve's rule), the swap as a
//                  relabelling of two rows, the multipliers as a product
//                  with the pivot's reciprocal, the rank-1 update of the
//                  panel's other columns. One __syncthreads a step: each
//                  warp posts its best row (a double-buffered slot; the
//                  first largest found with redux.sync on |x|'s bits),
//                  every warp then reduces the slots itself. NaN is never
//                  a pivot, as in lu_solve. It writes L's panel and U11
//                  back in the order after the swaps, and the source of
//                  each row j0..k-1 (`rows`): no pivot step makes a pass
//                  over device memory.
//   update_kernel  one CTA a block and a slab of CW columns right of the
//                  panel (S's columns j1..k-1, then Z's, which the first
//                  panel reads from Y): the panel's row swaps as a gather
//                  (every row that moved took a row of the panel, so the
//                  panel's rows as they were and the rows they took are
//                  staged in shared memory before anything is written),
//                  U12 = L11^-1 A12 (warp 0, a lane a column, shared
//                  with the other warps through shared memory), then the
//                  trailing update A22 -= L21 U12: L21 staged in shared
//                  memory 64 rows at a time (the next rows' loads in
//                  flight meanwhile), a warp 8 of them, a lane a column.
//                  At most 64 registers a thread, four CTAs an SM: the
//                  CTAs wait on loads and barriers in turn, and more of
//                  them in flight hide it. A slab's columns belong to its
//                  CTA alone, so nothing waits on another CTA inside a
//                  launch.
// and after the last panel:
//   back_kernel    one CTA a block and a slab of CW columns of Z, held in
//                  shared memory (k x CW): for each panel from the last,
//                  the diagonal block (one warp, a lane a column), then
//                  the rows above it, U's rows staged in shared memory 64
//                  at a time as in the update kernel; Z stored in fp32
//                  and, where asked, as its bf16 hi and lo slices (the
//                  Woodbury correction's operand), split as it is stored.
// Per element the arithmetic is that of the unblocked elimination of
// lu_solve.cuh and of the kernel this replaces, in the same order: every
// update x = fma(-l, u, x) in fp32 on the CUDA cores (no tensor cores),
// accumulators starting from the matrix's own values, the forward updates
// of an entry in ascending pivot order (whichever kernel applies them),
// the back substitution's in descending order and then the division by
// U's diagonal. So Z is bitwise that of the unblocked solve, an exactly
// singular S meets an exact zero pivot (a non-finite out, the SMW gate's
// fallback signal), and a block's result does not depend on its chunk.
// The diagonal term 1/c is added as S_ii + 1/c when the first panel's
// kernels first read S_ii.
// Bound: operations, 2/3 k^3 + 2 k^2 bs fp32 a block (5.7 GFLOP at
// (2, 1024, 1024), 0.085 ms at 67 TFLOP/s). The trailing updates read and
// write A22 once a panel (not once a column), over ~(k + bs) / CW CTAs a
// block. What holds it back: at nb = 2 the k pivot steps, sequential, one
// CTA a block (two SMs), each step two redux.sync reductions, one barrier
// and a reciprocal; at the --smw path's 768-1152 blocks of k 256, the
// update and back kernels' short CTAs, which wait on loads and barriers
// more than they compute (fp32 FMAs from shared memory).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace lub {

constexpr int PANEL = 32;            // columns of a panel
constexpr int CW = 32;               // columns of an update or back slab
constexpr int MAX_K = 1024;
constexpr int PANEL_THREADS = 512;   // at most; two rows a thread above 512
constexpr int SLAB_THREADS = 256;    // 8 warps
constexpr int SLAB_WARPS = SLAB_THREADS / 32;
constexpr int ZLD = CW + 1;          // row stride of the back kernel's Z slab

// Factors the panel [j0, j0 + PANEL) of each block's rows j0..k-1. RPT:
// rows a thread (slot tid + i * blockDim.x holds row j0 + slot before the
// swaps). lr[i] is the slot's row after the swaps so far (relative to j0).
template <int RPT>
__global__ void __launch_bounds__(PANEL_THREADS)
panel_kernel(float* __restrict__ s, int lds, int* __restrict__ rows, int ldp,
             int k, int j0, float inv_c) {
  __shared__ __align__(16) float cand[2][32][PANEL];
  __shared__ unsigned ckey[2][32], crow[2][32];
  const int nr = k - j0;
  const int wn = nr < PANEL ? nr : PANEL;
  const size_t blk = blockIdx.x;
  float* S = s + blk * k * lds;
  int* src = rows + blk * ldp;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  float a[RPT][PANEL];
  int lr[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int slot = tid + i * blockDim.x;
    lr[i] = slot < nr ? slot : -1;
    const float* row = S + static_cast<size_t>(j0 + slot) * lds + j0;
#pragma unroll
    for (int q = 0; q < PANEL / 4; ++q) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (slot < nr && 4 * q < wn)
        v = *reinterpret_cast<const float4*>(row + 4 * q);
      a[i][4 * q] = v.x;
      a[i][4 * q + 1] = v.y;
      a[i][4 * q + 2] = v.z;
      a[i][4 * q + 3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < PANEL; ++u) {
      if (u >= wn) a[i][u] = 0.f;
      if (j0 == 0 && u == slot) a[i][u] = a[i][u] + inv_c;
    }
  }

#pragma unroll
  for (int t = 0; t < PANEL; ++t) {
    if (t < wn) {
      const int b = t & 1;
      // the thread's first largest, as a key: 0 for none (or NaN),
      // else |x|'s bits + 1, which order as |x| does
      unsigned key = 0u, p = t;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float v = fabsf(a[i][t]);
        const unsigned kv =
            lr[i] >= t && !isnan(v) ? __float_as_uint(v) + 1u : 0u;
        const unsigned row = static_cast<unsigned>(lr[i]);
        if (kv > key || (kv == key && kv && row < p)) {
          key = kv;
          p = lr[i];
        }
      }
      // the warp's: the largest key, then the first row holding it
      const unsigned wkey = __reduce_max_sync(0xffffffffu, key);
      const unsigned wrow =
          __reduce_min_sync(0xffffffffu, key == wkey ? p : 0xffffffffu);
      bool own[RPT];
      bool mine = false;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        own[i] = lr[i] == static_cast<int>(wrow);
        mine = mine || own[i];
      }
      const unsigned held = __ballot_sync(0xffffffffu, mine);
      if (lane == 0) {
        ckey[b][warp] = wkey;
        crow[b][warp] = 2u * wrow + (held ? 0u : 1u);
      }
#pragma unroll
      for (int i = 0; i < RPT; ++i)
        if (own[i]) {
          float4* dst = reinterpret_cast<float4*>(cand[b][warp]);
#pragma unroll
          for (int q = 0; q < PANEL / 4; ++q)
            dst[q] = make_float4(a[i][4 * q], a[i][4 * q + 1],
                                 a[i][4 * q + 2], a[i][4 * q + 3]);
        }
      __syncthreads();
      // every warp reduces the posted slots (lane w reads warp w's): the
      // largest key, the first row, a warp that holds it (crow's low bit)
      const unsigned kk = lane < nwarps ? ckey[b][lane] : 0u;
      const unsigned rr = lane < nwarps ? crow[b][lane] : 0xffffffffu;
      const unsigned bkey = __reduce_max_sync(0xffffffffu, kk);
      const unsigned brow =
          __reduce_min_sync(0xffffffffu, kk == bkey ? rr : 0xffffffffu);
      const int wp = static_cast<int>(brow >> 1);
      const float* prow =
          cand[b][__ffs(__ballot_sync(0xffffffffu, kk == bkey && rr == brow))
                  - 1];
      const float r = __frcp_rn(prow[t]);   // 1 / pivot, rounded once
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        lr[i] = lr[i] == wp ? t : (lr[i] == t ? wp : lr[i]);
        if (lr[i] > t) {
          const float l = a[i][t] * r;
          a[i][t] = l;
#pragma unroll
          for (int u = t + 1; u < PANEL; ++u)
            a[i][u] = __fmaf_rn(-l, prow[u], a[i][u]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (lr[i] < 0) continue;
    float* row = S + static_cast<size_t>(j0 + lr[i]) * lds + j0;
#pragma unroll
    for (int q = 0; q < PANEL / 4; ++q) {
      if (4 * q + 3 < wn) {
        *reinterpret_cast<float4*>(row + 4 * q) =
            make_float4(a[i][4 * q], a[i][4 * q + 1], a[i][4 * q + 2],
                        a[i][4 * q + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * q + e < wn) row[4 * q + e] = a[i][4 * q + e];
      }
    }
    src[j0 + lr[i]] = j0 + tid + i * static_cast<int>(blockDim.x);
  }
}

// Applies the panel [j0, j1) to the columns right of it: grid (slabs of S's
// columns j1..k-1, then of Z's 0..bs-1; blocks). The first panel reads Z's
// columns from Y and adds 1/c where it reads S_ii.
__global__ void __launch_bounds__(SLAB_THREADS, 4)
update_kernel(float* __restrict__ s, int lds, const float* __restrict__ y,
              float* __restrict__ z, int ldy, const int* __restrict__ rows,
              int ldp, int k, int bs, int j0, float inv_c) {
  constexpr int RC = 64;                 // rows of L21 staged at a time
  constexpr int RW = RC / SLAB_WARPS;    // of them a warp's
  __shared__ float l11[PANEL][PANEL + 1];
  __shared__ float po[PANEL][CW];    // the panel's rows before the swaps
  __shared__ float u12[PANEL][CW];   // its rows after them, then U12
  __shared__ __align__(16) float4 lsm[RC][PANEL / 4];
  const int j1 = j0 + PANEL < k ? j0 + PANEL : k;
  const int wn = j1 - j0;
  const int ns = (k - j1 + CW - 1) / CW;
  const bool on_s = static_cast<int>(blockIdx.x) < ns;
  const int c0 = on_s ? j1 + static_cast<int>(blockIdx.x) * CW
                      : (static_cast<int>(blockIdx.x) - ns) * CW;
  const int ncols = on_s ? k - c0 : bs - c0;
  const size_t blk = blockIdx.y;
  float* S = s + blk * k * lds;
  const int* src = rows + blk * ldp;
  const size_t ld = on_s ? lds : ldy;
  float* dst = on_s ? S + c0 : z + blk * k * ldy + c0;
  const float* from = on_s || j0 > 0 ? dst : y + blk * k * ldy + c0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool live = lane < ncols;
  const bool diag = on_s && j0 == 0;
  // row r of the slab as it was, 1/c added on the diagonal (first panel)
  auto as_was = [&](int r, float v) {
    return diag && r == c0 + lane ? v + inv_c : v;
  };
  auto load = [&](int r) {
    return as_was(r, live ? from[static_cast<size_t>(r) * ld + lane] : 0.f);
  };

  // A22 -= L21 U12 below: rows j1..k-1 (wn == PANEL whenever there are
  // any), RC at a time, L21's rows staged in shared memory (a float4 a
  // thread and pass), a warp RW of them, a lane a column; each chunk's
  // loads are in flight while the one before is updated, the first's
  // while the panel's rows are gathered and U12 solved.
  float4 lreg[RC * PANEL / 4 / SLAB_THREADS];
  float xr[RW];
  int sr[RW];
  auto fetch = [&](int r0) {
#pragma unroll
    for (int e = 0; e < RC * PANEL / 4 / SLAB_THREADS; ++e) {
      const int idx = tid + e * SLAB_THREADS;
      const int r = r0 + (idx >> 3);
      lreg[e] = r < k ? __ldg(reinterpret_cast<const float4*>(
                            S + static_cast<size_t>(r) * lds + j0) +
                        (idx & 7))
                      : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = r0 + warp * RW + i;
      sr[i] = r < k ? src[r] : r;
      xr[i] = r < k && live ? from[static_cast<size_t>(r) * ld + lane] : 0.f;
    }
  };
  if (j1 < k) fetch(j1);

  for (int idx = tid; idx < wn * wn; idx += SLAB_THREADS) {
    const int i = idx / wn, jj = idx % wn;
    l11[i][jj] = S[static_cast<size_t>(j0 + i) * lds + j0 + jj];
  }
  for (int t = warp; t < wn; t += SLAB_WARPS) {
    po[t][lane] = load(j0 + t);
    const int r = src[j0 + t];
    if (r >= j1) u12[t][lane] = load(r);
  }
  __syncthreads();
  for (int t = warp; t < wn; t += SLAB_WARPS) {
    const int r = src[j0 + t];
    if (r < j1) u12[t][lane] = po[r - j0][lane];
  }
  __syncthreads();

  // U12 = L11^-1 (the panel's rows after the swaps), by warp 0
  if (warp == 0) {
    float u[PANEL];
#pragma unroll
    for (int t = 0; t < PANEL; ++t) {
      if (t < wn) {
        float acc = u12[t][lane];
#pragma unroll
        for (int q = 0; q < t; ++q) acc = __fmaf_rn(-l11[t][q], u[q], acc);
        u[t] = acc;
        u12[t][lane] = acc;
        if (live) dst[static_cast<size_t>(j0 + t) * ld + lane] = acc;
      }
    }
  }

  __syncthreads();   // U12 in u12
  for (int r0 = j1; r0 < k; r0 += RC) {
    float acc[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = r0 + warp * RW + i;
      acc[i] = sr[i] == r ? as_was(r, xr[i]) : po[sr[i] - j0][lane];
    }
#pragma unroll
    for (int e = 0; e < RC * PANEL / 4 / SLAB_THREADS; ++e) {
      const int idx = tid + e * SLAB_THREADS;
      lsm[idx >> 3][idx & 7] = lreg[e];
    }
    if (r0 + RC < k) fetch(r0 + RC);
    __syncthreads();   // the chunk's L21 staged
#pragma unroll
    for (int q = 0; q < PANEL / 4; ++q) {
      const float u0 = u12[4 * q][lane], u1 = u12[4 * q + 1][lane];
      const float u2 = u12[4 * q + 2][lane], u3 = u12[4 * q + 3][lane];
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float4 l = lsm[warp * RW + i][q];
        acc[i] = __fmaf_rn(-l.x, u0, acc[i]);
        acc[i] = __fmaf_rn(-l.y, u1, acc[i]);
        acc[i] = __fmaf_rn(-l.z, u2, acc[i]);
        acc[i] = __fmaf_rn(-l.w, u3, acc[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      const int r = r0 + warp * RW + i;
      if (r < k && live) dst[static_cast<size_t>(r) * ld + lane] = acc[i];
    }
    __syncthreads();   // lsm read before the next chunk overwrites it
  }
}

// Z = U^-1 Z: grid (slabs of Z's columns, blocks); dynamic shared memory
// k * ZLD floats. zh, zl (rows ld16 apart; null: not stored): Z's hi and
// lo slices (round to nearest even, hi = bf16(z), lo = bf16(z - hi)).
__global__ void __launch_bounds__(SLAB_THREADS, 4)
back_kernel(const float* __restrict__ s, int lds, float* __restrict__ z,
            int ldy, int k, int bs, __nv_bfloat16* __restrict__ zh,
            __nv_bfloat16* __restrict__ zl, int ld16) {
  constexpr int RC = 64;                 // rows of U staged at a time
  constexpr int RW = RC / SLAB_WARPS;    // of them a warp's
  constexpr int LPT = RC * PANEL / 4 / SLAB_THREADS;   // float4 a thread
  extern __shared__ float zs[];
  __shared__ float u11[PANEL][PANEL + 1];
  __shared__ __align__(16) float4 usm[RC][PANEL / 4];
  const size_t blk = blockIdx.y;
  const float* S = s + blk * k * lds;
  const int c0 = static_cast<int>(blockIdx.x) * CW;
  float* Z = z + blk * k * ldy + c0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool live = lane < bs - c0;
  for (int r0 = warp; r0 < k; r0 += SLAB_WARPS * 4) {
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + e * SLAB_WARPS;
      v[e] = r < k && live ? Z[static_cast<size_t>(r) * ldy + lane] : 0.f;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + e * SLAB_WARPS;
      if (r < k) zs[r * ZLD + lane] = v[e];
    }
  }
  // each panel's U11 (at most 4 entries a thread), loaded a panel ahead
  constexpr int UPT = PANEL * PANEL / SLAB_THREADS;
  float u11r[UPT];
  auto fetch11 = [&](int jq) {
    const int wq = k - jq < PANEL ? k - jq : PANEL;
#pragma unroll
    for (int e = 0; e < UPT; ++e) {
      const int idx = tid + e * SLAB_THREADS;
      u11r[e] = idx < wq * wq ? S[static_cast<size_t>(jq + idx / wq) * lds +
                                  jq + idx % wq]
                              : 0.f;
    }
  };
  fetch11((k - 1) / PANEL * PANEL);
  for (int j0 = (k - 1) / PANEL * PANEL; j0 >= 0; j0 -= PANEL) {
    const int wn = k - j0 < PANEL ? k - j0 : PANEL;
    __syncthreads();   // zs loaded / the rows above the last panel done
#pragma unroll
    for (int e = 0; e < UPT; ++e) {
      const int idx = tid + e * SLAB_THREADS;
      if (idx < wn * wn) u11[idx / wn][idx % wn] = u11r[e];
    }
    if (j0 > 0) fetch11(j0 - PANEL);
    // U's rows above the panel (its columns), RC at a time, the next
    // rows' loads in flight while these are used
    float4 lreg[LPT];
    auto fetch = [&](int i0) {
#pragma unroll
      for (int e = 0; e < LPT; ++e) {
        const int idx = tid + e * SLAB_THREADS;
        const int i = i0 + (idx >> 3), q = idx & 7;
        lreg[e] = i < j0 && 4 * q < wn
                      ? __ldg(reinterpret_cast<const float4*>(
                                  S + static_cast<size_t>(i) * lds + j0) +
                              q)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    };
    if (j0 > 0) fetch(0);
    __syncthreads();
    // the diagonal block: warp 0, a lane a column (the others' loads of
    // U's rows above are in flight meanwhile)
    if (warp == 0) {
      float v[PANEL];
#pragma unroll
      for (int jj = 0; jj < PANEL; ++jj)
        v[jj] = jj < wn ? zs[(j0 + jj) * ZLD + lane] : 0.f;
#pragma unroll
      for (int jj = PANEL - 1; jj >= 0; --jj) {
        if (jj < wn) {
          v[jj] = __fdiv_rn(v[jj], u11[jj][jj]);
#pragma unroll
          for (int i = 0; i < jj; ++i)
            v[i] = __fmaf_rn(-u11[i][jj], v[jj], v[i]);
        }
      }
#pragma unroll
      for (int jj = 0; jj < PANEL; ++jj)
        if (jj < wn) zs[(j0 + jj) * ZLD + lane] = v[jj];
    }
    __syncthreads();
    if (j0 == 0) break;
    // the rows above: a warp RW of each RC, a lane a column
    for (int i0 = 0; i0 < j0; i0 += RC) {
#pragma unroll
      for (int e = 0; e < LPT; ++e) {
        const int idx = tid + e * SLAB_THREADS;
        usm[idx >> 3][idx & 7] = lreg[e];
      }
      if (i0 + RC < j0) fetch(i0 + RC);
      __syncthreads();   // the rows staged
      float acc[RW];
#pragma unroll
      for (int e = 0; e < RW; ++e) {
        const int i = i0 + warp * RW + e;
        acc[e] = i < j0 ? zs[i * ZLD + lane] : 0.f;
      }
#pragma unroll
      for (int q = PANEL / 4 - 1; q >= 0; --q) {
        float x[4];
#pragma unroll
        for (int f = 0; f < 4; ++f)
          x[f] = 4 * q + f < wn ? zs[(j0 + 4 * q + f) * ZLD + lane] : 0.f;
#pragma unroll
        for (int e = 0; e < RW; ++e) {
          const float4 w = usm[warp * RW + e][q];
          if (4 * q + 3 < wn) acc[e] = __fmaf_rn(-w.w, x[3], acc[e]);
          if (4 * q + 2 < wn) acc[e] = __fmaf_rn(-w.z, x[2], acc[e]);
          if (4 * q + 1 < wn) acc[e] = __fmaf_rn(-w.y, x[1], acc[e]);
          if (4 * q < wn) acc[e] = __fmaf_rn(-w.x, x[0], acc[e]);
        }
      }
#pragma unroll
      for (int e = 0; e < RW; ++e) {
        const int i = i0 + warp * RW + e;
        if (i < j0) zs[i * ZLD + lane] = acc[e];
      }
      __syncthreads();   // usm read before the next rows overwrite it
    }
  }
  __syncthreads();
  if (live)
    for (int r = warp; r < k; r += SLAB_WARPS) {
      const float v = zs[r * ZLD + lane];
      Z[static_cast<size_t>(r) * ldy + lane] = v;
      if (zh) {
        const size_t o = (blk * k + r) * ld16 + c0 + lane;
        const __nv_bfloat16 h = __float2bfloat16_rn(v);
        zh[o] = h;
        zl[o] = __float2bfloat16_rn(v - __bfloat162float(h));
      }
    }
}

}  // namespace lub
