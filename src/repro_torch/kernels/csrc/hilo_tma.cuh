// Batched hi/lo product on TMA and wgmma, with operands stored split: the
// products of every large route (blocks, tiles and ranks of 129..1024):
// neumann_inv.cu's, fused_precond.cu's, smw_update.cu's and
// fused_gram_solve.cu's Gram.
//
// One launch computes, for every batch entry b and every 128 x BN tile of
// the m x n result,
//   acc = sum over the partials of L[b] R[b]        (m x k times k x n)
// and writes epilogue(acc) into C[b] (and F[b]). Every operand is kept in
// device memory as its bf16 hi and lo slices (round to nearest even, as
// hilo::split2: hi = bf16(x), lo = bf16(x - hi)), row-major, rows l_ld16
// (left) or r_ld16 (right) apart (multiples of 8 elements, as TMA needs).
// Each is stored m x k (left) and k x n (right), or transposed with l_t
// (the left stored k x m: Y^T Z reads Y, the Gram a^T a reads a) and r_t
// (the right stored n x k: Y V^T reads V); the TMA lands either in the
// shared-memory layout wgmma reads for it (a stored-transposed left is an
// MN-major A, a stored-transposed right a K-major B), so nothing is
// transposed in memory. Block b of an operand is block idx[b] of its
// array when the operand has an index array (a pool of blocks that many
// batch entries share: the WU's inverse blocks), else block b; an array
// holds l_blocks or r_blocks blocks. The square form (m = k = n, one
// stride ld16, no index, arrays of batch blocks) is what zero in the
// rectangular fields gives. The writer of an operand, a split kernel
// (split_launch), a prep kernel or a product's epilogue, splits it once as
// it stores it: nothing is split as it is loaded, and splitting on store
// is bitwise what splitting the stored fp32 on load gives. The partials,
// with fp32 accumulation in wgmma's registers:
//   two slices of L  L_H R_H + L_H R_L + L_L R_H
//   one slice of L   L_S R_H + L_S R_L   (L_S an exact bf16 slice: the hi
//                                          or lo slice of A + lam I)
//   one of each      L_H R_H             (both exact bf16: bf16
//                                          activations, whose lo slices
//                                          are zero, so the two partials
//                                          left out add exact zeros)
// summed k step by k step (16 deep) in a fixed order: no split K, no
// atomics, so a launch is bitwise its repeat and each block's result does
// not depend on the other blocks of the batch or on its index. The depth k
// may exceed the sides' 1024 (the Gram's is its token count).
//
// Epilogues (E fp32 m x n, read at rows ld32 apart; C and F each written
// in the forms the caller asks for: fp32 at ld32, hi and lo at ld16, any
// subset, none too):
//   STORE        C = acc
//   TWO_I_MINUS  C = 2I - acc             (Newton-Schulz's W = 2I - A_H X)
//   I_MINUS      C = I - acc              (the refinement's residual)
//   ADD          C = E + acc              (M + M R)
//   NEG_ACC      C = -acc, F = E + C      (a Neumann term T and M += T;
//                                          with C written in no form, the
//                                          Woodbury correction F = M - acc
//                                          in one rounding)
//   DOT          C = acc, and sum(acc E) over each warpgroup's 64 rows of
//                the tile into part[2 tile + wg], in a fixed order (the
//                WU's trust-region dot; a second kernel sums a block's
//                partials in order: no atomics)
// The fp32 rows of C, F and E need no padding: where ld32 or a base is not
// a multiple of 16 bytes, they are read and written an entry at a time,
// masked at column n (the WU's out and g are unpadded (N, bi, bo) tensors).
//
// Design. One CTA an SM walks the tiles of the batch (tile t, t + grid,
// ...; a block's tiles adjacent, so its panels are shared in the L2, and
// so are the pool blocks of neighbouring entries). Warp 8 is the producer:
// one thread reads the tile's block indices and issues, for each k stage
// of 32, the TMA copies of the stage's left block (128 x 32, each slice,
// 64-byte swizzle; stored k x m: two 64-column panels of 32 rows, 128-byte
// swizzle) and right block (32 x BN, each slice, in 64-column panels,
// 128-byte swizzle; stored n x k: BN rows of 32, 64-byte swizzle) from
// three-dimensional tensor maps over (block, row, column), which land them
// in wgmma's canonical layouts and fill every entry outside the stored
// block with zero (so sides such as 129 or 176 are exact with no padding
// in memory). A ring of as
// many stages as shared memory holds (4 of 48 KB at BN 256, 5 of 40 KB at
// 192), handed over with mbarriers (full: the copies' bytes; empty: one
// arrival a consumer warp), keeps all but one stage's copies in flight,
// across tiles too, so a tile's epilogue runs under the next tile's first
// copies: the products stream their operands from device memory, and a
// shallow ring leaves them waiting on its latency. Warps 0-7 are two
// consumer warpgroups of 64 rows each: per k16 step they issue one
// m64nBNk16 wgmma a partial from shared-memory descriptors, one commit
// group a stage, the previous stage's group retired before its slot is
// handed back (a warpgroup whose 64 rows lie past m multiplies zeros: the
// tile is 128 rows, and m = 130 or 176 pads to 256). BN is 192 or 256
// (whichever pads n less: 176 -> 192, 256 -> 256, 1024 -> 4 x 256), fixed
// by n alone, so that a block's arithmetic is the same in any batch and
// any chunk. The epilogue holds the tile's last ring slot (the
// producer fills the others with the next tile's stages meanwhile): each
// warpgroup stages its accumulators there a 64-column panel at a time,
// then applies the elementwise step four entries a thread at a time, so
// that E is read and every form stored in whole rows of a warp: stored
// straight from the accumulators' layout, a warp store covers 16 bytes of
// each of 8 rows, and those stores, not the products, set the pace.
//
// A library instantiates the kernel only for the operand forms and
// partial counts it launches (launch<FORMS>): each is a kernel of its own
// for both tile widths and both epilogue accesses, and nvcc takes seconds
// for each.
#pragma once

#include <cuda.h>

#include <mutex>

#include "hilo_mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace htma {

using wgmma::bf16;

constexpr int BM = 128, BK = 32;
constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 32;     // and the producer warp
constexpr int A_BYTES = BM * BK * 2;        // one slice of a left block
constexpr int MAX_N = 1024;                 // m and n
constexpr int MAX_K = 1 << 24;              // the depth (a Gram's tokens)
constexpr int MAX_BATCH = 1 << 24;          // entries, blocks of an array
constexpr int SMEM_LIMIT = 232448;          // a CTA's shared memory

enum Epi {
  STORE = 0, TWO_I_MINUS = 1, I_MINUS = 2, ADD = 3, NEG_ACC = 4, DOT = 5
};

// An output (or the prep kernel's): each pointer null where that form is
// not written.
struct Out {
  float* f32;
  bf16* hi;
  bf16* lo;
};

struct Params {
  const bf16* l_hi;  // the left operand's slice (its hi slice, or the one
  const bf16* l_lo;  // exact slice with l_lo null: two partials; with
  const bf16* r_hi;  // r_lo null too, one)
  const bf16* r_lo;
  const float* e;    // ADD, NEG_ACC: the M block read; DOT: the E block
  Out c, f;          // f: NEG_ACC's M block written
  int n, ld32, ld16, batch, epi;
  // The rectangular form; each field 0 takes the square form's value
  // (resolved()): m (n), k (n), l_ld16 and r_ld16 (ld16), l_blocks and
  // r_blocks (batch).
  int m, k;                  // L is m x k, R is k x n, C, E and F m x n
  int l_ld16, r_ld16;        // the operands' slice row strides
  int l_blocks, r_blocks;    // blocks in each operand's arrays
  const int* l_idx;          // block of batch entry b: l_idx[b] (null: b)
  const int* r_idx;
  float* part;               // DOT: 2 partial dots a tile
  int l_t, r_t;              // 1: the left stored k x m, the right n x k
};

// The forms a library launches, a bit each (launch<FORMS>): the left and
// right operands' storage and the partial count (3: two slices of L; 2:
// one; 1: L_H R_H alone).
constexpr int form_bit(bool lt, bool rt, int parts) {
  return 1 << (3 * (lt + 2 * rt) + parts - 1);
}
// the square and rectangular form with two or three partials
// (neumann_inv.cu, fused_precond.cu)
constexpr int PLAIN = form_bit(false, false, 2) | form_bit(false, false, 3);

// The tile's width: 192 or 256 columns, whichever covers n with less pad.
__host__ __device__ constexpr int tile_n(int n) {
  return (n + 191) / 192 * 192 < (n + 255) / 256 * 256 ? 192 : 256;
}

// Everything below has internal linkage: each library that includes this
// header gets its own kernels and its own host state (a static in an
// inline function would be one object for every library in the process,
// and one library's kernel would then never get its shared-memory limit).
namespace {

// The epilogue's staging of a warpgroup's 64 x 64 panel of accumulators:
// rows of 64 floats EP apart (8 more: a warp's pair stores fall on two
// wavefronts, the least for 256 bytes).
constexpr int EP = 72;
constexpr int STAGING_BYTES = 2 * 64 * EP * 4;  // both warpgroups' panels

// A stage: the left block's slices (BM x BK, 64-byte swizzle: 64-byte
// rows), then the right block's (BK x BN, 128-byte swizzle, in 64-column
// panels of BK rows); as many stages as shared memory holds.
// After the ring: its barriers, then the DOT epilogue's 8 warp sums.
template <int BN>
struct Cfg {
  static constexpr int B_BYTES = BK * BN * 2;  // one slice of a right block
  static constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES = (SMEM_LIMIT - 1024 - 128) / STAGE_BYTES;
  static_assert(STAGE_BYTES >= STAGING_BYTES, "the epilogue stages in a slot");
  static constexpr int SMEM =
      1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8 + CONSUMERS / 32 * 4;
  static_assert(SMEM <= SMEM_LIMIT, "the ring and its barriers fit");
};

// Descriptor of the left operand, K-major with the 64-byte swizzle: rows
// 64 wg .. +64 of the BM x BK block at L (64-byte rows, 8-row groups 512
// bytes apart), columns 16 ks .. +16 (32 bytes a k16 step inside a row;
// the hardware swizzles the summed address).
__device__ __forceinline__ uint64_t desc_k64(uint32_t L, int wg, int ks) {
  const uint32_t a = L + wg * 64 * 64 + ks * 32;
  const uint32_t lo = ((a >> 4) & 0x3FFFu) | (1u << 16);
  const uint32_t hi = (512u >> 4) | (2u << 30);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// The square form's values for the rectangular fields left at 0.
inline Params resolved(Params p) {
  if (p.m == 0) p.m = p.n;
  if (p.k == 0) p.k = p.n;
  if (p.l_ld16 == 0) p.l_ld16 = p.ld16;
  if (p.r_ld16 == 0) p.r_ld16 = p.ld16;
  if (p.l_blocks == 0) p.l_blocks = p.batch;
  if (p.r_blocks == 0) p.r_blocks = p.batch;
  return p;
}

// Barrier of warpgroup wg's 128 threads alone (ids 1 and 2).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Barrier of the two consumer warpgroups (id 3).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// Four fp32 entries from p: one 16-byte load with VEC (ld32 and the bases
// multiples of 16 bytes: a group past column n reads the row's padding),
// else the `valid` entries left of column n one at a time, zero after.
template <bool VEC>
__device__ __forceinline__ float4 ld4(const float* p, int valid) {
  if constexpr (VEC) return *reinterpret_cast<const float4*>(p);
  return make_float4(p[0], valid > 1 ? p[1] : 0.f, valid > 2 ? p[2] : 0.f,
                     valid > 3 ? p[3] : 0.f);
}

// One output's forms of four entries at fp32 index i32 and bf16 index i16
// (a column that is a multiple of 4): fp32 as ld4 reads it (a group past
// column n writes the row's padding only with VEC); the slices in 8-byte
// stores, since ld16 is a multiple of 8 and at least n, so that a group
// past n always lands in the row's padding, which nothing reads.
template <bool VEC>
__device__ __forceinline__ void put4(const Out& o, size_t i32, size_t i16,
                                     float4 v, int valid) {
  if (o.f32) {
    if constexpr (VEC) {
      *reinterpret_cast<float4*>(o.f32 + i32) = v;
    } else {
      o.f32[i32] = v.x;
      if (valid > 1) o.f32[i32 + 1] = v.y;
      if (valid > 2) o.f32[i32 + 2] = v.z;
      if (valid > 3) o.f32[i32 + 3] = v.w;
    }
  }
  if (o.hi || o.lo) {
    uint32_t h0, l0, h1, l1;
    hilo::split2(v.x, v.y, h0, l0);
    hilo::split2(v.z, v.w, h1, l1);
    if (o.hi) *reinterpret_cast<uint2*>(o.hi + i16) = make_uint2(h0, h1);
    if (o.lo) *reinterpret_cast<uint2*>(o.lo + i16) = make_uint2(l0, l1);
  }
}

// This thread's accumulators of 64-column panel P into its warpgroup's
// staging st (rows of the warpgroup's 64, columns of the panel).
template <int P, int NA>
__device__ __forceinline__ void stage_panel(float (&d)[NA], uint32_t st) {
  if constexpr (32 * (P + 1) <= NA) {
    const int t = wgmma::opaque_tid();
#pragma unroll
    for (int j = 32 * P; j < 32 * (P + 1); j += 2) {
      const int r = wgmma::acc_row(j, t) - 64 * (t >> 7);
      const int c = wgmma::acc_col(j, t) - 64 * P;
      wgmma::st_shared(st + 4 * (r * EP + c),
                       make_uint2(__float_as_uint(d[j]),
                                  __float_as_uint(d[j + 1])));
    }
  }
}

// The epilogue of a staged panel: rows r0 .. r0 + 63, columns c0 .. c0 +
// 63 of block b, four entries a thread at a time, so that every read of E
// and every store is a warp's whole rows (16 bytes a thread in fp32, 8 a
// slice); a thread's groups are taken U at a time, their E read first so
// that U loads are in flight together (E is F's buffer in NEG_ACC: no
// load could be moved past a store). Nothing at a row past m or a column
// past n is read or written, except as ld4 and put4 say. Returns this
// thread's part of DOT's sum(acc E), its entries added in a fixed order.
template <bool VEC>
__device__ __forceinline__ float finish_panel(const Params& p, uint32_t st,
                                              int b, int r0, int c0) {
  constexpr int U = 4;
  const int t = threadIdx.x & 127;
  const size_t blk = static_cast<size_t>(b) * p.m;
  const bool reads_e = p.epi == ADD || p.epi == NEG_ACC || p.epi == DOT;
  float dot = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < 64 * 16; k0 += 128 * U) {
    float4 e[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + 128 * u + t;
      const int r = r0 + (k >> 4), c = c0 + (k & 15) * 4;
      e[u] = reads_e && r < p.m && c < p.n
                 ? ld4<VEC>(p.e + (blk + r) * p.ld32 + c, p.n - c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + 128 * u + t;
      const int lr = k >> 4, lc = (k & 15) * 4;
      const int r = r0 + lr, c = c0 + lc;
      if (r >= p.m || c >= p.n) continue;
      const uint4 a = wgmma::ld_shared_b128(st + 4 * (lr * EP + lc));
      float4 v = make_float4(__uint_as_float(a.x), __uint_as_float(a.y),
                             __uint_as_float(a.z), __uint_as_float(a.w));
      const size_t i32 = (blk + r) * p.ld32 + c;
      const size_t i16 = (blk + r) * p.ld16 + c;
      const int valid = p.n - c;
      if (p.epi == TWO_I_MINUS || p.epi == I_MINUS) {
        const float s = p.epi == TWO_I_MINUS ? 2.f : 1.f;
        v.x = (r == c ? s : 0.f) - v.x;
        v.y = (r == c + 1 ? s : 0.f) - v.y;
        v.z = (r == c + 2 ? s : 0.f) - v.z;
        v.w = (r == c + 3 ? s : 0.f) - v.w;
      } else if (p.epi == ADD) {
        v = make_float4(e[u].x + v.x, e[u].y + v.y, e[u].z + v.z,
                        e[u].w + v.w);
      } else if (p.epi == NEG_ACC) {
        v = make_float4(-v.x, -v.y, -v.z, -v.w);
        put4<VEC>(p.f, i32, i16,
                  make_float4(e[u].x + v.x, e[u].y + v.y, e[u].z + v.z,
                              e[u].w + v.w),
                  valid);
      } else if (p.epi == DOT) {
        dot += v.x * e[u].x;
        if (valid > 1) dot += v.y * e[u].y;
        if (valid > 2) dot += v.z * e[u].z;
        if (valid > 3) dot += v.w * e[u].w;
      }
      put4<VEC>(p.c, i32, i16, v, valid);
    }
  }
  return dot;
}

// The tile's epilogue: each warpgroup stages its 64 rows panel by panel
// in st (the tile's last ring slot, held until this ends) and finishes
// them, once both warpgroups' products have stopped reading the slot; a
// warpgroup whose rows lie past m has nothing to finish. DOT: the
// warpgroup's sum, its threads' parts added by a butterfly (lane 0's
// order), its warps' in order, into part[2 tile + wg] (red: the 8 warps'
// sums in shared memory).
template <int BN, bool VEC, int NA>
__device__ __forceinline__ void epilogue(float (&d)[NA], const Params& p,
                                         uint32_t slot, uint32_t red, int wg,
                                         int b, int m0, int n0, int tile) {
  const uint32_t st = slot + wg * (STAGING_BYTES / 2);
  float dot = 0.f;
  consumers_sync();
  if (m0 + 64 * wg < p.m) {
#pragma unroll
    for (int q = 0; q < BN / 64; ++q) {
      if (n0 + 64 * q >= p.n) break;
      if (q == 0) stage_panel<0>(d, st);
      if (q == 1) stage_panel<1>(d, st);
      if (q == 2) stage_panel<2>(d, st);
      if (q == 3) stage_panel<3>(d, st);
      wg_sync(wg);
      dot += finish_panel<VEC>(p, st, b, m0 + 64 * wg, n0 + 64 * q);
      wg_sync(wg);
    }
  }
  if (p.epi == DOT) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, o);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0)
      wgmma::st_shared(red + 4 * warp, __float_as_uint(dot));
    wg_sync(wg);
    if ((threadIdx.x & 127) == 0) {
      float s = 0.f;
      for (int w = 4 * wg; w < 4 * wg + 4; ++w)
        s += __uint_as_float(wgmma::ld_shared_b32(red + 4 * w));
      p.part[2 * static_cast<size_t>(tile) + wg] = s;
    }
  }
}

// The stage's copies of one operand block (its hi or lo slice) at shared
// address dst, reported to bar: a left block of rows m0.. and depth k0..
// (LT: stored k x m, two 64-column panels of BK rows, 128-byte swizzle;
// else one box of BM rows of BK, 64-byte swizzle), a right block of
// columns n0.. (RT: stored n x k, one box of BN rows of BK, 64-byte
// swizzle; else BN / 64 panels of BK rows, 128-byte swizzle).
template <bool LT>
__device__ __forceinline__ void load_left(uint32_t dst, const CUtensorMap* map,
                                          int m0, int k0, int blk,
                                          uint32_t bar) {
  if constexpr (LT) {
    tma::load_3d(dst, map, m0, k0, blk, bar);
    tma::load_3d(dst + BK * 128, map, m0 + 64, k0, blk, bar);
  } else {
    tma::load_3d(dst, map, k0, m0, blk, bar);
  }
}

template <int BN, bool RT>
__device__ __forceinline__ void load_right(uint32_t dst,
                                           const CUtensorMap* map, int n0,
                                           int k0, int blk, uint32_t bar) {
  if constexpr (RT) {
    tma::load_3d(dst, map, k0, n0, blk, bar);
  } else {
#pragma unroll
    for (int q = 0; q < BN / 64; ++q)
      tma::load_3d(dst + q * (BK * 128), map, n0 + 64 * q, k0, blk, bar);
  }
}

// Descriptors of k16 step ks of a stage's left block (warpgroup wg's 64
// rows; LT: MN-major, wgmma's transposed A) and right block (RT: K-major).
template <bool LT>
__device__ __forceinline__ uint64_t desc_left(uint32_t a, int wg, int ks) {
  if constexpr (LT) return wgmma::desc_mn_t<BK>(a, wg, ks);
  return desc_k64(a, wg, ks);
}

template <bool RT>
__device__ __forceinline__ uint64_t desc_right(uint32_t b, int ks) {
  if constexpr (RT) return desc_k64(b, 0, ks);
  return wgmma::desc_mn<BK>(b, ks);
}

// PARTS: 3 (the left operand's two slices), 2 (its one slice) or 1 (L_H
// R_H). LT, RT: the operands stored transposed (l_t, r_t). VEC: C's, F's
// and E's fp32 rows take 16-byte accesses (a template flag: tested at run
// time in the epilogue's loops, it slowed neumann_inv's products by 3-4%
// on the H100). p is resolved().
template <int BN, int PARTS, bool LT, bool RT, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
product_kernel(const __grid_constant__ Params p,
               const __grid_constant__ CUtensorMap map_lh,
               const __grid_constant__ CUtensorMap map_ll,
               const __grid_constant__ CUtensorMap map_rh,
               const __grid_constant__ CUtensorMap map_rl) {
  using C = Cfg<BN>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t raw = wgmma::smem_addr(smem);
  // stage s: left hi, left lo, right hi, right lo (1024-byte aligned)
  const uint32_t base = raw + ((1024u - (raw & 1023u)) & 1023u);
  constexpr int STAGES = C::STAGES;
  const uint32_t full = base + STAGES * C::STAGE_BYTES;
  const uint32_t empty = full + 8 * STAGES;
  const uint32_t red = empty + 8 * STAGES;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tma::mbar_init(full + 8 * s, 1);
      tma::mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    tma::mbar_fence_init();
  }
  __syncthreads();
  const int ct = (p.n + BN - 1) / BN;
  const int per = (p.m + BM - 1) / BM * ct;
  const int tiles = p.batch * per, nk = (p.k + BK - 1) / BK;

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x != CONSUMERS) return;
    // the producer: every stage of every tile of this CTA, in order
    constexpr uint32_t BYTES =
        (PARTS == 3 ? 2 : 1) * A_BYTES + (PARTS == 1 ? 1 : 2) * C::B_BYTES;
    int g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b = tile / per, rc = tile % per;
      const int m0 = rc / ct * BM, n0 = rc % ct * BN;
      // the blocks of the operands' arrays (a pool's block by its index;
      // one out of range is read as zeros by the TMA)
      const int lb = p.l_idx ? p.l_idx[b] : b;
      const int rb = p.r_idx ? p.r_idx[b] : b;
      for (int kt = 0; kt < nk; ++kt, ++g) {
        const uint32_t st = base + g % STAGES * C::STAGE_BYTES;
        const uint32_t bar = full + 8 * (g % STAGES);
        const int k0 = kt * BK;
        tma::wait_free(empty, g, STAGES);
        tma::mbar_arrive_tx(bar, BYTES);
        load_left<LT>(st, &map_lh, m0, k0, lb, bar);
        if (PARTS == 3) load_left<LT>(st + A_BYTES, &map_ll, m0, k0, lb, bar);
        load_right<BN, RT>(st + 2 * A_BYTES, &map_rh, n0, k0, rb, bar);
        if (PARTS > 1)
          load_right<BN, RT>(st + 2 * A_BYTES + C::B_BYTES, &map_rl, n0, k0,
                             rb, bar);
      }
    }
    // stay until the consumers have released every slot
    for (int i = 0; i < STAGES; ++i, ++g) tma::wait_free(empty, g, STAGES);
    return;
  }

  const int wg = threadIdx.x >> 7;
  const bool lane0 = (threadIdx.x & 31) == 0;
  float acc[BN / 2];  // this warpgroup's 64 rows of the tile
  int g = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int b = tile / per, rc = tile % per;
    const int m0 = rc / ct * BM, n0 = rc % ct * BN;
    // (a warpgroup whose rows lie past m multiplies zeros: a branch around
    // the wgmma, not known to be uniform, makes ptxas serialise them)
#pragma unroll
    for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++g) {
      const uint32_t lh = base + g % STAGES * C::STAGE_BYTES;
      const uint32_t rh = lh + 2 * A_BYTES, rl = rh + C::B_BYTES;
      tma::wait_filled(full, g, STAGES);
      wgmma::fence_operand(acc);
      wgmma::fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        const uint64_t dl = desc_left<LT>(lh, wg, ks);
        const uint64_t dr = desc_right<RT>(rh, ks);
        wgmma::mma<LT, !RT>(acc, dl, dr, 1);
        if (PARTS > 1) wgmma::mma<LT, !RT>(acc, dl, desc_right<RT>(rl, ks), 1);
        if (PARTS == 3)
          wgmma::mma<LT, !RT>(acc, desc_left<LT>(lh + A_BYTES, wg, ks), dr,
                              1);
      }
      wgmma::commit();
      wgmma::wait<1>();  // the previous stage's products are done
      wgmma::fence_operand(acc);
      if (kt > 0 && lane0) tma::mbar_arrive(empty + 8 * ((g - 1) % STAGES));
    }
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    epilogue<BN, VEC>(acc, p, base + (g - 1) % STAGES * C::STAGE_BYTES, red,
                      wg, b, m0, n0, tile);
    // the staging's generic accesses before the slot goes back to the TMA
    wgmma::fence_smem();
    __syncwarp();
    if (lane0) tma::mbar_arrive(empty + 8 * ((g - 1) % STAGES));
  }
}

// Tensor map of slices of `blocks` rows x cols blocks, rows ld16 apart:
// boxes of box_cols columns (32: the 64-byte swizzle; 64: the 128-byte
// one) x box_rows rows of one block, zero outside.
inline bool encode(CUtensorMap* map, const bf16* p, int rows, int cols,
                   int ld16, int blocks, int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(blocks)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(ld16) * 2,
      static_cast<cuuint64_t>(rows) * static_cast<cuuint64_t>(ld16) * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return tma::encode_tiled()(
             map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<bf16*>(p),
             dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
             box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                            : CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// encode() through a small cache: a chunk's 50 products use the same few
// maps (each buffer's slices, two box shapes), and a map depends on these
// arguments alone, every one of them in the key (an address the allocator
// hands out again with another shape gets a map of its own), so each is
// encoded once (the host's time a launch bounds a call at a few blocks a
// side).
inline bool encode_cached(CUtensorMap* map, const bf16* p, int rows,
                          int cols, int ld16, int blocks, int box_cols,
                          int box_rows) {
  struct Entry {
    CUtensorMap map;
    const bf16* p;
    int rows, cols, ld16, blocks, box_cols, box_rows;
  };
  constexpr int SIZE = 64;
  static std::mutex mu;
  static Entry cache[SIZE];
  static int used = 0, next = 0;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.p == p && e.rows == rows && e.cols == cols && e.ld16 == ld16 &&
        e.blocks == blocks && e.box_cols == box_cols &&
        e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  }
  if (!encode(map, p, rows, cols, ld16, blocks, box_cols, box_rows))
    return false;
  cache[next] = Entry{*map, p, rows, cols, ld16, blocks, box_cols, box_rows};
  next = (next + 1) % SIZE;
  if (used < SIZE) ++used;
  return true;
}

// The device's SM count, the kernel's shared-memory limit set on the first
// launch there (both fixed for the process).
template <int BN, int PARTS, bool LT, bool RT, bool VEC>
cudaError_t prepare(int* sms) {
  constexpr int DEVICES = 64;
  static std::mutex mu;
  static int count[DEVICES] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= DEVICES) return cudaErrorInvalidDevice;
  const std::lock_guard<std::mutex> lock(mu);
  if (count[dev] == 0) {
    err = cudaFuncSetAttribute(product_kernel<BN, PARTS, LT, RT, VEC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg<BN>::SMEM);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      count[dev] = 0;
      return err;
    }
  }
  *sms = count[dev];
  return cudaSuccess;
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// p resolved() and valid(). The maps' boxes: a left block of BM rows of
// BK (64-byte swizzle) or, stored k x m, 64-column panels of BK rows
// (128-byte swizzle); a right block in 64-column panels of BK rows or,
// stored n x k, BN rows of BK.
template <int BN, int PARTS, bool LT, bool RT, bool VEC>
int launch_tiles(const Params& p, cudaStream_t stream) {
  CUtensorMap lh{}, ll{}, rh{}, rl{};
  const int lr = LT ? p.k : p.m, lc = LT ? p.m : p.k;
  const int rr = RT ? p.n : p.k, rc = RT ? p.k : p.n;
  const int lbc = LT ? 64 : BK, lbr = LT ? BK : BM;
  const int rbc = RT ? BK : 64, rbr = RT ? BN : BK;
  if (!encode_cached(&lh, p.l_hi, lr, lc, p.l_ld16, p.l_blocks, lbc, lbr) ||
      (PARTS == 3 &&
       !encode_cached(&ll, p.l_lo, lr, lc, p.l_ld16, p.l_blocks, lbc, lbr)) ||
      !encode_cached(&rh, p.r_hi, rr, rc, p.r_ld16, p.r_blocks, rbc, rbr) ||
      (PARTS > 1 &&
       !encode_cached(&rl, p.r_lo, rr, rc, p.r_ld16, p.r_blocks, rbc, rbr)))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = prepare<BN, PARTS, LT, RT, VEC>(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(p.batch) *
                          ((p.m + BM - 1) / BM) * ((p.n + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  product_kernel<BN, PARTS, LT, RT, VEC>
      <<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(p, lh, ll, rh, rl);
  return static_cast<int>(cudaGetLastError());
}

// The kernel of one form, if the library's FORMS instantiate it.
template <int FORMS, bool LT, bool RT, int PARTS>
int launch_form(const Params& p, cudaStream_t stream) {
  if constexpr ((FORMS & form_bit(LT, RT, PARTS)) == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    const bool vec = p.ld32 % 4 == 0 && aligned(p.c.f32, 16) &&
                     aligned(p.f.f32, 16) && aligned(p.e, 16);
    if (tile_n(p.n) == 192)
      return vec ? launch_tiles<192, PARTS, LT, RT, true>(p, stream)
                 : launch_tiles<192, PARTS, LT, RT, false>(p, stream);
    return vec ? launch_tiles<256, PARTS, LT, RT, true>(p, stream)
               : launch_tiles<256, PARTS, LT, RT, false>(p, stream);
  }
}

template <int FORMS, bool LT, bool RT>
int launch_parts(const Params& p, cudaStream_t stream) {
  if (p.l_lo) return launch_form<FORMS, LT, RT, 3>(p, stream);
  if (p.r_lo) return launch_form<FORMS, LT, RT, 2>(p, stream);
  return launch_form<FORMS, LT, RT, 1>(p, stream);
}

inline bool out_ok(const Out& o) {
  return aligned(o.f32, 4) && aligned(o.hi, 16) && aligned(o.lo, 16);
}

inline bool side_ok(int v) { return v >= 1 && v <= MAX_N; }

inline bool count_ok(int v) { return v >= 1 && v <= MAX_BATCH; }

// p resolved(): m and n in 1..MAX_N, k in 1..MAX_K, the stage count of the
// whole launch in an int, every slice stride a multiple of 8 and at least
// its stored rows' width (k, or m for a left operand stored k x m; n, or k
// for a right one stored n x k), an array without an index holding a block
// for every batch entry, a left lo slice only beside a right one, slices
// on 16 bytes (TMA's and the 8-byte stores' alignment), fp32 and indices
// on 4, E where the epilogue reads it and the partials where DOT writes
// them.
inline bool valid(const Params& p) {
  const bool reads_e = p.epi == ADD || p.epi == NEG_ACC || p.epi == DOT;
  const bool forms = (p.l_t == 0 || p.l_t == 1) && (p.r_t == 0 || p.r_t == 1);
  const int l_width = p.l_t ? p.m : p.k, r_width = p.r_t ? p.k : p.n;
  const bool sides = side_ok(p.n) && side_ok(p.m) && p.k >= 1 &&
                     p.k <= MAX_K && count_ok(p.batch);
  return forms && sides &&
         static_cast<long long>(p.batch) * ((p.m + BM - 1) / BM) *
                 ((p.n + 191) / 192) * ((p.k + BK - 1) / BK) <
             (1LL << 31) &&
         p.ld16 >= p.n && p.ld16 % 8 == 0 && p.l_ld16 >= l_width &&
         p.l_ld16 % 8 == 0 && p.r_ld16 >= r_width && p.r_ld16 % 8 == 0 &&
         p.ld32 >= p.n && count_ok(p.l_blocks) && count_ok(p.r_blocks) &&
         (p.l_idx || p.l_blocks >= p.batch) &&
         (p.r_idx || p.r_blocks >= p.batch) && p.epi >= STORE &&
         p.epi <= DOT && p.l_hi && p.r_hi && (p.r_lo || !p.l_lo) &&
         aligned(p.l_hi, 16) && aligned(p.l_lo, 16) && aligned(p.r_hi, 16) &&
         aligned(p.r_lo, 16) && aligned(p.l_idx, 4) && aligned(p.r_idx, 4) &&
         (!reads_e || (p.e && aligned(p.e, 4))) &&
         (p.epi != DOT || (p.part && aligned(p.part, 4))) && out_ok(p.c) &&
         out_ok(p.f);
}

// Enqueue one product on `stream`, its kernel among those FORMS
// instantiates (form_bit); returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments it does not take, a form the
// library does not instantiate or a tensor map the CUDA driver refuses,
// cudaErrorSymbolNotFound without the encoder).
template <int FORMS = PLAIN>
inline int launch(const Params& given, cudaStream_t stream) {
  const Params p = resolved(given);
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (tma::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  if (p.l_t)
    return p.r_t ? launch_parts<FORMS, true, true>(p, stream)
                 : launch_parts<FORMS, true, false>(p, stream);
  return p.r_t ? launch_parts<FORMS, false, true>(p, stream)
               : launch_parts<FORMS, false, false>(p, stream);
}

constexpr int SPLIT_THREADS = 256;

// Group i of blocks of rows x cols entries (fp32, or bf16: exact hi
// slices, whose lo is zero and not stored) at src, block b's row r at src
// + b bstride + r ld, into their slices at hi and lo (lo null for bf16),
// block after block, rows ld16 apart: 8 columns of a row (16-byte loads
// where vec, else one entry at a time; one 16-byte store a slice), the
// columns past cols written as zeros. The split kernel's body, and a prep
// kernel's where it splits an input beside its own work.
template <typename T>
__device__ __forceinline__ void split_group(const T* __restrict__ src,
                                            long long bstride, long long ld,
                                            int rows, long long i, int cols,
                                            int ld16, bf16* __restrict__ hi,
                                            bf16* __restrict__ lo, bool vec) {
  const int per_row = ld16 / 8;
  const long long row = i / per_row;
  const int c = static_cast<int>(i - row * per_row) * 8;
  // block after block (bstride = rows ld: the row's offset alone), else
  // the block's row (rows of all blocks < 2^32, 32-bit division)
  const unsigned blk =
      bstride == rows * ld ? 0u : static_cast<unsigned>(row) / rows;
  const T* s = src + blk * bstride + (row - blk * rows) * ld + c;
  const size_t o = static_cast<size_t>(row) * ld16 + c;
  if constexpr (sizeof(T) == 2) {
    uint4 h;
    if (vec && c + 8 <= cols) {
      h = *reinterpret_cast<const uint4*>(s);
    } else {
      uint32_t e[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        e[j] = c + j < cols ? __bfloat16_as_ushort(s[j]) : 0u;
      h = make_uint4(e[0] | e[1] << 16, e[2] | e[3] << 16, e[4] | e[5] << 16,
                     e[6] | e[7] << 16);
    }
    *reinterpret_cast<uint4*>(hi + o) = h;
  } else {
    float v[8];
    if (vec && c + 8 <= cols) {
      const float4 a = reinterpret_cast<const float4*>(s)[0];
      const float4 b = reinterpret_cast<const float4*>(s)[1];
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = c + j < cols ? s[j] : 0.f;
    }
    uint32_t h[4], l[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      hilo::split2(v[2 * j], v[2 * j + 1], h[j], l[j]);
    *reinterpret_cast<uint4*>(hi + o) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + o) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// Whether split_group may take 16-byte loads: cols, the strides and src
// on 16 bytes' worth of entries.
template <typename T>
inline bool split_vec(const T* src, int cols, long long bstride,
                      long long ld) {
  constexpr int E16 = 16 / sizeof(T);
  return cols % E16 == 0 && ld % E16 == 0 && bstride % E16 == 0 &&
         aligned(src, 16);
}

template <typename T>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_kernel(const T* __restrict__ src, long long bstride, long long ld,
             int rows, long long groups, int cols, int ld16,
             bf16* __restrict__ hi, bf16* __restrict__ lo, bool vec) {
  for (long long i = blockIdx.x * static_cast<long long>(SPLIT_THREADS) +
                     threadIdx.x;
       i < groups; i += static_cast<long long>(gridDim.x) * SPLIT_THREADS)
    split_group(src, bstride, ld, rows, i, cols, ld16, hi, lo, vec);
}

// Enqueue the split of `blocks` rows x cols blocks at src (block b's row r
// at src + b bstride + r ld elements; fp32, or bf16 with lo null) into
// slices at hi and lo (rows ld16 apart) on `stream`; returns the
// cudaError_t.
template <typename T>
inline int split_launch(const T* src, long long blocks, int rows, int cols,
                        long long bstride, long long ld, int ld16, bf16* hi,
                        bf16* lo, cudaStream_t stream) {
  if (!src || !hi || (sizeof(T) == 4) != (lo != nullptr) || blocks < 1 ||
      rows < 1 || blocks * rows >= (1LL << 32) || !side_ok(cols) ||
      ld < cols || bstride < 0 ||
      ld16 < cols || ld16 % 8 != 0 || !aligned(src, sizeof(T)) ||
      !aligned(hi, 16) || !aligned(lo, 16))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long groups = blocks * rows * (ld16 / 8);
  const long long want = (groups + SPLIT_THREADS - 1) / SPLIT_THREADS;
  const int grid = static_cast<int>(want < 4096 ? want : 4096);
  split_kernel<T><<<grid, SPLIT_THREADS, 0, stream>>>(
      src, bstride, ld, rows, groups, cols, ld16, hi, lo,
      split_vec(src, cols, bstride, ld));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace htma
