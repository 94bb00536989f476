// Batched hi/lo product on TMA and wgmma, with operands stored split: the
// products of neumann_inv.cu's large route (blocks of 129..1024).
//
// One launch computes, for every batch entry b and every 128 x BN tile of
// the n x n result,
//   acc = sum over the partials of L[b] R[b]        (n x n times n x n)
// and writes epilogue(acc) into C[b] (and F[b]). Every operand is kept in
// device memory as its bf16 hi and lo slices (round to nearest even, as
// hilo::split2: hi = bf16(x), lo = bf16(x - hi)), row-major, rows ld16
// apart (a multiple of 8 elements, as TMA needs), block b at b n ld16. The
// writer of an operand, the prep kernel or a product's epilogue, splits it
// once as it stores it: nothing is split as it is loaded, and splitting on
// store is bitwise what splitting the stored fp32 on load gives. The
// partials, with fp32 accumulation in wgmma's registers:
//   two slices of L  L_H R_H + L_H R_L + L_L R_H
//   one slice of L   L_S R_H + L_S R_L   (L_S an exact bf16 slice: the hi
//                                          or lo slice of A + lam I)
// summed k step by k step (16 deep) in a fixed order: no split K, no
// atomics, so a launch is bitwise its repeat and each block's result does
// not depend on the other blocks of the batch.
//
// Epilogues (E fp32, read at rows ld32 apart; C and F each written in the
// forms the caller asks for: fp32 at ld32, hi and lo at ld16, any subset):
//   STORE        C = acc
//   TWO_I_MINUS  C = 2I - acc             (Newton-Schulz's W = 2I - A_H X)
//   I_MINUS      C = I - acc              (the refinement's residual)
//   ADD          C = E + acc              (M + M R)
//   NEG_ACC      C = -acc, F = E + C      (a Neumann term T and M += T)
//
// Design. One CTA an SM walks the tiles of the batch (tile t, t + grid,
// ...; a block's tiles adjacent, so its panels are shared in the L2).
// Warp 8 is the producer: one thread issues, for each k stage of 32, the
// TMA copies of the stage's left block (128 x 32, each slice, 64-byte
// swizzle) and right block (32 x BN, each slice, in 64-column panels,
// 128-byte swizzle) from three-dimensional tensor maps over (block, row,
// column), which land them in wgmma's canonical layouts and fill every
// entry outside the n x n block with zero (so sides such as 129 or 176 are
// exact with no padding in memory). A ring of as many stages as shared
// memory holds (4 of 48 KB at BN 256, 5 of 40 KB at 192), handed over with
// mbarriers (full: the copies' bytes; empty: one arrival a consumer warp),
// keeps all but one stage's copies in flight, across tiles too, so a
// tile's epilogue runs under the next tile's first copies: the products
// stream their operands from device memory, and a shallow ring leaves
// them waiting on its latency. Warps 0-7 are two consumer warpgroups of 64
// rows each: per k16 step they issue one m64nBNk16 wgmma a partial from
// shared-memory descriptors, one commit group a stage, the previous
// stage's group retired before its slot is handed back. BN is 192 or 256
// (whichever pads the side less: 176 -> 192, 256 -> 256, 1024 -> 4 x
// 256), fixed by n alone, so that a block's arithmetic is the same in any
// batch and any chunk. The epilogue holds the tile's last ring slot (the
// producer fills the others with the next tile's stages meanwhile): each
// warpgroup stages its accumulators there a 64-column panel at a time,
// then applies the elementwise step four entries a thread at a time, so
// that E is read and every form stored in whole rows of a warp: stored
// straight from the accumulators' layout, a warp store covers 16 bytes of
// each of 8 rows, and those stores, not the products, set the pace.
#pragma once

#include <cuda.h>

#include <mutex>

#include "hilo_mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace tbmm {

using wgmma::bf16;

constexpr int BM = 128, BK = 32;
constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 32;     // and the producer warp
constexpr int A_BYTES = BM * BK * 2;        // one slice of a left block
constexpr int MAX_N = 1024;
constexpr int SMEM_LIMIT = 232448;          // a CTA's shared memory

enum Epi { STORE = 0, TWO_I_MINUS = 1, I_MINUS = 2, ADD = 3, NEG_ACC = 4 };

// An output (or the prep kernel's): each pointer null where that form is
// not written.
struct Out {
  float* f32;
  bf16* hi;
  bf16* lo;
};

struct Params {
  const bf16* l_hi;  // the left operand's slice (its hi slice, or the one
  const bf16* l_lo;  // exact slice with l_lo null: two partials)
  const bf16* r_hi;
  const bf16* r_lo;
  const float* e;    // ADD, NEG_ACC: the M block read
  Out c, f;          // f: NEG_ACC's M block written
  int n, ld32, ld16, batch, epi;
};

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
template <int BN>
struct Cfg {
  static constexpr int B_BYTES = BK * BN * 2;  // one slice of a right block
  static constexpr int STAGE_BYTES = 2 * A_BYTES + 2 * B_BYTES;
  static constexpr int STAGES = (SMEM_LIMIT - 1024 - 128) / STAGE_BYTES;
  static_assert(STAGE_BYTES >= STAGING_BYTES, "the epilogue stages in a slot");
  static constexpr int SMEM = 1024 + STAGES * STAGE_BYTES + 2 * STAGES * 8;
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

// Barrier of warpgroup wg's 128 threads alone (ids 1 and 2).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// Barrier of the two consumer warpgroups (id 3).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
}

// One output's forms of four entries at fp32 index i32 and bf16 index i16
// (a column that is a multiple of 4: 16- and 8-byte aligned).
__device__ __forceinline__ void put4(const Out& o, size_t i32, size_t i16,
                                     float4 v) {
  if (o.f32) *reinterpret_cast<float4*>(o.f32 + i32) = v;
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
// load could be moved past a store). A group whose last columns pass n
// lands in the rows' padding (ld32 and ld16 round n up to 4 and 8), which
// nothing reads.
__device__ __forceinline__ void finish_panel(const Params& p, uint32_t st,
                                             int b, int r0, int c0) {
  constexpr int U = 4;
  const int t = threadIdx.x & 127;
  const size_t blk = static_cast<size_t>(b) * p.n;
  const bool reads_e = p.epi == ADD || p.epi == NEG_ACC;
#pragma unroll
  for (int k0 = 0; k0 < 64 * 16; k0 += 128 * U) {
    float4 e[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + 128 * u + t;
      const int r = r0 + (k >> 4), c = c0 + (k & 15) * 4;
      e[u] = reads_e && r < p.n && c < p.n
                 ? *reinterpret_cast<const float4*>(
                       p.e + (blk + r) * p.ld32 + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k = k0 + 128 * u + t;
      const int lr = k >> 4, lc = (k & 15) * 4;
      const int r = r0 + lr, c = c0 + lc;
      if (r >= p.n || c >= p.n) continue;
      const uint4 a = wgmma::ld_shared_b128(st + 4 * (lr * EP + lc));
      float4 v = make_float4(__uint_as_float(a.x), __uint_as_float(a.y),
                             __uint_as_float(a.z), __uint_as_float(a.w));
      const size_t i32 = (blk + r) * p.ld32 + c;
      const size_t i16 = (blk + r) * p.ld16 + c;
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
        put4(p.f, i32, i16,
             make_float4(e[u].x + v.x, e[u].y + v.y, e[u].z + v.z,
                         e[u].w + v.w));
      }
      put4(p.c, i32, i16, v);
    }
  }
}

// The tile's epilogue: each warpgroup stages its 64 rows panel by panel
// in st (the tile's last ring slot, held until this ends) and finishes
// them, once both warpgroups' products have stopped reading the slot.
template <int BN, int NA>
__device__ __forceinline__ void epilogue(float (&d)[NA], const Params& p,
                                         uint32_t slot, int wg, int b,
                                         int m0, int n0) {
  const uint32_t st = slot + wg * (STAGING_BYTES / 2);
  consumers_sync();
#pragma unroll
  for (int q = 0; q < BN / 64; ++q) {
    if (n0 + 64 * q >= p.n) break;
    if (q == 0) stage_panel<0>(d, st);
    if (q == 1) stage_panel<1>(d, st);
    if (q == 2) stage_panel<2>(d, st);
    if (q == 3) stage_panel<3>(d, st);
    wg_sync(wg);
    finish_panel(p, st, b, m0 + 64 * wg, n0 + 64 * q);
    wg_sync(wg);
  }
}

// TWO: the left operand has two slices (three partials), else one (two).
template <int BN, bool TWO>
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
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      tma::mbar_init(full + 8 * s, 1);
      tma::mbar_init(empty + 8 * s, CONSUMERS / 32);
    }
    tma::mbar_fence_init();
  }
  __syncthreads();
  const int ct = (p.n + BN - 1) / BN;
  const int per = (p.n + BM - 1) / BM * ct;
  const int tiles = p.batch * per, nk = (p.n + BK - 1) / BK;

  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x != CONSUMERS) return;
    // the producer: every stage of every tile of this CTA, in order
    constexpr uint32_t BYTES = (TWO ? 2 : 1) * A_BYTES + 2 * C::B_BYTES;
    int g = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b = tile / per, rc = tile % per;
      const int m0 = rc / ct * BM, n0 = rc % ct * BN;
      for (int kt = 0; kt < nk; ++kt, ++g) {
        const uint32_t st = base + g % STAGES * C::STAGE_BYTES;
        const uint32_t bar = full + 8 * (g % STAGES);
        const int k0 = kt * BK;
        tma::wait_free(empty, g, STAGES);
        tma::mbar_arrive_tx(bar, BYTES);
        tma::load_3d(st, &map_lh, k0, m0, b, bar);
        if (TWO) tma::load_3d(st + A_BYTES, &map_ll, k0, m0, b, bar);
#pragma unroll
        for (int q = 0; q < BN / 64; ++q) {
          const uint32_t panel = st + 2 * A_BYTES + q * (BK * 128);
          tma::load_3d(panel, &map_rh, n0 + 64 * q, k0, b, bar);
          tma::load_3d(panel + C::B_BYTES, &map_rl, n0 + 64 * q, k0, b, bar);
        }
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
        const uint64_t dl = desc_k64(lh, wg, ks);
        const uint64_t dr = wgmma::desc_mn<BK>(rh, ks);
        wgmma::mma<0, 1>(acc, dl, dr, 1);
        wgmma::mma<0, 1>(acc, dl, wgmma::desc_mn<BK>(rl, ks), 1);
        if (TWO) wgmma::mma<0, 1>(acc, desc_k64(lh + A_BYTES, wg, ks), dr, 1);
      }
      wgmma::commit();
      wgmma::wait<1>();  // the previous stage's products are done
      wgmma::fence_operand(acc);
      if (kt > 0 && lane0) tma::mbar_arrive(empty + 8 * ((g - 1) % STAGES));
    }
    wgmma::wait<0>();
    wgmma::fence_operand(acc);
    const int b = tile / per, rc = tile % per;
    epilogue<BN>(acc, p, base + (g - 1) % STAGES * C::STAGE_BYTES, wg, b,
                 rc / ct * BM, rc % ct * BN);
    // the staging's generic accesses before the slot goes back to the TMA
    wgmma::fence_smem();
    __syncwarp();
    if (lane0) tma::mbar_arrive(empty + 8 * ((g - 1) % STAGES));
  }
}

// Tensor map of slices of `batch` n x n blocks, rows ld16 apart: boxes of
// box_cols columns (32: the 64-byte swizzle; 64: the 128-byte one) x
// box_rows rows of one block, zero outside.
inline bool encode(CUtensorMap* map, const bf16* p, int n, int ld16,
                   int batch, int box_cols, int box_rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[2] = {
      static_cast<cuuint64_t>(ld16) * 2,
      static_cast<cuuint64_t>(n) * static_cast<cuuint64_t>(ld16) * 2};
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
// arguments alone, so each is encoded once (the host's time a launch
// bounds a call at a few blocks a side).
inline bool encode_cached(CUtensorMap* map, const bf16* p, int n, int ld16,
                          int batch, int box_cols, int box_rows) {
  struct Entry {
    CUtensorMap map;
    const bf16* p;
    int n, ld16, batch, box_cols, box_rows;
  };
  constexpr int SIZE = 64;
  static std::mutex mu;
  static Entry cache[SIZE];
  static int used = 0, next = 0;
  const std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.p == p && e.n == n && e.ld16 == ld16 && e.batch == batch &&
        e.box_cols == box_cols && e.box_rows == box_rows) {
      *map = e.map;
      return true;
    }
  }
  if (!encode(map, p, n, ld16, batch, box_cols, box_rows)) return false;
  cache[next] = Entry{*map, p, n, ld16, batch, box_cols, box_rows};
  next = (next + 1) % SIZE;
  if (used < SIZE) ++used;
  return true;
}

// The device's SM count, the kernel's shared-memory limit set on the first
// launch there (both fixed for the process).
template <int BN, bool TWO>
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
    err = cudaFuncSetAttribute(product_kernel<BN, TWO>,
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

template <int BN, bool TWO>
int launch_tiles(const Params& p, cudaStream_t stream) {
  CUtensorMap lh{}, ll{}, rh{}, rl{};
  if (!encode_cached(&lh, p.l_hi, p.n, p.ld16, p.batch, BK, BM) ||
      (TWO && !encode_cached(&ll, p.l_lo, p.n, p.ld16, p.batch, BK, BM)) ||
      !encode_cached(&rh, p.r_hi, p.n, p.ld16, p.batch, 64, BK) ||
      !encode_cached(&rl, p.r_lo, p.n, p.ld16, p.batch, 64, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = prepare<BN, TWO>(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = static_cast<long long>(p.batch) *
                          ((p.n + BM - 1) / BM) * ((p.n + BN - 1) / BN);
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  product_kernel<BN, TWO><<<grid, THREADS, Cfg<BN>::SMEM, stream>>>(
      p, lh, ll, rh, rl);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

inline bool out_ok(const Out& o) {
  return aligned(o.f32, 8) && aligned(o.hi, 16) && aligned(o.lo, 16);
}

inline bool valid(const Params& p) {
  const bool reads_e = p.epi == ADD || p.epi == NEG_ACC;
  return p.n >= 1 && p.n <= MAX_N && p.ld16 >= p.n && p.ld16 % 8 == 0 &&
         p.ld32 >= p.n && p.ld32 % 2 == 0 && p.batch >= 1 &&
         p.batch <= 65535 && p.epi >= STORE && p.epi <= NEG_ACC && p.l_hi &&
         p.r_hi && p.r_lo && aligned(p.l_hi, 16) && aligned(p.l_lo, 16) &&
         aligned(p.r_hi, 16) && aligned(p.r_lo, 16) &&
         (!reads_e || (p.e && aligned(p.e, 8))) && out_ok(p.c) &&
         out_ok(p.f);
}

// Enqueue one product on `stream`; returns the cudaError_t of the launch
// (cudaErrorInvalidValue for arguments it does not take or a tensor map
// the driver refuses, cudaErrorSymbolNotFound without the encoder).
inline int launch(const Params& p, cudaStream_t stream) {
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  if (tma::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  const bool two = p.l_lo != nullptr;
  if (tile_n(p.n) == 192)
    return two ? launch_tiles<192, true>(p, stream)
               : launch_tiles<192, false>(p, stream);
  return two ? launch_tiles<256, true>(p, stream)
             : launch_tiles<256, false>(p, stream);
}

}  // namespace
}  // namespace tbmm
