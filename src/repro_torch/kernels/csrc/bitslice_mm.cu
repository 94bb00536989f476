// Bit-sliced (hi/lo bf16) matrix product with fp32 accumulation, on wgmma:
// c = a @ b for a (M, K) and b (K, N), fp32, fp16 or bf16 in, fp32 out.
//
// Replaces the Pallas TPU kernel repro/kernels/bitslice_mm.py (_kernel,
// called from bitslice_mm). Every operand is upcast to fp32 and split
// x = x_hi + x_lo (bf16, round to nearest even) inside the kernel, and
//   c = a_hi b_hi + a_hi b_lo + a_lo b_hi
// on the tensor cores (a_lo b_lo is below the fp32 floor and dropped, as
// on the TPU). bf16 input has a zero lo slice, so only a_hi b_hi is formed.
// Any M, N, K >= 1: the edges are masked in the kernel (zero fill in shared
// memory, stores guarded), not padded on the host. One launch a call.
//
// Bound: operations. 3 partials x 2MNK bf16 FLOP against 4(MK + KN + MN)
// bytes; at the MLP product of the main path, (2048, 1024) @ (1024, 2816),
// 35.4 GFLOP (0.036 ms at 989 TFLOP/s) against 43 MB (0.013 ms). What holds
// this kernel back is not the tensor cores but the work around them: every
// CTA re-reads its operand panels as fp32 from the L2 (a hi/lo pair is as
// many bytes, so splitting ahead of the product saves none) and splits
// them, and the copy, the split and the products all pass through the SM's
// shared memory (~216 KB a 128 x 192 x 32 stage in fp32: the copy in, the
// split's read and write, wgmma's reads). The design keeps the tensor cores
// off that path and the shared-memory traffic low:
//   - Tiles of 128 x 192 (2048 x 2816: 16 x 15 = 240 tiles, two rounds on
//     132 SMs, 310 MB of L2 reads against 369 MB for 128 x 128). One
//     persistent CTA an SM walks its tiles, so the next tile's copies and
//     splits run under this tile's last products and its stores.
//   - Two consumer warpgroups (64 rows each) issue one wgmma m64n192k16 a
//     partial and k-step from 128-byte-swizzled hi/lo slices (wgmma.cuh)
//     into 96 fp32 accumulators a thread, one commit group a K stage of 32,
//     one in flight while the next is issued.
//   - Two splitter warpgroups split. A thread of the first warp copies each
//     stage's a and b blocks with TMA (tiled tensor maps, zero fill outside
//     the matrices) into a staging ring three stages deep; every splitter
//     reads its 16-byte pieces back, splits them and stores the slices into
//     a slot of the slice ring (two slots for fp32, four for 16-bit input),
//     with the fp32 pieces of a dealt so that a warp's stores fall on
//     distinct banks. Rows that are not 16-byte aligned (K or N not a
//     multiple of 16 bytes' worth, or a base off 16 bytes) are read element
//     by element by the splitters instead, a stage ahead in registers.
//   - Slots are handed over with mbarriers (full / empty between splitters
//     and consumers, staged / freed between the copies and the splitters;
//     one arrival a warp), never a CTA-wide barrier; setmaxnreg moves
//     registers to the consumers.
// On the H100 the split, not the products, sets the pace of a stage
// (PERF.md, section 6, with kernel_times.py --ablate).
#include <cuda.h>
#include <cuda_fp16.h>

#include <climits>
#include <type_traits>

#include "hilo_mma.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

using tma::mbar_arrive;
using tma::mbar_arrive_tx;
using tma::mbar_init;
using tma::wait_filled;
using tma::wait_free;
using wgmma::bf16;

constexpr int BM = 128, BN = 192, BK = 32;  // output tile; K a stage
constexpr int CONSUMERS = 256;               // warpgroups 0-1: products
constexpr int SPLITTERS = 256;               // warpgroups 2-3: splits, copies
constexpr int THREADS = CONSUMERS + SPLITTERS;
// A slices: buffers of 128 rows x 64 columns (one 128-byte swizzle row,
// SPB stages); B slices: BK rows x 192 columns (three 64-column panels)
constexpr int SPB = 64 / BK;
constexpr int A_BUF = wgmma::half_bytes<BM>();       // 16 KB
constexpr int B_SLOT = 3 * wgmma::half_bytes<BK>();  // 12 KB

template <class T>
struct Cfg {
  static constexpr bool LO = !std::is_same<T, bf16>::value;  // lo slices
  static constexpr int E = 16 / sizeof(T);  // elements a 16-byte piece
  static constexpr int PA = BM * BK / E;    // pieces of a a stage
  static constexpr int PIECES = PA + BK * BN / E;
  static constexpr int NA = PA / SPLITTERS;      // a's pieces a splitter
  static constexpr int NP = PIECES / SPLITTERS;  // all its pieces
  static constexpr int S = sizeof(T) == 4 ? 2 : 4;  // slice slots
  static constexpr int D = 3;                       // staging slots
  static constexpr int NAB = S / SPB;               // A buffers
  static constexpr int SLICE_BYTES =
      (LO ? 2 : 1) * (NAB * A_BUF + S * B_SLOT);
  static constexpr int STAGE_BYTES = PIECES * 16;
  static constexpr int SMEM =
      1024 + SLICE_BYTES + D * STAGE_BYTES + 2 * (S + D) * 8;
};

// Chosen on the host. TMA: both operands' rows start on 16 bytes, so the
// tensor memory accelerator stages their blocks (else the splitters read
// them element by element); VEC_C: c is stored in column pairs.
enum { TMA = 1, VEC_C = 2 };

// Shared addresses: slices (1024-byte aligned), staging ring, and the
// barriers: full / empty hand slice slots from splitters to consumers and
// back, staged / freed staging slots from the TMA copies to the splitters
// and back.
struct Layout {
  uint32_t ah, al, bh, bl, stage, full, empty, staged, freed;
};

template <class T>
__device__ __forceinline__ Layout carve(unsigned char* smem) {
  using C = Cfg<T>;
  const uint32_t a = wgmma::smem_addr(smem);
  Layout l;
  l.ah = a + ((1024u - (a & 1023u)) & 1023u);
  l.al = l.ah + C::NAB * A_BUF;
  l.bh = l.ah + (C::LO ? 2 : 1) * C::NAB * A_BUF;
  l.bl = l.bh + C::S * B_SLOT;
  l.stage = l.ah + C::SLICE_BYTES;
  l.full = l.stage + C::D * C::STAGE_BYTES;
  l.empty = l.full + C::S * 8;
  l.staged = l.empty + C::S * 8;
  l.freed = l.staged + C::D * 8;
  return l;
}

// Element by element (rows not 16-byte aligned): E elements of row `row`
// (row stride ld), columns col .. col + E - 1, as a 16-byte piece, zero
// where row >= rows or a column >= cols.
template <class T>
__device__ __forceinline__ uint4 load_piece(const T* base, int row, int rows,
                                            int col, int cols, int ld) {
  constexpr int E = Cfg<T>::E;
  typedef typename std::conditional<sizeof(T) == 4, uint32_t,
                                    unsigned short>::type U;
  const U* src = reinterpret_cast<const U*>(base) +
                 static_cast<size_t>(row) * ld + col;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const uint32_t v = row < rows && col + e < cols ? src[e] : 0u;
    w[e * sizeof(T) / 4] |= v << (8 * ((e * sizeof(T)) & 3));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

struct Walk {
  int M, N, K, mt, nk, tiles, flags;
};

// The corner (m0, n0, k0) of stage idx of the CTA's walk: tile
// blockIdx.x + (idx / nk) gridDim.x, K stage idx % nk.
struct Corner {
  int m0, n0, k0;
};

template <class T>
__device__ __forceinline__ Corner corner(const Walk& w, int idx) {
  const int tile = blockIdx.x + (idx / w.nk) * gridDim.x;
  return {(tile % w.mt) * BM, (tile / w.mt) * BN, (idx % w.nk) * BK};
}

// Split a staged piece v into the hi (and lo) slices at H and L.
__device__ __forceinline__ void split_piece(uint4 v, const float*, uint32_t H,
                                            uint32_t L) {
  uint32_t h0, l0, h1, l1;
  hilo::split2(__uint_as_float(v.x), __uint_as_float(v.y), h0, l0);
  hilo::split2(__uint_as_float(v.z), __uint_as_float(v.w), h1, l1);
  wgmma::st_shared(H, make_uint2(h0, h1));
  wgmma::st_shared(L, make_uint2(l0, l1));
}

__device__ __forceinline__ void split_piece(uint4 v, const __half*,
                                            uint32_t H, uint32_t L) {
  const uint32_t in[4] = {v.x, v.y, v.z, v.w};
  uint32_t h[4], l[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f =
        __half22float2(*reinterpret_cast<const __half2*>(&in[j]));
    hilo::split2(f.x, f.y, h[j], l[j]);
  }
  wgmma::st_shared(H, make_uint4(h[0], h[1], h[2], h[3]));
  wgmma::st_shared(L, make_uint4(l[0], l[1], l[2], l[3]));
}

__device__ __forceinline__ void split_piece(uint4 v, const bf16*, uint32_t H,
                                            uint32_t) {
  wgmma::st_shared(H, v);
}

// Staging piece of splitter thread t's piece i: t + i SPLITTERS, except
// that fp32 a-pieces (8 to a row, 8-byte slices) are dealt to a warp as rows
// r, r + 4, r + 1, r + 5 (then r + 2, r + 6, r + 3, r + 7), whose swizzled
// slice rows fall on disjoint banks: rows r .. r + 3 would share 16 of them.
template <class T>
__device__ __forceinline__ int piece_index(int i, int t) {
  const int p = t + i * SPLITTERS;
  if (Cfg<T>::E != 4 || i >= Cfg<T>::NA) return p;
  const int g = p >> 5, j = (p >> 3) & 3;
  const int row = 8 * (g >> 1) + 2 * (g & 1) + 4 * (j & 1) + (j >> 1);
  return row * 8 + (p & 7);
}

// Splitter thread t's pieces of a stage: its piece i is staging piece
// P = piece_index(i, t), which is a's row P / (BK / E), column
// P % (BK / E) * E of the stage's BM x BK block for P < PA, else b's,
// numbered the same way in its BK x BN block (the layout of a TMA-staged
// stage, 16 bytes a piece). load_stage reads them from the matrices element
// by element.
template <class T>
__device__ __forceinline__ void load_stage(
    const T* __restrict__ a, const T* __restrict__ b, const Walk& w,
    const Corner& k, int t, uint4 (&v)[Cfg<T>::NP]) {
  using C = Cfg<T>;
#pragma unroll
  for (int i = 0; i < C::NP; ++i) {
    const int p = piece_index<T>(i, t);
    if (i < C::NA) {
      const int r = k.m0 + p / (BK / C::E);
      const int col = k.k0 + p % (BK / C::E) * C::E;
      v[i] = load_piece(a, r, w.M, col, w.K, w.K);
    } else {
      const int r = k.k0 + (p - C::PA) / (BN / C::E);
      const int col = k.n0 + (p - C::PA) % (BN / C::E) * C::E;
      v[i] = load_piece(b, r, w.K, col, w.N, w.N);
    }
  }
}

// Byte offsets of splitter thread t's pieces, the same in every stage:
// in a staging slot, and in slice slot 0 (columns 0 .. BK of A buffer 0,
// or B slot 0).
template <class T>
__device__ __forceinline__ void piece_offsets(int t,
                                              uint32_t (&staged)[Cfg<T>::NP],
                                              uint32_t (&slice)[Cfg<T>::NP]) {
  using C = Cfg<T>;
#pragma unroll
  for (int i = 0; i < C::NP; ++i) {
    const int p = piece_index<T>(i, t);
    staged[i] = 16 * p;
    const int q = p - C::PA;
    slice[i] = i < C::NA
                   ? wgmma::swz<BM>(p / (BK / C::E), p % (BK / C::E) * C::E)
                   : wgmma::swz<BK>(q / (BN / C::E), q % (BN / C::E) * C::E);
  }
}

// Split the pieces v into slice slot s: a's into columns BK (s % SPB) ..
// +BK of A buffer s / SPB (in the swizzle, BK (s % SPB) columns more flip
// the 16-byte chunk index by BK (s % SPB) / 8), b's into B slot s.
template <class T>
__device__ __forceinline__ void store_stage(
    const Layout& l, int s, const uint32_t (&slice)[Cfg<T>::NP],
    const uint4 (&v)[Cfg<T>::NP]) {
  using C = Cfg<T>;
  const uint32_t a_buf = s / SPB * A_BUF, a_flip = (s % SPB * BK / 8) << 4;
  const uint32_t b_slot = s * B_SLOT;
#pragma unroll
  for (int i = 0; i < C::NP; ++i) {
    const uint32_t off =
        i < C::NA ? a_buf + (slice[i] ^ a_flip) : b_slot + slice[i];
    split_piece(v[i], static_cast<const T*>(nullptr),
                (i < C::NA ? l.ah : l.bh) + off,
                (i < C::NA ? l.al : l.bl) + off);
  }
}

// The splitters' walk: each stage's pieces into swizzled hi/lo slices,
// handed to the consumers through full / empty. With TMA_ the first warp
// keeps D - 1 stages of copies ahead (waiting as a whole warp for their
// slots, so that its lanes do not diverge) and every splitter reads its
// pieces back from the staging slot; else each thread loads the next
// stage's pieces into registers before it splits this one's.
template <class T, bool TMA_>
__device__ __forceinline__ void split_walk(const T* __restrict__ a,
                                           const T* __restrict__ b,
                                           const Walk& w, const Layout& l,
                                           int stages,
                                           const CUtensorMap* map_a,
                                           const CUtensorMap* map_b) {
  using C = Cfg<T>;
  constexpr int NP = C::NP;
  const int t = threadIdx.x - CONSUMERS;
  const bool lane0 = (t & 31) == 0;  // a warp's one arrival on a barrier
  uint32_t staged[NP], slice[NP];
  piece_offsets<T>(t, staged, slice);
  if (TMA_) {
    // the TMA copies of stage g into its staging slot (one thread)
    const auto fetch = [&](int g) {
      const uint32_t bar = l.staged + 8 * (g % C::D);
      const uint32_t st = l.stage + g % C::D * C::STAGE_BYTES;
      const Corner k = corner<T>(w, g);
      mbar_arrive_tx(bar, C::STAGE_BYTES);
      tma::load_2d(st, map_a, k.k0, k.m0, bar);
      tma::load_2d(st + 16 * C::PA, map_b, k.n0, k.k0, bar);
    };
    if (t == 0)
      for (int g = 0; g < C::D - 1 && g < stages; ++g) fetch(g);
    for (int g = 0; g < stages; ++g) {
      if (t < 32 && g + C::D - 1 < stages) {
        wait_free(l.freed, g + C::D - 1, C::D);  // the slot's stage g - 1
        if (t == 0) fetch(g + C::D - 1);
        __syncwarp();
      }
      wait_filled(l.staged, g, C::D);
      const uint32_t st = l.stage + g % C::D * C::STAGE_BYTES;
      uint4 v[NP];
#pragma unroll
      for (int i = 0; i < NP; ++i)
        v[i] = wgmma::ld_shared_b128(st + staged[i]);
      __syncwarp();  // the warp's reads are done: the copies may refill
      if (lane0) mbar_arrive(l.freed + 8 * (g % C::D));
      wait_free(l.empty, g, C::S);
      store_stage<T>(l, g % C::S, slice, v);
      wgmma::fence_smem();
      __syncwarp();
      if (lane0) mbar_arrive(l.full + 8 * (g % C::S));
    }
  } else {
    uint4 v[NP], nx[NP];
    if (stages > 0) load_stage<T>(a, b, w, corner<T>(w, 0), t, v);
    for (int g = 0; g < stages; ++g) {
      if (g + 1 < stages) load_stage<T>(a, b, w, corner<T>(w, g + 1), t, nx);
      wait_free(l.empty, g, C::S);
      store_stage<T>(l, g % C::S, slice, v);
      wgmma::fence_smem();
      __syncwarp();
      if (lane0) mbar_arrive(l.full + 8 * (g % C::S));
#pragma unroll
      for (int i = 0; i < NP; ++i) v[i] = nx[i];
    }
  }
}

// Store this thread's accumulators of the tile at (m0, n0) into c, two
// adjacent columns a store where vec allows.
__device__ __forceinline__ void store_acc(const wgmma::Acc96& d, float* c,
                                          int m0, int n0, int mr, int nc,
                                          int N, bool vec) {
  const int t = wgmma::opaque_tid();
#pragma unroll
  for (int j = 0; j < 96; j += 2) {
    const int r = wgmma::acc_row(j, t);
    const int col = wgmma::acc_col(j, t);
    if (r >= mr) continue;
    float* dst = c + static_cast<size_t>(m0 + r) * N + n0 + col;
    if (vec && col + 1 < nc) {
      *reinterpret_cast<float2*>(dst) = make_float2(d[j], d[j + 1]);
    } else {
      if (col < nc) dst[0] = d[j];
      if (col + 1 < nc) dst[1] = d[j + 1];
    }
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
bitslice_mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ c, Walk w,
                   const __grid_constant__ CUtensorMap map_a,
                   const __grid_constant__ CUtensorMap map_b) {
  using C = Cfg<T>;
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout l = carve<T>(smem);
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::S; ++s) {
      mbar_init(l.full + 8 * s, SPLITTERS / 32);
      mbar_init(l.empty + 8 * s, CONSUMERS / 32);
    }
    for (int s = 0; s < C::D; ++s) {
      mbar_init(l.staged + 8 * s, 1);
      mbar_init(l.freed + 8 * s, SPLITTERS / 32);
    }
    tma::mbar_fence_init();
  }
  __syncthreads();
  const int my_tiles =
      (w.tiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x;
  const int stages = my_tiles * w.nk;

  if (threadIdx.x >= CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 104;\n" ::: "memory");
    if (w.flags & TMA)
      split_walk<T, true>(a, b, w, l, stages, &map_a, &map_b);
    else
      split_walk<T, false>(a, b, w, l, stages, &map_a, &map_b);
  } else {
    // consumers: products of each stage as soon as its slices are whole
    asm volatile("setmaxnreg.inc.sync.aligned.u32 152;\n" ::: "memory");
    const int wg = threadIdx.x >> 7;
    const bool lane0 = (threadIdx.x & 31) == 0;
    wgmma::Acc96 acc;  // this warpgroup's 64 rows of the tile
    int g = 0;
    for (int tile = blockIdx.x; tile < w.tiles; tile += gridDim.x) {
#pragma unroll
      for (int j = 0; j < 96; ++j) acc[j] = 0.f;
      for (int kt = 0; kt < w.nk; ++kt, ++g) {
        const int s = g % C::S;
        wait_filled(l.full, g, C::S);
        const uint32_t ah = l.ah + s / SPB * A_BUF;
        const uint32_t al = l.al + s / SPB * A_BUF;
        const uint32_t bh = l.bh + s * B_SLOT;
        const uint32_t bl = l.bl + s * B_SLOT;
        wgmma::fence_operand(acc);
        wgmma::fence();
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks) {
          const int kk = s % SPB * (BK / 16) + ks;
          const uint64_t dah = wgmma::desc_k(ah, wg, kk);
          const uint64_t dbh = wgmma::desc_mn<BK>(bh, ks);
          wgmma::mma<0, 1>(acc, dah, dbh, 1);
          if (C::LO) {
            wgmma::mma<0, 1>(acc, dah, wgmma::desc_mn<BK>(bl, ks), 1);
            wgmma::mma<0, 1>(acc, wgmma::desc_k(al, wg, kk), dbh, 1);
          }
        }
        wgmma::commit();
        wgmma::wait<1>();  // the previous stage's products are done
        wgmma::fence_operand(acc);
        if (kt > 0 && lane0) mbar_arrive(l.empty + 8 * ((g - 1) % C::S));
      }
      wgmma::wait<0>();
      wgmma::fence_operand(acc);
      if (lane0) mbar_arrive(l.empty + 8 * ((g - 1) % C::S));
      const int m0 = (tile % w.mt) * BM, n0 = (tile / w.mt) * BN;
      const int mr = min(BM, w.M - m0), nc = min(BN, w.N - n0);
      const bool vec = w.flags & VEC_C;
      store_acc(acc, c, m0, n0, mr, nc, w.N, vec);
    }
  }
}

template <class T>
constexpr CUtensorMapDataType tma_type() {
  return std::is_same<T, float>::value    ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
         : std::is_same<T, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                          : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// Tensor map of a row-major rows x cols matrix, boxes of box_rows x
// box_cols, zero outside the matrix.
template <class T>
bool encode(CUtensorMap* map, const T* p, int rows, int cols, int box_rows,
            int box_cols) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * sizeof(T)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return tma::encode_tiled()(map, tma_type<T>(), 2, const_cast<T*>(p), dims,
                        strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <class T>
int launch(const T* a, const T* b, float* c, int M, int N, int K,
           void* stream) {
  using C = Cfg<T>;
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long mt = (M + BM - 1) / BM, nt = (N + BN - 1) / BN;
  const long long nk = (K + BK - 1) / BK;
  if (mt * nt * nk > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bitslice_mm_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (tma::encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorSymbolNotFound);
  // TMA needs 16-byte aligned bases and row strides: K and N multiples of
  // E elements
  const auto aligned = [](const void* p, int bytes) {
    return reinterpret_cast<uintptr_t>(p) % bytes == 0;
  };
  Walk w;
  w.M = M;
  w.N = N;
  w.K = K;
  w.mt = static_cast<int>(mt);
  w.nk = static_cast<int>(nk);
  w.tiles = static_cast<int>(mt * nt);
  w.flags = (K % C::E == 0 && N % C::E == 0 && aligned(a, 16) &&
                     aligned(b, 16)
                 ? TMA
                 : 0) |
            (N % 2 == 0 && aligned(c, 8) ? VEC_C : 0);
  CUtensorMap map_a{}, map_b{};
  if ((w.flags & TMA) && !(encode(&map_a, a, M, K, BM, BK) &&
                           encode(&map_b, b, K, N, BK, BN)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(mt * nt < sms ? mt * nt : sms);
  bitslice_mm_kernel<T><<<grid, THREADS, C::SMEM,
                          static_cast<cudaStream_t>(stream)>>>(
      a, b, c, w, map_a, map_b);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` for row-major a (M, K), b (K, N) and c (M, N); returns
// the cudaError_t of the launch (0 = success).
extern "C" int bitslice_mm_f32_launch(const float* a, const float* b,
                                      float* c, int M, int N, int K,
                                      void* stream) {
  return launch(a, b, c, M, N, K, stream);
}

extern "C" int bitslice_mm_f16_launch(const __half* a, const __half* b,
                                      float* c, int M, int N, int K,
                                      void* stream) {
  return launch(a, b, c, M, N, K, stream);
}

extern "C" int bitslice_mm_bf16_launch(const bf16* a, const bf16* b,
                                       float* c, int M, int N, int K,
                                       void* stream) {
  return launch(a, b, c, M, N, K, stream);
}

extern "C" const char* bitslice_mm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
