// Composed-precision inverse of damped SPD blocks, one CTA per block, for a
// group of leaves in one launch.
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
// FLOP/byte ridge: 528 blocks take at least 0.284 ms at 989 TFLOP/s.
// Design against that bound: the whole iteration stays on chip
// (composed_inv.cuh: six swizzled bf16 tiles in shared memory, fp32 state in
// registers), so device memory is touched once to load the block and once
// to store its inverse; every product runs on wgmma from shared memory (two
// warpgroups of 64 rows each, one commit and one wait a product), with two
// barriers a Newton-Schulz step. One CTA per SM (192 KB of tiles): the
// hi/lo splits between products and the barriers are not hidden behind
// another CTA's products, and they hold it near half of the bound.
//
// Grouping: one launch inverts the blocks of up to MAX_LEAVES leaves of
// the same n, Σ nb_i CTAs, each finding its leaf in a table passed by value
// as a kernel parameter (base pointers of input, damping and output, and
// the prefix sums of nb_i). A K-FAC refresh of 3120 blocks in 11 leaves is
// then one launch (24 waves of 132 CTAs, not 28 in 11 launches), and each
// CTA computes exactly what it computes in a launch of its leaf alone.
//
// Blocks of 129..1024 (the reference's whole domain) take a second route:
// a block's hi/lo pair no longer fits one CTA (256 KB at n = 256 against
// 227 KB), so the iteration runs as a sequence of batched products over
// every block of a chunk of one side, with the state in a workspace that
// the caller allocates (kernels/neumann_inv.py): each buffer of the
// schedule kept in the forms its readers take, fp32 (rows ld32 apart, ld32
// = n rounded up to 4) where an epilogue's E or the copy-out reads it, and
// bf16 hi and lo slices (rows ld16 apart, n rounded up to 8) where a
// product reads it as an operand:
//   neumann_inv_prep      Ad = A + lam I (its slices) and X0 = A_H /
//                         (|A_H|_1 |A_H|_inf), one CTA a block, the norms
//                         on n as given, summed in a fixed order;
//   neumann_inv_product   one product of the iteration with its epilogue
//                         (hilo_tma.cuh: W = 2I - A_H X, X W, A_L T,
//                         T = -X U with M += T, R = I - Ad M, M + M R),
//                         each result split once as it is stored;
//   neumann_inv_copy_out  the chunk's inverses into the leaves' outputs.
// The caller issues them in the order of the schedule
// (kernels/neumann_inv.py, inv_schedule, which also says which forms each
// kernel writes): 2 ns + 2 (taylor - 1) + 2 refine products between prep
// and copy-out. Each block's arithmetic is independent of the chunk and of
// the other leaves, and nothing is summed with atomics, so a grouped call
// is bitwise the per-leaf calls and a run bitwise its repeat.
//
// Bound of the large route: at 20/4/2 a block takes 127 partial n^3
// products (254 n^3 bf16 FLOP) against 8 n^2 bytes of input and output:
// operations, 3.31 ms for the 768 blocks of 256 of a block-256 refresh and
// 52.9 ms for the 192 blocks of 1024 of a block-1024 one. With the state
// round-tripping through device memory between products, the schedule
// itself moves 614 n^2 bytes a block (each kernel's inputs read once and
// its outputs written once, in their forms; neumann_inv.schedule_bytes):
// 9.22 ms at 3.35 TB/s for the 256 side, above its operations bound, and
// 15.8 ms for the whole block-256 refresh (with 1152 blocks of 176); at
// 1024 the operations outweigh it (36.9 ms). The design's answer is to make
// each product run at the rate of its bytes or of its tensor cores:
// operands are split once, by their writer, never on load; TMA brings them
// in whole 64-deep stages with no thread spent on a load or a split;
// wgmma takes 128 x 192 or 128 x 256 output tiles, so a 256 side reads
// each of its row panels once and its column panel twice. Keeping a 256
// block on chip in a cluster is what would go below the bytes floor.
#include "composed_inv.cuh"
#include "hilo_tma.cuh"

constexpr int MAX_LEAVES = 32;
constexpr int LARGE_N = 1024;  // the reference's largest block

struct LeafTable {
  const float* a[MAX_LEAVES];        // (nb_i, n, n) blocks
  const float* damping[MAX_LEAVES];  // (nb_i,)
  float* out[MAX_LEAVES];            // (nb_i, n, n) inverses
  int start[MAX_LEAVES + 1];         // prefix sums of nb_i
  int count;                         // leaves, 1 .. MAX_LEAVES
};

namespace {

__global__ void __launch_bounds__(composed::THREADS, 1)
neumann_inv_kernel(const __grid_constant__ LeafTable t, int n, int ns_iters,
                   int taylor_terms, int refine_steps) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const composed::Tiles s = composed::carve(smem);
  const int b = static_cast<int>(blockIdx.x);
  int leaf = 0;
  while (leaf + 1 < t.count && t.start[leaf + 1] <= b) ++leaf;
  const int i = b - t.start[leaf];
  const size_t blk = static_cast<size_t>(i) * n * n;

  // Ad = A + lam I, split into the A_H / A_L slices
  composed::load_split(t.a[leaf] + blk, n, t.damping[leaf][i], s.AH, s.AL);
  __syncthreads();
  composed::inverse(s, n, ns_iters, taylor_terms, refine_steps,
                    t.out[leaf] + blk);
}

}  // namespace

// Launch on `stream` over the leaves of `table` (read before returning);
// returns the cudaError_t of the launch (0 = success).
extern "C" int neumann_inv_launch(const LeafTable* table, int n, int ns_iters,
                                  int taylor_terms, int refine_steps,
                                  void* stream) {
  if (n < 1 || n > composed::NP || table->count < 1 ||
      table->count > MAX_LEAVES)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = table->start[table->count];
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      neumann_inv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      composed::SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  neumann_inv_kernel<<<blocks, composed::THREADS, composed::SMEM_BYTES,
                       static_cast<cudaStream_t>(stream)>>>(
      *table, n, ns_iters, taylor_terms, refine_steps);
  return static_cast<int>(cudaGetLastError());
}

namespace {

__device__ __forceinline__ int leaf_of(const LeafTable& t, int b) {
  int leaf = 0;
  while (leaf + 1 < t.count && t.start[leaf + 1] <= b) ++leaf;
  return leaf;
}

__device__ __forceinline__ float hi_abs(float v) {
  return fabsf(__bfloat162float(__float2bfloat16_rn(v)));
}

constexpr int PREP_THREADS = 1024;
constexpr int PREP_U = 8;  // loads a thread issues before it uses them

// v's forms into o at fp32 index i32 and bf16 index i16 (hilo::split2's
// rounding: hi = bf16(v), lo = bf16(v - hi)).
__device__ __forceinline__ void put(const htma::Out& o, size_t i32,
                                    size_t i16, float v) {
  if (o.f32) o.f32[i32] = v;
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  if (o.hi) o.hi[i16] = h;
  if (o.lo) o.lo[i16] = __float2bfloat16_rn(v - __bfloat162float(h));
}

// One CTA a block (global index b0 + blockIdx.x of the table): Ad into
// `ad` and X0 into `x`, each in the forms given (n x n, rows ld32 or ld16
// apart, block after block). |A_H|_1: thread j sums column j over the rows
// in order; |A_H|_inf: a warp sums a row by lanes, then a butterfly (every
// lane ends with the same sum); both maxima are exact in any order. Each
// loop takes its entries PREP_U at a time, every load of the group issued
// before the first is used (a chunk of 1024-blocks has only as many CTAs
// as blocks: one load in flight a thread left its SMs waiting on latency),
// and adds them in the same order.
__global__ void __launch_bounds__(PREP_THREADS)
inv_prep_kernel(const __grid_constant__ LeafTable t, int b0, int n, int ld32,
                int ld16, const htma::Out ad, const htma::Out x) {
  __shared__ float red[2][PREP_THREADS / 32];
  const int b = b0 + static_cast<int>(blockIdx.x);
  const int leaf = leaf_of(t, b);
  const int i = b - t.start[leaf];
  const float* src = t.a[leaf] + static_cast<size_t>(i) * n * n;
  const float lam = t.damping[leaf][i];
  const size_t o32 = static_cast<size_t>(blockIdx.x) * n * ld32;
  const size_t o16 = static_cast<size_t>(blockIdx.x) * n * ld16;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  float cmax = 0.f;
  for (int j = tid; j < n; j += PREP_THREADS) {
    float s = 0.f;
    for (int r0 = 0; r0 < n; r0 += PREP_U) {
      float v[PREP_U];
#pragma unroll
      for (int u = 0; u < PREP_U; ++u) {
        const int r = r0 + u;
        v[u] = r < n ? src[static_cast<size_t>(r) * n + j] +
                           (r == j ? lam : 0.f)
                     : 0.f;
      }
#pragma unroll
      for (int u = 0; u < PREP_U; ++u) {
        const int r = r0 + u;
        if (r >= n) break;
        put(ad, o32 + static_cast<size_t>(r) * ld32 + j,
            o16 + static_cast<size_t>(r) * ld16 + j, v[u]);
        s += hi_abs(v[u]);
      }
    }
    cmax = fmaxf(cmax, s);
  }
  float rmax = 0.f;
  for (int r = warp; r < n; r += PREP_THREADS / 32) {
    const float* row = src + static_cast<size_t>(r) * n;
    float s = 0.f;
    for (int j0 = lane; j0 < n; j0 += 32 * PREP_U) {
      float v[PREP_U];
#pragma unroll
      for (int u = 0; u < PREP_U; ++u) {
        const int j = j0 + 32 * u;
        v[u] = j < n ? row[j] + (r == j ? lam : 0.f) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < PREP_U; ++u)
        if (j0 + 32 * u < n) s += hi_abs(v[u]);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    rmax = fmaxf(rmax, s);
  }
  cmax = composed::warp_max(cmax);
  rmax = composed::warp_max(rmax);
  if (lane == 0) {
    red[0][warp] = cmax;
    red[1][warp] = rmax;
  }
  __syncthreads();
  float n1 = 0.f, ninf = 0.f;
  for (int w = 0; w < PREP_THREADS / 32; ++w) {
    n1 = fmaxf(n1, red[0][w]);
    ninf = fmaxf(ninf, red[1][w]);
  }
  const float bound = n1 * ninf;
  const int nn = n * n;
  for (int k0 = tid; k0 < nn; k0 += PREP_THREADS * PREP_U) {
    float v[PREP_U];
#pragma unroll
    for (int u = 0; u < PREP_U; ++u) {
      const int k = k0 + PREP_THREADS * u;
      v[u] = k < nn ? src[k] + (k / n == k % n ? lam : 0.f) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < PREP_U; ++u) {
      const int k = k0 + PREP_THREADS * u;
      if (k >= nn) break;
      const int r = k / n, c = k - r * n;
      put(x, o32 + static_cast<size_t>(r) * ld32 + c,
          o16 + static_cast<size_t>(r) * ld16 + c,
          __bfloat162float(__float2bfloat16_rn(v[u])) / bound);
    }
  }
}

// The chunk's inverses m (row stride ld) into the leaves' outputs;
// blockIdx.y is the block of the chunk.
__global__ void inv_copy_out_kernel(const __grid_constant__ LeafTable t,
                                    int b0, int n, int ld,
                                    const float* __restrict__ m) {
  const int b = b0 + static_cast<int>(blockIdx.y);
  const int leaf = leaf_of(t, b);
  const int i = b - t.start[leaf];
  float* dst = t.out[leaf] + static_cast<size_t>(i) * n * n;
  const float* src = m + static_cast<size_t>(blockIdx.y) * n * ld;
  for (int k = blockIdx.x * blockDim.x + threadIdx.x; k < n * n;
       k += gridDim.x * blockDim.x) {
    const int r = k / n;
    dst[k] = src[static_cast<size_t>(r) * ld + k - r * n];
  }
}

bool large_args(const LeafTable* t, int b0, int nb, int n, int ld32) {
  return n > composed::NP && n <= LARGE_N && ld32 >= n && ld32 % 4 == 0 &&
         t->count >= 1 && t->count <= MAX_LEAVES && b0 >= 0 && nb >= 1 &&
         nb <= 65535 && b0 + nb <= t->start[t->count];
}

}  // namespace

// Large route, step 1: Ad and X0 of blocks b0 .. b0 + nb - 1 of the table
// into the workspace, each in the forms its Out names. Returns the
// cudaError_t (0 = ok).
extern "C" int neumann_inv_prep(const LeafTable* table, int b0, int nb, int n,
                                int ld32, int ld16, const htma::Out* ad,
                                const htma::Out* x, void* stream) {
  if (!large_args(table, b0, nb, n, ld32) || ld16 < n || ld16 % 8 != 0 ||
      !ad || !x)
    return static_cast<int>(cudaErrorInvalidValue);
  inv_prep_kernel<<<nb, PREP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, b0, n, ld32, ld16, *ad, *x);
  return static_cast<int>(cudaGetLastError());
}

// Large route: one product of the iteration (hilo_tma.cuh).
extern "C" int neumann_inv_product(const htma::Params* p, void* stream) {
  return htma::launch(*p, static_cast<cudaStream_t>(stream));
}

// Large route, last step: the inverses m of blocks b0 .. b0 + nb - 1 into
// the table's outputs.
extern "C" int neumann_inv_copy_out(const LeafTable* table, int b0, int nb,
                                    int n, int ld32, const float* m,
                                    void* stream) {
  if (!large_args(table, b0, nb, n, ld32) || !m)
    return static_cast<int>(cudaErrorInvalidValue);
  const int per = (n * n + 255) / 256;
  const dim3 grid(per < 16 ? per : 16, nb);
  inv_copy_out_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      *table, b0, n, ld32, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* neumann_inv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
