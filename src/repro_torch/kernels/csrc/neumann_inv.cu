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
#include "composed_inv.cuh"

constexpr int MAX_LEAVES = 32;

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

extern "C" const char* neumann_inv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
