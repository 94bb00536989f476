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
// Design against that bound: the whole iteration stays on chip
// (composed_inv.cuh: six bf16 tiles in shared memory, fp32 state in
// registers), so device memory is touched once to load the block and once
// to store its inverse. One CTA per SM (8 warps, mma.sync); wgmma/TMA
// pipelining is later work.
#include "composed_inv.cuh"

using namespace hilo;

namespace {

constexpr int SMEM_BYTES = COMPOSED_SMEM_BYTES;

__global__ void __launch_bounds__(THREADS, 1)
neumann_inv_kernel(const float* __restrict__ a,
                   const float* __restrict__ damping,
                   float* __restrict__ out, int n, int ns_iters,
                   int taylor_terms, int refine_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  const ComposedTiles s = carve_tiles(smem);
  const size_t blk = static_cast<size_t>(blockIdx.x) * n * n;

  // Ad = A + lam I, split into the A_H / A_L slices
  load_split(a + blk, n, n, n, damping[blockIdx.x], s.AH, s.AL);
  __syncthreads();
  composed_inverse(s, n, ns_iters, taylor_terms, refine_steps, out + blk);
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
