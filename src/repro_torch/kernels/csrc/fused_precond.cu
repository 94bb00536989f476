// Pooled two-sided block VMM with the trust-region dot in the same pass,
// one CTA per gradient tile.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_precond.py (_kernel,
// called from fused_precond). Per tile t, with bi, bo <= 128:
//   tmp     = hilo(A_inv[t], g[t])          (bi x bo)
//   out[t]  = hilo(tmp, G_inv[t])           (left-first association)
//   dots[t] = sum(out[t] * g[t])
// where hilo(P, Q) = P_H Q_H + P_H Q_L + P_L Q_H on the tensor cores
// (bf16 operands, fp32 accumulation).
//
// Bound: bytes. A 128 x 128 tile moves 4 x 64 KB of fp32 (three inputs,
// one output) for 6 partial 128^3 GEMMs (25 MFLOP), ~100 FLOP per byte,
// left of the H100's ~295 bf16 FLOP/byte ridge: at the main path's 18816
// tiles that is 4.9 GB (1.5 ms at 3.35 TB/s) against 0.48 ms of tensor-core
// work.
// Design against that bound: each input is read from device memory once
// and the output written once; the intermediate tmp never leaves the SM
// (its hi/lo slices overwrite the A_inv slices in shared memory) and the
// trust-region dot is reduced from the output registers, so no second pass
// over g or out is needed. Four bf16 128x136 tiles (136 KB) allow one CTA
// per SM; overlapping the next tile's loads with this tile's products
// (cp.async/TMA double buffering) is later work.
#include "hilo_mma.cuh"

using namespace hilo;

namespace {

constexpr int SMEM_BYTES = 4 * TILE_BYTES + (THREADS / 32) * 4;

__global__ void __launch_bounds__(THREADS, 1)
fused_precond_kernel(const float* __restrict__ a_inv,
                     const float* __restrict__ g,
                     const float* __restrict__ g_inv,
                     float* __restrict__ out, float* __restrict__ dots,
                     int bi, int bo) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* PH = reinterpret_cast<bf16*>(smem);   // A_inv, then tmp
  bf16* PL = PH + TILE_ELEMS;
  bf16* QH = PL + TILE_ELEMS;                  // g, then G_inv
  bf16* QL = QH + TILE_ELEMS;
  float* red = reinterpret_cast<float*>(QL + TILE_ELEMS);

  const size_t t = blockIdx.x;
  const float* gt = g + t * bi * bo;

  load_split(a_inv + t * bi * bi, bi, bi, bi, 0.f, PH, PL);
  load_split(gt, bi, bo, bo, 0.f, QH, QL);
  __syncthreads();

  Acc acc;
  zero(acc);
  gemm(acc, PH, QH);
  gemm(acc, PH, QL);
  gemm(acc, PL, QH);
  __syncthreads();
  store_split(acc, PH, PL);
  load_split(g_inv + t * bo * bo, bo, bo, bo, 0.f, QH, QL);
  __syncthreads();

  zero(acc);
  gemm(acc, PH, QH);
  gemm(acc, PH, QL);
  gemm(acc, PL, QH);

  float* ot = out + t * bi * bo;
  float s = 0.f;
  for_each(acc, [&](int r, int c, float& v) {
    if (r < bi && c < bo) {
      ot[r * bo + c] = v;
      s += v * gt[r * bo + c];
    }
  });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float d = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) d += red[w];
    dots[t] = d;
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = success).
extern "C" int fused_precond_launch(const float* a_inv, const float* g,
                                    const float* g_inv, float* out,
                                    float* dots, int n_tiles, int bi, int bo,
                                    void* stream) {
  if (bi < 1 || bi > NP || bo < 1 || bo > NP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_precond_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_precond_kernel<<<n_tiles, THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      a_inv, g, g_inv, out, dots, bi, bo);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_precond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
