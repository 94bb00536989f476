// Bit-sliced (hi/lo bf16) matrix product with fp32 accumulation:
// c = a @ b for a (M, K) and b (K, N), fp32, fp16 or bf16 in, fp32 out.
//
// Replaces the Pallas TPU kernel repro/kernels/bitslice_mm.py (_kernel,
// called from bitslice_mm). Every operand is upcast to fp32 and split
// x = x_hi + x_lo (bf16, round to nearest even) inside the kernel, and
//   c = a_hi b_hi + a_hi b_lo + a_lo b_hi
// on the tensor cores (a_lo b_lo is below the fp32 floor and dropped, as
// on the TPU). Any M, N, K >= 1: the edges are masked in the kernel (zero
// fill in shared memory, stores guarded), not padded on the host.
//
// Bound: operations. 3 partials x 2MNK bf16 FLOP against 4(MK + KN + MN)
// bytes; at the MLP product of the main path, (2048, 1024) @ (1024, 2816),
// 35.4 GFLOP (0.036 ms at 989 TFLOP/s) against 43 MB (0.013 ms).
// Design (a first one): a CTA of 8 warps owns a 128 x 128 output tile and
// walks K in steps of 32. Each step's fp32 a and b tiles are split into
// hi/lo bf16 tiles in shared memory (38 KB), and gemm3 feeds every
// fragment pair to its three mma.sync. The next step's fp32 values are
// loaded into registers before this step's products, so the global loads
// overlap the tensor-core work. That prefetch needs 180 registers, so one
// CTA runs per SM: capped at 128 registers for two CTAs, the kernel spilled
// and ran slower (PERF.md). wgmma, TMA and a deeper pipeline are later
// work.
#include <cuda_fp16.h>

#include "hilo_mma.cuh"

using namespace hilo;

namespace {

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int LDA = BK + 8;  // 80-byte rows: ldmatrix rows on distinct banks
constexpr int LDB = BN + 8;
constexpr int A_PER_THREAD = BM * BK / THREADS;  // 16
constexpr int B_PER_THREAD = BK * BN / THREADS;  // 16

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

// This thread's a and b values of the K step at k0 (zero outside the
// matrices). Element i of a sits at row (tid / BK) + i * (THREADS / BK),
// column tid % BK of the tile; of b at row (tid / BN) + i * (THREADS / BN),
// column tid % BN.
template <class T>
__device__ __forceinline__ void load_step(const T* __restrict__ a,
                                          const T* __restrict__ b, int M,
                                          int N, int K, int m0, int n0,
                                          int k0, float va[A_PER_THREAD],
                                          float vb[B_PER_THREAD]) {
  const int tid = threadIdx.x;
  const int ac = k0 + tid % BK;
#pragma unroll
  for (int i = 0; i < A_PER_THREAD; ++i) {
    const int r = m0 + tid / BK + i * (THREADS / BK);
    va[i] = (r < M && ac < K) ? to_f32(a[static_cast<size_t>(r) * K + ac])
                              : 0.f;
  }
  const int bc = n0 + tid % BN;
#pragma unroll
  for (int i = 0; i < B_PER_THREAD; ++i) {
    const int r = k0 + tid / BN + i * (THREADS / BN);
    vb[i] = (r < K && bc < N) ? to_f32(b[static_cast<size_t>(r) * N + bc])
                              : 0.f;
  }
}

template <class T>
__global__ void __launch_bounds__(THREADS, 1)
bitslice_mm_kernel(const T* __restrict__ a, const T* __restrict__ b,
                   float* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) bf16 AH[BM * LDA];
  __shared__ __align__(16) bf16 AL[BM * LDA];
  __shared__ __align__(16) bf16 BH[BK * LDB];
  __shared__ __align__(16) bf16 BL[BK * LDB];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int mr = min(BM, M - m0);
  const int nc = min(BN, N - n0);

  Acc acc;
  zero(acc);
  float va[A_PER_THREAD], vb[B_PER_THREAD];
  load_step(a, b, M, N, K, m0, n0, 0, va, vb);
  for (int k0 = 0; k0 < K; k0 += BK) {
    __syncthreads();  // the previous step's products are done with the tiles
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int off = (tid / BK + i * (THREADS / BK)) * LDA + tid % BK;
      split(va[i], AH[off], AL[off]);
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int off = (tid / BN + i * (THREADS / BN)) * LDB + tid % BN;
      split(vb[i], BH[off], BL[off]);
    }
    __syncthreads();
    if (k0 + BK < K) load_step(a, b, M, N, K, m0, n0, k0 + BK, va, vb);
    gemm3<false, false, LDA, LDB>(acc, AH, AL, BH, BL, BK, mr, nc);
  }

  for_each(acc, [&](int r, int col, float& v) {
    if (r < mr && col < nc) c[static_cast<size_t>(m0 + r) * N + n0 + col] = v;
  });
}

template <class T>
int launch(const T* a, const T* b, float* c, int M, int N, int K,
           void* stream) {
  if (M < 1 || N < 1 || K < 1 || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  bitslice_mm_kernel<T><<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(a, b, c, M, N,
                                                               K);
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
