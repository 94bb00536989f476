// Pooled two-sided block VMM with the trust-region dot in the same pass:
// persistent CTAs, loads in flight behind the products, inverse blocks read
// from their pools by index.
//
// Replaces the Pallas TPU kernel repro/kernels/fused_precond.py (_kernel,
// called from fused_precond). Per tile t, with bi, bo <= 128:
//   tmp     = hilo(A[t], g[t])          (bi x bo)
//   out[t]  = hilo(tmp, G[t])           (left-first association)
//   dots[t] = sum(out[t] * g[t])
// where hilo(P, Q) = P_H Q_H + P_H Q_L + P_L Q_H on the tensor cores (bf16
// operands, fp32 accumulation), and A[t] = a_inv[a_src[t]], G[t] =
// g_inv[g_src[t]] when index arrays are given (the pools of distinct
// inverse blocks the WU plan indexes), else a_inv[t] and g_inv[t]. The TPU
// kernel takes gathered tiles because its BlockSpecs cut them; here a CTA
// reads its own indices, so the 64 KB blocks are never copied per tile.
//
// Bound: bytes. A 128 x 128 tile moves 4 x 64 KB of fp32 in the gathered
// form for 6 partial 128^3 GEMMs (25 MFLOP), ~100 FLOP per byte, left of
// the H100's ~295 bf16 FLOP/byte ridge: at the main path's 18816 tiles 4.9
// GB (1.47 ms at 3.35 TB/s) against 0.48 ms of tensor-core work. In the
// indexed form the function must read g and write out once and each
// distinct pool block once: 2.47 + 0.20 GB (0.80 ms).
// Design against that bound:
//   * Persistent CTAs, one per SM (grid = SM count), each walking tiles
//     t = blockIdx.x, + gridDim.x, ...: at any moment the CTAs hold
//     consecutive tiles, which share their A block and cycle through one
//     layer's few G blocks, so repeated pool blocks come from L2.
//   * Three equal shared-memory regions, each holding either a bf16 hi/lo
//     pair (128 x 136) or an fp32 staging tile (128 x 132) filled by
//     16-byte cp.async. R keeps the right operand (g, then G); X and Y
//     swap roles every tile. With g[t] landed in X and A[t] landing in Y:
//     split g into R (its fp32 kept in registers in the accumulator
//     layout for the dot) while A lands; split A into X; G lands in Y
//     behind tmp = hilo(A, g); tmp's slices overwrite A's and G's
//     overwrite g's; g[t+1] lands in Y behind out = hilo(tmp, G), and
//     A[t+1] in X behind the epilogue and the next split of g. Each
//     operand is read from device memory once; tmp never leaves the SM.
//   * Epilogue from registers: the dot from the output and kept g values;
//     out in 16-byte stores after one shuffle a lane pair.
//   * Products: gemm3_full (the three partials a fragment, the k loop
//     unrolled, the next k-step's fragments loaded under this step's mma).
// Shared memory: three regions of 69,632 B + 32 B = 208,928 B of the
// 232,448 a block may have, so one CTA per SM; a fourth region (to land
// A[t+1] behind the second product) does not fit. Registers (-Xptxas -v,
// see the build log chip_smoke.py prints): 216 a thread (64 accumulators,
// 64 kept g values, fragments), no spills.
// What holds it back now (PERF.md): the indexed form, with half the bytes,
// takes as long as the gathered one, so bytes no longer bound it. The two
// products on mma.sync and the four fp32 -> hi/lo splits run on the same
// warps one after another; wgmma and splits on warps of their own are the
// next step.
//
// Tiles with a side of 129..1024 (the reference's whole domain) take a
// second route, on hilo_tma.cuh's batched product (TMA, wgmma, operands
// stored as bf16 hi/lo slices by the kernel that writes them), with the
// schedule of launches in Python (kernels/fused_precond.wu_schedule):
//   fused_precond_split    once a call, each distinct inverse pool into
//                          its slices (one split when a_inv is g_inv);
// then per chunk of tiles (workspace from PyTorch's allocator, under
// hilo_tma.WORKSPACE_BYTES):
//   fused_precond_split    the chunk's g into its slices,
//   fused_precond_product  (FULL, STORE) tmp = hilo(A[a_src[t]], g[t]),
//                          stored as its two slices only,
//   fused_precond_product  (FULL, DOT) out[t] = hilo(tmp, G[g_src[t]]) in
//                          fp32 into the caller's unpadded out, each
//                          (tile, warpgroup)'s sum of out * g (E, the
//                          caller's g) into a partial,
//   fused_precond_dots     dots[t] = the tile's partials summed in order.
// The pools are read by index through their tensor maps (the producer
// reads a_src[t] and g_src[t] as a tile's block coordinates): no block is
// gathered or split per tile, and tiles next to each other in the walk
// share an A block (a WU plan's runs), read from L2.
// Bound. The function (each input read once, each distinct pool block
// once) is bound by operations at the WU's shapes: (1536, 256, 256) is
// 309 GFLOP of bf16 partials, 0.31 ms at 989 TFLOP/s, against 0.23 ms of
// its bytes. The design's own floor is bytes, since tmp and the slices
// pass through device memory: 28 B an element of g (the split 4 + 4,
// product 1 4 + 4, product 2 4 + 4 + 4) and 12 B an element of a pool
// (split 4 + 4, read 4), 0.89 ms at that shape (wu_schedule's
// floor_bytes). What holds it back (kernel_times.py --ablate at that shape
// on the H100, PERF.md section 6): g's split (0.29 ms, ~2.8 TB/s) and the
// two products' epilogues, which the consumer warpgroups run between one
// tile's products and the next (without them the products take 0.21 and
// 0.20 ms instead of 0.39 and 0.57 ms); a call takes ~1.4 ms. Sides of 130
// or 176 rows also multiply zeros over 256 rows (128-row tiles).
#include "hilo_mma.cuh"
#include "hilo_tma.cuh"

using namespace hilo;

namespace {

constexpr int REGION_BYTES = 2 * TILE_BYTES;
constexpr int SMEM_BYTES = 3 * REGION_BYTES + (THREADS / 32) * 4;
static_assert(STAGE_BYTES <= REGION_BYTES, "staging fits a region");

__global__ void __launch_bounds__(THREADS, 1)
fused_precond_kernel(const float* __restrict__ a_inv,
                     const float* __restrict__ g,
                     const float* __restrict__ g_inv,
                     const int* __restrict__ a_src,
                     const int* __restrict__ g_src,
                     float* __restrict__ out, float* __restrict__ dots,
                     int n_tiles, int bi, int bo, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* RH = reinterpret_cast<bf16*>(smem);    // g, then G (hi/lo)
  bf16* RL = RH + TILE_ELEMS;
  unsigned char* X = smem + REGION_BYTES;      // g lands; A, then tmp
  unsigned char* Y = smem + 2 * REGION_BYTES;  // A lands; G lands; g lands
  float* red = reinterpret_cast<float*>(smem + 3 * REGION_BYTES);

  const size_t gsz = static_cast<size_t>(bi) * bo;
  const size_t asz = static_cast<size_t>(bi) * bi;
  const size_t bsz = static_cast<size_t>(bo) * bo;
  int t = blockIdx.x;
  if (t >= n_tiles) return;
  stage_async(g + t * gsz, bi, bo, vec, reinterpret_cast<float*>(X));
  stage_async(a_inv + (a_src ? a_src[t] : t) * asz, bi, bi, vec,
              reinterpret_cast<float*>(Y));

  Acc acc, gk;
  for (; t < n_tiles; t += gridDim.x) {
    const size_t ig = g_src ? g_src[t] : t;
    float* xs = reinterpret_cast<float*>(X);
    float* ys = reinterpret_cast<float*>(Y);
    bf16* PH = reinterpret_cast<bf16*>(X);
    bf16* PL = PH + TILE_ELEMS;

    // g[t] (X) into R, while A[t] lands in Y
    cp_async_wait<1>();
    __syncthreads();
    split_staged(xs, bi, bo, RH, RL);
    load_acc_layout(xs, bi, bo, gk);
    cp_async_wait<0>();
    __syncthreads();
    split_staged(ys, bi, bi, PH, PL);
    __syncthreads();

    // tmp = hilo(A, g) while G[t] lands in Y
    stage_async(g_inv + ig * bsz, bo, bo, vec, ys);
    zero(acc);
    gemm3_full(acc, PH, PL, RH, RL);
    __syncthreads();
    store_split2(acc, PH, PL);
    cp_async_wait<0>();
    __syncthreads();
    split_staged(ys, bo, bo, RH, RL);
    __syncthreads();

    // out = hilo(tmp, G) while g[t + gridDim.x] lands in Y
    const int next = t + gridDim.x;
    if (next < n_tiles) stage_async(g + next * gsz, bi, bo, vec, ys);
    zero(acc);
    gemm3_full(acc, PH, PL, RH, RL);

    float s = 0.f;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 8; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) s += acc[mi][ni][e] * gk[mi][ni][e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
    __syncthreads();

    // A[t + gridDim.x] lands in X behind the epilogue; X and Y swap
    if (next < n_tiles)
      stage_async(a_inv + (a_src ? a_src[next] : next) * asz, bi, bi, vec,
                  xs);
    if (threadIdx.x == 0) {
      float d = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) d += red[w];
      dots[t] = d;
    }
    store_acc_global(acc, out + t * gsz, bi, bo, vec);
    unsigned char* tmp_region = X;
    X = Y;
    Y = tmp_region;
  }
}

}  // namespace

// Launch on `stream`; a_src and g_src are both null (tile t uses a_inv[t]
// and g_inv[t]) or both int32 arrays of n_tiles pool indices, in range.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int fused_precond_launch(const float* a_inv, const float* g,
                                    const float* g_inv, const int* a_src,
                                    const int* g_src, float* out,
                                    float* dots, int n_tiles, int bi, int bo,
                                    void* stream) {
  if (bi < 1 || bi > NP || bo < 1 || bo > NP || (!a_src) != (!g_src))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_precond_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const bool vec = bi % 4 == 0 && bo % 4 == 0 && aligned(a_inv) &&
                   aligned(g) && aligned(g_inv) && aligned(out);
  const int grid = n_tiles < sms ? n_tiles : sms;
  fused_precond_kernel<<<grid, THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      a_inv, g, g_inv, a_src, g_src, out, dots, n_tiles, bi, bo, vec);
  return static_cast<int>(cudaGetLastError());
}

namespace {

// dots[t] = sum over q of part[t * per + q], in order
__global__ void dots_kernel(const float* __restrict__ part, int per,
                            float* __restrict__ dots, int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  float s = 0.f;
  for (int q = 0; q < per; ++q) s += part[static_cast<size_t>(t) * per + q];
  dots[t] = s;
}

}  // namespace

// Large route: `blocks` fp32 rows x cols blocks (a pool, or a chunk's g)
// into their bf16 hi and lo slices, rows ld16 apart. Returns the
// cudaError_t (0 = success).
extern "C" int fused_precond_split(const float* src, long long blocks,
                                   int rows, int cols, void* hi, void* lo,
                                   int ld16, void* stream) {
  return htma::split_launch(src, blocks, rows, cols,
                            static_cast<long long>(rows) * cols, cols, ld16,
                            static_cast<htma::bf16*>(hi),
                            static_cast<htma::bf16*>(lo),
                            static_cast<cudaStream_t>(stream));
}

// Large route: one of the two products (hilo_tma.cuh; epi STORE for tmp,
// DOT for out and the partial dots). Returns the cudaError_t.
extern "C" int fused_precond_product(const htma::Params* p, void* stream) {
  if (!p || (p->epi != htma::STORE && p->epi != htma::DOT))
    return static_cast<int>(cudaErrorInvalidValue);
  return htma::launch(*p, static_cast<cudaStream_t>(stream));
}

// Large route: dots[t] for t < n from `per` partials a tile.
extern "C" int fused_precond_dots(const float* part, int per, float* dots,
                                  int n, void* stream) {
  if (!part || !dots || per < 1 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dots_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      part, per, dots, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_precond_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
