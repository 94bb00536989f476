// Rank-k Sherman-Morrison-Woodbury update of cached block inverses, hi/lo
// bit-sliced, one CTA per block in each of two passes.
//
// Replaces the Pallas TPU kernel repro/kernels/smw_update.py (_kernel_stats
// and _kernel_apply, called from smw_update). Per block, with the cached
// inverse inv (bs x bs), the columns V (k x bs), bs, k <= 128:
//   pass 1   M = (inv + inv^T) * (0.5 / decay)
//            Y = V M                          (k x bs, written out)
//            S = Y V^T + I / c                (k x k, written out)
//   between  Z = S^-1 Y                       (torch.linalg.solve, wrapper)
//   pass 2   out = M - Y^T Z                  (bs x bs)
// where every product is the three-partial hi/lo sum P_H Q_H + P_H Q_L +
// P_L Q_H on the tensor cores (bf16 operands split round-to-nearest-even,
// fp32 accumulation), and M is the same fp32 expression in both passes.
//
// Bound: bytes. At the main path's (528, 64, 128) the function must read
// inv and V and write out, 160 KB a block (84 MB, 25 us at 3.35 TB/s), for
// 15.7 MFLOP of partial products (8.3 GFLOP, 8.4 us at 989 TFLOP/s bf16);
// with Y, S and Z crossing device memory between the passes this design
// moves 336 KB a block (177 MB, 53 us).
// Design against that bound: the TPU kernel pads k and bs to 128 and hands
// M from pass 1 to pass 2 through device memory (576 KB a block at k = 64).
// Here k and bs are taken as given and zero-padded in shared memory only
// (exact: zero rows and columns add nothing to any product), and pass 2
// rebuilds M from inv in its epilogue instead of reading it back. Both
// passes stage inv through shared memory as fp32 with a row stride of
// NP + 1 words, so the transposed read of sym(inv) is conflict-free rather
// than a strided global load. Warps whose output rows or columns lie wholly
// outside k skip their products. Four bf16 128x136 tiles (136 KB) per CTA,
// one CTA per SM, mma.sync; fusing the k x k solve between the passes and
// overlapping loads with compute are later work.
#include "hilo_mma.cuh"

using namespace hilo;

namespace {

constexpr int SMEM_BYTES = 4 * TILE_BYTES;
constexpr int SLD = NP + 1;   // fp32 staging row stride (words)
static_assert(NP * SLD * 4 <= 2 * TILE_BYTES, "staging fits two tiles");

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// inv (n x n, row-major) -> fp32 staging tile, row stride SLD.
__device__ __forceinline__ void stage_block(const float* src, int n,
                                            float* st) {
  for (int idx = threadIdx.x; idx < n * n; idx += THREADS)
    st[(idx / n) * SLD + idx % n] = src[idx];
}

// M[i][j] = (inv[i][j] + inv[j][i]) * s from the staged block; rounded
// separately (no contraction) so both passes and the plain version agree.
__device__ __forceinline__ float sym_entry(const float* st, int i, int j,
                                           float s) {
  return __fmul_rn(__fadd_rn(st[i * SLD + j], st[j * SLD + i]), s);
}

__global__ void __launch_bounds__(THREADS, 1)
smw_stats_kernel(const float* __restrict__ inv, const float* __restrict__ v,
                 float* __restrict__ y, float* __restrict__ s, int bs, int k,
                 float inv_decay, float inv_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* MH = reinterpret_cast<bf16*>(smem);    // M, then Y
  bf16* ML = MH + TILE_ELEMS;
  bf16* VH = ML + TILE_ELEMS;                  // staged inv, then V
  bf16* VL = VH + TILE_ELEMS;
  float* st = reinterpret_cast<float*>(VH);

  const size_t blk = blockIdx.x;
  stage_block(inv + blk * bs * bs, bs, st);
  __syncthreads();
  for (int idx = threadIdx.x; idx < NP * NP; idx += THREADS) {
    const int i = idx / NP;
    const int j = idx % NP;
    const float m =
        (i < bs && j < bs) ? sym_entry(st, i, j, inv_decay) : 0.f;
    split(m, MH[i * LDS + j], ML[i * LDS + j]);
  }
  __syncthreads();
  load_split(v + blk * k * bs, k, bs, bs, 0.f, VH, VL);
  __syncthreads();

  // Y = V M  (k x bs, depth bs)
  const int kb = round16(bs);
  Acc acc;
  zero(acc);
  gemm_ex<false, false>(acc, VH, MH, kb, k, bs);
  gemm_ex<false, false>(acc, VH, ML, kb, k, bs);
  gemm_ex<false, false>(acc, VL, MH, kb, k, bs);
  __syncthreads();
  store_split(acc, MH, ML);    // the fp32 Y just formed, split for S
  float* yb = y + blk * k * bs;
  for_each(acc, [&](int r, int c, float& val) {
    if (r < k && c < bs) yb[r * bs + c] = val;
  });
  __syncthreads();

  // S = Y V^T + I/c  (k x k, depth bs; V is stored k x bs = N x K)
  zero(acc);
  gemm_ex<false, true>(acc, MH, VH, kb, k, k);
  gemm_ex<false, true>(acc, MH, VL, kb, k, k);
  gemm_ex<false, true>(acc, ML, VH, kb, k, k);
  float* sb = s + blk * k * k;
  for_each(acc, [&](int r, int c, float& val) {
    if (r < k && c < k) sb[r * k + c] = r == c ? val + inv_c : val;
  });
}

__global__ void __launch_bounds__(THREADS, 1)
smw_apply_kernel(const float* __restrict__ inv, const float* __restrict__ y,
                 const float* __restrict__ z, float* __restrict__ out, int bs,
                 int k, float inv_decay) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* YH = reinterpret_cast<bf16*>(smem);    // Y, then staged inv
  bf16* YL = YH + TILE_ELEMS;
  bf16* ZH = YL + TILE_ELEMS;
  bf16* ZL = ZH + TILE_ELEMS;
  float* st = reinterpret_cast<float*>(YH);

  const size_t blk = blockIdx.x;
  load_split(y + blk * k * bs, k, bs, bs, 0.f, YH, YL);
  load_split(z + blk * k * bs, k, bs, bs, 0.f, ZH, ZL);
  __syncthreads();

  // Y^T Z  (bs x bs, depth k; Y is stored k x bs = K x M)
  const int kd = round16(k);
  Acc acc;
  zero(acc);
  gemm_ex<true, false>(acc, YH, ZH, kd, bs, bs);
  gemm_ex<true, false>(acc, YH, ZL, kd, bs, bs);
  gemm_ex<true, false>(acc, YL, ZH, kd, bs, bs);
  __syncthreads();
  stage_block(inv + blk * bs * bs, bs, st);
  __syncthreads();

  float* ob = out + blk * bs * bs;
  for_each(acc, [&](int r, int c, float& val) {
    if (r < bs && c < bs)
      ob[r * bs + c] = __fsub_rn(sym_entry(st, r, c, inv_decay), val);
  });
}

template <class Kernel>
int set_smem(Kernel kernel) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES));
}

}  // namespace

// Pass 1 on `stream`: y (nb, k, bs) and s (nb, k, k) from inv (nb, bs, bs)
// and v (nb, k, bs). Returns the cudaError_t of the launch (0 = success).
extern "C" int smw_update_stats_launch(const float* inv, const float* v,
                                       float* y, float* s, int nb, int bs,
                                       int k, float inv_decay, float inv_c,
                                       void* stream) {
  if (bs < 1 || bs > NP || k < 1 || k > NP)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(smw_stats_kernel);
  if (err != 0) return err;
  smw_stats_kernel<<<nb, THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      inv, v, y, s, bs, k, inv_decay, inv_c);
  return static_cast<int>(cudaGetLastError());
}

// Pass 2 on `stream`: out (nb, bs, bs) = M - y^T z with z = s^-1 y.
extern "C" int smw_update_apply_launch(const float* inv, const float* y,
                                       const float* z, float* out, int nb,
                                       int bs, int k, float inv_decay,
                                       void* stream) {
  if (bs < 1 || bs > NP || k < 1 || k > NP)
    return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(smw_apply_kernel);
  if (err != 0) return err;
  smw_apply_kernel<<<nb, THREADS, SMEM_BYTES,
                     static_cast<cudaStream_t>(stream)>>>(
      inv, y, z, out, bs, k, inv_decay);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* smw_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
