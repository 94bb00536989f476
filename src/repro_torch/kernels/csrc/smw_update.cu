// Rank-k Sherman-Morrison-Woodbury update of cached block inverses, hi/lo
// bit-sliced, one CTA per block and one launch a call, the k x k solve
// inside the CTA.
//
// Replaces the Pallas TPU kernel repro/kernels/smw_update.py (_kernel_stats
// and _kernel_apply, called from smw_update, with jnp.linalg.solve between
// the two pallas_calls). Per block, with the cached inverse inv (bs x bs),
// the columns V (k x bs), bs, k <= 128:
//   M   = (inv + inv^T) * (0.5 / decay)
//   Y   = V M                              (k x bs)
//   S   = Y V^T + I / c                    (k x k, fp32)
//   Z   = S^-1 Y                           (LU with partial pivoting, fp32)
//   out = M - Y^T Z                        (bs x bs)
// where every product is the three-partial hi/lo sum P_H Q_H + P_H Q_L +
// P_L Q_H on the tensor cores (bf16 operands split round-to-nearest-even,
// fp32 accumulation), and M is the same fp32 expression both times.
//
// Bound: bytes. At the main path's (528, 64, 128) the function must read
// inv and V and write out, 160 KB a block (84 MB, 25 us at 3.35 TB/s), for
// 15.7 MFLOP of partial products a block (8.3 GFLOP, 8.4 us at 989 TFLOP/s
// bf16) and the solve's 0.7 MFLOP of fp32 (0.35 GFLOP, 5.3 us at 67
// TFLOP/s).
// Design against that bound: the TPU program solves between its two
// pallas_calls because Pallas could not solve in VMEM, so Y, S and Z cross
// device memory; a two-pass port around torch.linalg.solve_ex does the
// same, and there the solve takes most of the call. Here Y, S and Z never
// leave the SM: the capacitance (at most 128 x 129 fp32, 66 KB) fits in
// shared memory, and one CTA factors it with partial pivoting (a warp
// finds each pivot, the CTA swaps and eliminates across [S | Y], threads
// across columns) and back-substitutes over the k x bs right-hand side.
// LU, not Cholesky: S is SPD only if sym(inv) is, and the run's
// unconverged cached inverses need not be; an exactly singular S gives a
// non-finite out, as torch.linalg.solve_ex does, which the SMW gate reads
// as a non-finite drift. inv is read twice (for M, and again for the
// epilogue's M, an L2 hit: its fp32 staging holds Y and Z in between).
// Shared memory, 205,828 B (one CTA per SM, 8 warps, mma.sync):
//   R0  two bf16 128 x 136 tiles   M hi/lo, then Y hi/lo
//   R1  two bf16 128 x 136 tiles   V hi/lo, then S (fp32, stride 129),
//                                  then Z hi/lo
//   R2  fp32 128 x 129             inv, then Y -> Z (the solve in place),
//                                  then inv again
// Warps whose output rows or columns lie wholly outside k skip their
// products; k and bs are taken as given and zero-padded in shared memory
// only (exact: zero rows and columns add nothing to any product).
// What holds it back now: the k pivot steps of the LU run one after
// another, each a short chain of shared-memory accesses between two
// __syncthreads, on one CTA per SM; the bytes are a small share.
#include "hilo_mma.cuh"

using namespace hilo;

namespace {

constexpr int SLD = NP + 1;   // fp32 row stride (words)
constexpr int ILP = 8;        // rows a thread updates between stores
constexpr int SMEM_BYTES = 4 * TILE_BYTES + NP * SLD * 4 + (NP + 1) * 4;
static_assert(NP * SLD * 4 <= 2 * TILE_BYTES, "S fits two tiles");

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// inv (n x n, row-major) -> fp32 staging tile, row stride SLD.
__device__ __forceinline__ void stage_block(const float* src, int n,
                                            float* st) {
  for (int i = threadIdx.x >> 5; i < n; i += THREADS / 32)
    for (int j = threadIdx.x & 31; j < n; j += 32)
      st[i * SLD + j] = src[i * n + j];
}

// M[i][j] = (inv[i][j] + inv[j][i]) * s from the staged block; rounded
// separately (no contraction) so both uses and the plain version agree.
__device__ __forceinline__ float sym_entry(const float* st, int i, int j,
                                           float s) {
  return __fmul_rn(__fadd_rn(st[i * SLD + j], st[j * SLD + i]), s);
}

// Z = S^-1 B in place: S (k x k) and B (k x bs), both row stride SLD in
// shared memory; k + bs <= THREADS. LU with partial pivoting (the first
// largest |pivot| of the column), the forward substitution folded into the
// elimination. At step j a warp finds the pivot row p; then each thread
// owns one column of [S | B] right of j, swaps rows j and p in it and
// eliminates below row j with multipliers S[i][j] / S[p][j] (taken as a
// product with the pivot's reciprocal, as LAPACK's getf2 scales them), read
// from column j, which nobody writes during the step: no thread waits on
// another inside a step. U's diagonal goes to udiag (column j keeps its
// unswapped values). Back substitution: a thread per column of B.
__device__ void lu_solve(float* S, float* B, int k, int bs, float* scratch) {
  int* piv = reinterpret_cast<int*>(scratch);
  float* udiag = scratch + 1;
  const int lane = threadIdx.x & 31;
  for (int j = 0; j < k; ++j) {
    if (threadIdx.x < 32) {
      float best = -1.f;
      int p = j;
      for (int i = j + lane; i < k; i += 32) {
        const float a = fabsf(S[i * SLD + j]);
        if (a > best) {
          best = a;
          p = i;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int op = __shfl_xor_sync(0xffffffffu, p, off);
        if (ob > best || (ob == best && op < p)) {
          best = ob;
          p = op;
        }
      }
      if (lane == 0) {
        *piv = p;
        udiag[j] = S[p * SLD + j];
      }
    }
    __syncthreads();
    const int p = *piv;
    const float r = 1.f / udiag[j];
    const int ws = k - j - 1;          // S columns right of j
    if (threadIdx.x < ws + bs) {
      float* col = threadIdx.x < ws ? S + j + 1 + threadIdx.x
                                    : B + threadIdx.x - ws;
      const float top = col[p * SLD];
      const float was = col[j * SLD];
      col[j * SLD] = top;
      col[p * SLD] = was;
      // rows in batches of ILP: all loads of a batch before its stores
      for (int i0 = j + 1; i0 < k; i0 += ILP) {
        float l[ILP], x[ILP];
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          const int i = i0 + u < k ? i0 + u : j;
          l[u] = S[(i == p ? j : i) * SLD + j] * r;
          x[u] = col[i * SLD];
        }
#pragma unroll
        for (int u = 0; u < ILP; ++u)
          if (i0 + u < k) col[(i0 + u) * SLD] = x[u] - l[u] * top;
      }
    }
    __syncthreads();
  }
  if (threadIdx.x < bs) {
    float* col = B + threadIdx.x;
    for (int j = k - 1; j >= 0; --j) {
      const float x = col[j * SLD] / udiag[j];
      col[j * SLD] = x;
      for (int i0 = 0; i0 < j; i0 += ILP) {
        float u_[ILP], y[ILP];
#pragma unroll
        for (int u = 0; u < ILP; ++u) {
          const int i = i0 + u < j ? i0 + u : 0;
          u_[u] = S[i * SLD + j];
          y[u] = col[i * SLD];
        }
#pragma unroll
        for (int u = 0; u < ILP; ++u)
          if (i0 + u < j) col[(i0 + u) * SLD] = y[u] - u_[u] * x;
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
smw_update_kernel(const float* __restrict__ inv, const float* __restrict__ v,
                  float* __restrict__ out, int bs, int k, float inv_decay,
                  float inv_c) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* MH = reinterpret_cast<bf16*>(smem);    // R0: M, then Y
  bf16* ML = MH + TILE_ELEMS;
  bf16* VH = ML + TILE_ELEMS;                  // R1: V, then S, then Z
  bf16* VL = VH + TILE_ELEMS;
  float* sf = reinterpret_cast<float*>(VH);
  float* st = reinterpret_cast<float*>(VL + TILE_ELEMS);  // R2
  float* scratch = st + NP * SLD;   // pivot row, U's diagonal

  const size_t blk = blockIdx.x;
  const float* ib = inv + blk * bs * bs;
  stage_block(ib, bs, st);
  __syncthreads();
  for (int idx = threadIdx.x; idx < NP * NP; idx += THREADS) {
    const int i = idx / NP;
    const int j = idx % NP;
    const float m =
        (i < bs && j < bs) ? sym_entry(st, i, j, inv_decay) : 0.f;
    split(m, MH[i * LDS + j], ML[i * LDS + j]);
  }
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
  store_split(acc, MH, ML);    // Y's slices over M's
  for_each(acc, [&](int r, int c, float& val) {
    if (r < k && c < bs) st[r * SLD + c] = val;   // Y's fp32 over inv
  });
  __syncthreads();

  // S = Y V^T + I/c  (k x k, depth bs; V is stored k x bs = N x K)
  zero(acc);
  gemm_ex<false, true>(acc, MH, VH, kb, k, k);
  gemm_ex<false, true>(acc, MH, VL, kb, k, k);
  gemm_ex<false, true>(acc, ML, VH, kb, k, k);
  __syncthreads();
  for_each(acc, [&](int r, int c, float& val) {
    if (r < k && c < k) sf[r * SLD + c] = r == c ? val + inv_c : val;
  });
  __syncthreads();

  // Z = S^-1 Y, in place of Y
  lu_solve(sf, st, k, bs, scratch);

  // Z's slices over S
  for (int idx = threadIdx.x; idx < NP * NP; idx += THREADS) {
    const int i = idx / NP;
    const int j = idx % NP;
    split(i < k && j < bs ? st[i * SLD + j] : 0.f, VH[i * LDS + j],
          VL[i * LDS + j]);
  }
  __syncthreads();

  // Y^T Z  (bs x bs, depth k; Y is stored k x bs = K x M)
  const int kd = round16(k);
  zero(acc);
  gemm_ex<true, false>(acc, MH, VH, kd, bs, bs);
  gemm_ex<true, false>(acc, MH, VL, kd, bs, bs);
  gemm_ex<true, false>(acc, ML, VH, kd, bs, bs);
  stage_block(ib, bs, st);
  __syncthreads();

  float* ob = out + blk * bs * bs;
  for_each(acc, [&](int r, int c, float& val) {
    if (r < bs && c < bs)
      ob[r * bs + c] = __fsub_rn(sym_entry(st, r, c, inv_decay), val);
  });
}

}  // namespace

// One launch on `stream`: out (nb, bs, bs) from inv (nb, bs, bs) and
// v (nb, k, bs). Returns the cudaError_t of the launch (0 = success).
extern "C" int smw_update_launch(const float* inv, const float* v,
                                 float* out, int nb, int bs, int k,
                                 float inv_decay, float inv_c,
                                 void* stream) {
  if (bs < 1 || bs > NP || k < 1 || k > NP)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      smw_update_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  smw_update_kernel<<<nb, THREADS, SMEM_BYTES,
                      static_cast<cudaStream_t>(stream)>>>(
      inv, v, out, bs, k, inv_decay, inv_c);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* smw_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
