// Rank-k Sherman-Morrison-Woodbury update of cached block inverses, hi/lo
// bit-sliced: for bs, k <= 128 one CTA per block and one launch a call,
// the k x k solve inside the CTA; for bs or k of 129..1024 the large route
// at the end of this file.
//
// Replaces the Pallas TPU kernel repro/kernels/smw_update.py (_kernel_stats
// and _kernel_apply, called from smw_update, with jnp.linalg.solve between
// the two pallas_calls). Per block, with the cached inverse inv (bs x bs),
// the columns V (k x bs):
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
#include <cstdint>

#include "hilo_tma.cuh"
#include "lu_blocked.cuh"
#include "lu_solve.cuh"

using namespace hilo;
using smw::ILP;
using smw::SLD;
using smw::lu_solve;

namespace {

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

// ---------------------------------------------------------------------------
// Large route: bs or k of 129..1024 (the reference's whole domain). A block
// no longer fits one CTA (a 256 block's inverse alone is 256 KB), so the
// update runs as a sequence of kernels over every block of a chunk, with
// M, Y, S and Z in a workspace that the caller allocates, each value
// stored in the forms its readers take (derived backwards from them): bf16
// hi and lo slices (rows ld16 apart) for a product's operands, fp32 (rows
// ld = the columns rounded up to 4) for the solve and an epilogue's E:
//   smw_update_prep          the caller's inputs into the forms the products
//                            read: M = (inv + inv^T) * (0.5 / decay),
//                            sym_entry's rounding, 32 x 32 tiles through
//                            shared memory, stored as fp32 (out's E, at
//                            out's unpadded rows) and as slices (Y's right
//                            operand); in the same launch (CTAs of their
//                            own) V into its slices by hilo_tma.cuh's
//                            split: Y's left operand, and S's right one
//                            read as stored (k x bs: V^T stored n x k);
//   smw_update_product       hilo_tma.cuh's product: Y = hilo(V, M), stored
//                            as fp32 (the solve's) and as slices (S's left
//                            operand, and out's read as stored: Y^T stored
//                            k x m); S = hilo(Y, V^T) in fp32;
//                            out = M - hilo(Y^T, Z), NEG_ACC writing F (the
//                            caller's output) alone, one rounding;
//   smw_update_solve_slab    k <= 128: Z = (S + I/c)^-1 Y, one CTA a block
//                            and a slab of at most 128 columns of Y, S and
//                            the slab in shared memory, lu_solve as the
//                            one-CTA kernel runs it; Z stored in fp32 and
//                            as its slices (out's right operand);
//   smw_update_lu_panel, smw_update_lu_update, smw_update_lu_back
//                            k of 129..1024: S (up to 4 MB) fits no CTA; a
//                            blocked right-looking LU with partial pivoting
//                            over [S | Z] in the workspace, two launches a
//                            panel of 32 columns and one back substitution
//                            (lu_blocked.cuh), with lu_solve's rules and its
//                            per-element arithmetic: Z bitwise the
//                            unblocked solve's, an exactly singular S
//                            giving a non-finite out without a host check;
//                            the back substitution stores Z's slices too.
// So a chunk takes as many launches as it did with products that split
// their operands as they loaded them: at a few blocks a call is bound by
// its launches.
// The caller issues them in the order of the schedule (kernels/
// smw_update.py, smw_schedule). A block's arithmetic does not depend on its
// chunk, and nothing is summed with atomics, so a call is bitwise its
// repeat.
// What bounds it: bytes at k = 64 (the main path's bs 256 and 176: inv, V
// and out, ~0.79 GB a refresh), against ~75 GFLOP of partials; the design
// moves M, Y, S and Z through device memory (M's slices and fp32 once
// each), the products at the rate of hilo_tma.cuh's wgmma; above k 128
// operations (the products' partials and the LU's k pivot steps, which run
// one after another, one CTA a block).

constexpr int PREP_TILE = 32;
constexpr int SOLVE_SMEM_BYTES = (2 * NP * SLD + NP + 1) * 4;
constexpr int LU_MAX = 1024;   // the reference's largest rank

// M's 32 x 32 tile blockIdx.x of block blockIdx.y, or, for blockIdx.x
// past M's tb x tb tiles, V's split: 256 groups of 8 columns of block
// blockIdx.y's k x bs columns a CTA (v null: no split).
__global__ void __launch_bounds__(PREP_TILE * 8)
smw_prep_kernel(const float* __restrict__ inv, const htma::Out m, int bs,
                int ld32, int ld16, float inv_decay, const float* v, int k,
                bf16* vh, bf16* vl, bool vec) {
  __shared__ float t[PREP_TILE][PREP_TILE + 1], u[PREP_TILE][PREP_TILE + 1];
  const int tb = (bs + PREP_TILE - 1) / PREP_TILE;
  const int tx = threadIdx.x, ty = threadIdx.y;
  if (static_cast<int>(blockIdx.x) >= tb * tb) {
    const long long i =
        (static_cast<long long>(blockIdx.x) - tb * tb) * (PREP_TILE * 8) +
        ty * PREP_TILE + tx;
    if (i < static_cast<long long>(k) * (ld16 / 8)) {
      const size_t blk = blockIdx.y;
      htma::split_group(v + blk * k * bs, static_cast<long long>(k) * bs,
                        bs, k, i, bs, ld16,
                        vh + blk * k * ld16, vl + blk * k * ld16, vec);
    }
    return;
  }
  const int i0 = static_cast<int>(blockIdx.x) / tb * PREP_TILE;
  const int j0 = static_cast<int>(blockIdx.x) % tb * PREP_TILE;
  const float* ib = inv + static_cast<size_t>(blockIdx.y) * bs * bs;
  const size_t row0 = static_cast<size_t>(blockIdx.y) * bs;
  // t: inv's tile (i0, j0); u: its tile (j0, i0)
  for (int r = ty; r < PREP_TILE; r += blockDim.y) {
    const int i = i0 + r, j = j0 + tx;
    t[r][tx] = i < bs && j < bs ? ib[static_cast<size_t>(i) * bs + j] : 0.f;
    const int i2 = j0 + r, j2 = i0 + tx;
    u[r][tx] =
        i2 < bs && j2 < bs ? ib[static_cast<size_t>(i2) * bs + j2] : 0.f;
  }
  __syncthreads();
  for (int r = ty; r < PREP_TILE; r += blockDim.y) {
    const int i = i0 + r, j = j0 + tx;
    if (i >= bs || j >= bs) continue;
    const float val = __fmul_rn(__fadd_rn(t[r][tx], u[tx][r]), inv_decay);
    if (m.f32) m.f32[(row0 + i) * ld32 + j] = val;
    const size_t o = (row0 + i) * ld16 + j;
    if (m.hi) split(val, m.hi[o], m.lo[o]);
  }
}

// Z = (S + I/c)^-1 Y for one block (blockIdx.x) and one slab of at most NP
// columns of Y (blockIdx.y); k <= NP. The diagonal term is added as
// acc + inv_c, as the one-CTA kernel and the plain version add it.
__global__ void __launch_bounds__(THREADS, 1)
smw_solve_slab_kernel(const float* __restrict__ s, int lds,
                      const float* __restrict__ y, float* __restrict__ z,
                      int ldy, int k, int bs, float inv_c, bf16* zh,
                      bf16* zl, int ld16) {
  extern __shared__ __align__(16) float sm[];
  float* S = sm;
  float* B = S + NP * SLD;
  float* scratch = B + NP * SLD;
  const int c0 = static_cast<int>(blockIdx.y) * NP;
  const int cols = bs - c0 < NP ? bs - c0 : NP;
  const size_t blk = blockIdx.x;
  const float* sb = s + blk * k * lds;
  const float* yb = y + blk * k * ldy + c0;
  float* zb = z + blk * k * ldy + c0;
  for (int idx = threadIdx.x; idx < k * k; idx += THREADS) {
    const int i = idx / k, j = idx % k;
    const float v = sb[static_cast<size_t>(i) * lds + j];
    S[i * SLD + j] = i == j ? v + inv_c : v;
  }
  for (int idx = threadIdx.x; idx < k * cols; idx += THREADS) {
    const int i = idx / cols, j = idx % cols;
    B[i * SLD + j] = yb[static_cast<size_t>(i) * ldy + j];
  }
  __syncthreads();
  lu_solve(S, B, k, cols, scratch);
  for (int idx = threadIdx.x; idx < k * cols; idx += THREADS) {
    const int i = idx / cols, j = idx % cols;
    const float val = B[i * SLD + j];
    zb[static_cast<size_t>(i) * ldy + j] = val;
    if (zh) {
      const size_t o = (blk * k + i) * ld16 + c0 + j;
      split(val, zh[o], zl[o]);
    }
  }
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

// Large route: M of the nb blocks of inv (nb, bs, bs) in the forms of m
// (fp32 rows ld32 apart, slices ld16 apart; hi and lo both or neither),
// and the slices of v (nb, k, bs) at vh and vl, rows ld16 apart.
extern "C" int smw_update_prep(const float* inv, const htma::Out* m,
                               const float* v, void* vh, void* vl, int nb,
                               int bs, int k, int ld32, int ld16,
                               float inv_decay, void* stream) {
  if (nb < 1 || bs < 1 || bs > LU_MAX || k < 1 || k > LU_MAX || !inv ||
      !m || (!m->f32 && !m->hi) || (!m->hi) != (!m->lo) || ld32 < bs ||
      ld16 < bs || ld16 % 8 != 0 || nb > 65535 || !v || !vh || !vl ||
      reinterpret_cast<uintptr_t>(vh) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(vl) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int tb = (bs + PREP_TILE - 1) / PREP_TILE;
  const long long groups = static_cast<long long>(k) * (ld16 / 8);
  const int vb = static_cast<int>((groups + PREP_TILE * 8 - 1) /
                                  (PREP_TILE * 8));
  smw_prep_kernel<<<dim3(tb * tb + vb, nb), dim3(PREP_TILE, 8), 0,
                    static_cast<cudaStream_t>(stream)>>>(
      inv, *m, bs, ld32, ld16, inv_decay, v, k, static_cast<bf16*>(vh),
      static_cast<bf16*>(vl),
      htma::split_vec(v, bs, static_cast<long long>(k) * bs, bs));
  return static_cast<int>(cudaGetLastError());
}

// The products' forms: Y = V M (both as stored), S = Y V^T (V stored n x
// k), out = M - Y^T Z (Y stored k x m), each of three partials.
constexpr int PRODUCT_FORMS = htma::form_bit(false, false, 3) |
                              htma::form_bit(false, true, 3) |
                              htma::form_bit(true, false, 3);

// Large route: one product (epilogue STORE, or NEG_ACC for out).
extern "C" int smw_update_product(const htma::Params* p, void* stream) {
  if (!p || (p->epi != htma::STORE && p->epi != htma::NEG_ACC))
    return static_cast<int>(cudaErrorInvalidValue);
  return htma::launch<PRODUCT_FORMS>(*p, static_cast<cudaStream_t>(stream));
}

// Large route, k <= 128: z = (s + I/c)^-1 y for nb blocks, s (k x k, rows
// lds apart), y and z (k x bs, rows ldy apart), one CTA a block and slab;
// z's slices at zh and zl too (rows ld16 apart; both null: not stored).
extern "C" int smw_update_solve_slab(const float* s, int lds, const float* y,
                                     float* z, int ldy, int nb, int k,
                                     int bs, float inv_c, void* zh,
                                     void* zl, int ld16, void* stream) {
  if (nb < 1 || k < 1 || k > NP || bs < 1 || lds < k || ldy < bs || !s ||
      !y || !z || (!zh) != (!zl) || (zh && ld16 < bs))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      smw_solve_slab_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SOLVE_SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  smw_solve_slab_kernel<<<dim3(nb, (bs + NP - 1) / NP), THREADS,
                          SOLVE_SMEM_BYTES,
                          static_cast<cudaStream_t>(stream)>>>(
      s, lds, y, z, ldy, k, bs, inv_c, static_cast<bf16*>(zh),
      static_cast<bf16*>(zl), ld16);
  return static_cast<int>(cudaGetLastError());
}

// Large route, k of 129..1024 (any k of 1..1024 is taken): the blocked LU
// of lu_blocked.cuh, its launches in smw_schedule's order. s (k x k, rows
// lds apart, lds a multiple of 4, 16-byte aligned) is factored in place;
// rows holds k ints a block (ldp apart): the sources of each panel's rows.
static bool lu_args(const float* s, int lds, int nb, int k, int ldp) {
  return s && nb >= 1 && k >= 1 && k <= lub::MAX_K && lds >= k &&
         lds % 4 == 0 && ldp >= k &&
         reinterpret_cast<uintptr_t>(s) % 16 == 0;
}

// The panel [j0, j0 + 32) of every block.
extern "C" int smw_update_lu_panel(float* s, int lds, int* rows, int ldp,
                                   int nb, int k, int j0, float inv_c,
                                   void* stream) {
  if (!lu_args(s, lds, nb, k, ldp) || !rows || j0 < 0 || j0 >= k ||
      j0 % lub::PANEL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nr = k - j0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (nr <= lub::PANEL_THREADS)
    lub::panel_kernel<1><<<nb, (nr + 31) / 32 * 32, 0, st>>>(
        s, lds, rows, ldp, k, j0, inv_c);
  else
    lub::panel_kernel<2><<<nb, ((nr + 1) / 2 + 31) / 32 * 32, 0, st>>>(
        s, lds, rows, ldp, k, j0, inv_c);
  return static_cast<int>(cudaGetLastError());
}

// The panel [j0, j0 + 32) applied to the columns right of it, S's and Z's
// (y, z: k x bs, rows ldy apart; the first panel reads y).
extern "C" int smw_update_lu_update(float* s, int lds, const float* y,
                                    float* z, int ldy, const int* rows,
                                    int ldp, int nb, int k, int bs, int j0,
                                    float inv_c, void* stream) {
  if (!lu_args(s, lds, nb, k, ldp) || !rows || !y || !z || bs < 1 ||
      ldy < bs || j0 < 0 || j0 >= k || j0 % lub::PANEL || nb > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int j1 = j0 + lub::PANEL < k ? j0 + lub::PANEL : k;
  const int slabs = (k - j1 + lub::CW - 1) / lub::CW +
                    (bs + lub::CW - 1) / lub::CW;
  lub::update_kernel<<<dim3(slabs, nb), lub::SLAB_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      s, lds, y, z, ldy, rows, ldp, k, bs, j0, inv_c);
  return static_cast<int>(cudaGetLastError());
}

// Z = U^-1 Z with U the factored s's upper triangle; Z's slices at zh and
// zl too (rows ld16 apart; both null: not stored).
extern "C" int smw_update_lu_back(const float* s, int lds, float* z,
                                  int ldy, int nb, int k, int bs, void* zh,
                                  void* zl, int ld16, void* stream) {
  if (!lu_args(s, lds, nb, k, k) || !z || bs < 1 || ldy < bs ||
      nb > 65535 || (!zh) != (!zl) || (zh && ld16 < bs))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = k * lub::ZLD * 4;
  cudaError_t err = cudaFuncSetAttribute(
      lub::back_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  lub::back_kernel<<<dim3((bs + lub::CW - 1) / lub::CW, nb),
                     lub::SLAB_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      s, lds, z, ldy, k, bs, static_cast<bf16*>(zh), static_cast<bf16*>(zl),
      ld16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* smw_update_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
