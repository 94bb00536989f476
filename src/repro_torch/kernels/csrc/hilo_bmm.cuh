// Batched, tiled hi/lo product on the tensor cores with fused epilogues:
// the large-block route of smw_update.cu and fused_gram_solve.cu's Gram
// (blocks and ranks of 129..1024), where one block no longer fits one
// CTA's shared memory (a 256 block's hi/lo pair is 256 KB against 227 KB a
// CTA may have). neumann_inv.cu's and fused_precond.cu's large routes run
// on hilo_tma.cuh's product: their operands are stored split, by the
// kernel that writes them; these routes' operands are not.
//
// One launch computes, for every batch entry b and every 64 x 64 tile of
// the M x N result,
//   acc = op(L)_H op(R)_H + op(L)_H op(R)_L + op(L)_L op(R)_H
//         (M x K times K x N, fp32 accumulation)
// and writes epilogue(acc) into C[b]. Operands are fp32 (or, for the Gram
// of bf16 activations, bf16: converted to fp32 as they are read, so their
// lo slice is exactly zero) in device memory (row-major, any leading
// dimension, block b at base + idx[b] * stride, or b * stride without an
// index array) and are split into bf16 hi/lo slices as they are staged
// into shared memory: splitting on load is bitwise what storing the split
// and loading it gives, and moves the same bytes an entry. op(L) is L, or
// with the template flag LT the transpose of L stored K x M; op(R) is R, or
// with RT the transpose of R stored N x K. A transposed operand is loaded
// along its contiguous side like any other and staged in its stored
// layout; ldmatrix's other form (.trans or not) delivers the same mma
// fragments from it. Entries outside M x K and K x N are read as zero
// (the zero pad of the one-CTA kernels, in shared memory only), so a side
// such as 176 = 11 x 16 is exact, and nothing outside M x N is written.
//
// Epilogues (E an M x N block):
//   STORE  C = acc                  (the Woodbury Y and S; the Gram)
//   SUB    C = E - acc              (the Woodbury correction M - Y^T Z, one
//                                    rounding)
//
// Bound: operations at the K-FAC shapes (a 256 block's product is 2 x
// 256^3 a partial against 768 KB of fp32 operands, ~85 FLOP a byte from
// device memory but each operand tile is re-read by every tile of its row
// or column, from L2). Design, simple first: 64 x 64 output tiles, 4 warps
// of 32 x 32 on mma.sync m16n8k16 (hilo_mma.cuh's fragments and loads),
// depth steps of 32 double-buffered in shared memory, the next step's
// global loads held in registers while this step's products run, one
// barrier a step; 39 KB of static shared memory, several CTAs an SM. The
// re-reads and the splits on every load hold it near 56 TFLOP/s on the
// H100 (PERF.md, section 6); moving smw_update's products and the Gram
// onto hilo_tma.cuh's product, as fused_precond's moved, is later work.
#pragma once

#include <type_traits>

#include "hilo_mma.cuh"

namespace bmm {

using hilo::bf16;

constexpr int BM = 64, BN = 64, BK = 32;
constexpr int THREADS = 128;
constexpr int LDA = BK + 8;  // left tiles BM x BK, row stride (bf16)
constexpr int LDB = BN + 8;  // right tiles BK x BN, row stride (bf16)

// The left operand's mode: FULL, its two slices (the only one these routes
// use; the C entries check it). Epilogues keep their numbers.
enum Mode { FULL = 0 };
enum Epi { STORE = 0, SUB = 6 };

// An operand: block b at p + (idx ? idx[b] : b) * stride elements (fp32,
// or bf16 where the kernel's element type says so), rows ld apart. vec:
// ld % 4 == 0, stride % 4 == 0 and p 16-byte aligned (loads of four
// entries; four that straddle the last column are masked, which reads
// inside the row because ld >= the columns rounded up to 4).
struct Operand {
  const float* p;
  const int* idx;
  long long stride;
  int ld;
  int vec;
};

struct Params {
  Operand L, R;
  float* C;
  long long c_stride;
  int ldc;
  const float* E;  // SUB: the M block read
  long long e_stride;
  int lde;
  int M, N, K, batch;
  int c_vec;       // C, E, F 8-byte aligned, even ld and strides
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// Four entries of row r from column c on, as fp32 (zeros outside rows x
// cols).
template <typename T>
__device__ __forceinline__ float4 load4(const T* __restrict__ base, int ld,
                                        int rows, int cols, int r, int c,
                                        bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r < rows && c < cols) {
    const T* s = base + static_cast<size_t>(r) * ld + c;
    if (vec) {
      if constexpr (std::is_same<T, float>::value) {
        v = *reinterpret_cast<const float4*>(s);
      } else {
        const uint2 q = *reinterpret_cast<const uint2*>(s);
        const float2 a = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&q.x));
        const float2 b = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&q.y));
        v = make_float4(a.x, a.y, b.x, b.y);
      }
      if (c + 1 >= cols) v.y = 0.f;
      if (c + 2 >= cols) v.z = 0.f;
      if (c + 3 >= cols) v.w = 0.f;
    } else {
      v.x = to_f32(s[0]);
      if (c + 1 < cols) v.y = to_f32(s[1]);
      if (c + 2 < cols) v.z = to_f32(s[2]);
      if (c + 3 < cols) v.w = to_f32(s[3]);
    }
  }
  return v;
}

__device__ __forceinline__ void split4(const float4 v, uint2& h, uint2& l) {
  hilo::split2(v.x, v.y, h.x, l.x);
  hilo::split2(v.z, v.w, h.y, l.y);
}

// The left tile is staged as stored: BM x BK (row stride LDA), or with LT
// BK x BM (row stride LDB); the right tile BK x BN (LDB), or with RT
// BN x BK (LDA).
template <bool TR>
__host__ __device__ constexpr int left_elems() {
  return TR ? BK * LDB : BM * LDA;
}
template <bool TR>
__host__ __device__ constexpr int right_elems() {
  return TR ? BN * LDA : BK * LDB;
}

template <int EPI, bool LT = false, bool RT = false, typename T = float>
__global__ void __launch_bounds__(THREADS)
hilo_bmm_kernel(const __grid_constant__ Params p) {
  __shared__ __align__(16) bf16 sLH[2][left_elems<LT>()];
  __shared__ __align__(16) bf16 sLL[2][left_elems<LT>()];
  __shared__ __align__(16) bf16 sRH[2][right_elems<RT>()];
  __shared__ __align__(16) bf16 sRL[2][right_elems<RT>()];

  const int tm = (p.M + BM - 1) / BM, tn = (p.N + BN - 1) / BN;
  const int tile = static_cast<int>(blockIdx.x % (tm * tn));
  const int b = static_cast<int>(blockIdx.x / (tm * tn));
  const int i0 = (tile / tn) * BM, j0 = (tile % tn) * BN;
  const T* Lb = reinterpret_cast<const T*>(p.L.p) +
                static_cast<size_t>(p.L.idx ? p.L.idx[b] : b) *
                    static_cast<size_t>(p.L.stride);
  const T* Rb = reinterpret_cast<const T*>(p.R.p) +
                static_cast<size_t>(p.R.idx ? p.R.idx[b] : b) *
                    static_cast<size_t>(p.R.stride);
  const bool lvec = p.L.vec, rvec = p.R.vec;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int r16 = lane & 15, c8 = (lane >> 4) * 8;           // plain
  const int r8 = (lane & 7) + ((lane >> 4) << 3);              // swapped
  const int s8 = ((lane >> 3) & 1) * 8;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // this thread's four slots of four entries of each staged tile, in the
  // operand's stored layout: a BM x BK tile (64 rows of 8 slots; the left
  // tile, or the right one with RT) or a BK x BN tile (32 rows of 16; the
  // right tile, or the left one with LT)
  float4 gl[4], gr[4];
  auto gload = [&](int k0) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = tid + s * THREADS;
      if constexpr (LT)
        gl[s] = load4(Lb, p.L.ld, p.K, p.M, k0 + (q >> 4),
                      i0 + (q & 15) * 4, lvec);
      else
        gl[s] = load4(Lb, p.L.ld, p.M, p.K, i0 + (q >> 3),
                      k0 + (q & 7) * 4, lvec);
      if constexpr (RT)
        gr[s] = load4(Rb, p.R.ld, p.N, p.K, j0 + (q >> 3),
                      k0 + (q & 7) * 4, rvec);
      else
        gr[s] = load4(Rb, p.R.ld, p.K, p.N, k0 + (q >> 4),
                      j0 + (q & 15) * 4, rvec);
    }
  };
  auto sstore = [&](int buf) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int q = tid + s * THREADS;
      uint2 h, l;
      split4(gl[s], h, l);
      const int lo = LT ? (q >> 4) * LDB + (q & 15) * 4
                        : (q >> 3) * LDA + (q & 7) * 4;
      *reinterpret_cast<uint2*>(&sLH[buf][lo]) = h;
      *reinterpret_cast<uint2*>(&sLL[buf][lo]) = l;
      split4(gr[s], h, l);
      const int ro = RT ? (q >> 3) * LDA + (q & 7) * 4
                        : (q >> 4) * LDB + (q & 15) * 4;
      *reinterpret_cast<uint2*>(&sRH[buf][ro]) = h;
      *reinterpret_cast<uint2*>(&sRL[buf][ro]) = l;
    }
  };

  const int kt_n = (p.K + BK - 1) / BK;
  gload(0);
  sstore(0);
  __syncthreads();
  for (int kt = 0; kt < kt_n; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < kt_n) gload((kt + 1) * BK);
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks) {
      const int k0 = ks * 16;
      uint32_t ah[2][4], al[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        if constexpr (LT) {
          const int off = (k0 + r8) * LDB + wm + mi * 16 + s8;
          hilo::ldmatrix_x4_trans(ah[mi], &sLH[cur][off]);
          hilo::ldmatrix_x4_trans(al[mi], &sLL[cur][off]);
        } else {
          const int off = (wm + mi * 16 + r16) * LDA + k0 + c8;
          hilo::ldmatrix_x4(ah[mi], &sLH[cur][off]);
          hilo::ldmatrix_x4(al[mi], &sLL[cur][off]);
        }
      }
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t bh[4], bl[4];
        if constexpr (RT) {
          const int off = (wn + nj * 16 + r8) * LDA + k0 + s8;
          hilo::ldmatrix_x4(bh, &sRH[cur][off]);
          hilo::ldmatrix_x4(bl, &sRL[cur][off]);
        } else {
          const int off = (k0 + r16) * LDB + wn + nj * 16 + c8;
          hilo::ldmatrix_x4_trans(bh, &sRH[cur][off]);
          hilo::ldmatrix_x4_trans(bl, &sRL[cur][off]);
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          hilo::mma_16816(acc[mi][2 * nj], ah[mi], bh[0], bh[1]);
          hilo::mma_16816(acc[mi][2 * nj + 1], ah[mi], bh[2], bh[3]);
          hilo::mma_16816(acc[mi][2 * nj], ah[mi], bl[0], bl[1]);
          hilo::mma_16816(acc[mi][2 * nj + 1], ah[mi], bl[2], bl[3]);
          hilo::mma_16816(acc[mi][2 * nj], al[mi], bh[0], bh[1]);
          hilo::mma_16816(acc[mi][2 * nj + 1], al[mi], bh[2], bh[3]);
        }
      }
    }
    if (kt + 1 < kt_n) sstore(cur ^ 1);
    __syncthreads();
  }

  // epilogue from the accumulators: thread element (mi, ni, e) is row
  // wm + 16 mi + lane / 4 + 8 (e / 2), column wn + 8 ni + 2 (lane % 4) +
  // e % 2 of the tile
  float* Cb = p.C + static_cast<size_t>(b) * static_cast<size_t>(p.c_stride);
  const size_t eo = static_cast<size_t>(b) * static_cast<size_t>(p.e_stride);
  constexpr bool READS_E = EPI == SUB;
  const float* Eb = READS_E ? p.E + eo : nullptr;
  const bool v2 = p.c_vec;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = i0 + wm + mi * 16 + (lane >> 2) + h * 8;
        const int c = j0 + wn + ni * 8 + (lane & 3) * 2;
        if (r >= p.M || c >= p.N) continue;
        const bool two = c + 1 < p.N;
        float v[2] = {acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]};
        float e[2] = {0.f, 0.f};
        if constexpr (READS_E) {
          const float* s = Eb + static_cast<size_t>(r) * p.lde + c;
          if (v2 && two) {
            const float2 q = *reinterpret_cast<const float2*>(s);
            e[0] = q.x;
            e[1] = q.y;
          } else {
            e[0] = s[0];
            if (two) e[1] = s[1];
          }
        }
        if constexpr (EPI == SUB) {
          v[0] = __fsub_rn(e[0], v[0]);
          v[1] = __fsub_rn(e[1], v[1]);
        }
        float* d = Cb + static_cast<size_t>(r) * p.ldc + c;
        if (v2 && two) {
          *reinterpret_cast<float2*>(d) = make_float2(v[0], v[1]);
        } else {
          d[0] = v[0];
          if (two) d[1] = v[1];
        }
      }
}

// Enqueue hilo_bmm_kernel<EPI, LT, RT, T> over every tile of every batch
// entry; returns the cudaError_t of the launch.
template <int EPI, bool LT = false, bool RT = false, typename T = float>
inline int launch(const Params& p, cudaStream_t stream) {
  const long long tiles = static_cast<long long>(p.batch) *
                          ((p.M + BM - 1) / BM) * ((p.N + BN - 1) / BN);
  if (tiles < 1 || tiles > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  hilo_bmm_kernel<EPI, LT, RT, T>
      <<<static_cast<unsigned>(tiles), THREADS, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

inline bool valid(const Params& p) {
  return p.M >= 1 && p.N >= 1 && p.K >= 1 && p.batch >= 1 && p.L.p &&
         p.R.p && p.C;
}

}  // namespace bmm
