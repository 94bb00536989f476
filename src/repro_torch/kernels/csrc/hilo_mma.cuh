// Shared building blocks of the port's hi/lo bf16 kernels (sm_90a).
//
// One CTA of 8 warps owns one square problem of at most NP x NP = 128 x 128
// and computes every product of it on the tensor cores with mma.sync
// m16n8k16 (bf16 operands, fp32 accumulation). Operands live in shared
// memory as bf16 hi/lo slices, row-major with a padded row stride LDS so
// that ldmatrix rows land on distinct banks. Problems smaller than NP are
// zero-padded inside shared memory only: zero rows and columns add nothing
// to any product, so the result on the n x n corner is the unpadded one.
//
// Warp tiling of the 128 x 128 output: warp w owns rows (w / 2) * 32 .. +32
// and columns (w % 2) * 64 .. +64, i.e. 2 x 8 mma tiles of 16 x 8, which is
// 64 fp32 accumulators per thread.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hilo {

constexpr int NP = 128;            // largest problem side a CTA takes
constexpr int LDS = NP + 8;        // padded row stride (bf16 elements)
constexpr int THREADS = 256;       // 8 warps
constexpr int TILE_ELEMS = NP * LDS;
constexpr int TILE_BYTES = TILE_ELEMS * 2;

typedef __nv_bfloat16 bf16;
typedef float Acc[2][8][4];

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void zero(Acc acc) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
}

// acc += L @ R over the full NP depth; L and R are NP x NP bf16 tiles
// (row-major, stride LDS). L fragments come from ldmatrix, R fragments
// from ldmatrix.trans (R is stored k-major, the mma wants it n-major).
__device__ __forceinline__ void gemm(Acc acc, const bf16* L, const bf16* R) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp >> 1) * 32;
  const int n0 = (warp & 1) * 64;
  const int lrow = lane & 15;
  const int lcol = (lane >> 4) * 8;
#pragma unroll 2
  for (int k0 = 0; k0 < NP; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldmatrix_x4(a[mi], L + (m0 + mi * 16 + lrow) * LDS + k0 + lcol);
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, R + (k0 + lrow) * LDS + n0 + nj * 16 + lcol);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_16816(acc[mi][2 * nj], a[mi], b[0], b[1]);
        mma_16816(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// acc += op(L) @ op(R) for a product of M x K by K x N inside the NP x NP
// tiles, over the depth kd (a multiple of 16, at most NP). op(L) is L
// (stored M x K) or, with LT, the transpose of L stored K x M; op(R) is R
// (stored K x N) or, with RT, the transpose of R stored N x K. Either
// transpose costs nothing: ldmatrix.trans (resp. plain ldmatrix) delivers
// the same mma fragments from the other layout. Warps whose 32 output rows
// start at or past mr, and 16-column slabs at or past nc, skip their
// products (their accumulators stay as they were); all operand entries
// outside mr x kd and kd x nc that are read must be zero.
template <bool LT, bool RT>
__device__ __forceinline__ void gemm_ex(Acc acc, const bf16* L, const bf16* R,
                                        int kd, int mr, int nc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp >> 1) * 32;
  const int n0 = (warp & 1) * 64;
  if (m0 >= mr || n0 >= nc) return;
  // row / column offsets of this lane's ldmatrix address
  const int r16 = lane & 15, c8 = (lane >> 4) * 8;                 // plain
  const int r8 = (lane & 7) + ((lane >> 4) << 3);                  // swapped
  const int s8 = ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < kd; k0 += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (LT)
        ldmatrix_x4_trans(a[mi], L + (k0 + r8) * LDS + m0 + mi * 16 + s8);
      else
        ldmatrix_x4(a[mi], L + (m0 + mi * 16 + r16) * LDS + k0 + c8);
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n = n0 + nj * 16;
      if (n >= nc) continue;
      uint32_t b[4];
      if (RT)
        ldmatrix_x4(b, R + (n + r8) * LDS + k0 + s8);
      else
        ldmatrix_x4_trans(b, R + (k0 + r16) * LDS + n + c8);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_16816(acc[mi][2 * nj], a[mi], b[0], b[1]);
        mma_16816(acc[mi][2 * nj + 1], a[mi], b[2], b[3]);
      }
    }
  }
}

// acc += op(LH) op(RH) + op(LH) op(RL) + op(LL) op(RH): the three hi/lo
// partial products of one fp32 product, each fragment loaded once and used
// for every partial it enters (three mma.sync per fragment pair). Layouts,
// depth and masks as in gemm_ex; LDL and LDR are the row strides of the
// L and R tiles (bf16 elements; rows 16-byte aligned).
template <bool LT, bool RT, int LDL = LDS, int LDR = LDS>
__device__ __forceinline__ void gemm3(Acc acc, const bf16* LH, const bf16* LL,
                                      const bf16* RH, const bf16* RL, int kd,
                                      int mr, int nc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp >> 1) * 32;
  const int n0 = (warp & 1) * 64;
  if (m0 >= mr || n0 >= nc) return;
  const int r16 = lane & 15, c8 = (lane >> 4) * 8;
  const int r8 = (lane & 7) + ((lane >> 4) << 3);
  const int s8 = ((lane >> 3) & 1) * 8;
  for (int k0 = 0; k0 < kd; k0 += 16) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      if (LT) {
        const int off = (k0 + r8) * LDL + m0 + mi * 16 + s8;
        ldmatrix_x4_trans(ah[mi], LH + off);
        ldmatrix_x4_trans(al[mi], LL + off);
      } else {
        const int off = (m0 + mi * 16 + r16) * LDL + k0 + c8;
        ldmatrix_x4(ah[mi], LH + off);
        ldmatrix_x4(al[mi], LL + off);
      }
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      const int n = n0 + nj * 16;
      if (n >= nc) continue;
      uint32_t bh[4], bl[4];
      if (RT) {
        const int off = (n + r8) * LDR + k0 + s8;
        ldmatrix_x4(bh, RH + off);
        ldmatrix_x4(bl, RL + off);
      } else {
        const int off = (k0 + r16) * LDR + n + c8;
        ldmatrix_x4_trans(bh, RH + off);
        ldmatrix_x4_trans(bl, RL + off);
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_16816(acc[mi][2 * nj], ah[mi], bh[0], bh[1]);
        mma_16816(acc[mi][2 * nj + 1], ah[mi], bh[2], bh[3]);
        mma_16816(acc[mi][2 * nj], ah[mi], bl[0], bl[1]);
        mma_16816(acc[mi][2 * nj + 1], ah[mi], bl[2], bl[3]);
        mma_16816(acc[mi][2 * nj], al[mi], bh[0], bh[1]);
        mma_16816(acc[mi][2 * nj + 1], al[mi], bh[2], bh[3]);
      }
    }
  }
}

// f(row, col, value&) over this thread's accumulator elements.
template <class F>
__device__ __forceinline__ void for_each(Acc acc, F f) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp >> 1) * 32 + (lane >> 2);
  const int n0 = (warp & 1) * 64 + (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        f(m0 + mi * 16 + (e >> 1) * 8, n0 + ni * 8 + (e & 1),
          acc[mi][ni][e]);
}

// hi = bf16(v) (round to nearest even), lo = bf16(v - hi).
__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// Write the hi/lo slices of this thread's accumulators into H and L.
__device__ __forceinline__ void store_split(Acc acc, bf16* H, bf16* L) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp >> 1) * 32 + (lane >> 2);
  const int n0 = (warp & 1) * 64 + (lane & 3) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int off = (m0 + mi * 16 + h * 8) * LDS + n0 + ni * 8;
        bf16 h0, l0, h1, l1;
        split(acc[mi][ni][2 * h], h0, l0);
        split(acc[mi][ni][2 * h + 1], h1, l1);
        *reinterpret_cast<__nv_bfloat162*>(H + off) = __halves2bfloat162(h0, h1);
        *reinterpret_cast<__nv_bfloat162*>(L + off) = __halves2bfloat162(l0, l1);
      }
}

// Load an fp32 rows x cols row-major matrix (leading dimension ld) as hi/lo
// slices into the NP x NP tiles H and L, zero outside rows x cols. `diag`
// is added to the diagonal of the loaded part.
__device__ __forceinline__ void load_split(const float* src, int rows,
                                           int cols, int ld, float diag,
                                           bf16* H, bf16* L) {
  for (int idx = threadIdx.x; idx < NP * NP; idx += THREADS) {
    const int i = idx / NP;
    const int j = idx % NP;
    float v = 0.f;
    if (i < rows && j < cols) {
      v = src[i * ld + j];
      if (i == j) v += diag;
    }
    bf16 h, l;
    split(v, h, l);
    H[i * LDS + j] = h;
    L[i * LDS + j] = l;
  }
}

}  // namespace hilo
