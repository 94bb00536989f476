// Shared building blocks of the port's mma.sync hi/lo bf16 kernels (sm_90a):
// fused_precond.cu and smw_update.cu. The composed inverse (composed_inv.cuh,
// for neumann_inv.cu and fused_gram_solve.cu) runs on wgmma (wgmma.cuh) and
// takes only split2 and the cp.async helpers from here; bitslice_mm.cu runs
// on wgmma too and takes only split2.
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

// gemm3 over the full NP depth with no masks (operands zero-padded): the
// same products added in the same order, with the k loop unrolled and the
// next k-step's L fragments loaded while this step's products run.
__device__ __forceinline__ void gemm3_full(Acc acc, const bf16* LH,
                                           const bf16* LL, const bf16* RH,
                                           const bf16* RL) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int m0 = (warp >> 1) * 32;
  const int n0 = (warp & 1) * 64;
  const int r16 = lane & 15, c8 = (lane >> 4) * 8;
  uint32_t ah[2][2][4], al[2][2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
    const int off = (m0 + mi * 16 + r16) * LDS + c8;
    ldmatrix_x4(ah[0][mi], LH + off);
    ldmatrix_x4(al[0][mi], LL + off);
  }
#pragma unroll
  for (int ks = 0; ks < NP / 16; ++ks) {
    const int cur = ks & 1;
    const int k0 = ks * 16;
    if (ks + 1 < NP / 16) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int off = (m0 + mi * 16 + r16) * LDS + k0 + 16 + c8;
        ldmatrix_x4(ah[cur ^ 1][mi], LH + off);
        ldmatrix_x4(al[cur ^ 1][mi], LL + off);
      }
    }
#pragma unroll
    for (int nj = 0; nj < 4; ++nj) {
      uint32_t bh[4], bl[4];
      const int off = (k0 + r16) * LDS + n0 + nj * 16 + c8;
      ldmatrix_x4_trans(bh, RH + off);
      ldmatrix_x4_trans(bl, RL + off);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        mma_16816(acc[mi][2 * nj], ah[cur][mi], bh[0], bh[1]);
        mma_16816(acc[mi][2 * nj + 1], ah[cur][mi], bh[2], bh[3]);
        mma_16816(acc[mi][2 * nj], ah[cur][mi], bl[0], bl[1]);
        mma_16816(acc[mi][2 * nj + 1], ah[cur][mi], bl[2], bl[3]);
        mma_16816(acc[mi][2 * nj], al[cur][mi], bh[0], bh[1]);
        mma_16816(acc[mi][2 * nj + 1], al[cur][mi], bh[2], bh[3]);
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

// ---------------------------------------------------------------------------
// fp32 operands staged through shared memory by cp.async (sm_80+ async copies
// from device memory straight into shared memory, no registers on the way).
// A staging tile holds NP rows at a stride of STG words: rows stay 16-byte
// aligned for 16-byte copies, and a warp's float2 accesses in the mma
// accumulator layout (8 rows x 4 column pairs) land on distinct banks.

constexpr int STG = NP + 4;
constexpr int STAGE_BYTES = NP * STG * 4;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(a), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(a), "l"(src) : "memory");
}

// Wait until at most N of this thread's copy groups (one a stage_async) are
// still in flight; a __syncthreads must follow before other threads read
// what they wrote.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start copying the fp32 rows x cols row-major matrix src (leading dimension
// cols) into the staging tile st, in 16-byte pieces when vec (cols % 4 == 0
// and src 16-byte aligned), else in 4-byte ones, as one copy group; returns
// at once.
__device__ __forceinline__ void stage_async(const float* src, int rows,
                                            int cols, bool vec, float* st) {
  if (vec) {
    const int q = cols >> 2;
    for (int idx = threadIdx.x; idx < rows * q; idx += THREADS) {
      const int i = idx / q;
      const int j = (idx - i * q) << 2;
      cp_async16(st + i * STG + j, src + i * cols + j);
    }
  } else {
    for (int idx = threadIdx.x; idx < rows * cols; idx += THREADS) {
      const int i = idx / cols;
      cp_async4(st + i * STG + idx - i * cols, src + idx);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// split() of two values with one packed conversion for each slice (the
// same round-to-nearest-even results), as packed bf16 pairs.
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                      uint32_t& lo) {
  const __nv_bfloat162 h = __float22bfloat162_rn(make_float2(a, b));
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __float22bfloat162_rn(make_float2(a - hf.x, b - hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Split the staged rows x cols matrix into hi/lo slices in the NP x NP
// tiles H and L, zero outside rows x cols (whatever the staging tile holds
// there): float4 reads, 8-byte stores.
__device__ __forceinline__ void split_staged(const float* st, int rows,
                                             int cols, bf16* H, bf16* L) {
  for (int idx = threadIdx.x; idx < NP * NP / 4; idx += THREADS) {
    const int i = idx / (NP / 4);
    const int j = (idx % (NP / 4)) * 4;
    const float4 q = *reinterpret_cast<const float4*>(st + i * STG + j);
    const bool in = i < rows;
    uint32_t h[2], l[2];
    split2(in && j < cols ? q.x : 0.f, in && j + 1 < cols ? q.y : 0.f,
           h[0], l[0]);
    split2(in && j + 2 < cols ? q.z : 0.f, in && j + 3 < cols ? q.w : 0.f,
           h[1], l[1]);
    *reinterpret_cast<uint2*>(H + i * LDS + j) = make_uint2(h[0], h[1]);
    *reinterpret_cast<uint2*>(L + i * LDS + j) = make_uint2(l[0], l[1]);
  }
}

// store_split with two values a conversion: the same slices.
__device__ __forceinline__ void store_split2(Acc acc, bf16* H, bf16* L) {
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
        uint32_t hi, lo;
        split2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(H + off) = hi;
        *reinterpret_cast<uint32_t*>(L + off) = lo;
      }
}

// v = the staged matrix at this thread's accumulator positions (the layout
// for_each walks), 0 outside rows x cols.
__device__ __forceinline__ void load_acc_layout(const float* st, int rows,
                                                int cols, Acc v) {
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
        const int r = m0 + mi * 16 + h * 8;
        const int c = n0 + ni * 8;
        const float2 q = *reinterpret_cast<const float2*>(st + r * STG + c);
        v[mi][ni][2 * h] = r < rows && c < cols ? q.x : 0.f;
        v[mi][ni][2 * h + 1] = r < rows && c + 1 < cols ? q.y : 0.f;
      }
}

// Write this thread's accumulators to the rows x cols row-major dst
// (leading dimension cols): each lane pair swaps one row's column pair
// (a shuffle), so that each lane holds four consecutive columns of one row
// and writes them in one 16-byte store when vec (cols % 4 == 0, dst 16-byte
// aligned) and the four lie inside; else entry by entry, masked.
__device__ __forceinline__ void store_acc_global(Acc acc, float* dst,
                                                 int rows, int cols,
                                                 bool vec) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const bool odd = lane & 1;
  const int m0 = (warp >> 1) * 32 + (lane >> 2) + (odd ? 8 : 0);
  const int n0 = (warp & 1) * 64 + (lane & 2) * 2;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float* a = acc[mi][ni];
      const float q0 = __shfl_xor_sync(0xffffffffu, odd ? a[0] : a[2], 1);
      const float q1 = __shfl_xor_sync(0xffffffffu, odd ? a[1] : a[3], 1);
      const float4 v = odd ? make_float4(q0, q1, a[2], a[3])
                           : make_float4(a[0], a[1], q0, q1);
      const int r = m0 + mi * 16;
      const int c = n0 + ni * 8;
      if (r >= rows) continue;
      float* d = dst + r * cols + c;
      if (vec && c + 3 < cols) {
        *reinterpret_cast<float4*>(d) = v;
      } else {
        if (c < cols) d[0] = v.x;
        if (c + 1 < cols) d[1] = v.y;
        if (c + 2 < cols) d[2] = v.z;
        if (c + 3 < cols) d[3] = v.w;
      }
    }
}

}  // namespace hilo
