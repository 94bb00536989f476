// Hopper warpgroup MMA (wgmma) building blocks (sm_90a only), used by the
// composed-precision inverse (composed_inv.cuh: neumann_inv.cu and
// fused_gram_solve.cu), by bitslice_mm.cu and by the batched product of
// hilo_tma.cuh.
//
// Tiles. A bf16 tile of R rows (R = 128 or 64) and 128 columns lives in
// shared memory in wgmma's canonical 128-byte-swizzle layout: two 64-column
// halves, each R rows of 128 bytes, and inside each group of 8 rows the
// 16-byte chunk c of row r stored at chunk c ^ (r % 8). A tile starts on a
// 1024-byte boundary (the swizzle is taken from the address bits) and is
// named by its 32-bit shared-memory address. The same row-major tile
// serves as either operand without a copy: as the left operand of L @ R it
// is read K-major (rows = M, contiguous K), as the right operand MN-major
// (rows = K, contiguous N), and its transpose as an MN-major left operand
// (rows = K, contiguous M).
//
// Products. Two consumer warpgroups (256 threads) each own 64 rows of a
// product: wgmma.mma_async m64n128k16 (64 fp32 accumulators a thread),
// m64n64k16 over one 64-column half (32), m64n192k16 over three (96) or
// m64n256k16 over four (128), both operands read from shared memory
// through matrix descriptors. Accumulator j of a thread holds row
// 16 * (warp % 4) + lane / 4 + 8 * bit 1 of j, column 8 * (j / 4) +
// 2 * (lane % 4) + bit 0 of j, of its warpgroup's 64 rows (and of the half).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wgmma {

typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;                 // two warpgroups
typedef float Acc[64];                       // m64n128 accumulators
typedef float Acc32[32];                     // m64n64 accumulators
typedef float Acc96[96];                     // m64n192 accumulators
typedef float Acc128[128];                   // m64n256 accumulators

// bytes of an R-row tile; bytes of one of its 64-column halves
template <int R>
__host__ __device__ constexpr int tile_bytes() { return R * 256; }
template <int R>
__host__ __device__ constexpr int half_bytes() { return R * 128; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of element (r, c) in an R-row swizzled tile.
template <int R>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * half_bytes<R>() + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + (c & 7) * 2;
}

__device__ __forceinline__ void st_shared(uint32_t a, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t a, uint2 v) {
  asm volatile("st.shared.v2.b32 [%0], {%1, %2};\n" ::"r"(a), "r"(v.x),
               "r"(v.y)
               : "memory");
}

__device__ __forceinline__ void st_shared(uint32_t a, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Four 8 x 8 b16 blocks in the mma accumulator layout (thread t holds
// row t / 4, columns 2 (t % 4) and +1 of block i in r[i]), block i's rows
// at the addresses of threads 8i .. 8i+7.
__device__ __forceinline__ void stmatrix(uint32_t a, const uint32_t (&r)[4]) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(a), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t a) {
  uint32_t v;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ uint4 ld_shared_b128(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

__device__ __forceinline__ float ld_shared_bf16(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a) : "memory");
  return __bfloat162float(__ushort_as_bfloat16(v));
}

// Matrix descriptor of a 128-byte-swizzled operand at shared address a,
// with leading and stride byte offsets lbo and sbo (its upper word is a
// constant).
__device__ __forceinline__ uint64_t desc(uint32_t a, uint32_t lbo,
                                         uint32_t sbo) {
  const uint32_t lo = ((a >> 4) & 0x3FFFu) | ((lbo >> 4) << 16);
  const uint32_t hi = (sbo >> 4) | (1u << 30);
  return (static_cast<uint64_t>(hi) << 32) | lo;
}

// Left operand, K-major: rows 64 wg .. +64 of the 128-row tile L (M x K),
// columns 16 ks .. +16. Inside a swizzle row the start moves 32 bytes a
// k-step; the hardware swizzles the summed address.
__device__ __forceinline__ uint64_t desc_k(uint32_t L, int wg, int ks) {
  return desc(L + (ks >> 2) * half_bytes<128>() + wg * 8192 + (ks & 3) * 32,
              16, 1024);
}

// Right operand, MN-major: rows 16 ks .. +16 (K) of the R-row tile B,
// columns from half h on: one half for m64n64, both for m64n128 (h = 0;
// the halves are lbo apart); 8-row groups 1024 bytes apart.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(uint32_t B, int ks, int h = 0) {
  return desc(B + h * half_bytes<R>() + ks * 2048, half_bytes<R>(), 1024);
}

// Transposed left operand, MN-major: columns 64 wg .. +64 (M) of the R-row
// tile T (K x 128), rows 16 ks .. +16 (K).
template <int R>
__device__ __forceinline__ uint64_t desc_mn_t(uint32_t T, int wg, int ks) {
  return desc(T + wg * half_bytes<R>() + ks * 2048, half_bytes<R>(), 1024);
}

// d (+)= SA A B for one m64n128k16 step: TA / TB = 1 reads A / B
// MN-major, SA = -1 negates A. With accumulate = 0 the step overwrites d.
template <int TA, int TB, int SA = 1>
__device__ __forceinline__ void mma(Acc& d, uint64_t da, uint64_t db,
                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, %69, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB), "n"(SA));
}

// The same for one m64n64k16 step.
template <int TA, int TB, int SA = 1>
__device__ __forceinline__ void mma(Acc32& d, uint64_t da, uint64_t db,
                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, "
      "%32, %33, p, %37, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB), "n"(SA));
}

// The same for one m64n192k16 step over three 64-column halves (lbo apart).
template <int TA, int TB, int SA = 1>
__device__ __forceinline__ void mma(Acc96& d, uint64_t da, uint64_t db,
                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, "
      "%71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, "
      "%85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, %101, 1, %99, %100;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB), "n"(SA));
}

// The same for one m64n256k16 step over four 64-column panels (lbo apart).
template <int TA, int TB, int SA = 1>
__device__ __forceinline__ void mma(Acc128& d, uint64_t da, uint64_t db,
                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
      "%124, %125, %126, %127}, "
      "%128, %129, p, %133, 1, %131, %132;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB), "n"(SA));
}

// Order this thread's register accesses to d around asynchronous wgmma
// (emits no instruction; keeps the compiler from moving reads or writes
// of d across an asynchronous product or a wait).
template <int N>
__device__ __forceinline__ void fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Before a warpgroup's first wgmma after its registers or shared memory
// were written.
__device__ __forceinline__ void fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's committed groups are pending.
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// After this thread's ordinary stores to shared memory that a wgmma will
// read (then a barrier): makes them visible to the async proxy.
__device__ __forceinline__ void fence_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// threadIdx.x as a value the compiler cannot see through: what an
// epilogue derives from it is computed where it is used, not hoisted out of
// the iteration loops into registers the wgmma pipeline needs.
__device__ __forceinline__ int opaque_tid() {
  int t = threadIdx.x;
  asm volatile("" : "+r"(t));
  return t;
}

// Row and column of thread t's accumulator j (columns of one half from 0).
__device__ __forceinline__ int acc_row(int j, int t) {
  return (t >> 7) * 64 + ((t >> 5) & 3) * 16 + ((t & 31) >> 2) +
         ((j >> 1) & 1) * 8;
}

__device__ __forceinline__ int acc_col(int j, int t) {
  return (j >> 2) * 8 + (t & 3) * 2 + (j & 1);
}

// f(row, col, value&) over this thread's accumulators, whose columns start
// at c0.
template <int N, class F>
__device__ __forceinline__ void for_each(float (&d)[N], F f, int c0 = 0) {
  const int t = opaque_tid();
#pragma unroll
  for (int j = 0; j < N; ++j) f(acc_row(j, t), c0 + acc_col(j, t), d[j]);
}

}  // namespace wgmma
