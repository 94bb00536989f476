// Tensor Memory Accelerator (TMA) copies and the shared-memory barriers
// (mbarrier) that report them, for the warp-specialised kernels
// (bitslice_mm.cu, hilo_tma.cuh): a producer thread arms a barrier with the
// bytes it expects and issues tiled copies from device memory into shared
// memory; consumers wait on the barrier's phase and hand the slot back
// through a second barrier. Tensor maps are encoded on the host through
// cuTensorMapEncodeTiled, reached through the CUDA runtime
// (cudaGetDriverEntryPoint*), so no library links libcuda.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// After the barriers' initialisation, before any other thread uses them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          bar)
      : "memory");
}

// This thread's arrival, and `bytes` more for the barrier's phase to wait
// for (the TMA copies report them as they land).
__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Stage g of a ring of n slots (barriers 8 bytes apart from bars): wait for
// the consumer of the slot's previous use (parity of round g / n - 1;
// passes at once in round 0).
__device__ __forceinline__ void wait_free(uint32_t bars, int g, int n) {
  mbar_wait(bars + 8 * (g % n), ((g / n) & 1) ^ 1);
}

// Stage g of the ring: wait until its slot is filled.
__device__ __forceinline__ void wait_filled(uint32_t bars, int g, int n) {
  mbar_wait(bars + 8 * (g % n), (g / n) & 1);
}

// The box of a 2-D `map` at (column x, row y) into shared dst (zero outside
// the tensor), reported to the barrier bar.
__device__ __forceinline__ void load_2d(uint32_t dst, const CUtensorMap* map,
                                        int x, int y, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(bar)
      : "memory");
}

// The same for a 3-D map at (column x, row y, matrix z).
__device__ __forceinline__ void load_3d(uint32_t dst, const CUtensorMap* map,
                                        int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (the
// libraries do not link libcuda); null where it is missing.
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

}  // namespace tma
