// tma.cuh — Hopper's Tensor Memory Accelerator (TMA) and shared-memory
// mbarriers from inline PTX, for kernels compiled for sm_90a, and the
// host-side encoding of their tensor maps.
//
// Device side: an mbarrier a buffer, initialised by one thread
// (mbar_init, then fence.mbarrier_init), armed by the thread that issues
// the copies with the bytes they will bring (mbar_expect), completed by
// the copies themselves (tma_2d, tma_4d: one box of a map, elements out
// of the tensor's range arrive as zeros and still count; bulk_copy: a
// contiguous run of bytes, no map) and by the
// other arrivals the barrier was made for (mbar_arrive); a consumer
// waits on the barrier's phase parity (mbar_wait).
//
// Host side: make_map / make_map_4d encode a CUtensorMap through
// cuTensorMapEncodeTiled, which encode_tiled looks up through the CUDA
// runtime, so the library needs no -lcuda.  A map is passed to the
// kernel in a __grid_constant__ argument.  TMA takes a base address and
// strides that are multiples of 16 bytes; the makers return false where
// a tensor breaks that, and the caller decides what to do.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count) : "memory");
}

// this thread's arrival, announcing `bytes` of TMA copies to come
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// a 2-D tile of a TMA map at (inner c0, row c1) into shared memory,
// completing on bar; out-of-range elements arrive as zeros
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(smem_addr(bar)) : "memory");
}

// a 4-D box of a TMA map at (c0 innermost .. c3) into shared memory,
// completing on bar; out-of-range elements arrive as zeros
__device__ __forceinline__ void tma_4d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, int c2, int c3,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3), "r"(smem_addr(bar)) : "memory");
}

// `bytes` contiguous bytes from device memory into shared memory,
// completing on bar (no tensor map; both addresses and `bytes` on 16
// bytes)
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (no
// -lcuda at build time)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// a row-major (rows, cols) matrix with a row stride of `ld` bytes, read
// in boxes of (box_rows, box_cols); false where TMA cannot take it
inline bool make_map(CUtensorMap* map, CUtensorMapDataType type,
                     const void* base, long long rows, long long cols,
                     long long ld, int box_rows, int box_cols,
                     CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16 || ld % 16)
    return false;
  const cuuint64_t dim[2] = {static_cast<cuuint64_t>(cols),
                             static_cast<cuuint64_t>(rows)};
  const cuuint64_t stride[1] = {static_cast<cuuint64_t>(ld)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t estride[2] = {1, 1};
  return fn(map, type, 2, const_cast<void*>(base), dim, stride, box, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a 4-D tensor of extents dim[0] (innermost, unit stride) .. dim[3] and
// byte strides stride[0..2] of dims 1..3, read in boxes of box[0..3];
// false where TMA cannot take it (a stride or the base off 16 bytes)
inline bool make_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                        const void* base, const long long (&dim)[4],
                        const long long (&stride)[3], const int (&box)[4],
                        CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr || reinterpret_cast<uintptr_t>(base) % 16) return false;
  cuuint64_t d[4], s[3];
  cuuint32_t b[4];
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    if (dim[i] < 1 || box[i] < 1) return false;
    d[i] = static_cast<cuuint64_t>(dim[i]);
    b[i] = static_cast<cuuint32_t>(box[i]);
  }
  for (int i = 0; i < 3; ++i) {
    if (stride[i] <= 0 || stride[i] % 16) return false;
    s[i] = static_cast<cuuint64_t>(stride[i]);
  }
  return fn(map, type, 4, const_cast<void*>(base), d, s, b, estride,
            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
