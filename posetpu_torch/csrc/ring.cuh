// Shared-memory ring primitives of the redesigned kernels (sm_90a): mbarriers,
// the bulk copy engine (TMA) in its plain and its tensor-map form, the host's
// tensor-map encoder, and ldmatrix. Used by resblock.cu (B8a), tail2.cu (B1,
// B9a, B9b) and aggregation.cu (B3). Every address is a shared-space address
// (__cvta_generic_to_shared).
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links -lcuda)

#include "int8_mma.cuh"

namespace posetpu {

__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(bar), "r"(count) : "memory");
}

// make the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// ``bytes`` (a multiple of 16, both ends 16-aligned) from device memory to
// shared memory; their arrival counts on ``bar``
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// One box of a tensor map (a __grid_constant__ kernel parameter, by its
// generic address) at coordinates innermost first; bytes outside the tensor
// arrive as zeros and count on ``bar`` like the rest.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const void* map, int c0, int c1,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_3d(unsigned dst, const void* map, int c0, int c1,
                                            int c2, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(bar) : "memory");
}

__device__ __forceinline__ void tma_load_4d(unsigned dst, const void* map, int c0, int c1,
                                            int c2, int c3, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(map), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar) : "memory");
}

// four 8 x 16-byte matrices, one row address a lane: lanes 8m..8m+7 give matrix m
__device__ __forceinline__ void ldsm4(unsigned& r0, unsigned& r1, unsigned& r2, unsigned& r3,
                                      unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3) : "r"(addr) : "memory");
}

// ---- host: tensor maps

// cuTensorMapEncodeTiled, looked up through the runtime's entry-point query
// (nothing links -lcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess && q == cudaDriverEntryPointSuccess)
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) ==
            cudaSuccess && q == cudaDriverEntryPointSuccess)
#endif
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// an int8 tensor of ``rank`` (<= 5) dims (innermost first, ``pitch`` bytes
// between the entries of each outer dim) cut into ``box`` tiles; bytes
// outside the tensor arrive as zeros
inline bool uint8_map(CUtensorMap* map, const void* base, int rank, const cuuint64_t* dims,
                      const cuuint64_t* pitch, const cuuint32_t* box,
                      CUtensorMapSwizzle swizzle) {
  EncodeTiled fn = encode_tiled();
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, rank, const_cast<void*>(base), dims, pitch, box,
            ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace posetpu
