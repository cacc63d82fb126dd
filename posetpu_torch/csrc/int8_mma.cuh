// Shared int8 tensor-core pieces of the port's kernels (sm_90a): the tile
// constants of B8a (resblock.cu), cp.async, mma.sync.m16n8k32 s8 (exact int32
// sums; B8a's products and B1's, B5's and B9b's head in tail2.cu), the nibble
// widening of B4 (aggregation.cu) and the f32 epilogue steps every kernel
// rounds as the JAX reference does.
//
// mma.sync m16n8k32 s8 reaches 1,270 of the card's 1,979 TOP/s and
// wgmma.m64n128k32 1,950 (tools/imma_rate.cu): the GEMM main loops are wgmma
// (wgmma.cuh) everywhere but in B8a, whose mma.sync pipeline PERF.md times
// beside B8b's wgmma kernel.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace posetpu {

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_size) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Sign-extend the four 4-bit values held in the low nibbles of a word's
// bytes to four int8: per byte (x ^ 8) - 8, written as x | 0xF0 where bit 3
// is set (the same value; no borrow crosses a byte). B4 (aggregation.cu)
// widens its nibble-packed bank with it.
__device__ __forceinline__ unsigned sext_nibbles(unsigned x) {
  return x | ((x & 0x08080808u) * 0x1Eu);
}

// f32 epilogue steps, each rounded on its own (no FMA contraction), as the
// JAX reference rounds them.
__device__ __forceinline__ float scale_bias(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// requant(+ReLU) to int8: clip(round_half_even(max(z, 0) * inv_so), -127, 127)
__device__ __forceinline__ signed char requant_relu(float z, float inv_so) {
  float q = rintf(__fmul_rn(fmaxf(z, 0.0f), inv_so));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

// The folded requant of the bottleneck and subpixel-deconv kernels, whose
// scale and bias arrive pre-divided by the output scale:
// clip(round_half_even(acc * s + b), lo, 127), multiply and add rounded
// separately. ReLU is lo = 0.
__device__ __forceinline__ signed char requant_folded(int acc, float s, float b, float lo) {
  float q = rintf(scale_bias(acc, s, b));
  q = fminf(fmaxf(q, lo), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

}  // namespace posetpu
