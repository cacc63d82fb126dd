// The int8 trunk's requantize epilogue, one value at a time (sm_90a).
//
// A convolution's exact int32 sum for output channel c becomes the next int8
// (or 4-bit) boundary value in the arithmetic of models/quant.py's plain
// passes and of the JAX package's _Int8Runner:
//   conv epilogue  q = clamp(rint(relu?(float(acc) * sv[c] + b[c]) * inv), -hi, hi)
//   block tail     q = clamp(rint(relu((float(acc) * sv[c] + b[c]) + float(r) * r_s) * inv),
//                            -hi, hi)
// with sv = s_in * w_scale and inv = 1 / s_out computed by the caller, r the
// block's int8 residual at scale r_s, and hi 127 (7 at a 4-bit boundary).
// Every multiply and add is rounded on its own, as PyTorch's eager passes
// round them (the library is built with --fmad=false as well); int32 -> f32
// rounds to nearest; rintf rounds half to even, as torch.round does. So a
// kernel built on these functions gives the plain passes' int8 values bit for
// bit. They are kept here, apart from csrc/requant.cu's pass, for an
// implicit-GEMM int8 convolution to apply in its own epilogue.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace posetpu {

// float(acc) * sv + b, each operation rounded on its own
__device__ __forceinline__ float requant_affine(int acc, float sv, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), sv), b);
}

// y + float(r) * r_s: the dequantized residual added to the affine
__device__ __forceinline__ float requant_add_residual(float y, int r, float r_s) {
  return __fadd_rn(y, __fmul_rn(__int2float_rn(r), r_s));
}

// clamp(rint(relu?(y) * inv), -hi, hi) as an int8 value
__device__ __forceinline__ int8_t requant_round(float y, bool relu, float inv, float hi) {
  if (relu) y = fmaxf(y, 0.0f);
  const float q = fminf(fmaxf(rintf(__fmul_rn(y, inv)), -hi), hi);
  return static_cast<int8_t>(static_cast<int>(q));
}

// (a) the conv epilogue
__device__ __forceinline__ int8_t requant_conv(int acc, float sv, float b, bool relu, float inv,
                                               float hi) {
  return requant_round(requant_affine(acc, sv, b), relu, inv, hi);
}

// (b) the block tail: the block's last conv, its residual, ReLU, the boundary
__device__ __forceinline__ int8_t requant_tail(int acc, float sv, float b, int r, float r_s,
                                               float inv, float hi) {
  return requant_round(requant_add_residual(requant_affine(acc, sv, b), r, r_s), true, inv, hi);
}

}  // namespace posetpu
