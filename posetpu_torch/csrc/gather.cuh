// Operand loaders for int8_mma.cuh's main loops: where one thread's A row or
// B row lives in device memory at depth k. Each is a functor
// operator()(k, valid) returning the address of 16 bytes, with valid=false
// (and any mapped address) where the loop must read zeros instead.
#pragma once

#include "int8_mma.cuh"

namespace posetpu {

// Row o of a K-minor weight matrix [rows][K], read from depth k0 on.
struct KMinorBRow {
  const int8_t* w;
  int o, rows, k_total, k0;
  __device__ const void* operator()(int k, bool& valid) const {
    valid = o < rows;
    return valid ? w + static_cast<size_t>(o) * k_total + k0 + k : w;
  }
};

// One pixel's channel vector of an [N, H, W, C] int8 image, or zeros.
struct PixelARow {
  const int8_t* px;  // the pixel's first channel
  bool ok;
  __device__ const void* operator()(int k, bool& valid) const {
    valid = ok;
    return px + (ok ? k : 0);
  }
};

}  // namespace posetpu
