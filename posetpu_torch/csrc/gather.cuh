// Operand loaders for int8_mma.cuh's main loops: where one thread's A row or
// B row lives in device memory at depth k. Each is a functor
// operator()(k, valid) returning the address of 16 bytes, with valid=false
// (and any mapped address) where the loop must read zeros instead.
#pragma once

#include "int8_mma.cuh"

namespace posetpu {

// A row of one phase of a k4/s2/p1 transposed conv in phase form: output
// pixel (n, i, j) of phase (a, b), depth k = tap * Cin + c with tap (u, v),
// reads x[n, i + u - (1-a), j + v - (1-b), c], zero outside the image.
struct PhaseARow {
  const int8_t* x;
  int n, i, j, h, w, cin, a, b;
  bool row_ok;
  __device__ const void* operator()(int k, bool& valid) const {
    const int t = k / cin, c = k - t * cin;
    const int ii = i + (t >> 1) - (1 - a), jj = j + (t & 1) - (1 - b);
    valid = row_ok && ii >= 0 && ii < h && jj >= 0 && jj < w;
    return valid ? x + ((static_cast<size_t>(n) * h + ii) * w + jj) * cin + c : x;
  }
  // the row for tile row m of the [N*H*W] pixel list
  __device__ static PhaseARow at(const int8_t* x, int m, int n_img, int h, int w,
                                 int cin, int a, int b) {
    PhaseARow r;
    r.x = x; r.h = h; r.w = w; r.cin = cin; r.a = a; r.b = b;
    r.row_ok = m < n_img * h * w;
    const int mm = r.row_ok ? m : 0;
    r.j = mm % w;
    r.i = (mm / w) % h;
    r.n = mm / (w * h);
    return r;
  }
};

// B row o of the phase weights [4 phase, 4 tap, Cout, Cin] (K-minor).
struct PhaseBRow {
  const int8_t* w;
  int g, o, cin, cout;
  __device__ const void* operator()(int k, bool& valid) const {
    const int t = k / cin, c = k - t * cin;
    valid = o < cout;
    return valid ? w + (static_cast<size_t>(g * 4 + t) * cout + o) * cin + c : w;
  }
};

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
