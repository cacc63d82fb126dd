// Fused int8 subpixel transposed-conv kernels, row-major output (sm_90a).
//
// Replaces two Pallas TPU kernels of posetpu/ops/pallas/deconv.py:
//   B9a fused_subpixel_deconv (_deconv_kernel) — one k4/s2/p1 transposed
//       conv as four 2x2 phase convs, folded requant (+ReLU), depth-to-space,
//       int8 [N, H*W, Cin] -> int8 [N, 4*H*W, Cout];
//   B9b fused_subpixel_deconv_head (_deconv_head_kernel) — the same followed
//       by the 1x1 head on the interleaved int8 rows -> f32 [N, 4*H*W, J].
//
// The TPU kernel runs the phase conv over the whole padded (H+2) x (W+2) grid
// of one image in VMEM and slices the valid windows afterwards. Here each
// phase computes only its valid H x W window, as in phase_tail.cu: per phase
// an implicit GEMM, M = N*H*W pixels, N = Cout, K = 4 taps * Cin, the A rows
// gathered (shifted, zero outside the image) straight from x, and the output
// element (n, i, j) of phase (a, b) written at pixel (2i+a, 2j+b): the
// depth-to-space costs nothing. The epilogue is not phase_tail.cu's: scale
// and bias arrive pre-divided by the output scale and the sum is rounded
// once, clip(round(acc * v0 + v1), 0, 127).
//
// B9b keeps the deconv's int8 output out of device memory: a block computes
// ALL Cout channels of its 128 pixels (Cout / 128 passes of the main loop)
// into a shared-memory tile, then takes the head's K = Cout product from that
// tile with dp4a (the head is 1/64 of the deconv's work at J = 16) and writes
// f32 rows [J] at each pixel's interleaved position.
//
// Bound on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s) at 128 images of
// 256^2 input: deconv0 (8x8, 2048 -> 256) 6.9e10 MAC, 0.069 ms; deconv1
// (16x16, 256 -> 256) 3.4e10 MAC, 0.035 ms; deconv2 + head (32x32, 256 -> 256
// -> 16) 1.4e11 MAC, 0.141 ms: all bound by operations. The design answers
// with int8 tensor-core mma.sync on 128 x 128 tiles; it is not at the bound
// (mma.sync rather than wgmma/TMA, two-stage cp.async).
//
// Exactness: multiply and add rounded separately (__fmul_rn/__fadd_rn,
// --fmad=false), rintf rounds half to even like jnp.round.

#include "gather.cuh"

namespace posetpu {

struct DeconvArgs {
  const int8_t* x;   // [N, H, W, Cin]
  const int8_t* w;   // [4 phase, 4 tap, Cout, Cin]
  const float* v;    // [2, 4 * Cout]: scale, bias; phase g at g * Cout
  const int8_t* wh;  // [J, Cout], head only
  const float* vh;   // [2, J], head only
  void* out;         // int8 [N, 2H, 2W, Cout], or f32 [N, 2H, 2W, J]
  int n, h, wd, cin, cout, joints;  // wd: image width
};

// interleaved pixel index of phase (a, b)'s element mo of the [N*H*W] list
__device__ __forceinline__ size_t interleaved_pixel(const DeconvArgs& p, int mo, int a, int b) {
  const int j = mo % p.wd, i = (mo / p.wd) % p.h, n = mo / (p.wd * p.h);
  return (static_cast<size_t>(n) * 2 * p.h + 2 * i + a) * 2 * p.wd + 2 * j + b;
}

__global__ void __launch_bounds__(THREADS) deconv_kernel(DeconvArgs p) {
  const int g = blockIdx.z, a = g >> 1, b = g & 1;
  const int m_total = p.n * p.h * p.wd;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lrow = threadIdx.x >> 1;
  const PhaseARow la = PhaseARow::at(p.x, m0 + lrow, p.n, p.h, p.wd, p.cin, a, b);
  const PhaseBRow lb{p.w, g, n0 + lrow, p.cin, p.cout};

  Acc acc;
  mma_mainloop(la, lb, 4 * p.cin / BK, acc);

  const float* sv = p.v + g * p.cout;
  const float* bv = p.v + 4 * p.cout + g * p.cout;
  int8_t* out = static_cast<int8_t*>(p.out);
  for_each_pair(acc, [&](int row, int col, int v0, int v1) {
    const int mo = m0 + row, o = n0 + col;
    if (mo >= m_total || o >= p.cout) return;
    char2 q;
    q.x = requant_folded(v0, sv[o], bv[o], 0.0f);
    q.y = requant_folded(v1, sv[o + 1], bv[o + 1], 0.0f);
    *reinterpret_cast<char2*>(out + interleaved_pixel(p, mo, a, b) * p.cout + o) = q;
  });
}

__global__ void __launch_bounds__(THREADS) deconv_head_kernel(DeconvArgs p) {
  extern __shared__ int smem[];
  const int cw = p.cout / 4;  // int32 words per pixel
  const int ld = cw + 1;      // padded row stride: conflict-free dp4a reads
  int* zs = smem;             // [BM][ld]: the block's requantised deconv output
  int* ws = smem + BM * ld;   // [J][ld]: the head's weights
  const int g = blockIdx.z, a = g >> 1, b = g & 1;
  const int m_total = p.n * p.h * p.wd;
  const int m0 = blockIdx.y * BM;
  const int lrow = threadIdx.x >> 1;
  const PhaseARow la = PhaseARow::at(p.x, m0 + lrow, p.n, p.h, p.wd, p.cin, a, b);

  for (int e = threadIdx.x; e < p.joints * cw; e += THREADS) {
    const int j = e / cw;
    ws[j * ld + e - j * cw] = reinterpret_cast<const int*>(p.wh)[e];
  }

  const float* sv = p.v + g * p.cout;
  const float* bv = p.v + 4 * p.cout + g * p.cout;
  int8_t* zb = reinterpret_cast<int8_t*>(zs);
  for (int n0 = 0; n0 < p.cout; n0 += BN) {
    const PhaseBRow lb{p.w, g, n0 + lrow, p.cin, p.cout};
    Acc acc;
    mma_mainloop(la, lb, 4 * p.cin / BK, acc);
    for_each_pair(acc, [&](int row, int col, int v0, int v1) {
      const int o = n0 + col;
      if (o >= p.cout) return;
      char2 q;
      q.x = requant_folded(v0, sv[o], bv[o], 0.0f);
      q.y = requant_folded(v1, sv[o + 1], bv[o + 1], 0.0f);
      *reinterpret_cast<char2*>(zb + row * ld * 4 + o) = q;
    });
  }
  __syncthreads();

  float* out = static_cast<float*>(p.out);
  for (int e = threadIdx.x; e < BM * p.joints; e += THREADS) {
    const int px = e / p.joints, j = e - px * p.joints;
    const int mo = m0 + px;
    if (mo >= m_total) continue;
    const int* zr = zs + px * ld;
    const int* wr = ws + j * ld;
    int acc = 0;
    for (int q = 0; q < cw; ++q) acc = __dp4a(zr[q], wr[q], acc);
    out[interleaved_pixel(p, mo, a, b) * p.joints + j] =
        scale_bias(acc, p.vh[j], p.vh[p.joints + j]);
  }
}

}  // namespace posetpu

using namespace posetpu;

extern "C" int subpixel_deconv(const void* x, const void* w, const void* v,
                               const void* wh, const void* vh, void* out, int n,
                               int h, int w_, int cin, int cout, int joints,
                               void* stream) {
  const DeconvArgs p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                     static_cast<const float*>(v), static_cast<const int8_t*>(wh),
                     static_cast<const float*>(vh), out, n, h, w_, cin, cout, joints};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int m = n * h * w_;
  if (wh == nullptr) {
    dim3 grid((cout + BN - 1) / BN, (m + BM - 1) / BM, 4);
    deconv_kernel<<<grid, THREADS, 0, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = static_cast<size_t>(BM + joints) * (cout / 4 + 1) * sizeof(int);
  cudaError_t e = cudaFuncSetAttribute(
      deconv_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid(1, (m + BM - 1) / BM, 4);
  deconv_head_kernel<<<grid, THREADS, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
