// Phase-domain deconvolution kernels for the serving tail (sm_90a).
//
// Replaces two Pallas TPU kernels of posetpu/ops/pallas/phase_tail.py:
//   B5 fused_phase_tail (_phase_tail_kernel) — the last deconv + the 1x1
//      head, heatmaps in the phase_index_tables(levels=1) order: phase_conv
//      (phase-major output) then phase_head(levels=1);
//   B6 fused_subpixel_deconv (_subpixel_deconv_kernel) — deconv0 as 4 phases
//      x 4 taps of int8 dots + per-phase requant, with the per-pair kernel's
//      N-minor output [4, H, W, N, Cout] (phase_conv output mode 2).
// B1 (fused_phase_tail2) and B2 (fused_subpixel_deconv_batched) have their
// own kernel, tail2.cu; the launches here are the design they left (PERF.md),
// kept for B5 and B6 until they move onto it.
//
// phase_conv: one k4/s2/p1 transposed conv in phase form. Output element
// (g=(a,b), n, i, j, o) = requant(sum_t sum_c x[n, i+sr, j+sc, c] * w[g,t,o,c])
// with tap t=(u,v), sr = u-(1-a), sc = v-(1-b), x zero outside the image:
// per phase an implicit GEMM, M = N*H*W pixels, N = Cout, K = 4 taps * Cin,
// whose A rows are gathered (shifted, zero-padded) straight from x. Output
// modes: phase-major [4, N, H, W, Cout], interleaved into the 2H x 2W image,
// or N-minor.
//
// phase_head: the [C -> J] int8 head over phase maps, writing f32 [J, N,
// 4*h*w] directly in a packed order (ops/heatmap.py: phase_index_tables):
// levels=2, p = ((g2*4 + 2al+be) * bh*bw) + i*bw + j reads phase g2 at pixel
// (2i+al, 2j+be); levels=1, p = g*h*w + r reads phase g at row-major pixel r.
//
// Bound on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s), at the serving
// shapes (128 images, 256^2 input): B6 (deconv0) 6.87e10 MAC over 33.6 MB,
// ~0.069 ms, compute-bound. B5 at the serving shapes (128 images, 32x32 ->
// 64x64, C 256): 1.36e11 MAC, ~0.137 ms, compute-bound; it round-trips its
// deconv output (134 MB int8) through device memory.
// The design answers the compute bound with int8 tensor-core mma.sync (exact
// int32 sums) on 128x128 tiles on int8_mma.cuh's two-stage loop; it is 7-12x
// above the bound (PERF.md).
//
// Exactness: every epilogue rounds multiply and add separately
// (__fmul_rn/__fadd_rn; the library is also built with --fmad=false), the
// reciprocal 1/so is a correctly rounded f32 divide as in JAX, and rintf
// rounds half to even like jnp.round.

#include "gather.cuh"

namespace posetpu {

struct PhaseConvArgs {
  const int8_t* x;      // [N, H, W, Cin]
  const int8_t* w;      // [4 phase, 4 tap, Cout, Cin]
  const float* sv;      // scale, phase g at sv + g * phase_stride
  const float* bv;      // bias, same layout
  int phase_stride;     // Cout (per-phase vectors) or 0 (one broadcast vector)
  const float* so;      // output scale, one value
  int8_t* out;          // by out_mode, below
  int n, h, wd, cin, cout;  // wd: image width
  int out_mode;         // 0: [4, N, H, W, Cout]; 1: interleaved [N, 2H, 2W, Cout];
                        // 2: [4, H, W, N, Cout]
};

__global__ void __launch_bounds__(THREADS) phase_conv_kernel(PhaseConvArgs p) {
  const int g = blockIdx.z, a = g >> 1, b = g & 1;
  const int m_total = p.n * p.h * p.wd;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lrow = threadIdx.x >> 1;

  const PhaseARow la = PhaseARow::at(p.x, m0 + lrow, p.n, p.h, p.wd, p.cin, a, b);
  PhaseBRow lb{p.w, g, n0 + lrow, p.cin, p.cout};

  Acc acc;
  mma_mainloop(la, lb, 4 * p.cin / BK, acc);

  const float inv_so = __fdiv_rn(1.0f, *p.so);
  const float* sv = p.sv + g * p.phase_stride;
  const float* bv = p.bv + g * p.phase_stride;
  for_each_pair(acc, [&](int row, int col, int v0, int v1) {
    const int mo = m0 + row, o = n0 + col;
    if (mo >= m_total || o >= p.cout) return;
    const int j = mo % p.wd, i = (mo / p.wd) % p.h, n = mo / (p.wd * p.h);
    size_t base;
    if (p.out_mode == 1)
      base = ((static_cast<size_t>(n) * 2 * p.h + 2 * i + a) * 2 * p.wd + 2 * j + b) * p.cout;
    else if (p.out_mode == 2)
      base = (((static_cast<size_t>(g) * p.h + i) * p.wd + j) * p.n + n) * p.cout;
    else
      base = (static_cast<size_t>(g) * m_total + mo) * p.cout;
    char2 q;
    q.x = requant_relu(scale_bias(v0, sv[o], bv[o]), inv_so);
    q.y = requant_relu(scale_bias(v1, sv[o + 1], bv[o + 1]), inv_so);
    *reinterpret_cast<char2*>(p.out + base + o) = q;
  });
}

// phase_head: one block = one image n and 64 consecutive packed positions.
constexpr int HEAD_PIX = 64;

__global__ void __launch_bounds__(THREADS) phase_head_kernel(
    const int8_t* __restrict__ z,   // [4, N, H2, W2, C] deconv2 phase maps
    const int8_t* __restrict__ wh,  // [J, C]
    const float* __restrict__ vh,   // [2, J]: scale, bias
    float* __restrict__ out,        // [J, N, 4*H2*W2]
    int n_img, int h2, int w2, int c, int joints, int levels) {
  extern __shared__ int smem[];
  const int cw = c / 4;            // int32 words per channel row
  const int ld = cw + 1;           // padded row stride: conflict-free reads
  int* zs = smem;                  // [HEAD_PIX][ld]
  int* ws = smem + HEAD_PIX * ld;  // [J][cw]
  const int n = blockIdx.y;
  const int total = 4 * h2 * w2;
  const int p0 = blockIdx.x * HEAD_PIX;
  const int bh = h2 / 2, bw = w2 / 2, plane = bh * bw;

  for (int e = threadIdx.x; e < joints * cw; e += blockDim.x)
    ws[e] = reinterpret_cast<const int*>(wh)[e];
  for (int e = threadIdx.x; e < HEAD_PIX * cw; e += blockDim.x) {
    const int px = e / cw, word = e - px * cw;
    const int pk = p0 + px;
    int v = 0;
    if (pk < total) {
      int g2, yy, xx;
      if (levels == 1) {  // packed p = g*H2*W2 + r: phase g, row-major pixel r
        g2 = pk / (h2 * w2);
        const int r = pk - g2 * h2 * w2;
        yy = r / w2; xx = r - yy * w2;
      } else {
        g2 = pk / (4 * plane);
        const int rem = pk - g2 * 4 * plane;
        const int par = rem / plane, r = rem - par * plane;
        yy = 2 * (r / bw) + (par >> 1); xx = 2 * (r % bw) + (par & 1);
      }
      const size_t row = ((static_cast<size_t>(g2) * n_img + n) * h2 + yy) * w2 + xx;
      v = reinterpret_cast<const int*>(z + row * c)[word];
    }
    zs[px * ld + word] = v;
  }
  __syncthreads();

  const int px = threadIdx.x % HEAD_PIX;
  const int pk = p0 + px;
  if (pk >= total) return;
  for (int j = threadIdx.x / HEAD_PIX; j < joints; j += blockDim.x / HEAD_PIX) {
    int acc = 0;
    const int* zr = zs + px * ld;
    const int* wr = ws + j * cw;
    for (int q = 0; q < cw; ++q) acc = __dp4a(zr[q], wr[q], acc);
    out[(static_cast<size_t>(j) * n_img + n) * total + pk] =
        scale_bias(acc, vh[j], vh[joints + j]);
  }
}

}  // namespace posetpu

using namespace posetpu;

extern "C" int phase_conv(const void* x, const void* w, const void* sv,
                          const void* bv, int phase_stride, const void* so,
                          void* out, int n, int h, int w_, int cin, int cout,
                          int out_mode, void* stream) {
  PhaseConvArgs p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
                  static_cast<const float*>(sv), static_cast<const float*>(bv),
                  phase_stride, static_cast<const float*>(so),
                  static_cast<int8_t*>(out), n, h, w_, cin, cout, out_mode};
  const int m = n * h * w_;
  dim3 grid((cout + BN - 1) / BN, (m + BM - 1) / BM, 4);
  phase_conv_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int phase_head(const void* z, const void* wh, const void* vh,
                          void* out, int n, int h2, int w2, int c, int joints,
                          int levels, void* stream) {
  const size_t smem = (HEAD_PIX * (c / 4 + 1) + joints * (c / 4)) * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        phase_head_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid((4 * h2 * w2 + HEAD_PIX - 1) / HEAD_PIX, n);
  phase_head_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(z), static_cast<const int8_t*>(wh),
      static_cast<const float*>(vh), static_cast<float*>(out), n, h2, w2, c,
      joints, levels);
  return static_cast<int>(cudaGetLastError());
}
