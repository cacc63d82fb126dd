// The int8 trunk's requantize as one pass a site (sm_90a).
//
// Replaces no TPU kernel: in the JAX package XLA fuses each convolution's
// requantize into the convolution. In the port the trunk's convolutions are
// im2col + torch._int_mm (models/quant.py), and the requantize of their int32
// sums ran as six to eight PyTorch passes that each read and wrote f32, plus
// about eight more at each residual block's tail. requant_kernel does a
// site's work in one pass: it reads the int32 sums acc [rows, cols] once (and
// the block's int8 residual, at a block's tail) and writes the int8 boundary
// once, with the arithmetic of csrc/requant.cuh (bit for bit the plain
// passes').
//
// Bound on the H100 by bytes (3.35 TB/s): 5 bytes an element, 6 with a
// residual. At the serving shapes (ResNet-50 at 256 x 256, 128 images) the 53
// sites of a request move 10,213 MB, 3.05 ms. The design aims at the card's
// bandwidth:
//   - a thread owns 8 consecutive channels and walks rows: two 16-byte
//     loads of the sums a row (streaming, evict-first: each is read once),
//     one 8-byte load of the residual and one 8-byte store of the int8
//     values. So the channels must be a multiple of 8, the sums 16-byte
//     aligned with a row stride that keeps them so, and the residual and the
//     output 8-byte aligned: ops/requant.py refuses anything else. Every
//     trunk site has a multiple of 64 channels, and the sums of a padded
//     torch._int_mm output keep a row stride that is a multiple of 32;
//   - its 8 scales and biases stay in registers across all its rows;
//   - a block is 128 threads, cols / 8 wide (at most 128) and as many rows
//     tall as fit; the grid holds as many blocks as the card keeps resident
//     (132 SMs x the blocks an SM fits) and they stride over the rows, so the
//     smallest site (layer4, 16.8 M elements) still fills every SM;
//   - the sums' row stride is an argument, so a column slice of a padded
//     torch._int_mm output is read in place.
// 16 channels a thread and 256 threads a block ran the block tails slower
// (64 registers, fewer loads in flight an SM); PERF.md has the times.

#include <cstdint>
#include <cuda_runtime.h>

#include "requant.cuh"

namespace posetpu {

constexpr int RQ_THREADS = 128;
constexpr int VEC = 8;  // channels a thread

// 8 int8 values from / to memory as one 8-byte load or store
__device__ __forceinline__ void load_bytes(const int8_t* p, int (&v)[VEC]) {
  const uint2 x = *reinterpret_cast<const uint2*>(p);
#pragma unroll
  for (int i = 0; i < VEC; ++i) v[i] = static_cast<int8_t>((i < 4 ? x.x : x.y) >> (8 * (i % 4)));
}

__device__ __forceinline__ void store_bytes(int8_t* p, const int (&v)[VEC]) {
  unsigned w[2] = {};
#pragma unroll
  for (int i = 0; i < VEC; ++i) w[i / 4] |= (static_cast<unsigned>(v[i]) & 0xFFu) << (8 * (i % 4));
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// acc [rows, cols] int32 (row stride ld) -> out [rows, cols] int8; with RES
// the block tail over res [rows, cols] int8, else the conv epilogue
template <bool RES>
__global__ void __launch_bounds__(RQ_THREADS) requant_kernel(
    const int* __restrict__ acc, int ld, const int8_t* __restrict__ res,
    int8_t* __restrict__ out, const float* __restrict__ sv, const float* __restrict__ bias,
    const float* __restrict__ inv_p, const float* __restrict__ rs_p, int rows, int cols,
    int relu, float hi) {
  const int groups = cols / VEC;
  const float inv = *inv_p;
  const float r_s = RES ? *rs_p : 0.0f;
  for (int g = blockIdx.y * blockDim.x + threadIdx.x; g < groups; g += gridDim.y * blockDim.x) {
    const int c0 = g * VEC;
    float s[VEC], b[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      s[i] = sv[c0 + i];
      b[i] = bias[c0 + i];
    }
    for (int m = blockIdx.x * blockDim.y + threadIdx.y; m < rows;
         m += gridDim.x * blockDim.y) {
      const int* src = acc + static_cast<size_t>(m) * ld + c0;
      int a[VEC];
#pragma unroll
      for (int u = 0; u < VEC / 4; ++u) {
        const int4 x = __ldcs(reinterpret_cast<const int4*>(src) + u);
        a[4 * u] = x.x, a[4 * u + 1] = x.y, a[4 * u + 2] = x.z, a[4 * u + 3] = x.w;
      }
      const size_t o = static_cast<size_t>(m) * cols + c0;
      int q[VEC];
      if constexpr (RES) {
        int r[VEC];
        load_bytes(res + o, r);
#pragma unroll
        for (int i = 0; i < VEC; ++i) q[i] = requant_tail(a[i], s[i], b[i], r[i], r_s, inv, hi);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) q[i] = requant_conv(a[i], s[i], b[i], relu, inv, hi);
      }
      store_bytes(out + o, q);
    }
  }
}

template <bool RES>
int launch(const void* acc, int ld, const void* res, void* out, const void* sv, const void* bias,
           const void* inv, const void* r_scale, int rows, int cols, int relu, int hi,
           cudaStream_t stream) {
  static int resident = 0;  // blocks the card keeps resident, for this instance
  if (!resident) {
    int dev = 0, sms = 0, fit = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, requant_kernel<RES>, RQ_THREADS, 0);
    if (e != cudaSuccess) return static_cast<int>(e);
    resident = sms * (fit > 0 ? fit : 1);
  }
  const int groups = cols / VEC;
  const int tx = groups < RQ_THREADS ? groups : RQ_THREADS;
  const int ty = RQ_THREADS / tx;
  const int gy = (groups + tx - 1) / tx;
  const int most = resident / gy > 0 ? resident / gy : 1;
  const int need = (rows + ty - 1) / ty;
  requant_kernel<RES><<<dim3(need < most ? need : most, gy), dim3(tx, ty), 0, stream>>>(
      static_cast<const int*>(acc), ld, static_cast<const int8_t*>(res),
      static_cast<int8_t*>(out), static_cast<const float*>(sv), static_cast<const float*>(bias),
      static_cast<const float*>(inv), static_cast<const float*>(r_scale), rows, cols, relu,
      static_cast<float>(hi));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace posetpu

using namespace posetpu;

// acc [rows, cols] int32 with row stride ld (>= cols) -> out [rows, cols]
// int8, contiguous; res (nullptr at a conv epilogue) [rows, cols] int8,
// contiguous; sv, bias [cols] f32; inv, r_scale 0-d f32 on the device. cols
// a multiple of 8, ld of 4, acc 16-byte aligned, res and out 8-byte aligned.
extern "C" int requant(const void* acc, int ld, const void* res, void* out, const void* sv,
                       const void* bias, const void* inv, const void* r_scale, int rows,
                       int cols, int relu, int hi, void* stream) {
  if (rows == 0 || cols == 0) return 0;
  const auto at = [](const void* p, int n) { return reinterpret_cast<uintptr_t>(p) % n == 0; };
  if (cols % VEC || ld % 4 || !at(acc, 16) || !at(out, 8) || (res && !at(res, 8)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return res ? launch<true>(acc, ld, res, out, sv, bias, inv, r_scale, rows, cols, relu, hi, s)
             : launch<false>(acc, ld, res, out, sv, bias, inv, r_scale, rows, cols, relu, hi, s);
}
