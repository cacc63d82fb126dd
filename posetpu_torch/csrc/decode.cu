// Fused heatmap decode (sm_90a).
//
// Replaces the Pallas TPU kernel B7 posetpu/ops/pallas/decode.py:
// decode_heatmaps_pallas (_decode_kernel). Per map [H, W] f32: the maximum,
// the FIRST row-major index that attains it, coords (x, y) zeroed where the
// maximum is <= 0, and for peaks strictly inside [2, W-2) x [2, H-2) a
// quarter-pixel nudge by the sign of the neighbour differences.
//
// Bound on the H100 by bytes: every map is read once (33.5 MB for 128 x 16
// maps of 64 x 64, ~0.010 ms at 3.35 TB/s) and 12 bytes are written per map;
// the reduction's operations are far below the card's rate. The design
// answers with one pass: one block per map, 16-byte loads where the map
// allows, a (value, index) reduction through warp shuffles in which equal
// values keep the LOWER index (the first-occurrence rule of argmax), then
// one thread reads the four neighbours, and only where the nudge applies
// (the TPU kernel reads wrapped neighbours and masks them afterwards).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace posetpu {

constexpr int DECODE_THREADS = 256;

__device__ __forceinline__ void take_first_max(float& best, int& idx, float v, int i) {
  if (v > best || (v == best && i < idx)) {
    best = v;
    idx = i;
  }
}

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

__global__ void __launch_bounds__(DECODE_THREADS) decode_kernel(
    const float* __restrict__ hm,  // [maps, H*W]
    float* __restrict__ coords,    // [maps, 2]
    float* __restrict__ maxvals,   // [maps]
    int h, int w, int post_process, int vec4) {
  const int hw = h * w;
  const float* map = hm + static_cast<size_t>(blockIdx.x) * hw;
  float best = -INFINITY;
  int idx = hw;
  if (vec4) {
    const float4* map4 = reinterpret_cast<const float4*>(map);
    for (int q = threadIdx.x; q < hw / 4; q += DECODE_THREADS) {
      const float4 v = map4[q];
      take_first_max(best, idx, v.x, 4 * q);
      take_first_max(best, idx, v.y, 4 * q + 1);
      take_first_max(best, idx, v.z, 4 * q + 2);
      take_first_max(best, idx, v.w, 4 * q + 3);
    }
  } else {
    for (int i = threadIdx.x; i < hw; i += DECODE_THREADS)
      take_first_max(best, idx, map[i], i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    take_first_max(best, idx, ov, oi);
  }
  __shared__ float s_best[DECODE_THREADS / 32];
  __shared__ int s_idx[DECODE_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    s_best[warp] = best;
    s_idx[warp] = idx;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  for (int k = 1; k < DECODE_THREADS / 32; ++k)
    take_first_max(best, idx, s_best[k], s_idx[k]);
  if (idx >= hw) idx = hw - 1;  // a map of NaNs: no element compared

  const float valid = best > 0.0f ? 1.0f : 0.0f;
  float x = static_cast<float>(idx % w) * valid;
  float y = static_cast<float>(idx / w) * valid;
  const int px = static_cast<int>(x), py = static_cast<int>(y);
  if (post_process && px > 1 && px < w - 1 && py > 1 && py < h - 1) {
    const int at = py * w + px;
    x += 0.25f * sign_of(map[at + 1] - map[at - 1]);
    y += 0.25f * sign_of(map[at + w] - map[at - w]);
  }
  coords[2 * static_cast<size_t>(blockIdx.x)] = x;
  coords[2 * static_cast<size_t>(blockIdx.x) + 1] = y;
  maxvals[blockIdx.x] = best;
}

}  // namespace posetpu

using namespace posetpu;

extern "C" int decode_heatmaps(const void* hm, void* coords, void* maxvals,
                               int maps, int h, int w, int post_process,
                               void* stream) {
  if (maps == 0) return 0;
  const int vec4 = (h * w) % 4 == 0 && reinterpret_cast<uintptr_t>(hm) % 16 == 0;
  decode_kernel<<<maps, DECODE_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hm), static_cast<float*>(coords),
      static_cast<float*>(maxvals), h, w, post_process, vec4);
  return static_cast<int>(cudaGetLastError());
}
