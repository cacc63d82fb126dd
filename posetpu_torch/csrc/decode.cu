// Fused heatmap decode (sm_90a).
//
// Replaces the Pallas TPU kernel B7 posetpu/ops/pallas/decode.py:
// decode_heatmaps_pallas (_decode_kernel). Per map [H, W] f32: the maximum,
// the FIRST row-major index that attains it, coords (x, y) zeroed where the
// maximum is <= 0, and for peaks strictly inside [2, W-2) x [2, H-2) a
// quarter-pixel nudge by the sign of the neighbour differences.
//
// Bound on the H100 by bytes: every map is read once (8.4 MB for 512 maps of
// 64 x 64, 0.0025 ms at 3.35 TB/s; 33.5 MB, 0.010 ms, for 2,048) and 12 bytes
// are written per map; the reduction's operations are far below the card's
// rate. At these sizes the kernel is a few microseconds and what a caller
// waits for is the launch and the wrapper around it, so the design keeps
// both short: one warp per map and DECODE_WARPS maps per block, each lane
// reading 16-byte vectors UNROLL at a time into four running maxima (one
// per vector component: four short compare chains, not one long one), a
// (value, first index) reduction through warp shuffles alone in which equal
// values keep the LOWER index (the first-occurrence rule of argmax) — no
// shared memory and no block barrier — then lane 0 reads the four neighbours, only where the nudge applies (the
// TPU kernel reads wrapped neighbours and masks them afterwards), and writes
// (x, y, max) as one row of a single [maps, 3] output, so the wrapper
// allocates once. What the one-warp-a-map shape costs: at 512 maps there
// are four warps to an SM and fewer loads in flight than the earlier
// 256-threads-a-map kernel had, 0.0041-0.0047 ms against its 0.0034 ms
// (the compiler keeps only a few of a round's loads in flight whatever the
// unroll; forcing 32 with volatile loads changed nothing measurable); at
// 2,048 maps it is the faster one (0.013 against 0.014 ms, PERF.md).

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace posetpu {

constexpr int DECODE_WARPS = 4;  // maps per block
constexpr int DECODE_UNROLL = 8;

__device__ __forceinline__ void take_first_max(float& best, int& idx, float v, int i) {
  if (v > best || (v == best && i < idx)) {
    best = v;
    idx = i;
  }
}

__device__ __forceinline__ float sign_of(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

// Rounds of U vectors a lane, from vector q on, while a whole round is left.
// Four running maxima, one per vector component, so that a lane's compares
// are four short chains and not one long one.
template <int U>
__device__ __forceinline__ void scan_vectors(const float4* __restrict__ map4, int n4, int& q,
                                             float (&best)[4], int (&idx)[4]) {
  for (; q + 32 * (U - 1) < n4; q += 32 * U) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) v[u] = map4[q + 32 * u];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = 4 * (q + 32 * u);
      take_first_max(best[0], idx[0], v[u].x, i);
      take_first_max(best[1], idx[1], v[u].y, i + 1);
      take_first_max(best[2], idx[2], v[u].z, i + 2);
      take_first_max(best[3], idx[3], v[u].w, i + 3);
    }
  }
}

__global__ void __launch_bounds__(DECODE_WARPS * 32) decode_kernel(
    const float* __restrict__ hm,  // [maps, H*W]
    float* __restrict__ out,       // [maps, 3]: x, y, max
    int maps, int h, int w, int post_process, int vec4) {
  const int lane = threadIdx.x & 31;
  const int m = static_cast<int>(blockIdx.x) * DECODE_WARPS + (threadIdx.x >> 5);
  if (m >= maps) return;  // whole warps leave: the shuffles below stay full
  const int hw = h * w;
  const float* map = hm + static_cast<size_t>(m) * hw;
  float best = -INFINITY;
  int idx = hw;
  if (vec4) {
    const float4* map4 = reinterpret_cast<const float4*>(map);
    const int n4 = hw / 4;
    float b4[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
    int i4[4] = {hw, hw, hw, hw};
    int q = lane;
    scan_vectors<DECODE_UNROLL>(map4, n4, q, b4, i4);
    scan_vectors<1>(map4, n4, q, b4, i4);
#pragma unroll
    for (int c = 0; c < 4; ++c) take_first_max(best, idx, b4[c], i4[c]);
  } else {
    for (int i = lane; i < hw; i += 32) take_first_max(best, idx, map[i], i);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, idx, off);
    take_first_max(best, idx, ov, oi);
  }
  if (lane != 0) return;
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
  float* o = out + 3 * static_cast<size_t>(m);
  o[0] = x;
  o[1] = y;
  o[2] = best;
}

}  // namespace posetpu

using namespace posetpu;

// 16-byte loads need every map 16-byte aligned: the base, and H*W % 4 == 0.
extern "C" int decode_heatmaps(const void* hm, void* out, int maps, int h, int w,
                               int post_process, void* stream) {
  if (maps == 0) return 0;
  const int vec4 = (h * w) % 4 == 0 && reinterpret_cast<uintptr_t>(hm) % 16 == 0;
  const int blocks = (maps + DECODE_WARPS - 1) / DECODE_WARPS;
  decode_kernel<<<blocks, DECODE_WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hm), static_cast<float*>(out), maps, h, w, post_process,
      vec4);
  return static_cast<int>(cudaGetLastError());
}
