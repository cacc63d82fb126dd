// Grouped int8 cross-view aggregation (sm_90a).
//
// Replaces the Pallas TPU kernel B3 posetpu/ops/pallas/aggregation.py:
// aggregation_grouped_pallas (_agg_kernel / _agg_kernel_jnb). For each
// target view t, out[t] = (sum over its 3 source views p of
// xq[src(t, p)] @ wq[t, p]) * sv[t]: a grouped GEMM [JN, 3*S] x [3*S, S]
// with exact int32 sums and one f32 multiply by the pre-folded
// sv = (x_scale/3) * w_scale. The source planes of xq [V, JN, S] are read in
// place (the k-block picks the plane: src = p < t ? p : p + 1), so no
// gathered 3x copy exists. The bank is stored K-minor, wq [4, 3, S_out, S_in].
//
// Bound on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s), at the serving
// shapes (J*N = 512, S = 4096): 1.03e11 MAC, ~0.104 ms, compute-bound, with
// the bank's 201 MB giving a 0.060 ms memory floor (0.073 ms with every
// input and output counted) close behind. The design answers with int8
// tensor-core mma.sync on 128x128 tiles; each bank tile is read by the
// JN/128 = 4 row blocks of its target, mostly from L2. Not yet at the bound
// (mma.sync, not wgmma/TMA; no persistent weight streaming).
//
// B4 replaces aggregation_grouped_pallas_s4 (_agg_kernel_s4): the same dot on
// a 4-bit residual bank plus the exact f32 diagonal term,
//   out = acc * sv[t] + sum_p xq[src(t, p)][m, o] * dv[t, p][o]
// with res and dia each built from separately rounded multiplies and adds,
// dia summed in pair order p = 0, 1, 2, then res + dia. The bank arrives
// nibble-packed K-minor, wq4 [4, 3, S_out, S_in / 2] bytes (int8_mma.cuh:
// mma_mainloop_w4 gives the order), so the card reads 100.7 MB of weights at
// S = 4096, not 201 MB; each nibble pair is widened to int8 in registers and
// fed to the same mma.sync. Bound at the serving shapes: 1.03e11 MAC,
// ~0.104 ms by operations; all inputs and outputs (~152 MB) are 0.045 ms.

#include "int8_mma.cuh"

namespace posetpu {

struct AggARow {
  const int8_t* xq;
  int t, m, jn, s;
  __device__ const void* operator()(int k, bool& valid) const {
    const int p = k / s, kk = k - p * s;
    const int src = p < t ? p : p + 1;
    valid = m < jn;
    return valid ? xq + (static_cast<size_t>(src) * jn + m) * s + kk : xq;
  }
};

struct AggBRow {
  const int8_t* wq;
  int t, o, s;
  __device__ const void* operator()(int k, bool& valid) const {
    const int p = k / s, kk = k - p * s;
    valid = o < s;
    return valid ? wq + ((static_cast<size_t>(t) * 3 + p) * s + o) * s + kk : wq;
  }
};

__global__ void __launch_bounds__(THREADS) aggregation_kernel(
    const int8_t* xq, const int8_t* wq, const float* sv, float* out, int jn,
    int s) {
  const int t = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int lrow = threadIdx.x >> 1;
  AggARow la{xq, t, m0 + lrow, jn, s};
  AggBRow lb{wq, t, n0 + lrow, s};

  Acc acc;
  mma_mainloop(la, lb, 3 * s / BK, acc);

  const float* svt = sv + static_cast<size_t>(t) * s;
  for_each_pair(acc, [&](int row, int col, int v0, int v1) {
    const int m = m0 + row, o = n0 + col;
    if (m >= jn || o >= s) return;
    float2 r;
    r.x = __fmul_rn(__int2float_rn(v0), svt[o]);
    r.y = __fmul_rn(__int2float_rn(v1), svt[o + 1]);
    *reinterpret_cast<float2*>(out + (static_cast<size_t>(t) * jn + m) * s + o) = r;
  });
}

struct AggB4Row {
  const uint8_t* wq4;
  int t, o, s;
  __device__ const void* operator()(int k_byte, bool& valid) const {
    const int half = s / 2;
    const int p = k_byte / half, kk = k_byte - p * half;
    valid = o < s;
    return valid ? wq4 + ((static_cast<size_t>(t) * 3 + p) * s + o) * half + kk : wq4;
  }
};

__global__ void __launch_bounds__(THREADS) aggregation_s4_kernel(
    const int8_t* xq, const uint8_t* wq4, const float* sv, const float* dv,
    float* out, int jn, int s) {
  const int t = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  AggARow la{xq, t, m0 + (static_cast<int>(threadIdx.x) >> 1), jn, s};
  AggB4Row lb{wq4, t, n0 + static_cast<int>(threadIdx.x), s};

  Acc acc;
  mma_mainloop_w4(la, lb, 3 * s / BK, acc);

  const float* svt = sv + static_cast<size_t>(t) * s;
  const float* dvt = dv + static_cast<size_t>(t) * 3 * s;
  for_each_pair(acc, [&](int row, int col, int v0, int v1) {
    const int m = m0 + row, o = n0 + col;
    if (m >= jn || o >= s) return;
    float dia[2];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const int src = p < t ? p : p + 1;
      const char2 x = *reinterpret_cast<const char2*>(
          xq + (static_cast<size_t>(src) * jn + m) * s + o);
      const float d0 = __fmul_rn(static_cast<float>(x.x), dvt[p * s + o]);
      const float d1 = __fmul_rn(static_cast<float>(x.y), dvt[p * s + o + 1]);
      dia[0] = p == 0 ? d0 : __fadd_rn(dia[0], d0);
      dia[1] = p == 0 ? d1 : __fadd_rn(dia[1], d1);
    }
    float2 r;
    r.x = __fadd_rn(__fmul_rn(__int2float_rn(v0), svt[o]), dia[0]);
    r.y = __fadd_rn(__fmul_rn(__int2float_rn(v1), svt[o + 1]), dia[1]);
    *reinterpret_cast<float2*>(out + (static_cast<size_t>(t) * jn + m) * s + o) = r;
  });
}

}  // namespace posetpu

using namespace posetpu;

extern "C" int aggregation_grouped_s4(const void* xq, const void* wq4,
                                      const void* sv, const void* dv, void* out,
                                      int jn, int s, void* stream) {
  dim3 grid((s + BN - 1) / BN, (jn + BM - 1) / BM, 4);
  aggregation_s4_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const uint8_t*>(wq4),
      static_cast<const float*>(sv), static_cast<const float*>(dv),
      static_cast<float*>(out), jn, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int aggregation_grouped(const void* xq, const void* wq,
                                   const void* sv, void* out, int jn, int s,
                                   void* stream) {
  dim3 grid((s + BN - 1) / BN, (jn + BM - 1) / BM, 4);
  aggregation_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(sv), static_cast<float*>(out), jn, s);
  return static_cast<int>(cudaGetLastError());
}
