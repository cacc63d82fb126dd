// Grouped int8 cross-view aggregation (sm_90a).
//
// Replaces the Pallas TPU kernel B3 posetpu/ops/pallas/aggregation.py:
// aggregation_grouped_pallas (_agg_kernel / _agg_kernel_jnb), and the XLA
// fusion its wrapper runs first (aggregation.py:184-193). For each target
// view t, out[t] = (sum over its 3 source views p of xq[src(t, p)] @ wq[t, p])
// * sv[t]: a grouped GEMM [JN, 3*S] x [3*S, S] with exact int32 sums and one
// f32 multiply by sv = (x_scale/3) * w_scale, folded once when the bank is
// put on the device. The source planes of xq [V, JN, S] are read in place
// (the k-block picks the plane: src = p < t ? p : p + 1), so no gathered 3x
// copy exists. The bank is stored K-minor, wq [4, 3, S_out, S_in].
//
// quantize_kernel: hm [J, NG, 4, S] f32 -> xq [4, J*NG, S] int8,
// clip(rint(hm * (1 / x_scale)), -127, 127) with the reciprocal a correctly
// rounded divide and the multiply rounded on its own (the value of the plain
// version and of XLA's fusion), 16 values a thread: 64 bytes read and 16
// written, both contiguous across a warp. One pass where PyTorch took four
// to five and a copy.
//
// Bound on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s), at the serving
// shapes (J*N = 512, S = 4096): 1.03e11 MAC, ~0.104 ms, compute-bound, with
// the bank's 201 MB giving a 0.060 ms memory floor close behind. Both
// operands are plain K-contiguous rows and K is 12,288 deep, so B3 is the
// textbook Hopper GEMM (aggregation_kernel):
//   - a block computes a 128 x 256 tile of one target; the 4 row blocks of a
//     bank tile are neighbours in the grid's order, so they run together and
//     the 201 MB bank crosses HBM about once a request;
//   - a producer warp walks K in steps of 128 bytes and asks the tensor
//     memory accelerator for both operands: A through a 3D tensor map over
//     xq [4, JN, S] (the k-step picks the plane), B through a 2D map over
//     the bank [4*3*S_out, S_in]; 128-byte swizzle, rows past JN or columns
//     past S arrive as zeros. The maps are encoded on the host with
//     cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint (no
//     -lcuda), and passed as __grid_constant__ parameters;
//   - a ring of 4 stages (48 KB each) with full / empty mbarriers; two
//     consumer warpgroups each run wgmma.mma_async m64n256k32 s8 on their 64
//     rows with both operands read by descriptor, and keep the next step's
//     products in flight (wgmma.wait_group 1) before they free a stage;
//   - the epilogue multiplies by sv from shared memory, stages the f32 tile
//     through the ring's memory and leaves it in 16-byte stores.
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
// B4 keeps its first design (int8_mma.cuh's two-stage loop).

#include "ring.cuh"

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

// ---------------------------------------------------------------------------
// B3: TMA + wgmma

constexpr int G_BM = 128, G_BN = 256, G_BK = 128, G_STAGES = 4;
constexpr int G_A_BYTES = G_BM * G_BK, G_B_BYTES = G_BN * G_BK;
constexpr int G_STAGE = G_A_BYTES + G_B_BYTES;
constexpr int G_THREADS = 2 * 128 + 32;  // two consumer warpgroups, one producer warp
constexpr int G_LDO = G_BN * 4 + 16;     // a staged output row, bytes
constexpr int G_SMEM = 1024 + G_STAGES * G_STAGE + 2 * G_STAGES * 8 + G_BN * 4;

// K-major operand in shared memory, 128-byte swizzle: rows of 128 bytes,
// 8-row groups 1024 bytes apart (the tile starts 1024-aligned)
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(1024 >> 4) << 32) | (uint64_t(1) << 62);
}

__device__ __forceinline__ void wgmma_m64n256k32(int (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63,%64,%65,%66,%67,%68,%69,%70,%71,%72,%73,%74,%75,%76,%77,%78,%79,%80,%81,%82,%83,%84,%85,%86,%87,%88,%89,%90,%91,%92,%93,%94,%95,%96,%97,%98,%99,%100,%101,%102,%103,%104,%105,%106,%107,%108,%109,%110,%111,%112,%113,%114,%115,%116,%117,%118,%119,%120,%121,%122,%123,%124,%125,%126,%127}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(da), "l"(db));
}

// the compiler must not move the accumulators while a wgmma may write them
__device__ __forceinline__ void keep_in_registers(int (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__global__ void __launch_bounds__(G_THREADS, 1) aggregation_kernel(
    const __grid_constant__ CUtensorMap tm_x,  // xq [4][JN][S], box 128 x 128 x 1
    const __grid_constant__ CUtensorMap tm_w,  // wq [4*3*S][S], box 128 x 256
    const float* __restrict__ sv, float* __restrict__ out, int jn, int s) {
  extern __shared__ int8_t smem_raw[];
  const unsigned raw_s = smem_addr(smem_raw);
  int8_t* smem = smem_raw + ((1024 - (raw_s & 1023)) & 1023);  // 1024-aligned: the swizzle
  const unsigned smem_s = smem_addr(smem);
  const unsigned full0 = smem_s + G_STAGES * G_STAGE, empty0 = full0 + G_STAGES * 8;
  float* svs = reinterpret_cast<float*>(smem + G_STAGES * G_STAGE + 2 * G_STAGES * 8);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = blockIdx.x * G_BM, n0 = blockIdx.y * G_BN, t = blockIdx.z;
  const int kpp = (s + G_BK - 1) / G_BK;  // k-steps a source plane; past S reads zeros
  const int ksteps = 3 * kpp;

  if (tid == 0) {
    for (int i = 0; i < G_STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);   // the producer's arrive, and the bytes
      mbar_init(empty0 + 8 * i, 8);  // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  for (int i = tid; i < G_BN; i += G_THREADS)
    svs[i] = n0 + i < s ? sv[static_cast<size_t>(t) * s + n0 + i] : 0.0f;
  __syncthreads();

  if (warp == 8) {  // the producer
    if (lane == 0) {
      for (int ks = 0; ks < ksteps; ++ks) {
        const int st = ks % G_STAGES;
        if (ks >= G_STAGES) mbar_wait(empty0 + 8 * st, ((ks / G_STAGES) - 1) & 1);
        const int p = ks / kpp, kk = (ks - p * kpp) * G_BK;
        const int src = p < t ? p : p + 1;
        const unsigned a_dst = smem_s + st * G_STAGE;
        mbar_expect_tx(full0 + 8 * st, G_STAGE);
        tma_load_3d(a_dst, &tm_x, kk, m0, src, full0 + 8 * st);
        tma_load_2d(a_dst + G_A_BYTES, &tm_w, kk, (t * 3 + p) * s + n0, full0 + 8 * st);
      }
    }
    return;
  }

  // consumers: warpgroup wg takes rows 64 wg .. 64 wg + 63 of the tile
  const int wg = warp >> 2;
  int d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  for (int ks = 0; ks < ksteps; ++ks) {
    const int st = ks % G_STAGES;
    mbar_wait(full0 + 8 * st, (ks / G_STAGES) & 1);
    const unsigned a = smem_s + st * G_STAGE + wg * 64 * G_BK, b = smem_s + st * G_STAGE + G_A_BYTES;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < G_BK / 32; ++k)
      wgmma_m64n256k32(d, sw128_desc(a + 32 * k), sw128_desc(b + 32 * k));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the step before this one has finished reading its stage: free it
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    keep_in_registers(d);
    if (ks > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((ks - 1) % G_STAGES));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  keep_in_registers(d);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every stage read: the ring is free

  // out = acc * sv, staged: d[4i + r] is row 16 w + lane/4 (+8 for r >= 2),
  // column 8 i + 2 (lane % 4) + (r & 1) of this warpgroup's 64 x 256
  const int row = wg * 64 + (warp & 3) * 16 + (lane >> 2), col = 2 * (lane & 3);
  int8_t* so = smem + row * G_LDO;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int c = 8 * i + col;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float2 v;
      v.x = __fmul_rn(__int2float_rn(d[4 * i + 2 * h]), svs[c]);
      v.y = __fmul_rn(__int2float_rn(d[4 * i + 2 * h + 1]), svs[c + 1]);
      *reinterpret_cast<float2*>(so + h * 8 * G_LDO + c * 4) = v;
    }
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  for (int e = tid; e < G_BM * (G_BN / 4); e += 256) {  // S % 16 == 0: whole float4s
    const int r = e >> 6, c = (e & 63) * 4;
    const int m = m0 + r, o = n0 + c;
    if (m < jn && o < s)
      *reinterpret_cast<float4*>(out + (static_cast<size_t>(t) * jn + m) * s + o) =
          *reinterpret_cast<const float4*>(smem + r * G_LDO + c * 4);
  }
}

// hm [J, NG, 4, S] f32 -> xq [4, J*NG, S] int8, 16 values a thread (S % 16 == 0)
__global__ void __launch_bounds__(256) quantize_kernel(const float* __restrict__ hm,
                                                       const float* __restrict__ x_scale,
                                                       int8_t* __restrict__ xq, int jn, int s) {
  const int chunks = s / 16;
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (e >= static_cast<size_t>(4) * jn * chunks) return;
  const float inv = __fdiv_rn(1.0f, *x_scale);
  const int ch = static_cast<int>(e % chunks);
  const size_t vr = e / chunks;  // v * jn + r
  const int r = static_cast<int>(vr % jn), v = static_cast<int>(vr / jn);
  const float4* src = reinterpret_cast<const float4*>(
      hm + (static_cast<size_t>(r) * 4 + v) * s + ch * 16);
  unsigned w[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 f = src[u];
    const float fv[4] = {f.x, f.y, f.z, f.w};
    unsigned word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const float q = fminf(fmaxf(rintf(__fmul_rn(fv[b], inv)), -127.0f), 127.0f);
      word |= (static_cast<unsigned>(static_cast<int>(q)) & 0xFFu) << (8 * b);
    }
    w[u] = word;
  }
  *reinterpret_cast<uint4*>(xq + vr * s + ch * 16) = make_uint4(w[0], w[1], w[2], w[3]);
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

// B3. S % 16 == 0 (a tensor map's row pitch), any J*N.
extern "C" int aggregation_grouped(const void* xq, const void* wq,
                                   const void* sv, void* out, int jn, int s,
                                   void* stream) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(aggregation_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  CUtensorMap tm_x, tm_w;
  const cuuint64_t xd[3] = {static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(jn), 4};
  const cuuint64_t xp[2] = {static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(jn) * s};
  const cuuint32_t xb[3] = {G_BK, G_BM, 1};
  const cuuint64_t wd[2] = {static_cast<cuuint64_t>(s), 12ull * s};
  const cuuint64_t wp[1] = {static_cast<cuuint64_t>(s)};
  const cuuint32_t wb[2] = {G_BK, G_BN};
  if (!uint8_map(&tm_x, xq, 3, xd, xp, xb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !uint8_map(&tm_w, wq, 2, wd, wp, wb, CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((jn + G_BM - 1) / G_BM, (s + G_BN - 1) / G_BN, 4);
  aggregation_kernel<<<grid, G_THREADS, G_SMEM, static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, static_cast<const float*>(sv), static_cast<float*>(out), jn, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int quantize_heatmaps(const void* hm, const void* x_scale, void* xq, int jn, int s,
                                 void* stream) {
  const size_t threads = static_cast<size_t>(4) * jn * (s / 16);
  quantize_kernel<<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(hm), static_cast<const float*>(x_scale),
      static_cast<int8_t*>(xq), jn, s);
  return static_cast<int>(cudaGetLastError());
}
