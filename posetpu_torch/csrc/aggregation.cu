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
// nibble-packed K-minor, wq4 [4, 3, S_out, S_in / 2] bytes (in every 32-deep
// k-block byte b holds k = b low and k = 16 + b high: ops/aggregation.py
// pack_nibbles_k), so the card reads 100.7 MB of weights at S = 4096, not
// 201 MB. Bound at the serving shapes: 1.03e11 MAC, 0.104 ms by operations;
// the packed bank alone is 0.030 ms of HBM. So B4 is B3's GEMM with the
// bank widened on its way to the tensor cores, which have no 4-bit integer
// type (aggregation_w4_kernel):
//   - a block computes a transposed tile out[t]^T, 128 bank rows (S_out) x
//     256 J*N columns: the bank is wgmma's A (64 rows a consumer warpgroup)
//     and xq its B, read by descriptor from the same 128-byte-swizzled TMA
//     box as B3's (256 rows x 128 bytes); the two J*N blocks of a bank tile
//     are neighbours in the grid's order, so the bank crosses HBM once;
//   - the producer warp brings each step's packed bank tile (128 rows x 64
//     bytes, 64-byte swizzle: a warp's 4-byte fragment loads hit 32 banks)
//     beside the xq box, on a ring of 40 KB stages with full / empty
//     mbarriers;
//   - each consumer thread loads word tig of its rows gid and gid + 8 per
//     32-deep k-block: with pack_nibbles_k's order the low nibbles are
//     k = 4 tig .. 4 tig + 3 and the high ones k = 16 + 4 tig .. + 3, which is
//     wgmma's (and mma.m16n8k32's) A fragment, so widening is two masks and
//     a sign extension (sext_nibbles) a register. It stores them into its
//     warpgroup's 128-byte-swizzled int8 A tile (two slots, one a step in
//     turn), fences the generic proxy's stores for the tensor cores, and
//     wgmma reads A by descriptor, one step's products in flight;
//   - the epilogue stages res = acc * sv through shared memory transposed,
//     then leaves 16-byte row stores of out [4, J*N, S], adding dia from xq's
//     bytes (eight rows' loads in flight) and dv (staged per block) four
//     outputs a thread.
// Feeding wgmma the widened registers as its A operand instead was built,
// held equal and measured 0.5-2.4 % slower on a ring of 4 (ptxas serialises
// those wgmmas, C7513: the next step's A registers are written while one is
// in flight), so it was removed; PERF.md has both designs' times
// (tools/torch_kernel_sweep.py agg).

#include "ring.cuh"

namespace posetpu {

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

// ---------------------------------------------------------------------------
// B4: TMA + wgmma on the nibble-packed bank, widened to int8 by the consumers

constexpr int W4_BM = 128, W4_BN = 256, W4_BK = 128;  // bank rows, J*N columns, k a step
constexpr int W4_X_BYTES = W4_BN * W4_BK;             // xq box, 128-byte swizzle
constexpr int W4_P_BYTES = W4_BM * W4_BK / 2;         // packed bank box, 64-byte swizzle
constexpr int W4_STAGE = W4_X_BYTES + W4_P_BYTES;     // 40 KB
constexpr int W4_A_BYTES = 64 * W4_BK;                // a warpgroup's widened A tile
constexpr int W4_LDO = W4_BM + 4;                     // floats a staged output row (m)
constexpr int W4_OUT_BYTES = W4_BN * W4_LDO * 4;      // the staged tile

// bytes before the mbarriers: the ring and each warpgroup's two A slots, at
// least the staged output tile the epilogue writes over them
__host__ __device__ constexpr int w4_ring_bytes(int stages) {
  return stages * W4_STAGE + 4 * W4_A_BYTES > W4_OUT_BYTES ? stages * W4_STAGE + 4 * W4_A_BYTES
                                                            : W4_OUT_BYTES;
}
// the mbarriers, then sv and dv of the block's 128 bank rows; 1 KB to align
__host__ __device__ constexpr int w4_smem(int stages) {
  return 1024 + w4_ring_bytes(stages) + 16 * stages + 4 * 4 * W4_BM;
}

__global__ void __launch_bounds__(G_THREADS, 1) aggregation_w4_kernel(
    const __grid_constant__ CUtensorMap tm_x,  // xq [4][JN][S], box 128 x 256 x 1
    const __grid_constant__ CUtensorMap tm_w,  // wq4 [4*3*S][S/2] bytes, box 64 x 128
    const int8_t* __restrict__ xq, const float* __restrict__ sv, const float* __restrict__ dv,
    float* __restrict__ out, int jn, int s, int stages) {
  extern __shared__ int8_t smem_raw[];
  const unsigned raw_s = smem_addr(smem_raw);
  int8_t* smem = smem_raw + ((1024 - (raw_s & 1023)) & 1023);  // 1024-aligned: the swizzles
  const unsigned smem_s = smem_addr(smem);
  const int ring = w4_ring_bytes(stages);
  const unsigned full0 = smem_s + ring, empty0 = full0 + 8 * stages;
  float* svs = reinterpret_cast<float*>(smem + ring + 16 * stages);
  float* dvs = svs + W4_BM;  // [3][128]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * W4_BN, o0 = blockIdx.y * W4_BM, t = blockIdx.z;
  const int kpp = (s + W4_BK - 1) / W4_BK;  // k-steps a source plane; past S reads zeros
  const int ksteps = 3 * kpp;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(full0 + 8 * i, 1);   // the producer's arrive, and the bytes
      mbar_init(empty0 + 8 * i, 8);  // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  for (int i = tid; i < W4_BM; i += G_THREADS) {
    const bool in = o0 + i < s;
    svs[i] = in ? sv[static_cast<size_t>(t) * s + o0 + i] : 0.0f;
#pragma unroll
    for (int p = 0; p < 3; ++p)
      dvs[p * W4_BM + i] = in ? dv[(static_cast<size_t>(t) * 3 + p) * s + o0 + i] : 0.0f;
  }
  __syncthreads();

  if (warp == 8) {  // the producer
    if (lane == 0) {
      for (int ks = 0; ks < ksteps; ++ks) {
        const int st = ks % stages;
        if (ks >= stages) mbar_wait(empty0 + 8 * st, ((ks / stages) - 1) & 1);
        const int p = ks / kpp, kk = (ks - p * kpp) * W4_BK;
        const int src = p < t ? p : p + 1;
        const unsigned dst = smem_s + st * W4_STAGE;
        mbar_expect_tx(full0 + 8 * st, W4_STAGE);
        tma_load_3d(dst, &tm_x, kk, n0, src, full0 + 8 * st);
        tma_load_2d(dst + W4_X_BYTES, &tm_w, kk / 2, (t * 3 + p) * s + o0, full0 + 8 * st);
      }
    }
    return;
  }

  // consumers: warpgroup wg takes bank rows 64 wg .. 64 wg + 63 of the tile,
  // warp wq of it rows 16 wq .. 16 wq + 15, this thread rows r0 and r0 + 8
  const int wg = warp >> 2, wq = warp & 3, gid = lane >> 2, tig = lane & 3;
  const int r0 = 64 * wg + 16 * wq + gid;
  // word tig of 16-byte chunk kk of packed row r sits in chunk kk ^ ((r >> 1) & 3)
  const int psw = (r0 >> 1) & 3;  // the same for r0 + 8

  int d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0;
  // two steps an iteration, so each one's A slot is a constant: 4-6 % faster
  // than one on the H100 (PERF.md)
#pragma unroll 2
  for (int ks = 0; ks < ksteps; ++ks) {
    const int st = ks % stages;
    mbar_wait(full0 + 8 * st, (ks / stages) & 1);
    // widen this thread's fragment words, then store them into this
    // warpgroup's A slot (ks & 1), 128-byte swizzle: byte k of row r in chunk
    // (k >> 4) ^ (r & 7); rows r0 - 64 wg and + 8 both have r & 7 = gid
    const int8_t* pk = smem + st * W4_STAGE + W4_X_BYTES + r0 * 64 + 4 * tig;
    const int slot = stages * W4_STAGE + ((ks & 1) * 2 + wg) * W4_A_BYTES;
    int8_t* as = smem + slot + (16 * wq + gid) * 128 + 4 * tig;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const unsigned w0 = *reinterpret_cast<const unsigned*>(pk + 16 * (kk ^ psw));
      const unsigned w1 = *reinterpret_cast<const unsigned*>(pk + 8 * 64 + 16 * (kk ^ psw));
      // rows r0 and r0 + 8, k 4 tig .. (low nibbles) and k 16 + 4 tig .. (high)
      *reinterpret_cast<unsigned*>(as + 16 * ((2 * kk) ^ gid)) = sext_nibbles(w0 & 0x0F0F0F0Fu);
      *reinterpret_cast<unsigned*>(as + 8 * 128 + 16 * ((2 * kk) ^ gid)) =
          sext_nibbles(w1 & 0x0F0F0F0Fu);
      *reinterpret_cast<unsigned*>(as + 16 * ((2 * kk + 1) ^ gid)) =
          sext_nibbles((w0 >> 4) & 0x0F0F0F0Fu);
      *reinterpret_cast<unsigned*>(as + 8 * 128 + 16 * ((2 * kk + 1) ^ gid)) =
          sext_nibbles((w1 >> 4) & 0x0F0F0F0Fu);
    }
    // the generic proxy's stores, visible to the tensor cores, from every warp
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" :: "r"(2 + wg) : "memory");
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const unsigned b = smem_s + st * W4_STAGE;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_m64n256k32(d, sw128_desc(smem_s + slot + 32 * kk), sw128_desc(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the step before this one has finished: its stage and A slot are free
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    keep_in_registers(d);
    if (ks > 0 && lane == 0) mbar_arrive(empty0 + 8 * ((ks - 1) % stages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  keep_in_registers(d);
  asm volatile("bar.sync 1, 256;\n" ::: "memory");  // every stage read: the ring is free

  // res = acc * sv, staged transposed [m][o]: d[4 i + r] is bank row (o)
  // 64 wg + 16 wq + gid (+8 for r >= 2), column (m) 8 i + 2 tig + (r & 1)
  float* so = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 32; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int o = r0 + 8 * (r >> 1), m = 8 * i + 2 * tig + (r & 1);
      so[m * W4_LDO + o] = __fmul_rn(__int2float_rn(d[4 * i + r]), svs[o]);
    }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  // out = res + dia, four outputs of one row a thread (S % 32 == 0: whole
  // float4s), eight rows at a time: their 24 loads of xq's bytes in flight
  // together, not one L2 round trip a row
  constexpr int kRows = 8;
#pragma unroll 1
  for (int it = 0; it < W4_BN * (W4_BM / 4) / 256; it += kRows) {
    char4 x[kRows][3];
    bool in[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int e = tid + 256 * (it + u), m = n0 + (e >> 5), o = o0 + (e & 31) * 4;
      in[u] = m < jn && o < s;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const int src = p < t ? p : p + 1;
        x[u][p] = in[u] ? *reinterpret_cast<const char4*>(
                              xq + (static_cast<size_t>(src) * jn + m) * s + o)
                        : make_char4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int e = tid + 256 * (it + u), ml = e >> 5, c = (e & 31) * 4;
      if (!in[u]) continue;
      const float4 res = *reinterpret_cast<const float4*>(so + ml * W4_LDO + c);
      float4 dia;
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const float4 v = *reinterpret_cast<const float4*>(dvs + p * W4_BM + c);
        const float4 dp = make_float4(__fmul_rn(static_cast<float>(x[u][p].x), v.x),
                                      __fmul_rn(static_cast<float>(x[u][p].y), v.y),
                                      __fmul_rn(static_cast<float>(x[u][p].z), v.z),
                                      __fmul_rn(static_cast<float>(x[u][p].w), v.w));
        dia = p == 0 ? dp
                     : make_float4(__fadd_rn(dia.x, dp.x), __fadd_rn(dia.y, dp.y),
                                   __fadd_rn(dia.z, dp.z), __fadd_rn(dia.w, dp.w));
      }
      *reinterpret_cast<float4*>(out + (static_cast<size_t>(t) * jn + n0 + ml) * s + o0 + c) =
          make_float4(__fadd_rn(res.x, dia.x), __fadd_rn(res.y, dia.y),
                      __fadd_rn(res.z, dia.z), __fadd_rn(res.w, dia.w));
    }
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

// B4. S % 32 == 0, any J*N; ``stages`` the ring's depth (w4_smem must fit a
// block).
extern "C" int aggregation_grouped_s4(const void* xq, const void* wq4, const void* sv,
                                      const void* dv, void* out, int jn, int s, int stages,
                                      void* stream) {
  static int configured = 0;
  const int smem = w4_smem(stages);
  if (stages < 2 || smem > 232448)  // a block's shared memory
    return static_cast<int>(cudaErrorInvalidValue);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(aggregation_w4_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  CUtensorMap tm_x, tm_w;
  const cuuint64_t xd[3] = {static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(jn), 4};
  const cuuint64_t xp[2] = {static_cast<cuuint64_t>(s), static_cast<cuuint64_t>(jn) * s};
  const cuuint32_t xb[3] = {W4_BK, W4_BN, 1};
  const cuuint64_t wd[2] = {static_cast<cuuint64_t>(s / 2), 12ull * s};
  const cuuint64_t wp[1] = {static_cast<cuuint64_t>(s / 2)};
  const cuuint32_t wb[2] = {W4_BK / 2, W4_BM};
  if (!uint8_map(&tm_x, xq, 3, xd, xp, xb, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !uint8_map(&tm_w, wq4, 2, wd, wp, wb, CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((jn + W4_BN - 1) / W4_BN, (s + W4_BM - 1) / W4_BM, 4);
  aggregation_w4_kernel<<<grid, G_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      tm_x, tm_w, static_cast<const int8_t*>(xq), static_cast<const float*>(sv),
      static_cast<const float*>(dv), static_cast<float*>(out), jn, s, stages);
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
