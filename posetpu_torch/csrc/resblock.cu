// Fused int8 ResNet bottleneck kernels (sm_90a).
//
// Replaces two Pallas TPU kernels of posetpu/ops/pallas/resblock.py:
//   B8a fused_bottleneck (_bottleneck_kernel, _bottleneck_ds_kernel) — a
//       whole stride-1 bottleneck, conv1 1x1 -> requant -> conv2 3x3 ->
//       requant -> conv3 1x1 + residual -> ReLU -> requant, with the identity
//       residual or a 1x1 projection requantised to int8 (no ReLU) first;
//   B8b fused_bottleneck_v2 (_bottleneck_kernel_v2) — the same function,
//       identity residual only, several images per grid step and the 3x3
//       conv as one K = 9*Cm product over im2col patches.
//
// The TPU kernels hold a whole image in VMEM; a thread block has 227 KB. B8a
// takes ``th`` output rows of one image, B8b a tile of 128 output pixels;
// each computes conv1 on its tile's halo (recomputed by the neighbours),
// keeps h1 and h2 in shared memory and reads x and writes out once. All sums
// are exact int32, so B8b's output equals B8a's.
//
// B8a, bottleneck_rows_kernel. The H100's bound (1,979 TOP/s int8 dense, 3.35
// TB/s) at 128 images of 256^2 input: layer1 (7.0e4 MAC per pixel x 4096
// pixels, 268 MB of x and out: 0.080 ms) and layer2 (0.040 ms) by bytes,
// layer3 and layer4 (0.037 ms) by operations. The kernel is at neither. The
// first version waited: every 32-byte k-step was an L2 round trip behind two
// barriers with one block on the SM. This one no longer waits for memory (a
// block's cp.async and mbarrier waits are ~2 % of its cycles, clock64); it
// is bound by instructions: a 128 x 128 x 64 k-step is 32 mma.sync and 12
// ldmatrix a warp beside the step's bookkeeping, and an epilogue is ~14
// instructions a value, of which the conversions run at half rate. mma.sync
// itself reaches 1,270 TOP/s on this card and wgmma 1,950 (tools/imma_rate.cu),
// so the way on is fewer, fatter steps (wgmma m64n256, K = 128 a stage), which
// needs the shared memory of a whole SM: PERF.md has the steps and numbers.
// The design:
//   - the whole block is ONE software pipeline. conv1, conv2, the projection
//     and conv3 are a flat list of k-steps over (phase, m-tile, n-tile, k);
//     a load cursor runs STAGES - 1 steps ahead of the compute loops through
//     a ring of STAGES stages, KB = 64 bytes of K each, across tile and phase
//     borders, so the ring is filled once per block and not once per tile.
//     One __syncthreads per step orders the ring's reuse and the epilogues'
//     writes to h1/h2 before their readers;
//   - the weights arrive as stage images: ops/resblock.py tiles each weight
//     once into [n-tile][k-step][128 rows][64 bytes] blocks laid out exactly
//     as a ring stage (tile_weight), so a step's B operand is one bulk copy
//     (cp.async.bulk, the TMA engine's plain form: no tensor map, nothing
//     beyond the CUDA runtime) asked for by one thread and counted by an mbarrier. Only where A
//     streams from x (conv1, the projection) do the threads copy with
//     cp.async, two 16-byte chunks each;
//   - ring rows are 64 bytes with their 16-byte chunks XOR-swizzled by
//     (row >> 1) & 3 (wgmma's 64-byte swizzle, should a later version read B
//     by descriptor), so ldmatrix hits 32 banks without padding: a stage is
//     8 KB and two blocks share an SM (__launch_bounds__(256, 2), <= 113 KB
//     of shared memory each), one computing while the other is in an epilogue;
//   - fragments come by ldmatrix.x4 (6 a 32-deep step instead of 24 ld.shared);
//   - h1 is kept with one zero column left and right of every row, so a 3x3
//     tap is a constant offset and conv2's A fragments need no predicate;
//   - at Cm = 64 conv1 and conv2 run 128 x 64 tiles (warps 4 x 2 of 32 x 32)
//     and all eight warps work;
//   - scales and biases wait in shared memory (v1, v2 whole; v3, vr, vd a
//     tile's 128 columns at a time): fetched from device memory they cost an
//     L2 round trip per column pair;
//   - a conv3 tile's identity residual and scale slices arrive by 16-byte
//     cp.async into a staging tile one tile ahead (two where a tile is one
//     k-step), the epilogue adds in place and the tile leaves as 16-byte
//     stores, rows contiguous. The staging tiles lie over h1, which conv3 no
//     longer needs. The projection writes its int8 residual into the same tile.
// Output rows of a row tile are contiguous in device memory (pixel = first
// + m), so no epilogue divides.
//
// B8b, bottleneck_v2_kernel: three chained wgmma GEMMs on an h1 halo that
// stays in shared memory. Its bound is B8a's (the same function and bytes).
// A job is one image's tile of output pixels in one of two forms
// (ops/resblock.plan_v2): "tile", 16 x 8 pixels and their 18 x 10 halo, two
// warpgroups of 8 rows of 8 pixels; "split", 8 x 8 pixels and their 10 x 10
// halo, which both warpgroups compute, each half of every conv's columns.
// Ragged tiles are masked at the store. The grid is persistent: as
// many blocks as fit the card at once, each walking its share of the jobs.
//   - a producer warp keeps one ring of stages full across convs, n-tiles
//     and jobs (full and empty mbarriers, ``stages`` - 1 steps ahead, the
//     consumers never wait for each other a step): a stage is IPS weight
//     images (64 bytes of K each: B8a's stage images, tile_weight, 64-byte
//     swizzled, B by descriptor) by cp.async.bulk, and in conv1 beside each
//     the same 64 channels of x's halo by TMA through a 4D tensor map over
//     x [N][H][W][Cin] (zero fill outside the tensor; its 64-byte swizzle
//     lands the rows as wgmma's K-major A).
//   - conv1: each warpgroup runs two m64 slices of consecutive halo pixels
//     from its own 10 x 10 halo on (the rows past it are thrown away). The
//     epilogue writes h1 as [Cm / 16][halo pixel][16 bytes] and writes 0 at
//     a pixel outside the image: conv2's padding is on h1, and a zero x
//     pixel gives requant(bias), not 0.
//   - conv2: 9 taps x Cm / 32 k32 instructions, A the h1 planes at the tap's
//     constant offset (8 pixels x 16 bytes a core matrix, 160 bytes to the
//     next tile row), picked instruction by instruction (at Cm = 32 or 96 a
//     64-byte k-step spans two taps); in the split form even and odd
//     instructions into two accumulators (two chains in the tensor pipe).
//     The epilogue writes h2 as [Cm / 16][output pixel][16 bytes].
//   - conv3: A is h2, B w3t in 128-column n-tiles; an n-tile's residual and
//     its v3 / vr slices arrive by cp.async into one of two staging tiles
//     (over h1, which conv3 no longer reads) an n-tile ahead; B8a's epilogue
//     arithmetic; 16-byte stores.
//   - a warpgroup keeps a step's products in flight while the next step's
//     are issued (wgmma.wait_group 1), as tail2_kernel does.
//   - an epilogue computes its values in registers and stores them after:
//     a shared-memory store between its loads orders them pair by pair.
// Measured (PERF.md, tools/torch_kernel_sweep.py v2, the clock64 counters
// of the kernel's timed instances, bottleneck_v2_clocked): the two warpgroups reach their epilogues together and the
// tensor pipe idles through them, a third to a half of the cycles at
// layer1-3; the rest is the products and the ring's waits, which at layer4
// are the weight stream (all weights from L2 per 64-pixel job).
//
// Exactness: each epilogue is clip(round(acc * s + b)) with the multiply and
// the add rounded separately (__fmul_rn/__fadd_rn, --fmad=false), rintf
// rounds half to even like jnp.round; the output is
// clip(round((acc3*v3s + v3b) + (r*vrs + vrb)), 0, 127), each step rounded.

#include <type_traits>

#include "ring.cuh"
#include "wgmma.cuh"

namespace posetpu {

struct BottleneckArgs {
  const int8_t* x;    // [N, H, W, Cin]
  // stage images of the K-minor weights (tile_weight)
  const int8_t* w1;   // [Cm, Cin]
  const int8_t* w2;   // [Cm, 9 * Cm], tap-major depth
  const int8_t* w3;   // [Cout, Cm]
  const int8_t* wd;   // [Cout, Cin] projection, or null: identity residual
  const float* v1;    // [2, Cm]: scale, bias
  const float* v2;    // [2, Cm]
  const float* v3;    // [2, Cout]
  const float* vd;    // [2, Cout], projection only
  const float* vr;    // [2, Cout]: the residual's dequant scale, bias
  int8_t* out;        // [N, H, W, Cout]
  int n, h, w, cin, cm, cout;
  int th;             // output rows per block
};

// ---------------------------------------------------------------------------
// B8a

constexpr int KB = 64;                  // bytes of K per ring stage
constexpr int STAGES = 3;
constexpr int STAGE_BYTES = BM * KB;    // 128 rows of 64 bytes, swizzled
constexpr int S_LD = BN + 16;           // staging tile row (padded: char2 access)
constexpr int S_DATA = BM * S_LD;
constexpr int P_SLICE = BN * 4;         // 128 columns of one f32 vector
constexpr int S_BYTES = S_DATA + 6 * P_SLICE;  // a staging tile and its columns' scales

// Where the block's shared memory regions start (ops/resblock.py plans them).
// h1, and over it the ``ns`` staging tiles, start at 0. The A ring may lie
// over h2 when only conv1 streams A (no projection). off_pv: v1 and v2;
// off_bar: the ring's mbarriers.
struct RowsLayout {
  int off_h2, off_ring_a, off_ring_b, off_pv, off_bar, ns;
};

// byte offset of 16-byte chunk ``chunk`` of row ``row`` in a ring stage
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * KB + ((chunk ^ ((row >> 1) & 3)) << 4);
}

struct Cursor {
  int phase, mt, nt, ks;  // phase 0 conv1, 1 conv2, 2 projection + conv3
};

// clip(round_half_even(v), lo, 127) as int8; cvt.rni saturates where rintf
// and the float clip would have clipped
__device__ __forceinline__ signed char round_clip(float v, int lo) {
  return static_cast<signed char>(min(max(__float2int_rn(v), lo), 127));
}

template <bool NARROW>
__global__ void __launch_bounds__(THREADS, 2)
bottleneck_rows_kernel(BottleneckArgs p, RowsLayout lay) {
  extern __shared__ __align__(1024) int8_t smem[];
  constexpr int NJ12 = NARROW ? 4 : 8;   // n-tiles of 8 per warp in conv1, conv2
  constexpr int BN12 = NARROW ? 64 : BN;
  constexpr int B12_BYTES = BN12 * KB;   // a conv1/conv2 weight stage image
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;  // row slots 0, 1 are warps 0-3: all four tensor cores
  const int ld = p.cm + 16, wp = p.w + 2;
  const int r0 = static_cast<int>(blockIdx.x) * p.th;
  const int rows = min(p.th, p.h - r0);
  const int m_halo = (rows + 2) * p.w, m_out = rows * p.w;
  const int hw = p.h * p.w;
  const int halo0 = (r0 - 1) * p.w, out0 = r0 * p.w;  // image pixel of tile row 0
  const size_t img_pix = static_cast<size_t>(blockIdx.y) * hw;
  const bool has_ds = p.wd != nullptr;

  int8_t* h1 = smem;                    // [rows + 2][w + 2][ld], border columns zero
  int8_t* stage_tiles = smem;           // [ns][BM][S_LD], over h1 once conv2 is done
  int8_t* h2 = smem + lay.off_h2;       // [m_out][ld]
  int8_t* ring_a = smem + lay.off_ring_a;
  const unsigned smem_s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const unsigned full0 = smem_s + lay.off_bar;  // a mbarrier a stage: its B image has landed

  const int k1 = (p.cin + KB - 1) / KB, k2 = (9 * p.cm + KB - 1) / KB;
  const int k3 = (p.cm + KB - 1) / KB, kd = has_ds ? k1 : 0, kt3 = kd + k3;
  const int mt1 = (m_halo + BM - 1) / BM, mto = (m_out + BM - 1) / BM;
  const int nt12 = (p.cm + BN12 - 1) / BN12, nt3 = (p.cout + BN - 1) / BN;
  const int total = mt1 * nt12 * k1 + mto * nt12 * k2 + mto * nt3 * kt3;
  const int ahead = lay.ns - 1;  // staging tiles the residual runs ahead

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full0 + s * 8, 1);  // thread 0's arrive, and the bytes
    mbar_init_fence();
  }
  __syncthreads();

  // zeros: conv2's padding, and conv1 rows outside the image are never written
  for (int i = tid * 16; i < (rows + 2) * wp * ld; i += THREADS * 16)
    *reinterpret_cast<int4*>(h1 + i) = make_int4(0, 0, 0, 0);
  // conv1's and conv2's scales and biases wait in shared memory: an epilogue
  // that fetched them from device memory paid that latency column by column
  float* pv = reinterpret_cast<float*>(smem + lay.off_pv);  // v1 [2, cm], v2 [2, cm]
  for (int i = tid; i < 2 * p.cm; i += THREADS) {
    pv[i] = p.v1[i];
    pv[2 * p.cm + i] = p.v2[i];
  }

  // ---- the loader walks the block's flat list of k-steps, (phase, m-tile,
  // n-tile, k) with phase 0 conv1, 1 conv2, 2 projection + conv3, STAGES - 1
  // steps ahead of the loops below, which walk the same list. A step's B
  // operand is one stage image of the tiled weights (ops/resblock.py,
  // tile_weight): thread 0 asks the bulk copy engine for it with one
  // instruction, and its arrival counts on the stage's mbarrier. Where A
  // streams from x (conv1 on the halo rows, the projection on the output
  // rows) this thread copies chunks ch0, ch0 + 1 of ring row lrow with
  // cp.async. Where its rows start is worked out once per tile, not per step.
  Cursor lc{0, 0, 0, 0};
  const int lrow = tid >> 1, ch0 = (tid & 1) * 2;
  const int ldst0 = swz(lrow, ch0), ldst1 = swz(lrow, ch0 + 1);
  const int8_t* l_b = nullptr;  // the tile's first stage image
  const int8_t* l_a = nullptr;  // this thread's A row at its first chunk, or none
  int l_bbytes = 0, l_ks0 = 0;

  auto load_setup = [&]() {
    bool a_streams = false;
    l_bbytes = lc.phase == 2 ? STAGE_BYTES : B12_BYTES;
    if (lc.phase == 0) {
      l_b = p.w1 + static_cast<size_t>(lc.nt * k1) * B12_BYTES;
      a_streams = true;
    } else if (lc.phase == 1) {
      l_b = p.w2 + static_cast<size_t>(lc.nt * k2) * B12_BYTES;
    } else if (lc.ks < kd) {
      l_b = p.wd + static_cast<size_t>(lc.nt * kd) * STAGE_BYTES;
      a_streams = true;
    } else {
      l_b = p.w3 + static_cast<size_t>(lc.nt * k3) * STAGE_BYTES;
    }
    l_ks0 = lc.ks;
    l_a = nullptr;
    if (a_streams) {  // rows outside the image or the tile: their sums are never kept
      const int m = lc.mt * BM + lrow;
      const int pix = (lc.phase == 0 ? halo0 : out0) + m;
      const bool ok = lc.phase == 0 ? (m < m_halo && pix >= 0 && pix < hw) : m < m_out;
      if (ok) l_a = p.x + (img_pix + pix) * p.cin + ch0 * 16;
    }
  };

  // the loads of the loader's step into ring stage ``st``, and one step on
  auto load_step = [&](int st) {
    if (lc.ks == 0 || (lc.phase == 2 && lc.ks == kd)) load_setup();
    const int ks = lc.ks - l_ks0;
    if (tid == 0) {
      mbar_expect_tx(full0 + st * 8, l_bbytes);
      bulk_copy(smem_s + lay.off_ring_b + st * STAGE_BYTES,
                l_b + static_cast<size_t>(ks) * l_bbytes, l_bbytes, full0 + st * 8);
    }
    if (l_a != nullptr) {
      const int kofs = ks * KB;
      const bool in0 = kofs + ch0 * 16 < p.cin;  // K % 32 == 0: a chunk is inside or outside
      const bool in1 = kofs + ch0 * 16 + 16 < p.cin;
      int8_t* dst = ring_a + st * STAGE_BYTES;
      cp_async16(dst + ldst0, in0 ? l_a + kofs : l_a, in0);
      cp_async16(dst + ldst1, in1 ? l_a + kofs + 16 : l_a, in1);
    }
    if (++lc.ks < (lc.phase == 0 ? k1 : lc.phase == 1 ? k2 : kt3)) return;
    lc.ks = 0;
    if (++lc.nt < (lc.phase == 2 ? nt3 : nt12)) return;
    lc.nt = 0;
    if (++lc.mt < (lc.phase == 0 ? mt1 : mto)) return;
    lc.mt = 0;
    ++lc.phase;
  };

  // a conv3 tile's inputs -> its staging tile, 16 bytes a copy: the identity
  // residual (rows of x), and behind it the 128 columns' slices of the scale
  // and bias vectors (v3 and vr, and vd for the projection)
  auto load_tile_inputs = [&](int tt) {
    if (tt >= mto * nt3) return;
    const int mt = tt / nt3, nt = tt - mt * nt3;
    int8_t* sb = stage_tiles + (tt % lay.ns) * S_BYTES;
    if (!has_ds) {
#pragma unroll
      for (int u = 0; u < BM * (BN / 16) / THREADS; ++u) {
        const int e = tid + u * THREADS, row = e >> 3, ch = e & 7;
        const int m = mt * BM + row, o = nt * BN + ch * 16;
        if (m < m_out && o < p.cout)
          cp_async16(sb + row * S_LD + ch * 16, p.x + (img_pix + out0 + m) * p.cin + o, true);
      }
    }
    const int sl = tid >> 5, o = nt * BN + lane * 4;  // slice, and four of its columns
    if (sl < (has_ds ? 6 : 4) && o < p.cout) {
      const float* v = sl < 2 ? p.v3 : (sl < 4 ? p.vr : p.vd);
      cp_async16(sb + S_DATA + sl * P_SLICE + lane * 16, v + (sl & 1) * p.cout + o, true);
    }
  };

  // ---- a k-step's frame: its loads have landed for every thread, the stage
  // read one step ago is free and is asked to be filled for STAGES - 1 steps
  // on. The caller commits the group (after any residual copies) and computes.
  int q = 0, st = 0, parity = 0;  // the step, q % STAGES, and the stage's use, odd or even
  auto step_begin = [&]() {
    cp_async_wait1();  // this thread's A chunks; STAGES - 2 groups may still fly
    mbar_wait(full0 + st * 8, parity);  // the B image
    __syncthreads();   // also orders an epilogue's h1/h2 writes before their readers
    if (q + STAGES - 1 < total) load_step(st == 0 ? STAGES - 1 : st - 1);
  };
  auto step_end = [&]() {
    ++q;
    if (++st == STAGES) {
      st = 0;
      parity ^= 1;
    }
  };

  // ---- fragments come by ldmatrix: lane l gives the row address of row
  // l & 7 of matrix l >> 3. A: matrices (rows 0-7 | 8-15) x (k 0-15 | 16-31)
  // of a 16-row group; B: (k 0-15 | 16-31) x (n-tile j | j + 1).
  const int l8 = lane & 7, lmi = lane >> 3;
  const int xsw = l8 >> 1;  // the swizzle of every ring row this lane addresses
  const int fa_row = wm * 32 + (lmi & 1) * 8 + l8;  // + 16 i: this lane's A row in the tile
  const int fa_ch = lmi >> 1, fb_ch = lmi & 1;      // its 16-byte chunk of a 32-byte k-step
  const unsigned fa_ring = smem_s + lay.off_ring_a + fa_row * KB;
  const unsigned fb_ring = smem_s + lay.off_ring_b + ((lmi >> 1) * 8 + l8) * KB;

  int acc[2][8][4];
  auto acc_clear = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;
  };
  acc_clear();

  // B fragments of one 32-deep step from ring stage ``st`` and the products
  auto mma_b = [&](auto nj, int s, const unsigned (&af)[2][4]) {
    constexpr int NJ = decltype(nj)::value;
    const unsigned bt = fb_ring + st * STAGE_BYTES + wn * NJ * 8 * KB + (((2 * s + fb_ch) ^ xsw) << 4);
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      unsigned b0[2], b1[2];
      ldsm4(b0[0], b0[1], b1[0], b1[1], bt + j * 8 * KB);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_s8(acc[i][j], af[i], b0);
        mma_s8(acc[i][j + 1], af[i], b1);
      }
    }
  };

  // one k-step with A from the ring (k-step ``ks`` of a K = cin product)
  auto mma_ring = [&](auto nj, int ks) {
#pragma unroll
    for (int s = 0; s < KB / BK; ++s) {
      if (ks * KB + s * BK >= p.cin) break;
      unsigned af[2][4];
      const unsigned at = fa_ring + st * STAGE_BYTES + (((2 * s + fa_ch) ^ xsw) << 4);
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldsm4(af[i][0], af[i][1], af[i][2], af[i][3], at + i * 16 * KB);
      mma_b(nj, s, af);
    }
  };

  // one k-step with A from h1 or h2: ``a_at`` is this lane's address of the
  // step's first 16 bytes less its rows' own offsets ``arow``
  int arow[2] = {0, 0};
  auto mma_tile = [&](auto nj, unsigned a_at, int s) {
    unsigned af[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ldsm4(af[i][0], af[i][1], af[i][2], af[i][3], a_at + arow[i]);
    mma_b(nj, s, af);
  };

  // this thread's sums: f(j, i, hh, tile row, tile column) for the pair
  // acc[i][j][2 hh], acc[i][j][2 hh + 1], columns outermost so that a
  // column's scale and bias load once for its four rows
  auto row_of = [&](int i, int hh) { return wm * 32 + i * 16 + hh * 8 + gid; };
  const auto narrow_c = std::integral_constant<int, NJ12>{};
  const auto wide_c = std::integral_constant<int, 8>{};
  // conv1, conv2: scale and bias pairs of columns o, o + 1 of v1 (which = 0)
  // or v2 (1) from shared memory (o clamped: a column past cm is never stored)
  auto scale12 = [&](int which, int o, float2& s, float2& b) {
    const float* v = pv + which * 2 * p.cm + min(o, p.cm - 2);
    s = *reinterpret_cast<const float2*>(v);
    b = *reinterpret_cast<const float2*>(v + p.cm);
  };
  auto requant2 = [&](const int (&a)[4], int hh, float2 s, float2 b, int lo) {
    char2 v;
    v.x = round_clip(scale_bias(a[2 * hh], s.x, b.x), lo);
    v.y = round_clip(scale_bias(a[2 * hh + 1], s.y, b.y), lo);
    return v;
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load_step(s);
    cp_async_commit();
  }

  // ---- conv1 over the halo rows -> h1
  for (int mt = 0; mt < mt1; ++mt) {
    const bool warp_on = wm * 32 < m_halo - mt * BM;  // else no row of this warp is kept
    int dst[2][2];  // where this thread's rows go in h1, or -1: outside the image
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int hp = mt * BM + row_of(i, hh), pix = halo0 + hp, lr = hp / p.w;
        dst[i][hh] = (hp >= m_halo || pix < 0 || pix >= hw)
                         ? -1 : (lr * wp + (hp - lr * p.w) + 1) * ld;
      }
    for (int nt = 0; nt < nt12; ++nt) {
      for (int ks = 0; ks < k1; ++ks) {
        step_begin();
        cp_async_commit();
        if (warp_on) mma_ring(narrow_c, ks);
        step_end();
      }
#pragma unroll
      for (int j = 0; j < NJ12; ++j) {
        const int o = nt * BN12 + wn * NJ12 * 8 + j * 8 + tig * 2;
        float2 s, b;
        scale12(0, o, s, b);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const char2 v = requant2(acc[i][j], hh, s, b, 0);
            if (dst[i][hh] >= 0 && o < p.cm) *reinterpret_cast<char2*>(h1 + dst[i][hh] + o) = v;
          }
      }
      acc_clear();
    }
  }

  // ---- conv2 (3x3) from h1 -> h2: tap by tap through padded h1, a tap one
  // pixel on from the last, and one row on (less three pixels) after every third
  for (int mt = 0; mt < mto; ++mt) {
    const bool warp_on = wm * 32 < m_out - mt * BM;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = min(mt * BM + fa_row + i * 16, m_out - 1);
      const int ro = m / p.w;
      arow[i] = ((ro + 1) * wp + (m - ro * p.w) + 1) * ld;
    }
    for (int nt = 0; nt < nt12; ++nt) {
      int kc = 0, tx = 0;
      unsigned a_at = smem_s + (-wp - 1) * ld + fa_ch * 16;  // tap (-1, -1)
      for (int ks = 0; ks < k2; ++ks) {
        step_begin();
        cp_async_commit();
#pragma unroll
        for (int s = 0; s < KB / BK; ++s) {
          if (ks * KB + s * BK >= 9 * p.cm) break;
          if (warp_on) mma_tile(narrow_c, a_at + kc, s);
          kc += BK;
          if (kc == p.cm) {
            kc = 0;
            a_at += ld;
            if (++tx == 3) {
              tx = 0;
              a_at += (wp - 3) * ld;
            }
          }
        }
        step_end();
      }
#pragma unroll
      for (int j = 0; j < NJ12; ++j) {
        const int o = nt * BN12 + wn * NJ12 * 8 + j * 8 + tig * 2;
        float2 s, b;
        scale12(1, o, s, b);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int m = mt * BM + row_of(i, hh);
            const char2 v = requant2(acc[i][j], hh, s, b, 0);
            if (m < m_out && o < p.cm) *reinterpret_cast<char2*>(h2 + m * ld + o) = v;
          }
      }
      acc_clear();
    }
  }

  // ---- the projection (if any), conv3, residual -> out, through staging tiles
  const bool vec = p.cout % 16 == 0;
  for (int mt = 0; mt < mto; ++mt) {
    const bool warp_on = wm * 32 < m_out - mt * BM;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      arow[i] = min(mt * BM + fa_row + i * 16, m_out - 1) * ld;
    for (int nt = 0; nt < nt3; ++nt) {
      const int tt = mt * nt3 + nt;
      int8_t* sb = stage_tiles + (tt % lay.ns) * S_BYTES;
      int8_t* srow = sb + row_of(0, 0) * S_LD + wn * 64 + tig * 2;  // + (16 i + 8 hh) rows + 8 j
      // the tile's scale slices behind it: + slice * BN + 8 j
      const float* par = reinterpret_cast<const float*>(sb + S_DATA) + wn * 64 + tig * 2;
      for (int ks = 0; ks < kt3; ++ks) {
        step_begin();
        if (ks == 0) {
          // h1 is free: the inputs of the tile ``ahead`` tiles on, into the
          // staging tile whose rows left with tile tt - 1. The first tiles'
          // are waited for on the spot, once a block.
          if (tt == 0) {
            for (int t = 0; t < ahead; ++t) load_tile_inputs(t);
            cp_async_commit();
            cp_async_wait0();
            __syncthreads();
          }
          load_tile_inputs(tt + ahead);
        }
        cp_async_commit();
        if (ks < kd) {
          if (warp_on) mma_ring(wide_c, ks);
          if (ks == kd - 1) {
            // the projection, requantised to int8 with no ReLU -> the staging tile
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              const float2 s = *reinterpret_cast<const float2*>(par + 4 * BN + j * 8);
              const float2 b = *reinterpret_cast<const float2*>(par + 5 * BN + j * 8);
#pragma unroll
              for (int i = 0; i < 2; ++i)
#pragma unroll
                for (int hh = 0; hh < 2; ++hh)
                  *reinterpret_cast<char2*>(srow + (i * 16 + hh * 8) * S_LD + j * 8) =
                      requant2(acc[i][j], hh, s, b, -127);
            }
            acc_clear();
          }
        } else if (warp_on) {
          const unsigned a_at = smem_s + lay.off_h2 + (ks - kd) * KB + fa_ch * 16;
#pragma unroll
          for (int s = 0; s < KB / BK; ++s) {
            if ((ks - kd) * KB + s * BK >= p.cm) break;
            mma_tile(wide_c, a_at + s * BK, s);
          }
        }
        step_end();
      }
      // conv3 + residual -> ReLU -> requant, in place in the staging tile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 s = *reinterpret_cast<const float2*>(par + j * 8);
        const float2 b = *reinterpret_cast<const float2*>(par + BN + j * 8);
        const float2 rs = *reinterpret_cast<const float2*>(par + 2 * BN + j * 8);
        const float2 rb = *reinterpret_cast<const float2*>(par + 3 * BN + j * 8);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            char2* at = reinterpret_cast<char2*>(srow + (i * 16 + hh * 8) * S_LD + j * 8);
            const char2 res = *at;
            char2 v;
            v.x = round_clip(__fadd_rn(scale_bias(acc[i][j][2 * hh], s.x, b.x),
                                       scale_bias(res.x, rs.x, rb.x)), 0);
            v.y = round_clip(__fadd_rn(scale_bias(acc[i][j][2 * hh + 1], s.y, b.y),
                                       scale_bias(res.y, rs.y, rb.y)), 0);
            *at = v;
          }
      }
      acc_clear();
      __syncthreads();
      // the tile leaves, 16 bytes a store, eight stores to a 128-byte row
#pragma unroll
      for (int u = 0; u < BM * (BN / 16) / THREADS; ++u) {
        const int e = tid + u * THREADS, row = e >> 3, ch = e & 7;
        const int m = mt * BM + row, o = nt * BN + ch * 16;
        if (m >= m_out || o >= p.cout) continue;
        const int8_t* src = sb + row * S_LD + ch * 16;
        int8_t* dst = p.out + (img_pix + out0 + m) * p.cout + o;
        if (vec) {
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
        } else {
          for (int b = 0; b < min(16, p.cout - o); ++b) dst[b] = src[b];
        }
      }
    }
  }
}

struct RowsKernel {
  void (*fn)(BottleneckArgs, RowsLayout);
  int configured;  // dynamic shared memory the kernel has been allowed so far
};

static RowsKernel rows_kernels[2] = {{bottleneck_rows_kernel<false>, 0},
                                     {bottleneck_rows_kernel<true>, 0}};

// The attribute is set when a launch asks for more than any before it, not
// on every launch; the carve-out is asked for at its largest once, so that
// two blocks find room on an SM.
static cudaError_t configure_rows(RowsKernel& k, int smem) {
  if (smem <= k.configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaFuncSetAttribute(k.fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return e;
  k.configured = smem;
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// B8b

constexpr int V2_IMG = BM * KB;  // a weight image's slot in a ring stage (conv3's 128 rows)
constexpr int V2_HW = 10;        // halo pixels a row: a tile row of 8 and its neighbours
constexpr int V2_KEEP = 100;     // halo pixels a warpgroup's conv1 keeps: a 10 x 10 halo
constexpr int V2_S_DATA = BM * S_LD;  // a staging tile's rows, then v3 and vr slices
constexpr int V2_STG = V2_S_DATA + 4 * P_SLICE;  // a staging tile; there are two
constexpr int V2_THREADS = THREADS + 32;  // two consumer warpgroups and a producer warp

struct V2Args {
  const int8_t* x;    // [N, H, W, C]
  const int8_t* w1t;  // stage images (tile_weight): [Cm / BN12][Cin / 64][BN12][64]
  const int8_t* w2t;  // [Cm / BN12][9 Cm / 64][BN12][64], tap-major depth
  const int8_t* w3t;  // [Cout / 128][Cm / 64][128][64]
  const float* v1;    // [2, Cm]: scale, bias
  const float* v2;    // [2, Cm]
  const float* v3;    // [2, Cout]
  const float* vr;    // [2, Cout]: the residual's dequant scale, bias
  int8_t* out;        // [N, H, W, C]
  unsigned long long* clocks;  // the timed instances' cycle counters (ops/resblock.V2_CLOCK_SLOTS)
  int n, h, w, cin, cm, cout;
  int tiles_x, tile_h, stages, a_img;  // the form (ops/resblock.plan_v2)
  int jobs;           // tiles x images; block b takes jobs b, b + gridDim.x, ...
};

// where the block's shared memory regions start (ops/resblock.plan_v2): h1
// at 0, and over it from conv3 on the two staging tiles; the ring's weight
// images; its halo images; h2; a zero weight image (IPS = 2); v1 and v2;
// the ring's full and empty mbarriers
struct V2Layout {
  int off_ring_b, off_ring_a, off_h2, off_zero, off_pv, off_bar;
};

// R12, R3: accumulator registers a thread in conv1/conv2 and in conv3
// (wgmma n = 2 R). R3 = 32: the warpgroups split N (the "split" form). IPS:
// weight images (64 bytes of K) a ring stage. A step's wgmma instructions
// run straight through, with no branch between them (ptxas serialises
// wgmma behind a branch, C7520): an image past an n-tile's last reads B
// from a zero image, a depth past K the padded zeros of its image.
// CLOCKS: a timed instance, a measurement only (bottleneck_v2_clocked).
template <int R12, int R3, int IPS, bool CLOCKS>
__global__ void __launch_bounds__(V2_THREADS, 1) bottleneck_v2_kernel(
    const __grid_constant__ V2Args p, const __grid_constant__ V2Layout lay,
    const __grid_constant__ CUtensorMap tm_x) {  // x [N][H][W][Cin], a box 64 channels of a halo
  constexpr bool kSplit = R3 == 32;
  constexpr int NW12 = 2 * R12, NW3 = 2 * R3;        // columns a warpgroup
  constexpr int BN12 = kSplit ? 2 * NW12 : NW12;     // rows of a conv1/conv2 stage image
  constexpr int IMG12 = BN12 * KB;
  // a second accumulator chain for conv2 and conv3 where registers allow
  // (the split form's 32-register chains); beside conv1's 128 accumulators
  // the spills it brought cost more than it gained
  constexpr bool kTwoChains = kSplit;
  extern __shared__ __align__(1024) int8_t smem[];
  const long long t_start = CLOCKS ? clock64() : 0;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
  const int tiles = p.tiles_x * ((p.h + p.tile_h - 1) / p.tile_h);
  const int hp_img = (p.tile_h + 2) * V2_HW;    // halo pixels
  const int plane_h1 = hp_img * 16;             // a 16-channel plane of h1
  const int out_px = kSplit ? 64 : BM;          // a tile's output pixels
  const int plane_h2 = out_px * 16;
  // weight images (64 bytes of K) an n-tile of each conv, and ring steps of
  // IPS images each
  const int k1 = (p.cin + KB - 1) / KB, k2 = (9 * p.cm + KB - 1) / KB, k3 = (p.cm + KB - 1) / KB;
  const int s1 = (k1 + IPS - 1) / IPS, s2 = (k2 + IPS - 1) / IPS, s3 = (k3 + IPS - 1) / IPS;
  const int nt12 = (p.cm + BN12 - 1) / BN12, nt3 = (p.cout + BN - 1) / BN;
  const int q1 = nt12 * s1, q2 = q1 + nt12 * s2, per_job = q2 + nt3 * s3;
  // a ring stage: IPS weight images, and in conv1 for each a 64-channel
  // image of x's halo, [halo pixel][64 bytes] swizzled as wgmma's 64-byte
  // K-major layout (TMA writes it so)
  const int b_stage = IPS * V2_IMG, a_stage = IPS * p.a_img;
  const unsigned smem_s = smem_addr(smem);
  const unsigned full0 = smem_s + lay.off_bar, empty0 = full0 + 8 * p.stages;
  float* pv = reinterpret_cast<float*>(smem + lay.off_pv);  // v1 [2][cm], then v2 [2][cm]
  const unsigned zero_s = smem_s + lay.off_zero;
  // the timed instances: a warpgroup's first thread (and the producer's)
  // adds the cycles between its marks to a counter
  const bool timed = CLOCKS && (tid & 127) == 0;
  long long mark = t_start;
  auto lap = [&](int slot) {
    if (timed) {
      const long long now = clock64();
      atomicAdd(p.clocks + slot, static_cast<unsigned long long>(now - mark));
      mark = now;
    }
  };

  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);   // the producer's arrive, and the bytes
      mbar_init(empty0 + 8 * s, 8);  // one arrive per consumer warp
    }
    mbar_init_fence();
  }
  for (int i = tid; i < 2 * p.cm; i += V2_THREADS) {
    pv[i] = p.v1[i];
    pv[2 * p.cm + i] = p.v2[i];
  }
  if (IPS == 2) {
    for (int i = tid * 16; i < V2_IMG; i += V2_THREADS * 16)
      *reinterpret_cast<int4*>(smem + lay.off_zero + i) = make_int4(0, 0, 0, 0);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  // ---- the producer: its lane 0 walks the block's jobs' steps, (job, conv,
  // n-tile, k) in the weight images' order, and asks for each step's images
  // and, in conv1, the same 64 channels of x's halo (zeros outside the
  // tensor) into the next stage once the consumers have freed it
  if (warp == THREADS / 32) {
    if (lane == 0) {
      int g = 0;
      for (int job = blockIdx.x; job < p.jobs; job += gridDim.x) {
        const int y0 = (job % tiles) / p.tiles_x * p.tile_h, x0 = (job % tiles) % p.tiles_x * 8;
        const int img = job / tiles;
        for (int q = 0; q < per_job; ++q, ++g) {
          const int st = g % p.stages;
          if (g >= p.stages) {
            if (CLOCKS) mark = clock64();
            mbar_wait(empty0 + 8 * st, (g / p.stages - 1) & 1);
            lap(8);
          }
          const unsigned bar = full0 + 8 * st, dst = smem_s + lay.off_ring_b + st * b_stage;
          const int8_t* w;
          int kimg, img_bytes, ks, nt;
          if (q < q1) {
            nt = q / s1, ks = q - nt * s1, kimg = k1, img_bytes = IMG12, w = p.w1t;
          } else if (q < q2) {
            nt = (q - q1) / s2, ks = q - q1 - nt * s2, kimg = k2, img_bytes = IMG12, w = p.w2t;
          } else {
            nt = (q - q2) / s3, ks = q - q2 - nt * s3, kimg = k3, img_bytes = V2_IMG, w = p.w3t;
          }
          const int i0 = ks * IPS, imgs_here = min(IPS, kimg - i0);
          const int boxes = q < q1 ? imgs_here : 0;  // x's halo, 64 channels each
          mbar_expect_tx(bar, imgs_here * img_bytes + boxes * 64 * hp_img);
          for (int i = 0; i < imgs_here; ++i)
            bulk_copy(dst + i * V2_IMG, w + static_cast<size_t>(nt * kimg + i0 + i) * img_bytes,
                      img_bytes, bar);
          for (int i = 0; i < boxes; ++i)
            tma_load_4d(smem_s + lay.off_ring_a + st * a_stage + i * p.a_img, &tm_x,
                        64 * (i0 + i), x0 - 1, y0 - 1, img, bar);
        }
      }
    }
    return;
  }

  // ---- the consumers. A k-step: its stage has landed, its products are
  // issued; then the step before it is done and its stage is freed
  int g = 0, st = 0, parity = 0;
  auto step_begin = [&](int slot) {
    mbar_wait(full0 + 8 * st, parity);
    lap(slot);
    wgmma_fence();
  };
  auto step_end = [&](auto&... acc) {
    wgmma_commit();
    wgmma_wait<1>();
    (keep_in_registers(acc), ...);
    lap(2);
    if (g > 0 && lane == 0) mbar_arrive(empty0 + 8 * (st == 0 ? p.stages - 1 : st - 1));
    ++g;
    if (++st == p.stages) {
      st = 0;
      parity ^= 1;
    }
  };
  auto sync_consumers = []() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); };
  // what an epilogue wrote to h1 or h2 is visible to the tensor cores' reads
  auto publish = [&]() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    sync_consumers();
  };
  auto clear = [](auto& a) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(a) / sizeof(int)); ++i) a[i] = 0;
  };
  // this thread's rows of a 64-row slice (+ 8 for the odd pairs) and columns
  // (+ 8 per two pairs): d[2 k], d[2 k + 1] are row row_w + 8 (k & 1),
  // columns 8 (k >> 1) + 2 tig and the next
  const int row_w = 16 * (warp & 3) + gid;
  // conv1: each warpgroup computes two 64-row slices from its 10 x 10 halo's
  // first pixel on (split: both the same halo, half the columns each) and
  // keeps its own pixels (the tile form's warpgroup 1 leaves rows 8 and 9 to
  // warpgroup 0); the rows past its halo are thrown away
  const int region0 = kSplit ? 0 : wg * 8 * V2_HW;  // in h1 and in the x image
  const int own0 = kSplit ? 0 : wg * V2_KEEP;
  const int col12 = kSplit ? wg * NW12 : 0;
  const int centre = region0 + V2_HW + 1;  // halo pixel of the warpgroup's first output pixel
  const int row2 = kSplit ? 0 : 64 * wg;   // and its first row of h2 (and of the output tile)
  const int col3 = kSplit ? wg * NW3 : 0;
  // conv3's n-tiles pass through two staging tiles over h1 in turn, an
  // n-tile's residual asked for one n-tile ahead, the job's first as conv3
  // starts
  int ntg = 0;  // conv3 n-tiles so far: the staging tile's parity
  lap(6);

  for (int job = blockIdx.x; job < p.jobs; job += gridDim.x) {
    const int y0 = (job % tiles) / p.tiles_x * p.tile_h, x0 = (job % tiles) % p.tiles_x * 8;
    const int8_t* x_img = p.x + static_cast<size_t>(job / tiles) * p.h * p.w * p.cin;
    int8_t* out_img = p.out + static_cast<size_t>(job / tiles) * p.h * p.w * p.cout;
    if (timed && wg == 0) atomicAdd(p.clocks + 9, 1ull);
    // output pixel r of the tile: its place in the image, or -1 outside it
    auto out_pixel = [&](int r) {
      const int y = y0 + (r >> 3), x = x0 + (r & 7);
      return y < p.h && x < p.w ? y * p.w + x : -1;
    };
    // n-tile nt's residual tile (x at its pixels) and its v3 / vr slices ->
    // staging tile ``buf``, 16 bytes a copy
    auto load_res = [&](int nt, int buf) {
      int8_t* sb = smem + buf * V2_STG;
      for (int e = tid; e < out_px * (BN / 16); e += THREADS) {
        const int r = e >> 3, ch = e & 7, o = nt * BN + ch * 16, px = out_pixel(r);
        if (px >= 0 && o < p.cout)
          cp_async16(sb + r * S_LD + ch * 16, x_img + static_cast<size_t>(px) * p.cin + o, true);
      }
      if (tid < 128) {  // slices v3 scale, v3 bias, vr scale, vr bias: four columns a thread
        const int sl = tid >> 5, o = nt * BN + lane * 4;
        if (o < p.cout)
          cp_async16(sb + V2_S_DATA + sl * P_SLICE + lane * 16,
                     (sl < 2 ? p.v3 : p.vr) + (sl & 1) * p.cout + o, true);
      }
    };
    // ---- conv1 over the halo -> h1 [Cm / 16][halo pixel][16 bytes]
    for (int nt = 0; nt < nt12; ++nt) {
      int d0[R12], d1[R12];
      clear(d0);
      clear(d1);
      for (int ks = 0; ks < s1; ++ks) {
        step_begin(10);
        const unsigned a = smem_s + lay.off_ring_a + st * a_stage + region0 * 64;
        const unsigned b = smem_s + lay.off_ring_b + st * b_stage + col12 * KB;
#pragma unroll
        for (int i = 0; i < IPS; ++i) {
          const unsigned bi = ks * IPS + i < k1 ? b + i * V2_IMG : zero_s;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint64_t db = desc_sw64(bi + 32 * j);
            const unsigned aj = a + i * p.a_img + 32 * j;
            wgmma_s8(d0, desc_sw64(aj), db);
            wgmma_s8(d1, desc_sw64(aj + 64 * 64), db);
          }
        }
        step_end(d0, d1);
      }
      wgmma_wait<0>();
      keep_in_registers(d0);
      keep_in_registers(d1);
      lap(14);
      // this thread's four rows of conv1's two slices: their halo pixels,
      // whether each is this warpgroup's to keep and whether it lies inside
      // the image
      int hp1[4];
      bool keep1[4], in1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int lp = 64 * (u >> 1) + row_w + 8 * (u & 1);
        hp1[u] = region0 + lp;
        keep1[u] = lp < V2_KEEP && hp1[u] >= own0;
        const int hr = hp1[u] / V2_HW, y = y0 - 1 + hr, x = x0 - 1 + hp1[u] - hr * V2_HW;
        in1[u] = y >= 0 && y < p.h && x >= 0 && x < p.w;
      }
      // per slice, the requantised values replace the sums in registers and
      // are stored after: a store between the loads of pv would order them
      // pair by pair
#pragma unroll
      for (int slice = 0; slice < 2; ++slice) {
        int (&d)[R12] = slice == 0 ? d0 : d1;  // unrolled: registers, not memory
#pragma unroll
        for (int k = 0; k < R12 / 2; ++k) {
          const int u = 2 * slice + (k & 1);
          const int o = min(nt * BN12 + col12 + 8 * (k >> 1) + 2 * tig, p.cm - 2);
          // conv2's zero padding is on h1: a pixel outside the image is 0,
          // not the requantised bias its zero input gives
          const int v0 = requant_folded(d[2 * k], pv[o], pv[p.cm + o], 0.0f);
          const int v1 = requant_folded(d[2 * k + 1], pv[o + 1], pv[p.cm + o + 1], 0.0f);
          d[2 * k] = in1[u] ? v0 : 0;
          d[2 * k + 1] = in1[u] ? v1 : 0;
        }
#pragma unroll
        for (int k = 0; k < R12 / 2; ++k) {
          const int u = 2 * slice + (k & 1);
          const int o = nt * BN12 + col12 + 8 * (k >> 1) + 2 * tig;
          if (keep1[u] && o < p.cm)
            *reinterpret_cast<char2*>(smem + (o >> 4) * plane_h1 + hp1[u] * 16 + (o & 15)) =
                make_char2(static_cast<signed char>(d[2 * k]),
                           static_cast<signed char>(d[2 * k + 1]));
        }
      }
      publish();
      lap(3);
    }

    // ---- conv2 (3x3) from h1 -> h2 [Cm / 16][output pixel][16 bytes]: the
    // warpgroup's 8 x 8 pixels (160 bytes from one tile row to the next) at
    // each tap's constant offset; a k32 instruction's 32 channels lie in one
    // tap (Cm % 32 == 0), picked instruction by instruction. Where registers
    // allow, the even and the odd k32 instructions sum into two accumulators
    // (two independent chains in the tensor pipe), added in the epilogue
    for (int nt = 0; nt < nt12; ++nt) {
      int d2[R12], e2[kTwoChains ? R12 : 1];
      clear(d2);
      clear(e2);
      for (int ks = 0; ks < s2; ++ks) {
        step_begin(1);
        const unsigned b = smem_s + lay.off_ring_b + st * b_stage + col12 * KB;
#pragma unroll
        for (int i = 0; i < IPS; ++i) {
          const int kimg = ks * IPS + i;
          const unsigned bi = kimg < k2 ? b + i * V2_IMG : zero_s;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kk = kimg * KB + 32 * j < 9 * p.cm ? kimg * KB + 32 * j : 0;
            const int tap = kk / p.cm, c = kk - tap * p.cm, ty = tap / 3;
            const int off = (ty - 1) * V2_HW + tap - 3 * ty - 1;
            const uint64_t da = desc_plain(smem_s + (c >> 4) * plane_h1 + (centre + off) * 16,
                                           plane_h1, V2_HW * 16);
            const uint64_t db = desc_sw64(bi + 32 * j);
            if constexpr (kTwoChains) {
              if (j == 0) {
                wgmma_s8(d2, da, db);
              } else {
                wgmma_s8(e2, da, db);
              }
            } else {
              wgmma_s8(d2, da, db);
            }
          }
        }
        step_end(d2, e2);
      }
      wgmma_wait<0>();
      keep_in_registers(d2);
      keep_in_registers(e2);
      lap(15);
      if constexpr (kTwoChains) {
#pragma unroll
        for (int i = 0; i < R12; ++i) d2[i] += e2[kTwoChains ? i : 0];  // the chains' sum
      }
#pragma unroll
      for (int k = 0; k < R12 / 2; ++k) {  // in registers first, as conv1's
        const int o = min(nt * BN12 + col12 + 8 * (k >> 1) + 2 * tig, p.cm - 2);
        d2[2 * k] = requant_folded(d2[2 * k], pv[2 * p.cm + o], pv[3 * p.cm + o], 0.0f);
        d2[2 * k + 1] =
            requant_folded(d2[2 * k + 1], pv[2 * p.cm + o + 1], pv[3 * p.cm + o + 1], 0.0f);
      }
#pragma unroll
      for (int k = 0; k < R12 / 2; ++k) {
        const int r = row2 + row_w + 8 * (k & 1);
        const int o = nt * BN12 + col12 + 8 * (k >> 1) + 2 * tig;
        if (o < p.cm)
          *reinterpret_cast<char2*>(smem + lay.off_h2 + (o >> 4) * plane_h2 + r * 16 + (o & 15)) =
              make_char2(static_cast<signed char>(d2[2 * k]),
                         static_cast<signed char>(d2[2 * k + 1]));
      }
      publish();
      lap(4);
    }

    // ---- conv3 from h2 + the identity residual -> out, a 128-column n-tile
    // at a time through a staging tile (the residual and v3 / vr slices
    // arrive by cp.async while the products run; the epilogue adds in place
    // and the tile leaves 16 bytes a store); two accumulators as in conv2
    for (int nt = 0; nt < nt3; ++nt) {
      if (nt == 0) {
        load_res(0, ntg & 1);
        cp_async_commit();
      }
      if (nt + 1 < nt3) load_res(nt + 1, (ntg + 1) & 1);
      cp_async_commit();  // possibly empty: the n-tile's own residual is the group before
      int d3[R3], e3[kTwoChains ? R3 : 1];
      clear(d3);
      clear(e3);
      for (int ks = 0; ks < s3; ++ks) {
        step_begin(1);
        const unsigned b = smem_s + lay.off_ring_b + st * b_stage + col3 * KB;
#pragma unroll
        for (int i = 0; i < IPS; ++i) {
          const int kimg = ks * IPS + i;
          const unsigned bi = kimg < k3 ? b + i * V2_IMG : zero_s;
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int kk = kimg * KB + 32 * j < p.cm ? kimg * KB + 32 * j : 0;
            const uint64_t da = desc_plain(smem_s + lay.off_h2 + (kk >> 4) * plane_h2 + row2 * 16,
                                           plane_h2, 128);
            const uint64_t db = desc_sw64(bi + 32 * j);
            if constexpr (kTwoChains) {
              if (j == 0) {
                wgmma_s8(d3, da, db);
              } else {
                wgmma_s8(e3, da, db);
              }
            } else {
              wgmma_s8(d3, da, db);
            }
          }
        }
        step_end(d3, e3);
      }
      wgmma_wait<0>();
      keep_in_registers(d3);
      keep_in_registers(e3);
      lap(11);
      if constexpr (kTwoChains) {
#pragma unroll
        for (int i = 0; i < R3; ++i) d3[i] += e3[kTwoChains ? i : 0];
      }
      cp_async_wait1();
      sync_consumers();
      lap(12);
      int8_t* sb = smem + (ntg & 1) * V2_STG;
      const float* par = reinterpret_cast<const float*>(sb + V2_S_DATA);
      // the results wait in registers (over the sums) and are stored after
      // the loop: a store between the loads would order them one pair at a
      // time
#pragma unroll
      for (int k = 0; k < R3 / 2; ++k) {
        const int r = row2 + row_w + 8 * (k & 1), c = col3 + 8 * (k >> 1) + 2 * tig;
        const char2 res = *reinterpret_cast<const char2*>(sb + r * S_LD + c);
        const float2 s = *reinterpret_cast<const float2*>(par + c);
        const float2 bb = *reinterpret_cast<const float2*>(par + BN + c);
        const float2 rs = *reinterpret_cast<const float2*>(par + 2 * BN + c);
        const float2 rb = *reinterpret_cast<const float2*>(par + 3 * BN + c);
        d3[2 * k] = round_clip(__fadd_rn(scale_bias(d3[2 * k], s.x, bb.x),
                                         scale_bias(res.x, rs.x, rb.x)), 0);
        d3[2 * k + 1] = round_clip(__fadd_rn(scale_bias(d3[2 * k + 1], s.y, bb.y),
                                             scale_bias(res.y, rs.y, rb.y)), 0);
      }
#pragma unroll
      for (int k = 0; k < R3 / 2; ++k) {
        const int r = row2 + row_w + 8 * (k & 1), c = col3 + 8 * (k >> 1) + 2 * tig;
        *reinterpret_cast<char2*>(sb + r * S_LD + c) =
            make_char2(static_cast<signed char>(d3[2 * k]), static_cast<signed char>(d3[2 * k + 1]));
      }
      sync_consumers();
      lap(13);
      for (int e = tid; e < out_px * (BN / 16); e += THREADS) {
        const int r = e >> 3, ch = e & 7, o = nt * BN + ch * 16, px = out_pixel(r);
        if (px >= 0 && o < p.cout)
          *reinterpret_cast<int4*>(out_img + static_cast<size_t>(px) * p.cout + o) =
              *reinterpret_cast<const int4*>(sb + r * S_LD + ch * 16);
      }
      sync_consumers();  // the staging tile is free for the n-tile after next
      ++ntg;
      lap(5);
    }
  }
  if (timed) {
    atomicAdd(p.clocks, static_cast<unsigned long long>(clock64() - t_start));
    atomicAdd(p.clocks + 7, static_cast<unsigned long long>(g));
  }
}

using V2Fn = void (*)(V2Args, V2Layout, CUtensorMap);

struct V2Kernel {
  int r12, r3, ips;
  bool clocks;
  V2Fn fn;
  int configured;     // dynamic shared memory the kernel has been allowed so far
  int blocks_per_sm;  // at that size
};

#define V2_INSTANCE(R12, R3, IPS, CLOCKS) \
  {R12, R3, IPS, CLOCKS, bottleneck_v2_kernel<R12, R3, IPS, CLOCKS>, 0, 0}
#define V2_INSTANCES(CLOCKS)                                                            \
  V2_INSTANCE(64, 64, 1, CLOCKS), V2_INSTANCE(32, 64, 1, CLOCKS),                      \
      V2_INSTANCE(32, 32, 1, CLOCKS), V2_INSTANCE(16, 32, 1, CLOCKS),                  \
      V2_INSTANCE(64, 64, 2, CLOCKS), V2_INSTANCE(32, 64, 2, CLOCKS),                  \
      V2_INSTANCE(32, 32, 2, CLOCKS), V2_INSTANCE(16, 32, 2, CLOCKS)

// the instances: conv1/conv2 128 or 64 columns a warpgroup (Cm > 64 or not),
// conv3 128; the same with the warpgroups splitting N; each with one or two
// weight images a ring stage; and each once more timed
static V2Kernel v2_kernels[] = {V2_INSTANCES(false), V2_INSTANCES(true)};

static V2Kernel* find_v2(int cm, int split, int ips, bool clocks) {
  const int bn12 = cm <= 64 ? 64 : BN;
  const int r12 = (split ? bn12 / 2 : bn12) / 2, r3 = split ? 32 : 64;
  for (V2Kernel& k : v2_kernels)
    if (k.r12 == r12 && k.r3 == r3 && k.ips == ips && k.clocks == clocks) return &k;
  return nullptr;
}

// The attribute and the blocks an SM at ``smem`` bytes, set when a launch
// asks for more than any before it.
static cudaError_t configure_v2(V2Kernel& k, int smem) {
  if (smem <= k.configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k.fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k.blocks_per_sm, k.fn, V2_THREADS, smem);
  if (e == cudaSuccess) k.configured = smem;
  return e;
}

}  // namespace posetpu

using namespace posetpu;

static BottleneckArgs pack_args(const void* x, const void* w1, const void* w2,
                                const void* w3, const void* wd, const void* v1,
                                const void* v2, const void* v3, const void* vd,
                                const void* vr, void* out, int n, int h, int w,
                                int cin, int cm, int cout, int th) {
  return BottleneckArgs{
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
      static_cast<const int8_t*>(w2), static_cast<const int8_t*>(w3),
      static_cast<const int8_t*>(wd), static_cast<const float*>(v1),
      static_cast<const float*>(v2), static_cast<const float*>(v3),
      static_cast<const float*>(vd), static_cast<const float*>(vr),
      static_cast<int8_t*>(out), n, h, w, cin, cm, cout, th};
}

// B8a. ``th`` rows per block and the shared-memory layout come planned from
// ops/resblock.py (plan_rows); smem is the block's dynamic shared memory.
extern "C" int bottleneck_rows(const void* x, const void* w1, const void* w2,
                               const void* w3, const void* wd, const void* v1,
                               const void* v2, const void* v3, const void* vd,
                               const void* vr, void* out, int n, int h, int w,
                               int cin, int cm, int cout, int th, int off_h2,
                               int off_ring_a, int off_ring_b, int off_pv, int off_bar,
                               int ns, int smem, void* stream) {
  const BottleneckArgs p =
      pack_args(x, w1, w2, w3, wd, v1, v2, v3, vd, vr, out, n, h, w, cin, cm, cout, th);
  RowsKernel& k = rows_kernels[cm <= 64 ? 1 : 0];
  cudaError_t e = configure_rows(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const RowsLayout lay{off_h2, off_ring_a, off_ring_b, off_pv, off_bar, ns};
  dim3 grid((h + th - 1) / th, n);
  k.fn<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p, lay);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of B8a that fit one SM at ``smem`` bytes of dynamic shared memory
// (registers and shared memory together), or minus the CUDA error.
extern "C" int bottleneck_rows_blocks_per_sm(int cm, int smem) {
  RowsKernel& k = rows_kernels[cm <= 64 ? 1 : 0];
  cudaError_t e = configure_rows(k, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.fn, THREADS, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

// B8b. The form (``tile_h`` rows of 8 pixels of one image a job, ``split``:
// the warpgroups split N), the ring (``stages`` of ``ips`` weight images)
// and the shared-memory layout come planned from ops/resblock.py (plan_v2).
// The grid is persistent: at most as many blocks as fit the card at once,
// each walking its share of the jobs. ``clocks``: null, or the counters of a
// timed instance.
static int launch_v2(const void* x, const void* w1t, const void* w2t, const void* w3t,
                     const void* v1, const void* v2, const void* v3, const void* vr, void* out,
                     void* clocks, int n, int h, int w, int cin, int cm, int cout, int tile_h,
                     int split, int stages, int ips, int a_img, int off_ring_b, int off_ring_a,
                     int off_h2, int off_zero, int off_pv, int off_bar, int smem, int sms,
                     void* stream) {
  V2Kernel* k = find_v2(cm, split, ips, clocks != nullptr);
  if (k == nullptr || stages < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = configure_v2(*k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (k->blocks_per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  CUtensorMap tm_x{};
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
  const cuuint64_t pitch[3] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(w) * cin,
                               static_cast<cuuint64_t>(h) * w * cin};
  const cuuint32_t box[4] = {64, V2_HW, static_cast<cuuint32_t>(tile_h + 2), 1};
  if (!uint8_map(&tm_x, x, 4, dims, pitch, box, CU_TENSOR_MAP_SWIZZLE_64B))
    return static_cast<int>(cudaErrorInvalidValue);
  const int tiles_x = (w + 7) / 8, tiles_y = (h + tile_h - 1) / tile_h;
  const int jobs = tiles_x * tiles_y * n;
  const V2Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1t),
                 static_cast<const int8_t*>(w2t), static_cast<const int8_t*>(w3t),
                 static_cast<const float*>(v1), static_cast<const float*>(v2),
                 static_cast<const float*>(v3), static_cast<const float*>(vr),
                 static_cast<int8_t*>(out), static_cast<unsigned long long*>(clocks),
                 n, h, w, cin, cm, cout, tiles_x, tile_h, stages, a_img, jobs};
  const V2Layout lay{off_ring_b, off_ring_a, off_h2, off_zero, off_pv, off_bar};
  const int blocks = jobs < sms * k->blocks_per_sm ? jobs : sms * k->blocks_per_sm;
  k->fn<<<blocks, V2_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p, lay, tm_x);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bottleneck_v2(const void* x, const void* w1t, const void* w2t, const void* w3t,
                             const void* v1, const void* v2, const void* v3, const void* vr,
                             void* out, int n, int h, int w, int cin, int cm, int cout,
                             int tile_h, int split, int stages, int ips, int a_img,
                             int off_ring_b, int off_ring_a, int off_h2, int off_zero,
                             int off_pv, int off_bar, int smem, int sms, void* stream) {
  return launch_v2(x, w1t, w2t, w3t, v1, v2, v3, vr, out, nullptr, n, h, w, cin, cm, cout,
                   tile_h, split, stages, ips, a_img, off_ring_b, off_ring_a, off_h2, off_zero,
                   off_pv, off_bar, smem, sms, stream);
}

// The same launch on the timed instance (a measurement): it adds its cycle
// marks to ``clocks``, the int64 counters ops/resblock.V2_CLOCK_SLOTS names.
extern "C" int bottleneck_v2_clocked(const void* x, const void* w1t, const void* w2t,
                                     const void* w3t, const void* v1, const void* v2,
                                     const void* v3, const void* vr, void* out, void* clocks,
                                     int n, int h, int w, int cin, int cm, int cout, int tile_h,
                                     int split, int stages, int ips, int a_img, int off_ring_b,
                                     int off_ring_a, int off_h2, int off_zero, int off_pv,
                                     int off_bar, int smem, int sms, void* stream) {
  if (clocks == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return launch_v2(x, w1t, w2t, w3t, v1, v2, v3, vr, out, clocks, n, h, w, cin, cm, cout,
                   tile_h, split, stages, ips, a_img, off_ring_b, off_ring_a, off_h2, off_zero,
                   off_pv, off_bar, smem, sms, stream);
}

// Blocks of B8b's instance for (``cm``, ``split``, ``ips``) that fit one SM at
// ``smem`` bytes of dynamic shared memory, or minus the CUDA error.
extern "C" int bottleneck_v2_blocks_per_sm(int cm, int split, int ips, int smem) {
  V2Kernel* k = find_v2(cm, split, ips, false);
  if (k == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = configure_v2(*k, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k->fn, V2_THREADS, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}
