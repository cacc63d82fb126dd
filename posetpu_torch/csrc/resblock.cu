// Fused int8 ResNet bottleneck kernels (sm_90a).
//
// Replaces two Pallas TPU kernels of posetpu/ops/pallas/resblock.py:
//   B8a fused_bottleneck (_bottleneck_kernel, _bottleneck_ds_kernel) — a
//       whole stride-1 bottleneck, conv1 1x1 -> requant -> conv2 3x3 ->
//       requant -> conv3 1x1 + residual -> ReLU -> requant, with the identity
//       residual or a 1x1 projection requantised to int8 (no ReLU) first;
//   B8b fused_bottleneck_v2 (_bottleneck_kernel_v2) — the same function,
//       identity residual only, several images per block and the 3x3 conv as
//       one K = 9*Cm product over im2col patches held in shared memory.
//
// The TPU kernels hold a whole image in VMEM; a thread block has 227 KB. A
// block here takes ``th`` output rows of one image (B8b: of ``imgs`` images),
// computes conv1 on th + 2 rows (the halo rows are recomputed by the
// neighbour blocks), keeps h1 and h2 in shared memory and reads x and writes
// out once. All products are mma.sync.m16n8k32 with exact int32 sums, so
// B8b's output equals B8a's.
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
// B8b, bottleneck_im2col_kernel, keeps the first design (int8_mma.cuh's
// two-stage loops, K-minor weights): it first copies a [128, kch] chunk of the im2col matrix
// into shared memory and multiplies from that; kch is all of 9*Cm where it
// fits and a divisor of it where it does not.
//
// Exactness: each epilogue is clip(round(acc * s + b)) with the multiply and
// the add rounded separately (__fmul_rn/__fadd_rn, --fmad=false), rintf
// rounds half to even like jnp.round; the output is
// clip(round((acc3*v3s + v3b) + (r*vrs + vrb)), 0, 127), each step rounded.

#include <type_traits>

#include "gather.cuh"
#include "ring.cuh"

namespace posetpu {

struct BottleneckArgs {
  const int8_t* x;    // [N, H, W, Cin]
  // B8b: K-minor matrices; B8a: the same as stage images (tile_weight)
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
  int th, imgs, kch;  // rows and images per block; B8b: im2col depth per chunk
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

// Tile pixel lists. Halo pixel hp = (k * (th+2) + lr) * w + c is image
// img0 + k, row r0 - 1 + lr, column c; output pixel m = (k * th + ro) * w + c
// is row r0 + ro.
struct BlockTile {
  int w, h, n, th, imgs, r0, img0;
  __device__ int m_halo() const { return imgs * (th + 2) * w; }
  __device__ int m_out() const { return imgs * th * w; }
  // image, row, column of halo pixel hp; false outside the batch or image
  __device__ bool halo(int hp, int& img, int& r, int& c) const {
    const int per = (th + 2) * w;
    const int k = hp / per, rem = hp - k * per;
    const int lr = rem / w;
    c = rem - lr * w;
    img = img0 + k;
    r = r0 - 1 + lr;
    return hp < m_halo() && img < n && r >= 0 && r < h;
  }
  // output pixel m -> its image, row, column and its centre halo pixel
  __device__ bool out(int m, int& img, int& r, int& c, int& hp) const {
    const int per = th * w;
    const int k = m / per, rem = m - k * per;
    const int ro = rem / w;
    c = rem - ro * w;
    img = img0 + k;
    r = r0 + ro;
    hp = (k * (th + 2) + ro + 1) * w + c;
    return m < m_out() && img < n && r < h;
  }
};

// Rows of a resident [rows][ld] int8 tile, from row m0 on.
struct TileRows {
  const int8_t* buf;
  int ld, m0, m_lim;
  struct Row {
    int off;
    bool ok;
  };
  __device__ Row row(int r) const { return {(m0 + r) * ld, m0 + r < m_lim}; }
  __device__ const int8_t* ptr(Row rw, int ks, bool& ok) const {
    ok = rw.ok;
    return buf + rw.off + ks * BK;
  }
};

// Rows of the 3x3 conv's im2col matrix, gathered from the h1 halo tile:
// depth k = tap * Cm + c with tap (dy, dx) reads the pixel one row and one
// column over, zero beyond the image's left and right border (the rows above
// and below the image are zeros in h1).
struct Conv3x3Rows {
  const int8_t* h1;
  BlockTile t;
  int ld, cm, m0;
  struct Row {
    int off, c;
    bool ok;
  };
  __device__ Row row(int r) const {
    int img, rr, c, hp;
    t.out(m0 + r, img, rr, c, hp);  // every tile row is computed, also past the image
    return {hp * ld, c, m0 + r < t.m_out()};
  }
  __device__ const int8_t* at(Row rw, int k, bool& ok) const {
    const int tap = k / cm, kc = k - tap * cm;
    const int dy = tap / 3 - 1, dx = tap - (tap / 3) * 3 - 1;
    const int cc = rw.c + dx;
    ok = rw.ok && cc >= 0 && cc < t.w;
    return h1 + rw.off + (dy * t.w + dx) * ld + kc;
  }
};

__global__ void __launch_bounds__(THREADS) bottleneck_im2col_kernel(BottleneckArgs p) {
  extern __shared__ __align__(1024) int8_t smem[];
  __shared__ __align__(16) int8_t sB[RESIDENT_SB];
  const BlockTile t{p.w, p.h, p.n, p.th, p.imgs,
                    static_cast<int>(blockIdx.x) * p.th,
                    static_cast<int>(blockIdx.y) * p.imgs};
  const int ld = p.cm + 16;  // padded row: a warp's fragment loads hit 32 banks
  const int m_halo = t.m_halo(), m_out = t.m_out();
  int8_t* h1 = smem;               // [m_halo][ld]
  int8_t* h2 = h1 + m_halo * ld;   // [m_out][ld]
  int8_t* im = h2 + m_out * ld;    // [BM][kch + 16]
  const int lrow = threadIdx.x >> 1;
  Acc acc;

  // 1. conv1 over the halo tile -> h1 (rows outside the image as zeros)
  for (int m0 = 0; m0 < m_halo; m0 += BM)
    for (int n0 = 0; n0 < p.cm; n0 += BN) {
      int img, r, c;
      const bool ok = t.halo(m0 + lrow, img, r, c);
      const PixelARow la{
          p.x + (ok ? ((static_cast<size_t>(img) * p.h + r) * p.w + c) * p.cin : 0), ok};
      const KMinorBRow lb{p.w1, n0 + lrow, p.cm, p.cin, 0};
      mma_mainloop(la, lb, p.cin / BK, acc);
      for_each_pair(acc, [&](int row, int col, int v0, int v1) {
        const int hp = m0 + row, o = n0 + col;
        if (hp >= m_halo || o >= p.cm) return;
        int img2, r2, c2;
        char2 q = make_char2(0, 0);
        if (t.halo(hp, img2, r2, c2)) {
          q.x = requant_folded(v0, p.v1[o], p.v1[p.cm + o], 0.0f);
          q.y = requant_folded(v1, p.v1[o + 1], p.v1[p.cm + o + 1], 0.0f);
        }
        *reinterpret_cast<char2*>(h1 + hp * ld + o) = q;
      });
    }
  __syncthreads();

  // 2. conv2 (3x3) over im2col chunks of h1 -> h2
  for (int m0 = 0; m0 < m_out; m0 += BM)
    for (int n0 = 0; n0 < p.cm; n0 += BN) {
      const int n_lim = min(BN, p.cm - n0);
      const WarpTile wt = warp_tile(n_lim <= 64);
      const Conv3x3Rows gather{h1, t, ld, p.cm, m0};
      acc_zero(acc);
      const int ldi = p.kch + 16, segs = p.kch / 16;
      for (int k0 = 0; k0 < 9 * p.cm; k0 += p.kch) {
        for (int e = threadIdx.x; e < BM * segs; e += THREADS) {
          const int row = e / segs, seg = e - row * segs;
          bool ok;
          const int8_t* src = gather.at(gather.row(row), k0 + seg * 16, ok);
          int4 v = make_int4(0, 0, 0, 0);
          if (ok) v = *reinterpret_cast<const int4*>(src);
          *reinterpret_cast<int4*>(im + row * ldi + seg * 16) = v;
        }
        __syncthreads();
        const TileRows ar{im, ldi, 0, m_out - m0};
        const KMinorBRow lb{p.w2, n0 + lrow, p.cm, 9 * p.cm, k0};
        mma_resident(ar, lb, p.kch / BK, m_out - m0, n_lim, wt, sB, acc);
      }
      for_each_pair_at(acc, wt, [&](int, int row, int col, int v0, int v1) {
        const int m = m0 + row, o = n0 + col;
        if (m >= m_out || o >= p.cm) return;
        char2 q;
        q.x = requant_folded(v0, p.v2[o], p.v2[p.cm + o], 0.0f);
        q.y = requant_folded(v1, p.v2[o + 1], p.v2[p.cm + o + 1], 0.0f);
        *reinterpret_cast<char2*>(h2 + m * ld + o) = q;
      });
    }
  __syncthreads();

  // 3. conv3 from h2 + the identity residual -> out
  for (int m0 = 0; m0 < m_out; m0 += BM)
    for (int n0 = 0; n0 < p.cout; n0 += BN) {
      const int n_lim = min(BN, p.cout - n0);
      const WarpTile wt = warp_tile(n_lim <= 64);
      const TileRows ar{h2, ld, m0, m_out};
      const KMinorBRow lb{p.w3, n0 + lrow, p.cout, p.cm, 0};
      acc_zero(acc);
      mma_resident(ar, lb, p.cm / BK, m_out - m0, n_lim, wt, sB, acc);
      for_each_pair_at(acc, wt, [&](int, int row, int col, int v0, int v1) {
        const int o = n0 + col;
        int img, r, c, hp;
        if (!t.out(m0 + row, img, r, c, hp) || o >= p.cout) return;
        const size_t pix = (static_cast<size_t>(img) * p.h + r) * p.w + c;
        const char2 res = *reinterpret_cast<const char2*>(p.x + pix * p.cin + o);
        const float y0 = scale_bias(v0, p.v3[o], p.v3[p.cout + o]);
        const float y1 = scale_bias(v1, p.v3[o + 1], p.v3[p.cout + o + 1]);
        const float r0 = scale_bias(res.x, p.vr[o], p.vr[p.cout + o]);
        const float r1 = scale_bias(res.y, p.vr[o + 1], p.vr[p.cout + o + 1]);
        char2 q;
        q.x = static_cast<signed char>(static_cast<int>(
            fminf(fmaxf(rintf(__fadd_rn(y0, r0)), 0.0f), 127.0f)));
        q.y = static_cast<signed char>(static_cast<int>(
            fminf(fmaxf(rintf(__fadd_rn(y1, r1)), 0.0f), 127.0f)));
        *reinterpret_cast<char2*>(p.out + pix * p.cout + o) = q;
      });
    }
}

}  // namespace posetpu

using namespace posetpu;

static BottleneckArgs pack_args(const void* x, const void* w1, const void* w2,
                                const void* w3, const void* wd, const void* v1,
                                const void* v2, const void* v3, const void* vd,
                                const void* vr, void* out, int n, int h, int w,
                                int cin, int cm, int cout, int th, int imgs, int kch) {
  return BottleneckArgs{
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
      static_cast<const int8_t*>(w2), static_cast<const int8_t*>(w3),
      static_cast<const int8_t*>(wd), static_cast<const float*>(v1),
      static_cast<const float*>(v2), static_cast<const float*>(v3),
      static_cast<const float*>(vd), static_cast<const float*>(vr),
      static_cast<int8_t*>(out), n, h, w, cin, cm, cout, th, imgs, kch};
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
      pack_args(x, w1, w2, w3, wd, v1, v2, v3, vd, vr, out, n, h, w, cin, cm, cout, th, 1, 0);
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

// Static shared memory B8b's kernel uses beside its dynamic tile (the two
// main loops' staging buffers): the wrapper sizes its tiles against the rest.
extern "C" int bottleneck_static_smem() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, bottleneck_im2col_kernel) != cudaSuccess) return -1;
  return static_cast<int>(a.sharedSizeBytes);
}

// B8b. The attribute is set when a launch asks for more than any before it.
extern "C" int bottleneck_im2col(const void* x, const void* w1, const void* w2,
                                 const void* w3, const void* v1, const void* v2,
                                 const void* v3, const void* vr, void* out, int n,
                                 int h, int w, int cin, int cm, int cout, int th,
                                 int imgs, int kch, int smem, void* stream) {
  static int configured = 0;
  const BottleneckArgs p = pack_args(x, w1, w2, w3, nullptr, v1, v2, v3, nullptr, vr, out,
                                     n, h, w, cin, cm, cout, th, imgs, kch);
  if (smem > configured) {
    cudaError_t e = cudaFuncSetAttribute(bottleneck_im2col_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = smem;
  }
  dim3 grid((h + th - 1) / th, (n + imgs - 1) / imgs);
  bottleneck_im2col_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
