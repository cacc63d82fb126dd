// The phase-form k4/s2/p1 transposed convs of the deconv tails, and their 1x1
// heads, on one halo + wgmma kernel (sm_90a).
//
// Replaces six Pallas TPU kernels:
//   B1 posetpu/ops/pallas/phase_tail.py: fused_phase_tail2
//      (_phase_tail2_kernel): deconv1 and deconv2 and the 1x1 head,
//      heatmaps in the phase_index_tables(levels=2) order. Two launches:
//        1. deconv1 (JT = 0): x [N, H, W, Cin] -> z1 [N, 2H, 2W, Cout] int8,
//           each phase written interleaved (the 2H x 2W image deconv2 reads);
//        2. deconv2 + head (JT > 0): z1 -> f32 [J, N, 16 H W] packed.
//   B5 phase_tail.py: fused_phase_tail (_phase_tail_kernel): the last deconv
//      and the head in one launch, B1's second with the levels=1 store
//      (column g H W + y W + x of [J, N, 4 H W]).
//   B9a posetpu/ops/pallas/deconv.py: fused_subpixel_deconv (_deconv_kernel):
//      one deconv into the same interleaved int8 image, requantised with the
//      folded per-phase epilogue (EPI = kFolded).
//   B9b deconv.py: fused_subpixel_deconv_head (_deconv_head_kernel): the same
//      and the head -> f32 [N, 2H, 2W, J] row-major (JT > 0, EPI = kFolded).
//   B2 posetpu/ops/pallas/phase_tail.py: fused_subpixel_deconv_batched
//      (deconv0 of the serving tail): the phase maps int8 [4, N, H, W, Cout],
//      phase-major, B1's relu requant on per-phase vectors (EPI =
//      kReluPhase), on the streamed halo.
//   B6 phase_tail.py: fused_subpixel_deconv (the per-pair kernel): B2 with
//      the N-minor store [4, H, W, N, Cout].
// The deconv's output never leaves the block when a head follows: each
// 128-channel half of it is requantised into shared memory and the head's
// int32 sums, which split exactly over the channels, accumulate half by half
// in registers (an mma.sync with M = pixels, N = joints, K = 128).
//
// Phase form: output phase g = (a, b), tap t = (u, v) reads input pixel
// (i + sr, j + sc), sr = u - 1 + a, sc = v - 1 + b, both in {-1, 0, 1}. The
// block computes 128 pixels (two warpgroups of 8 rows of 8) for a run of
// ``sets`` consecutive (phase, 128-channel n-half) pairs; the A operand comes
// by one of two designs (ASRC):
//   kHalo: a 16 x 8 tile of one image's input grid and its one-pixel halo
//     sit in shared memory once, zeros outside the image, channel-blocked:
//     16-byte planes [Cin / 16][18][10][16 bytes]. Each of the 16 (phase,
//     tap) A operands is the tile at a constant offset, and a warpgroup's 64
//     pixels are wgmma's canonical K-major layout with no swizzle: 8 pixels x
//     16 bytes a core matrix, 160 bytes to the next tile row, a plane to the
//     next 16 channels. wgmma reads A by descriptor straight from the halo,
//     which serves all four phases. Needs the halo to fit: Cin <= 930-960.
//   kHaloStream: for a Cin whose halo does not fit (deconv0, 8 x 8 at Cin
//     2048: 200 KB an image). Each warpgroup takes an 8 x 8 tile of its own
//     image (an 8 x 8 image is exactly 64 pixels), and the halo's planes
//     arrive K-chunk by K-chunk through the ring: one TMA box a plane over x
//     [N][H][W][Cin] at (c, x0 - 1, y0 - 1, n0), 16 x 10 x 10 x 2 bytes, whose
//     out-of-bounds zero fill is the padding. It lands in kHalo's
//     [plane][image][10][10][16 bytes] layout, so the A descriptors are the
//     same; the weights' K runs (32-channel chunk, tap, channel), so a chunk
//     serves all four taps while it is in the ring.
// The weights always stream: ops/phase_tail.py tiles each phase's K-minor
// [Cout, 4 Cin] weight once into stage images [4 phase][Cout / 128]
// [4 Cin / 64][128][64] (B8a's ops/resblock.tile_weight: 64-byte rows whose
// 16-byte chunks are XOR-swizzled by (row >> 1) & 3, which is wgmma's 64-byte
// swizzle), so the block's k-steps are one flat list, (phase, n-half, k) in
// the images' own order; a ring stage is two consecutive images (128 bytes
// of K) brought by one cp.async.bulk from one thread, and in the streamed
// design the step's two halo planes beside them, all counted by the stage's
// mbarrier, ``stages`` - 1 steps ahead across phase and n-half borders. Two
// warpgroups each run wgmma.mma_async m64n128k32 s8 (exact int32 sums) on
// their 64 pixels, and keep a step's products in flight while the next
// step's are issued (wgmma.wait_group 1).
//
// Epilogues (EPI), the arithmetic: kRelu, B1's and B5's: relu(acc * s + b) *
// (1 / so), rounded once, clipped to [-127, 127], s and b [2, Cout] shared by
// the phases; kFolded, B9's: acc * v0 + v1 rounded once and clipped to
// [0, 127], v [2, 4 Cout] per phase (scale and bias pre-divided by the output
// scale on the host); kReluPhase, B2's and B6's: kRelu's arithmetic with
// kFolded's per-phase rows (scales of the four phases, then their biases:
// [8, Cout]).
// Stores (STORE), the layout, pixel (y, x) of phase g = (a, b) of image n:
// the deconv's int8 kInterleaved at (2y + a, 2x + b) of [N, 2H, 2W, Cout],
// kPhaseMajor at [g][n][y][x] of [4, N, H, W, Cout], kNMinor at [g][y][x][n]
// of [4, H, W, N, Cout]; the head's f32 kHeadPacked2 in the levels=2 packed
// order of [J, N, 4 H W], kHeadPacked1 in the levels=1 order (column g H W +
// y W + x) of the same, kHeadRowMajor J floats at pixel (2y + a, 2x + b) of
// [N, 2H, 2W, J]. The instances (tail2_kernels[] below) pair them.
//
// Bounds on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s), 128 images: B1 at
// 16x16 deconv1 input, C = 256, J = 16: 1.73e11 MAC -> 0.176 ms; B9b (32x32,
// 256 -> 256 -> 16) 1.40e11 MAC -> 0.141 ms; B9a deconv0 (8x8, 2048 -> 256)
// 6.9e10 MAC -> 0.069 ms (B2's and B6's the same) and deconv1 (16x16, 256 ->
// 256) 3.4e10 -> 0.035 ms: all bound by operations, as B5 (B9b's shape) and
// B6 (B2's) are at any batch. Each block streams its sets' weights from L2
// (4 taps x Cin x 128 bytes a set: 128 KB at Cin 256, 1 MB at Cin 2048), so
// the block's 128 pixels set the weights' L2 traffic: deconv0 reads 8192 /
// 128 x 8.4 MB = 0.54 GB of them, whatever the sets a block. Measured design
// by design in PERF.md (tools/torch_kernel_sweep.py tail2, deconv): on
// deconv0 the streamed halo beat B3's implicit GEMM (a shifted 128-channel
// TMA box per (phase, tap): 4x the A bytes) by 15-25 %;
// ops/phase_tail.plan_tail2 gives the ring's shape and the block's sets.
//
// Exactness: int32 sums in any order; requant_relu / requant_folded /
// scale_bias of int8_mma.cuh (multiply and add rounded separately,
// --fmad=false), 1/so a correctly rounded divide, rintf half to even:
// bit-equal to ops/phase_tail's plain versions (phase_tail2_plain,
// phase_tail_plain, subpixel_deconv_plain, subpixel_deconv_pairs_plain) and
// ops/deconv's.

#include "ring.cuh"
#include "wgmma.cuh"

namespace posetpu {

constexpr int T2_TH = 16, T2_TW = 8;      // kHalo's input tile: two warpgroups of 8 rows
constexpr int T2_HW = T2_TW + 2;          // halo pixels a row
constexpr int T2_PLANE = (T2_TH + 2) * T2_HW * 16;  // a 16-channel plane of the halo
constexpr int T2_KB = 64;                 // bytes of K per weight stage image
constexpr int T2_BN = 128;                // output channels per n-half
constexpr int T2_STAGE = T2_BN * T2_KB;   // a weight stage image
constexpr int T2_IPS = 2;                 // stage images a ring stage: 128 bytes of K a step
constexpr int T2_W_BYTES = T2_IPS * T2_STAGE;
constexpr int T2_LDZ = T2_BN + 16;        // a row of the requantised half, bytes
constexpr int T2_THREADS = 256;
constexpr int T2_IMGS = 2;                // the streamed designs: an image a warpgroup
constexpr int T2_SPLANE = T2_IMGS * 10 * T2_HW * 16;  // kHaloStream: a plane, both images

enum Epilogue { kRelu = 0, kFolded = 1, kReluPhase = 2 };
enum ASource { kHalo = 0, kHaloStream = 1 };
enum Store {
  kInterleaved = 0, kPhaseMajor = 1, kNMinor = 2,            // the deconv's, int8
  kHeadPacked2 = 3, kHeadPacked1 = 4, kHeadRowMajor = 5      // the head's, f32
};
__host__ __device__ constexpr bool head_store(int store) { return store >= kHeadPacked2; }

// bytes of A a ring stage holds beside its weights (two planes), and the
// stage's size (1024-aligned: the swizzled weights' atoms)
__host__ __device__ constexpr int a_bytes(int asrc) {
  return asrc == kHaloStream ? 2 * T2_SPLANE : 0;
}
__host__ __device__ constexpr int ring_stage_bytes(int asrc) {
  return T2_W_BYTES + (a_bytes(asrc) + 1023) / 1024 * 1024;
}

struct Tail2Args {
  const int8_t* x;    // [N, H, W, Cin]
  const int8_t* wt;   // stage images [4][NH][KS][128][64]
  const float* sc;    // kRelu: [2, Cout] (scale, bias); else per phase [2, 4 Cout]
  const float* so;    // kRelu, kReluPhase: the output scale
  const int8_t* wh;   // head [JT * 8][NH * 128], zero padded (JT > 0)
  const float* vh;    // [2, J]: scale, bias (JT > 0)
  void* out;          // as the store lays it out (Store)
  int n, h, w, cin, cout, joints;
  int tiles_x, stages, sets;
};

// where the block's shared memory regions start (ops/phase_tail.py plans
// them); the halo (kHalo) starts at 0
struct Tail2Layout {
  int off_ring, off_z, off_wh, off_sc, off_bar;
};

template <int JT, int EPI, int ASRC, int STORE>
__global__ void __launch_bounds__(T2_THREADS, 2) tail2_kernel(
    const Tail2Args p, const Tail2Layout lay,
    const __grid_constant__ CUtensorMap tm_x) {  // x [N][H][W][Cin] (streamed designs)
  static_assert(JT == 0 || ASRC == kHalo, "a head follows only the resident halo");
  static_assert((JT > 0) == head_store(STORE), "a head store with a head, a deconv's without");
  constexpr bool kStream = ASRC != kHalo;
  constexpr int ring_stage = ring_stage_bytes(ASRC);
  constexpr int nvec = EPI == kRelu ? 2 : 8;  // rows of sv: (scale, bias) x phases
  extern __shared__ __align__(1024) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  // the tile: kHalo 16 x 8 of image blockIdx.y; streamed, 8 x 8 of images
  // 2 blockIdx.y and 2 blockIdx.y + 1, one a warpgroup
  constexpr int tile_h = kStream ? 8 : T2_TH;
  const int y0 = (static_cast<int>(blockIdx.x) / p.tiles_x) * tile_h;
  const int x0 = (static_cast<int>(blockIdx.x) % p.tiles_x) * T2_TW;
  const int nh_count = (p.cout + T2_BN - 1) / T2_BN;
  const int ks_count = 4 * p.cin / (T2_KB * T2_IPS);  // ring steps a (phase, n-half)
  const int set0 = blockIdx.z * p.sets;               // the block's first (phase, n-half)
  const int total = p.sets * ks_count;
  const int cpad = nh_count * T2_BN;
  const unsigned smem_s = smem_addr(smem);
  const unsigned full0 = smem_s + lay.off_bar;
  int8_t* zs = smem + lay.off_z;
  float* sv = reinterpret_cast<float*>(smem + lay.off_sc);  // [nvec][cpad], then vh [2][JT * 8]
  const int8_t* wt = p.wt + static_cast<size_t>(set0) * ks_count * T2_W_BYTES;

  // the image, row and column of tile row r (0..127), as the epilogues see it
  auto pixel = [&](int r, int& img, int& y, int& x) {
    img = kStream ? T2_IMGS * blockIdx.y + (r >> 6) : blockIdx.y;
    y = y0 + (kStream ? (r >> 3) & 7 : r >> 3);
    x = x0 + (r & 7);
    return img < p.n && y < p.h && x < p.w;
  };

  // ---- the ring: thread 0 asks for step q's weights (and, streamed, its
  // halo planes) into stage ``st``
  auto issue = [&](int q, int st) {
    const unsigned dst = smem_s + lay.off_ring + st * ring_stage, bar = full0 + 8 * st;
    mbar_expect_tx(bar, T2_W_BYTES + a_bytes(ASRC));
    bulk_copy(dst, wt + static_cast<size_t>(q) * T2_W_BYTES, T2_W_BYTES, bar);
    if constexpr (ASRC == kHaloStream) {
      // K chunk k: channels 32 k .. 32 k + 31, two planes of the halos
      const int c = 32 * (q % ks_count);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        tma_load_4d(dst + T2_W_BYTES + j * T2_SPLANE, &tm_x, c + 16 * j, x0 - 1, y0 - 1,
                    T2_IMGS * blockIdx.y, bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init_fence();
    for (int q = 0; q < p.stages - 1 && q < total; ++q) issue(q, q);
  }
  if constexpr (ASRC == kHalo) {
    // ---- the halo tile into its 16-channel planes, zeros outside the image
    const int8_t* xi = p.x + static_cast<size_t>(blockIdx.y) * p.h * p.w * p.cin;
    const int cch = p.cin / 16;
    for (int e = tid; e < (T2_TH + 2) * T2_HW * cch; e += T2_THREADS) {
      const int px = e / cch, ch = e - px * cch;
      const int hy = px / T2_HW, hx = px - hy * T2_HW;
      const int y = y0 - 1 + hy, x = x0 - 1 + hx;
      const bool in = y >= 0 && y < p.h && x >= 0 && x < p.w;
      cp_async16(smem + ch * T2_PLANE + px * 16,
                 in ? xi + (static_cast<size_t>(y) * p.w + x) * p.cin + ch * 16 : xi, in);
    }
    cp_async_commit();
  }
  // ---- scales (zero past Cout), the head
  for (int i = tid; i < cpad; i += T2_THREADS) {
    const bool in = i < p.cout;
#pragma unroll
    for (int r = 0; r < nvec; ++r)  // per phase: row 4 (scale, bias) + phase
      sv[r * cpad + i] = in ? p.sc[r * p.cout + i] : 0.0f;
  }
  const int ldh = cpad + 16;
  if constexpr (JT > 0) {
    for (int i = tid; i < JT * 8; i += T2_THREADS) {
      sv[nvec * cpad + i] = i < p.joints ? p.vh[i] : 0.0f;
      sv[nvec * cpad + JT * 8 + i] = i < p.joints ? p.vh[p.joints + i] : 0.0f;
    }
    for (int e = tid; e < JT * 8 * (cpad / 16); e += T2_THREADS) {
      const int r = e / (cpad / 16), ch = e - r * (cpad / 16);
      *reinterpret_cast<int4*>(smem + lay.off_wh + r * ldh + ch * 16) =
          *reinterpret_cast<const int4*>(p.wh + r * cpad + ch * 16);
    }
  }
  const float inv_so = EPI != kFolded ? __fdiv_rn(1.0f, *p.so) : 0.0f;
  if constexpr (ASRC == kHalo) cp_async_wait0();
  // every thread's halo copies and scales are in, and visible to the tensor
  // cores' reads (the async proxy); what TMA brings needs only its mbarrier
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // warpgroup wg takes tile rows 8 wg .. 8 wg + 7 (kHalo) or its own image's
  // 8 x 8 tile (streamed): its A rows start here, less the tap's offset and
  // the channel plane
  const int wg = warp >> 2;
  const unsigned a_base = kHalo == ASRC ? smem_s + ((8 * wg + 1) * T2_HW + 1) * 16
                                        : (wg * 10 * T2_HW + T2_HW + 1) * 16;
  const int l8 = lane & 7, lmi = lane >> 3;  // ldmatrix: lane l gives a row of matrix l >> 3
  int d[64];
  int hacc[JT > 0 ? JT : 1][4];
  auto clear = [&](auto& a) {
#pragma unroll
    for (int i = 0; i < static_cast<int>(sizeof(a) / sizeof(int)); ++i)
      reinterpret_cast<int*>(&a)[i] = 0;
  };
  clear(d);
  clear(hacc);

  int q = 0, st = 0, parity = 0;
  for (int set = set0; set < set0 + p.sets; ++set) {
    const int g = set / nh_count, nh = set - g * nh_count;
    const int a = g >> 1, b = g & 1;
    int tap = 0, c = 0;
    for (int ks = 0; ks < ks_count; ++ks) {
      // ---- a k-step: its stage has landed; its 32-deep products are issued,
      // A by descriptor (tap (u, v) reads u - 1 + a rows and v - 1 + b pixels
      // on) and B from the stage
      mbar_wait(full0 + 8 * st, parity);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      const unsigned stage = smem_s + lay.off_ring + st * ring_stage;
#pragma unroll
      for (int s = 0; s < 2 * T2_IPS; ++s) {
        uint64_t da;
        if constexpr (ASRC == kHalo) {
          da = desc_plain(a_base + (c >> 4) * T2_PLANE +
                              (((tap >> 1) - 1 + a) * T2_HW + (tap & 1) - 1 + b) * 16,
                          T2_PLANE, T2_HW * 16);
          c += 32;
          if (c == p.cin) {
            c = 0;
            ++tap;
          }
        } else {  // the step's 32 channels under tap s
          da = desc_plain(stage + T2_W_BYTES + a_base +
                              (((s >> 1) - 1 + a) * T2_HW + (s & 1) - 1 + b) * 16,
                          T2_SPLANE, T2_HW * 16);
        }
        wgmma_m64n128k32(d, da, desc_sw64(stage + (s >> 1) * T2_STAGE + 32 * (s & 1)));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the step before this one is done: once every warpgroup is past the
      // barrier its stage is free, and is asked to be filled stages - 1
      // steps on
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      keep_in_registers(d);
      __syncthreads();
      if (tid == 0 && q + p.stages - 1 < total)
        issue(q + p.stages - 1, st == 0 ? p.stages - 1 : st - 1);
      ++q;
      if (++st == p.stages) {
        st = 0;
        parity ^= 1;
      }
    }

    // ---- the half's requant -> shared memory (zeros past Cout): d[4 i + r]
    // is pixel 16 (warp % 4) + gid (+ 8 for r >= 2) of the warpgroup,
    // channel 8 i + 2 tig + (r & 1)
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    keep_in_registers(d);
    const float* s_g = sv + (EPI != kRelu ? g : 0) * cpad;
    const float* b_g = sv + (EPI != kRelu ? 4 + g : 1) * cpad;
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const int row = 64 * wg + 16 * (warp & 3) + 8 * (k & 1) + gid;
      const int col = (k >> 1) * 8 + tig * 2, o = nh * T2_BN + col;
      char2 v = make_char2(0, 0);
      if (o < p.cout) {
        if constexpr (EPI == kFolded) {
          v.x = requant_folded(d[2 * k], s_g[o], b_g[o], 0.0f);
          v.y = requant_folded(d[2 * k + 1], s_g[o + 1], b_g[o + 1], 0.0f);
        } else {
          v.x = requant_relu(scale_bias(d[2 * k], s_g[o], b_g[o]), inv_so);
          v.y = requant_relu(scale_bias(d[2 * k + 1], s_g[o + 1], b_g[o + 1]), inv_so);
        }
      }
      *reinterpret_cast<char2*>(zs + row * T2_LDZ + col) = v;
    }
    clear(d);
    __syncthreads();

    if constexpr (JT == 0) {
      // the deconv's output leaves in the store's layout, 16 bytes a store,
      // a pixel's 128 channels one 128-byte line
      int8_t* z1 = static_cast<int8_t*>(p.out);
      for (int e = tid; e < 128 * (T2_BN / 16); e += T2_THREADS) {
        const int row = e >> 3, ch = e & 7, o = nh * T2_BN + ch * 16;
        int img, y, x;
        if (!pixel(row, img, y, x) || o >= p.cout) continue;
        size_t px;
        if constexpr (STORE == kPhaseMajor) {
          px = ((static_cast<size_t>(g) * p.n + img) * p.h + y) * p.w + x;
        } else if constexpr (STORE == kNMinor) {
          px = ((static_cast<size_t>(g) * p.h + y) * p.w + x) * p.n + img;
        } else {
          px = (static_cast<size_t>(img) * 2 * p.h + 2 * y + a) * 2 * p.w + 2 * x + b;
        }
        int8_t* dst = z1 + px * p.cout + o;
        const int8_t* src = zs + row * T2_LDZ + ch * 16;
        if (p.cout % 16 == 0) {
          *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
        } else {
          for (int u = 0; u < min(16, p.cout - o); ++u) dst[u] = src[u];
        }
      }
      // the next half's requant overwrites zs only after this barrier's
      // successors: every k-step ends in one
    } else {
      // the head's sums over this half's 128 channels, warp w taking pixels
      // 16 w .. 16 w + 15 and all JT * 8 joints, fragments by ldmatrix: A
      // (pixels 0-7 | 8-15) x (k 0-15 | 16-31), B (k 0-15 | 16-31) x (joints
      // j | j + 8)
      const unsigned za = smem_s + lay.off_z + (warp * 16 + (lmi & 1) * 8 + l8) * T2_LDZ +
                          (lmi >> 1) * 16;
      const unsigned wa = smem_s + lay.off_wh + ((lmi >> 1) * 8 + l8) * ldh + nh * T2_BN +
                          (lmi & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < T2_BN / 32; ++kk) {
        unsigned af[4];
        ldsm4(af[0], af[1], af[2], af[3], za + kk * 32);
#pragma unroll
        for (int jt = 0; jt < JT; jt += 2) {
          unsigned b0[2], b1[2];
          ldsm4(b0[0], b0[1], b1[0], b1[1], wa + jt * 8 * ldh + kk * 32);
          mma_s8(hacc[jt], af, b0);
          mma_s8(hacc[jt + 1], af, b1);
        }
      }
      if (nh == nh_count - 1) {
        // ---- the phase's head epilogue: hacc[jt][2 hh + e] is pixel
        // 16 w + 8 hh + gid, joint 8 jt + 2 tig + e
        const float* vs = sv + nvec * cpad;
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = warp * 16 + hh * 8 + gid;
          int img, y, x;
          if (!pixel(row, img, y, x)) continue;
          if constexpr (STORE == kHeadRowMajor) {
            // J floats at pixel (2y + a, 2x + b) of the 2H x 2W image
            float* hm = static_cast<float*>(p.out) +
                        ((static_cast<size_t>(img) * 2 * p.h + 2 * y + a) * 2 * p.w + 2 * x +
                         b) * p.joints;
#pragma unroll
            for (int jt = 0; jt < JT; ++jt) {
              const int joint = jt * 8 + tig * 2;
              const float v0 = scale_bias(hacc[jt][2 * hh], vs[joint], vs[JT * 8 + joint]);
              const float v1 =
                  scale_bias(hacc[jt][2 * hh + 1], vs[joint + 1], vs[JT * 8 + joint + 1]);
              if (p.joints % 2 == 0 && joint < p.joints) {
                *reinterpret_cast<float2*>(hm + joint) = make_float2(v0, v1);
              } else {
                if (joint < p.joints) hm[joint] = v0;
                if (joint + 1 < p.joints) hm[joint + 1] = v1;
              }
            }
          } else {
            // [J, N, 4 h w]; the levels = 2 order: pixel (y, x) of the
            // phase g is packed position (4 g + 2 (y & 1) + (x & 1)) * (h/2 *
            // w/2) + (y >> 1) * w/2 + (x >> 1); the levels = 1 order: g h w +
            // y w + x
            float* hm = static_cast<float*>(p.out);
            const int plane = 4 * p.h * p.w;
            size_t pk;
            if constexpr (STORE == kHeadPacked2) {
              const int bh = p.h / 2, bw = p.w / 2;
              pk = static_cast<size_t>(4 * g + 2 * (y & 1) + (x & 1)) * bh * bw +
                   (y >> 1) * bw + (x >> 1);
            } else {
              pk = (static_cast<size_t>(g) * p.h + y) * p.w + x;
            }
#pragma unroll
            for (int jt = 0; jt < JT; ++jt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int joint = jt * 8 + tig * 2 + e;
                if (joint < p.joints)
                  hm[(static_cast<size_t>(joint) * p.n + img) * plane + pk] =
                      scale_bias(hacc[jt][2 * hh + e], vs[joint], vs[JT * 8 + joint]);
              }
          }
        }
        clear(hacc);
      }
    }
  }
}

using Tail2Fn = void (*)(Tail2Args, Tail2Layout, CUtensorMap);

struct Tail2Kernel {
  int jt, epi, asrc, store;
  Tail2Fn fn;
  int configured;  // dynamic shared memory the kernel has been allowed so far
};

#define TAIL2_INSTANCE(JT, EPI, ASRC, STORE) \
  {JT, EPI, ASRC, STORE, tail2_kernel<JT, EPI, ASRC, STORE>, 0}

// the instances: B1's two launches (deconv1; deconv2 + head at J <= 16 and
// <= 32), B5's one launch, B9's at the resident halo, B9a's, B2's and B6's
// streamed halo
static Tail2Kernel tail2_kernels[] = {
    TAIL2_INSTANCE(0, kRelu, kHalo, kInterleaved),           // B1 deconv1
    TAIL2_INSTANCE(2, kRelu, kHalo, kHeadPacked2),           // B1 deconv2 + head
    TAIL2_INSTANCE(4, kRelu, kHalo, kHeadPacked2),
    TAIL2_INSTANCE(2, kRelu, kHalo, kHeadPacked1),           // B5
    TAIL2_INSTANCE(4, kRelu, kHalo, kHeadPacked1),
    TAIL2_INSTANCE(0, kFolded, kHalo, kInterleaved),         // B9a deconv1
    TAIL2_INSTANCE(2, kFolded, kHalo, kHeadRowMajor),        // B9b
    TAIL2_INSTANCE(4, kFolded, kHalo, kHeadRowMajor),
    TAIL2_INSTANCE(0, kFolded, kHaloStream, kInterleaved),   // B9a deconv0
    TAIL2_INSTANCE(0, kReluPhase, kHaloStream, kPhaseMajor), // B2
    TAIL2_INSTANCE(0, kReluPhase, kHaloStream, kNMinor),     // B6
};

static Tail2Kernel* find_kernel(int jt, int epi, int asrc, int store) {
  for (Tail2Kernel& k : tail2_kernels)
    if (k.jt == jt && k.epi == epi && k.asrc == asrc && k.store == store) return &k;
  return nullptr;
}

static cudaError_t configure(Tail2Kernel& k, int smem) {
  if (smem <= k.configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) k.configured = smem;
  return e;
}

}  // namespace posetpu

using namespace posetpu;

// One launch of the kernel. ``jt`` 0 runs a deconv into int8; 2 or 4 a deconv
// and the head (J <= 8 jt). ``epi`` picks the epilogue (Epilogue), ``asrc``
// the design (0 the resident halo, 1 the streamed halo), ``store`` the
// output's layout (Store); the four name an instance. ``sets`` the (phase,
// n-half) pairs a block takes (a divisor of 4 NH; a multiple of NH with a
// head). The ring's shape and the
// shared-memory layout come planned from ops/phase_tail.py (plan_tail2).
extern "C" int tail2(const void* x, const void* wt, const void* sc, const void* so,
                     const void* wh, const void* vh, void* out, int n, int h, int w, int cin,
                     int cout, int joints, int jt, int epi, int asrc, int store, int sets,
                     int stages, int off_ring, int off_z, int off_wh, int off_sc, int off_bar,
                     int smem, void* stream) {
  Tail2Kernel* k = find_kernel(jt, epi, asrc, store);
  const int nh = (cout + T2_BN - 1) / T2_BN;
  if (k == nullptr || sets < 1 || (4 * nh) % sets || (jt > 0 && sets % nh))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = configure(*k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tm_x{};
  if (asrc == kHaloStream) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(cin), static_cast<cuuint64_t>(w),
                                static_cast<cuuint64_t>(h), static_cast<cuuint64_t>(n)};
    const cuuint64_t pitch[3] = {static_cast<cuuint64_t>(cin),
                                 static_cast<cuuint64_t>(w) * cin,
                                 static_cast<cuuint64_t>(h) * w * cin};
    const cuuint32_t box[4] = {16, T2_HW, 10, T2_IMGS};
    if (!uint8_map(&tm_x, x, 4, dims, pitch, box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tile_h = asrc == kHalo ? T2_TH : 8;
  const int tiles_x = (w + T2_TW - 1) / T2_TW, tiles_y = (h + tile_h - 1) / tile_h;
  const Tail2Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
                    static_cast<const float*>(sc), static_cast<const float*>(so),
                    static_cast<const int8_t*>(wh), static_cast<const float*>(vh), out,
                    n, h, w, cin, cout, joints, tiles_x, stages, sets};
  const Tail2Layout lay{off_ring, off_z, off_wh, off_sc, off_bar};
  dim3 grid(tiles_x * tiles_y, asrc == kHalo ? n : (n + T2_IMGS - 1) / T2_IMGS, 4 * nh / sets);
  k->fn<<<grid, T2_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p, lay, tm_x);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one instance that fit one SM at ``smem`` bytes of dynamic shared
// memory, or minus the CUDA error.
extern "C" int tail2_blocks_per_sm(int jt, int epi, int asrc, int store, int smem) {
  Tail2Kernel* k = find_kernel(jt, epi, asrc, store);
  if (k == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = configure(*k, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k->fn, T2_THREADS, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}
