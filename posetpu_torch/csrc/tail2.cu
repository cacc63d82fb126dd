// The fused deconv1 + deconv2 + head of the serving tail (sm_90a).
//
// Replaces the Pallas TPU kernel B1 posetpu/ops/pallas/phase_tail.py:
// fused_phase_tail2 (_phase_tail2_kernel): deconv1 and deconv2 (k4/s2/p1
// transposed convs, phase form) and the 1x1 head, heatmaps in the
// phase_index_tables(levels=2) order. Two launches of one kernel:
//   1. deconv1 (JT = 0): x [N, H, W, Cin] -> z1 [N, 2H, 2W, Cout] int8, each
//      phase written interleaved (the 2H x 2W image deconv2 reads);
//   2. deconv2 + head (JT > 0): z1 -> f32 [J, N, 16 H W]. deconv2's output z2
//      never leaves the block: each 128-channel half of it is requantised into
//      shared memory and the head's int32 sums, which split exactly over the
//      channels, accumulate half by half in registers (an mma.sync with M =
//      pixels, N = joints, K = 128). The epilogue acc * scale + bias writes
//      straight into the packed order.
//
// Phase form: output phase g = (a, b), tap t = (u, v) reads input pixel
// (i + sr, j + sc), sr = u - 1 + a, sc = v - 1 + b, both in {-1, 0, 1}. A
// block takes a 16 x 8 tile of one image's input grid and its one-pixel halo
// into shared memory once, zeros outside the image, channel-blocked: 16-byte
// planes [Cin / 16][18][10][16 bytes]. Then each of the 16 (phase, tap) A
// operands is the tile at a constant offset, and a warpgroup's 64 pixels (8
// tile rows of 8) are wgmma's canonical K-major layout with no swizzle: 8
// pixels x 16 bytes a core matrix, 160 bytes to the next tile row, a plane to
// the next 16 channels. So wgmma reads A by descriptor straight from the
// halo: no gather, no predicate, no register traffic, and the halo serves all
// four phases. Only the weights stream: ops/phase_tail.py tiles each phase's
// K-minor [Cout, 4 Cin] weight once into stage images [4 phase][Cout / 128]
// [4 Cin / 64][128][64] (B8a's ops/resblock.tile_weight: 64-byte rows whose
// 16-byte chunks are XOR-swizzled by (row >> 1) & 3, which is wgmma's 64-byte
// swizzle), so the block's k-steps are one flat list, (phase, n-half, k) in
// the images' own order; a ring stage is consecutive images brought by
// one cp.async.bulk from one thread and counted by the stage's mbarrier (two
// images, 128 bytes of K, a step),
// ``stages`` - 1 steps ahead, across phase and n-half borders. Two
// warpgroups each run wgmma.mma_async m64n128k32 s8 (exact int32 sums) on
// their 64 pixels, and keep a step's products in flight while the next
// step's are issued (wgmma.wait_group 1).
//
// Bound on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s), 128 images of 16x16
// deconv1 input at C = 256, J = 16: deconv1 3.4e10 MAC, deconv2 1.37e11, head
// 2.1e9 -> 0.176 ms by operations (42 MB in and out: 0.013 ms). Each block
// streams all of w from L2 (1 MB for deconv2: 1,024 blocks, 1 GB). Measured
// design by design in PERF.md (tools/torch_kernel_sweep.py tail2): the same
// structure on mma.sync with ldmatrix fragments is 10-20 % slower, and 256-pixel
// tiles (half the weight reads, one block an SM) do not beat two 128-pixel
// blocks an SM; ops/phase_tail.plan_tail2 gives the ring's shape.
//
// Exactness: int32 sums in any order; requant_relu / scale_bias of
// int8_mma.cuh (multiply and add rounded separately, --fmad=false), 1/so a
// correctly rounded divide, rintf half to even: bit-equal to
// ops/phase_tail.phase_tail2_plain.

#include "ring.cuh"

namespace posetpu {

constexpr int T2_TH = 16, T2_TW = 8;      // the input tile: two warpgroups of 8 rows
constexpr int T2_HW = T2_TW + 2;          // halo pixels a row
constexpr int T2_PLANE = (T2_TH + 2) * T2_HW * 16;  // a 16-channel plane of the halo
constexpr int T2_KB = 64;                 // bytes of K per weight stage image
constexpr int T2_BN = 128;                // output channels per n-half
constexpr int T2_STAGE = T2_BN * T2_KB;   // a weight stage image
constexpr int T2_IPS = 2;                 // stage images a ring stage: 128 bytes of K a step
constexpr int T2_RING_STAGE = T2_IPS * T2_STAGE;
constexpr int T2_LDZ = T2_BN + 16;        // a row of the requantised half, bytes
constexpr int T2_THREADS = 256;

struct Tail2Args {
  const int8_t* x;    // [N, H, W, Cin]
  const int8_t* wt;   // stage images [4][NH][KS][128][64]
  const float* sc;    // [2, Cout]: scale, bias (every phase)
  const float* so;    // the output scale
  const int8_t* wh;   // head [JT * 8][NH * 128], zero padded (JT > 0)
  const float* vh;    // [2, J]: scale, bias (JT > 0)
  void* out;          // JT = 0: int8 [N, 2H, 2W, Cout]; else f32 [J, N, 4 H W]
  int n, h, w, cin, cout, joints;
  int tiles_x, stages;
};

// where the block's shared memory regions start (ops/phase_tail.py plans
// them); the halo starts at 0
struct Tail2Layout {
  int off_ring, off_z, off_wh, off_sc, off_bar;
};

// wgmma operand descriptors: A K-major with no swizzle (8-row x 16-byte core
// matrices, ``lbo`` bytes apart along K, ``sbo`` along M), B a 64-byte
// swizzled stage image (rows of 64 bytes, 8-row groups 512 bytes apart)
__device__ __forceinline__ uint64_t desc_plain(unsigned addr, int lbo, int sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

__device__ __forceinline__ uint64_t desc_sw64(unsigned addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) |
         (uint64_t(512 >> 4) << 32) | (uint64_t(2) << 62);
}

__device__ __forceinline__ void wgmma_m64n128k32(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db));
}

// the compiler must not move the accumulators while a wgmma may write them
__device__ __forceinline__ void keep_in_registers(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int JT>
__global__ void __launch_bounds__(T2_THREADS, 2) tail2_kernel(Tail2Args p, Tail2Layout lay) {
  extern __shared__ __align__(1024) int8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int y0 = (static_cast<int>(blockIdx.x) / p.tiles_x) * T2_TH;
  const int x0 = (static_cast<int>(blockIdx.x) % p.tiles_x) * T2_TW;
  const int img = blockIdx.y;
  const int nh_count = (p.cout + T2_BN - 1) / T2_BN;
  const int ks_count = 4 * p.cin / (T2_KB * T2_IPS);  // ring steps a (phase, n-half)
  constexpr int ring_stage = T2_RING_STAGE;
  const int total = 4 * nh_count * ks_count;
  const int cpad = nh_count * T2_BN;
  const unsigned smem_s = smem_addr(smem);
  const unsigned full0 = smem_s + lay.off_bar;
  int8_t* zs = smem + lay.off_z;
  float* sv = reinterpret_cast<float*>(smem + lay.off_sc);  // [2][cpad], then vh [2][JT * 8]

  // ---- the ring: thread 0 asks for step q's images into stage q % stages
  if (tid == 0) {
    for (int s = 0; s < p.stages; ++s) mbar_init(full0 + 8 * s, 1);
    mbar_init_fence();
    for (int q = 0; q < p.stages - 1 && q < total; ++q) {
      mbar_expect_tx(full0 + 8 * q, ring_stage);
      bulk_copy(smem_s + lay.off_ring + q * ring_stage, p.wt + static_cast<size_t>(q) * ring_stage,
                ring_stage, full0 + 8 * q);
    }
  }
  // ---- the halo tile into its 16-channel planes, zeros outside the image
  const int8_t* xi = p.x + static_cast<size_t>(img) * p.h * p.w * p.cin;
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
  // ---- scales (zero past Cout), the head
  for (int i = tid; i < cpad; i += T2_THREADS) {
    sv[i] = i < p.cout ? p.sc[i] : 0.0f;
    sv[cpad + i] = i < p.cout ? p.sc[p.cout + i] : 0.0f;
  }
  const int ldh = cpad + 16;
  if constexpr (JT > 0) {
    for (int i = tid; i < JT * 8; i += T2_THREADS) {
      sv[2 * cpad + i] = i < p.joints ? p.vh[i] : 0.0f;
      sv[2 * cpad + JT * 8 + i] = i < p.joints ? p.vh[p.joints + i] : 0.0f;
    }
    for (int e = tid; e < JT * 8 * (cpad / 16); e += T2_THREADS) {
      const int r = e / (cpad / 16), ch = e - r * (cpad / 16);
      *reinterpret_cast<int4*>(smem + lay.off_wh + r * ldh + ch * 16) =
          *reinterpret_cast<const int4*>(p.wh + r * cpad + ch * 16);
    }
  }
  const float inv_so = __fdiv_rn(1.0f, *p.so);
  cp_async_wait0();
  // every thread's halo copies and scales are in, and visible to the tensor
  // cores' reads (the async proxy)
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  // warpgroup wg takes tile rows 8 wg .. 8 wg + 7: its A rows start here,
  // less the tap's offset and the channel plane
  const int wg = warp >> 2;
  const unsigned a_base = smem_s + ((8 * wg + 1) * T2_HW + 1) * 16;
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
  for (int g = 0; g < 4; ++g) {
    const int a = g >> 1, b = g & 1;
    for (int nh = 0; nh < nh_count; ++nh) {
      int tap = 0, c = 0;
      for (int ks = 0; ks < ks_count; ++ks) {
        // ---- a k-step: its images have landed; its 32-deep products are
        // issued, A by descriptor from the halo (tap (u, v) reads u - 1 + a
        // rows and v - 1 + b pixels on) and B from the stage
        mbar_wait(full0 + 8 * st, parity);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int s = 0; s < 2 * T2_IPS; ++s) {
          const unsigned at = a_base + (c >> 4) * T2_PLANE +
                              (((tap >> 1) - 1 + a) * T2_HW + (tap & 1) - 1 + b) * 16;
          wgmma_m64n128k32(d, desc_plain(at, T2_PLANE, T2_HW * 16),
                           desc_sw64(smem_s + lay.off_ring + st * ring_stage +
                                     (s >> 1) * T2_STAGE + 32 * (s & 1)));
          c += 32;
          if (c == p.cin) {
            c = 0;
            ++tap;
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        // the step before this one is done: once every warpgroup is past
        // the barrier its stage is free, and is asked to be filled stages -
        // 1 steps on
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        keep_in_registers(d);
        __syncthreads();
        if (tid == 0 && q + p.stages - 1 < total) {
          const int qn = q + p.stages - 1, sn = st == 0 ? p.stages - 1 : st - 1;
          mbar_expect_tx(full0 + 8 * sn, ring_stage);
          bulk_copy(smem_s + lay.off_ring + sn * ring_stage,
                    p.wt + static_cast<size_t>(qn) * ring_stage, ring_stage, full0 + 8 * sn);
        }
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
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int row = 64 * wg + 16 * (warp & 3) + 8 * (k & 1) + gid;
        const int col = (k >> 1) * 8 + tig * 2, o = nh * T2_BN + col;
        char2 v = make_char2(0, 0);
        if (o < p.cout) {
          v.x = requant_relu(scale_bias(d[2 * k], sv[o], sv[cpad + o]), inv_so);
          v.y = requant_relu(scale_bias(d[2 * k + 1], sv[o + 1], sv[cpad + o + 1]), inv_so);
        }
        *reinterpret_cast<char2*>(zs + row * T2_LDZ + col) = v;
      }
      clear(d);
      __syncthreads();

      if constexpr (JT == 0) {
        // deconv1: z1 leaves interleaved, 16 bytes a store, a pixel's 128
        // channels one 128-byte line
        int8_t* z1 = static_cast<int8_t*>(p.out);
        for (int e = tid; e < T2_TH * T2_TW * (T2_BN / 16); e += T2_THREADS) {
          const int row = e >> 3, ch = e & 7;
          const int y = y0 + row / T2_TW, x = x0 + row % T2_TW, o = nh * T2_BN + ch * 16;
          if (y >= p.h || x >= p.w || o >= p.cout) continue;
          int8_t* dst = z1 + ((static_cast<size_t>(img) * 2 * p.h + 2 * y + a) * 2 * p.w +
                              2 * x + b) * p.cout + o;
          const int8_t* src = zs + row * T2_LDZ + ch * 16;
          if (p.cout % 16 == 0) {
            *reinterpret_cast<int4*>(dst) = *reinterpret_cast<const int4*>(src);
          } else {
            for (int u = 0; u < min(16, p.cout - o); ++u) dst[u] = src[u];
          }
        }
      } else {
        // deconv2: the head's sums over this half's 128 channels, warp w
        // taking pixels 16 w .. 16 w + 15 and all JT * 8 joints, fragments by
        // ldmatrix: A (pixels 0-7 | 8-15) x (k 0-15 | 16-31), B (k 0-15 |
        // 16-31) x (joints j | j + 8)
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
      }
    }

    if constexpr (JT > 0) {
      // ---- the head's epilogue -> f32 [J, N, 4 h w] in the levels = 2
      // order: pixel (y, x) of deconv2's phase g is packed position
      // (4 g + 2 (y & 1) + (x & 1)) * (h/2 * w/2) + (y >> 1) * w/2 + (x >> 1)
      float* hm = static_cast<float*>(p.out);
      const int bh = p.h / 2, bw = p.w / 2, plane = 4 * p.h * p.w;
      const float* vs = sv + 2 * cpad;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = warp * 16 + hh * 8 + gid;
        const int y = y0 + row / T2_TW, x = x0 + row % T2_TW;
        if (y >= p.h || x >= p.w) continue;
        const size_t pk = static_cast<size_t>(4 * g + 2 * (y & 1) + (x & 1)) * bh * bw +
                          (y >> 1) * bw + (x >> 1);
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
      clear(hacc);
    }
  }
}

struct Tail2Kernel {
  void (*fn)(Tail2Args, Tail2Layout);
  int configured;  // dynamic shared memory the kernel has been allowed so far
};

// [JT / 2]: deconv1 (JT = 0), deconv2 + head at J <= 16 and <= 32
static Tail2Kernel tail2_kernels[3] = {{tail2_kernel<0>, 0}, {tail2_kernel<2>, 0},
                                       {tail2_kernel<4>, 0}};

static cudaError_t configure(Tail2Kernel& k, int smem) {
  if (smem <= k.configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) k.configured = smem;
  return e;
}

}  // namespace posetpu

using namespace posetpu;

// One launch of B1's kernel. ``jt`` 0 runs deconv1 into int8 z1; 2 or 4
// runs deconv2 and the head (J <= 8 jt). The ring's shape and the
// shared-memory layout come planned from ops/phase_tail.py (plan_tail2).
extern "C" int tail2(const void* x, const void* wt, const void* sc, const void* so,
                     const void* wh, const void* vh, void* out, int n, int h, int w, int cin,
                     int cout, int joints, int jt, int stages, int off_ring, int off_z,
                     int off_wh, int off_sc, int off_bar, int smem, void* stream) {
  if (jt != 0 && jt != 2 && jt != 4) return static_cast<int>(cudaErrorInvalidValue);
  Tail2Kernel& k = tail2_kernels[jt / 2];
  cudaError_t e = configure(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int tiles_x = (w + T2_TW - 1) / T2_TW, tiles_y = (h + T2_TH - 1) / T2_TH;
  const Tail2Args p{static_cast<const int8_t*>(x), static_cast<const int8_t*>(wt),
                    static_cast<const float*>(sc), static_cast<const float*>(so),
                    static_cast<const int8_t*>(wh), static_cast<const float*>(vh), out,
                    n, h, w, cin, cout, joints, tiles_x, stages};
  const Tail2Layout lay{off_ring, off_z, off_wh, off_sc, off_bar};
  dim3 grid(tiles_x * tiles_y, n);
  k.fn<<<grid, T2_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(p, lay);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of one instance that fit one SM at ``smem`` bytes of dynamic shared
// memory, or minus the CUDA error.
extern "C" int tail2_blocks_per_sm(int jt, int smem) {
  if (jt != 0 && jt != 2 && jt != 4) return -static_cast<int>(cudaErrorInvalidValue);
  Tail2Kernel& k = tail2_kernels[jt / 2];
  cudaError_t e = configure(k, smem);
  if (e != cudaSuccess) return -static_cast<int>(e);
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k.fn, T2_THREADS, smem);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}
