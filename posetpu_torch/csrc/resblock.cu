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
// block here takes ``th`` output rows of ``imgs`` images (B8a: imgs = 1):
//   1. conv1 on th + 2 rows (the halo rows are recomputed by the neighbour
//      blocks; rows outside the image are written as zeros, which is conv2's
//      zero padding) straight from x in device memory -> h1 in shared memory;
//   2. conv2 from h1 -> h2 in shared memory. B8a gathers each tap's shifted
//      rows out of h1 as it loads its A fragments (the dx mask of the TPU
//      kernel is the image-border predicate here). B8b first copies a
//      [128, kch] chunk of the im2col matrix into shared memory and multiplies
//      from that; kch is all of 9*Cm where it fits and a divisor of it where
//      it does not (Cm = 512: 128 rows x 4608 bytes would be 590 KB);
//   3. conv3 from h2, the residual (x read once more, or the projection of x
//      through the same main loop, kept as int8 in registers), ReLU and
//      requant -> out.
// h1 and h2 never reach device memory. The weights stream from L2 through the
// cp.async double buffer of int8_mma.cuh, 32 deep per step; all products are
// mma.sync.m16n8k32 with exact int32 sums, so B8b's output equals B8a's.
//
// Bound on the H100 (1,979 TOP/s int8 dense, 3.35 TB/s) at 128 images of
// 256^2 input: a layer1 identity block is 7.0e4 MAC per pixel over 4096
// pixels = 3.7e10 MAC, 0.037 ms, against 268 MB of x and out, 0.080 ms: bound
// by bytes; layer2 (2.8e5 MAC x 1024 pixels, 134 MB) 0.040 ms by bytes;
// layer3 (1.1e6 x 256) 0.037 ms and layer4 (4.5e6 x 64) 0.037 ms by
// operations. The design answers the byte bound by reading x and writing out
// once with nothing in between; it is not at either bound: mma.sync rather
// than wgmma/TMA, 128-row tiles that a 64-pixel layer4 image half fills, one
// or two blocks per SM, and conv1 recomputed on the halo rows.
//
// Exactness: each epilogue is clip(round(acc * s + b)) with the multiply and
// the add rounded separately (__fmul_rn/__fadd_rn, --fmad=false), rintf
// rounds half to even like jnp.round; the output is
// clip(round((acc3*v3s + v3b) + (r*vrs + vrb)), 0, 127), each step rounded.

#include "gather.cuh"

namespace posetpu {

struct BottleneckArgs {
  const int8_t* x;    // [N, H, W, Cin]
  const int8_t* w1;   // [Cm, Cin]      K-minor
  const int8_t* w2;   // [Cm, 9 * Cm]   K-minor, tap-major depth
  const int8_t* w3;   // [Cout, Cm]
  const int8_t* wd;   // [Cout, Cin] projection, or null: identity residual
  const float* v1;    // [2, Cm]: scale, bias
  const float* v2;    // [2, Cm]
  const float* v3;    // [2, Cout]
  const float* vd;    // [2, Cout], projection only
  const float* vr;    // [2, Cout]: the residual's dequant scale, bias
  int8_t* out;        // [N, H, W, Cout]
  int n, h, w, cin, cm, cout;
  int th, imgs, kch;  // rows and images per block; im2col depth per chunk
};

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
  __device__ const int8_t* ptr(Row rw, int ks, bool& ok) const { return at(rw, ks * BK, ok); }
};

template <bool IM2COL>
__global__ void __launch_bounds__(THREADS) bottleneck_kernel(BottleneckArgs p) {
  extern __shared__ __align__(16) int8_t smem[];
  __shared__ __align__(16) int8_t sB[RESIDENT_SB];
  const BlockTile t{p.w, p.h, p.n, p.th, p.imgs,
                    static_cast<int>(blockIdx.x) * p.th,
                    static_cast<int>(blockIdx.y) * p.imgs};
  const int ld = p.cm + 16;  // padded row: a warp's fragment loads hit 32 banks
  const int m_halo = t.m_halo(), m_out = t.m_out();
  int8_t* h1 = smem;               // [m_halo][ld]
  int8_t* h2 = h1 + m_halo * ld;   // [m_out][ld]
  int8_t* im = h2 + m_out * ld;    // IM2COL: [BM][kch + 16]
  const int lrow = threadIdx.x >> 1;
  const WarpTile wt_fixed = warp_tile(true);  // mma_mainloop's own arrangement
  Acc acc;

  // 1. conv1 over the halo tile -> h1
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

  // 2. conv2 (3x3) from h1 -> h2
  for (int m0 = 0; m0 < m_out; m0 += BM)
    for (int n0 = 0; n0 < p.cm; n0 += BN) {
      const int n_lim = min(BN, p.cm - n0);
      const WarpTile wt = warp_tile(n_lim <= 64);
      const Conv3x3Rows gather{h1, t, ld, p.cm, m0};
      acc_zero(acc);
      if constexpr (!IM2COL) {
        const KMinorBRow lb{p.w2, n0 + lrow, p.cm, 9 * p.cm, 0};
        mma_resident(gather, lb, 9 * p.cm / BK, m_out - m0, n_lim, wt, sB, acc);
      } else {
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

  // 3. conv3 from h2 + residual -> out
  const bool has_ds = p.wd != nullptr;
  for (int m0 = 0; m0 < m_out; m0 += BM)
    for (int n0 = 0; n0 < p.cout; n0 += BN) {
      const int n_lim = min(BN, p.cout - n0);
      // the projection's sums come in mma_mainloop's arrangement; conv3
      // takes the same, so each thread holds both sums of its elements
      const WarpTile wt = has_ds ? wt_fixed : warp_tile(n_lim <= 64);
      short rd[32];  // the projection residual, int8 pairs
      if (has_ds) {
        int img, r, c, hp;
        const bool ok = t.out(m0 + lrow, img, r, c, hp);
        const PixelARow la{
            p.x + (ok ? ((static_cast<size_t>(img) * p.h + r) * p.w + c) * p.cin : 0), ok};
        const KMinorBRow lb{p.wd, n0 + lrow, p.cout, p.cin, 0};
        mma_mainloop(la, lb, p.cin / BK, acc);
        for_each_pair_at(acc, wt_fixed, [&](int idx, int, int col, int v0, int v1) {
          const int o = n0 + col;
          char2 q = make_char2(0, 0);
          if (o < p.cout) {  // requantised to int8 with no ReLU
            q.x = requant_folded(v0, p.vd[o], p.vd[p.cout + o], -127.0f);
            q.y = requant_folded(v1, p.vd[o + 1], p.vd[p.cout + o + 1], -127.0f);
          }
          rd[idx] = static_cast<short>((static_cast<unsigned char>(q.y) << 8) |
                                       static_cast<unsigned char>(q.x));
        });
      }
      const TileRows ar{h2, ld, m0, m_out};
      const KMinorBRow lb{p.w3, n0 + lrow, p.cout, p.cm, 0};
      acc_zero(acc);
      mma_resident(ar, lb, p.cm / BK, m_out - m0, n_lim, wt, sB, acc);
      for_each_pair_at(acc, wt, [&](int idx, int row, int col, int v0, int v1) {
        const int o = n0 + col;
        int img, r, c, hp;
        if (!t.out(m0 + row, img, r, c, hp) || o >= p.cout) return;
        const size_t pix = (static_cast<size_t>(img) * p.h + r) * p.w + c;
        char2 res;
        if (has_ds) {
          res.x = static_cast<signed char>(rd[idx] & 0xff);
          res.y = static_cast<signed char>((rd[idx] >> 8) & 0xff);
        } else {
          res = *reinterpret_cast<const char2*>(p.x + pix * p.cin + o);
        }
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

template <bool IM2COL>
int launch_bottleneck(const BottleneckArgs& p, cudaStream_t stream) {
  const int ld = p.cm + 16;
  const size_t smem = static_cast<size_t>(p.imgs) * (p.th + 2) * p.w * ld +
                      static_cast<size_t>(p.imgs) * p.th * p.w * ld +
                      (IM2COL ? static_cast<size_t>(BM) * (p.kch + 16) : 0);
  cudaError_t e = cudaFuncSetAttribute(bottleneck_kernel<IM2COL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  dim3 grid((p.h + p.th - 1) / p.th, (p.n + p.imgs - 1) / p.imgs);
  bottleneck_kernel<IM2COL><<<grid, THREADS, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace posetpu

using namespace posetpu;

// Static shared memory the kernels use beside their dynamic tile (the two
// main loops' staging buffers): the wrapper sizes its tiles against the rest.
extern "C" int bottleneck_static_smem() {
  cudaFuncAttributes a;
  if (cudaFuncGetAttributes(&a, bottleneck_kernel<true>) != cudaSuccess) return -1;
  return static_cast<int>(a.sharedSizeBytes);
}

extern "C" int bottleneck(const void* x, const void* w1, const void* w2,
                          const void* w3, const void* wd, const void* v1,
                          const void* v2, const void* v3, const void* vd,
                          const void* vr, void* out, int n, int h, int w,
                          int cin, int cm, int cout, int th, int imgs, int kch,
                          int im2col, void* stream) {
  const BottleneckArgs p{
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w1),
      static_cast<const int8_t*>(w2), static_cast<const int8_t*>(w3),
      static_cast<const int8_t*>(wd), static_cast<const float*>(v1),
      static_cast<const float*>(v2), static_cast<const float*>(v3),
      static_cast<const float*>(vd), static_cast<const float*>(vr),
      static_cast<int8_t*>(out), n, h, w, cin, cm, cout, th, imgs, kch};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return im2col ? launch_bottleneck<true>(p, s) : launch_bottleneck<false>(p, s);
}
