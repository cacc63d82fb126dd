// Shared int8 tensor-core GEMM main loop for the port's kernels (sm_90a).
//
// One thread block computes a BM x BN tile of C = A . B^T with int8
// operands and exact int32 sums: A rows and B rows are both K-contiguous
// (B is the weight stored [N][K], "K-minor"), which is the operand form of
// mma.sync.m16n8k32.row.col.s32.s8.s8.s32. The caller supplies where each
// thread's A row and B row live for a given k, so the same loop serves a
// gathered operand (shifted image rows with zero padding, or a source view
// picked per k-block) without materialising it: a load whose source is
// outside the operand is a zero-filled cp.async (src-size 0).
//
// mma_resident (below) is the loop for an A operand that already sits in
// shared memory.
//
// Tiles: 128 x 128 x 32, 256 threads = 8 warps as 4 (m) x 2 (n), each warp
// 32 x 64 = 2 x 8 mma tiles. Two shared-memory stages, cp.async double
// buffering. Shared rows are 48 bytes (32 + 16 pad) so the fragment loads
// of a warp hit 32 distinct banks.
//
// What bounds these loops on the H100: not the tensor cores (mma.sync
// m16n8k32 s8 reaches 1,270 of the card's 1,979 TOP/s, tools/imma_rate.cu)
// and not memory bandwidth, but the step: 32 bytes of K behind a
// cp.async.wait_group and two __syncthreads is an exposed L2 round trip,
// and 24 four-byte ld.shared feed 16 mma. The kernel still built on them
// (B8b) sits 22x above its bound for that reason. B8a (resblock.cu) left
// these loops for a three-stage ring 64 bytes deep that runs across tiles,
// ldmatrix fragments and bulk-copied weight stages, B1, B2, B5, B6, B9a and
// B9b (tail2.cu) and B3 and B4 (aggregation.cu) for wgmma fed from rings of
// bulk copies, and PERF.md has what each step bought; the same is queued for
// B8b.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace posetpu {

constexpr int BM = 128, BN = 128, BK = 32, THREADS = 256;
constexpr int LDS = BK + 16;  // bytes per shared row

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int src_size = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_size) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j][r]: m-tile i (16 rows), n-tile j (8 cols), register r of the
// m16n8 accumulator fragment. Element (i, j, r) sits at tile row
// warp_m*32 + i*16 + (lane>>2) + (r>=2 ? 8 : 0) and tile column
// warp_n*64 + j*8 + (lane&3)*2 + (r&1).
struct Acc {
  int v[2][8][4];
};

// Sign-extend the four 4-bit values held in the low nibbles of a word's
// bytes to four int8: per byte (x ^ 8) - 8, written as x | 0xF0 where bit 3
// is set (the same value; no borrow crosses a byte). B4 (aggregation.cu)
// widens its nibble-packed bank with it.
__device__ __forceinline__ unsigned sext_nibbles(unsigned x) {
  return x | ((x & 0x08080808u) * 0x1Eu);
}

// ALoad / BLoad: per-thread functors; operator()(k, valid) returns the
// address of 16 bytes at depth k (a multiple of 16) of this thread's row,
// setting valid=false (and returning any mapped address) for a zero row.
// Each thread loads row tid>>1, 16-byte half tid&1, of both tiles.
template <class ALoad, class BLoad>
__device__ __forceinline__ void mma_mainloop(const ALoad& la, const BLoad& lb,
                                             int k_steps, Acc& acc) {
  __shared__ __align__(16) int8_t sA[2][BM * LDS];
  __shared__ __align__(16) int8_t sB[2][BN * LDS];

  const int tid = threadIdx.x;
  const int lrow = tid >> 1;          // this thread's A row (and int8 B row) in the tile
  const int lcol = (tid & 1) * 16;    // its 16-byte half of the 32-byte k-step
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc.v[i][j][r] = 0;

  auto load = [&](int stage, int ks) {
    bool va, vb;
    const void* pa = la(ks * BK + lcol, va);
    cp_async16(&sA[stage][lrow * LDS + lcol], pa, va);
    const void* pb = lb(ks * BK + lcol, vb);
    cp_async16(&sB[stage][lrow * LDS + lcol], pb, vb);
  };

  load(0, 0);
  cp_async_commit();
  for (int ks = 0; ks < k_steps; ++ks) {
    if (ks + 1 < k_steps) load((ks + 1) & 1, ks + 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait1();   // stage ks has landed
    __syncthreads();
    const int8_t* a = sA[ks & 1];
    const int8_t* b = sB[ks & 1];
    unsigned af[2][4], bf[8][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wm * 32 + i * 16 + gid;
      af[i][0] = *reinterpret_cast<const unsigned*>(a + r * LDS + tig * 4);
      af[i][1] = *reinterpret_cast<const unsigned*>(a + (r + 8) * LDS + tig * 4);
      af[i][2] = *reinterpret_cast<const unsigned*>(a + r * LDS + 16 + tig * 4);
      af[i][3] = *reinterpret_cast<const unsigned*>(a + (r + 8) * LDS + 16 + tig * 4);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = wn * 64 + j * 8 + gid;
      bf[j][0] = *reinterpret_cast<const unsigned*>(b + n * LDS + tig * 4);
      bf[j][1] = *reinterpret_cast<const unsigned*>(b + n * LDS + 16 + tig * 4);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_s8(acc.v[i][j], af[i], bf[j]);
    __syncthreads();  // the next iteration's load overwrites this stage
  }
}

// Walk this thread's accumulator elements as (tile row, tile col pair):
// f(row, col, v0, v1) with v0/v1 the sums at columns col and col+1.
template <class F>
__device__ __forceinline__ void for_each_pair(const Acc& acc, F&& f) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 3, wn = warp >> 2;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = wm * 32 + i * 16 + gid;
      const int col = wn * 64 + j * 8 + tig * 2;
      f(row, col, acc.v[i][j][0], acc.v[i][j][1]);
      f(row + 8, col, acc.v[i][j][2], acc.v[i][j][3]);
    }
}

// f32 epilogue steps, each rounded on its own (no FMA contraction), as the
// JAX reference rounds them.
__device__ __forceinline__ float scale_bias(int acc, float s, float b) {
  return __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
}

// requant(+ReLU) to int8: clip(round_half_even(max(z, 0) * inv_so), -127, 127)
__device__ __forceinline__ signed char requant_relu(float z, float inv_so) {
  float q = rintf(__fmul_rn(fmaxf(z, 0.0f), inv_so));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

// The folded requant of the bottleneck and subpixel-deconv kernels, whose
// scale and bias arrive pre-divided by the output scale:
// clip(round_half_even(acc * s + b), lo, 127), multiply and add rounded
// separately. ReLU is lo = 0.
__device__ __forceinline__ signed char requant_folded(int acc, float s, float b, float lo) {
  float q = rintf(scale_bias(acc, s, b));
  q = fminf(fmaxf(q, lo), 127.0f);
  return static_cast<signed char>(static_cast<int>(q));
}

// ---------------------------------------------------------------------------
// mma_resident: the same 128 x 128 x 32 tile product with the A operand
// already in shared memory (an activation tile an earlier stage of the same
// kernel left there), so only B streams through the cp.async double buffer.
//
// ARows says where a tile row lives: ``row(r)`` is called once per thread and
// row, ``ptr(row, ks, ok)`` gives the 32 bytes of k-step ks (ok=false: read
// zeros), so a 3x3 conv can gather shifted rows tap by tap. Rows from m_lim
// and columns from n_lim on are not computed: a warp whose rows or columns
// all lie beyond them runs no mma. The caller zeroes ``acc`` (a K loop cut
// into chunks accumulates across calls) and picks the warp arrangement with
// warp_tile(), so that the warps left with work sit on all four of the
// SM's tensor cores (a warp's core is its index mod 4). ``sB`` is the
// caller's staging buffer, RESIDENT_SB bytes of shared memory, 16-aligned.

constexpr int RESIDENT_STAGE = BN * LDS;
constexpr int RESIDENT_SB = 2 * RESIDENT_STAGE;

struct WarpTile {
  int wm, wn;  // this warp's 32-row and 64-column slot of the tile
};

// Warps as 4 (m) x 2 (n). ``narrow`` (n_lim <= 64): column slot 0 is warps
// 0-3; otherwise row slots 0 and 1 (m_lim <= 64) are warps 0-3.
__device__ __forceinline__ WarpTile warp_tile(bool narrow) {
  const int warp = threadIdx.x >> 5;
  return narrow ? WarpTile{warp & 3, warp >> 2} : WarpTile{warp >> 1, warp & 1};
}

__device__ __forceinline__ void acc_zero(Acc& acc) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc.v[i][j][r] = 0;
}

template <class ARows, class BLoad>
__device__ __forceinline__ void mma_resident(const ARows& ar, const BLoad& lb,
                                             int k_steps, int m_lim, int n_lim,
                                             WarpTile wt, int8_t* sB, Acc& acc) {

  const int tid = threadIdx.x;
  const int lrow = tid >> 1, lcol = (tid & 1) * 16;
  const int lane = tid & 31, gid = lane >> 2, tig = lane & 3;
  const bool warp_on = wt.wm * 32 < m_lim && wt.wn * 64 < n_lim;

  typename ARows::Row rows[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) rows[i][hh] = ar.row(wt.wm * 32 + i * 16 + hh * 8 + gid);

  auto load = [&](int stage, int ks) {
    bool vb;
    const void* pb = lb(ks * BK + lcol, vb);
    cp_async16(sB + stage * RESIDENT_STAGE + lrow * LDS + lcol, pb, vb);
  };

  load(0, 0);
  cp_async_commit();
  for (int ks = 0; ks < k_steps; ++ks) {
    if (ks + 1 < k_steps) load((ks + 1) & 1, ks + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    if (warp_on) {
      const int8_t* b = sB + (ks & 1) * RESIDENT_STAGE;
      unsigned af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          bool ok;
          const int8_t* pa = ar.ptr(rows[i][hh], ks, ok);
          af[i][hh] = ok ? *reinterpret_cast<const unsigned*>(pa + tig * 4) : 0u;
          af[i][2 + hh] = ok ? *reinterpret_cast<const unsigned*>(pa + 16 + tig * 4) : 0u;
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (wt.wn * 64 + j * 8 < n_lim) {
          const int n = wt.wn * 64 + j * 8 + gid;
          unsigned bf[2];
          bf[0] = *reinterpret_cast<const unsigned*>(b + n * LDS + tig * 4);
          bf[1] = *reinterpret_cast<const unsigned*>(b + n * LDS + 16 + tig * 4);
#pragma unroll
          for (int i = 0; i < 2; ++i) mma_s8(acc.v[i][j], af[i], bf);
        }
      }
    }
    __syncthreads();
  }
}

// for_each_pair for a tile computed under the warp arrangement ``wt``;
// ``idx`` numbers this thread's 32 pairs in a fixed order.
template <class F>
__device__ __forceinline__ void for_each_pair_at(const Acc& acc, WarpTile wt, F&& f) {
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int row = wt.wm * 32 + i * 16 + gid;
      const int col = wt.wn * 64 + j * 8 + tig * 2;
      f((i * 8 + j) * 2, row, col, acc.v[i][j][0], acc.v[i][j][1]);
      f((i * 8 + j) * 2 + 1, row + 8, col, acc.v[i][j][2], acc.v[i][j][3]);
    }
}

}  // namespace posetpu
