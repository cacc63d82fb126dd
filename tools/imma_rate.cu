// Rate of the two int8 tensor-core instructions of sm_90a, operands in
// registers / shared memory, no global traffic:
//   mma.sync.aligned.m16n8k32.s32.s8.s8   (16 independent accumulators a warp)
//   wgmma.mma_async.m64n128k32.s32.s8.s8  (one accumulator tile a warpgroup)
// Prints TOP/s (2 operations per multiply-accumulate) for 1 and 2 blocks of
// 256 threads per SM. Built and run by tools/torch_kernel_sweep.py imma.
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__global__ void __launch_bounds__(256, 2) mma_sync_rate(int iters, int* sink) {
  int c[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) c[j][r] = 0;
  unsigned a[4] = {threadIdx.x, 1u, 2u, 3u}, b[2] = {threadIdx.x * 3u, 5u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(c[j][0]), "+r"(c[j][1]), "+r"(c[j][2]), "+r"(c[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
  int s = 0;
#pragma unroll
  for (int j = 0; j < 16; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 0x7fffffff) *sink = s;
}

__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  // no swizzle; leading and stride byte offsets of a K-major 8 x 16-byte core matrix layout
  uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | (uint64_t(128 >> 4) << 16) | (uint64_t(256 >> 4) << 32);
}

__global__ void __launch_bounds__(256, 2) wgmma_rate(int iters, int* sink) {
  __shared__ __align__(128) int8_t sa[64 * 32], sb[128 * 32];
  for (int i = threadIdx.x; i < 64 * 32; i += 256) sa[i] = i;
  for (int i = threadIdx.x; i < 128 * 32; i += 256) sb[i] = i * 3;
  __syncthreads();
  int c[64];
#pragma unroll
  for (int r = 0; r < 64; ++r) c[r] = 0;
  const uint64_t da = smem_desc(sa), db = smem_desc(sb);
  for (int it = 0; it < iters; ++it) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int u = 0; u < 4; ++u)
      asm volatile(
          "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
          "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
          "{%0,%1,%2,%3,%4,%5,%6,%7,%8,%9,%10,%11,%12,%13,%14,%15,"
          "%16,%17,%18,%19,%20,%21,%22,%23,%24,%25,%26,%27,%28,%29,%30,%31,"
          "%32,%33,%34,%35,%36,%37,%38,%39,%40,%41,%42,%43,%44,%45,%46,%47,"
          "%48,%49,%50,%51,%52,%53,%54,%55,%56,%57,%58,%59,%60,%61,%62,%63}, "
          "%64, %65, p;\n}\n"
          : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3]), "+r"(c[4]), "+r"(c[5]), "+r"(c[6]),
            "+r"(c[7]), "+r"(c[8]), "+r"(c[9]), "+r"(c[10]), "+r"(c[11]), "+r"(c[12]),
            "+r"(c[13]), "+r"(c[14]), "+r"(c[15]), "+r"(c[16]), "+r"(c[17]), "+r"(c[18]),
            "+r"(c[19]), "+r"(c[20]), "+r"(c[21]), "+r"(c[22]), "+r"(c[23]), "+r"(c[24]),
            "+r"(c[25]), "+r"(c[26]), "+r"(c[27]), "+r"(c[28]), "+r"(c[29]), "+r"(c[30]),
            "+r"(c[31]), "+r"(c[32]), "+r"(c[33]), "+r"(c[34]), "+r"(c[35]), "+r"(c[36]),
            "+r"(c[37]), "+r"(c[38]), "+r"(c[39]), "+r"(c[40]), "+r"(c[41]), "+r"(c[42]),
            "+r"(c[43]), "+r"(c[44]), "+r"(c[45]), "+r"(c[46]), "+r"(c[47]), "+r"(c[48]),
            "+r"(c[49]), "+r"(c[50]), "+r"(c[51]), "+r"(c[52]), "+r"(c[53]), "+r"(c[54]),
            "+r"(c[55]), "+r"(c[56]), "+r"(c[57]), "+r"(c[58]), "+r"(c[59]), "+r"(c[60]),
            "+r"(c[61]), "+r"(c[62]), "+r"(c[63])
          : "l"(da), "l"(db));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  int s = 0;
#pragma unroll
  for (int r = 0; r < 64; ++r) s += c[r];
  if (s == 0x7fffffff) *sink = s;
}

template <class K>
static void time_it(const char* name, K kernel, double macs_per_thread_block_iter) {
  int* sink;
  cudaMalloc(&sink, 4);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int iters = 4096;
  for (int per_sm = 1; per_sm <= 2; ++per_sm) {
    const int blocks = prop.multiProcessorCount * per_sm;
    kernel<<<blocks, 256>>>(64, sink);
    cudaEvent_t a, b;
    cudaEventCreate(&a);
    cudaEventCreate(&b);
    cudaEventRecord(a);
    kernel<<<blocks, 256>>>(iters, sink);
    cudaEventRecord(b);
    cudaEventSynchronize(b);
    float ms = 0;
    cudaEventElapsedTime(&ms, a, b);
    const double ops = 2.0 * macs_per_thread_block_iter * iters * blocks;
    printf("%s, %d block(s) of 256 threads per SM: %.3f ms, %.1f TOP/s (%s)\n", name, per_sm,
           ms, ops / ms / 1e9, cudaGetErrorString(cudaGetLastError()));
  }
}

int main() {
  // per block and iteration: 8 warps x 16 mma of 16*8*32; 2 warpgroups x 4 wgmma of 64*128*32
  time_it("mma.sync.m16n8k32.s8", mma_sync_rate, 8.0 * 16 * 16 * 8 * 32);
  time_it("wgmma.m64n128k32.s8", wgmma_rate, 2.0 * 4 * 64 * 128 * 32);
  return 0;
}
