// The int8 tensor-core rates of this card: the ceilings of the int8
// bottleneck kernels (transmil_deepgraft_tpu_torch/csrc/qstage.cu, wgmma
// m64nNk32 s8) and of the mma.sync design they replaced (m16n8k32 s8).
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_s8_peak \
//       tools/mma_s8_peak.cu && build/mma_s8_peak
//
// mma.sync: one block an SM of 4 to 32 warps, each issuing 4 or 8
// independent chains of register-only m16n8k32 products (2*16*8*32 OP each).
// wgmma: one block an SM of 1 to 3 warpgroups, each issuing batches of 8
// m64n128k32 products (2*64*128*32 OP each) into one accumulator, both
// operands from shared memory in the 128-byte swizzle, then waiting for the
// batch (as qstage.cu does a K tile) or keeping one batch in flight. Prints
// TOP/s for each.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CHAINS>
__global__ void mma_chains(int* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  int c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma_s8(c[j], a, i + j, i);
  }
  int s = 0;
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 12345) out[0] = s;  // keeps the products
}

#define R8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
              "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

__device__ __forceinline__ void wgmma_n128(int (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : R8(0), R8(8), R8(16), R8(24), R8(32), R8(40), R8(48), R8(56)
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

template <int IN_FLIGHT>
__global__ void wgmma_batches(int* out, int iters) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int wg = threadIdx.x / 128;
  const uint32_t a = base + 16384 + wg * 8192, b = base;  // B 128 x 128 bytes, A 64 x 128 a warpgroup
  int d[64] = {};
  for (int i = 0; i < iters; ++i) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 8; ++k) wgmma_n128(d, desc128(a + 32 * (k & 3)), desc128(b + 32 * (k & 3)));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(IN_FLIGHT) : "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  int s = 0;
  for (int j = 0; j < 64; ++j) s += d[j];
  if (s == 12345) out[0] = s;
}

template <class K>
float time_ms(K launch) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  launch(10);  // warm-up
  cudaEventRecord(e0);
  launch(0);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  return ms;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, sms);
  int* out = nullptr;
  cudaMalloc(&out, sizeof(int));
  const int iters = 20000;
  for (int warps : {4, 8, 16, 32}) {
    const float ms4 = time_ms([&](int warm) {
      mma_chains<4><<<sms, 32 * warps>>>(out, warm ? warm : iters);
    });
    const float ms8 = time_ms([&](int warm) {
      mma_chains<8><<<sms, 32 * warps>>>(out, warm ? warm : iters);
    });
    const double op = 2.0 * 16 * 8 * 32 * (double)iters * warps * sms;
    printf("mma.sync m16n8k32 s8, %2d warps an SM: %.1f TOP/s (4 chains), %.1f (8 chains)\n",
           warps, op * 4 / ms4 / 1e9, op * 8 / ms8 / 1e9);
  }
  const int smem = 1024 + 16384 + 3 * 8192;
  cudaFuncSetAttribute(wgmma_batches<0>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncSetAttribute(wgmma_batches<1>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int witers = 4000;
  for (int wgs : {1, 2, 3}) {
    const float ms0 = time_ms([&](int warm) {
      wgmma_batches<0><<<sms, 128 * wgs, smem>>>(out, warm ? warm : witers);
    });
    const float ms1 = time_ms([&](int warm) {
      wgmma_batches<1><<<sms, 128 * wgs, smem>>>(out, warm ? warm : witers);
    });
    const double op = 2.0 * 64 * 128 * 32 * 8 * (double)witers * wgs * sms;
    printf("wgmma m64n128k32 s8, %d warpgroups an SM: %.1f TOP/s (wait each batch), "
           "%.1f (one batch in flight)\n", wgs, op / ms0 / 1e9, op / ms1 / 1e9);
  }
  cudaFree(out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
