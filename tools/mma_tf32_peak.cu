// The TF32 tensor-core rates of this card: the ceilings of the Nystrom
// landmark kernels (transmil_deepgraft_tpu_torch/csrc/nystrom.cu, mma.sync
// m16n8k8) and of the TransLayer projections (csrc/translayer.cu, wgmma
// m64nNk8 with A from registers), which do every float32 product as three
// TF32 products.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_tf32_peak \
//       tools/mma_tf32_peak.cu && build/mma_tf32_peak
//
// mma.sync: one block an SM of 4 to 32 warps, each issuing 4 or 8
// independent chains of register-only products (2*16*8*8 FLOP each).
// wgmma: one block an SM of 1 or 2 warpgroups, each issuing batches of 12
// m64n256k8 products (2*64*256*8 FLOP each; one K tile of translayer.cu's
// 3xTF32 loop) into one accumulator, B from shared memory in the 128-byte
// swizzle, A from registers or from shared memory, then waiting for the
// batch (as translayer.cu does a K tile) or keeping one batch in flight.
// Prints TFLOP/s for each.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int CHAINS>
__global__ void chains(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  float c[CHAINS][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CHAINS; ++j) mma_tf32(c[j], a, i + j, i);
  }
  float s = 0.f;
  for (int j = 0; j < CHAINS; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 1234.5f) out[0] = s;  // keeps the products
}

#define F8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
              "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define D128 F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56), F8(64), F8(72), \
             F8(80), F8(88), F8(96), F8(104), F8(112), F8(120)
#define R128 "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, " \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, " \
  "%125, %126, %127}"

__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " R128
               ", {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
               : D128
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " R128
               ", %128, %129, p, 1, 1;\n}\n"
               : D128
               : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint64_t desc128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// B is 256 rows x 128 bytes (32 KB), then A 64 x 128 bytes a warpgroup.
template <bool RS, int IN_FLIGHT>
__global__ void wgmma_batches(float* out, int iters) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const int wg = threadIdx.x / 128;
  const uint32_t b = base, a = base + 32768 + wg * 8192;
  const uint32_t areg[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  float d[128] = {};
  for (int i = 0; i < iters; ++i) {
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 12; ++k) {
      if constexpr (RS) wgmma_rs(d, areg, desc128(b + 32 * (k & 3)));
      else wgmma_ss(d, desc128(a + 32 * (k & 3)), desc128(b + 32 * (k & 3)));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(IN_FLIGHT) : "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  float s = 0.f;
  for (int j = 0; j < 128; ++j) s += d[j];
  if (s == 1234.5f) out[0] = s;
}

template <bool RS, int IN_FLIGHT>
float wgmma_tflops(int sms, int wgs, float* out) {
  const int smem = 1024 + 32768 + 2 * 8192, iters = 2000;
  cudaFuncSetAttribute(wgmma_batches<RS, IN_FLIGHT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  wgmma_batches<RS, IN_FLIGHT><<<sms, 128 * wgs, smem>>>(out, 10);  // warm-up
  cudaEventRecord(e0);
  wgmma_batches<RS, IN_FLIGHT><<<sms, 128 * wgs, smem>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  return 2.0 * 64 * 256 * 8 * 12 * (double)iters * wgs * sms / ms / 1e9;
}

template <int CHAINS>
void run(int sms, int warps, int iters, float* out) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  chains<CHAINS><<<sms, 32 * warps>>>(out, 10);  // warm-up
  cudaEventRecord(e0);
  chains<CHAINS><<<sms, 32 * warps>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms = 0.f;
  cudaEventElapsedTime(&ms, e0, e1);
  const double flop = 2.0 * 16 * 8 * 8 * CHAINS * (double)iters * warps * sms;
  printf("mma.sync m16n8k8 TF32, %d chains a warp, %2d warps an SM: %.1f TFLOP/s\n", CHAINS,
         warps, flop / ms / 1e9);
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("%s, %d SMs\n", prop.name, sms);
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float));
  for (int warps : {4, 8, 12, 16, 32}) {
    run<4>(sms, warps, 20000, out);
    run<8>(sms, warps, 20000, out);
  }
  for (int wgs : {1, 2}) {
    printf("wgmma m64n256k8 TF32, A from registers, %d warpgroups an SM: %.1f TFLOP/s (wait "
           "each batch), %.1f (one batch in flight)\n", wgs, wgmma_tflops<true, 0>(sms, wgs, out),
           wgmma_tflops<true, 1>(sms, wgs, out));
    printf("wgmma m64n256k8 TF32, A from shared memory, %d warpgroups an SM: %.1f TFLOP/s (wait "
           "each batch), %.1f (one batch in flight)\n", wgs, wgmma_tflops<false, 0>(sms, wgs, out),
           wgmma_tflops<false, 1>(sms, wgs, out));
  }
  cudaFree(out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
