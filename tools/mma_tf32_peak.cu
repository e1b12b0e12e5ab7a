// The rate of mma.sync.m16n8k8 TF32 on this card: the ceiling of the Nystrom
// landmark kernels (transmil_deepgraft_tpu_torch/csrc/nystrom.cu), which do
// every float32 product as three such TF32 products.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_tf32_peak \
//       tools/mma_tf32_peak.cu && build/mma_tf32_peak
//
// One block an SM of 4 to 32 warps, each issuing 4 or 8 independent chains
// of register-only mma.sync; prints TFLOP/s (2*16*8*8 a product) for each.

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
  cudaFree(out);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) {
    printf("CUDA error: %s\n", cudaGetErrorString(err));
    return 1;
  }
  return 0;
}
