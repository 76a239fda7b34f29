// Throughput ceilings of the two instruction streams of mma_contract_kernel
// (src/repro_torch/kernels/csrc/quant_matmul.cu) on one card, each alone:
//   imma  mma.sync m16n8k32 s8 x s8 -> s32, 16 independent accumulators
//         a warp, one block of W warps on every SM;
//   fold  acc += ((float)p * s) * w on 32 independent int sums a thread
//         (its per-group rescale), for int8 codes.
// Prints one line per measurement.  Build: nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -o int8_mma_rate int8_mma_rate.cu
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

__global__ void imma(int* out, int iters) {
  uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  uint32_t b[2] = {5u, threadIdx.x};
  int d[16][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j)
      asm volatile(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
          "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+r"(d[j][0]), "+r"(d[j][1]), "+r"(d[j][2]), "+r"(d[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  }
  int s = 0;
  for (int j = 0; j < 16; ++j) s += d[j][0] + d[j][1] + d[j][2] + d[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void fold(float* out, int iters) {
  int p[32];
  float acc[32];
  const float s = threadIdx.x * 1e-3f, w = 0.5f;
  for (int j = 0; j < 32; ++j) {
    p[j] = threadIdx.x + j;
    acc[j] = 0.f;
  }
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      acc[j] += ((float)p[j] * s) * w;
      p[j] += 3;
    }
  }
  float t = 0.f;
  for (int j = 0; j < 32; ++j) t += acc[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = t;
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  int* io;
  float* fo;
  cudaMalloc(&io, sms * 512 * sizeof(int));
  cudaMalloc(&fo, sms * 512 * sizeof(float));
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  const int iters = 4096;
  for (int warps : {4, 8, 16}) {
    imma<<<sms, warps * 32>>>(io, 16);  // warm
    cudaEventRecord(e0);
    imma<<<sms, warps * 32>>>(io, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    const double ops = 2.0 * 16 * 8 * 32 * 16.0 * iters * warps * sms;
    printf("imma m16n8k32 warps/SM=%d ms=%.4f TOPS=%.1f\n", warps, ms,
           ops / ms / 1e9);
  }
  for (int warps : {8, 16}) {
    fold<<<sms, warps * 32>>>(fo, 16);
    cudaEventRecord(e0);
    fold<<<sms, warps * 32>>>(fo, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, e0, e1);
    const double folds = 32.0 * iters * warps * 32 * sms;
    printf("fold warps/SM=%d ms=%.4f Gfolds/s=%.1f\n", warps, ms,
           folds / ms / 1e6);
  }
  const cudaError_t err = cudaGetLastError();
  printf("cuda: %s\n", cudaGetErrorString(err));
  return err == cudaSuccess ? 0 : 1;
}
