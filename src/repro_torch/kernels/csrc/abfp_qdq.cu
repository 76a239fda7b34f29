// Fused ABFP quantize-dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/abfp_qdq.py::abfp_qdq (body
// _kernel, helper _qdq_tile): per group of n along the last dim of x (M, K)
// f32, max |x| -> bf16 scale -> quantize -> dequantize, one read and one
// write of x.
//
// What bounds it on this card: bytes.  It reads 4 bytes and writes 4 bytes
// per element and does a handful of operations on each, far below the
// card's operations-per-byte balance.
//
// Design.  One warp owns one (row, group): its lanes read the group with
// consecutive lanes on consecutive addresses (a warp reads 128 bytes per
// step), reduce the max with shuffles, and QDQ in registers
// (qdq_rows_kernel in abfp_qdq.cuh, whose device functions quant_matmul.cu's
// abfp_matmul applies to both of its operands).  Groups are independent, so
// nothing crosses blocks; the TPU kernel's (BM, BK) tiling has no
// counterpart.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no fast-math: divisions and rintf pin bits).

#include <cuda_runtime.h>

#include "abfp_qdq.cuh"

// x, y: (M, K) f32 contiguous, K a multiple of n.  Returns cudaGetLastError().
extern "C" int repro_abfp_qdq(const void* x, void* y, long long M, int K,
                              int n, int is_int, float qmax, float qmin,
                              int man_bits, int min_exp, int max_exp,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const repro::QdqFormat fmt{is_int, qmax, qmin, man_bits, min_exp, max_exp};
  repro::launch_qdq_rows(static_cast<const float*>(x), static_cast<float*>(y),
                         M * (long long)(K / n), n, fmt, stream);
  return (int)cudaGetLastError();
}
