// Fused ABFP quantize-dequantize for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/abfp_qdq.py::abfp_qdq (body
// _kernel, helper _qdq_tile): per group of n along the last dim of x (M, K)
// in f32, bf16 or f16, max |x| -> bf16 scale -> quantize -> dequantize in
// f32, written back in x's dtype; one read and one write of x.
//
// What bounds it on this card: bytes.  It reads and writes each element
// once (8 bytes an element in f32, 4 in bf16 / f16) and does a few dozen
// operations on each, far below the card's operations-per-byte balance.
// So the design is about keeping enough bytes in flight to cover DRAM
// latency: at 3.35 TB/s and about 0.8 us that is about 20 KB an SM.
//
// Design (qdq_stream_kernel in abfp_qdq.cuh, which abfp_matmul's x pre-pass
// in quant_matmul.cu launches too).  A group sits in the registers of a
// power-of-two set of lanes, as wide as its loads allow (16 lanes of one
// 16-byte load each for f32 at n = 64, 8 for bf16), read with 16-byte
// vector loads that do not allocate in L1 (one element a load where the
// group or a base pointer is off the 16-byte grid); its max is reduced
// with shuffles inside the set, its QDQ done in registers and written with
// evict-first stores: x is read once.  Few elements a thread keep each
// thread's chain of divisions short; 16 blocks of 128 threads an SM, each
// thread with its next group's load in flight while it QDQs the current
// one, keep 32 KB in flight an SM.  The grid is at most that many resident
// blocks with a grid-stride loop, and smaller blocks for a small call, so
// its groups still spread over the SMs.  Minifloats take exponent and
// quantum from the bits and multiply by the quantum's power-of-two
// reciprocal (bit for bit the frexpf / ldexpf / division form, for every
// format whose quanta are normal); x / scale stays a correctly rounded
// division.  A group larger than a set's registers (more than 8 loads a
// lane) takes qdq_rows_kernel, one warp a group reading x twice.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no fast-math: divisions and rintf pin bits).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "abfp_qdq.cuh"

// x, y: n_groups contiguous groups of n elements of dtype 0 (f32), 1
// (bf16) or 2 (f16); plan: a repro::QdqPlan.  Returns a CUDA error.
extern "C" int repro_abfp_qdq(const void* x, void* y, long long n_groups,
                              int n, int dtype, const void* plan,
                              int is_int, float qmax, float qmin,
                              int man_bits, int min_exp, int max_exp,
                              void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const repro::QdqFormat fmt{is_int, qmax, qmin, man_bits, min_exp, max_exp};
  const repro::QdqPlan& p = *static_cast<const repro::QdqPlan*>(plan);
  int err = (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0:
      err = repro::launch_qdq(static_cast<const float*>(x),
                              static_cast<float*>(y), n_groups, n, fmt, p,
                              stream);
      break;
    case 1:
      err = repro::launch_qdq(static_cast<const __nv_bfloat16*>(x),
                              static_cast<__nv_bfloat16*>(y), n_groups, n,
                              fmt, p, stream);
      break;
    case 2:
      err = repro::launch_qdq(static_cast<const __half*>(x),
                              static_cast<__half*>(y), n_groups, n, fmt, p,
                              stream);
      break;
  }
  return err != (int)cudaSuccess ? err : (int)cudaGetLastError();
}
