// ABFP quantize-dequantize device functions, shared by the kernels that
// QDQ a group on chip (abfp_qdq.cu, quant_matmul.cu).
//
// One group of n values along the contraction dimension shares a scale:
//
//   alpha = max(bf16_round_nearest_even(max |x|), 1e-12)
//   scale = alpha / qmax            (IEEE division: no fast-math, and no
//                                    reciprocal, which is one ulp off)
//   y     = qdq_unit(x / scale) * scale
//
// qdq_unit mirrors repro_torch.core.formats: int formats round half to
// even (rintf) and clamp to [qmin, qmax]; minifloats take the exponent
// from frexpf, clamp it to [min_normal_exp, max_biased_exp - bias], round
// the value to the quantum ldexpf(1, e - man_bits) (a power of two, so the
// division and the product are exact), saturate to +-qmax and keep 0 as 0.
// Every operation is correctly rounded, so the result is bit-exact against
// the plain PyTorch version.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro {

struct QdqFormat {
  int is_int;     // 1: integer grid, 0: saturating minifloat
  float qmax;     // largest magnitude (alpha lands on it)
  float qmin;     // int formats: lowest code
  int man_bits;   // minifloats: mantissa bits
  int min_exp;    // minifloats: exponent of the smallest normal
  int max_exp;    // minifloats: max_biased_exp - bias
};

// Scale of a group from its max |x|: bf16 round-to-nearest-even, floor
// 1e-12, divided by the top code.
__device__ __forceinline__ float group_scale(float amax, float qmax) {
  float alpha = __bfloat162float(__float2bfloat16_rn(amax));
  alpha = fmaxf(alpha, 1e-12f);
  return alpha / qmax;
}

// Quantize-dequantize of one value already divided by its scale.
__device__ __forceinline__ float qdq_unit(float xs, const QdqFormat& f) {
  if (f.is_int) return fminf(fmaxf(rintf(xs), f.qmin), f.qmax);
  const float ax = fabsf(xs);
  int ex;
  frexpf(ax > 0.f ? ax : 1.f, &ex);  // ax = m * 2^ex, m in [0.5, 1)
  int e = ex - 1;
  e = min(max(e, f.min_exp), f.max_exp);
  const float quantum = ldexpf(1.f, e - f.man_bits);
  float q = rintf(xs / quantum) * quantum;
  q = fminf(fmaxf(q, -f.qmax), f.qmax);
  return ax == 0.f ? 0.f : q;
}

__device__ __forceinline__ float qdq_value(float x, float scale,
                                           const QdqFormat& f) {
  return qdq_unit(x / scale, f) * scale;
}

// Integer code of one value (int formats only): round, clamp.
__device__ __forceinline__ float int_code(float x, float scale,
                                          const QdqFormat& f) {
  return fminf(fmaxf(rintf(x / scale), f.qmin), f.qmax);
}

// Max |x| over a warp's lanes.
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kQdqWarps = 8;  // warps per block of qdq_rows_kernel

// QDQ of contiguous groups of n: warp w of the grid owns group w (x and y
// are (n_groups, n) row-major).  Consecutive lanes read consecutive
// addresses; the max is reduced with shuffles.
__global__ void __launch_bounds__(kQdqWarps * 32)
qdq_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                long long n_groups, int n, QdqFormat fmt) {
  const long long wid =
      (long long)blockIdx.x * kQdqWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= n_groups) return;  // uniform per warp
  const float* src = x + wid * n;
  float* dst = y + wid * n;
  float amax = 0.f;
  for (int i = lane; i < n; i += 32) amax = fmaxf(amax, fabsf(src[i]));
  const float s = group_scale(warp_max(amax), fmt.qmax);
  for (int i = lane; i < n; i += 32) dst[i] = qdq_value(src[i], s, fmt);
}

inline void launch_qdq_rows(const float* x, float* y, long long n_groups,
                            int n, const QdqFormat& fmt,
                            cudaStream_t stream) {
  const long long blocks = (n_groups + kQdqWarps - 1) / kQdqWarps;
  qdq_rows_kernel<<<(unsigned)blocks, kQdqWarps * 32, 0, stream>>>(
      x, y, n_groups, n, fmt);
}

}  // namespace repro
