// ABFP quantize-dequantize: the group arithmetic shared by the kernels that
// QDQ a group on chip (abfp_qdq.cu, quant_matmul.cu), and the kernels that
// QDQ a whole tensor of contiguous groups (abfp_qdq's kernel and
// abfp_matmul's x pre-pass).
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
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// qdq_unit of a minifloat, bit for bit, for a format whose quanta
// 2^(e - man_bits), e in [min_exp, max_exp], and their reciprocals are all
// normal f32 (|e - man_bits| <= 126 at both ends; the host checks it, and
// every float format of the registry has quanta in 2^-16 .. 2^14):
//  - the exponent is the biased exponent of |xs| less 127, clamped.  A
//    normal value's is frexpf's ex - 1; a subnormal's reads -127 and clamps
//    to min_exp (>= -126), as frexpf's smaller exponent does; 0 is caught
//    by the last line, as in qdq_unit;
//  - quantum and reciprocal are built from bits, and xs * 2^(man - e) is
//    the same correctly rounded number as xs / 2^(e - man).
__device__ __forceinline__ float qdq_unit_minifloat(float xs,
                                                    const QdqFormat& f) {
  const float ax = fabsf(xs);
  const int e = min(max((int)(__float_as_uint(ax) >> 23) - 127, f.min_exp),
                    f.max_exp);
  const float quantum = __uint_as_float((uint32_t)(e - f.man_bits + 127)
                                        << 23);
  const float inv = __uint_as_float((uint32_t)(f.man_bits - e + 127) << 23);
  float q = rintf(xs * inv) * quantum;
  q = fminf(fmaxf(q, -f.qmax), f.qmax);
  return ax == 0.f ? 0.f : q;
}

// Max |x| over a warp's lanes.
__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ------------------------------------------------------------------------
// QDQ of a tensor: n_groups contiguous groups of n elements of T (float,
// __nv_bfloat16 or __half), computed in f32 and written back as T with
// one round to nearest even, as ``.to(x.dtype)`` does.
//
// qdq_stream_kernel<T, VEC, VPL>: a group is held in registers by a set of
// L = 2^k lanes (k <= 5), each with VPL loads of 16 bytes (VEC: 4 f32 or 8
// bf16 / f16) or of one element (the scalar variant, for a group or a base
// pointer off the 16-byte grid): load j of lane l is load j L + l of the
// group, so the L lanes of a set read L * 16 contiguous bytes each time
// and neighbouring sets neighbouring groups.  The set is as wide as the
// group's loads allow (VPL their odd part, or more past 32 lanes), so that
// a thread's serial chain of divisions is short and the SM has many warps
// to hide it.  The max is reduced by __shfl_xor_sync within the set and x
// is read once.  A lane of up to two loads a group has its next group's
// loads in flight while it QDQs the current one (a register double
// buffer): 32 KB in flight an SM at f32's one load a lane and 16 resident
// blocks, 24 KB at bf16's 12 (a deeper ring measured no faster:
// scripts/abfp_qdq_variants.py).  Loads do not allocate in L1 and stores
// are evict-first: nothing is read twice.  The grid is at most
// stream_blocks_per_sm resident blocks an SM, with a grid-stride loop;
// the host plans it (repro_torch.kernels.abfp_qdq.plan_qdq) so that
// a small call still spreads over the SMs.  mode: kQdqInt (an int grid)
// or kQdqMinifloat (qdq_unit_minifloat).  x / scale stays an IEEE
// division.
//
// qdq_rows_kernel<T>: one warp a group, x read twice (the max, then the
// QDQ), qdq_value's arithmetic, any n: the route for a group a set's
// registers cannot hold and for a minifloat whose quanta are not all
// normal (kQdqGeneric).
// ------------------------------------------------------------------------

enum QdqMode { kQdqInt = 0, kQdqMinifloat = 1, kQdqGeneric = 2 };

constexpr int kQdqWarps = 8;         // warps per block of qdq_rows_kernel
constexpr int kStreamThreads = 128;  // most threads of a stream block
constexpr int kStreamMaxVpl = 8;     // most loads a lane holds of a group

// Groups a lane holds at once: the current one and, up to 2 loads a
// group, the next one in flight (a register double buffer).
__host__ __device__ constexpr int stream_depth(int vpl) {
  return vpl <= 2 ? 2 : 1;
}

// Resident stream blocks an SM (their launch bounds), by the elements a
// lane holds of a group: 2048 threads of at most 32 registers up to 4
// (f32, one load), 1536 of 40 up to 16, else 1024 of 64.
__host__ __device__ constexpr int stream_blocks_per_sm(int elems) {
  return elems <= 4 ? 16 : elems <= 16 ? 12 : 8;
}

// How the host launches a QDQ (planned by plan_qdq, checked by
// qdq_plan_ok before the launch).
struct QdqPlan {
  int rows_kernel;  // 1: qdq_rows_kernel, 0: qdq_stream_kernel
  int vec;          // 16-byte loads (else one element a load)
  int lanes;        // L, lanes a group
  int vpl;          // loads a lane holds of a group
  int mode;         // QdqMode
  int threads;      // threads a block
  int blocks;       // blocks
};

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_stream(const uint32_t* p) {
  uint32_t v;
  asm("ld.global.nc.L1::no_allocate.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ uint32_t ld_stream(const unsigned short* p) {
  unsigned short v;
  asm("ld.global.nc.L1::no_allocate.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}

// Per-lane max of two pairs of 16-bit unsigned values.
__device__ __forceinline__ uint32_t max_u16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("max.u16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

// How a kernel moves elements of T: a load is kWords 32-bit words holding
// kElems elements (two 16-bit elements a word in a 16-byte load, the low
// half first; one element in the low bits otherwise).
template <typename T, bool VEC>
struct QdqIo {
  static constexpr bool kHalfWords = sizeof(T) == 2;
  static constexpr int kWords = VEC ? 4 : 1;
  static constexpr int kPerWord = (VEC && kHalfWords) ? 2 : 1;
  static constexpr int kElems = kWords * kPerWord;
  using Unit = std::conditional_t<
      VEC, uint4, std::conditional_t<kHalfWords, unsigned short, uint32_t>>;
  struct Words {
    uint32_t w[kWords];
  };

  static __device__ __forceinline__ Words load(const T* base, long long i) {
    Words v;
    if constexpr (VEC) {
      const uint4 u = ld_stream(reinterpret_cast<const uint4*>(base) + i);
      v.w[0] = u.x, v.w[1] = u.y, v.w[2] = u.z, v.w[3] = u.w;
    } else {
      v.w[0] = ld_stream(reinterpret_cast<const Unit*>(base) + i);
    }
    return v;
  }
  static __device__ __forceinline__ void store(T* base, long long i,
                                               const Words& v) {
    Unit* p = reinterpret_cast<Unit*>(base) + i;
    if constexpr (VEC)
      __stcs(p, make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]));
    else
      __stcs(p, (Unit)v.w[0]);
  }
  // Element e of a load, as f32 (exact).
  static __device__ __forceinline__ float get(const Words& v, int e) {
    const uint32_t w = v.w[e / kPerWord];
    const bool hi = kPerWord == 2 && (e & 1);
    if constexpr (std::is_same_v<T, float>) {
      return __uint_as_float(w);
    } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return __uint_as_float(hi ? (w & 0xffff0000u) : (w << 16));
    } else {
      return __half2float(
          __ushort_as_half((unsigned short)(hi ? (w >> 16) : w)));
    }
  }
  // The word holding f32 results a (low half) and b (high half; unused
  // when a word holds one element), each rounded to T once.
  static __device__ __forceinline__ uint32_t pack(float a, float b) {
    if constexpr (std::is_same_v<T, float>) {
      return __float_as_uint(a);
    } else if constexpr (kPerWord == 2) {
      if constexpr (std::is_same_v<T, __nv_bfloat16>) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
        return *reinterpret_cast<const uint32_t*>(&p);
      } else {
        const __half2 p = __floats2half2_rn(a, b);
        return *reinterpret_cast<const uint32_t*>(&p);
      }
    } else if constexpr (std::is_same_v<T, __nv_bfloat16>) {
      return __bfloat16_as_ushort(__float2bfloat16_rn(a));
    } else {
      return __half_as_ushort(__float2half_rn(a));
    }
  }
  // Max |x| of a load, folded into m: f32 compares magnitudes as floats;
  // 16-bit types compare the bits with the sign cleared (the same order
  // for every value that is not NaN), two at a time, in ``bits``.
  static __device__ __forceinline__ void fold_max(const Words& v, float& m,
                                                  uint32_t& bits) {
#pragma unroll
    for (int k = 0; k < kWords; ++k) {
      if constexpr (std::is_same_v<T, float>)
        m = fmaxf(m, fabsf(__uint_as_float(v.w[k])));
      else if constexpr (kPerWord == 2)
        bits = max_u16x2(bits, v.w[k] & 0x7fff7fffu);
      else
        bits = max(bits, v.w[k] & 0x7fffu);
    }
  }
  // The magnitude ``fold_max`` gathered, as f32 (exact).
  static __device__ __forceinline__ float amax(float m, uint32_t bits) {
    if constexpr (std::is_same_v<T, float>) {
      return m;
    } else {
      const uint32_t b = max(bits & 0xffffu, bits >> 16);
      if constexpr (std::is_same_v<T, __nv_bfloat16>)
        return __uint_as_float(b << 16);
      else
        return __half2float(__ushort_as_half((unsigned short)b));
    }
  }
};

// QDQ of a load's elements in place, scale s, the format's branch resolved
// at compile time.
template <typename Io, int MODE>
__device__ __forceinline__ void qdq_load(typename Io::Words& v, float s,
                                         const QdqFormat& f) {
  float r[Io::kElems];
#pragma unroll
  for (int e = 0; e < Io::kElems; ++e) {
    const float xs = Io::get(v, e) / s;
    float u;
    if constexpr (MODE == kQdqInt)
      u = fminf(fmaxf(rintf(xs), f.qmin), f.qmax);
    else
      u = qdq_unit_minifloat(xs, f);
    r[e] = u * s;
  }
#pragma unroll
  for (int k = 0; k < Io::kWords; ++k)
    v.w[k] = Io::pack(r[k * Io::kPerWord],
                      r[k * Io::kPerWord + Io::kPerWord - 1]);
}

template <typename T, bool VEC, int VPL>
__global__ void __launch_bounds__(kStreamThreads,
                                  stream_blocks_per_sm(
                                      VPL * QdqIo<T, VEC>::kElems))
qdq_stream_kernel(const T* __restrict__ x, T* __restrict__ y,
                  long long n_groups, int lanes_log2, QdqFormat f,
                  int mode) {
  using Io = QdqIo<T, VEC>;
  using Words = typename Io::Words;
  constexpr int D = stream_depth(VPL);
  const int L = 1 << lanes_log2;
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int lane = (int)(tid & (L - 1));
  const long long sets = ((long long)gridDim.x * blockDim.x) >> lanes_log2;
  const long long per_group = (long long)VPL * L;  // loads a group
  // set s takes groups s, s + sets, ...; the loop runs while the warp's
  // first set has a group (uniform per warp, so every lane takes part in
  // the shuffles)
  long long g = tid >> lanes_log2;
  long long w0 = (tid & ~31LL) >> lanes_log2;
  if (w0 >= n_groups) return;

  auto load = [&](Words* buf, long long group) {
#pragma unroll
    for (int j = 0; j < VPL; ++j) {
      if (group < n_groups) {
        buf[j] = Io::load(x, group * per_group + j * L + lane);
      } else {
#pragma unroll
        for (int k = 0; k < Io::kWords; ++k) buf[j].w[k] = 0u;
      }
    }
  };

  // buf[0]: the group QDQ'd now; buf[1 .. D - 1]: the next ones, loaded
  Words buf[D][VPL];
#pragma unroll
  for (int d = 0; d + 1 < D; ++d) load(buf[d], g + d * sets);
  for (;;) {
    const bool more = w0 + sets < n_groups;
    load(buf[D - 1], g + (D - 1) * sets);
    Words* cur = buf[0];
    float m = 0.f;
    uint32_t bits = 0u;
#pragma unroll
    for (int j = 0; j < VPL; ++j) Io::fold_max(cur[j], m, bits);
    m = Io::amax(m, bits);
    for (int o = L >> 1; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float s = group_scale(m, f.qmax);
    if (mode == kQdqInt) {
#pragma unroll
      for (int j = 0; j < VPL; ++j) qdq_load<Io, kQdqInt>(cur[j], s, f);
    } else {
#pragma unroll
      for (int j = 0; j < VPL; ++j) qdq_load<Io, kQdqMinifloat>(cur[j], s, f);
    }
    if (g < n_groups) {
#pragma unroll
      for (int j = 0; j < VPL; ++j)
        Io::store(y, g * per_group + j * L + lane, cur[j]);
    }
    if (!more) break;
    g += sets;
    w0 += sets;
#pragma unroll
    for (int d = 0; d + 1 < D; ++d)
#pragma unroll
      for (int j = 0; j < VPL; ++j) buf[d][j] = buf[d + 1][j];
  }
}

template <typename T>
__device__ __forceinline__ float to_f32(T v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __bfloat162float(v);
  else
    return __half2float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v) {
  if constexpr (std::is_same_v<T, float>)
    return v;
  else if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return __float2bfloat16_rn(v);
  else
    return __float2half_rn(v);
}

// QDQ of contiguous groups of n: warp w of the grid owns group w.
// Consecutive lanes read consecutive addresses; the max is reduced with
// shuffles; x is read again for the QDQ.
template <typename T>
__global__ void __launch_bounds__(kQdqWarps * 32)
qdq_rows_kernel(const T* __restrict__ x, T* __restrict__ y,
                long long n_groups, int n, QdqFormat fmt) {
  const long long wid =
      (long long)blockIdx.x * kQdqWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= n_groups) return;  // uniform per warp
  const T* src = x + wid * n;
  T* dst = y + wid * n;
  float amax = 0.f;
  for (int i = lane; i < n; i += 32)
    amax = fmaxf(amax, fabsf(to_f32(src[i])));
  const float s = group_scale(warp_max(amax), fmt.qmax);
  for (int i = lane; i < n; i += 32)
    dst[i] = from_f32<T>(qdq_value(to_f32(src[i]), s, fmt));
}

// Whether the minifloat fast form holds for a format (see
// qdq_unit_minifloat).
inline bool minifloat_fast(const QdqFormat& f) {
  const int lo = f.min_exp - f.man_bits, hi = f.max_exp - f.man_bits;
  return !f.is_int && lo >= -126 && lo <= 126 && hi >= -126 && hi <= 126;
}

// Whether a plan describes a launch the kernels take for these operands.
template <typename T>
bool qdq_plan_ok(const T* x, const T* y, long long n_groups, int n,
                 const QdqFormat& f, const QdqPlan& p) {
  if (n <= 0 || p.blocks <= 0) return false;
  if (p.rows_kernel)
    return p.threads == kQdqWarps * 32 &&
           (long long)p.blocks * kQdqWarps >= n_groups;
  const int width = p.vec ? 16 / (int)sizeof(T) : 1;
  const bool pow2 = p.lanes >= 1 && p.lanes <= 32 &&
                    (p.lanes & (p.lanes - 1)) == 0;
  const bool threads = p.threads == 32 || p.threads == 64 ||
                       p.threads == kStreamThreads;
  const bool aligned = !p.vec || ((uintptr_t)x % 16 == 0 &&
                                  (uintptr_t)y % 16 == 0);
  const bool mode = p.mode == kQdqInt         ? f.is_int != 0
                    : p.mode == kQdqMinifloat ? minifloat_fast(f)
                                              : false;
  return pow2 && threads && aligned && mode && p.vpl >= 1 &&
         p.vpl <= kStreamMaxVpl && p.lanes * p.vpl * width == n;
}

template <typename T, bool VEC, int VPL>
void launch_stream(const T* x, T* y, long long n_groups, const QdqFormat& f,
                   const QdqPlan& p, cudaStream_t stream) {
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < p.lanes) ++lanes_log2;
  qdq_stream_kernel<T, VEC, VPL><<<p.blocks, p.threads, 0, stream>>>(
      x, y, n_groups, lanes_log2, f, p.mode);
}

template <typename T, bool VEC>
void launch_stream_vpl(const T* x, T* y, long long n_groups,
                       const QdqFormat& f, const QdqPlan& p,
                       cudaStream_t stream) {
  switch (p.vpl) {
    case 1: return launch_stream<T, VEC, 1>(x, y, n_groups, f, p, stream);
    case 2: return launch_stream<T, VEC, 2>(x, y, n_groups, f, p, stream);
    case 3: return launch_stream<T, VEC, 3>(x, y, n_groups, f, p, stream);
    case 4: return launch_stream<T, VEC, 4>(x, y, n_groups, f, p, stream);
    case 5: return launch_stream<T, VEC, 5>(x, y, n_groups, f, p, stream);
    case 6: return launch_stream<T, VEC, 6>(x, y, n_groups, f, p, stream);
    case 7: return launch_stream<T, VEC, 7>(x, y, n_groups, f, p, stream);
    default: return launch_stream<T, VEC, 8>(x, y, n_groups, f, p, stream);
  }
}

// QDQ of n_groups contiguous groups of n on the caller's stream, as the
// plan says.  Returns cudaErrorInvalidValue for a plan the kernels do not
// take, else cudaSuccess once the launch is enqueued: the caller reads
// cudaGetLastError() for the launch's own error.
template <typename T>
int launch_qdq(const T* x, T* y, long long n_groups, int n,
               const QdqFormat& f, const QdqPlan& p, cudaStream_t stream) {
  if (n_groups <= 0) return (int)cudaSuccess;
  if (!qdq_plan_ok(x, y, n_groups, n, f, p))
    return (int)cudaErrorInvalidValue;
  if (p.rows_kernel)
    qdq_rows_kernel<T><<<p.blocks, p.threads, 0, stream>>>(x, y, n_groups,
                                                          n, f);
  else if (p.vec)
    launch_stream_vpl<T, true>(x, y, n_groups, f, p, stream);
  else
    launch_stream_vpl<T, false>(x, y, n_groups, f, p, stream);
  return (int)cudaSuccess;
}

}  // namespace repro
