// Compressed-domain quantized matmul for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (body _stored_codes_kernel):
//
//   y[m, c] = sum_g sx[m, g] * ws[c, g] * (xc[m, g, :] . wc[c, g, :])
//
// x (M, K) f32 is ABFP-quantized here per group of n along K (group max ->
// bf16 -> max(., 1e-12) -> / qmax -> divide -> round-half-even -> clip ->
// int8); the weight arrives as stored integer codes (N, G, n) int8, or
// (N, G, n/2) bytes holding two 4-bit two's-complement codes each (element
// 2i in the low nibble), plus f32 unit scales (N, G).  Group products are
// summed in int32, the per-group rescale and the sum across groups are f32.
//
// What bounds it on this card: at decode (M = n_slots, a handful of rows)
// the call is bound by reading the weight codes once from device memory;
// at prefill (M in the hundreds) by integer multiply-accumulate.
//
// Design.  The TPU kernel walks a sequential (M/bm, N/bn, K/bk) grid and
// carries an accumulator across K steps; here nothing carries across
// blocks, so each warp owns CN output columns for a tile of BM rows and
// loops over all of K itself.
//   stage 1  quantize_rows: one warp per (row, group) writes the int8
//            codes and the unit scale of x once, so the contraction never
//            repeats the divide/round per output tile.
//   stage 2  contract: per step a lane loads 16 bytes of each of its CN
//            weight rows (coalesced, 512 bytes a warp, CN loads in flight),
//            unpacks 4-bit codes in registers, multiplies with __dp4a
//            against the x codes, reduces the int32 sums over the lanes of
//            a group by shuffles, and folds sx * ws in f32.  Packed 4-bit
//            codes are read as stored: the weight bytes cross the memory
//            bus once and are never expanded in device memory.
// Both stages are launched by one host entry on the caller's stream.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no fast-math: the divides and rintf pin the
//        reference's bit patterns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

// ---------------------------------------------------------------- stage 1
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, int8_t* __restrict__ xc,
                     float* __restrict__ sx, long long n_groups, int n,
                     float qmax, float qmin) {
  const long long wid =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= n_groups) return;  // uniform per warp
  const float* src = x + wid * n;
  int8_t* dst = xc + wid * n;
  float amax = 0.f;
  for (int i = lane; i < n; i += 32) amax = fmaxf(amax, fabsf(src[i]));
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  // scales live in bf16 (round to nearest even), floored, then alpha/qmax
  float alpha = __bfloat162float(__float2bfloat16_rn(amax));
  alpha = fmaxf(alpha, 1e-12f);
  const float s = alpha / qmax;
  for (int i = lane; i < n; i += 32) {
    float q = rintf(src[i] / s);
    q = fminf(fmaxf(q, qmin), qmax);
    dst[i] = (int8_t)q;
  }
  if (lane == 0) sx[wid] = s;
}

// ---------------------------------------------------------------- stage 2
template <int BM, int CN, bool PACKED>
__global__ void __launch_bounds__(kThreads)
contract_kernel(const int8_t* __restrict__ xc,   // (M, K) codes
                const float* __restrict__ sx,    // (M, G)
                const uint8_t* __restrict__ wc,  // (N, K) or (N, K/2)
                const float* __restrict__ ws,    // (N, G)
                float* __restrict__ y,           // (M, N)
                int M, int N, int K, int n) {
  constexpr int CPL = PACKED ? 32 : 16;  // codes a lane takes per step
  constexpr int XW = CPL / 4;            // 32-bit words of x codes per lane
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int G = K / n;
  const int lpg = n / CPL;  // lanes per group, a power of two <= 32
  const int col0 = (blockIdx.x * kWarpsPerBlock + warp) * CN;
  const int row0 = blockIdx.y * BM;
  if (col0 >= N) return;  // uniform per warp
  const size_t row_bytes = PACKED ? (size_t)(K / 2) : (size_t)K;

  float acc[BM][CN];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[m][c] = 0.f;

  for (int k0 = 0; k0 < K; k0 += 32 * CPL) {
    const int k = k0 + lane * CPL;
    const bool live = k < K;  // K is a multiple of n, n of CPL
    const int g = live ? k / n : 0;

    uint4 w[CN];
    float wscale[CN];
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      const int col = min(col0 + c, N - 1);
      w[c] = make_uint4(0u, 0u, 0u, 0u);
      wscale[c] = 0.f;
      if (live) {
        w[c] = __ldg(reinterpret_cast<const uint4*>(
            wc + (size_t)col * row_bytes + (PACKED ? (k >> 1) : k)));
        wscale[c] = __ldg(ws + (size_t)col * G + g);
      }
    }

#pragma unroll
    for (int m = 0; m < BM; ++m) {
      const int row = row0 + m;
      const bool rlive = live && row < M;
      uint32_t xw[XW];
#pragma unroll
      for (int i = 0; i < XW; ++i) xw[i] = 0u;
      float sxm = 0.f;
      if (rlive) {
        const uint4* xp =
            reinterpret_cast<const uint4*>(xc + (size_t)row * K + k);
#pragma unroll
        for (int i = 0; i < XW / 4; ++i) {
          const uint4 v = __ldg(xp + i);
          xw[4 * i + 0] = v.x;
          xw[4 * i + 1] = v.y;
          xw[4 * i + 2] = v.z;
          xw[4 * i + 3] = v.w;
        }
        sxm = __ldg(sx + (size_t)row * G + g);
      }

      int p[CN];
#pragma unroll
      for (int c = 0; c < CN; ++c) p[c] = 0;

      if constexpr (PACKED) {
        // weight word i holds elements 8i..8i+7: even ones in the low
        // nibbles, odd ones in the high nibbles.  Moving a nibble to the
        // top of its byte gives 16 * (signed code) as an int8, so the
        // dp4a sum is 16 times the true one and is shifted back exactly.
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t xe = __byte_perm(xw[2 * i], xw[2 * i + 1], 0x6420);
          const uint32_t xo = __byte_perm(xw[2 * i], xw[2 * i + 1], 0x7531);
#pragma unroll
          for (int c = 0; c < CN; ++c) {
            const uint32_t wi = (&w[c].x)[i];
            const uint32_t lo = (wi << 4) & 0xF0F0F0F0u;
            const uint32_t hi = wi & 0xF0F0F0F0u;
            p[c] = __dp4a((int)lo, (int)xe, p[c]);
            p[c] = __dp4a((int)hi, (int)xo, p[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < CN; ++c) p[c] >>= 4;
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int c = 0; c < CN; ++c)
            p[c] = __dp4a((int)(&w[c].x)[i], (int)xw[i], p[c]);
        }
      }

      // int32 sum of the whole group, on every lane of the group
      for (int o = 1; o < lpg; o <<= 1) {
#pragma unroll
        for (int c = 0; c < CN; ++c)
          p[c] += __shfl_xor_sync(0xffffffffu, p[c], o);
      }
#pragma unroll
      for (int c = 0; c < CN; ++c)
        acc[m][c] += ((float)p[c] * sxm) * wscale[c];
    }
  }

  // every lane of a group holds the same sums: keep one, add over lanes
  const bool leader = (lane & (lpg - 1)) == 0;
#pragma unroll
  for (int m = 0; m < BM; ++m) {
#pragma unroll
    for (int c = 0; c < CN; ++c) {
      float v = leader ? acc[m][c] : 0.f;
      for (int o = 16; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
      const int row = row0 + m;
      const int col = col0 + c;
      if (lane == 0 && row < M && col < N) y[(size_t)row * N + col] = v;
    }
  }
}

template <int BM, int CN>
void launch_contract(const int8_t* xc, const float* sx, const uint8_t* wc,
                     const float* ws, float* y, int M, int N, int K, int n,
                     bool packed, cudaStream_t stream) {
  dim3 grid((N + kWarpsPerBlock * CN - 1) / (kWarpsPerBlock * CN),
            (M + BM - 1) / BM);
  if (packed)
    contract_kernel<BM, CN, true>
        <<<grid, kThreads, 0, stream>>>(xc, sx, wc, ws, y, M, N, K, n);
  else
    contract_kernel<BM, CN, false>
        <<<grid, kThreads, 0, stream>>>(xc, sx, wc, ws, y, M, N, K, n);
}

}  // namespace

// x: (M, K) f32, K = G * n already zero-padded.  wc: (N, K) int8 codes or
// (N, K/2) packed nibbles.  ws: (N, G) f32.  xc_scratch: M*K bytes,
// sx_scratch: M*G floats, y: (M, N) f32.  Returns cudaGetLastError().
extern "C" int repro_quant_matmul(const void* x, const void* wc,
                                  const void* ws, void* xc_scratch,
                                  void* sx_scratch, void* y, int M, int N,
                                  int K, int n, int packed, float qmax,
                                  float qmin, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_groups = (long long)M * (K / n);
  const int qblocks =
      (int)((n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock);
  quantize_rows_kernel<<<qblocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(xc_scratch),
      static_cast<float*>(sx_scratch), n_groups, n, qmax, qmin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int8_t* xc = static_cast<const int8_t*>(xc_scratch);
  const float* sx = static_cast<const float*>(sx_scratch);
  const uint8_t* w = static_cast<const uint8_t*>(wc);
  const float* s = static_cast<const float*>(ws);
  float* out = static_cast<float*>(y);
  if (M <= 4)
    launch_contract<4, 4>(xc, sx, w, s, out, M, N, K, n, packed != 0, stream);
  else if (M <= 8)
    launch_contract<8, 2>(xc, sx, w, s, out, M, N, K, n, packed != 0, stream);
  else
    launch_contract<16, 2>(xc, sx, w, s, out, M, N, K, n, packed != 0,
                           stream);
  return (int)cudaGetLastError();
}
