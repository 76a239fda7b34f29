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
// The same file holds the two dense matmuls that QDQ both operands per
// call (repro/kernels/quant_matmul.py::abfp_matmul and ::abfp_matmul_int8);
// see the section "dense weights" below.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no fast-math: the divides and rintf pin the
//        reference's bit patterns).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "abfp_qdq.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

// ---------------------------------------------------------------- stage 1
// int codes of x per (row, group): one warp per group.
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
  // scales live in bf16 (round to nearest even), floored, then alpha/qmax
  const float s = repro::group_scale(repro::warp_max(amax), qmax);
  const repro::QdqFormat f{1, qmax, qmin, 0, 0, 0};
  for (int i = lane; i < n; i += 32)
    dst[i] = (int8_t)repro::int_code(src[i], s, f);
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

// ===========================================================================
// Dense weights: abfp_matmul (fp path) and abfp_matmul_int8.
//
// Replace repro/kernels/quant_matmul.py::abfp_matmul (body _fp_kernel) and
// ::abfp_matmul_int8 (body _int8_kernel): x (M, K) and w (K, N), both f32,
// are ABFP-quantized per group of n along K at every call (w per column: a
// column's group is n rows of one column), with the device functions of
// abfp_qdq.cuh.  Nothing is cached across calls, as on the TPU.
//
// What bounds them on this card: at decode (M = a handful of rows) reading
// the f32 weight once from device memory; at prefill (M in the hundreds)
// the f32 multiply-adds, since the contraction stays on the CUDA cores (see
// below).
//
// abfp_matmul.  Stage 1 QDQs x once into scratch (qdq_rows_kernel: x is
// read by every column block, so its QDQ is not repeated per tile).  Stage
// 2 is an f32 SIMT tiled contraction: per K step of one group a block
// loads a (BM, n) x tile and an (n, BN) w tile into shared memory, QDQs
// each of the BN column groups of the w tile in place (a column's max is
// reduced over kThreads / BN threads through shared memory), then every
// thread accumulates its TM x TN outputs.  w crosses the memory bus once
// per row block and is QDQ'd on chip, as the TPU kernel does in VMEM.  No
// TF32 and no tensor core: an int8 code times a bf16 scale has up to 16
// significant bits, TF32 keeps 11, so it would change the product the
// reference computes in f32.  Each group's partial sum is added to the
// running total once, which keeps the f32 rounding error of K = 18944
// terms near that of a pairwise sum.
//
// abfp_matmul_int8.  x codes and scales per (row, group) (stage 1,
// quantize_rows_kernel) and w codes and scales per (group, column)
// (quantize_cols_kernel, written transposed as (N, K) so a column's codes
// are contiguous) go to scratch once; stage 2 is contract_kernel above on
// int8 codes: exact int32 group sums by __dp4a, rescaled by sx * sw in
// f32 and summed over groups.
// ===========================================================================
namespace {

// w (K, N) f32 -> codes wc (N, K) int8 and unit scales sw (N, G): one
// thread per (group, column); neighbouring threads read neighbouring
// columns, so the reads of a row of the group are coalesced.
__global__ void __launch_bounds__(kThreads)
quantize_cols_kernel(const float* __restrict__ w, int8_t* __restrict__ wc,
                     float* __restrict__ sw, int K, int N, int n, float qmax,
                     float qmin) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int G = K / n;
  if (idx >= (long long)G * N) return;
  const int c = (int)(idx % N);
  const int g = (int)(idx / N);
  const float* src = w + (size_t)g * n * N + c;
  float amax = 0.f;
  for (int i = 0; i < n; ++i) amax = fmaxf(amax, fabsf(src[(size_t)i * N]));
  const float s = repro::group_scale(amax, qmax);
  const repro::QdqFormat f{1, qmax, qmin, 0, 0, 0};
  uint32_t* dst = reinterpret_cast<uint32_t*>(wc + (size_t)c * K + g * n);
  for (int i = 0; i < n; i += 4) {  // n % 16 == 0: whole 32-bit words
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int8_t q = (int8_t)repro::int_code(src[(size_t)(i + b) * N], s, f);
      word |= (uint32_t)(uint8_t)q << (8 * b);
    }
    dst[i / 4] = word;
  }
  sw[(size_t)c * G + g] = s;
}

template <int BM, int BN, int TM, int TN>
__global__ void __launch_bounds__(kThreads)
fp_contract_kernel(const float* __restrict__ xq,  // (M, K) QDQ'd x
                   const float* __restrict__ w,   // (K, N) raw weight
                   float* __restrict__ y,         // (M, N)
                   int M, int N, int K, int n, repro::QdqFormat fw) {
  constexpr int CT = BN / TN;  // threads along columns
  constexpr int RT = BM / TM;  // threads along rows
  constexpr int P = kThreads / BN;  // threads sharing one column's QDQ
  static_assert(CT * RT == kThreads, "thread tile must cover the block");
  static_assert(P * BN == kThreads, "BN must divide the block");
  extern __shared__ float smem[];
  float* xs = smem;            // [BM][n]
  float* ws = xs + BM * n;     // [n][BN]
  float* red = ws + n * BN;    // [P][BN] partial column maxima
  const int tid = threadIdx.x;
  const int tx = tid % CT, ty = tid / CT;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += n) {
    for (int e = tid; e < BM * n; e += kThreads) {
      const int r = e / n, c = e - r * n;
      const int row = row0 + r;
      xs[e] = row < M ? xq[(size_t)row * K + k0 + c] : 0.f;
    }
    for (int e = tid; e < n * BN; e += kThreads) {
      const int r = e / BN, c = e - r * BN;
      const int col = col0 + c;
      ws[e] = col < N ? w[(size_t)(k0 + r) * N + col] : 0.f;
    }
    __syncthreads();
    {  // QDQ the BN column groups of the w tile in place
      const int c = tid % BN, part = tid / BN;
      float amax = 0.f;
      for (int r = part; r < n; r += P) amax = fmaxf(amax, fabsf(ws[r * BN + c]));
      red[tid] = amax;
      __syncthreads();
      float m = red[c];
      for (int p = 1; p < P; ++p) m = fmaxf(m, red[p * BN + c]);
      const float s = repro::group_scale(m, fw.qmax);
      for (int r = part; r < n; r += P)
        ws[r * BN + c] = repro::qdq_value(ws[r * BN + c], s, fw);
    }
    __syncthreads();
    float part_sum[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) part_sum[i][j] = 0.f;
    for (int k = 0; k < n; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[(ty + i * RT) * n + k];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = ws[k * BN + tx + j * CT];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part_sum[i][j] += a[i] * b[j];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] += part_sum[i][j];
    __syncthreads();  // the tiles are overwritten by the next step
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = row0 + ty + i * RT;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tx + j * CT;
      if (row < M && col < N) y[(size_t)row * N + col] = acc[i][j];
    }
  }
}

template <int BM, int BN, int TM, int TN>
int launch_fp_contract(const float* xq, const float* w, float* y, int M,
                       int N, int K, int n, const repro::QdqFormat& fw,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BM * n + (size_t)n * BN +
                                       (size_t)kThreads);
  auto kern = fp_contract_kernel<BM, BN, TM, TN>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kern<<<grid, kThreads, smem, stream>>>(xq, w, y, M, N, K, n, fw);
  return (int)cudaGetLastError();
}

}  // namespace

// x: (M, K) f32, w: (K, N) f32, K a multiple of n; xq_scratch: M*K floats;
// y: (M, N) f32.  fmt_x / fmt_w as QdqFormat fields.  Returns a CUDA error.
extern "C" int repro_abfp_matmul(const void* x, const void* w,
                                 void* xq_scratch, void* y, int M, int N,
                                 int K, int n, int x_int, float x_qmax,
                                 float x_qmin, int x_man, int x_emin,
                                 int x_emax, int w_int, float w_qmax,
                                 float w_qmin, int w_man, int w_emin,
                                 int w_emax, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const repro::QdqFormat fx{x_int, x_qmax, x_qmin, x_man, x_emin, x_emax};
  const repro::QdqFormat fw{w_int, w_qmax, w_qmin, w_man, w_emin, w_emax};
  float* xq = static_cast<float*>(xq_scratch);
  repro::launch_qdq_rows(static_cast<const float*>(x), xq,
                         (long long)M * (K / n), n, fx, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* wf = static_cast<const float*>(w);
  float* out = static_cast<float*>(y);
  if (M <= 4)
    return launch_fp_contract<4, 64, 1, 1>(xq, wf, out, M, N, K, n, fw,
                                           stream);
  if (M <= 16)
    return launch_fp_contract<16, 64, 1, 4>(xq, wf, out, M, N, K, n, fw,
                                            stream);
  return launch_fp_contract<64, 64, 4, 4>(xq, wf, out, M, N, K, n, fw,
                                          stream);
}

// x: (M, K) f32, w: (K, N) f32, K a multiple of n (n / 16 a power of two
// <= 32); scratch: xc M*K bytes, sx M*G floats, wc N*K bytes, sw N*G
// floats; y: (M, N) f32.  Returns a CUDA error.
extern "C" int repro_abfp_matmul_int8(const void* x, const void* w,
                                      void* xc_scratch, void* sx_scratch,
                                      void* wc_scratch, void* sw_scratch,
                                      void* y, int M, int N, int K, int n,
                                      float x_qmax, float x_qmin,
                                      float w_qmax, float w_qmin,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long n_groups = (long long)M * (K / n);
  const int qblocks =
      (int)((n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock);
  quantize_rows_kernel<<<qblocks, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<int8_t*>(xc_scratch),
      static_cast<float*>(sx_scratch), n_groups, n, x_qmax, x_qmin);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long w_groups = (long long)(K / n) * N;
  quantize_cols_kernel<<<(unsigned)((w_groups + kThreads - 1) / kThreads),
                         kThreads, 0, stream>>>(
      static_cast<const float*>(w), static_cast<int8_t*>(wc_scratch),
      static_cast<float*>(sw_scratch), K, N, n, w_qmax, w_qmin);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int8_t* xc = static_cast<const int8_t*>(xc_scratch);
  const float* sx = static_cast<const float*>(sx_scratch);
  const uint8_t* wc = static_cast<const uint8_t*>(wc_scratch);
  const float* sw = static_cast<const float*>(sw_scratch);
  float* out = static_cast<float*>(y);
  if (M <= 4)
    launch_contract<4, 4>(xc, sx, wc, sw, out, M, N, K, n, false, stream);
  else if (M <= 8)
    launch_contract<8, 2>(xc, sx, wc, sw, out, M, N, K, n, false, stream);
  else
    launch_contract<16, 2>(xc, sx, wc, sw, out, M, N, K, n, false, stream);
  return (int)cudaGetLastError();
}
