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
// at a prefill chunk (M = 256 rows) bytes and int8 tensor-core operations
// take about the same time (wi,wg: 61 MB of x, codes, scales and y in
// 0.018 ms at 3.35 TB/s; 2 M N K = 34.8 G operations in 0.018 ms at 1,979
// TOP/s).
//
// Design.  The TPU kernel walks a sequential (M/bm, N/bn, K/bk) grid,
// quantizes x in VMEM and carries an accumulator across K steps; here
// nothing carries across blocks, so a block loops over K itself.
//   M <= 16  quant_decode_kernel, the whole call in one launch: K split
//            into at most 8 runs of whole groups across blocks, the
//            weight's codes streamed once through a cp.async ring, x's
//            codes of a block's split made on chip once a block (as
//            quantize_rows_kernel makes them), a contraction by __dp4a
//            into exact int32 group sums, and the split partials added in
//            split order.  See its note below.
//   M <= 4 on a layer of N >= 4 x 132 x 32 columns (wi,wg, lm_head)
//            stage 1, quantize_rows (below), then contract_kernel: a warp
//            streams 4 columns along K with no split and no prologue;
//            measured faster there than the one-launch kernel.
//   M > 16 (or a group length the decode kernels are not built for)
//            stage 1, quantize_rows: one warp per (row, group) writes the
//            int8 codes and the unit scale of x once, so the contraction
//            never repeats the divide/round per output tile; stage 2,
//            mma_contract_kernel: the contraction on the int8 tensor cores
//            (mma.sync m16n8k32), fed from shared memory by a 4-stage
//            cp.async ring; it replaces the TPU kernels
//            repro/kernels/quant_matmul.py:226 quant_matmul (body
//            _stored_codes_kernel) and :171 abfp_matmul_int8 (body
//            _int8_kernel) above 16 rows, and (on bf16 unit codes) :156
//            abfp_matmul.  See its note below, with its summation order.
// Packed 4-bit codes are read as stored by both: the weight bytes cross
// the memory bus once and are never expanded in device memory.
// One host entry launches either on the caller's stream.
//
// Any group length n that divides K: the codes of each group are
// zero-padded to n_pad, n rounded up to a multiple of 16 (packed: 32).
// A zero code adds exactly 0 to a group sum, so the contractions see a
// group length they are built for; the scales stay (rows, G).  x's codes
// are written with stride n_pad (zeros in the pad); stored weight codes
// off that grid arrive zero-padded from the wrapper (a plain copy).
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
#include "ptx.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

// ---------------------------------------------------------------- stage 1
// A unit code (qdq_unit's output) as stored: int8_t for int formats of at
// most 8 bits, __nv_bfloat16 for any format whose unit codes bf16 holds
// exactly (the conversion is then exact), and its bits.
template <typename T>
__device__ __forceinline__ T to_code(float u);
template <>
__device__ __forceinline__ int8_t to_code<int8_t>(float u) {
  return (int8_t)u;
}
template <>
__device__ __forceinline__ __nv_bfloat16 to_code<__nv_bfloat16>(float u) {
  return __float2bfloat16_rn(u);
}
template <typename T>
__device__ __forceinline__ uint32_t code_bits(float u) {
  if constexpr (sizeof(T) == 1)
    return (uint32_t)(uint8_t)to_code<int8_t>(u);
  else
    return (uint32_t)__bfloat16_as_ushort(to_code<__nv_bfloat16>(u));
}

// The unit code of x in a group of scale s (qdq_unit of x / s), with the
// format's branch resolved at compile time.
template <bool INT>
__device__ __forceinline__ float unit_code(float x, float s,
                                           const repro::QdqFormat& f) {
  if constexpr (INT)
    return fminf(fmaxf(rintf(x / s), f.qmin), f.qmax);
  else
    return repro::qdq_unit(x / s, f);
}

// Unit codes of x per (row, group): one warp per group, which reads its n
// values (stride n) and writes n codes and n_pad - n zeros (stride
// n_pad).  INT: the format is an integer grid (resolved at compile time;
// int8_t codes always are).
template <typename T, bool INT>
__global__ void __launch_bounds__(kThreads)
quantize_rows_kernel(const float* __restrict__ x, T* __restrict__ xc,
                     float* __restrict__ sx, long long n_groups, int n,
                     int n_pad, repro::QdqFormat f) {
  const long long wid =
      (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (wid >= n_groups) return;  // uniform per warp
  const float* src = x + wid * n;
  T* dst = xc + wid * n_pad;
  float amax = 0.f;
  for (int i = lane; i < n; i += 32) amax = fmaxf(amax, fabsf(src[i]));
  // scales live in bf16 (round to nearest even), floored, then alpha/qmax
  const float s = repro::group_scale(repro::warp_max(amax), f.qmax);
  for (int i = lane; i < n_pad; i += 32)
    dst[i] = to_code<T>(i < n ? unit_code<INT>(src[i], s, f) : 0.f);
  if (lane == 0) sx[wid] = s;
}

// Stage 1 on the caller's stream: M * G groups.  Returns a CUDA error.
template <typename T>
int launch_quantize_rows(const float* x, T* xc, float* sx, long long n_groups,
                         int n, int n_pad, const repro::QdqFormat& f,
                         cudaStream_t stream) {
  if (n_groups <= 0) return (int)cudaSuccess;
  const unsigned blocks =
      (unsigned)((n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if constexpr (sizeof(T) == 1) {
    quantize_rows_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
        x, xc, sx, n_groups, n, n_pad, f);
  } else {
    if (f.is_int)
      quantize_rows_kernel<T, true><<<blocks, kThreads, 0, stream>>>(
          x, xc, sx, n_groups, n, n_pad, f);
    else
      quantize_rows_kernel<T, false><<<blocks, kThreads, 0, stream>>>(
          x, xc, sx, n_groups, n, n_pad, f);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- stage 2
// contract_kernel, up to 4 rows of a layer of N >= 4 x 132 x 32 columns
// (wi,wg, lm_head; quant_matmul_plan chooses it): a warp owns CN output
// columns and walks the whole of K, 32 lanes side by side along it.  Per
// step a lane loads 16 bytes of each of its CN weight rows (coalesced, 512
// bytes a warp, CN loads in flight), unpacks 4-bit codes in registers,
// multiplies with __dp4a against x's codes (stage 1's, read through the
// cache), reduces the int32 sums over the lanes of a group by shuffles,
// and folds sx * ws in f32; the lanes' sums are added at the end.  There a
// block needs no x prologue of its own and the call measured faster than
// quant_decode_kernel (PERF.md), at the cost of a second launch.
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

// ------------------------------------------------ stage 2, above 16 rows
// mma_contract_kernel: the contraction on the tensor cores (mma.sync), for
// three code types (Codes below): int8 codes of x and the weight, int8 x
// codes against packed 4-bit weight codes, and bf16 unit codes of both
// (abfp_matmul's operands, in any format whose unit codes bf16 holds
// exactly).  A bf16 m16n8k16 fragment has the byte layout of an int8
// m16n8k32 one (16 rows x 32 bytes, four bytes a register), so one kernel
// counts its operands in bytes and differs by code type only in the MMA
// instruction, the type of a group sum and how a group sum is read.
// A block owns a 64 x 128 output tile (eight warps, 2 x 4, of 32 x 32) and
// one K split of whole groups; two blocks fit on an SM.  Per stage it
// copies one chunk of a group (C codes: the whole group up to 128 bytes of
// x codes a row, else the largest multiple of 16 (packed: 32) codes within
// that which divides n) of x's (64, C) codes, the weight's (128, C) codes
// or (128, C/2) packed bytes, and the 64 + 128 scales of that group into a
// ring of kMmaStages shared-memory stages by cp.async copies (16 bytes; 4
// for a scale); rows are an odd number of 16-byte units apart, so the 8
// rows an ldmatrix (or a quarter-warp's loads) touch fall on 8 distinct
// bank groups.  A fragments come by ldmatrix.x4; int8 and bf16 weight
// fragments by ldmatrix.x4 too; packed weight fragments by two 16-bit
// loads a register, each expanded on chip into four int8 in element order
// as 16 x the signed code (a nibble moved to the top of its byte), so the
// group sum comes out 16 times the true one and is shifted back exactly.
// Each K step of 32 bytes is one MMA per (16-row, 8-column) tile of the
// warp: m16n8k32 s8 (32 int8 codes) or m16n8k16 bf16 with f32 sums (16
// bf16 codes); an int8 chunk's remainder of 16 codes (n = 48, 80, ...) is
// one m16n8k16 s8.  A group's sums accumulate over its chunks; after the
// group's last chunk each is folded as acc += (P * sx) * sw (in that
// order, as the reference multiplies) and zeroed.
// Exactness.  int8: P is an exact int32.  bf16: every unit code of the
// formats the planner sends here is an integer of magnitude <= 256 or a
// minifloat grid point of at most 8 significant bits inside bf16's
// exponent range, so bf16 holds it exactly and each product u * v is
// exact in f32; for int codes every partial sum is an integer below 2^24
// while n * max|u| * max|v| < 2^24 (int8 x int8: n <= 1040), so P is exact
// and the result is bit for bit the int8 kernel's on the same grid.  For
// minifloat codes P is rounded to f32 on the tensor cores; the reference
// leaves its f32 accumulation order free.
// Summation order: each output adds its groups in order within a split;
// the last block of a tile to finish (an integer ticket) adds the split
// partials in split order.  Deterministic, no float atomics.
// Grid (plan_mma_contract in kernels/quant_matmul.py, which the wrapper
// passes in): K is split into whole groups until the tiles fill a wave of
// 132 blocks (M = 256: q,o and wo 112 tiles x 2 splits, k,v 16 x 9, wi,wg
// 592 x 1).  Splitting K rather than narrowing the column tile keeps each
// x fragment feeding four weight tiles; it costs one pass over S x M x N
// partial floats, in L2.  On an H100 a block's warps spend each chunk in
// three phases of similar length, one after another: issuing the copies
// (the warps stall while the load queue drains), the ldmatrix loads and
// MMAs, and the fold.  Neither the mma.sync rate nor the fold rate alone
// (tools/int8_mma_rate.py) nor the bytes set the time; the second block
// on an SM overlaps its phases with the first's (PERF.md).
constexpr int kMmaBM = 64;         // output rows per block
constexpr int kMmaBN = 128;        // output columns per block
constexpr int kMmaStages = 4;      // ring depth
constexpr int kMmaChunkMax = 128;  // bytes of a row's x codes per stage

// bytes of a shared-memory row that holds b bytes: an odd number of
// 16-byte units
__host__ __device__ constexpr int mma_row_bytes(int b) {
  return (b / 16) % 2 ? b : b + 16;
}

// codes of a group one stage holds, x codes of ``xbytes`` bytes each
__host__ __device__ inline int mma_chunk(int n, int xbytes, bool packed) {
  const int most = kMmaChunkMax / xbytes;
  if (n <= most) return n;
  const int step = packed ? 32 : 16;
  for (int c = most; c > step; c -= step)
    if (n % c == 0) return c;
  return step;
}

__host__ __device__ inline size_t mma_stage_bytes(int bm, int chunk,
                                                  int xbytes, bool packed) {
  return (size_t)bm * mma_row_bytes(chunk * xbytes) +
         (size_t)kMmaBN *
             mma_row_bytes(packed ? chunk / 2 : chunk * xbytes) +
         sizeof(float) * (size_t)(bm + kMmaBN);
}

// d += a . b: one m16n8k32 / m16n8k16 int8 MMA, int32 sums
__device__ __forceinline__ void mma_k32(int* d, const uint32_t* a,
                                        const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_k16(int* d, const uint32_t* a,
                                        uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// The code types of mma_contract_kernel: bytes of an x code, whether the
// weight is packed 4-bit, the type of a group sum, the MMA of a 32-byte K
// step, and the group sum P that a fold reads.
struct Int8Codes {
  using Sum = int;
  static constexpr int kXBytes = 1;
  static constexpr bool kPacked = false;
  __device__ static void mma(int* d, const uint32_t* a, const uint32_t* b) {
    mma_k32(d, a, b);
  }
  __device__ static float group_sum(int p) { return (float)p; }
};
struct Int4PackedCodes {  // the sum is 16 P: shifted back exactly
  using Sum = int;
  static constexpr int kXBytes = 1;
  static constexpr bool kPacked = true;
  __device__ static void mma(int* d, const uint32_t* a, const uint32_t* b) {
    mma_k32(d, a, b);
  }
  __device__ static float group_sum(int p) { return (float)(p >> 4); }
};
struct Bf16Codes {
  using Sum = float;
  static constexpr int kXBytes = 2;
  static constexpr bool kPacked = false;
  __device__ static void mma(float* d, const uint32_t* a,
                             const uint32_t* b) {
    mma_bf16(d, a, b);
  }
  __device__ static float group_sum(float p) { return p; }
};

// acc += (P * sx) * sw for each output of a warp, P its group sum, and
// the sum zeroed for the next group.  sxv[2 i + h]: the scale of the
// warp's row 16 i + g + 8 h; swv[2 j + h]: that of its column 8 j + 2 tig
// + h.
template <typename Codes, int MT, int NT>
__device__ __forceinline__ void fold_group(
    float (&acc)[MT][NT][4], typename Codes::Sum (&p)[MT][NT][4],
    const float (&sxv)[2 * MT], const float (&swv)[2 * NT]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float fp = Codes::group_sum(p[i][j][e]);
        acc[i][j][e] += (fp * sxv[2 * i + (e >> 1)]) * swv[2 * j + (e & 1)];
        p[i][j][e] = 0;
      }
}

// two packed bytes (elements 2i .. 2i + 3, element 2i in the low nibble
// of byte i) -> four int8 in element order, each 16 x its signed 4-bit
// code (a nibble moved to the top of its byte)
__device__ __forceinline__ uint32_t nibbles_x16(uint32_t v) {
  const uint32_t u = __byte_perm(v, 0u, 0x1100);  // bytes v0 v0 v1 v1
  return ((u << 4) & 0x00F000F0u) | (u & 0xF000F000u);
}

// mma_contract_kernel itself (see the note above kMmaBM).  Block: 64 x 128
// outputs, 8 warps (2 x 4) of 32 x 32, i.e. 2 x 4 (16-row, 8-column) MMA
// tiles a warp; up to two blocks an SM (128 registers a thread), so one
// block's copies can overlap the other's MMAs and rescaling.
template <typename Codes>
__global__ void __launch_bounds__(kThreads, 2)
mma_contract_kernel(const uint8_t* __restrict__ xc,  // (M, K) codes
                    const float* __restrict__ sx,    // (M, G)
                    const uint8_t* __restrict__ wc,  // (N, K) codes or
                                                     // (N, K/2) packed
                    const float* __restrict__ sw,    // (N, G)
                    float* __restrict__ y,           // (M, N)
                    float* __restrict__ partial,     // (S, M, N) when S > 1
                    int* __restrict__ tickets,       // one per tile, zero
                    int M, int N, int K, int n) {
  constexpr int BM = kMmaBM, BN = kMmaBN, WM = 32, WN = 32;
  constexpr int MT = WM / 16, NT = WN / 8;  // m16 and n8 tiles of a warp
  constexpr int XB = Codes::kXBytes;
  constexpr bool PACKED = Codes::kPacked;
  extern __shared__ __align__(16) uint8_t mma_ring[];
  const int C = mma_chunk(n, XB, PACKED);
  const int CB = C * XB;               // bytes of a row's x codes a stage
  const int WB = PACKED ? C / 2 : CB;  // and of a weight row's codes
  const int xrow = mma_row_bytes(CB);
  const int wrow = mma_row_bytes(WB);
  const int stage = (int)mma_stage_bytes(BM, C, XB, PACKED);
  const int G = K / n, Q = n / C;  // groups, chunks a group
  const int S = gridDim.z, split = blockIdx.z;
  const int g_lo = (int)((long long)split * G / S);
  const int T = ((int)((long long)(split + 1) * G / S) - g_lo) * Q;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, tig = lane & 3;
  const int xbytes = K * XB, wbytes = PACKED ? K / 2 : K * XB;

  // This thread's copies of every chunk, fixed once: up to XP pieces of 16
  // x-code bytes (BM x CB/16 a stage) and up to WP of weight bytes (128 x
  // WB/16), each as a shared-memory offset (-1: no copy) and a source
  // offset (-1: past M or N, zero-filled), moved by the chunk's K offset;
  // and one scale (x's rows for tid < BM, then w's columns).  (The wrapper
  // keeps the M K and N K code bytes below 2^31.)
  constexpr int XP = BM * (kMmaChunkMax / 16) / kThreads;
  constexpr int WP = BN * (kMmaChunkMax / 16) / kThreads;
  const int xq = CB / 16, wq = WB / 16;
  int x_dst[XP], x_off[XP], w_dst[WP], w_off[WP];
#pragma unroll
  for (int i = 0; i < XP; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / xq, q = e - r * xq;
    x_dst[i] = e < BM * xq ? r * xrow + 16 * q : -1;
    x_off[i] = row0 + r < M ? (row0 + r) * xbytes + 16 * q : -1;
  }
#pragma unroll
  for (int i = 0; i < WP; ++i) {
    const int e = tid + i * kThreads;
    const int r = e / wq, q = e - r * wq;
    w_dst[i] = e < BN * wq ? BM * xrow + r * wrow + 16 * q : -1;
    w_off[i] = col0 + r < N ? (col0 + r) * wbytes + 16 * q : -1;
  }
  const int s_dst = BM * xrow + BN * wrow + 4 * tid;
  const bool s_live = tid < BM ? row0 + tid < M : col0 + tid - BM < N;
  const float* s_src = !s_live    ? sx
                       : tid < BM ? sx + (size_t)(row0 + tid) * G
                                  : sw + (size_t)(col0 + tid - BM) * G;
  auto load = [&](int t) {
    uint8_t* st = mma_ring + (t % kMmaStages) * stage;
    const int tc = g_lo * Q + t;
    const int k0 = tc * CB, wk0 = tc * WB;
#pragma unroll
    for (int i = 0; i < XP; ++i)
      if (x_dst[i] >= 0)
        cp_async16(st + x_dst[i], x_off[i] >= 0 ? xc + x_off[i] + k0 : xc,
                   x_off[i] >= 0);
#pragma unroll
    for (int i = 0; i < WP; ++i)
      if (w_dst[i] >= 0)
        cp_async16(st + w_dst[i], w_off[i] >= 0 ? wc + w_off[i] + wk0 : wc,
                   w_off[i] >= 0);
    if (tid < BM + BN)
      cp_async4(st + s_dst, s_live ? s_src + (Q == 1 ? tc : tc / Q) : sx,
                s_live);
  };

  for (int s = 0; s < kMmaStages - 1; ++s) {
    if (s < T) load(s);
    cp_async_commit();  // empty groups keep the count uniform
  }

  float acc[MT][NT][4];
  typename Codes::Sum p[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = 0.f;
        p[i][j][e] = 0;
      }

  for (int t = 0; t < T; ++t) {
    cp_async_wait<kMmaStages - 2>();  // this thread's copies of chunk t
    __syncthreads();  // everyone's; and stage (t - 1) % kMmaStages is free
    if (t + kMmaStages - 1 < T) load(t + kMmaStages - 1);
    cp_async_commit();

    const uint8_t* xs = mma_ring + (t % kMmaStages) * stage;
    const uint8_t* ws = xs + BM * xrow;
    const unsigned xa = (unsigned)__cvta_generic_to_shared(xs) +
                        (wm * WM + (lane & 15)) * xrow;
    for (int k = 0; k + 32 <= CB; k += 32) {  // k: a byte of the row
      uint32_t a[MT][4], b[NT][2];
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4(a[i], xa + 16 * i * xrow + k + 16 * (lane >> 4));
      if constexpr (PACKED) {
        // the codes k + 4 tig .. + 3 and k + 16 + 4 tig .. + 3 of column g
        // of each n8 tile: two bytes of packed nibbles each
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const uint8_t* wr = ws + (wn * WN + 8 * j + g) * wrow + k / 2 +
                              2 * tig;
          b[j][0] = nibbles_x16(*reinterpret_cast<const uint16_t*>(wr));
          b[j][1] = nibbles_x16(*reinterpret_cast<const uint16_t*>(wr + 8));
        }
      } else {
        const unsigned wa = (unsigned)__cvta_generic_to_shared(ws) +
                            (wn * WN + 8 * (lane >> 4) + (lane & 7)) * wrow +
                            k + 16 * ((lane >> 3) & 1);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t r[4];
          ldmatrix_x4(r, wa + 8 * j * wrow);
          b[j][0] = r[0];
          b[j][1] = r[1];
          b[j + 1][0] = r[2];
          b[j + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j) Codes::mma(p[i][j], a[i], b[j]);
    }
    if constexpr (XB == 1 && !PACKED) {
      if (CB % 32) {  // the last 16 int8 codes of the chunk
        const int k = CB - 16;
        uint32_t a[MT][2], b[NT];
#pragma unroll
        for (int i = 0; i < MT; ++i)
          ldmatrix_x2(a[i], xa + 16 * i * xrow + k);
        ldmatrix_x4(b, (unsigned)__cvta_generic_to_shared(ws) +
                           (wn * WN + 8 * (lane >> 3) + (lane & 7)) * wrow +
                           k);
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int j = 0; j < NT; ++j) mma_k16(p[i][j], a[i], b[j]);
      }
    }
    if ((t + 1) % Q == 0) {  // the group's last chunk: rescale and fold
      const float* ss =
          reinterpret_cast<const float*>(ws + BN * wrow);
      float sxv[2 * MT], swv[2 * NT];
#pragma unroll
      for (int i = 0; i < 2 * MT; ++i)
        sxv[i] = ss[wm * WM + 16 * (i >> 1) + g + 8 * (i & 1)];
#pragma unroll
      for (int j = 0; j < 2 * NT; ++j)
        swv[j] = ss[BM + wn * WN + 8 * (j >> 1) + 2 * tig + (j & 1)];
      fold_group<Codes>(acc, p, sxv, swv);
    }
  }
  cp_async_wait<0>();

  float* dst = S == 1 ? y : partial + (size_t)split * M * N;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + wm * WM + 16 * i + g + 8 * (e >> 1);
        const int col = col0 + wn * WN + 8 * j + 2 * tig + (e & 1);
        if (row < M && col < N) dst[(size_t)row * N + col] = acc[i][j][e];
      }
  if (S == 1) return;  // uniform over the grid

  // the last block of this tile to finish adds the partials in split
  // order, four columns a thread, the loads of up to 8 splits in flight
  __shared__ int is_last;
  const int tile = blockIdx.y * gridDim.x + blockIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&tickets[tile], 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  const size_t MN = (size_t)M * N;
  const bool vec = (N & 3) == 0;
  for (int e = tid; e < BM * BN / 4; e += kThreads) {
    const int row = row0 + e / (BN / 4), col = col0 + 4 * (e % (BN / 4));
    if (row >= M || col >= N) continue;
    const size_t off = (size_t)row * N + col;
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s0 = 0; s0 < S; s0 += 8) {
      float4 v[8];
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const float* src = partial + (size_t)(s0 + b) * MN + off;
        if (s0 + b >= S) continue;
        if (vec) {
          v[b] = __ldcg(reinterpret_cast<const float4*>(src));
        } else {
          v[b].x = __ldcg(src);
          v[b].y = col + 1 < N ? __ldcg(src + 1) : 0.f;
          v[b].z = col + 2 < N ? __ldcg(src + 2) : 0.f;
          v[b].w = col + 3 < N ? __ldcg(src + 3) : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < 8; ++b)
        if (s0 + b < S) {
          s[0] += v[b].x;
          s[1] += v[b].y;
          s[2] += v[b].z;
          s[3] += v[b].w;
        }
    }
    if (vec) {
      *reinterpret_cast<float4*>(y + off) = make_float4(s[0], s[1], s[2],
                                                        s[3]);
    } else {
      for (int c = 0; c < 4 && col + c < N; ++c) y[off + c] = s[c];
    }
  }
  if (tid == 0) tickets[tile] = 0;
}

// The launch of mma_contract_kernel: ``splits`` K splits of whole groups
// (partial: splits * M * N floats and tickets: one zero int per output
// tile, when splits > 1).  Returns a CUDA error.
template <typename Codes>
int launch_mma(const void* xc, const float* sx, const void* wc,
               const float* sw, float* y, float* partial, int* tickets,
               int M, int N, int K, int n, int splits, cudaStream_t stream) {
  constexpr int XB = Codes::kXBytes;
  constexpr bool PACKED = Codes::kPacked;
  const int G = n > 0 ? K / n : 0;
  if (n <= 0 || n % (PACKED ? 32 : 16) || K % n || splits < 1 ||
      splits > G + (G == 0) ||
      (splits > 1 && (partial == nullptr || tickets == nullptr)) ||
      (long long)M * K * XB >= (1ll << 31) ||
      (long long)N * K * XB >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const size_t smem = kMmaStages * mma_stage_bytes(
                                       kMmaBM, mma_chunk(n, XB, PACKED), XB,
                                       PACKED);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kern = &mma_contract_kernel<Codes>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + kMmaBN - 1) / kMmaBN, (M + kMmaBM - 1) / kMmaBM, splits);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(xc), sx, static_cast<const uint8_t*>(wc),
      sw, y, partial, tickets, M, N, K, n);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ stage 2, M <= 16 rows
// quant_decode_kernel: the whole call at decode, one launch.  Block (tile,
// split): 256 columns tile*256.. over groups [split*G/S, (split+1)*G/S),
// cut as the dense decode kernels cut them.  B bytes hold a column's codes
// of one group (n_pad int8 codes, or n_pad / 2 packed bytes), contiguous
// along K, so a split of a column is one run of T B bytes.
//   x   The block issues the loads of x's groups of its split, starts its
//       ring, then makes x's codes and scales in shared memory, a
//       half-warp per (group, row) and as quantize_rows_kernel makes them
//       (group max, bf16 scale, IEEE division, rintf, clip; pad codes and
//       rows at or past M zero), in the order its contraction reads them
//       (qd_make_x).
//   w   A ring of kQdStages stages streams each column's run in slices of
//       kQdSlice bytes (whole groups, or part of one): 16-byte cp.async
//       copies, a column's pieces on neighbouring lanes, each warp copying
//       the slices of its own 32 columns (so a __syncwarp, not a block
//       barrier, orders a stage), rows an odd number of 16-byte units apart
//       (conflict-free reads); beside them the f32 scales of the groups the
//       slice holds.  Any group length streams through the same stage.
//   sum DotContract (4, 8 or 16 rows): a thread per column reads its slice
//       16 bytes at a time against x's codes of the same k, which every
//       lane reads at one address, by __dp4a.  Packed bytes are split in
//       registers into their low and high nibbles, each moved to the top of
//       its byte (16 x the signed code, so a sum is 16 P and is shifted
//       back exactly), and x's codes are written in the order that meets
//       them (qd_x_slot).  An output's int32 group sum is exact and whole
//       after the group's last piece; then it is rescaled as ((float)P *
//       sx) * sw and added to the output's f32 sum.  Groups in order
//       within a split; qd_sum_splits adds the splits in split order.
// Why: at decode the call is bound by reading the weight's codes once (a
// packed wi,wg is 38.6 MB of codes against 0.06 MB of x).  The ring keeps
// each warp's next slice in flight while it contracts the current one; x's
// codes cost one prologue a block instead of a launch and an (M, K)
// scratch a call; splitting K into whole groups gives the narrow layers
// more blocks (k,v: 2 tiles x 8 splits; q,o and wo: 14 x 8), which still
// leaves them under one block an SM: more splits lengthen the tail that
// adds them and measured no better overall (PERF.md, with the sweep).  On
// a wide layer the prologue a block costs more than the split gains, and
// contract_kernel is used there instead.
constexpr int kQdBN = kThreads;        // columns per block
constexpr int kQdSlice = 128;          // bytes of a column's run a stage holds
constexpr int kQdRow = kQdSlice + 16;  // stage row: nine 16-byte units
constexpr int kQdStages = 2;           // ring depth

// bytes of one ring stage: 256 rows of a slice, then the f32 scales of the
// groups a slice can hold (kQdSlice / B, at least one), 256 a group
__host__ __device__ inline int qd_stage_bytes(int B) {
  const int groups = B < kQdSlice ? kQdSlice / B : 1;
  return kQdBN * (kQdRow + (int)sizeof(float) * groups);
}

// dynamic shared memory of a block: the ring, then x's (t_max, BM, n_pad)
// codes and (t_max, BM) scales, t_max the groups of the longest split
__host__ __device__ inline size_t qd_smem_bytes(int B, int BM, int n_pad,
                                                int t_max) {
  return (size_t)kQdStages * qd_stage_bytes(B) +
         (size_t)t_max * BM * (n_pad + sizeof(float));
}

// packed: where code r of 32 goes so that the x codes of a weight word's
// low nibbles (codes 8q, 8q + 2, 8q + 4, 8q + 6) are bytes 8q .. 8q + 3
// and those of its high nibbles bytes 8q + 4 .. 8q + 7
__device__ __forceinline__ int qd_x_slot(int r) {
  return (r & ~7) | ((r & 1) << 2) | ((r >> 1) & 3);
}

// Start the copies of slice k (bytes k kQdSlice .. of each column's run)
// into ring stage ``st``: the warp's 32 columns (at or past N: zero-filled),
// a column's pieces on neighbouring lanes, and each column's scales of the
// groups the slice holds (a group wider than a slice: its one group).
__device__ __forceinline__ void qd_load_slice(
    uint8_t* st, const uint8_t* __restrict__ wc, const float* __restrict__ ws,
    int N, int G, int B, int lgB, int col0, int g_lo, int run, int k) {
  constexpr int kPieces = kQdSlice / 16;
  const int b0 = k * kQdSlice;
  const int pieces = min(kQdSlice, run - b0) >> 4;
  const int lane = threadIdx.x & 31, wcol = threadIdx.x & ~31;
  const size_t off = (size_t)g_lo * B + b0;
#pragma unroll
  for (int it = 0; it < kPieces; ++it) {
    const int e = lane + 32 * it;
    const int c = wcol + e / kPieces, q = e % kPieces;
    const int col = col0 + c;
    const bool live = col < N;
    if (q < pieces)
      cp_async16(st + c * kQdRow + 16 * q,
                 live ? wc + (size_t)col * G * B + off + 16 * q : wc, live);
  }
  const int col = col0 + threadIdx.x;
  const bool live = col < N;
  const int g0 = b0 >> lgB;
  const int groups = B < kQdSlice ? (pieces * 16) >> lgB : 1;
  float* sd = reinterpret_cast<float*>(st + kQdBN * kQdRow);
  for (int j = 0; j < groups; ++j)
    cp_async4(sd + j * kQdBN + threadIdx.x,
              live ? ws + (size_t)col * G + g_lo + g0 + j : ws, live);
}

// A thread per column, __dp4a against each of BM rows.  x's codes of item
// it = (group gl, row m) = gl BM + m are n_pad bytes at it n_pad (packed:
// qd_x_slot order within each 32 codes).
template <int BM_, bool PACKED_>
struct DotContract {
  static constexpr int BM = BM_;
  static constexpr bool PACKED = PACKED_;
  float acc[BM];
  int p[BM];

  __device__ static int x_pos(int it, int i, int n_pad) {
    return it * n_pad + (PACKED ? qd_x_slot(i) : i);
  }
  __device__ void init() {
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      acc[m] = 0.f;
      p[m] = 0;
    }
  }
  // bytes b0 .. b0 + len of the column runs, in stage ``st``
  __device__ void slice(const uint8_t* st, const int8_t* xc, const float* xs,
                        int b0, int len, int B, int lgB, int n_pad, int M) {
    const int c = threadIdx.x;
    const float* sw = reinterpret_cast<const float*>(st + kQdBN * kQdRow);
    const int g0 = b0 >> lgB;
    const int pieces = len >> 4;
#pragma unroll
    for (int q = 0; q < kQdSlice / 16; ++q) {
      if (q >= pieces) break;  // uniform
      const int b = b0 + 16 * q;
      const int gl = b >> lgB, ob = b & (B - 1);
      const uint4 w4 =
          *reinterpret_cast<const uint4*>(st + c * kQdRow + 16 * q);
      const uint32_t w[4] = {w4.x, w4.y, w4.z, w4.w};
      const int8_t* xg = xc + gl * BM * n_pad + (PACKED ? 2 * ob : ob);
      if constexpr (PACKED) {
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          lo[i] = (w[i] << 4) & 0xF0F0F0F0u;  // 16 x the even codes
          hi[i] = w[i] & 0xF0F0F0F0u;         // 16 x the odd codes
        }
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const uint4* xp = reinterpret_cast<const uint4*>(xg + m * n_pad);
          const uint4 a = xp[0], e = xp[1];
          p[m] = __dp4a((int)lo[0], (int)a.x, p[m]);
          p[m] = __dp4a((int)hi[0], (int)a.y, p[m]);
          p[m] = __dp4a((int)lo[1], (int)a.z, p[m]);
          p[m] = __dp4a((int)hi[1], (int)a.w, p[m]);
          p[m] = __dp4a((int)lo[2], (int)e.x, p[m]);
          p[m] = __dp4a((int)hi[2], (int)e.y, p[m]);
          p[m] = __dp4a((int)lo[3], (int)e.z, p[m]);
          p[m] = __dp4a((int)hi[3], (int)e.w, p[m]);
        }
      } else {
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const uint4 a = *reinterpret_cast<const uint4*>(xg + m * n_pad);
          p[m] = __dp4a((int)w[0], (int)a.x, p[m]);
          p[m] = __dp4a((int)w[1], (int)a.y, p[m]);
          p[m] = __dp4a((int)w[2], (int)a.z, p[m]);
          p[m] = __dp4a((int)w[3], (int)a.w, p[m]);
        }
      }
      if (ob + 16 == B) {  // the group's last piece (uniform): fold
        const float swc = sw[(gl - g0) * kQdBN + c];
        const float* sx = xs + gl * BM;
#pragma unroll
        for (int m = 0; m < BM; ++m) {
          const int P = PACKED ? p[m] >> 4 : p[m];  // 16 P: exact
          acc[m] += ((float)P * sx[m]) * swc;
          p[m] = 0;
        }
      }
    }
  }
  __device__ void store(float* dst, int M, int N, int col0) const {
    const int col = col0 + threadIdx.x;
    if (col >= N) return;
#pragma unroll
    for (int m = 0; m < BM; ++m)
      if (m < M) dst[(size_t)m * N + col] = acc[m];
  }
};

// x's codes and scales of groups g_lo .. g_lo + T - 1 (item it = (group
// gl, row m) = gl BM + m: codes at C::x_pos, scale xs[it]) in the block's
// shared memory.  The ``region`` bytes (codes, then scales) start at zero
// (pad codes, rows at or past M); the live items are j = gl M + m.
// Groups of up to 64 values: a half-warp an item (lane h holds values h,
// h + 16, h + 32, h + 48), the block's 16 half-warps each loading up to
// eight items before making any, so that a batch costs one memory latency
// and its max-reductions and divisions overlap.  Longer groups: a warp an
// item.  ``start()`` (the ring's first copies) is called once, by every
// thread, after the first batch's loads are issued, so that its copies
// and those loads are in flight together.
template <typename C, typename Start>
__device__ __forceinline__ void qd_make_x(
    const float* __restrict__ x, int8_t* xc, float* xs, int region, int M,
    int G, int n, int n_pad, int g_lo, int T, const repro::QdqFormat& f,
    Start start) {
  constexpr int BM = C::BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint4* z = reinterpret_cast<uint4*>(xc);
  for (int e = threadIdx.x; e < region / 16; e += kThreads)
    z[e] = make_uint4(0u, 0u, 0u, 0u);
  const int items = T * M;  // >= 1
  const size_t K = (size_t)G * n;
  if (n <= 64) {
    constexpr int kHalves = kThreads / 16;  // items made at once
    constexpr int kBatch = 8;               // rounds of them loaded at once
    const int h = lane & 15, half = threadIdx.x >> 4;
    // the same trip count on every lane: the shuffles below take the
    // whole warp
    for (int base = 0; base < items; base += kBatch * kHalves) {
      const int j0 = base + half;
      // rounds of the batch with a live item (the same on every lane)
      const int rounds = min(kBatch, (items - base + kHalves - 1) / kHalves);
      float v[kBatch][4];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u >= rounds) break;
        const int j = j0 + u * kHalves;
        const bool live = j < items;
        const int gl = live ? j / M : 0, m = live ? j - gl * M : 0;
        const float* src = x + m * K + (size_t)(g_lo + gl) * n;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          v[u][q] = live && h + 16 * q < n ? __ldg(src + h + 16 * q) : 0.f;
      }
      if (base == 0) {
        start();
        __syncthreads();  // the zeros written before any code
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (u >= rounds) break;
        float amax = fmaxf(fmaxf(fabsf(v[u][0]), fabsf(v[u][1])),
                           fmaxf(fabsf(v[u][2]), fabsf(v[u][3])));
        for (int o = 8; o > 0; o >>= 1)  // within the half-warp
          amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
        const int j = j0 + u * kHalves;
        if (j < items) {  // uniform per half-warp
          const int gl = j / M, m = j - gl * M, it = gl * BM + m;
          const float s = repro::group_scale(amax, f.qmax);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int i = h + 16 * q;
            if (i < n)
              xc[C::x_pos(it, i, n_pad)] =
                  (int8_t)repro::int_code(v[u][q], s, f);
          }
          if (h == 0) xs[it] = s;
        }
      }
    }
  } else {
    start();
    __syncthreads();  // the zeros written before any code
    for (int j = warp; j < items; j += kWarpsPerBlock) {
      const int gl = j / M, m = j - gl * M, it = gl * BM + m;
      const float* src = x + m * K + (size_t)(g_lo + gl) * n;
      float amax = 0.f;
      for (int i = lane; i < n; i += 32) amax = fmaxf(amax, fabsf(src[i]));
      const float s = repro::group_scale(repro::warp_max(amax), f.qmax);
      for (int i = lane; i < n; i += 32)
        xc[C::x_pos(it, i, n_pad)] = (int8_t)repro::int_code(src[i], s, f);
      if (lane == 0) xs[it] = s;
    }
  }
}

// Split-K epilogue of quant_decode_kernel, as sum_split_partials: the last
// block of a tile to arrive (an integer ticket) adds the S partials in
// split order into y, a thread per column with every row's loads of
// several splits issued together, and resets the ticket.
template <int BM>
__device__ __forceinline__ void qd_sum_splits(
    const float* __restrict__ partial, int* __restrict__ tickets,
    float* __restrict__ y, int M, int N, int col0, int S) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&tickets[blockIdx.x], 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  constexpr int kBatch = 32 / BM;  // splits loaded together
  const int col = col0 + threadIdx.x;
  if (col < N) {
    float sum[BM];
#pragma unroll
    for (int m = 0; m < BM; ++m) sum[m] = 0.f;
    for (int s0 = 0; s0 < S; s0 += kBatch) {
      float p[kBatch][BM];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
#pragma unroll
        for (int m = 0; m < BM; ++m)
          p[b][m] = s0 + b < S && m < M
                        ? __ldcg(partial + ((size_t)(s0 + b) * M + m) * N +
                                 col)
                        : 0.f;
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (s0 + b < S)
#pragma unroll
          for (int m = 0; m < BM; ++m) sum[m] += p[b][m];
    }
#pragma unroll
    for (int m = 0; m < BM; ++m)
      if (m < M) y[(size_t)m * N + col] = sum[m];
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

template <typename C>
__global__ void __launch_bounds__(kThreads, C::BM == 4 ? 3 : 2)
quant_decode_kernel(const float* __restrict__ x,      // (M, K) f32
                    const uint8_t* __restrict__ wc,  // (N, G, B) codes
                    const float* __restrict__ ws,    // (N, G) scales
                    float* __restrict__ y,           // (M, N)
                    float* __restrict__ partial,     // (S, M, N) when S > 1
                    int* __restrict__ tickets,       // one per tile, zero
                    int M, int N, int G, int n, int n_pad, int t_max,
                    float qmax, float qmin) {
  constexpr int BM = C::BM;
  extern __shared__ __align__(16) uint8_t qd_smem[];
  const repro::QdqFormat f{1, qmax, qmin, 0, 0, 0};
  const int B = C::PACKED ? n_pad / 2 : n_pad;  // a power of two >= 16
  const int lgB = __ffs(B) - 1;
  const int stage = qd_stage_bytes(B);
  int8_t* xc = reinterpret_cast<int8_t*>(qd_smem + kQdStages * stage);
  float* xs = reinterpret_cast<float*>(xc + (size_t)t_max * BM * n_pad);
  const int S = gridDim.y, split = blockIdx.y;
  const int col0 = blockIdx.x * kQdBN;
  const int g_lo = (int)((long long)split * G / S);
  const int T = (int)((long long)(split + 1) * G / S) - g_lo;
  const int run = T * B;  // bytes of a column's split
  const int slices = (run + kQdSlice - 1) / kQdSlice;

  qd_make_x<C>(x, xc, xs, t_max * BM * (n_pad + 4), M, G, n, n_pad, g_lo, T,
               f, [&] {
                 for (int s = 0; s < kQdStages - 1; ++s) {
                   if (s < slices)
                     qd_load_slice(qd_smem + s * stage, wc, ws, N, G, B,
                                   lgB, col0, g_lo, run, s);
                   cp_async_commit();  // empty groups keep the count uniform
                 }
               });
  __syncthreads();  // x's codes, for every thread

  C con;
  con.init();
  for (int k = 0; k < slices; ++k) {
    // a warp copies and reads only its own columns' slices
    cp_async_wait<kQdStages - 2>();  // this thread's copies of slice k
    __syncwarp();  // the warp's; and its reads of stage k - 1 are done
    const int nk = k + kQdStages - 1;
    if (nk < slices)
      qd_load_slice(qd_smem + (nk % kQdStages) * stage, wc, ws, N, G, B, lgB,
                    col0, g_lo, run, nk);
    cp_async_commit();
    con.slice(qd_smem + (k % kQdStages) * stage, xc, xs, k * kQdSlice,
              min(kQdSlice, run - k * kQdSlice), B, lgB, n_pad, M);
  }
  cp_async_wait<0>();

  con.store(S == 1 ? y : partial + (size_t)split * M * N, M, N, col0);
  if (S == 1) return;  // uniform over the grid
  qd_sum_splits<BM>(partial, tickets, y, M, N, col0, S);
}

// The launch of quant_decode_kernel on plan_quant_decode's grid: 256-column
// tiles x ``splits`` K splits, the longest ``t_max`` groups (partial:
// splits * M * N floats and tickets: one zero int per tile, when splits >
// 1).  Returns a CUDA error.
template <typename C>
int launch_quant_decode(const float* x, const uint8_t* wc, const float* ws,
                        float* y, float* partial, int* tickets, int M, int N,
                        int G, int n, int n_pad, int splits, int t_max,
                        float qmax, float qmin, cudaStream_t stream) {
  const int B = C::PACKED ? n_pad / 2 : n_pad;
  const size_t smem = qd_smem_bytes(B, C::BM, n_pad, t_max);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kern = &quant_decode_kernel<C>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((N + kQdBN - 1) / kQdBN, splits);
  kern<<<grid, kThreads, smem, stream>>>(x, wc, ws, y, partial, tickets, M,
                                         N, G, n, n_pad, t_max, qmax, qmin);
  return (int)cudaGetLastError();
}

template <bool PACKED>
int launch_quant_decode_rows(const float* x, const uint8_t* wc,
                             const float* ws, float* y, float* partial,
                             int* tickets, int M, int N, int G, int n,
                             int n_pad, int splits, int t_max, float qmax,
                             float qmin, cudaStream_t stream) {
  if (M <= 4)
    return launch_quant_decode<DotContract<4, PACKED>>(
        x, wc, ws, y, partial, tickets, M, N, G, n, n_pad, splits, t_max,
        qmax, qmin, stream);
  if (M <= 8)
    return launch_quant_decode<DotContract<8, PACKED>>(
        x, wc, ws, y, partial, tickets, M, N, G, n, n_pad, splits, t_max,
        qmax, qmin, stream);
  return launch_quant_decode<DotContract<16, PACKED>>(
      x, wc, ws, y, partial, tickets, M, N, G, n, n_pad, splits, t_max, qmax,
      qmin, stream);
}

}  // namespace

// x: (M, K) f32, K = G * n.  wc: (N, G * n_pad) int8 codes or (N, G *
// n_pad / 2) packed nibbles, each group zero-padded to n_pad (a multiple of
// 16, packed 32, >= n), 16-byte aligned.  ws: (N, G) f32.  y: (M, N) f32.
// ``splits`` K splits of whole groups (partial: splits*M*N floats and
// tickets: one zero int per output tile, when splits > 1).  ``kernel``:
//   0  quant_decode_kernel alone (M <= 16; n_pad = 16, packed 32, times a
//      power of two <= 32), ``t_max`` groups in its longest split
//      (plan_quant_decode); the scratch pointers are unused;
//   1  quantize_rows_kernel (xc_scratch: M*G*n_pad bytes, sx_scratch: M*G
//      floats), then contract_kernel (M <= 4, the same group lengths, one
//      split);
//   2  quantize_rows_kernel, then mma_contract_kernel (64 rows a block).
// Returns a CUDA error.
extern "C" int repro_quant_matmul(const void* x, const void* wc,
                                  const void* ws, void* xc_scratch,
                                  void* sx_scratch, void* partial,
                                  void* tickets, void* y, int M, int N,
                                  int K, int n, int n_pad, int packed,
                                  int kernel, int splits, int t_max,
                                  float qmax, float qmin,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int step = packed ? 32 : 16;  // codes of a 16-byte piece
  const int lpg = n_pad / step;
  if (n <= 0 || K % n || n_pad < n || n_pad % step || kernel < 0 ||
      kernel > 2 || (kernel < 2 && ((lpg & (lpg - 1)) || lpg > 32)) ||
      (kernel == 1 && (M > 4 || splits != 1)))
    return (int)cudaErrorInvalidValue;
  const int G = K / n;
  const int K_pad = G * n_pad;
  const uint8_t* w = static_cast<const uint8_t*>(wc);
  const float* s = static_cast<const float*>(ws);
  float* out = static_cast<float*>(y);
  float* part = static_cast<float*>(partial);
  int* tick = static_cast<int*>(tickets);
  if (kernel == 0) {
    if (M < 1 || M > 16 || splits < 1 || splits > G + (G == 0) ||
        t_max < (G + splits - 1) / splits || t_max < 1 ||
        (splits > 1 && (partial == nullptr || tickets == nullptr)))
      return (int)cudaErrorInvalidValue;
    const float* xf = static_cast<const float*>(x);
    return packed ? launch_quant_decode_rows<true>(xf, w, s, out, part, tick,
                                                   M, N, G, n, n_pad, splits,
                                                   t_max, qmax, qmin, stream)
                  : launch_quant_decode_rows<false>(xf, w, s, out, part,
                                                    tick, M, N, G, n, n_pad,
                                                    splits, t_max, qmax, qmin,
                                                    stream);
  }
  const repro::QdqFormat f{1, qmax, qmin, 0, 0, 0};
  int8_t* xc = static_cast<int8_t*>(xc_scratch);
  float* sx = static_cast<float*>(sx_scratch);
  int err = launch_quantize_rows(static_cast<const float*>(x), xc, sx,
                                 (long long)M * G, n, n_pad, f, stream);
  if (err != (int)cudaSuccess) return err;
  if (kernel == 1) {
    launch_contract<4, 4>(xc, sx, w, s, out, M, N, K_pad, n_pad, packed != 0,
                          stream);
    return (int)cudaGetLastError();
  }
  return packed ? launch_mma<Int4PackedCodes>(xc, sx, w, s, out, part, tick,
                                              M, N, K_pad, n_pad, splits,
                                              stream)
                : launch_mma<Int8Codes>(xc, sx, w, s, out, part, tick, M, N,
                                        K_pad, n_pad, splits, stream);
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
// What bounds them on this card: at decode (M <= 16 rows) reading the f32
// weight once from device memory (4 K N bytes; the QDQ costs about 16
// instructions per weight element and the contraction M FMAs, which the
// CUDA cores do in well under the byte time at M = 4 and in about the
// byte time at M = 16); above 16 rows, with the contraction on the tensor
// cores, reading the f32 weight once too (wi,wg at M = 192: 0.086 ms of
// bytes against 0.026 ms of bf16 tensor-core operations), plus the code
// scratch each call writes and reads back (2 + 2 bytes a weight element in
// bf16, 1 + 1 in int8).
//
// Both take every n that divides K.  Outside the decode kernels' n = 32
// and 64, the codes of each group are zero-padded to n_pad (n rounded up
// to a multiple of 16) in the code scratch; a zero code adds exactly 0.
//
// abfp_matmul.  The wrapper's plan_abfp_matmul chooses the regime:
//
//   decode (M <= 16, n = 32 or 64: qdq_stream_kernel, fp_decode_kernel).
//   qdq_stream_kernel (abfp_qdq's kernel, planned by plan_qdq) QDQs x
//   once into scratch (x is read by every column block).  A block owns 64 columns and one K split of whole groups; the
//   grid is (column tiles) x (splits), with enough splits for two waves of
//   blocks on the 132 SMs and, while a split keeps two groups, for up to
//   eight (k,v: 8 tiles x 33 splits; q,o and wo: 56 x 19; wi,wg: 296 x 4);
//   short blocks even out the tail.  The block streams its (n, 64) w tiles
//   and (BM, n) x tiles through a ring of kStages shared-memory stages
//   with 16-byte cp.async copies (4-byte ones when a row of w is not
//   16-byte aligned), so while one group is QDQ'd and contracted the next
//   kStages - 1 are in flight; one barrier per group.  Thread layout: the
//   16 lanes of a half-warp share 4 adjacent columns, lane p taking rows
//   p, p + 16, ...; a column group's max is reduced with __shfl_xor_sync
//   over those 16 lanes (no shared-memory round trip).  Rows are padded by
//   4 floats, so the 16-byte reads of 8 consecutive rows by a quarter-warp
//   hit 8 distinct bank groups.  The weight is QDQ'd with group_scale /
//   qdq_value of abfp_qdq.cuh (true IEEE division): bit for bit the plain
//   version's.  Each split writes its (M, 64) partial to an (S, M, N)
//   scratch; the last block of a column tile to arrive (an integer ticket
//   it resets) sums the S partials in split order: deterministic, no float
//   atomics.  With one split the block writes y itself.
//
//   prefill (every other M and n, for formats whose unit codes bf16 holds:
//   quantize_rows_kernel<bf16>, quantize_cols_kernel<bf16>,
//   mma_contract_kernel<Bf16Codes>).  Write x = u sx and w = v sw with u, v
//   the unit codes qdq_unit returns and sx, sw the group scales: then y =
//   sum_g (P_g sx_g) sw_g with P_g = sum_k u_k v_k.  The first two launches
//   write the unit codes as bf16 (exact: integers of magnitude <= 256 or
//   minifloat grid points of <= 8 significant bits in bf16's exponent
//   range; the planner names the rule) and the f32 scales, w's transposed
//   and coalesced as abfp_matmul_int8's int8 codes are; the third forms
//   each P_g on the bf16 tensor cores with f32 sums and folds it, as the
//   int8 contraction does.  The plain version multiplies QDQ'd values
//   instead; the two differ only in f32 rounding (the rounding of u * sx
//   and the summation order), which the reference leaves free.  For int
//   codes P_g is exact, so the result is bit for bit abfp_matmul_int8's
//   prefill regime's on the same formats.
//
//   simt (a format whose unit codes bf16 cannot hold: an int format of
//   more than 9 bits, a minifloat with more than 7 mantissa bits:
//   qdq_stream_kernel, fp_contract_kernel).  An f32 SIMT tiled contraction:
//   per group a block loads a (BM, n) QDQ'd x tile and an (n, 64) w tile
//   into shared memory, QDQs the 64 column groups of the w tile in place
//   (a column's max reduced over 4 threads through shared memory), then
//   every thread accumulates its TM x 4 outputs (BM = 64, or 32 where a
//   long group would not fit).  w crosses the memory bus once per row
//   block.  Each group's partial sum is added to the running total once.
//
// abfp_matmul_int8.  Stage 1, quantize_rows_kernel, writes x's int8 codes
// and scales per (row, group) to scratch (M K bytes: negligible).  Stage 2
// depends on the regime (plan_abfp_matmul(..., int8=True) chooses it):
//
//   decode (M <= 16, n = 32 or 64, int8_decode_kernel).  Bound, like
//   abfp_matmul's, by reading the f32 weight once (4 K N bytes).  No (N, K)
//   code scratch: each block streams its (n, 64) f32 w tiles, its (BM, n)
//   x codes and BM x scales through the same 4-stage cp.async ring, makes
//   the weight's int codes on chip and contracts them with __dp4a in the
//   same pass.  Four neighbouring lanes share a column, each holding a
//   quarter of its group in registers: the column max is two shuffles, and
//   a row's exact int32 group sum is whole after two rounds of shuffles
//   that leave each row with one lane.  Split partials, tickets and the
//   split-order sum are fp_decode_kernel's.  Two launches a call.
//
//   prefill (every other M and n: quantize_cols_kernel<int8>, then
//   mma_contract_kernel<Int8Codes> above).  quantize_cols_kernel writes
//   w's codes transposed, (N, K_pad), and scales (N, G) once: a block
//   stages whole groups x 32 columns in shared memory and each warp writes
//   a column's codes as contiguous runs of >= 128 bytes.  The contraction
//   runs on the int8 tensor cores; at M = 192 its operations (0.013 ms at
//   wi,wg) take less than the f32 weight's bytes, which quantize_cols_kernel
//   reads (0.081 ms).  Three launches a call.
//
// Summation order, all regimes but simt: a (row, column, group) sum of
// code products is exact (int32, or an integer-valued f32 for int codes
// in bf16), rescaled as (P * sx) * sw (never sx * sw folded: the reference
// multiplies in that order).  Each output's f32 sum adds its groups in
// order within a K split, then the split partials in split order (decode:
// the last block of a 64-column tile; prefill: the last block of a 64 x
// 128 tile).  decode adds per lane first: each lane adds its R-row share
// of a group to its own sum, and after the last group the 16 lanes of a
// column are summed by a shuffle tree.  Either way the f32 rounding error
// of K = 18944 terms stays near that of a pairwise sum.
// ===========================================================================
namespace {

// w (K, N) f32 -> unit codes wc (N, G * n_pad) (int8, or bf16) and scales
// sw (N, G), the layout the contractions read (a column's codes
// contiguous, each group zero-padded from n to n_pad).  A block owns
// kColTile columns and GB = rows / n whole groups, rows = max(128, n):
//   1. it reads the (GB n, 32) f32 tile row by row (a warp reads 128
//      contiguous bytes, a thread keeps 16 loads in flight) into shared
//      memory;
//   2. one thread per (group, column) forms the group's scale;
//   3. one thread per (word, column) makes the codes of one 32-bit word of
//      the column's padded codes (4 int8 or 2 bf16; zero in the pad) in a
//      (32, GB n_pad / CPW + 1) code tile (the odd row length keeps the 32
//      columns of a warp's writes on 32 banks);
//   4. a warp per column writes that column's GB n_pad codes, contiguous in
//      wc, as whole words: runs of >= 128 bytes, whole 32-byte sectors
//      (shorter only where K itself is shorter).
// The codes and scales are those of one thread per (group, column) with
// group_scale / qdq_unit: the same bits at any tiling.
constexpr int kColTile = 32;   // columns per block
constexpr int kColRows = 128;  // tile rows when n <= 128
constexpr int kLoads = 16;     // loads a thread keeps in flight

__host__ __device__ constexpr int col_tile_rows(int n) {
  return n > kColRows ? n : kColRows;
}

// 32-bit words of a column's codes in the code tile (odd)
__host__ __device__ constexpr int col_tile_words(int n, int n_pad,
                                                 int code_bytes) {
  return (col_tile_rows(n) / n) * n_pad * code_bytes / 4 + 1;
}

__host__ __device__ constexpr size_t col_tile_smem(int n, int n_pad,
                                                   int code_bytes) {
  return sizeof(float) * ((size_t)col_tile_rows(n) * kColTile +
                          (size_t)(col_tile_rows(n) / n) * kColTile +
                          (size_t)kColTile *
                              col_tile_words(n, n_pad, code_bytes));
}

template <typename T, bool INT>
__global__ void __launch_bounds__(kThreads)
quantize_cols_kernel(const float* __restrict__ w, T* __restrict__ wc,
                     float* __restrict__ sw, int K, int N, int n, int n_pad,
                     repro::QdqFormat f) {
  constexpr int CPW = 4 / sizeof(T);  // codes a 32-bit word
  extern __shared__ __align__(16) float tile[];  // [rows][kColTile]
  const int rows = col_tile_rows(n);
  const int GB = rows / n;
  const int cw = col_tile_words(n, n_pad, sizeof(T));
  float* scale = tile + rows * kColTile;                   // [GB][kColTile]
  uint32_t* codes = reinterpret_cast<uint32_t*>(scale + GB * kColTile);
  const int G = K / n;
  const int g0 = blockIdx.y * GB;
  const int ng = min(GB, G - g0);  // groups of this tile
  const int nr = ng * n;           // rows of this tile
  const int k0 = g0 * n;
  const int col0 = blockIdx.x * kColTile;
  const int tid = threadIdx.x;

  // kLoads loads of a thread in flight together (a load followed by its
  // store would wait out one memory latency per element)
  const int col = col0 + (tid % kColTile);
  for (int e0 = tid; e0 < nr * kColTile; e0 += kLoads * kThreads) {
    float v[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = e0 + i * kThreads;
      v[i] = e < nr * kColTile && col < N
                 ? __ldg(w + (size_t)(k0 + e / kColTile) * N + col)
                 : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i)
      if (e0 + i * kThreads < nr * kColTile) tile[e0 + i * kThreads] = v[i];
  }
  __syncthreads();
  for (int e = tid; e < ng * kColTile; e += kThreads) {
    const int g = e / kColTile, c = e - g * kColTile;
    const float* src = tile + g * n * kColTile + c;
    float m4[4] = {0.f, 0.f, 0.f, 0.f};  // four independent chains
    int i = 0;
    for (; i + 4 <= n; i += 4)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m4[k] = fmaxf(m4[k], fabsf(src[(i + k) * kColTile]));
    for (; i < n; ++i) m4[0] = fmaxf(m4[0], fabsf(src[i * kColTile]));
    const float amax = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
    scale[e] = repro::group_scale(amax, f.qmax);
  }
  __syncthreads();
  const int words = ng * n_pad / CPW;  // n_pad % 16 == 0: whole words
  for (int e = tid; e < words * kColTile; e += kThreads) {
    const int q = e / kColTile, c = e - q * kColTile;
    // padded position k of the word's first code: group g, row r of the
    // tile, offset k - g n_pad in the group
    const int k = q * CPW, g = k / n_pad, r = k - g * (n_pad - n);
    const float s = scale[g * kColTile + c];
    uint32_t word = 0u;
    if (k - g * n_pad + CPW <= n) {  // real codes only (uniform per warp)
#pragma unroll
      for (int b = 0; b < CPW; ++b)
        word |= code_bits<T>(unit_code<INT>(tile[(r + b) * kColTile + c], s,
                                            f))
                << (32 / CPW * b);
    } else {  // a word that reaches into the pad
      for (int b = 0; b < CPW && k - g * n_pad + b < n; ++b)
        word |= code_bits<T>(unit_code<INT>(tile[(r + b) * kColTile + c], s,
                                            f))
                << (32 / CPW * b);
    }
    codes[c * cw + q] = word;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  const int K_pad = G * n_pad;  // N K_pad code bytes < 2^31 (the planner)
  for (int c = warp; c < kColTile; c += kWarpsPerBlock) {
    const int col = col0 + c;
    if (col >= N) break;  // uniform per warp; columns ascend
    uint32_t* dst =
        reinterpret_cast<uint32_t*>(wc + (size_t)col * K_pad + g0 * n_pad);
    for (int q = lane; q < words; q += 32) dst[q] = codes[c * cw + q];
    if (lane < ng)
      sw[(size_t)col * G + g0 + lane] = scale[lane * kColTile + c];
    if (GB > 32)  // n < 4
      for (int g = lane + 32; g < ng; g += 32)
        sw[(size_t)col * G + g0 + g] = scale[g * kColTile + c];
  }
}

// w's codes and scales on the caller's stream.  Returns a CUDA error.
template <typename T>
int launch_quantize_cols(const float* w, T* wc, float* sw, int K, int N,
                         int n, int n_pad, const repro::QdqFormat& f,
                         cudaStream_t stream) {
  const int G = K / n;
  if (G == 0 || N == 0) return (int)cudaSuccess;
  const size_t smem = col_tile_smem(n, n_pad, sizeof(T));
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  auto kern = quantize_cols_kernel<T, true>;
  if constexpr (sizeof(T) > 1)
    if (!f.is_int) kern = quantize_cols_kernel<T, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int GB = col_tile_rows(n) / n;
  dim3 grid((N + kColTile - 1) / kColTile, (G + GB - 1) / GB);
  kern<<<grid, kThreads, smem, stream>>>(w, wc, sw, K, N, n, n_pad, f);
  return (int)cudaGetLastError();
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

// ------------------------------------------------------------ decode regime
constexpr int kDecBN = 64;                   // columns per block
constexpr int kDecStride = kDecBN + 4;       // floats per w tile row (padded)
constexpr int kStages = 4;                   // shared-memory ring depth
constexpr int kRowLanes = 16;                // lanes sharing 4 columns

// Start the copies of one group's (n, 64) w tile at rows k0.. into ``ws``
// (row stride kDecStride), NT threads sharing them.  Columns at or past N
// are zero-filled (source size 0).  VEC: N % 4 == 0 and w 16-byte aligned,
// so a 16-byte chunk of a row is wholly inside or outside the matrix.
template <int n, bool VEC, int NT>
__device__ __forceinline__ void load_w_tile(float* ws,
                                            const float* __restrict__ w,
                                            int N, int col0, int k0) {
  const int tid = threadIdx.x;
  if constexpr (VEC) {
    constexpr int kChunks = kDecBN / 4;  // 16-byte chunks per tile row
    for (int c = tid; c < n * kChunks; c += NT) {
      const int r = c / kChunks, q = c - r * kChunks;
      const int col = col0 + 4 * q;
      const bool live = col < N;
      cp_async16(ws + r * kDecStride + 4 * q,
                 live ? w + (size_t)(k0 + r) * N + col : w, live);
    }
  } else {
    for (int e = tid; e < n * kDecBN; e += NT) {
      const int r = e / kDecBN, c = e - r * kDecBN;
      const int col = col0 + c;
      const bool live = col < N;
      cp_async4(ws + r * kDecStride + c,
                live ? w + (size_t)(k0 + r) * N + col : w, live);
    }
  }
}

// Start the copies of one group into ring stage ``st``: the w tile, then
// the (BM, n) x tile; rows at or past M are zero-filled.
template <int BM, int R, bool VEC>
__device__ __forceinline__ void load_decode_stage(
    float* st, const float* __restrict__ xq, const float* __restrict__ w,
    int M, int N, int K, int col0, int k0) {
  constexpr int n = kRowLanes * R;
  load_w_tile<n, VEC, kThreads>(st, w, N, col0, k0);
  float* xs = st + n * kDecStride;
  constexpr int chunks = n / 4;  // x rows 16-byte aligned: K % n == 0
  for (int c = threadIdx.x; c < BM * chunks; c += kThreads) {
    const int m = c / chunks, q = c - m * chunks;
    const bool live = m < M;
    cp_async16(xs + m * n + 4 * q,
               live ? xq + (size_t)m * K + k0 + 4 * q : xq, live);
  }
}

// Split-K epilogue of the decode kernels, after every block has written
// its (M, 64) partial to ``partial`` (S, M, N): the last block of column
// tile blockIdx.x to arrive (an integer ticket) adds the S partials in
// split order into y and resets the tile's ticket for the next launch.
// No float atomics: the sum is the same bits on every run.
template <int NT>
__device__ __forceinline__ void sum_split_partials(
    const float* __restrict__ partial, int* __restrict__ tickets,
    float* __restrict__ y, int M, int N, int col0, int S) {
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    is_last = atomicAdd(&tickets[blockIdx.x], 1) == S - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  constexpr int kBatch = 8;  // partials loaded together, added in order
  for (int e = threadIdx.x; e < M * kDecBN; e += NT) {
    const int m = e / kDecBN, col = col0 + (e - m * kDecBN);
    if (col >= N) continue;
    const float* src = partial + (size_t)m * N + col;
    float s = 0.f;
    for (int s0 = 0; s0 < S; s0 += kBatch) {
      float p[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        p[b] = s0 + b < S ? __ldcg(src + (size_t)(s0 + b) * M * N) : 0.f;
#pragma unroll
      for (int b = 0; b < kBatch; ++b)
        if (s0 + b < S) s += p[b];
    }
    y[(size_t)m * N + col] = s;
  }
  if (threadIdx.x == 0) tickets[blockIdx.x] = 0;
}

// Block (tile, split): columns tile*64.. over groups [split*G/S,
// (split+1)*G/S).  Thread: 4 adjacent columns (its half-warp's), rows
// part, part + 16, ... of every group (n = 16 R, R = 2 or 4), held in
// registers between the max and the QDQ.  INT: the weight format is an
// integer grid (the format's branch is resolved at compile time; fw is
// otherwise used as given): on an H100 2.3 % faster over an M = 4 forward
// pass and 6-7 % at M = 16 than one kernel for every format (PERF.md).
// Blocks an SM: 3 at BM = 4, 2 at BM = 8, 1 at BM = 16, whose 2 x 64 sums
// a thread need more registers.
template <int BM, int R, bool VEC, bool INT>
__global__ void __launch_bounds__(kThreads, BM == 4 ? 3 : BM == 8 ? 2 : 1)
fp_decode_kernel(const float* __restrict__ xq,  // (M, K) QDQ'd x
                 const float* __restrict__ w,   // (K, N) raw weight
                 float* __restrict__ y,         // (M, N)
                 float* __restrict__ partial,   // (S, M, N) when S > 1
                 int* __restrict__ tickets,     // one per tile, zero
                 int M, int N, int K, repro::QdqFormat fw) {
  constexpr int n = kRowLanes * R;
  constexpr int stage = n * kDecStride + BM * n;
  extern __shared__ __align__(16) float ring[];
  repro::QdqFormat f = fw;
  f.is_int = INT;
  const int S = gridDim.y, split = blockIdx.y;
  const int col0 = blockIdx.x * kDecBN;
  const int G = K / n;
  const int g_lo = (int)((long long)split * G / S);
  const int T = (int)((long long)(split + 1) * G / S) - g_lo;
  const int lane = threadIdx.x & 31;
  const int part = lane & (kRowLanes - 1);
  const int c4 = ((threadIdx.x >> 5) * 2 + (lane >> 4)) * 4;

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T)
      load_decode_stage<BM, R, VEC>(ring + s * stage, xq, w, M, N, K, col0,
                                    (g_lo + s) * n);
    cp_async_commit();  // empty groups keep the count uniform
  }

  float acc[BM][4];
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int t = 0; t < T; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of group t landed
    __syncthreads();  // everyone's; and stage (t - 1) % kStages is free
    const int nt = t + kStages - 1;
    if (nt < T)
      load_decode_stage<BM, R, VEC>(ring + (nt % kStages) * stage, xq, w, M,
                                    N, K, col0, (g_lo + nt) * n);
    cp_async_commit();

    const float* ws = ring + (t % kStages) * stage + part * kDecStride + c4;
    const float* xs = ring + (t % kStages) * stage + n * kDecStride + part;
    float v[R][4];
    float amax[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const float4 u =
          *reinterpret_cast<const float4*>(ws + kRowLanes * i * kDecStride);
      v[i][0] = u.x;
      v[i][1] = u.y;
      v[i][2] = u.z;
      v[i][3] = u.w;
#pragma unroll
      for (int j = 0; j < 4; ++j) amax[j] = fmaxf(amax[j], fabsf(v[i][j]));
    }
    float sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int o = 1; o < kRowLanes; o <<= 1)
        amax[j] = fmaxf(amax[j], __shfl_xor_sync(0xffffffffu, amax[j], o));
      sc[j] = repro::group_scale(amax[j], f.qmax);
    }

    float ps[BM][4];
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) ps[m][j] = 0.f;
#pragma unroll
    for (int i = 0; i < R; ++i) {
      float q[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) q[j] = repro::qdq_value(v[i][j], sc[j], f);
#pragma unroll
      for (int m = 0; m < BM; ++m) {
        const float xv = xs[m * n + kRowLanes * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) ps[m][j] = fmaf(xv, q[j], ps[m][j]);
      }
    }
#pragma unroll
    for (int m = 0; m < BM; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] += ps[m][j];
  }
  cp_async_wait<0>();

  // sum over the 16 lanes of the half-warp (the rows); every lane ends
  // with the same bits, the lane of part 0 writes
#pragma unroll
  for (int m = 0; m < BM; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      for (int o = 1; o < kRowLanes; o <<= 1)
        acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], o);
  float* dst = S == 1 ? y : partial + (size_t)split * M * N;
  if (part == 0) {
#pragma unroll
    for (int m = 0; m < BM; ++m) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col0 + c4 + j;
        if (m < M && col < N) dst[(size_t)m * N + col] = acc[m][j];
      }
    }
  }
  if (S == 1) return;  // uniform over the grid
  sum_split_partials<kThreads>(partial, tickets, y, M, N, col0, S);
}

template <int BM, int R, bool VEC, bool INT>
int launch_fp_decode(const float* xq, const float* w, float* y,
                     float* partial, int* tickets, int M, int N, int K,
                     int splits, const repro::QdqFormat& fw,
                     cudaStream_t stream) {
  constexpr int n = kRowLanes * R;
  const size_t smem =
      sizeof(float) * kStages * ((size_t)n * kDecStride + (size_t)BM * n);
  auto kern = fp_decode_kernel<BM, R, VEC, INT>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + kDecBN - 1) / kDecBN, splits);
  kern<<<grid, kThreads, smem, stream>>>(xq, w, y, partial, tickets, M, N,
                                         K, fw);
  return (int)cudaGetLastError();
}

template <int BM, int R>
int launch_fp_decode_as(const float* xq, const float* w, float* y,
                        float* partial, int* tickets, int M, int N, int K,
                        int splits, bool vec, const repro::QdqFormat& fw,
                        cudaStream_t stream) {
  if (vec)
    return fw.is_int ? launch_fp_decode<BM, R, true, true>(
                           xq, w, y, partial, tickets, M, N, K, splits, fw,
                           stream)
                     : launch_fp_decode<BM, R, true, false>(
                           xq, w, y, partial, tickets, M, N, K, splits, fw,
                           stream);
  return fw.is_int ? launch_fp_decode<BM, R, false, true>(
                         xq, w, y, partial, tickets, M, N, K, splits, fw,
                         stream)
                   : launch_fp_decode<BM, R, false, false>(
                         xq, w, y, partial, tickets, M, N, K, splits, fw,
                         stream);
}

template <int BM>
int launch_fp_decode_rows(const float* xq, const float* w, float* y,
                          float* partial, int* tickets, int M, int N, int K,
                          int n, int splits, bool vec,
                          const repro::QdqFormat& fw, cudaStream_t stream) {
  return n == 32 ? launch_fp_decode_as<BM, 2>(xq, w, y, partial, tickets, M,
                                               N, K, splits, vec, fw, stream)
                 : launch_fp_decode_as<BM, 4>(xq, w, y, partial, tickets, M,
                                               N, K, splits, vec, fw, stream);
}

// ------------------------------------------- abfp_matmul_int8, decode regime
constexpr int kTPC = 4;  // threads sharing a column of the 64-column tile

// Floats of one ring stage: the (n, 64) f32 w tile (rows padded to
// kDecStride), the (BM, n) int8 x codes and the BM x scales of one group.
template <int BM, int n>
__host__ __device__ constexpr int int8_stage_floats() {
  return n * kDecStride + BM * n / 4 + BM;
}

// Start the copies of group g into ring stage ``st``.  x code word q of a
// row (its codes k0 + 4q .. k0 + 4q + 3) goes to word (q % 4) * n / 16 +
// q / 4 of the row's slot, so the words a thread contracts (q = 4j + t)
// are contiguous.  Rows at or past M are zero-filled: zero codes and a zero
// scale, whose product adds exactly 0.
template <int BM, int n, bool VEC>
__device__ __forceinline__ void load_int8_stage(
    float* st, const int8_t* __restrict__ xc, const float* __restrict__ sx,
    const float* __restrict__ w, int M, int N, int K, int col0, int g) {
  const int k0 = g * n;
  load_w_tile<n, VEC, kThreads>(st, w, N, col0, k0);
  constexpr int words = n / 4;
  float* xs = st + n * kDecStride;
  for (int e = threadIdx.x; e < BM * words; e += kThreads) {
    const int m = e / words, q = e - m * words;
    const bool live = m < M;
    const int8_t* src = live ? xc + (size_t)m * K + k0 + 4 * q : xc;
    cp_async4(xs + m * words + (q % kTPC) * (words / kTPC) + q / kTPC,
              reinterpret_cast<const float*>(src), live);
  }
  if (threadIdx.x < BM) {
    const int m = threadIdx.x;
    const bool live = m < M;
    cp_async4(xs + BM * words + m, live ? sx + (size_t)m * (K / n) + g : sx,
              live);
  }
}

// x code words [t * n/16, (t + 1) * n/16) of one row slot (16 or 8 bytes).
template <int Q>
__device__ __forceinline__ void load_x_words(const float* src, uint32_t* dst) {
  if constexpr (Q == 4) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    dst[0] = u.x; dst[1] = u.y; dst[2] = u.z; dst[3] = u.w;
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    dst[0] = u.x; dst[1] = u.y;
  }
}

// Block (tile, split) of abfp_matmul_int8 at decode: columns tile*64..
// over groups [split*G/S, (split+1)*G/S), as fp_decode_kernel cuts them.
// Thread: column c = 8 * warp + lane / 4 of the tile and the quarter t =
// lane % 4 of each of its groups: quads q = 4j + t, rows 16j + 4t .. 16j +
// 4t + 3 (j < n/16); the four threads of a column are neighbouring lanes.
// A quad's rows are read in an order turned by 2 for t = 2, 3, so the 8
// columns x 4 rows a warp reads at once fall on 32 distinct banks (rows 4
// apart are 16 banks apart); the turn only moves a code's byte in its
// word.  Per group a thread holds its n/4 weights in registers, takes
// their max (two shuffles complete the column's), makes their int codes
// (IEEE division, rintf, clip) and packs each quad into one __dp4a word;
// x's codes of the same 4 k make the other word.  Its int32 sums over its
// quarter of the group, one per row, are exact; two rounds of shuffles
// hand each row's quarters to the thread that keeps the row (thread t
// keeps rows 4i + t), so each group sum is whole before ((float)P * sx) *
// sw is added to the row's f32 sum.
template <int BM, int n, bool VEC>
__global__ void __launch_bounds__(kThreads, 3)
int8_decode_kernel(const int8_t* __restrict__ xc,  // (M, K) x codes
                   const float* __restrict__ sx,   // (M, G) x scales
                   const float* __restrict__ w,    // (K, N) raw weight
                   float* __restrict__ y,          // (M, N)
                   float* __restrict__ partial,    // (S, M, N) when S > 1
                   int* __restrict__ tickets,      // one per tile, zero
                   int M, int N, int K, float w_qmax, float w_qmin) {
  constexpr int stage = int8_stage_floats<BM, n>();
  constexpr int Q = n / 16;  // code words of a thread per group
  static_assert(BM % kTPC == 0 && (Q == 2 || Q == 4), "row and word split");
  extern __shared__ __align__(16) float ring[];
  const repro::QdqFormat f{1, w_qmax, w_qmin, 0, 0, 0};
  const int S = gridDim.y, split = blockIdx.y;
  const int col0 = blockIdx.x * kDecBN;
  const int G = K / n;
  const int g_lo = (int)((long long)split * G / S);
  const int T = (int)((long long)(split + 1) * G / S) - g_lo;
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  const int turn = (t >> 1) * 2;  // row order within a quad: b + turn
  const int c = (threadIdx.x >> 5) * 8 + (lane >> 2);

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < T)
      load_int8_stage<BM, n, VEC>(ring + s * stage, xc, sx, w, M, N, K, col0,
                                  g_lo + s);
    cp_async_commit();  // empty groups keep the count uniform
  }

  float acc[BM / 4];
#pragma unroll
  for (int i = 0; i < BM / 4; ++i) acc[i] = 0.f;

  for (int gt = 0; gt < T; ++gt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of group gt landed
    __syncthreads();  // everyone's; and stage (gt - 1) % kStages is free
    const int nt = gt + kStages - 1;
    if (nt < T)
      load_int8_stage<BM, n, VEC>(ring + (nt % kStages) * stage, xc, sx, w, M,
                                  N, K, col0, g_lo + nt);
    cp_async_commit();

    const float* st = ring + (gt % kStages) * stage;
    const float* ws = st + 4 * t * kDecStride + c;
    float v[Q][4];  // v[j][b]: row 16j + 4t + ((b + turn) & 3)
    float amax = 0.f;
#pragma unroll
    for (int j = 0; j < Q; ++j)
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        v[j][b] = ws[(16 * j + ((b + turn) & 3)) * kDecStride];
        amax = fmaxf(amax, fabsf(v[j][b]));
      }
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
    const float sw = repro::group_scale(amax, f.qmax);
    uint32_t wq[Q];
#pragma unroll
    for (int j = 0; j < Q; ++j) {
      uint32_t word = 0u;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int8_t q = (int8_t)repro::int_code(v[j][b], sw, f);
        word |= (uint32_t)(uint8_t)q << (8 * ((b + turn) & 3));
      }
      wq[j] = word;
    }

    const float* xs = st + n * kDecStride;
    const float* ss = xs + BM * n / 4;
    int p[BM];
#pragma unroll
    for (int m = 0; m < BM; ++m) {
      uint32_t xw[Q];
      load_x_words<Q>(xs + m * (n / 4) + t * Q, xw);
      int sum = 0;
#pragma unroll
      for (int j = 0; j < Q; ++j) sum = __dp4a((int)wq[j], (int)xw[j], sum);
      p[m] = sum;
    }
    // thread t ends with the whole sums of rows 4i + t: first lanes t, t^1
    // trade the rows of the other's parity, then lanes t, t^2 the rows of
    // the other's pair (integer adds: exact in any order)
    const int t0 = t & 1, t1 = t >> 1;
    int p2[BM / 2];
#pragma unroll
    for (int i = 0; i < BM / 2; ++i) {
      const int mine = t0 ? p[2 * i + 1] : p[2 * i];
      const int other = t0 ? p[2 * i] : p[2 * i + 1];
      p2[i] = mine + __shfl_xor_sync(0xffffffffu, other, 1);
    }
#pragma unroll
    for (int i = 0; i < BM / 4; ++i) {
      const int mine = t1 ? p2[2 * i + 1] : p2[2 * i];
      const int other = t1 ? p2[2 * i] : p2[2 * i + 1];
      const int P = mine + __shfl_xor_sync(0xffffffffu, other, 2);
      acc[i] += ((float)P * ss[4 * i + t]) * sw;
    }
  }
  cp_async_wait<0>();

  float* dst = S == 1 ? y : partial + (size_t)split * M * N;
  const int col = col0 + c;
  if (col < N) {
#pragma unroll
    for (int i = 0; i < BM / 4; ++i) {
      const int m = 4 * i + t;
      if (m < M) dst[(size_t)m * N + col] = acc[i];
    }
  }
  if (S == 1) return;  // uniform over the grid
  sum_split_partials<kThreads>(partial, tickets, y, M, N, col0, S);
}

template <int BM, int n, bool VEC>
int launch_int8_decode(const int8_t* xc, const float* sx, const float* w,
                       float* y, float* partial, int* tickets, int M, int N,
                       int K, int splits, float w_qmax, float w_qmin,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * kStages * int8_stage_floats<BM, n>();
  auto kern = int8_decode_kernel<BM, n, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((N + kDecBN - 1) / kDecBN, splits);
  kern<<<grid, kThreads, smem, stream>>>(xc, sx, w, y, partial, tickets, M,
                                         N, K, w_qmax, w_qmin);
  return (int)cudaGetLastError();
}

template <int BM>
int launch_int8_decode_rows(const int8_t* xc, const float* sx, const float* w,
                            float* y, float* partial, int* tickets, int M,
                            int N, int K, int n, int splits, bool vec,
                            float w_qmax, float w_qmin, cudaStream_t stream) {
  if (n == 32)
    return vec ? launch_int8_decode<BM, 32, true>(xc, sx, w, y, partial,
                                                  tickets, M, N, K, splits,
                                                  w_qmax, w_qmin, stream)
               : launch_int8_decode<BM, 32, false>(xc, sx, w, y, partial,
                                                   tickets, M, N, K, splits,
                                                   w_qmax, w_qmin, stream);
  return vec ? launch_int8_decode<BM, 64, true>(xc, sx, w, y, partial,
                                                tickets, M, N, K, splits,
                                                w_qmax, w_qmin, stream)
             : launch_int8_decode<BM, 64, false>(xc, sx, w, y, partial,
                                                 tickets, M, N, K, splits,
                                                 w_qmax, w_qmin, stream);
}

}  // namespace

// x: (M, K) f32, w: (K, N) f32, K a multiple of n; y: (M, N) f32; fmt_x /
// fmt_w as QdqFormat fields.  regime (plan_abfp_matmul's):
//   0  decode (M <= 16, n = 32 or 64, n_pad = n) with ``splits`` K splits:
//      x_scratch M*K floats; partial at least splits*M*N floats (unused for
//      one split), tickets (N+63)/64 ints that are zero and are left zero;
//      vec says that N % 4 == 0 and w is 16-byte aligned.
//   1  prefill on the bf16 tensor cores, groups zero-padded to n_pad (a
//      multiple of 16 >= n): x_scratch M*G*n_pad bf16, sx_scratch M*G
//      floats, wc_scratch N*G*n_pad bf16 (16-byte aligned), sw_scratch N*G
//      floats; ``splits`` K splits, partial and tickets as for
//      mma_contract_kernel.
//   2  simt (fp_contract_kernel with ``block_rows`` = 64 or 32 rows a
//      block): x_scratch M*K floats.
// x_qdq_plan (regimes 0 and 2): the repro::QdqPlan of x's QDQ into
// x_scratch (plan_qdq's, for M*K/n groups of n f32).
// Returns a CUDA error.
extern "C" int repro_abfp_matmul(const void* x, const void* w,
                                 void* x_scratch, void* sx_scratch,
                                 void* wc_scratch, void* sw_scratch,
                                 void* partial, void* tickets, void* y,
                                 int M, int N, int K, int n, int n_pad,
                                 int regime, int splits, int block_rows,
                                 int vec, int x_int, float x_qmax,
                                 float x_qmin, int x_man, int x_emin,
                                 int x_emax, int w_int, float w_qmax,
                                 float w_qmin, int w_man, int w_emin,
                                 int w_emax, const void* x_qdq_plan,
                                 void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const repro::QdqFormat fx{x_int, x_qmax, x_qmin, x_man, x_emin, x_emax};
  const repro::QdqFormat fw{w_int, w_qmax, w_qmin, w_man, w_emin, w_emax};
  if (n <= 0 || K % n || regime < 0 || regime > 2 ||
      (regime == 0 && (M > 16 || (n != 32 && n != 64) || splits < 1 ||
                       splits > K / n + (K == 0))) ||
      (regime == 1 && (n_pad < n || n_pad % 16)) ||
      (regime == 2 && block_rows != 64 && block_rows != 32))
    return (int)cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  float* out = static_cast<float*>(y);
  float* part = static_cast<float*>(partial);
  int* tick = static_cast<int*>(tickets);
  const int G = K / n;
  if (regime == 1) {
    __nv_bfloat16* xc = static_cast<__nv_bfloat16*>(x_scratch);
    __nv_bfloat16* wc = static_cast<__nv_bfloat16*>(wc_scratch);
    float* sx = static_cast<float*>(sx_scratch);
    float* sw = static_cast<float*>(sw_scratch);
    int err = launch_quantize_rows(xf, xc, sx, (long long)M * G, n, n_pad, fx,
                                   stream);
    if (err != (int)cudaSuccess) return err;
    err = launch_quantize_cols(wf, wc, sw, K, N, n, n_pad, fw, stream);
    if (err != (int)cudaSuccess) return err;
    return launch_mma<Bf16Codes>(xc, sx, wc, sw, out, part, tick, M, N,
                                 G * n_pad, n_pad, splits, stream);
  }
  float* xq = static_cast<float*>(x_scratch);
  if (x_qdq_plan == nullptr) return (int)cudaErrorInvalidValue;
  int err = repro::launch_qdq(
      xf, xq, (long long)M * G, n, fx,
      *static_cast<const repro::QdqPlan*>(x_qdq_plan), stream);
  if (err == (int)cudaSuccess) err = (int)cudaGetLastError();
  if (err != (int)cudaSuccess) return err;
  if (regime == 2)
    return block_rows == 64
               ? launch_fp_contract<64, 64, 4, 4>(xq, wf, out, M, N, K, n, fw,
                                                  stream)
               : launch_fp_contract<32, 64, 2, 4>(xq, wf, out, M, N, K, n, fw,
                                                  stream);
  if (M <= 4)
    return launch_fp_decode_rows<4>(xq, wf, out, part, tick, M, N, K, n,
                                    splits, vec != 0, fw, stream);
  if (M <= 8)
    return launch_fp_decode_rows<8>(xq, wf, out, part, tick, M, N, K, n,
                                    splits, vec != 0, fw, stream);
  return launch_fp_decode_rows<16>(xq, wf, out, part, tick, M, N, K, n,
                                   splits, vec != 0, fw, stream);
}

// x: (M, K) f32, w: (K, N) f32, K a multiple of n; scratch: xc M*G*n_pad
// bytes, sx M*G floats; y: (M, N) f32; ``splits`` K splits of whole
// groups, partial and tickets as for repro_abfp_matmul.  mma_rows = 64:
// the prefill regime (mma_contract_kernel, 64 rows a block), groups
// zero-padded to n_pad (a multiple of 16 >= n), with scratch wc N*G*n_pad
// bytes (16-byte aligned) and sw N*G floats.  mma_rows = 0: the decode
// regime (M <= 16, n = n_pad = 32 or 64; wc and sw unused), vec as for
// repro_abfp_matmul.  Returns a CUDA error.
extern "C" int repro_abfp_matmul_int8(const void* x, const void* w,
                                      void* xc_scratch, void* sx_scratch,
                                      void* wc_scratch, void* sw_scratch,
                                      void* partial, void* tickets, void* y,
                                      int M, int N, int K, int n, int n_pad,
                                      int splits, int mma_rows, int vec,
                                      float x_qmax, float x_qmin,
                                      float w_qmax, float w_qmin,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n <= 0 || K % n || n_pad < n || n_pad % 16 ||
      (mma_rows != 0 && mma_rows != kMmaBM) ||
      (mma_rows == 0 && (M > 16 || (n != 32 && n != 64) || n_pad != n ||
                         splits < 1 || splits > K / n + (K == 0))))
    return (int)cudaErrorInvalidValue;
  const int G = K / n;
  const repro::QdqFormat fx{1, x_qmax, x_qmin, 0, 0, 0};
  const repro::QdqFormat fw{1, w_qmax, w_qmin, 0, 0, 0};
  int8_t* xc = static_cast<int8_t*>(xc_scratch);
  float* sx = static_cast<float*>(sx_scratch);
  int err = launch_quantize_rows(static_cast<const float*>(x), xc, sx,
                                 (long long)M * G, n, n_pad, fx, stream);
  if (err != (int)cudaSuccess) return err;
  const float* wf = static_cast<const float*>(w);
  float* out = static_cast<float*>(y);
  float* part = static_cast<float*>(partial);
  int* tick = static_cast<int*>(tickets);
  if (mma_rows == 0) {
    if (M <= 4)
      return launch_int8_decode_rows<4>(xc, sx, wf, out, part, tick, M, N, K,
                                        n, splits, vec != 0, w_qmax, w_qmin,
                                        stream);
    if (M <= 8)
      return launch_int8_decode_rows<8>(xc, sx, wf, out, part, tick, M, N, K,
                                        n, splits, vec != 0, w_qmax, w_qmin,
                                        stream);
    return launch_int8_decode_rows<16>(xc, sx, wf, out, part, tick, M, N, K,
                                       n, splits, vec != 0, w_qmax, w_qmin,
                                       stream);
  }
  int8_t* wc = static_cast<int8_t*>(wc_scratch);
  float* sw = static_cast<float*>(sw_scratch);
  err = launch_quantize_cols(wf, wc, sw, K, N, n, n_pad, fw, stream);
  if (err != (int)cudaSuccess) return err;
  return launch_mma<Int8Codes>(xc, sx, wc, sw, out, part, tick, M, N,
                               G * n_pad, n_pad, splits, stream);
}
