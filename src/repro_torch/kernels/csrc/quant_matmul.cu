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
// What bounds them on this card: at decode (M <= 16 rows) reading the f32
// weight once from device memory (4 K N bytes; the QDQ costs about 16
// instructions per weight element and the contraction M FMAs, which the
// CUDA cores do in well under the byte time at M = 4 and in about the
// byte time at M = 16); at prefill (M in the hundreds) the f32
// multiply-adds, since the contraction stays on the CUDA cores.  No TF32
// and no tensor core: an int8 code times a bf16 scale has up to 16
// significant bits, TF32 keeps 11, so it would change the product the
// reference computes in f32.
//
// abfp_matmul.  Stage 1 QDQs x once into scratch (qdq_rows_kernel: x is
// read by every column block, so its QDQ is not repeated per tile).  Stage
// 2 depends on the regime (the wrapper's plan_abfp_matmul chooses it):
//
//   decode (M <= 16, fp_decode_kernel).  A block owns 64 columns and one
//   K split of whole groups; the grid is (column tiles) x (splits), with
//   enough splits for two waves of blocks on the 132 SMs and, while a
//   split keeps two groups, for up to eight (k,v: 8 tiles x 33 splits;
//   q,o and wo: 56 x 19; wi,wg: 296 x 4); short blocks even out the
//   tail.  The block streams its (n, 64) w tiles and (BM, n) x tiles
//   through a ring of kStages shared-memory stages with 16-byte cp.async
//   copies (4-byte ones when a row of w is not 16-byte aligned), so while
//   one group is QDQ'd and contracted the next kStages - 1 are in flight;
//   one barrier per group.  Thread layout: the 16 lanes of a half-warp
//   share 4 adjacent columns, lane p taking rows p, p + 16, ...; a column
//   group's max is reduced with __shfl_xor_sync over those 16 lanes (no
//   shared-memory round trip).  Rows are padded by 4 floats, so the
//   16-byte reads of 8 consecutive rows by a quarter-warp hit 8 distinct
//   bank groups.  The weight is QDQ'd with group_scale / qdq_value of
//   abfp_qdq.cuh (true IEEE division): bit for bit the plain version's.
//   Each split writes its (M, 64) partial to an (S, M, N) scratch; the
//   last block of a column tile to arrive (an integer ticket it resets)
//   sums the S partials in split order: deterministic, no float atomics.
//   With one split the block writes y itself.
//
//   prefill (M > 16, fp_contract_kernel<64, 64, 4, 4>).  An f32 SIMT tiled
//   contraction: per group a block loads a (64, n) x tile and an (n, 64) w
//   tile into shared memory, QDQs the 64 column groups of the w tile in
//   place (a column's max reduced over 4 threads through shared memory),
//   then every thread accumulates its 4 x 4 outputs.  w crosses the memory
//   bus once per row block.
//
// Summation order.  prefill: each group's partial sum is added to the
// running total once.  decode: each lane adds its R-row share of a group to
// its own accumulator once per group; after the last group the 16 lanes of
// a column are summed by a shuffle tree, and then the split partials in
// split order.  Either way the f32 rounding error of K = 18944 terms stays
// near that of a pairwise sum.
//
// abfp_matmul_int8.  Stage 1, quantize_rows_kernel, writes x's int8 codes
// and scales per (row, group) to scratch (M K bytes: negligible).  Stage 2
// depends on the regime (plan_abfp_matmul(..., int8=True) chooses it, on
// the same grid as abfp_matmul's):
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
//   prefill (M > 16, or another n: quantize_cols_kernel, then
//   contract_kernel<BM, CN, false> above).  quantize_cols_kernel writes w's
//   codes transposed, (N, K), and scales (N, G) once: a block stages whole
//   groups x 32 columns in shared memory and each warp writes a column's
//   codes as contiguous runs of >= 128 bytes.  contract_kernel is bound by
//   __dp4a issue at M in the hundreds.  Three launches a call.
//
// Summation order, both regimes: a (row, column, group) sum of code
// products is an exact int32, rescaled as ((float)P * sx) * sw (never sx *
// sw folded: the reference multiplies in that order).  decode: each row's
// f32 sum adds its groups in order within a split, then the split partials
// in split order; prefill: each lane adds its groups in order, then a
// shuffle tree adds the lanes.
// ===========================================================================
namespace {

// w (K, N) f32 -> codes wc (N, K) int8 and unit scales sw (N, G), the
// layout contract_kernel reads (a column's codes contiguous).  A block owns
// kColTile columns and GB = rows / n whole groups, rows = max(128, n):
//   1. it reads the (rows, 32) f32 tile row by row (a warp reads 128
//      contiguous bytes, a thread keeps 16 loads in flight) into shared
//      memory;
//   2. one thread per (group, column) forms the group's scale;
//   3. one thread per (4 rows, column) packs their codes into a word of a
//      (32, rows / 4 + 1) code tile (the pad keeps the 32 columns of a
//      warp's writes on 32 banks);
//   4. a warp per column writes that column's rows codes, contiguous in wc,
//      as whole words: runs of GB * n >= 128 bytes, whole 32-byte sectors
//      (shorter only where K itself is shorter).
// The codes and scales are those of one thread per (group, column) with
// group_scale / int_code: the same bits at any tiling.
constexpr int kColTile = 32;   // columns per block
constexpr int kColRows = 128;  // tile rows when n <= 128
constexpr int kLoads = 16;     // loads a thread keeps in flight

__host__ __device__ constexpr int col_tile_rows(int n) {
  return n > kColRows ? n : kColRows;
}

__host__ __device__ constexpr size_t col_tile_smem(int n) {
  return sizeof(float) * ((size_t)col_tile_rows(n) * kColTile +
                          (size_t)(col_tile_rows(n) / n) * kColTile +
                          (size_t)kColTile * (col_tile_rows(n) / 4 + 1));
}

__global__ void __launch_bounds__(kThreads)
quantize_cols_kernel(const float* __restrict__ w, int8_t* __restrict__ wc,
                     float* __restrict__ sw, int K, int N, int n, float qmax,
                     float qmin) {
  extern __shared__ __align__(16) float tile[];  // [rows][kColTile]
  const int rows = col_tile_rows(n);
  const int GB = rows / n;
  const int cw = rows / 4 + 1;  // words of a column's codes, padded
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
    for (int i = 0; i < n; i += 4)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        m4[k] = fmaxf(m4[k], fabsf(src[(i + k) * kColTile]));
    const float amax = fmaxf(fmaxf(m4[0], m4[1]), fmaxf(m4[2], m4[3]));
    scale[e] = repro::group_scale(amax, qmax);
  }
  __syncthreads();
  const repro::QdqFormat f{1, qmax, qmin, 0, 0, 0};
  for (int e = tid; e < (nr / 4) * kColTile; e += kThreads) {
    const int q = e / kColTile, c = e - q * kColTile;
    const float s = scale[(4 * q / n) * kColTile + c];
    uint32_t word = 0u;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int8_t code = (int8_t)repro::int_code(
          tile[(4 * q + b) * kColTile + c], s, f);
      word |= (uint32_t)(uint8_t)code << (8 * b);
    }
    codes[c * cw + q] = word;
  }
  __syncthreads();
  const int warp = tid >> 5, lane = tid & 31;
  for (int c = warp; c < kColTile; c += kWarpsPerBlock) {
    const int col = col0 + c;
    if (col >= N) break;  // uniform per warp; columns ascend
    uint32_t* dst = reinterpret_cast<uint32_t*>(wc + (size_t)col * K + k0);
    for (int q = lane; q < nr / 4; q += 32) dst[q] = codes[c * cw + q];
    if (lane < ng)
      sw[(size_t)col * G + g0 + lane] = scale[lane * kColTile + c];
  }
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

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

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

// x: (M, K) f32, w: (K, N) f32, K a multiple of n; xq_scratch: M*K floats;
// y: (M, N) f32.  fmt_x / fmt_w as QdqFormat fields.  splits = 0: the
// prefill regime.  splits >= 1: the decode regime (M <= 16, n = 32 or 64)
// with that many K splits; then partial holds at least splits*M*N floats
// (unused for one split), tickets (N+63)/64 ints that are zero and are
// left zero, and vec says that N % 4 == 0 and w is 16-byte aligned.
// Returns a CUDA error.
extern "C" int repro_abfp_matmul(const void* x, const void* w,
                                 void* xq_scratch, void* partial,
                                 void* tickets, void* y, int M, int N, int K,
                                 int n, int splits, int vec, int x_int,
                                 float x_qmax, float x_qmin, int x_man,
                                 int x_emin, int x_emax, int w_int,
                                 float w_qmax, float w_qmin, int w_man,
                                 int w_emin, int w_emax, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const repro::QdqFormat fx{x_int, x_qmax, x_qmin, x_man, x_emin, x_emax};
  const repro::QdqFormat fw{w_int, w_qmax, w_qmin, w_man, w_emin, w_emax};
  if (splits > 0 && (M > 16 || (n != 32 && n != 64) ||
                     splits > K / n + (K == 0)))
    return (int)cudaErrorInvalidValue;
  float* xq = static_cast<float*>(xq_scratch);
  const long long x_groups = (long long)M * (K / n);
  if (x_groups > 0) {
    repro::launch_qdq_rows(static_cast<const float*>(x), xq, x_groups, n, fx,
                           stream);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const float* wf = static_cast<const float*>(w);
  float* out = static_cast<float*>(y);
  float* part = static_cast<float*>(partial);
  int* tick = static_cast<int*>(tickets);
  if (splits == 0)
    return launch_fp_contract<64, 64, 4, 4>(xq, wf, out, M, N, K, n, fw,
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

// x: (M, K) f32, w: (K, N) f32, K a multiple of n (n / 16 a power of two
// <= 32); scratch: xc M*K bytes, sx M*G floats; y: (M, N) f32.  splits = 0:
// the prefill regime, with scratch wc N*K bytes and sw N*G floats.  splits
// >= 1: the decode regime (M <= 16, n = 32 or 64; wc and sw unused) with
// that many K splits; partial, tickets and vec as for repro_abfp_matmul.
// Returns a CUDA error.
extern "C" int repro_abfp_matmul_int8(const void* x, const void* w,
                                      void* xc_scratch, void* sx_scratch,
                                      void* wc_scratch, void* sw_scratch,
                                      void* partial, void* tickets, void* y,
                                      int M, int N, int K, int n, int splits,
                                      int vec, float x_qmax, float x_qmin,
                                      float w_qmax, float w_qmin,
                                      void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (splits > 0 && (M > 16 || (n != 32 && n != 64) ||
                     splits > K / n + (K == 0)))
    return (int)cudaErrorInvalidValue;
  const long long n_groups = (long long)M * (K / n);
  if (n_groups > 0) {
    const int qblocks =
        (int)((n_groups + kWarpsPerBlock - 1) / kWarpsPerBlock);
    quantize_rows_kernel<<<qblocks, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<int8_t*>(xc_scratch),
        static_cast<float*>(sx_scratch), n_groups, n, x_qmax, x_qmin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int8_t* xc = static_cast<const int8_t*>(xc_scratch);
  const float* sx = static_cast<const float*>(sx_scratch);
  const float* wf = static_cast<const float*>(w);
  float* out = static_cast<float*>(y);
  if (splits > 0) {
    float* part = static_cast<float*>(partial);
    int* tick = static_cast<int*>(tickets);
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

  const int G = K / n;
  if (G > 0) {
    const size_t smem = col_tile_smem(n);
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(
          quantize_cols_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (e != cudaSuccess) return (int)e;
    }
    const int GB = col_tile_rows(n) / n;
    dim3 grid((N + kColTile - 1) / kColTile, (G + GB - 1) / GB);
    quantize_cols_kernel<<<grid, kThreads, smem, stream>>>(
        wf, static_cast<int8_t*>(wc_scratch), static_cast<float*>(sw_scratch),
        K, N, n, w_qmax, w_qmin);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const uint8_t* wc = static_cast<const uint8_t*>(wc_scratch);
  const float* sw = static_cast<const float*>(sw_scratch);
  if (M <= 4)
    launch_contract<4, 4>(xc, sx, wc, sw, out, M, N, K, n, false, stream);
  else if (M <= 8)
    launch_contract<8, 2>(xc, sx, wc, sw, out, M, N, K, n, false, stream);
  else
    launch_contract<16, 2>(xc, sx, wc, sw, out, M, N, K, n, false, stream);
  return (int)cudaGetLastError();
}
