// Dense causal flash attention for Hopper (sm_90a): flash_mma_kernel.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _kernel): out = softmax(q k^T * scale) v over q (BH, S, D) and
// k, v (BHkv, T, D), f32, with the reference's online recurrence per key
// tile:
//
//   m_new = max(m, rowmax(s));  p = exp(s - m_new), 0 where s <= NEG_INF/2
//   corr  = exp(m - m_new), 0 where m <= NEG_INF/2
//   l     = l * corr + rowsum(p);  acc = acc * corr + p v
//   out   = acc / max(l, 1e-30)
//
// NEG_INF = -1e30 marks masked scores; causality keeps key t for query row
// i where t <= i + q_offset (absolute positions), so a row with no key
// (q_offset < 0) comes out exactly 0.  Query head bh reads key head
// bh / G (G = BH / BHkv): grouped-query attention needs no repeated K/V.
//
// What bounds it on this card.  The fixed-slot prefill's largest call (B
// = 1, S = T = 192, H = 28, KV = 4, D = 128, causal) moves 6.3 MB once
// (1.9 us at 3.35 TB/s) and needs 265.6 M f32 operations (q.k and p.v,
// D multiply-adds each, for the pairs the mask keeps: 4.0 us at the 67
// TFLOP/s of f32 outside the tensor cores).  Here every product runs on
// the tensor cores as three tf32 products (1.6 us at 495 TFLOP/s), so
// the bytes are the floor and the f32 figure a reference; what a block
// spends beyond that goes to the mma.sync issue rate, the copies and the
// barriers of each key tile.
//
// Design.
//   rows     a block serves three m16 tiles of rows of one (batch, KV
//            head), row = position * G + head over the G query heads that
//            read that KV head, so each K / V tile is copied into shared
//            memory once for all of them.  The head's n16 m16 tiles go to
//            nb = n16 / 3 blocks as tiles b, b + nb and b + 2 nb: under
//            the causal mask early and late positions share every block,
//            and so does the work (S = 192: 84 m16 tiles a head, 28 x 4 =
//            112 blocks, one wave, each walking all three key tiles).
//   warps    12 warps: warp (m16 tile mt, key part kp) forms the scores
//            of its 16 rows and the 16 keys kp of every 64-key tile, and
//            P.V of its 16 rows for a quarter of the head dimension over
//            all 64 keys.  A scheduler holds one warp of each m16 tile.
//   products scores q.k and P.V on the tensor cores, mma.sync m16n8k8
//            tf32 with f32 sums, at f32 accuracy: each f32 operand is split
//            x = big + small (split_tf32, ptx.cuh) and a product is small *
//            big + big * small + big * big, within 3 * 2^-22 of the f32
//            product.  The scores keep an f32 accumulator a term, added as
//            (small * big + big * small) + big * big at the end, and P.V one
//            for both small terms and one for big * big, so that a warp's
//            MMAs form independent chains (a warp alone on its scheduler
//            waits on an MMA's latency, not its issue).  q's rows
//            are split once into shared memory and read by ldmatrix; K
//            (ldmatrix) and V (two loads a fragment) are split as they are
//            read.  An MMA step of P.V takes 8 keys ordered (2 t, 2 t + 1)
//            for column pair t, as a score fragment holds them, so p's
//            terms are written and read as float2 and V's rows are read in
//            that order.  Row pitches (q, K, V: D + 4 floats; p: 72) put
//            the 8 rows of an ldmatrix, and the rows of a fragment, on
//            distinct banks.
//   softmax  the online recurrence per 64-key tile, on the score
//            fragments: a part's row maxima by the 4 lanes of a quad (two
//            shuffles), the tile's row max over the four parts through
//            shared memory (one barrier), p's terms written for P.V (one
//            barrier); each part keeps its own running sum of p under the
//            common corr, and the four sums are added in part order at the
//            end.  An accumulator is rescaled only when some row's corr is
//            not 1.
//   ring     K and V tiles of 64 keys are copied by cp.async two tiles
//            deep: the copy of tile j + 1 is issued at the start of tile j
//            and runs under its math.  Keys past T and columns past D are
//            zero-filled.
//   skip     a block walks only the tiles up to its last row's causal
//            limit; a key part that no row of an m16 tile can see is
//            neither multiplied nor written, and P.V leaves it out: its
//            p are zeros and its corr the tile's, so every output bit is
//            as without the skip.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no fast-math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ptx.cuh"

namespace {

constexpr int kMT = 3;                  // m16 tiles of rows a block
constexpr int kRows = 16 * kMT;         // rows a block serves
constexpr int kKeys = 64;               // keys a K / V tile
constexpr int kParts = 4;               // key parts of a tile
constexpr int kWarps = kMT * kParts;    // a warp a (m16 tile, key part)
constexpr int kThreads = 32 * kWarps;
constexpr int kPart = kKeys / kParts;   // keys a warp takes of a tile
constexpr int kPN = kPart / 8;          // its n8 tiles / P.V MMA steps
constexpr int kPP = kKeys + 8;          // p row pitch, floats
constexpr float kNegInf = -1e30f;

// Dynamic shared memory of a block for head_dim padded to DP: q's rows
// split (big, small) and two stages of a K and a V tile, rows DP + 4
// floats apart; p's terms (big, small), rows kPP apart; the key parts'
// row maxima (then sums).
__host__ __device__ constexpr size_t flash_smem_bytes(int DP) {
  return sizeof(float) * ((size_t)(DP + 4) * (2 * kRows + 4 * kKeys) +
                          (size_t)2 * kRows * kPP + kParts * kRows);
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return (unsigned)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The recurrence's guarded correction exp(m - m_new): 0 for a row that
// has seen no key yet.
__device__ __forceinline__ float correction(float m, float m_new) {
  return m <= kNegInf / 2 ? 0.f : expf(m - m_new);
}

// Four floats c .. c + 3 of one row -> shared (zeros past D, or all four
// when the row is not live): one 16-byte copy when vec, else four 4-byte
// ones.
__device__ __forceinline__ void copy_piece(float* dst, const float* src,
                                           const float* any, int c, int D,
                                           bool live, bool vec) {
  if (vec) {
    const bool on = live && c < D;
    cp_async16(dst + c, on ? src + c : any, on);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool on = live && c + e < D;
      cp_async4(dst + c + e, on ? src + c + e : any, on);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, 1)
flash_mma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 int BHkv, int S, int T, int D, int G, float scale,
                 int causal, int q_offset, int vec) {
  constexpr int P = DP + 4;       // q, K, V row pitch, floats
  constexpr int KS = DP / 8;      // MMA steps over d (scores), n-tiles of d
  constexpr int NTW = KS >= kParts ? KS / kParts : 1;  // P.V n-tiles a warp
  extern __shared__ __align__(16) float smem[];
  float* qb = smem;                  // kRows x P: tf32 big terms of q
  float* qs = qb + kRows * P;        // kRows x P: small terms
  float* ring = qs + kRows * P;      // 2 stages x (K, V) x kKeys x P
  float* pb = ring + 4 * kKeys * P;  // kRows x kPP: big terms of p
  float* ps = pb + kRows * kPP;      // kRows x kPP: small terms
  float* red = ps + kRows * kPP;     // kParts x kRows: row maxima, sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rows_total = S * G;
  // the block's m16 tiles: tile b, b + nb and b + 2 nb of its KV head's
  // n16 (nb blocks a KV head), so that early and late positions share
  // every block and, under the causal mask, its work
  const int n16 = (rows_total + 15) / 16;
  const int nb = (n16 + kMT - 1) / kMT;
  const int bkv = blockIdx.x % BHkv;
  const int b = blockIdx.x / BHkv;
  auto m16_row0 = [&](int i) { return 16 * (b + i * nb); };
  // the last key any row of a set of rows sees (-1: none)
  auto last_key = [&](int last_row) {
    return causal ? min(last_row / G + q_offset, T - 1) : T - 1;
  };
  int i_last = kMT - 1;  // the block's last m16 tile that holds rows
  while (m16_row0(i_last) >= rows_total) --i_last;
  const int block_lim =
      last_key(min(m16_row0(i_last) + 15, rows_total - 1));
  const int n_tiles = block_lim < 0 ? 0 : block_lim / kKeys + 1;

  // ---- K / V tile j into stage j & 1 (one cp.async group a tile)
  auto copy_tile = [&](int j) {
    float* kd = ring + (j & 1) * 2 * kKeys * P;
    float* vd = kd + kKeys * P;
    for (int i = tid; i < kKeys * (DP / 4); i += kThreads) {
      const int key = i / (DP / 4), c = 4 * (i % (DP / 4));
      const int t = j * kKeys + key;
      const bool live = t < T;
      const size_t off = ((size_t)bkv * T + (live ? t : 0)) * D;
      copy_piece(kd + key * P, k + off, k, c, D, live, vec);
      copy_piece(vd + key * P, v + off, v, c, D, live, vec);
    }
  };

  // ---- q's rows (row R: query head bkv * G + R % G, position R / G):
  // loads issued first, tile 0's copies next, then q split and stored as
  // big and small terms (zeros past D and past the last row)
  constexpr int kQPieces = kRows * (DP / 4);
  constexpr int kQIter = (kQPieces + kThreads - 1) / kThreads;
  float xq[kQIter][4];
#pragma unroll
  for (int u = 0; u < kQIter; ++u) {
    const int i = tid + u * kThreads;
    const int r = i / (DP / 4), c = 4 * (i % (DP / 4));
    const int R = m16_row0(r / 16) + r % 16;
#pragma unroll
    for (int e = 0; e < 4; ++e) xq[u][e] = 0.f;
    if (i < kQPieces && R < rows_total) {
      const float* src = q + ((size_t)(bkv * G + R % G) * S + R / G) * D;
      if (vec) {
        if (c < D) {
          const float4 f = __ldg(reinterpret_cast<const float4*>(src + c));
          xq[u][0] = f.x;
          xq[u][1] = f.y;
          xq[u][2] = f.z;
          xq[u][3] = f.w;
        }
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c + e < D) xq[u][e] = __ldg(src + c + e);
      }
    }
  }
  if (n_tiles > 0) copy_tile(0);
  cp_async_commit();
#pragma unroll
  for (int u = 0; u < kQIter; ++u) {
    const int i = tid + u * kThreads;
    if (i < kQPieces) {
      const int r = i / (DP / 4), c = 4 * (i % (DP / 4));
      uint32_t b[4], sm[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(xq[u][e], b[e], sm[e]);
      *reinterpret_cast<uint4*>(qb + r * P + c) =
          make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(qs + r * P + c) =
          make_uint4(sm[0], sm[1], sm[2], sm[3]);
    }
  }

  // ---- this thread's place: warp (m16 tile mt, key part kp), fragment
  // row g (and g + 8), column pair t4
  const int mt = warp % kMT, kp = warp / kMT;
  const int g = lane >> 2, t4 = lane & 3;
  const int wr0 = m16_row0(mt);
  const int warp_lim =
      wr0 < rows_total ? last_key(min(wr0 + 15, rows_total - 1)) : -1;
  int lim[2];  // the last key each of the thread's two rows sees
#pragma unroll
  for (int hr = 0; hr < 2; ++hr)
    lim[hr] = last_key(min(wr0 + g + 8 * hr, rows_total - 1));
  // ldmatrix rows: q's A fragments (rows 0-7 / 8-15, columns 0-3 / 4-7 of
  // a step), K's B fragments (the part's two n-tiles x columns 0-3 / 4-7)
  const int qrow = 16 * mt + (lane & 7) + 8 * ((lane >> 3) & 1);
  const int qcol = 4 * (lane >> 4);
  const int krow = kPart * kp + 8 * (lane >> 4) + (lane & 7);
  const int kcol = 4 * ((lane >> 3) & 1);
  // P.V: the warp's output columns, n-tiles nt0 .. nt0 + NTW - 1 (none
  // for the parts past KS at small head dimensions)
  const int nt0 = kp * NTW;
  const bool has_cols = nt0 < KS;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  // P.V accumulators: [0] the small terms' products, [1] big * big
  float acc[2][NTW][4];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][nt][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<0>();  // this thread's pieces of tile j
    // tile j and q's terms are in for everyone, and everyone is done with
    // tile j - 1: its stage takes tile j + 1, its p and maxima are free
    __syncthreads();
    if (j + 1 < n_tiles) copy_tile(j + 1);
    cp_async_commit();
    const float* ks = ring + (j & 1) * 2 * kKeys * P;
    const float* vs = ks + kKeys * P;
    const int kt0 = j * kKeys + kPart * kp;  // the part's first key
    const bool live = kt0 <= warp_lim;       // some row sees a key of it
    // scores of 16 rows x the part's 16 keys: s[nt] holds (g, 8 nt + 2 t4
    // + e) in e = 0, 1 and row g + 8 in e = 2, 3
    float s[kPN][4];
    float mx[2] = {kNegInf, kNegInf};
    if (live) {
      // one accumulator a term (small * big, big * small, big * big), so
      // that the warp's MMAs form six independent chains, not two
      float st[3][kPN][4];
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int nt = 0; nt < kPN; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[u][nt][e] = 0.f;
      // step kk's fragments: q's big and small terms, K's raw values;
      // loaded one step ahead
      uint32_t fr[3][4];
      auto load_step = [&](int kk, uint32_t (*f)[4]) {
        ldmatrix_x4(f[0], smem_addr(qb + qrow * P + 8 * kk + qcol));
        ldmatrix_x4(f[1], smem_addr(qs + qrow * P + 8 * kk + qcol));
        ldmatrix_x4(f[2], smem_addr(ks + krow * P + 8 * kk + kcol));
      };
      load_step(0, fr);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t nx[3][4];
        if (kk + 1 < KS) load_step(kk + 1, nx);
        uint32_t bb[kPN][2], bs[kPN][2];  // K's terms, n-tile e / 2
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split_tf32(__uint_as_float(fr[2][e]), bb[e / 2][e & 1],
                     bs[e / 2][e & 1]);
#pragma unroll
        for (int nt = 0; nt < kPN; ++nt) {
          mma_tf32(st[0][nt], fr[1], bb[nt]);
          mma_tf32(st[1][nt], fr[0], bs[nt]);
          mma_tf32(st[2][nt], fr[0], bb[nt]);
        }
        if (kk + 1 < KS) {
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) fr[i][e] = nx[i][e];
        }
      }
#pragma unroll
      for (int nt = 0; nt < kPN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = kt0 + 8 * nt + 2 * t4 + (e & 1);
          s[nt][e] = (st[0][nt][e] + st[1][nt][e]) + st[2][nt][e];
          const float x = t <= lim[e >> 1] ? s[nt][e] * scale : kNegInf;
          s[nt][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) mx[hr] = quad_max(mx[hr]);
    }
    // the tile's row maxima: each part's, then all four
    if (t4 == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        red[kp * kRows + 16 * mt + g + 8 * hr] = mx[hr];
    }
    __syncthreads();
    float corr[2];
    bool scaled = false;  // some row's accumulator changes under corr
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mt_max = kNegInf;
#pragma unroll
      for (int i = 0; i < kParts; ++i)
        mt_max = fmaxf(mt_max, red[i * kRows + 16 * mt + g + 8 * hr]);
      const float m_new = fmaxf(m[hr], mt_max);
      corr[hr] = correction(m[hr], m_new);
      // a row that has seen no key holds acc = 0, which corr leaves 0
      scaled |= corr[hr] != 1.f && m[hr] > kNegInf / 2;
      m[hr] = m_new;
    }
    // p of the part's keys (a part no row sees holds only zeros: it is
    // neither written nor multiplied), each part's own running sum
    float sum[2] = {0.f, 0.f};
    if (live) {
#pragma unroll
      for (int nt = 0; nt < kPN; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[nt][e];
          const float p = x <= kNegInf / 2 ? 0.f : expf(x - m[e >> 1]);
          s[nt][e] = p;
          sum[e >> 1] += p;
        }
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) sum[hr] = quad_sum(sum[hr]);
#pragma unroll
      for (int nt = 0; nt < kPN; ++nt)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int at = (16 * mt + g + 8 * hr) * kPP + kPart * kp + 8 * nt +
                         2 * t4;
          uint32_t b0, s0, b1, s1;
          split_tf32(s[nt][2 * hr], b0, s0);
          split_tf32(s[nt][2 * hr + 1], b1, s1);
          *reinterpret_cast<uint2*>(pb + at) = make_uint2(b0, b1);
          *reinterpret_cast<uint2*>(ps + at) = make_uint2(s0, s1);
        }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) l[hr] = fmaf(l[hr], corr[hr], sum[hr]);
    if (__any_sync(0xffffffffu, scaled)) {
#pragma unroll
      for (int nt = 0; nt < NTW; ++nt) {
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          acc[u][nt][0] *= corr[0];
          acc[u][nt][1] *= corr[0];
          acc[u][nt][2] *= corr[1];
          acc[u][nt][3] *= corr[1];
        }
      }
    }
    __syncthreads();  // every part's p is in
    // acc += p v over the tile's live parts, the warp's n-tiles: an MMA
    // step of 8 keys takes keys (2 t4, 2 t4 + 1) as columns (t4, t4 + 4)
    // of its A fragment, and V's rows in that order
    if (has_cols) {
      const float* pr = pb + (16 * mt + g) * kPP + 2 * t4;
      const float* pr2 = ps + (16 * mt + g) * kPP + 2 * t4;
      const float* vr = vs + 2 * t4 * P + 8 * nt0 + g;
      for (int part = 0; part < kParts; ++part) {
        if (j * kKeys + kPart * part > warp_lim) break;
#pragma unroll
        for (int h = 0; h < kPN; ++h) {
          const int k0 = kPart * part + 8 * h;
          const uint2 a0 = *reinterpret_cast<const uint2*>(pr + k0);
          const uint2 a1 = *reinterpret_cast<const uint2*>(pr + 8 * kPP + k0);
          const uint2 c0 = *reinterpret_cast<const uint2*>(pr2 + k0);
          const uint2 c1 =
              *reinterpret_cast<const uint2*>(pr2 + 8 * kPP + k0);
          const uint32_t abig[4] = {a0.x, a1.x, a0.y, a1.y};
          const uint32_t asml[4] = {c0.x, c1.x, c0.y, c1.y};
          const float* v0 = vr + k0 * P;
          uint32_t bb[NTW][2], bs[NTW][2];  // V's terms, n-tile nt0 + nt
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) {
            split_tf32(v0[8 * nt], bb[nt][0], bs[nt][0]);
            split_tf32(v0[P + 8 * nt], bb[nt][1], bs[nt][1]);
          }
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) mma_tf32(acc[0][nt], asml, bb[nt]);
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) mma_tf32(acc[0][nt], abig, bs[nt]);
#pragma unroll
          for (int nt = 0; nt < NTW; ++nt) mma_tf32(acc[1][nt], abig, bb[nt]);
        }
      }
    }
  }

  // ---- the row sums: the parts' running sums, added in part order (a
  // warp writes red only after the barrier that followed everyone's last
  // read of the maxima); then out = acc / max(l, 1e-30) for the warp's
  // columns of its m16 tile's real rows
  if (t4 == 0) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      red[kp * kRows + 16 * mt + g + 8 * hr] = l[hr];
  }
  __syncthreads();
  if (!has_cols) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int R = wr0 + g + 8 * hr;
    if (R >= rows_total) continue;
    float den = red[16 * mt + g + 8 * hr];
#pragma unroll
    for (int i = 1; i < kParts; ++i)
      den += red[i * kRows + 16 * mt + g + 8 * hr];
    den = fmaxf(den, 1e-30f);
    float* o = out + ((size_t)(bkv * G + R % G) * S + R / G) * D;
#pragma unroll
    for (int nt = 0; nt < NTW; ++nt) {
      const int col = 8 * (nt0 + nt) + 2 * t4;
      const float o0 =
          div_rn(acc[1][nt][2 * hr] + acc[0][nt][2 * hr], den);
      const float o1 =
          div_rn(acc[1][nt][2 * hr + 1] + acc[0][nt][2 * hr + 1], den);
      if (col + 1 < D && !(D & 1)) {
        *reinterpret_cast<float2*>(o + col) = make_float2(o0, o1);
      } else {
        if (col < D) o[col] = o0;
        if (col + 1 < D) o[col + 1] = o1;
      }
    }
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, float* out,
           int BHkv, int S, int T, int D, int G, float scale, int causal,
           int q_offset, int vec, cudaStream_t stream) {
  const size_t bytes = flash_smem_bytes(DP);
  const cudaError_t e = cudaFuncSetAttribute(
      flash_mma_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const long long blocks =
      (long long)((S * G + kRows - 1) / kRows) * BHkv;
  flash_mma_kernel<DP><<<(unsigned)blocks, kThreads, bytes, stream>>>(
      q, k, v, out, BHkv, S, T, D, G, scale, causal, q_offset, vec);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (BHkv * G, S, D) f32; k, v: (BHkv, T, D) f32, D <= dp, dp the
// head_dim the kernel is instantiated for (16, 32, 64 or 128); vec: D % 4
// == 0 and every pointer 16-byte aligned (16-byte copies).  Returns
// cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int BHkv,
                                     int S, int T, int D, int G, float scale,
                                     int causal, int q_offset, int dp,
                                     int vec, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (D > dp || D < 1 || S <= 0 || T < 0 || G <= 0 || BHkv <= 0 ||
      (long long)S * G > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  float* of = static_cast<float*>(out);
  switch (dp) {
    case 16:
      return launch<16>(qf, kf, vf, of, BHkv, S, T, D, G, scale, causal,
                        q_offset, vec, stream);
    case 32:
      return launch<32>(qf, kf, vf, of, BHkv, S, T, D, G, scale, causal,
                        q_offset, vec, stream);
    case 64:
      return launch<64>(qf, kf, vf, of, BHkv, S, T, D, G, scale, causal,
                        q_offset, vec, stream);
    case 128:
      return launch<128>(qf, kf, vf, of, BHkv, S, T, D, G, scale, causal,
                         q_offset, vec, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
