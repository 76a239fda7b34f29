// Dense causal flash attention for Hopper (sm_90a).
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
// i where t <= i + q_offset (absolute positions).  Query head bh reads key
// head bh / G (G = BH / BHkv), so grouped-query attention needs no repeated
// K/V in device memory.
//
// What bounds it on this card: f32 multiply-adds at prefill lengths (4 S T D
// operations against (S + 2T) D floats); the card's f32 rate outside the
// tensor cores is 67 TFLOP/s.
//
// Design.  One block per (query head, tile of BQ = 16 query rows); its 256
// threads loop over key tiles of BK = 64 held in shared memory with the
// q tile.  Scores are computed 4 per thread from shared memory (K rows
// padded by one float so a warp's 32 keys fall in 32 banks), the softmax
// update takes 16 threads per row with shuffles, and each thread keeps 8
// output accumulators (one column d, every second row).  The running
// max / denominator / accumulator live in shared memory and registers, so
// HBM sees q, k, v once per block and out once.  A key tile that lies
// wholly above the causal diagonal of the query tile is skipped: in the
// recurrence such a tile changes nothing (p = 0, corr = 1).  The TPU
// kernel's sequential KV grid axis becomes the loop inside the block.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC   (no fast-math).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 16;         // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int DMAX = 128;      // largest head_dim
constexpr float kNegInf = -1e30f;

__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int S,
             int T, int D, int G, float scale, int causal, int q_offset) {
  extern __shared__ float smem[];
  const int KD = D + 1;               // padded K row
  float* qs = smem;                   // [BQ][D]
  float* ks = qs + BQ * D;            // [BK][D + 1]
  float* vs = ks + BK * KD;           // [BK][D]
  float* sc = vs + BK * D;            // [BQ][BK] scores, then p
  float* m_s = sc + BQ * BK;          // [BQ] running max
  float* l_s = m_s + BQ;              // [BQ] running denominator
  float* c_s = l_s + BQ;              // [BQ] this tile's correction

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const float* qb = q + (size_t)bh * S * D;
  const float* kb = k + (size_t)(bh / G) * T * D;
  const float* vb = v + (size_t)(bh / G) * T * D;

  for (int e = tid; e < BQ * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    qs[e] = q0 + r < S ? qb[(size_t)(q0 + r) * D + d] : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  // P.V mapping: column d = tid % 128, rows rg, rg + 2, ...
  const int d_own = tid % DMAX;
  const int rg = tid / DMAX;          // 0 or 1
  constexpr int RA = BQ / (kThreads / DMAX);  // 8 rows per thread
  float acc[RA];
#pragma unroll
  for (int i = 0; i < RA; ++i) acc[i] = 0.f;

  // score mapping: key j = tid % BK, rows r0, r0 + 4, ...
  const int j_own = tid % BK;
  const int r0 = tid / BK;            // 0..3
  constexpr int RS = BQ / (kThreads / BK);    // 4 rows per thread
  // softmax mapping: 16 threads per row
  const int srow = tid / 16;
  const int sl = tid % 16;

  const int last_q = min(q0 + BQ, S) - 1;
  for (int t0 = 0; t0 < T; t0 += BK) {
    if (causal && t0 > last_q + q_offset) break;  // every later tile too
    __syncthreads();  // previous tile's K/V/p no longer read
    for (int e = tid; e < BK * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const bool live = t0 + r < T;
      ks[r * KD + d] = live ? kb[(size_t)(t0 + r) * D + d] : 0.f;
      vs[e] = live ? vb[(size_t)(t0 + r) * D + d] : 0.f;
    }
    __syncthreads();

    // scores
    {
      const int t = t0 + j_own;
      float s[RS];
#pragma unroll
      for (int i = 0; i < RS; ++i) s[i] = 0.f;
      for (int d = 0; d < D; ++d) {
        const float kv = ks[j_own * KD + d];
#pragma unroll
        for (int i = 0; i < RS; ++i) s[i] += qs[(r0 + i * 4) * D + d] * kv;
      }
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const int r = r0 + i * 4;
        float val = s[i] * scale;
        const bool ok = t < T && (!causal || t <= q0 + r + q_offset);
        sc[r * BK + j_own] = ok ? val : kNegInf;
      }
    }
    __syncthreads();

    // online softmax update, 16 threads per row
    {
      float* row = sc + srow * BK;
      float mx = kNegInf;
      for (int j = sl; j < BK; j += 16) mx = fmaxf(mx, row[j]);
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[srow];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = sl; j < BK; j += 16) {
        const float sv = row[j];
        const float p = sv <= kNegInf / 2 ? 0.f : expf(sv - m_new);
        row[j] = p;
        sum += p;
      }
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (sl == 0) {
        const float corr =
            m_prev <= kNegInf / 2 ? 0.f : expf(m_prev - m_new);
        c_s[srow] = corr;
        l_s[srow] = l_s[srow] * corr + sum;
        m_s[srow] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + p v
    if (d_own < D) {
#pragma unroll
      for (int i = 0; i < RA; ++i) {
        const int r = rg + 2 * i;
        const float* p = sc + r * BK;
        float pv = 0.f;
        for (int j = 0; j < BK; ++j) pv += p[j] * vs[j * D + d_own];
        acc[i] = acc[i] * c_s[r] + pv;
      }
    }
  }
  __syncthreads();
  if (d_own < D) {
#pragma unroll
    for (int i = 0; i < RA; ++i) {
      const int r = rg + 2 * i;
      if (q0 + r < S)
        out[((size_t)bh * S + q0 + r) * D + d_own] =
            acc[i] / fmaxf(l_s[r], 1e-30f);
    }
  }
}

}  // namespace

// q, out: (BH, S, D) f32; k, v: (BHkv, T, D) f32, BH = G * BHkv, D <= 128.
// Returns cudaGetLastError().
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* out, int BH, int S,
                                     int T, int D, int G, float scale,
                                     int causal, int q_offset,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (D > DMAX) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) *
      ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D +
       (size_t)BQ * BK + 3 * BQ);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid((S + BQ - 1) / BQ, BH);
  flash_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T, D, G,
      scale, causal, q_offset);
  return (int)cudaGetLastError();
}
