"""Where a block of ``flash_mma_kernel`` spends its time, on the card.

Copies this checkout's ``src/`` to ``build/flash_attention_phases/``, adds
clock reads to the copy of ``kernels/csrc/flash_attention.cu`` (lane 0 of
warp ``--warp`` of each block; warp 0 holds the block's earliest rows,
warp 2 its latest, both with the first key part;
%globaltimer at the block's start and end, clock64 after q is split and
stored (tile 0 streams in meanwhile), and at the end: the row
sums handed over, their barrier, the stores; inside the tile loop, summed
over the tiles: the wait for a tile's copy and its barrier, the next
tile's copies issued, the scores,
the softmax (with the row maxima's barrier), the barrier that publishes p,
P.V), builds it, and calls ``flash_attention`` on the fixed-slot
prefill's shape (B = 1, S = T = ``--seq``, H = 28, KV = 4, D = 128,
causal, seeded inputs).  Prints, for the last call, quantiles
(0/50/90/100) of each phase over the blocks that walk each number of
tiles, in microseconds at the clock given by ``--ghz``.  The instrumented
copy is for diagnosis only; its times include the clock reads.

    python3 scripts/flash_attention_phases.py [--seq 192] [--ghz 1.98]
                                              [--warp 0]
"""

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "build" / "flash_attention_phases"

DECL = """__device__ unsigned long long g_fp_clk[12][1024];
__device__ unsigned long long g_fp_ns[2][1024];
__device__ int g_fp_tiles[1024];
__device__ __forceinline__ unsigned long long fp_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define FP_ON (threadIdx.x == 32 * FP_WARP && blockIdx.x < 1024)
"""

# (anchor, replacement): every anchor must occur exactly once
PATCHES = [
    ("template <int DP>\n__global__ void __launch_bounds__(kThreads, 1)\n"
     "flash_mma_kernel(",
     DECL + "template <int DP>\n__global__ void __launch_bounds__("
     "kThreads, 1)\nflash_mma_kernel("),
    ("  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n",
     "  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
     "  if (FP_ON) g_fp_ns[0][blockIdx.x] = fp_ns();\n"
     "  const unsigned long long fp_c0 = clock64();\n"
     "  unsigned long long fp_t = 0, fp_wait = 0, fp_sc = 0, fp_sm = 0, "
     "fp_pv = 0, fp_free = 0, fp_issue = 0;\n"),
    # the row sums' hand-over and its barrier
    ("  __syncthreads();\n  if (!has_cols) return;\n",
     "  if (FP_ON) g_fp_clk[9][blockIdx.x] = clock64() - fp_c0;\n"
     "  __syncthreads();\n"
     "  if (FP_ON) g_fp_clk[10][blockIdx.x] = clock64() - fp_c0;\n"
     "  if (!has_cols) return;\n"),
    ("  // ---- this thread's place:",
     "  if (FP_ON) { g_fp_clk[0][blockIdx.x] = clock64() - fp_c0; "
     "g_fp_tiles[blockIdx.x] = n_tiles; }\n"
     "  // ---- this thread's place:"),
    # the tile loop: the wait for the tile and the barrier; the scores;
    # the row maxima (their barrier), p and its split terms written; the
    # barrier that publishes p; P.V
    ("    cp_async_wait<0>();  // this thread's pieces of tile j\n",
     "    fp_t = clock64();\n"
     "    cp_async_wait<0>();  // this thread's pieces of tile j\n"),
    ("    if (j + 1 < n_tiles) copy_tile(j + 1);\n    cp_async_commit();\n",
     "    fp_wait += clock64() - fp_t; fp_t = clock64();\n"
     "    if (j + 1 < n_tiles) copy_tile(j + 1);\n    cp_async_commit();\n"
     "    fp_issue += clock64() - fp_t; fp_t = clock64();\n"),
    ("    // the tile's row maxima: each part's, then all four\n",
     "    fp_sc += clock64() - fp_t; fp_t = clock64();\n"
     "    // the tile's row maxima: each part's, then all four\n"),
    ("    __syncthreads();  // every part's p is in\n",
     "    fp_sm += clock64() - fp_t; fp_t = clock64();\n"
     "    __syncthreads();  // every part's p is in\n"
     "    fp_free += clock64() - fp_t; fp_t = clock64();\n"),
    ("mma_tf32(acc[1][nt], abig, bb[nt]);\n        }\n      }\n    }\n  }\n",
     "mma_tf32(acc[1][nt], abig, bb[nt]);\n        }\n      }\n    }\n"
     "    fp_pv += clock64() - fp_t;\n  }\n"),
    ("  // ---- the row sums:",
     "  if (FP_ON) {\n    g_fp_clk[1][blockIdx.x] = clock64() - fp_c0;\n"
     "    g_fp_clk[2][blockIdx.x] = fp_wait;\n"
     "    g_fp_clk[3][blockIdx.x] = fp_sc;\n"
     "    g_fp_clk[4][blockIdx.x] = fp_sm;\n"
     "    g_fp_clk[5][blockIdx.x] = fp_pv;\n"
     "    g_fp_clk[6][blockIdx.x] = fp_free;\n"
     "    g_fp_clk[8][blockIdx.x] = fp_issue;\n  }\n"
     "  // ---- the row sums:"),
    ("}\n\ntemplate <int DP>\nint launch(",
     "  __syncwarp();\n"
     "  if (FP_ON) { g_fp_clk[7][blockIdx.x] = clock64() - fp_c0; "
     "g_fp_ns[1][blockIdx.x] = fp_ns(); }\n"
     "}\n\ntemplate <int DP>\nint launch("),
    ('extern "C" int repro_flash_attention(',
     'extern "C" int repro_fp_clocks(void* clk, void* ns, void* tiles) {\n'
     "  cudaError_t e = cudaMemcpyFromSymbol(clk, g_fp_clk, "
     "sizeof(g_fp_clk));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, g_fp_ns, "
     "sizeof(g_fp_ns));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(tiles, g_fp_tiles, "
     "sizeof(g_fp_tiles));\n  return (int)e;\n}\n\n"
     'extern "C" int repro_flash_attention('),
]


def instrumented_copy(warp: int) -> Path:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src", COPY / "src")
    cu = COPY / "src/repro_torch/kernels/csrc/flash_attention.cu"
    text = f"#define FP_WARP {warp}\n" + cu.read_text()
    for old, new in PATCHES:
        if text.count(old) != 1:
            raise SystemExit("anchor not found once in flash_attention.cu: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return COPY / "src"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seq", type=int, default=192,
                    help="S = T of the call (default 192)")
    ap.add_argument("--ghz", type=float, default=1.98,
                    help="SM clock to convert clock64 cycles (default 1.98)")
    ap.add_argument("--warp", type=int, default=0,
                    help="the warp whose lane 0 reads the clocks: m16 tile "
                    "warp % 3 (0: the block's earliest rows), key part "
                    "warp // 3 (default 0)")
    args = ap.parse_args()
    sys.path.insert(0, str(instrumented_copy(args.warp)))
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = build.load("flash_attention")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, S, H, KV, D = 1, args.seq, 28, 4, 128
    q = torch.randn((B * H, S, D), generator=gen, device="cuda")
    k = torch.randn((B * KV, S, D), generator=gen, device="cuda")
    v = torch.randn((B * KV, S, D), generator=gen, device="cuda")
    for _ in range(3):
        fa.flash_attention(q, k, v)
    torch.cuda.synchronize()
    clk = np.zeros((12, 1024), np.uint64)
    ns = np.zeros((2, 1024), np.uint64)
    tiles = np.zeros(1024, np.int32)
    if lib.repro_fp_clocks(clk.ctypes.data, ns.ctypes.data,
                           tiles.ctypes.data) != 0:
        raise SystemExit("reading the clocks failed")
    plan = fa.plan_flash(B, S, S, H, KV, D)
    blocks = plan.grid
    cyc = clk[:, :blocks].astype(np.int64) / (args.ghz * 1e3)
    ns = ns[:, :blocks].astype(np.int64) / 1e3
    tiles = tiles[:blocks]
    t0 = ns[0].min()

    def quantiles(a):
        return [round(float(np.percentile(a, p)), 3) for p in (0, 50, 90, 100)]

    phases = {"start_us": ns[0] - t0, "end_us": ns[1] - t0,
              "prologue_us": cyc[0],
              "tile_loop_us": cyc[1] - cyc[0],
              "wait_us": cyc[2], "issue_us": cyc[8], "scores_us": cyc[3],
              "softmax_us": cyc[4], "p_barrier_us": cyc[6], "pv_us": cyc[5],
              "sums_handover_us": cyc[9] - cyc[1],
              "sums_barrier_us": cyc[10] - cyc[9],
              "store_us": cyc[7] - cyc[10], "block_us": cyc[7]}
    out = {"S": S, "warp": args.warp, "blocks": blocks,
           "plan": plan._asdict(),
           "span_us": round(float((ns[1] - t0).max()), 3)}
    for n in sorted(set(tiles.tolist())):
        sel = tiles == n
        out[f"{n} tiles ({int(sel.sum())} blocks)"] = {
            k: quantiles(v[sel]) for k, v in phases.items()}
    print(json.dumps(out), flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
