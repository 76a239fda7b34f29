"""Where a block of ``attention_decode_long_kernel`` spends its time, on the
card.

Copies this checkout's ``src/`` to ``build/attention_decode_long_phases/``,
adds clock reads to the copy of ``kernels/csrc/flash_attention_quant.cu``
(thread 0 of each block: %globaltimer at its start and end, clock64 after
the prologue (kv_pos scan, live units, walk list), after pass 1 (the
scores of its seen tiles), around the cluster barriers of the statistics
(the barrier after pass 1 and each bk tile's maxima; the prefix maxima
and each tile's sums), after the recurrence, the probabilities and the
QDQ, after P.V, and around the barrier of the P.V merge), builds
it, and calls ``flash_attention_quant`` on the long path's decode shape (B
= 4, S = 1, T = 8192, H = 28, KV = 4, D = 128, int8 codes, phased, bk =
512, probs QDQ n = 64) with the rows of ``chip_smoke.py``'s timed check
(positions 6007, 4107, 2507 and a dead row) and with early rows (4000,
700, 37 and a dead row).  Prints, for the last call of each, quantiles
(0/50/90/100) of each phase over the blocks of live rows that walk tiles,
over those of dead rows, and over those dealt nothing, in microseconds at
the clock given by ``--ghz``, the tiles each walked, the span from the
first block's start to the last block's end, and how many of the call's
clusters the card holds at once.  The instrumented copy is for
diagnosis only; its times include the clock reads.

    python3 scripts/attention_decode_long_phases.py [--ghz 1.98] [--T 8192]
"""

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "build" / "attention_decode_long_phases"

DECL = """__device__ unsigned long long g_dl_clk[12][1024];
__device__ unsigned long long g_dl_ns[2][1024];
__device__ int g_dl_info[2][1024];
__device__ unsigned long long g_dl_sub[4][1024];
__device__ __forceinline__ unsigned long long dl_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int dl_bid() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
#define DL_CLK(i)                                            \\
  if (threadIdx.x == 0 && dl_bid() < 1024) g_dl_clk[i][dl_bid()] = clock64()
"""

# pass 2's wait and issue times, stored where P.V ends (either branch)
SUB_STORE = ("    if (threadIdx.x == 0 && dl_bid() < 1024) {\n"
             "      g_dl_sub[2][dl_bid()] = dl_wait;\n"
             "      g_dl_sub[3][dl_bid()] = dl_issue;\n    }\n")

# (anchor, replacement[, times it occurs]): each anchor must occur exactly
# once unless a count is given
PATCHES = [
    ("template <bool FP8>\n__global__ void __launch_bounds__(kThreads, 1)\n"
     "attention_decode_long_kernel(",
     DECL + "template <bool FP8>\n__global__ void __launch_bounds__("
     "kThreads, 1)\nattention_decode_long_kernel("),
    ("  const int span = p.unit / kDLTile;  // 64-key tiles a unit\n",
     "  const int span = p.unit / kDLTile;  // 64-key tiles a unit\n"
     "  if (threadIdx.x == 0 && dl_bid() < 1024) g_dl_ns[0][dl_bid()] = "
     "dl_ns();\n  DL_CLK(0);\n"
     "  unsigned long long dl_wait = 0, dl_issue = 0, dl_t0 = 0;\n"),
    ("  const int n_walk = cnt_s[1];\n",
     "  const int n_walk = cnt_s[1];\n  DL_CLK(1);\n"
     "  if (threadIdx.x == 0 && dl_bid() < 1024) {\n"
     "    g_dl_info[0][dl_bid()] = dead;\n"
     "    g_dl_info[1][dl_bid()] = n_walk;\n  }\n"),
    ("    cp_async_wait<R - 4>();  // my pieces of loads J, J + 1 (and q)\n"
     "    __syncthreads();  // everyone's; the stages of loads before J "
     "are free\n    while (next < min(J + R, p1)) copy_tile(next++);\n",
     "    dl_t0 = clock64();\n"
     "    cp_async_wait<R - 4>();  // my pieces of loads J, J + 1 (and q)\n"
     "    __syncthreads();  // everyone's; the stages of loads before J "
     "are free\n    dl_wait += clock64() - dl_t0;\n    dl_t0 = clock64();\n"
     "    while (next < min(J + R, p1)) copy_tile(next++);\n"
     "    dl_issue += clock64() - dl_t0;\n"),
    # pass 2's loop, the dead row's and the tensor-core one: both patched
    ("      cp_async_wait<R - 2>();  // my pieces of load J\n"
     "      __syncthreads();  // everyone's; the stages of loads before J are "
     "free\n      while (next < J + R) copy_tile(next++);\n",
     "      dl_t0 = clock64();\n"
     "      cp_async_wait<R - 2>();  // my pieces of load J\n"
     "      __syncthreads();  // everyone's; the stages of loads before J are "
     "free\n      dl_wait += clock64() - dl_t0;\n      dl_t0 = clock64();\n"
     "      while (next < J + R) copy_tile(next++);\n"
     "      dl_issue += clock64() - dl_t0;\n",
     2),
    ("  __syncthreads();  // every score of my range is in place\n",
     "  __syncthreads();  // every score of my range is in place\n"
     "  DL_CLK(2);\n  if (threadIdx.x == 0 && dl_bid() < 1024) {\n"
     "    g_dl_sub[0][dl_bid()] = dl_wait;\n"
     "    g_dl_sub[1][dl_bid()] = dl_issue;\n  }\n"
     "  dl_wait = dl_issue = 0;\n"),
    ("  cluster.sync();  // every tile's maxima are in place\n",
     "  DL_CLK(3);\n  cluster.sync();  // every tile's maxima are in "
     "place\n  DL_CLK(4);\n"),
    ("  cluster.sync();  // every tile's sums are in place\n",
     "  DL_CLK(5);\n  cluster.sync();  // every tile's sums are in "
     "place\n  DL_CLK(6);\n"),
    ("  __syncthreads();\n  if (dead) {\n    // ---- pass 2 of a dead row",
     "  __syncthreads();\n  DL_CLK(7);\n  if (dead) {\n    // ---- pass 2 of "
     "a dead row"),
    ("    cp_async_wait<0>();\n    // my partials (hi + (mid + lo)), to the "
     "block owning each column (block\n",
     "    cp_async_wait<0>();\n    DL_CLK(8);\n" + SUB_STORE +
     "    // my partials (hi + (mid + lo)), to the block owning each column "
     "(block\n"),
    ("    cp_async_wait<0>();\n    float* part = reinterpret_cast<float*>(vt);"
     "  // nh x D\n",
     "    cp_async_wait<0>();\n    DL_CLK(8);\n" + SUB_STORE +
     "    float* part = reinterpret_cast<float*>(vt);  // nh x D\n"),
    ("  cluster.sync();  // every P.V partial has landed; no remote access "
     "after\n",
     "  DL_CLK(9);\n  cluster.sync();  // every P.V partial has landed; no "
     "remote access after\n  DL_CLK(10);\n"),
    ("    if (online) o = o / fmaxf(l_s[r], 1e-30f);\n"
     "    p.out[((size_t)b * p.H + kvh * G + r) * D + lo + j] = o;\n  }\n}\n",
     "    if (online) o = o / fmaxf(l_s[r], 1e-30f);\n"
     "    p.out[((size_t)b * p.H + kvh * G + r) * D + lo + j] = o;\n  }\n"
     "  __syncthreads();\n  DL_CLK(11);\n"
     "  if (threadIdx.x == 0 && dl_bid() < 1024) g_dl_ns[1][dl_bid()] = "
     "dl_ns();\n}\n"),
    ('extern "C" int repro_flash_attention_quant(',
     'extern "C" int repro_dl_max_clusters(int C, int KV, int B, int smem) '
     "{\n  cudaFuncSetAttribute(attention_decode_long_kernel<false>, "
     "cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
     "  cudaLaunchAttribute attr[1];\n"
     "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
     "  attr[0].val.clusterDim.x = C;\n  attr[0].val.clusterDim.y = 1;\n"
     "  attr[0].val.clusterDim.z = 1;\n  cudaLaunchConfig_t cfg = {};\n"
     "  cfg.gridDim = dim3(C, KV, B);\n  cfg.blockDim = dim3(kThreads);\n"
     "  cfg.dynamicSmemBytes = smem;\n  cfg.attrs = attr;\n"
     "  cfg.numAttrs = 1;\n  int n = -1;\n"
     "  if (cudaOccupancyMaxActiveClusters(&n, "
     "attention_decode_long_kernel<false>, &cfg) != cudaSuccess) "
     "return -1;\n  return n;\n}\n\n"
     'extern "C" int repro_dl_clocks(void* clk, void* ns, void* info, '
     'void* sub) {\n'
     "  cudaError_t e = cudaMemcpyFromSymbol(clk, g_dl_clk, "
     "sizeof(g_dl_clk));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, g_dl_ns, "
     "sizeof(g_dl_ns));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(info, g_dl_info, "
     "sizeof(g_dl_info));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(sub, g_dl_sub, "
     "sizeof(g_dl_sub));\n  return (int)e;\n}\n\n"
     'extern "C" int repro_flash_attention_quant('),
]

# phase -> (clock index after, clock index before)
PHASES = {
    "prologue_us": (1, 0), "pass1_scores_us": (2, 1),
    # the barrier after pass 1 and each bk tile's maxima; the prefix
    # maxima and each tile's sums; the recurrence, p and the QDQ
    "tile_max_us": (3, 2), "max_barrier_us": (4, 3), "tile_sum_us": (5, 4),
    "sum_barrier_us": (6, 5), "probs_qdq_us": (7, 6), "pv_us": (8, 7),
    "pv_partials_us": (9, 8), "pv_merge_barrier_us": (10, 9),
    "store_us": (11, 10), "block_us": (11, 0),
}


# parts of the two streamed loops, summed over a block's tiles: waiting
# for the tile's copy (and the block barrier), issuing the next one
SUBS = ("pass1_wait_us", "pass1_issue_us", "pv_wait_us", "pv_issue_us")


def instrumented_copy() -> Path:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src", COPY / "src")
    cu = COPY / "src/repro_torch/kernels/csrc/flash_attention_quant.cu"
    text = cu.read_text()
    for old, new, *times in PATCHES:
        if text.count(old) != (times[0] if times else 1):
            raise SystemExit("anchor not found as often as expected in "
                             f"flash_attention_quant.cu: {old[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return COPY / "src"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ghz", type=float, default=1.98,
                    help="SM clock to convert clock64 cycles (default 1.98)")
    ap.add_argument("--T", type=int, default=8192,
                    help="keys of the call (default 8192, the long path's)")
    args = ap.parse_args()
    sys.path.insert(0, str(instrumented_copy()))
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_quant as faq

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = build.load("flash_attention_quant")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, T, H, KV, D = 4, args.T, 28, 4, 128
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda")
    kc, vc = torch.randint(-127, 128, (2, B, T, KV, D), generator=gen,
                           device="cuda", dtype=torch.int8)
    ks, vs = (torch.rand((B, T, KV), generator=gen, device="cuda") * 0.05
              + 1e-3 for _ in range(2))
    kw = dict(scale=D ** -0.5, causal=True, probs_n=64, probs_qmax=127.0,
              probs_qmin=-127.0, block_k=512)
    plan = faq.plan_attention(B, 1, T, H, KV, D, 512, 64)
    assert plan.kernel == "attention_decode_long_kernel", plan
    blocks = int(np.prod(plan.grid))
    out = {"plan": plan._asdict(), "ghz": args.ghz,
           # clusters the card can hold at once at this plan
           # (cudaOccupancyMaxActiveClusters), beside the grid's
           "max_active_clusters": lib.repro_dl_max_clusters(
               plan.cluster, KV, B, plan.smem_bytes),
           "clusters": KV * B}
    scale = T / 8192
    for name, starts in (("timed rows", [6007, 4107, 2507, -1]),
                         ("early rows", [4000, 700, 37, -1])):
        starts = [int(s * scale) if s > 0 else s for s in starts]
        st = torch.tensor(starts, dtype=torch.int32, device="cuda")
        q_pos = torch.clamp_min(st, 0)[:, None].contiguous()
        n_ctx = torch.where(st >= 0, st + 1, torch.zeros_like(st))
        idx = torch.arange(T, dtype=torch.int32, device="cuda")[None]
        kv_pos = torch.where(idx < n_ctx[:, None], idx,
                             torch.full_like(idx, -1)).contiguous()
        call_args = (q, kc.contiguous(), vc.contiguous(), ks, vs, q_pos,
                     kv_pos)
        for _ in range(3):
            faq._flash_attention_quant(*call_args, 1 << 30, plan=plan, **kw)
        torch.cuda.synchronize()
        clk = np.zeros((12, 1024), np.uint64)
        ns = np.zeros((2, 1024), np.uint64)
        info = np.zeros((2, 1024), np.int32)
        sub = np.zeros((4, 1024), np.uint64)
        if lib.repro_dl_clocks(clk.ctypes.data, ns.ctypes.data,
                               info.ctypes.data, sub.ctypes.data) != 0:
            raise SystemExit("reading the clocks failed")
        cyc = clk[:, :blocks].astype(np.int64) / (args.ghz * 1e3)
        t_ns = ns[:, :blocks].astype(np.int64) / 1e3
        subs = sub[:, :blocks].astype(np.int64) / (args.ghz * 1e3)
        dead = info[0, :blocks].astype(bool)
        walk = info[1, :blocks]

        def quantiles(a):
            return [round(float(np.percentile(a, p)), 3)
                    for p in (0, 50, 90, 100)] if a.size else None

        res = {"rows": starts,
               "span_us": round(float(t_ns[1].max() - t_ns[0].min()), 3),
               "start_spread_us": round(float(t_ns[0].max()
                                              - t_ns[0].min()), 3)}
        for sel_name, sel in (("live", ~dead & (walk > 0)), ("dead", dead),
                              ("dealt nothing", ~dead & (walk == 0))):
            res[f"{sel_name} ({int(sel.sum())} blocks)"] = {
                "tiles_walked": quantiles(walk[sel].astype(float)),
                **{k: quantiles((cyc[a] - cyc[b])[sel])
                   for k, (a, b) in PHASES.items()},
                **{k: quantiles(subs[i][sel]) for i, k in enumerate(SUBS)}}
        out[name] = res
    print(json.dumps(out), flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
