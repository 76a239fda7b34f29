"""Where a block of ``attention_long_kernel`` spends its time, on the card.

Copies this checkout's ``src/`` to ``build/attention_long_phases/``, adds
clock reads to the copy of ``kernels/csrc/flash_attention_quant.cu``
(thread 0 of each block: %globaltimer at its start and end; clock64 after
the prologue (q's copy issued, the unit flags and the live list), after
pass 1, after the cluster's statistics merge, after pass 2 and after the
P.V merge; inside each pass, the time to the barrier that publishes a
staged unit, pass 1's scores and their store with the statistics, pass
2's scores formed again (``--recompute``: no score store) and its
probabilities; a tile no position sees skips pass 1 and sums V's columns
in pass 2, which is timed whole), builds it, and calls
``flash_attention_quant`` on the long path's chunk shape (B = 4, S = 64,
T = 8192, H = 28, KV = 4, D = 128, int8 codes, phased, bk = 512, probs QDQ
n = 64; batch rows starting at 8128, 5000, 2000 and a dead row, as
``chip_smoke.py``'s timed check and with its inputs, or the starts given
by ``--starts``).  Prints, for the last call, quantiles (0/50/90/100) of
each phase over the blocks dealt each number of units, in microseconds at
the clock given by ``--ghz``.  The instrumented copy is for diagnosis
only; its times include the clock reads.

    python3 scripts/attention_long_phases.py [--ghz 1.98] [--starts 8128,5000,2000,-1] [--recompute]
"""

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "build" / "attention_long_phases"

DECL = """__device__ unsigned long long g_al_clk[12][1024];
__device__ unsigned long long g_al_ns[2][1024];
__device__ int g_al_units[2][1024];
__device__ __forceinline__ unsigned long long al_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int al_bid() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
#define AL_ON (threadIdx.x == 0 && al_bid() < 1024)
#define AL_CLK(i) \\
  if (AL_ON) g_al_clk[i][al_bid()] = clock64()
"""

# (anchor, replacement): every anchor must occur exactly once.  Clocks 0-5:
# start, prologue end, pass 1 end, merge end, pass 2 end, block end;
# 6-11: summed over the units of pass 1 (staging, scores, the scores'
# store and the statistics) and of pass 2 (staging, probabilities up to
# P.V, the scores formed again).
PATCHES = [
    ("template <bool FP8>\n__global__ void __launch_bounds__(kThreads, 1)\n"
     "attention_long_kernel(",
     DECL + "template <bool FP8>\n__global__ void __launch_bounds__("
     "kThreads, 1)\nattention_long_kernel("),
    ("  const bool online = p.mode == 1;\n",
     "  const bool online = p.mode == 1;\n"
     "  if (AL_ON) g_al_ns[0][al_bid()] = al_ns();\n  AL_CLK(0);\n"
     "  unsigned long long al_t = 0, al_acc[6] = {0, 0, 0, 0, 0, 0};\n"),
    ("      all_dead ? n_mine : p1 + (span == 1 ? 1 : 2) * n_mine;\n",
     "      all_dead ? n_mine : p1 + (span == 1 ? 1 : 2) * n_mine;\n"
     "  AL_CLK(1);\n  if (AL_ON) { g_al_units[0][al_bid()] = n_mine; "
     "g_al_units[1][al_bid()] = *n_live_s; }\n"),
    ("    cp_async_wait<0>();  // this thread's pieces of load J (and of q)\n",
     "    al_t = clock64();\n"
     "    cp_async_wait<0>();  // this thread's pieces of load J (and of q)\n"),
    ("    __syncthreads();\n    unit_scores(unit, seen, st);\n"
     "    __syncthreads();\n",
     "    __syncthreads();\n    al_acc[0] += clock64() - al_t; al_t = clock64();\n"
     "    unit_scores(unit, seen, st);\n    __syncthreads();\n"
     "    al_acc[1] += clock64() - al_t; al_t = clock64();\n"),
    ("      m[rr] = m_new;\n    }\n  }\n",
     "      m[rr] = m_new;\n    }\n    al_acc[2] += clock64() - al_t;\n  }\n"
     "  AL_CLK(2);\n"),
    ("    if (lane == 0) l_s[r] = sum;\n  }\n",
     "    if (lane == 0) l_s[r] = sum;\n  }\n  AL_CLK(3);\n"),
    ("    cp_async_wait<0>();  // this thread's pieces of load J\n",
     "    al_t = clock64();\n"
     "    cp_async_wait<0>();  // this thread's pieces of load J\n"),
    ("    copy_tile(J + 1);\n    __syncthreads();\n    if (seen && !stored)",
     "    copy_tile(J + 1);\n    __syncthreads();\n"
     "    al_acc[3] += clock64() - al_t; al_t = clock64();\n"
     "    if (seen && !stored)"),
    ("      unit_scores(unit, true, st);\n      __syncthreads();\n    }\n",
     "      unit_scores(unit, true, st);\n      __syncthreads();\n    }\n"
     "    al_acc[5] += clock64() - al_t; al_t = clock64();\n"),
    ("    __syncthreads();\n#pragma unroll\n    for (int k = 0; k < kPKeys / 16;"
     " ++k) {",
     "    __syncthreads();\n    al_acc[4] += clock64() - al_t;\n"
     "#pragma unroll\n    for (int k = 0; k < kPKeys / 16; ++k) {"),
    ("  const int W = D / C;\n",
     "  AL_CLK(4);\n  if (AL_ON) for (int u = 0; u < 6; ++u) "
     "g_al_clk[6 + u][al_bid()] = al_acc[u];\n  const int W = D / C;\n"),
    ('extern "C" int repro_flash_attention_quant(',
     'extern "C" int repro_al_clocks(void* clk, void* ns, void* units) {\n'
     "  cudaError_t e = cudaMemcpyFromSymbol(clk, g_al_clk, "
     "sizeof(g_al_clk));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, g_al_ns, "
     "sizeof(g_al_ns));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(units, g_al_units, "
     "sizeof(g_al_units));\n  return (int)e;\n}\n\n"
     'extern "C" int repro_flash_attention_quant('),
]
# the block's end: after its stores, the last statement of the kernel
END_ANCHOR = "          j] = v;\n  }\n"


def instrumented_copy() -> Path:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src", COPY / "src")
    cu = COPY / "src/repro_torch/kernels/csrc/flash_attention_quant.cu"
    text = cu.read_text()
    for old, new in PATCHES + [(END_ANCHOR, END_ANCHOR + (
            "  __syncthreads();\n  AL_CLK(5);\n"
            "  if (AL_ON) g_al_ns[1][al_bid()] = al_ns();\n"))]:
        if text.count(old) != 1:
            raise SystemExit("anchor not found once in "
                             f"flash_attention_quant.cu: {old[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return COPY / "src"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ghz", type=float, default=1.98,
                    help="SM clock to convert clock64 cycles (default 1.98)")
    ap.add_argument("--starts", default="8128,5000,2000,-1",
                    help="first position of each batch row's chunk (-1: a "
                    "dead row)")
    ap.add_argument("--recompute", action="store_true",
                    help="pass 2 forms the scores again (no score store)")
    args = ap.parse_args()
    sys.path.insert(0, str(instrumented_copy()))
    sys.path.append(str(ROOT))
    import numpy as np
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention_quant as faq

    # after repro_torch: chip_smoke puts this checkout's src/ first on the
    # path, and the package must stay the instrumented copy's
    from chip_smoke import attention_inputs

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = build.load("flash_attention_quant")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    starts = [int(x) for x in args.starts.split(",")]
    B, S, T, H, KV, D = len(starts), 64, 8192, 28, 4, 128
    args_ = attention_inputs(torch, gen, B=B, S=S, T=T, H=H, KV=KV, D=D,
                             fp8=False, q_starts=starts)
    kw = dict(scale=D ** -0.5, causal=True, probs_n=64, probs_qmax=127.0,
              probs_qmin=-127.0, block_k=512)
    plan = faq.plan_attention(B, S, T, H, KV, D, 512, 64)
    if args.recompute:
        plan = plan._replace(slots=0)
    for _ in range(3):
        faq._flash_attention_quant(*args_, 1 << 30, plan=plan, **kw)
    torch.cuda.synchronize()
    clk = np.zeros((12, 1024), np.uint64)
    ns = np.zeros((2, 1024), np.uint64)
    units = np.zeros((2, 1024), np.int32)
    if lib.repro_al_clocks(clk.ctypes.data, ns.ctypes.data,
                           units.ctypes.data) != 0:
        raise SystemExit("reading the clocks failed")
    blocks = int(np.prod(plan.grid))
    cyc = clk[:, :blocks].astype(np.int64) / (args.ghz * 1e3)
    ns = ns[:, :blocks].astype(np.int64) / 1e3
    mine, live = units[0, :blocks], units[1, :blocks]
    t0 = ns[0].min()

    def quantiles(a):
        return [round(float(np.percentile(a, p)), 3) for p in (0, 50, 90, 100)]

    phases = {"start_us": ns[0] - t0, "end_us": ns[1] - t0,
              "prologue_us": cyc[1] - cyc[0],
              "pass1_us": cyc[2] - cyc[1], "merge_us": cyc[3] - cyc[2],
              "pass2_us": cyc[4] - cyc[3], "pv_merge_us": cyc[5] - cyc[4],
              "p1_staging_us": cyc[6], "p1_scores_us": cyc[7],
              "p1_store_stats_us": cyc[8], "p2_staging_us": cyc[9],
              "p2_probs_us": cyc[10], "p2_scores_us": cyc[11],
              # the rest of pass 2: P.V (and a wide group's pre-pass)
              "p2_pv_us": cyc[4] - cyc[3] - cyc[9] - cyc[10] - cyc[11]}
    out = {"blocks": blocks, "plan": plan._asdict(), "starts": starts,
           "recompute": args.recompute,
           "span_us": float(ns[1].max() - t0)}
    for n in sorted(set(zip(mine.tolist(), live.tolist()))):
        sel = (mine == n[0]) & (live == n[1])
        out[f"{n[0]} of {n[1]} units ({int(sel.sum())} blocks)"] = {
            k: quantiles(v[sel]) for k, v in phases.items()}
    print(json.dumps(out), flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
