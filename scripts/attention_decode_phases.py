"""Where a block of ``attention_decode_kernel`` spends its time, on the card.

Copies this checkout's ``src/`` to ``build/attention_decode_phases/``, adds
clock reads to the copy of ``kernels/csrc/flash_attention_quant.cu``
(thread 0 of each block: %globaltimer at its start and end, clock64 after
the kv_pos scan, once q and the K codes have landed, after the scores,
after the wait for every block of the cluster to start, around each
cluster barrier, after p and the QDQ, once the V codes have landed, after
P.V and its writes to the peers, and after the combine), builds it, and
calls ``flash_attention_quant`` on the main path's decode shape (B = 4,
S = 1, T = 512, H = 28, KV = 4, D = 128, int8 codes, probs QDQ n = 64)
with the rows of ``chip_smoke.py``'s timed check (positions 100, 510, 37
and a dead row) and with the main path's contexts (160, 41, 100 and a
dead row).  Prints, for the last call of each, quantiles (0/50/90/100) of each
phase over the blocks that take part and over those that skip, in
microseconds at the clock given by ``--ghz``, and the span from the first
block's start to the last block's end.  The instrumented copy is for
diagnosis only; its times include the clock reads.

    python3 scripts/attention_decode_phases.py [--ghz 1.98]
"""

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "build" / "attention_decode_phases"

DECL = """__device__ unsigned long long g_ad_clk[16][1024];
__device__ unsigned long long g_ad_ns[2][1024];
__device__ int g_ad_live[1024];
__device__ __forceinline__ unsigned long long ad_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int ad_bid() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
#define AD_CLK(i)                                            \\
  if (threadIdx.x == 0 && ad_bid() < 1024) g_ad_clk[i][ad_bid()] = clock64()
"""

# (anchor, replacement): every anchor must occur exactly once
PATCHES = [
    ("template <bool FP8>\n__global__ void __launch_bounds__(kThreads)\n"
     "attention_decode_kernel(",
     DECL + "template <bool FP8>\n__global__ void __launch_bounds__("
     "kThreads)\nattention_decode_kernel("),
    ("  const int nk = min(L, T - k0);  // keys of my range (C = ceil(T / L))\n"
     "  const int CP = prefill_cpitch(D);\n",
     "  const int nk = min(L, T - k0);  // keys of my range (C = ceil(T / L))\n"
     "  const int CP = prefill_cpitch(D);\n"
     "  if (threadIdx.x == 0 && ad_bid() < 1024) g_ad_ns[0][ad_bid()] = "
     "ad_ns();\n  AD_CLK(0);\n"),
    ("  const bool live = mine || !__syncthreads_or(any);\n",
     "  const bool live = mine || !__syncthreads_or(any);\n  AD_CLK(1);\n"
     "  if (threadIdx.x == 0 && ad_bid() < 1024) g_ad_live[ad_bid()] = "
     "live;\n"),
    ("    cp_async_wait<1>();\n    __syncthreads();\n",
     "    cp_async_wait<1>();\n    __syncthreads();\n    AD_CLK(2);\n"),
    ("  }\n  cluster_wait();",
     "  }\n  AD_CLK(3);\n  cluster_wait();\n  AD_CLK(4);"),
    ("  cluster.sync();  // every block's row maxima have landed\n",
     "  AD_CLK(5);\n  cluster.sync();  // every block's row maxima have "
     "landed\n  AD_CLK(6);\n"),
    ("  cluster.sync();  // the partial sums of every block that takes "
     "part\n",
     "  AD_CLK(7);\n  cluster.sync();  // the partial sums of every block "
     "that takes part\n  AD_CLK(8);\n"),
    ("    cp_async_wait<0>();\n    __syncthreads();\n\n    // ---- P.V",
     "    AD_CLK(9);\n    cp_async_wait<0>();\n    __syncthreads();\n"
     "    AD_CLK(10);\n\n    // ---- P.V"),
    ("  cluster.sync();  // the P.V partials of every block that takes "
     "part\n",
     "  AD_CLK(11);\n  cluster.sync();  // the P.V partials of every block "
     "that takes part\n  AD_CLK(12);\n"),
    ("    p.out[((size_t)b * p.H + kvh * G + r) * D + lo + j] = o;\n  }\n}\n",
     "    p.out[((size_t)b * p.H + kvh * G + r) * D + lo + j] = o;\n  }\n"
     "  __syncthreads();\n  AD_CLK(13);\n"
     "  if (threadIdx.x == 0 && ad_bid() < 1024) g_ad_ns[1][ad_bid()] = "
     "ad_ns();\n}\n"),
    ('extern "C" int repro_flash_attention_quant(',
     'extern "C" int repro_ad_clocks(void* clk, void* ns, void* live) {\n'
     "  cudaError_t e = cudaMemcpyFromSymbol(clk, g_ad_clk, "
     "sizeof(g_ad_clk));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, g_ad_ns, "
     "sizeof(g_ad_ns));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(live, g_ad_live, "
     "sizeof(g_ad_live));\n  return (int)e;\n}\n\n"
     'extern "C" int repro_flash_attention_quant('),
]

# phase -> (clock index after, clock index before); live-only phases are
# read on the blocks that take part
PHASES = {
    "scan_us": (1, 0), "k_copy_us": (2, 1), "scores_us": (3, 2),
    "start_wait_us": (4, 3), "max_us": (5, 4), "barrier1_us": (6, 5),
    "exp_sum_us": (7, 6), "barrier2_us": (8, 7), "p_qdq_us": (9, 8),
    "v_copy_us": (10, 9), "pv_us": (11, 10), "barrier3_us": (12, 11),
    "combine_us": (13, 12), "block_us": (13, 0),
}
LIVE_ONLY = {"k_copy_us", "scores_us", "p_qdq_us", "v_copy_us", "pv_us"}


def instrumented_copy() -> Path:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src", COPY / "src")
    cu = COPY / "src/repro_torch/kernels/csrc/flash_attention_quant.cu"
    text = cu.read_text()
    for old, new in PATCHES:
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
    B, T, H, KV, D = 4, 512, 28, 4, 128
    q = torch.randn((B, 1, H, D), generator=gen, device="cuda")
    kc, vc = torch.randint(-127, 128, (2, B, T, KV, D), generator=gen,
                           device="cuda", dtype=torch.int8)
    ks, vs = (torch.rand((B, T, KV), generator=gen, device="cuda") * 0.05
              + 1e-3 for _ in range(2))
    kw = dict(scale=D ** -0.5, causal=True, probs_n=64, probs_qmax=127.0,
              probs_qmin=-127.0, block_k=0)
    plan = faq.plan_attention(B, 1, T, H, KV, D, T, 64)
    blocks = int(np.prod(plan.grid))
    out = {"plan": plan._asdict(), "ghz": args.ghz}
    for name, starts in (("timed rows", [100, 510, 37, -1]),
                         ("main-path contexts", [160, 41, 100, -1])):
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
        clk = np.zeros((16, 1024), np.uint64)
        ns = np.zeros((2, 1024), np.uint64)
        live = np.zeros(1024, np.int32)
        if lib.repro_ad_clocks(clk.ctypes.data, ns.ctypes.data,
                               live.ctypes.data) != 0:
            raise SystemExit("reading the clocks failed")
        cyc = clk[:, :blocks].astype(np.int64) / (args.ghz * 1e3)
        t_ns = ns[:, :blocks].astype(np.int64) / 1e3
        live = live[:blocks].astype(bool)

        def quantiles(a):
            return [round(float(np.percentile(a, p)), 3)
                    for p in (0, 50, 90, 100)] if a.size else None

        res = {"span_us": round(float(t_ns[1].max() - t_ns[0].min()), 3),
               "start_spread_us": round(float(t_ns[0].max()
                                              - t_ns[0].min()), 3)}
        for sel_name, sel in (("live", live), ("skipped", ~live)):
            res[f"{sel_name} ({int(sel.sum())} blocks)"] = {
                k: quantiles((cyc[a] - cyc[b])[sel])
                for k, (a, b) in PHASES.items()
                if sel_name == "live" or k not in LIVE_ONLY}
        out[name] = res
    print(json.dumps(out), flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
