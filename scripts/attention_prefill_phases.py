"""Where a block of ``attention_prefill_kernel`` spends its time, on the card.

Copies this checkout's ``src/`` to ``build/attention_prefill_phases/``,
adds clock reads to the copy of ``kernels/csrc/flash_attention_quant.cu``
(thread 0 of each block: %globaltimer at its start and end, clock64 after
the prologue (tile flags, q's rows), after the scores, after the softmax
and QDQ, after P.V; inside the score loop, the time to the barrier that
publishes a staged tile and the time after it; inside the softmax, each
pass over warp 0's rows), builds it, and calls
``flash_attention_quant`` on the main path's prefill shape (B = 4, S = 64,
T = 512, H = 28, KV = 4, D = 128, int8 codes, probs QDQ n = 64; batch
rows starting at 0, 448, 128 and a dead row, as ``chip_smoke.py``'s timed
check).  Prints, for the last call, quantiles (0/50/90/100) of each phase
over the blocks that walk each number of tiles, in microseconds at the
clock given by ``--ghz``.  The instrumented copy is for diagnosis only;
its times include the clock reads.

    python3 scripts/attention_prefill_phases.py [--ghz 1.755]
"""

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "build" / "attention_prefill_phases"

DECL = """__device__ unsigned long long g_ap_clk[12][1024];
__device__ unsigned long long g_ap_ns[2][1024];
__device__ int g_ap_live[1024];
__device__ __forceinline__ unsigned long long ap_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int ap_bid() {
  return (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
}
#define AP_CLK(i)                                            \\
  if (threadIdx.x == 0 && ap_bid() < 1024) g_ap_clk[i][ap_bid()] = clock64()
"""

# (anchor, replacement): every anchor must occur exactly once
PATCHES = [
    ("template <bool FP8>\n__global__ void __launch_bounds__(kThreads, 1)\n"
     "attention_prefill_kernel(",
     DECL + "template <bool FP8>\n__global__ void __launch_bounds__("
     "kThreads, 1)\nattention_prefill_kernel("),
    ("  const int VP = prefill_vpitch(D);\n",
     "  const int VP = prefill_vpitch(D);\n"
     "  if (threadIdx.x == 0 && ap_bid() < 1024) g_ap_ns[0][ap_bid()] = "
     "ap_ns();\n  AP_CLK(0);\n  unsigned long long ap_t = 0, ap_st = 0, "
     "ap_mm = 0, ap_s = 0, ap_sm[4] = {0, 0, 0, 0};\n"),
    ("  const int n_live = *n_live_s;\n",
     "  const int n_live = *n_live_s;\n  AP_CLK(1);\n"
     "  if (threadIdx.x == 0 && ap_bid() < 1024) g_ap_live[ap_bid()] = "
     "n_live;\n"),
    ("    const int t0 = live_s[J] * kPKeys;\n    cp_async_wait<0>();",
     "    ap_t = clock64();\n"
     "    const int t0 = live_s[J] * kPKeys;\n    cp_async_wait<0>();"),
    ("    copy_tile(J + 1);\n    __syncthreads();\n    float acc[4][4];",
     "    copy_tile(J + 1);\n    __syncthreads();\n"
     "    ap_st += clock64() - ap_t; ap_t = clock64();\n    float acc[4][4];"),
    ("            key_visible(kpos_s[t], qp, p) ? acc[i][jj] * p.scale : "
     "NEG_INF;\n      }\n    }\n  }\n",
     "            key_visible(kpos_s[t], qp, p) ? acc[i][jj] * p.scale : "
     "NEG_INF;\n      }\n    }\n    ap_mm += clock64() - ap_t;\n  }\n"
     "  AP_CLK(5); if (threadIdx.x == 0 && ap_bid() < 1024) "
     "g_ap_clk[6][ap_bid()] = ap_st;\n"
     "  if (threadIdx.x == 0 && ap_bid() < 1024) g_ap_clk[7][ap_bid()] = "
     "ap_mm;\n"),
    # the softmax's passes, over warp 0's rows
    ("  constexpr int kRW = kPRows / kWarps;  // rows a warp\n",
     "  ap_s = clock64();\n"
     "  constexpr int kRW = kPRows / kWarps;  // rows a warp\n"),
    ("  for (int rr = 0; rr < kRW; ++rr) m[rr] = warp_max(m[rr]);\n",
     "  for (int rr = 0; rr < kRW; ++rr) m[rr] = warp_max(m[rr]);\n"
     "  ap_sm[0] += clock64() - ap_s; ap_s = clock64();\n"),
    ("  for (int rr = 0; rr < kRW; ++rr) sum[rr] = warp_sum(sum[rr]);\n",
     "  for (int rr = 0; rr < kRW; ++rr) sum[rr] = warp_sum(sum[rr]);\n"
     "  ap_sm[1] += clock64() - ap_s; ap_s = clock64();\n"),
    ("        step[rr] = probs_step(div_rn(warp_max(emax[rr]), sum[rr]), "
     "qmax);\n    }\n",
     "        step[rr] = probs_step(div_rn(warp_max(emax[rr]), sum[rr]), "
     "qmax);\n    }\n    ap_sm[2] += clock64() - ap_s; ap_s = clock64();\n"),
    ("        for (int rr = 0; rr < kRW; ++rr) rows[rr][t] = w[rr] * vs;\n"
     "      }\n    }\n",
     "        for (int rr = 0; rr < kRW; ++rr) rows[rr][t] = w[rr] * vs;\n"
     "      }\n    }\n    ap_sm[3] += clock64() - ap_s; ap_s = clock64();\n"),
    ("  __syncthreads();\n\n  // ---- softmax, probs QDQ",
     "  __syncthreads();\n  AP_CLK(2);\n\n  // ---- softmax, probs QDQ"),
    ("  __syncthreads();\n\n  // ---- P.V over the live tiles",
     "  __syncthreads();\n  AP_CLK(3);\n"
     "  if (threadIdx.x == 0 && ap_bid() < 1024)\n"
     "    for (int u = 0; u < 4; ++u) g_ap_clk[8 + u][ap_bid()] = ap_sm[u];\n"
     "\n  // ---- P.V over the live tiles"),
    ("  // ---- store the block's real rows\n",
     "  AP_CLK(4);\n  // ---- store the block's real rows\n"),
    ('extern "C" int repro_flash_attention_quant(',
     'extern "C" int repro_ap_clocks(void* clk, void* ns, void* live) {\n'
     "  cudaError_t e = cudaMemcpyFromSymbol(clk, g_ap_clk, "
     "sizeof(g_ap_clk));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(ns, g_ap_ns, "
     "sizeof(g_ap_ns));\n"
     "  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(live, g_ap_live, "
     "sizeof(g_ap_live));\n  return (int)e;\n}\n\n"
     'extern "C" int repro_flash_attention_quant('),
]
# the block's end time: after its stores, the last statement of the kernel
END_ANCHOR = ("          *reinterpret_cast<float2*>(o + 16 * dp + 8 * nt "
              "+ 2 * jl) =")


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
    # the kernel's closing brace, after its stores
    i = text.index(END_ANCHOR)
    j = text.index("}\n\ntemplate <bool FP8>\nint launch_prefill(", i)
    text = (text[:j] + "  __syncthreads();\n  if (threadIdx.x == 0 && "
            "ap_bid() < 1024) g_ap_ns[1][ap_bid()] = ap_ns();\n" + text[j:])
    cu.write_text(text)
    return COPY / "src"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ghz", type=float, default=1.755,
                    help="SM clock to convert clock64 cycles (default 1.755)")
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
    B, S, T, H, KV, D = 4, 64, 512, 28, 4, 128
    q = torch.randn((B, S, H, D), generator=gen, device="cuda")
    kc, vc = torch.randint(-127, 128, (2, B, T, KV, D), generator=gen,
                           device="cuda", dtype=torch.int8)
    ks, vs = (torch.rand((B, T, KV), generator=gen, device="cuda") * 0.05
              + 1e-3 for _ in range(2))
    starts = torch.tensor([0, 448, 128, -1], dtype=torch.int32,
                          device="cuda")
    q_pos = (torch.clamp_min(starts, 0)[:, None]
             + torch.arange(S, dtype=torch.int32, device="cuda")[None])
    n_ctx = torch.where(starts >= 0, starts + S, torch.zeros_like(starts))
    idx = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    kv_pos = torch.where(idx < n_ctx[:, None], idx, torch.full_like(idx, -1))
    args_ = (q, kc.contiguous(), vc.contiguous(), ks, vs,
             q_pos.contiguous(), kv_pos.contiguous())
    kw = dict(scale=D ** -0.5, causal=True, probs_n=64, probs_qmax=127.0,
              probs_qmin=-127.0, block_k=0)
    plan = faq.plan_attention(B, S, T, H, KV, D, T, 64)
    for _ in range(3):
        faq._flash_attention_quant(*args_, 1 << 30, plan=plan, **kw)
    torch.cuda.synchronize()
    clk = np.zeros((12, 1024), np.uint64)
    ns = np.zeros((2, 1024), np.uint64)
    live = np.zeros(1024, np.int32)
    if lib.repro_ap_clocks(clk.ctypes.data, ns.ctypes.data,
                           live.ctypes.data) != 0:
        raise SystemExit("reading the clocks failed")
    blocks = int(np.prod(plan.grid))
    cyc = clk[:, :blocks].astype(np.int64) / (args.ghz * 1e3)
    ns = ns[:, :blocks].astype(np.int64) / 1e3
    live = live[:blocks]
    t0 = ns[0].min()

    def quantiles(a):
        return [round(float(np.percentile(a, p)), 3) for p in (0, 50, 90, 100)]

    phases = {"start_us": ns[0] - t0, "end_us": ns[1] - t0,
              "prologue_us": cyc[1] - cyc[0],
              "scores_us": cyc[5] - cyc[1],
              "scores_staging_us": cyc[6], "scores_compute_us": cyc[7],
              "softmax_qdq_us": cyc[3] - cyc[2],
              # warp 0's rows: max, exp and sum, the groups' steps,
              # then p, the QDQ and w
              "softmax_max_us": cyc[8], "softmax_exp_us": cyc[9],
              "softmax_steps_us": cyc[10], "softmax_qdq_pass_us": cyc[11],
              "pv_us": cyc[4] - cyc[3]}
    out = {"blocks": blocks, "plan": plan._asdict()}
    for n in sorted(set(live.tolist())):
        sel = live == n
        out[f"{n} tiles ({int(sel.sum())} blocks)"] = {
            k: quantiles(v[sel]) for k, v in phases.items()}
    print(json.dumps(out), flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
