"""Where a block of ``quant_decode_kernel`` spends its time, on the card.

Copies this checkout's ``src/`` to ``build/quant_decode_phases/``, adds
clock reads to the copy of ``kernels/csrc/quant_matmul.cu`` (thread 0 of
each block: %globaltimer at its start and end, clock64 after x's codes,
after its last slice and at its end; with ``--prologue`` also after the
ring's first copies are issued and after x's first loads have landed,
which adds a block barrier), builds it, and calls ``quant_matmul`` at
M = 4 (packed, n = 64) on the main-path decode shapes with distinct
weights back to back, as ``chip_smoke.py``'s in-situ timer does.  Prints,
for the last call of each shape, quantiles (0/50/90/100) of the blocks'
start and end times and of each phase, in microseconds at the clock given
by ``--ghz``.  The instrumented copy is for diagnosis only; its times
include the clock reads.

    python3 scripts/quant_decode_phases.py [--prologue] [--ghz 1.755]
"""

import argparse
import json
import shutil
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
COPY = ROOT / "build" / "quant_decode_phases"

DECL = """__device__ unsigned long long g_qd_clk[7][8192];
__device__ unsigned long long g_qd_ns[2][8192];
__device__ __forceinline__ unsigned long long qd_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ int qd_bid() {
  return blockIdx.y * gridDim.x + blockIdx.x;
}
#define QD_CLK(i)                                            \\
  if (threadIdx.x == 0 && qd_bid() < 8192) g_qd_clk[i][qd_bid()] = clock64()
"""

# (anchor, replacement): every anchor must occur exactly once
PATCHES = [
    ("template <typename C, typename Start>\n"
     "__device__ __forceinline__ void qd_make_x(",
     DECL + "template <typename C, typename Start>\n"
     "__device__ __forceinline__ void qd_make_x("),
    ("  const int slices = (run + kQdSlice - 1) / kQdSlice;\n",
     "  const int slices = (run + kQdSlice - 1) / kQdSlice;\n"
     "  if (threadIdx.x == 0 && qd_bid() < 8192) g_qd_ns[0][qd_bid()] = "
     "qd_ns();\n  QD_CLK(0);\n"),
    ("  __syncthreads();  // x's codes, for every thread\n",
     "  __syncthreads();  // x's codes, for every thread\n  QD_CLK(1);\n"),
    ("  cp_async_wait<0>();\n\n  con.store(",
     "  cp_async_wait<0>();\n  QD_CLK(2);\n\n  con.store("),
    ("  if (S == 1) return;  // uniform over the grid\n"
     "  qd_sum_splits<BM>(partial, tickets, y, M, N, col0, S);\n}",
     "  if (S > 1) qd_sum_splits<BM>(partial, tickets, y, M, N, col0, S);\n"
     "  QD_CLK(3);\n  if (threadIdx.x == 0 && qd_bid() < 8192) "
     "g_qd_ns[1][qd_bid()] = qd_ns();\n}"),
    ('extern "C" int repro_quant_matmul(',
     'extern "C" int repro_qd_clocks(void* clk, void* ns) {\n'
     "  const cudaError_t e = cudaMemcpyFromSymbol(clk, g_qd_clk,\n"
     "                                             sizeof(g_qd_clk));\n"
     "  if (e != cudaSuccess) return (int)e;\n"
     "  return (int)cudaMemcpyFromSymbol(ns, g_qd_ns, sizeof(g_qd_ns));\n"
     "}\n\n"
     'extern "C" int repro_quant_matmul('),
]
PROLOGUE_PATCHES = [
    ("        start();\n        __syncthreads();  // the zeros written",
     "        start();\n        QD_CLK(4);\n        float w = 0.f;\n"
     "        for (int u = 0; u < kBatch; ++u)\n"
     "          if (u < rounds)\n"
     "            for (int q = 0; q < 4; ++q) w += v[u][q];\n"
     "        if (w == 12345.f) xs[0] = w;  // x's loads have landed\n"
     "        __syncthreads();\n        QD_CLK(5);\n"
     "        __syncthreads();  // the zeros written"),
]

SHAPES = (("q,o", 3584, 3584), ("k,v", 3584, 512), ("wi,wg", 3584, 18944),
          ("wo", 18944, 3584))


def instrumented_copy(prologue: bool) -> Path:
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(ROOT / "src", COPY / "src")
    cu = COPY / "src/repro_torch/kernels/csrc/quant_matmul.cu"
    text = cu.read_text()
    for old, new in PATCHES + (PROLOGUE_PATCHES if prologue else []):
        if text.count(old) != 1:
            raise SystemExit(f"anchor not found once in quant_matmul.cu: "
                             f"{old[:60]!r}")
        text = text.replace(old, new)
    cu.write_text(text)
    return COPY / "src"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--prologue", action="store_true")
    ap.add_argument("--ghz", type=float, default=1.755,
                    help="SM clock to convert clock64 cycles (default 1.755)")
    args = ap.parse_args()
    sys.path.insert(0, str(instrumented_copy(args.prologue)))
    import numpy as np
    import torch

    from repro_torch.core.formats import INT8
    from repro_torch.kernels import build
    from repro_torch.kernels import quant_matmul as qm

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    lib = build.load("quant_matmul")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def quantiles(a):
        return [float(np.percentile(a, p)) for p in (0, 50, 90, 100)]

    for name, K, N in SHAPES:
        plan = qm.plan_quant_decode(4, N, K, 64, True)
        count = max(2, -(-200_000_000 // (N * K // 2)))
        ws = [(torch.randint(0, 256, (N, K // 64, 32), generator=gen,
                             device="cuda", dtype=torch.uint8),
               torch.rand((N, K // 64), generator=gen, device="cuda")
               * 0.02 + 1e-3) for _ in range(count)]
        x = torch.randn((4, K), generator=gen, device="cuda")
        for _ in range(3):
            for w in ws:
                qm._quant_matmul(x, *w, INT8, 64, True, plan)
        torch.cuda.synchronize()
        clk = np.zeros((7, 8192), np.uint64)
        ns = np.zeros((2, 8192), np.uint64)
        if lib.repro_qd_clocks(clk.ctypes.data, ns.ctypes.data) != 0:
            raise SystemExit("reading the clocks failed")
        blocks = plan.tiles * plan.splits
        clk = clk[:, :blocks].astype(np.int64) / (args.ghz * 1e3)
        ns = ns[:, :blocks].astype(np.int64) / 1e3
        t0 = ns[0].min()
        out = {"blocks": blocks, "splits": plan.splits,
               "start_us": quantiles(ns[0] - t0),
               "end_us": quantiles(ns[1] - t0),
               "prologue_us": quantiles(clk[1] - clk[0]),
               "stream_us": quantiles(clk[2] - clk[1]),
               "epilogue_us": quantiles(clk[3] - clk[2])}
        if args.prologue:
            out["ring_start_us"] = quantiles(clk[4] - clk[0])
            out["x_loads_landed_us"] = quantiles(clk[5] - clk[4])
        print(f"{name} M=4: " + json.dumps(out), flush=True)
    print(torch.cuda.get_device_name(0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
