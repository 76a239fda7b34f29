"""The long-context decode call's attention on the card, for one tree.

Run it on this checkout, or with ``--src DIR`` on another tree of this
repository (an unpacked ``git archive`` of another commit), in turns in one
call, to compare the two on one card: the tree's own kernels are built
into its own ``build/``; the inputs, the checks and the timer are this
checkout's ``chip_smoke.py`` helpers.

``chip_smoke.check_attention`` at the decode shapes past
``attention_decode_kernel`` (B = 4, S = 1, H = 28, KV = 4, D = 128): the
long path's call (T = 8192, phased, bk = 512, int8 codes, probs QDQ n =
64, batch rows at 6007, 4107, 2507 keys and a dead row), early rows (4000,
700, 37, dead), the online and exact bodies, Qwen2-7B's whole context (T =
32,768), and, untimed, fp8 codes (phased and online), a window, 32-,
128- and 48-key probs
groups; each against the plain version at the card's bars, with the
kernel it launches read from the profiler and, where timed, its time
(CUDA events, L2 flushed between calls, median of 10) beside
``attention_kernel`` forced onto the same call.  Then the timed shapes
(and the dead row first) under clusters of 8, 7 and 6 blocks (``--clusters``).

Prints a JSON line per check (``chip_smoke.log``), then one JSON line of
the cluster sweep, one of the checks that failed their bar (the script
runs on and exits 1), then the card's name and power limit.

    python3 scripts/attention_decode_long_times.py [--src DIR] [--clusters]
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="root of the tree whose src/ is timed")
    ap.add_argument("--clusters", action="store_true",
                    help="also time the call under clusters of 8, 7, 6")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    sys.path.append(str(ROOT))
    import torch

    from repro_torch.kernels import flash_attention_quant as faq

    # after repro_torch: chip_smoke puts this checkout's src/ first on the
    # path, and the package must stay the --src tree's
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = cs.Timer(torch)
    kernel = "attention_decode_long_kernel"
    rows = [6007, 4107, 2507, -1]
    checks = [
        dict(T=8192, probs=True, block_k=512, q_starts=rows,
             label="long decode S=1 T=8192 int8 phased"),
        dict(T=8192, probs=True, block_k=512, q_starts=[4000, 700, 37, -1],
             label="long decode S=1 T=8192 int8 phased early rows"),
        dict(T=8192, probs=False, block_k=512, q_starts=rows,
             label="long decode S=1 T=8192 int8 online"),
        dict(T=8192, probs=True, block_k=0, q_starts=rows,
             label="long decode S=1 T=8192 int8 exact"),
        dict(T=32768, probs=True, block_k=512,
             q_starts=[30000, 16000, 2507, -1],
             label="long decode S=1 T=32768 int8 phased"),
        dict(T=8192, probs=True, block_k=512, q_starts=rows, fp8=True,
             timed=False, label="long decode S=1 T=8192 fp8 phased"),
        dict(T=8192, probs=False, block_k=512, q_starts=rows, fp8=True,
             timed=False, label="long decode S=1 T=8192 fp8 online"),
        dict(T=8192, probs=True, block_k=512, q_starts=rows, window=100,
             timed=False, label="long decode S=1 T=8192 int8 window=100"),
        dict(T=8192, probs=True, block_k=512, q_starts=rows, probs_n=32,
             timed=False, label="long decode S=1 T=8192 probs n=32"),
        dict(T=8192, probs=True, block_k=512, q_starts=rows, probs_n=128,
             timed=False, label="long decode S=1 T=8192 probs n=128"),
        dict(T=8160, probs=True, block_k=480, q_starts=rows, probs_n=48,
             timed=False, label="long decode S=1 T=8160 probs n=48"),
    ]
    failed = []
    for kw in checks:
        kw.setdefault("fp8", False)
        try:
            cs.check_attention(torch, timer, gen, S=1, want_kernel=kernel,
                               **kw)
        except SystemExit as e:  # a check off its bar: say so, go on
            failed.append(str(e))
    if args.clusters:
        sweep = {}
        B, H, KV, D = 4, 28, 4, 128
        for T, q_starts in ((8192, rows), (8192, [4000, 700, 37, -1]),
                            (8192, [-1, 6007, 4107, 2507]),
                            (32768, [30000, 16000, 2507, -1])):
            call = cs.attention_inputs(torch, gen, B=B, S=1, T=T, H=H,
                                       KV=KV, D=D, fp8=False,
                                       q_starts=q_starts)
            kw = dict(scale=D ** -0.5, causal=True, block_k=512, probs_n=64,
                      probs_qmax=127.0, probs_qmin=-127.0)
            base = faq.plan_attention(B, 1, T, H, KV, D, 512, 64)
            for C in (8, 7, 6):
                L = -(-(T // 64) // C) * 64
                plan = base._replace(
                    grid=(C, KV, B), cluster=C, keys=L,
                    smem_bytes=faq.decode_long_smem_bytes(
                        H // KV, L, T, D, 64, 512))
                sweep[f"T={T} rows={q_starts} C={C}"] = timer(
                    lambda: faq._flash_attention_quant(
                        *call, 1 << 30, plan=plan, **kw), iters=20)
        print(json.dumps({"cluster_ms": sweep}), flush=True)
    print(json.dumps({"failed": failed}), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
