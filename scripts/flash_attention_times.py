"""Time ``flash_attention`` at the fixed-slot prefill buckets on the card,
from this checkout or from another tree (an A/B of two versions of the
kernel in one call: run it on each tree in turns).

    python3 scripts/flash_attention_times.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), which
builds its ``flash_attention`` kernel into ``DIR/build/``, and prints one
JSON line: the label, the card's name and power limit, and for B = 1, S =
T = 64, 128 and 192, H = 28, KV = 4, D = 128, causal (seeded inputs): the
kernel names the profiler saw in one call, the median time of 10 calls
with the L2 flushed in between (``chip_smoke.Timer``), and the largest
difference from the plain version.  Needs a card; exits 1 without one.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its own path setup comes first)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="root of the tree whose repro_torch is timed")
    ap.add_argument("--label", default="this checkout")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fa

    src = Path(fa.__file__).resolve()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    timer = chip_smoke.Timer(torch)
    rows = []
    for S in (64, 128, 192):
        B, H, KV, D = 1, 28, 4, 128
        q = torch.randn((B * H, S, D), generator=gen, device="cuda")
        k = torch.randn((B * KV, S, D), generator=gen, device="cuda")
        v = torch.randn((B * KV, S, D), generator=gen, device="cuda")

        def call():
            return fa.flash_attention(q, k, v, scale=D ** -0.5)

        err = (call() - fa.flash_attention_plain(q, k, v, scale=D ** -0.5)
               ).abs().max().item()
        names = chip_smoke.device_launches(torch, call, {})
        rows.append({"S": S, "T": S, "kernels": sorted(names),
                     "ms": timer(call, iters=10), "max_abs_err": err})
    print(json.dumps({"label": args.label, "wrapper": str(src),
                      "card": chip_smoke.nvidia_smi_line(), "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
