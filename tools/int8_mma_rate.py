#!/usr/bin/env python3
"""Throughput ceilings of the int8 contraction's instruction streams.

    python3 tools/int8_mma_rate.py

Builds ``tools/int8_mma_rate.cu`` with nvcc into ``build/tools/`` of this
checkout and runs it: the int8 ``mma.sync`` m16n8k32 rate (TOP/s) with 4,
8 and 16 warps on every SM, and the rate of the per-group rescale ``acc +=
((float)p * s) * w`` (folds/s), each measured alone.  Prints the card's
name and power limit first.  Needs nvcc and one card.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build

    out_dir = os.path.join(ROOT, "build", "tools")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, "int8_mma_rate")
    subprocess.run([build.find_nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-o", exe,
                    os.path.join(ROOT, "tools", "int8_mma_rate.cu")],
                   check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout.strip())
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
