#!/usr/bin/env python3
"""Device time of one checkout's ``abfp_matmul_int8`` on the card.

    python3 tools/int8_matmul_times.py CHECKOUT TAG

Times ``abfp_matmul_int8`` of the checkout at ``CHECKOUT`` (its
``src/`` and its ``chip_smoke.py``) at qwen2-7b's dense layer shapes for
M = 4, 16 and 192 rows (and ``lm_head`` at M = 4), with ``chip_smoke.py``'s
timer: device time alone, L2 flushed between calls, median of 10.  At
M = 192 it also reads the kernels of one call from the profiler.  It
builds that checkout's kernels into ``CHECKOUT/build/int8_times``.

To compare two commits on one card, unpack each beside the other and run
this script for each in turns (A, B, B, A) in one session; every line it
prints starts with ``TIMES`` and holds TAG, the times per shape, the
forward passes they sum to (28 x (2 q,o + 2 k,v + 2 wi,wg + wo), plus
``lm_head`` at M = 4) and the per-kernel times at M = 192.
"""

from __future__ import annotations

import json
import os
import sys

SHAPES = (("q,o", 3584, 3584), ("k,v", 3584, 512), ("wi,wg", 3584, 18944),
          ("wo", 18944, 3584))
PER_LAYER = {"q,o": 2, "k,v": 2, "wi,wg": 2, "wo": 1}
KERNEL_NAMES = ("quantize_cols", "quantize_rows", "int8_decode",
                "int8_mma", "mma_contract", "contract_kernel")


def main() -> int:
    if len(sys.argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    tree, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path[:0] = [os.path.join(tree, "src"), tree]
    os.environ["REPRO_TORCH_BUILD_DIR"] = os.path.join(tree, "build",
                                                       "int8_times")
    import torch

    if not torch.cuda.is_available():
        print("int8_matmul_times: no CUDA card", file=sys.stderr)
        return 1
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    from repro_torch.core.formats import INT4, INT8
    from repro_torch.kernels import quant_matmul as qm

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    timer = cs.Timer(torch)
    out = {"tag": tag, "device": cs.nvidia_smi_line(), "ms": {},
           "forward_pass_ms": {}, "m192_kernels_ms": {}}
    for M in (4, 16, 192):
        rows = SHAPES + ((("lm_head", 3584, 152064),) if M == 4 else ())
        for name, K, N in rows:
            x = cs.activations(torch, gen, (M, K))
            w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5

            def call():
                return qm.abfp_matmul_int8(x, w, INT8, INT4)

            out["ms"][f"{name} M={M}"] = timer(call, iters=10)
            if M == 192:
                call()
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for _ in range(5):
                        call()
                    torch.cuda.synchronize()
                by_name = {}
                for e in prof.key_averages():
                    if (e.device_type != DeviceType.CUDA
                            or e.self_device_time_total <= 0):
                        continue
                    key = next((k for k in KERNEL_NAMES if k in e.key),
                               e.key[:40])
                    by_name[key] = (by_name.get(key, 0.0)
                                    + e.self_device_time_total / 1e3 / 5)
                out["m192_kernels_ms"][name] = by_name
            del x, w
        out["forward_pass_ms"][f"M={M}"] = 28 * sum(
            c * out["ms"][f"{n} M={M}"] for n, c in PER_LAYER.items()) + \
            out["ms"].get(f"lm_head M={M}", 0.0)
    print("TIMES " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
