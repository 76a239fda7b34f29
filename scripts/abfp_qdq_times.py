"""Time ``abfp_qdq`` on the card, from this checkout or from another tree (an
A/B of two versions of the kernel in one call: run it on each tree in
turns).

    python3 scripts/abfp_qdq_times.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR/src`` (default: this checkout), which
builds its ``abfp_qdq`` kernel into ``DIR/build/``, and prints one JSON
line: the label, the card's name and power limit, and for each shape
(seeded activation-like inputs) the kernels the profiler saw in one call,
the median time of 10 calls with the L2 flushed in between
(``chip_smoke.Timer``), ``y.copy_(x)`` on the same bytes, the bytes bound
and whether the result equals the plain version's; a tree whose wrapper
refuses the dtype gets its error instead.  Shapes: M = 256, K = 3584 in
f32 (int8, int4, e2m1, e4m3) and bf16 (int8, e4m3); a whole wi weight (N =
18944, K = 3584, f32, int4 and e4m3); abfp_matmul's pre-pass shapes (M =
4, K = 3584 and 18944, int8).  Then a P-fp decode tick's x pre-pass: 169
calls at (4, 3584) and 28 at (4, 18944), each on its own x, under the
profiler (device ms and launches of the tick).  Needs a card; exits 1
without one.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its own path setup comes first)

SHAPES = ([("M=256 K=3584 " + f, 256, 3584, f, "float32")
           for f in ("int8", "int4", "e2m1", "e4m3")]
          + [("M=256 K=3584 bf16 " + f, 256, 3584, f, "bfloat16")
             for f in ("int8", "e4m3")]
          + [("weight N=18944 K=3584 " + f, 18944, 3584, f, "float32")
             for f in ("int4", "e4m3")]
          + [(f"M=4 K={K} int8", 4, K, "int8", "float32")
             for K in (3584, 18944)])


def tick_prepass(torch, aq, fmt, gen) -> dict:
    """The 197 x QDQs of a P-fp decode tick (7 matmuls a layer x 28 + the
    lm_head: K = 18944 for wo, 3584 otherwise), under the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    xs = [torch.randn((4, 18944 if i % 7 == 6 else 3584), generator=gen,
                      device="cuda") for i in range(7 * 28)]
    xs.append(torch.randn((4, 3584), generator=gen, device="cuda"))
    for x in xs[:8]:
        aq.abfp_qdq(x, fmt, n=64)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in xs:
            aq.abfp_qdq(x, fmt, n=64)
        torch.cuda.synchronize()
    kernels = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            kernels[e.key[:60]] = {"ms": e.self_device_time_total / 1e3,
                                   "launches": e.count}
    return {"calls": len(xs), "kernels": kernels,
            "device_ms": sum(k["ms"] for k in kernels.values())}


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
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import abfp_qdq as aq

    src = Path(aq.__file__).resolve()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    timer = chip_smoke.Timer(torch)
    rows = []
    for label, M, K, name, dtype in SHAPES:
        fmt = get_format(name)
        x = chip_smoke.activations(torch, gen, (M, K)).to(
            getattr(torch, dtype))
        row = {"shape": label, "dtype": dtype}
        try:
            got = aq.abfp_qdq(x, fmt, n=64)
        except ValueError as e:
            rows.append({**row, "error": str(e)})
            continue
        row["equal"] = bool(torch.equal(got, aq.abfp_qdq_plain(x, fmt, n=64)))
        row["kernels"] = sorted(chip_smoke.device_launches(
            torch, lambda: aq.abfp_qdq(x, fmt, n=64), {}))
        row["bound_ms"] = chip_smoke.bound_fields(
            chip_smoke.nbytes(x, got), 0.0, 1.0)["bytes_ms"]
        row["ms"] = timer(lambda: aq.abfp_qdq(x, fmt, n=64), iters=10)
        y = torch.empty_like(x)
        row["copy_ms"] = timer(lambda: y.copy_(x), iters=10)
        rows.append(row)
        del x, got, y
        torch.cuda.empty_cache()
    tick = tick_prepass(torch, aq, get_format("int8"), gen)
    print(json.dumps({"label": args.label, "repro_torch": str(src),
                      "device": chip_smoke.nvidia_smi_line(), "rows": rows,
                      "p_fp_tick_prepass": tick}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
