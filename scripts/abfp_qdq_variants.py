"""What holds ``qdq_stream_kernel`` back: patched copies of ``abfp_qdq``'s
kernel timed beside the checkout's on the card, at the timed shapes.

    python3 scripts/abfp_qdq_variants.py [--variants a,b,...]

Each variant is a copy of ``csrc/abfp_qdq.cu`` and ``abfp_qdq.cuh`` under
``build/abfp_qdq_variants/<name>/``, patched at fixed anchors (the script
stops if one moved), built by ``nvcc`` with the package's flags and called
through the same C entry with ``plan_qdq``'s plan (its grid cut to the
variant's resident blocks).  Variants:

  kernel        the checkout's source, unpatched
  no_qdq        the group max and the QDQ removed: loads and stores alone
  mul_recip     x * (1 / scale) in place of the IEEE division x / scale
                (not the function: a timing of the division's share)
  depth1        no loads in flight across groups (a lane holds one group)
  depth3        two groups' loads in flight at one load a lane (a ring of
                3), 12 resident blocks an SM (the 40-register budget)
  plain_stores  ordinary stores in place of evict-first ones
  plain_loads   loads through L1 (ld.global.nc) in place of no-allocate
  plain_both    both

Prints one JSON line: the card's name and power limit and, per shape, the
median time of 10 calls with the L2 flushed in between
(``chip_smoke.Timer``) of each variant and of ``y.copy_(x)`` on the same
bytes, and whether each variant that computes the function equals the
plain version.  Needs a card; exits 1 without one.
"""

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its own path setup comes first)

DEPTH = "return vpl <= 2 ? 2 : 1;"
BLOCKS = "return elems <= 4 ? 16 : elems <= 16 ? 12 : 8;"
DIVIDE = "const float xs = Io::get(v, e) / s;"
QDQ = "    r[e] = u * s;"
MAX = "    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));"

STORE = "      __stcs(p, make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]));"
LOAD = "ld.global.nc.L1::no_allocate.v4.u32"

# name -> ([(anchor, replacement)], computes the function, most resident
# blocks an SM at one load a lane or None for plan_qdq's)
VARIANTS = {
    "kernel": ([], True, None),
    "no_qdq": ([(QDQ, "    r[e] = Io::get(v, e);"),
                (MAX, "    m = m;")], False, None),
    "mul_recip": ([(DIVIDE, "const float xs = Io::get(v, e) * __frcp_rn(s);")],
                  False, None),
    "depth1": ([(DEPTH, "return 1;")], True, None),
    "depth3": ([(DEPTH, "return vpl == 1 ? 3 : vpl <= 2 ? 2 : 1;"),
                (BLOCKS, "return elems <= 16 ? 12 : 8;")], True, 12),
    "plain_stores": ([(STORE, "      *p = make_uint4(v.w[0], v.w[1], v.w[2], "
                       "v.w[3]);")], True, None),
    "plain_loads": ([(LOAD, "ld.global.nc.v4.u32")], True, None),
    "plain_both": ([(STORE, "      *p = make_uint4(v.w[0], v.w[1], v.w[2], "
                     "v.w[3]);"), (LOAD, "ld.global.nc.v4.u32")], True, None),
}

SHAPES = (("M=256 K=3584 int8", 256, 3584, "int8", "float32"),
          ("M=256 K=3584 bf16 int8", 256, 3584, "int8", "bfloat16"),
          ("weight N=18944 K=3584 int4", 18944, 3584, "int4", "float32"),
          ("weight N=18944 K=3584 e4m3", 18944, 3584, "e4m3", "float32"),
          ("M=4 K=3584 int8", 4, 3584, "int8", "float32"))


def build_variant(name: str, patches, build) -> ctypes.CDLL:
    out = ROOT / "build" / "abfp_qdq_variants" / name
    shutil.rmtree(out, ignore_errors=True)
    out.mkdir(parents=True)
    for src in ("abfp_qdq.cu", "abfp_qdq.cuh"):
        text = (build.CSRC_DIR / src).read_text()
        for anchor, new in patches:
            if anchor in text:
                if text.count(anchor) != 1:
                    raise SystemExit(f"{name}: anchor {anchor!r} is not "
                                     f"unique in {src}")
                text = text.replace(anchor, new)
        (out / src).write_text(text)
    joined = (out / "abfp_qdq.cu").read_text() + (
        out / "abfp_qdq.cuh").read_text()
    for anchor, new in patches:
        if new not in joined:
            raise SystemExit(f"{name}: anchor {anchor!r} moved")
    lib = out / "libvariant.so"
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(out / "abfp_qdq.cu")], check=True)
    return ctypes.CDLL(str(lib))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=",".join(VARIANTS))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import abfp_qdq as aq
    from repro_torch.kernels import build

    names = [v for v in args.variants.split(",") if v]
    fns = {v: aq._bind(build_variant(v, VARIANTS[v][0], build))
           for v in names}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    timer = chip_smoke.Timer(torch)
    rows = []
    for label, M, K, fname, dtype in SHAPES:
        fmt = get_format(fname)
        x = chip_smoke.activations(torch, gen, (M, K)).to(
            getattr(torch, dtype))
        y = torch.empty_like(x)
        want = aq.abfp_qdq_plain(x, fmt, n=64)
        plan = aq.plan_qdq(M * (K // 64), 64, x.element_size(), True, fmt)
        row = {"shape": label, "blocks": plan.blocks,
               "bound_ms": chip_smoke.bound_fields(
                   chip_smoke.nbytes(x, y), 0.0, 1.0)["bytes_ms"]}
        for v in names:
            per_sm = VARIANTS[v][2]
            vplan = plan._replace(blocks=min(plan.blocks, aq.SMS * per_sm)
                                  ) if per_sm and plan.vpl == 1 else plan
            stream = torch.cuda.current_stream().cuda_stream

            def call(fn=fns[v], plan=vplan):
                err = fn(x.data_ptr(), y.data_ptr(), M * (K // 64), 64,
                         aq.QDQ_DTYPES.index(x.dtype),
                         ctypes.byref(aq.plan_struct(plan)),
                         *aq.format_args(fmt), stream)
                if err:
                    raise SystemExit(f"{v} at {label}: CUDA error {err}")

            call()
            torch.cuda.synchronize()
            row[v] = {"ms": timer(call, iters=10), "blocks": vplan.blocks}
            if VARIANTS[v][1]:
                row[v]["equal"] = bool(torch.equal(y, want))
        row["copy_ms"] = timer(lambda: y.copy_(x), iters=10)
        rows.append(row)
        del x, y, want
        torch.cuda.empty_cache()
    print(json.dumps({"device": chip_smoke.nvidia_smi_line(), "rows": rows}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
