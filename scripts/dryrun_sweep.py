"""The dry run's whole grid (``launch.dryrun --all``), one process per
(arch, mesh) at a time over ``--jobs`` workers, each cell's record
written by the CLI under ``--out-dir``; a summary of every cell (status,
seconds, HBM per device, dominant term, FLOPs and collective bytes per
device) is printed and written to ``--out-dir/summary.json``.

    PYTHONPATH=src python scripts/dryrun_sweep.py --out-dir build/dryrun
    PYTHONPATH=src python scripts/dryrun_sweep.py --meshes mp --archs qwen2-7b \
        --shapes train_4k,decode_32k

It runs on the CPU and allocates nothing (``meta`` tensors over a fake
process group); the exit code is 1 if any cell's status is ``error``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import glob
import json
import os
import subprocess
import sys
import time


def run_one(arch: str, mesh: str, out_dir: str, shapes) -> tuple:
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--out-dir", out_dir]
    if mesh == "mp":
        cmd.append("--multi-pod")
    t0 = time.perf_counter()
    lines = []
    for shape in shapes:
        p = subprocess.run(cmd + ["--shape", shape], capture_output=True,
                           text=True)
        lines.append(p.stdout.strip() or p.stderr.strip()[-400:])
    return arch, mesh, time.perf_counter() - t0, lines


def summary(out_dir: str) -> list:
    rows = []
    for path in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        if path.endswith("summary.json"):
            continue
        with open(path) as f:
            rec = json.load(f)
        row = {"cell": os.path.basename(path)[:-5], "status": rec["status"]}
        if rec["status"] == "ok":
            row.update(
                seconds=rec["lower_s"] + rec["compile_s"]
                + rec["cost_extraction_s"],
                hbm_gb_per_device=rec["hbm_gb_per_device"],
                dominant=rec["terms"]["dominant"],
                flops_per_device=rec["flops_per_device"],
                collective_bytes_per_device=rec[
                    "collective_bytes_per_device"])
        elif rec["status"] == "error":
            row["error"] = rec["error"][:300]
        rows.append(row)
    return rows


def main() -> int:
    from repro_torch.configs import SHAPES
    from repro_torch.launch.dryrun import ASSIGNED

    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="build/dryrun")
    ap.add_argument("--archs", default=",".join(ASSIGNED))
    ap.add_argument("--meshes", default="sp,mp")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--jobs", type=int, default=os.cpu_count() or 1)
    args = ap.parse_args()
    os.makedirs(args.out_dir, exist_ok=True)
    jobs = [(a, m) for m in args.meshes.split(",")
            for a in args.archs.split(",")]
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        futs = [pool.submit(run_one, a, m, args.out_dir,
                            args.shapes.split(",")) for a, m in jobs]
        for fut in concurrent.futures.as_completed(futs):
            arch, mesh, secs, lines = fut.result()
            print(f"== {arch} ({mesh}) {secs:.1f} s", flush=True)
            for ln in lines:
                print("  " + ln.replace("\n", "\n  "), flush=True)
    rows = summary(args.out_dir)
    with open(os.path.join(args.out_dir, "summary.json"), "w") as f:
        json.dump({"wall_s": time.perf_counter() - t0, "cells": rows}, f,
                  indent=1)
    errors = [r for r in rows if r["status"] == "error"]
    print(f"== {len(rows)} cells: "
          + json.dumps({s: sum(r["status"] == s for r in rows)
                        for s in ("ok", "skipped", "error", "lint_error")})
          + f" in {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
