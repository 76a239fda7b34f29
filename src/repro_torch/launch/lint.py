"""qlint CLI + launcher pre-flight gate.

Usage:
    python -m repro_torch.launch.lint --arch qwen2-7b --policy w4a8_abfp
    python -m repro_torch.launch.lint --arch zamba2-7b --recipe gptq \
        --shape decode_32k --compress
    python -m repro_torch.launch.lint --all      # registered configs x
                                                 # presets x recipes sweep
    python -m repro_torch.launch.lint --all --json --out build/lint.json

Exit status: 0 when no error-severity diagnostic was produced, 1 otherwise
(warnings/infos never fail the run).  ``--json`` emits machine-readable
reports; ``--all`` prints one summary line per combination.

The launchers (train / serve) call :func:`preflight` before doing any real
work — before a weight is built or a byte allocated on the card: errors
abort the launch with the diagnostics on stderr (exit code 2), warnings
are logged and the launch proceeds.  ``--no-lint`` bypasses.  Everything
here is symbolic and runs on the CPU; the one thing it reads of the card
is whether there is one (QL602).
"""

from __future__ import annotations

import argparse
import json
import sys


def preflight(cfg, policy, recipe=None, *, shape=None, compress=False,
              prequant=False, scan_layers=None, pages=None, speculative=None,
              experts=None, attn=None, where="launch", out=None) -> None:
    """Launcher gate: lint the tuple; SystemExit(2) on any error.

    The report goes to ``out`` (default: ``sys.stderr`` as it is at the
    call); on warnings alone the launch proceeds.
    ``scan_layers`` should be the launcher's FINAL value (after its
    layer-rule unroll fallback) so QL004 reflects what will actually run.
    ``pages`` carries the PageGeometry of a paged serving launch so the
    gate runs QL305-QL307 before any device allocation.  ``speculative``
    carries {draft_policy, draft_k} for a speculative launch (QL4xx);
    ``policy`` is then the target side.  ``experts`` carries
    {cache_capacity, hot_experts} for expert-resident MoE serving (QL5xx).
    ``attn`` carries {engine, kv} for a serving launch's attention-backend
    dispatch checks (QL6xx).
    """
    from repro_torch.analysis.qlint import lint

    out = sys.stderr if out is None else out
    report = lint(cfg, policy, recipe, shape=shape, compress=compress,
                  prequant=prequant, scan_layers=scan_layers, pages=pages,
                  speculative=speculative, experts=experts, attn=attn)
    if report.errors:
        print(f"qlint: {where} blocked by "
              f"{len(report.errors)} error(s):", file=out)
        print(report.render(verbose=False), file=out)
        print("(bypass with --no-lint)", file=out)
        raise SystemExit(2)
    if report.warnings:
        for d in report.warnings:
            print(f"qlint [{where}] {d.render()}", file=out)


# ---------------------------------------------------------------------------
# Sweep: every registered config x policy preset x recipe
# ---------------------------------------------------------------------------
def sweep_presets() -> list:
    """The shipped policy-preset names (flat + mixed + fp32; QAT variants
    are name suffixes of these, not separate grid points)."""
    from repro_torch.core.policy import _MIXED_FACTORIES, _PRESET_FACTORIES

    return ["fp32"] + sorted(_PRESET_FACTORIES) + sorted(_MIXED_FACTORIES)


def sweep_combos():
    """Yield (arch, preset, recipe|None) for the registered grid, skipping
    combinations the launchers themselves refuse a priori (layer-indexed
    presets on families without per-layer sites) — those are not shipped
    configurations, and the skip reason is recorded in the result row."""
    from repro_torch.configs import get_config, list_configs
    from repro_torch.core.policy import has_layer_rules, preset
    from repro_torch.core.recipe import recipe_names

    recipes = [None] + recipe_names()
    for arch in list_configs():
        cfg = get_config(arch)
        for pname in sweep_presets():
            pol = preset(pname, n_layers=cfg.n_layers)
            if cfg.family in ("hybrid", "encdec") and has_layer_rules(pol):
                yield (arch, pname, None, "skip",
                       "layer-indexed preset on a family without "
                       "per-layer sites (launchers refuse this combo)")
                continue
            for rname in recipes:
                yield (arch, pname, rname, "lint", None)


def run_sweep(json_out: bool, out_path: str | None,
              verbose: bool) -> int:
    from repro_torch.analysis.qlint import lint_launch
    from repro_torch.configs import get_config
    from repro_torch.core.policy import preset

    rows = []
    n_err = n_warn = n_skip = 0
    for arch, pname, rname, action, reason in sweep_combos():
        if action == "skip":
            n_skip += 1
            rows.append({"arch": arch, "policy": pname, "recipe": rname,
                         "status": "skipped", "reason": reason})
            if not json_out:
                print(f"[skip] {arch} x {pname}: {reason}")
            continue
        cfg = get_config(arch)
        policy = preset(pname, n_layers=cfg.n_layers)
        report = lint_launch(cfg, policy, rname)
        rows.append(report.to_dict())
        errs, warns = len(report.errors), len(report.warnings)
        n_err += errs
        n_warn += warns
        if not json_out:
            tag = "FAIL" if errs else "ok"
            rec = f" x {rname}" if rname else ""
            line = (f"[{tag}] {arch} x {pname}{rec}: "
                    f"{errs} error(s), {warns} warning(s)")
            if errs or (verbose and warns):
                print(line)
                print(report.render(verbose=False))
            elif verbose:
                print(line)
    summary = {
        "combinations": len(rows),
        "skipped": n_skip,
        "errors": n_err,
        "warnings": n_warn,
        "ok": n_err == 0,
    }
    payload = {"summary": summary, "reports": rows}
    if out_path:
        import os

        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(payload, f, indent=2)
    if json_out:
        print(json.dumps(payload if out_path is None else summary,
                         indent=2))
    else:
        print(f"qlint --all: {summary['combinations']} combinations "
              f"({n_skip} skipped), {n_err} error(s), {n_warn} warning(s)")
    return 1 if n_err else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.lint",
        description="statically analyze quantization launch configs",
    )
    ap.add_argument("--arch", default=None, help="registered config name")
    ap.add_argument("--policy", default=None,
                    help="policy preset (default: the --recipe's paired "
                    "policy, else w4a8_abfp)")
    ap.add_argument("--recipe", default=None, help="QuantRecipe name")
    ap.add_argument("--shape", default=None,
                    help="shape grid point (train_4k / prefill_32k / "
                    "decode_32k / long_500k) for launch-feasibility checks")
    ap.add_argument("--compress", action="store_true",
                    help="lint the compressed-serving configuration")
    ap.add_argument("--prequant", action="store_true",
                    help="lint the prequantized-serving configuration")
    ap.add_argument("--all", action="store_true",
                    help="lint every registered config x preset x recipe")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output")
    ap.add_argument("--out", default=None,
                    help="write the full JSON report to this path")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="show ok rows (--all) / info diagnostics")
    args = ap.parse_args(argv)

    if args.all:
        return run_sweep(args.json, args.out, args.verbose)
    if not args.arch:
        ap.error("--arch (with optional --policy/--recipe/--shape) or --all")

    from repro_torch.analysis.qlint import lint
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.core.policy import preset

    cfg = get_config(args.arch)
    policy_name = args.policy
    if policy_name is None and args.recipe:
        from repro_torch.core.recipe import get_recipe

        policy_name = get_recipe(args.recipe).policy_preset
    policy_name = policy_name or "w4a8_abfp"
    policy = preset(policy_name, n_layers=cfg.n_layers)
    shape = SHAPES[args.shape] if args.shape else None
    report = lint(cfg, policy, args.recipe, shape=shape,
                  compress=args.compress, prequant=args.prequant)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report.to_dict(), f, indent=2)
    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        print(report.render(verbose=True))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
