"""Multi-pod dry run: build every (arch x shape x mesh) cell on ``meta``
DTensors over a fake process group of 256 (or 512) ranks, trace its step
once through the port's counters (zero allocation, on no card), then
record the memory analysis, the cost analysis and the collectives for the
roofline report.

The process group is ``torch.distributed``'s ``"fake"`` backend over a
``FakeStore``: rank 0 of a world the mesh's size, every collective
recorded and none run.  ``run_cell`` makes it (and destroys and remakes
it for the other world size) after the lint gate; importing this module
makes no group and does not touch CUDA.

Record keys, in the port: ``lower_s`` is building the cell and laying its
inputs out on the mesh, ``compile_s`` the traced pass-1 step (every layer
run eagerly), ``cost_extraction_s`` pass 2 (the unrolled k- and 2k-layer
cells, carried to the whole depth by ``roofline.extrapolate``: for a
config whose layers cost the same, its totals are pass 1's).  ``flops``
are one rank's matmul-class FLOPs on its own chunks, ``bytes`` the bytes
its eager ops read and write, and the memory keys are those of
``launch.traced``; the roofline terms use the card's constants
(``launch.mesh``: one H100 SXM).

Usage:
    python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k
    python -m repro_torch.launch.dryrun --arch gemma2-9b --shape train_4k --multi-pod
    python -m repro_torch.launch.dryrun --all            # every assigned cell
Options: --policy w4a8_abfp|fp32|... --out-dir artifacts/dryrun
         --remat dots|full|none --microbatches N --compute fp|int8
         --strategy fsdp            (ZeRO-3 rules; §Perf trains)
         --prequant                 (offline weight QDQ; serving)
         --compress                 (per-site compressed weights; serving)
         --kv-on-write              (KV quantize-on-write; serving)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.policy import (
    Policy,
    has_layer_rules,
    kv_cache_mode,
    policies_of,
    preset,
    replace_enabled,
    with_kv_cache,
)
from repro_torch.dist import sharding as shd
from repro_torch.launch import roofline as rf
from repro_torch.launch import specs as sp
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.traced import trace_step
from repro_torch.models import build_model
from repro_torch.nn.module import make_generator
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train.step import TrainStepConfig, make_train_step

ASSIGNED = [
    "h2o-danube-1.8b", "granite-3-8b", "gemma2-9b", "qwen2-7b", "zamba2-7b",
    "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e", "whisper-large-v3",
    "internvl2-2b", "mamba2-130m", "vit-b16", "deit-s16",
]


def fake_world(size: int) -> None:
    """The default process group: rank 0 of a fake world of ``size``
    ranks (no communication).  A fake group of another size is destroyed
    first; a real one is left alone and raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("the dry run needs the fake process group; "
                               f"a {dist.get_backend()!r} group is running")
        if dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=size)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, policy: Policy,
               mesh, rules, microbatches: int = 1,
               compress: bool = False, device="meta", seed: int = 0):
    """Returns (fn, args, donate, info): ``args`` are DTensors laid out on
    ``mesh`` by ``rules`` (on ``meta``; on a real ``device`` the weights
    are drawn from ``seed``, the batches and states are zeros), ``donate``
    the indices of the arguments the step updates in place.

    ``info`` carries side records computed while building (currently the
    ``weight_bytes`` accounting of compressed cells — derived from the
    same ``meta`` trees the cell runs with, so nothing is built twice).
    """
    info = {}
    model = build_model(cfg, device=device)
    params = model.init(make_generator(seed, device) if device != "meta"
                        else torch.Generator())
    params_axes = model.param_axes()
    real = lambda t: t if device == "meta" else torch.zeros(
        t.shape, dtype=t.dtype, device=device)
    if compress:
        # compressed-domain weights for serving (§Perf): shape-transform
        # the tree per each kernel's resolved site rule + mirror the
        # logical axes; runtime policy drops weight QDQ and qmatmul's
        # compressed backend contracts the stored codes directly.
        from repro_torch.models import serving_transforms as st

        if shape.kind == "train":
            raise ValueError("compressed storage is serving-only; "
                             f"shape kind {shape.kind!r} trains")
        base_policy = policy
        dense = params
        params = st.compress_weights(params, base_policy)
        params_axes = st.compress_axes(params_axes, params)
        policy = st.serving_policy(policy)
        wb = st.weight_bytes_report(dense, params)
        info["weight_bytes"] = {k: v for k, v in wb.items()
                                if k != "sites"}
    params_sh = sp.shardings_from_axes(params_axes, mesh, rules, params)

    if shape.kind == "train":
        opt = AdamW(lr=1e-4, weight_decay=0.1)
        opt_state = opt.init(params)
        # moments mirror param sharding; count replicated
        opt_sh = AdamWState(
            mu=params_sh, nu=params_sh,
            count=sp.shardings_from_axes(None, mesh, rules))
        batch, batch_axes = sp.batch_specs(cfg, shape)
        batch = {k: real(v) for k, v in batch.items()}
        batch_sh = sp.shardings_from_axes(batch_axes, mesh, rules)
        fn = make_train_step(
            model, opt, policy,
            TrainStepConfig(microbatches=microbatches))
        args = (sp.distribute(params, params_sh),
                sp.distribute(opt_state, opt_sh),
                sp.distribute(batch, batch_sh))
        donate = (0, 1)
    elif shape.kind == "prefill":
        batch, batch_axes = sp.batch_specs(cfg, shape)
        batch = {k: real(v) for k, v in batch.items()}
        batch_sh = sp.shardings_from_axes(batch_axes, mesh, rules)

        if cfg.family == "vit":
            # encoder-only classifier: 'prefill' is a plain batched forward
            def fn(params, batch):
                return model.apply(params, batch, policy)
        else:
            def fn(params, batch):
                return model.prefill(params, batch, policy,
                                     max_len=shape.seq_len)

        args = (sp.distribute(params, params_sh),
                sp.distribute(batch, batch_sh))
        donate = ()
    else:  # decode
        state = sp.eval_decode_state(
            model, cfg, shape, kv_quant=(kv_cache_mode(policy) == "int8"),
            device=device)
        state_axes = sp.decode_state_axes(cfg, state)
        state_sh = sp.shardings_from_axes(state_axes, mesh, rules, state)
        tok, tok_axes = sp.token_spec(cfg, shape.global_batch)
        tok = real(tok)
        tok_sh = sp.shardings_from_axes(tok_axes, mesh, rules)

        def fn(params, token, state):
            return model.decode_step(params, token, state, policy)

        args = (sp.distribute(params, params_sh),
                sp.distribute(tok, tok_sh),
                sp.distribute(state, state_sh))
        donate = (2,)
    return fn, args, donate, info


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             policy_name: str | None = "w4a8_abfp",
             recipe_name: str | None = None, remat: str | None = None,
             microbatches: int = 1, compute: str | None = None,
             logits_chunk: int | None = None, out_dir: str | None = None,
             strategy: str | None = None, prequant: bool = False,
             compress: bool = False, kv_on_write: bool = False,
             kv_int8: bool = False, tag: str = "",
             no_lint: bool = False) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    # --recipe tags the traced cell with the offline PTQ method whose
    # weights it would serve; the recipe's paired eval policy becomes the
    # cell's policy unless --policy overrides it explicitly.
    recipe_dict = None
    if recipe_name is not None:
        from repro_torch.core.recipe import get_recipe, recipe_to_dict

        recipe = get_recipe(recipe_name)
        recipe_dict = recipe_to_dict(recipe)
        if policy_name is None and recipe.policy_preset:
            policy_name = recipe.policy_preset
    if policy_name is None:
        policy_name = "w4a8_abfp"
    if shape_name in cfg.skip_shapes:
        return {"arch": arch, "shape": shape_name, "status": "skipped",
                "reason": "inapplicable (see DESIGN.md §5)"}
    cfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    if remat is not None:
        cfg = cfg.replace(remat=remat)
    if logits_chunk is not None:
        cfg = cfg.replace(logits_chunk=logits_chunk)
    policy = preset(policy_name, n_layers=cfg.n_layers)
    if has_layer_rules(policy):
        # layer-indexed PolicyMap rules need per-layer sites (the same
        # constraint as calibration); the port always runs its layers one
        # by one, so the flag only keeps the record the reference's
        cfg = cfg.replace(scan_layers=False)
    if policy.enabled and shape.kind == "train":
        policy = policy.with_ste(True)  # QAT mode for training graphs
    if compute is not None and policy.enabled:
        policy = replace_enabled(policy, compute=compute)
    # kv storage is structural: set it on every entry, fp32 rules included
    if kv_on_write and policy.enabled:
        policy = with_kv_cache(policy, "on_write")
    if kv_int8 and policy.enabled:
        policy = with_kv_cache(policy, "int8")
    # per-site weight/activation bit-widths of the *resolved* map — recorded
    # before serving transforms strip the weight quantizer from the runtime
    # policy (the stored weights keep their offline format either way)
    policy_bits = rf.policy_bits_report(cfg, policy)
    if prequant and not compress and policy.enabled and any(
            p.weight is not None for p in policies_of(policy)):
        # serving mode: weights pre-quantized offline, no runtime weight QDQ
        # (--compress subsumes this: build_cell applies the full transform)
        from repro_torch.models.serving_transforms import serving_policy

        policy = serving_policy(policy)
    if not no_lint:
        # pre-flight gate: lint the final (policy, shape, flags) tuple
        # before making the process group and the mesh
        from repro_torch.analysis.qlint import lint as qlint_lint

        lrep = qlint_lint(cfg, policy, recipe_name, shape=shape,
                          compress=compress, prequant=prequant,
                          scan_layers=cfg.scan_layers)
        for d in lrep.warnings:
            print(f"qlint [dryrun] {d.render()}", file=sys.stderr)
        if lrep.errors:
            return {
                "arch": arch, "shape": shape_name,
                "policy": policy.name, "recipe": recipe_dict,
                "scan_layers": cfg.scan_layers, "tag": tag,
                "prequant": prequant, "compress": compress,
                "kv_on_write": kv_on_write, "kv_int8": kv_int8,
                "status": "lint_error",
                "lint": [d.to_dict() for d in lrep.errors],
                "error": "qlint: " + "; ".join(
                    f"{d.code} {d.message}" for d in lrep.errors),
            }
    fake_world(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    rules = sp.fit_batch_rule(sp.rules_for(cfg, shape, strategy=strategy),
                              shape.global_batch, mesh)
    rec = {
        "arch": arch, "shape": shape_name,
        "mesh": shd.mesh_axis_sizes(mesh),
        "chips": mesh.size(),
        "policy": policy.name, "remat": cfg.remat,
        "scan_layers": cfg.scan_layers,
        "policy_bits": policy_bits,
        # resident weight bytes under compression (the storage-side
        # counterpart of policy_bits) — filled from build_cell's pass-1
        # info so the meta trees are only built once
        "weight_bytes": None,
        "recipe": recipe_dict,
        "microbatches": microbatches, "tag": tag,
        "strategy": strategy, "prequant": prequant,
        "compress": compress, "kv_on_write": kv_on_write,
        "kv_int8": kv_int8,
        "status": "error",
    }
    try:
        # ---- pass 1: the whole model, every layer ----------------------
        t0 = time.time()
        fn, args, donate, cell_info = build_cell(
            cfg, shape, policy, mesh, rules, microbatches,
            compress=compress)
        rec["weight_bytes"] = cell_info.get("weight_bytes")
        t1 = time.time()
        with shd.use_rules(mesh, rules):
            traced = trace_step(fn, args, donate)
        del fn, args
        t2 = time.time()
        memory = rf.memory_dict(traced)
        scan_cost = rf.extract_costs(traced)

        # ---- pass 2: cost accounting ------------------------------------
        # The reference's cost analysis counts a scanned layer once, so it
        # compiles small UNROLLED variants at k and 2k layers (k = layer-
        # pattern period) and extrapolates affinely; the port's pass 1
        # already counts every layer, so for cost-uniform layers the
        # extrapolation gives pass 1's totals.  Layer-indexed PolicyMaps
        # break that uniformity (endcap layers cost differently than
        # interior ones): there pass 1's own counts are the accounting.
        if has_layer_rules(policy):
            ext = {
                "flops": scan_cost["flops"],
                "bytes": scan_cost["bytes"],
                "collective_bytes": scan_cost["collective_bytes"],
                "source": "unrolled_pass1",
            }
            collectives_rec = {"collectives_full_unrolled":
                               scan_cost["collectives"]}
        else:
            k = 1
            if cfg.alt_local_global:
                k = 2
            if cfg.family == "hybrid":
                k = cfg.shared_attn_every
            periods = cfg.n_layers // k
            costs2 = {}
            for mult in (1, 2):
                kw = dict(n_layers=k * mult, scan_layers=False)
                if cfg.family == "encdec":
                    kw["encoder_layers"] = k * mult
                small = cfg.replace(**kw)
                sfn, sargs, sdon, _ = build_cell(
                    small, shape, policy, mesh, rules, microbatches,
                    compress=compress)
                with shd.use_rules(mesh, rules):
                    costs2[mult] = rf.extract_costs(
                        trace_step(sfn, sargs, sdon))
                del sfn, sargs
            ext = rf.extrapolate(costs2[1], costs2[2], periods)
            collectives_rec = {"collectives_unrolled_2k":
                               costs2[2]["collectives"]}
        t3 = time.time()

        flops = ext["flops"]
        bytes_acc = ext["bytes"]
        coll_b = ext["collective_bytes"]
        terms = rf.roofline_terms(flops, bytes_acc, coll_b)
        mflops = rf.model_flops(cfg, shape, mesh.size())
        rec.update(
            status="ok",
            lower_s=round(t1 - t0, 2),
            compile_s=round(t2 - t1, 2),
            cost_extraction_s=round(t3 - t2, 2),
            flops_per_device=flops,
            bytes_per_device=bytes_acc,
            collective_bytes_per_device=coll_b,
            **collectives_rec,
            scan_artifact_costs=scan_cost,
            extrapolation={k2: v for k2, v in ext.items()},
            memory=memory,
            hbm_gb_per_device=round(
                (memory["argument_size_in_bytes"]
                 + memory["output_size_in_bytes"]
                 + memory["temp_size_in_bytes"]
                 - memory["alias_size_in_bytes"]) / 1e9, 3),
            terms=terms,
            model_flops_per_device=mflops,
            useful_compute_ratio=(mflops / flops) if flops else 0.0,
        )
    except Exception as e:  # noqa: BLE001 — record and continue the sweep
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = "mp" if multi_pod else "sp"
        tagpart = f"-{tag}" if tag else ""
        path = os.path.join(
            out_dir, f"{arch}__{shape_name}__{suffix}{tagpart}.json")
        with open(path, "w") as f:
            json.dump(rec, f, indent=2, default=str)
    return rec


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--policy", default=None,
                    help="policy preset (default w4a8_abfp, or the "
                    "--recipe's paired policy)")
    ap.add_argument("--recipe", default=None,
                    help="QuantRecipe name to record in the artifact; its "
                    "policy_preset becomes the cell policy unless --policy "
                    "is given")
    ap.add_argument("--remat", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compute", default=None, choices=[None, "fp", "int8"])
    ap.add_argument("--logits-chunk", type=int, default=None)
    ap.add_argument("--strategy", default=None, choices=[None, "fsdp"])
    ap.add_argument("--prequant", action="store_true",
                    help="serving mode: weights pre-quantized offline")
    ap.add_argument("--compress", action="store_true",
                    help="serving mode: per-site compressed weights (int "
                    "codes + group scales; INT4 packed) consumed by the "
                    "compressed execution backend; records weight_bytes")
    ap.add_argument("--kv-on-write", action="store_true",
                    help="serving mode: quantize KV entries at write time")
    ap.add_argument("--kv-int8", action="store_true",
                    help="serving mode: REAL int8 KV-cache storage")
    ap.add_argument("--out-dir", default="artifacts/dryrun")
    ap.add_argument("--tag", default="")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the qlint pre-flight gate")
    args = ap.parse_args()

    cells = []
    if args.all:
        for arch in ASSIGNED:
            for shape in SHAPES:
                cells.append((arch, shape))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required unless --all is given")
        cells.append((args.arch, args.shape))

    failures = 0
    for arch, shape in cells:
        rec = run_cell(
            arch, shape, multi_pod=args.multi_pod, policy_name=args.policy,
            recipe_name=args.recipe,
            remat=args.remat, microbatches=args.microbatches,
            compute=args.compute, logits_chunk=args.logits_chunk,
            strategy=args.strategy, prequant=args.prequant,
            compress=args.compress, kv_on_write=args.kv_on_write,
            kv_int8=args.kv_int8, out_dir=args.out_dir, tag=args.tag,
            no_lint=args.no_lint)
        status = rec["status"]
        if status == "ok":
            t = rec["terms"]
            pb = rec.get("policy_bits", {})
            print(
                f"[{status}] {arch} {shape} "
                f"({'mp' if args.multi_pod else 'sp'}): "
                f"compile={rec['compile_s']}s "
                f"flops/dev={rec['flops_per_device']:.3e} "
                f"hbm/dev={rec['hbm_gb_per_device']}GB "
                f"dom={t['dominant']} "
                f"wbits={pb.get('mean_weight_bits', 0):.2f}",
                flush=True,
            )
        elif status == "skipped":
            print(f"[skip] {arch} {shape}: {rec['reason']}", flush=True)
        else:
            failures += 1
            print(f"[FAIL] {arch} {shape}: {rec['error']}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
