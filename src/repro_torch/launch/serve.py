"""Serving launcher: a continuous-batching engine over a reduced or full
arch.

``python -m repro_torch.launch.serve --arch qwen2-7b --reduced --policy
w4a8_int8_native --attn-backend fused`` drives synthetic requests through
the fixed-slot ``ServeEngine`` (ring-buffer KV, bucketed prefill; prefill
attention through the dense flash-attention kernel); with ``--paged
--compress --kv int8 --attn-backend compressed`` through
``PagedServeEngine``.  It reports throughput (and page accounting when
paged) with the JSON keys of the reference launcher, and runs on the card
unless ``--device cpu`` is given.  ``--recipe`` runs a PTQ recipe
(``repro_torch.core.recipe``) over the random weights first, calibrating on
synthetic prompts on the same device, as the reference launcher does.

An encoder-only classifier (``--arch vit-b16`` / ``deit-s16``) has nothing
to decode: the launcher exits before building anything, as the reference's
does.  ``--arch mamba2-130m`` serves through the fixed-slot engine
(exact-length prefills, a recurrent state a slot); with ``--paged`` it
raises ``init_paged_state``'s ``TypeError``, and ``--arch zamba2-7b``
raises the engine's ``TypeError`` (a ``HybridState``), as the reference's
launcher does.  Neither launcher serves the encoder-decoder or the VLM,
and the port fails as the reference does: ``--arch whisper-large-v3``
raises the engine's ``TypeError`` (an ``EncDecState``), with ``--paged``
an ``AttributeError`` (``EncDecLM`` has no ``init_paged_state``);
``--arch internvl2-2b`` raises a ``KeyError`` (``'patch_embeds'``: the
synthetic requests carry no patch embeddings) at the first prefill, and
with ``--paged`` serves the text alone (the paged step takes no prefix).
Both run through ``Model`` instead (``chip_smoke.py --phases encdec``).
The dense configs (gemma2-9b, granite-3-8b, h2o-danube-1.8b) and the MoE
configs (phi3.5-moe-42b-a6.6b, llama4-scout-17b-a16e) serve through
either engine.  ``--speculate`` serves through ``SpeculativeServeEngine``
(a ``--draft-preset`` draft compressed from the same weights proposes
``--draft-k`` tokens a round, the target verifies them in one pass; with
``--paged`` over fp pages) and reports acceptance stats.  On an MoE arch,
``--compress --expert-cache N`` keeps an LRU of N decompressed experts a
MoE site and reports hit / miss and residency stats; ``--expert-precision
auto`` probes routing frequencies on synthetic prompts and serves the
hottest quarter of the experts at INT8, the rest at INT4.  Neither expert
flag combines with ``--speculate``, as in the reference.
Before any weight is built, the qlint pre-flight gate
(``repro_torch.launch.lint.preflight``) lints the launch: the policy, the
recipe, the page geometry, the speculative pair, the expert cache and the
attention backend; an error exits with code 2 and the report on stderr,
before anything is allocated on the card (``--expert-precision auto`` is
gated again once its map is assigned).  ``--no-lint`` bypasses the gate.
Like the reference launcher it has no flag that sets ``fused`` on the
policy, so its matmuls take the non-kernel paths; the matmul kernels are
reached through the engine API (see ``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--policy", default=None,
                    help="policy preset (default fp32, or the --recipe's "
                    "paired policy)")
    ap.add_argument("--recipe", default=None,
                    help="QuantRecipe name applied to the weights before "
                    "serving (e.g. smoothquant+gptq); calibrates on "
                    "synthetic prompts")
    ap.add_argument("--compress", action="store_true",
                    help="compressed-domain serving: store each kernel per "
                    "its resolved site rule (int codes + group scales; "
                    "INT4 packs two-per-byte) and contract the codes "
                    "directly — reports resident weight bytes")
    ap.add_argument("--expert-cache", type=int, default=None,
                    help="expert-resident MoE serving (requires --compress "
                    "on an MoE arch): LRU capacity, in experts per MoE "
                    "site, of decompressed-dense copies admitted by "
                    "routing frequency; reports hit/miss + residency "
                    "stats (E//4 is the useful starting point)")
    ap.add_argument("--expert-precision", default="flat",
                    choices=("flat", "auto"),
                    help="'auto' probes routing frequencies and assigns "
                    "per-expert weight formats (hot experts INT8, cold "
                    "INT4) as */experts.{e} policy rules before serving; "
                    "'flat' keeps the policy's single weight format")
    ap.add_argument("--n-slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="serve with the paged-KV engine (block pool + "
                    "chunked prefill) instead of fixed ring-buffer slots; "
                    "reports page-pool and resident-KV-byte accounting")
    ap.add_argument("--page-size", type=int, default=16,
                    help="tokens per KV page (--paged)")
    ap.add_argument("--n-pages", type=int, default=None,
                    help="physical pages in the shared pool (--paged; "
                    "default sizes for full occupancy of every slot)")
    ap.add_argument("--kv", default="auto",
                    choices=("auto", "fp", "int8", "fp8"),
                    help="page storage format (--paged); 'auto' follows the "
                    "policy's kv_cache mode")
    ap.add_argument("--attn-backend", default="auto",
                    choices=("auto", "ref", "fused", "compressed"),
                    help="attention backend at the attention block sites: "
                    "'compressed' contracts stored int8/fp8 KV codes inside "
                    "the quantized-KV kernel (needs quantized storage), "
                    "'fused' runs the dense flash-attention kernel at "
                    "prefill where eligible, 'ref' pins the plain path, "
                    "'auto' keeps the module defaults")
    ap.add_argument("--speculate", action="store_true",
                    help="speculative serving: a compressed low-precision "
                    "draft (same param tree, --draft-preset policy) "
                    "proposes --draft-k tokens per round and the target "
                    "verifies them in one chunked pass; reports "
                    "acceptance stats (--paged selects paged KV with fp "
                    "pages — --kv is ignored)")
    ap.add_argument("--draft-preset", default="w4a8_abfp",
                    help="draft-side policy preset (--speculate)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="draft tokens proposed per verify pass "
                    "(--speculate)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy; "
                    "under --speculate, > 0 switches acceptance to "
                    "rejection sampling)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k sampling cutoff (0 = full "
                    "distribution)")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the qlint pre-flight gate")
    ap.add_argument("--device", default="cuda",
                    help="where the model lives and runs (default: the "
                    "card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)

    from repro_torch.analysis import messages as msg
    from repro_torch.configs import get_config
    from repro_torch.core.policy import (has_layer_rules, preset,
                                         replace_enabled, with_attn_backend)
    from repro_torch.launch.lint import preflight
    from repro_torch.models import build_model
    from repro_torch.models.serving_transforms import weight_bytes_summary
    from repro_torch.nn.module import make_generator
    from repro_torch.serve.engine import (PagedServeEngine, Request,
                                          ServeEngine)
    from repro_torch.serve.kv_pages import PageGeometry, pages_for
    from repro_torch.serve.speculative import SpeculativeServeEngine

    cfg = get_config(args.arch)
    if cfg.family == "vit":
        raise SystemExit(
            f"{args.arch} is an encoder-only classifier: nothing to decode. "
            "Its forward, fused kernels and PTQ run on the card through "
            "`python3 chip_smoke.py --phases vit`.")
    if args.reduced:
        cfg = cfg.reduced()
    rec = None
    if args.recipe:
        from repro_torch.core.recipe import get_recipe

        rec = get_recipe(args.recipe)
    # an explicit --policy wins; otherwise the recipe's paired policy
    policy_name = args.policy or (rec.policy_preset if rec else None) or "fp32"
    policy = preset(policy_name, n_layers=cfg.n_layers)
    if args.attn_backend != "auto":
        policy = with_attn_backend(policy, args.attn_backend)
    if has_layer_rules(policy):
        # layer-indexed PolicyMap rules need per-layer sites (eager unroll)
        cfg = cfg.replace(scan_layers=False)
    if rec is not None:
        # calibration observers need eager per-layer execution
        cfg = cfg.replace(scan_layers=False, remat="none")
    pages_geo = None
    if args.paged:
        # mirror PagedServeEngine's defaults so the gate lints what runs
        chunk = max(args.page_size, -(-64 // args.page_size) * args.page_size)
        n_pages = (args.n_pages if args.n_pages is not None
                   else args.n_slots * pages_for(args.max_len,
                                                 args.page_size))
        pages_geo = PageGeometry(page_size=args.page_size, n_pages=n_pages,
                                 max_len=args.max_len, prefill_chunk=chunk)
    experts = None
    if args.expert_cache is not None or args.expert_precision != "flat":
        if args.speculate:
            raise SystemExit(
                "--expert-cache / --expert-precision are not supported "
                "under --speculate (the draft/target pair shares no "
                "expert store)")
        if args.expert_cache is not None and not args.compress:
            raise SystemExit(msg.expert_cache_requires_compress_message())
        experts = {"cache_capacity": args.expert_cache}
    draft_policy = None
    speculative = None
    if args.speculate:
        draft_policy = preset(args.draft_preset, n_layers=cfg.n_layers)
        if has_layer_rules(draft_policy):
            cfg = cfg.replace(scan_layers=False)
        speculative = {"draft_policy": draft_policy,
                       "draft_k": args.draft_k}
    attn_ctx = {"engine": "paged" if args.paged else "fixed"}
    if args.paged and args.kv != "auto":
        attn_ctx["kv"] = args.kv
    if not args.no_lint:
        # pre-flight gate: errors abort before any weights are built
        preflight(cfg, policy, rec, compress=args.compress,
                  scan_layers=cfg.scan_layers, pages=pages_geo,
                  speculative=speculative, experts=experts, attn=attn_ctx,
                  where="serve")

    model = build_model(cfg, device=args.device)
    params = model.init(make_generator(args.seed, args.device))
    recipe_info = {}
    if rec is not None:
        from repro_torch.core.recipe import (apply_recipe,
                                             quantizes_weights_offline)

        crng = np.random.RandomState(args.seed + 1)
        batches = [
            {"tokens": crng.randint(0, cfg.vocab, (2, 32)).astype(np.int32)}
            for _ in range(2)
        ]
        # observers only fire at quantized matmuls: calibrate under an
        # enabled policy even when serving fp32
        obs = policy if policy.enabled else preset("w4a8_mse")
        res = apply_recipe(rec, model, params, batches, policy,
                           calib_policy=obs)
        params = res.params
        if quantizes_weights_offline(rec):
            # GPTQ left pre-quantized kernels: drop runtime weight QDQ
            # (the prequant serving convention — re-quantization adds
            # pure double-quantization noise)
            policy = replace_enabled(policy, weight=None)
        recipe_info = {"recipe": rec.name,
                       "recipe_calibrations": res.n_calibrations}
        if res.qtree is not None:
            # the serving path has no static-q plumbing: static scalers
            # fall back to dynamic-max at prefill/decode
            print(f"note: recipe {rec.name!r} produced a static q tree; "
                  "serving ignores it (dynamic-max fallback)",
                  file=sys.stderr)
    expert_info = {}
    if args.expert_precision == "auto":
        from repro_torch.serve.experts import (assign_expert_precision,
                                               hot_experts,
                                               route_frequencies)

        if not getattr(model, "is_moe", False):
            # the QL502 gate blocks this before weights are built; mirror
            # it here for --no-lint runs
            raise SystemExit(msg.expert_non_moe_message(
                "--expert-precision auto", cfg.name))
        # offline assignment pass: probe routing frequencies on synthetic
        # prompts (group-size-aligned), hottest E//4 experts -> INT8,
        # the rest INT4, emitted as a serializable per-expert PolicyMap
        prng = np.random.RandomState(args.seed + 2)
        gt = max(1, cfg.moe_group_tokens)
        probe = [prng.randint(0, cfg.vocab, (1, gt)).astype(np.int32)
                 for _ in range(2)]
        loads = route_frequencies(model, params, probe, policy=policy)
        n_hot = max(1, cfg.n_experts // 4)
        hot = hot_experts(loads, n_hot)
        try:
            policy = assign_expert_precision(loads, policy, n_hot=n_hot)
        except ValueError as e:  # e.g. fp32 base: no weight rule to split
            raise SystemExit(f"--expert-precision auto: {e}")
        policy_name = policy.name
        expert_info["expert_precision"] = {
            "mode": "auto",
            "hot_experts": [int(e) for e in hot],
            "loads": [float(x) for x in np.asarray(loads).sum(axis=0)],
        }
        if not args.no_lint:
            # re-gate with the assigned map + hot set (QL503 inversion)
            preflight(cfg, policy, rec, compress=args.compress,
                      scan_layers=cfg.scan_layers, pages=pages_geo,
                      experts={"cache_capacity": args.expert_cache,
                               "hot_experts": hot}, where="serve")
    if args.speculate:
        kw = {}
        if args.paged:
            kw = dict(kv_cache="paged", page_size=pages_geo.page_size,
                      n_pages=pages_geo.n_pages,
                      prefill_chunk=pages_geo.prefill_chunk)
        engine = SpeculativeServeEngine(
            model, params, target_policy=policy, draft_policy=draft_policy,
            draft_k=args.draft_k, n_slots=args.n_slots,
            max_len=args.max_len, device=args.device, **kw,
        )
    elif args.paged:
        engine = PagedServeEngine(
            model, params, n_slots=args.n_slots, max_len=args.max_len,
            policy=policy, compress=args.compress,
            page_size=pages_geo.page_size, n_pages=pages_geo.n_pages,
            prefill_chunk=pages_geo.prefill_chunk, kv=args.kv,
            expert_cache=args.expert_cache, device=args.device,
        )
    else:
        engine = ServeEngine(
            model, params, n_slots=args.n_slots, max_len=args.max_len,
            policy=policy, compress=args.compress,
            expert_cache=args.expert_cache, device=args.device,
        )
    del params  # with --compress the engine holds the served tree only
    compress_info = {}
    if args.compress:
        wb = engine.weight_bytes
        if wb["compressed_sites"] == 0:
            print("note: --compress found no int-format weight rules to "
                  "compress (all sites dense)", file=sys.stderr)
        compress_info = weight_bytes_summary(wb)

    rng = np.random.RandomState(args.seed)
    for uid in range(args.n_requests):
        plen = int(rng.randint(4, 17))
        engine.submit(
            Request(
                uid=uid,
                prompt=rng.randint(0, cfg.vocab, size=plen).astype(np.int32),
                max_new_tokens=args.max_new_tokens,
                temperature=args.temperature,
                top_k=args.top_k,
            )
        )
    t0 = time.perf_counter()
    done = engine.run_until_done()
    if engine.device.type == "cuda":
        import torch

        torch.cuda.synchronize(engine.device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(c.tokens) for c in done)
    # per-request completion metadata: accept counts and target steps are
    # per-request facts, so they are reported there
    completions = []
    for c in done:
        row = {"uid": c.uid, "prompt_len": c.prompt_len,
               "n_tokens": len(c.tokens),
               "finished_reason": c.finished_reason}
        if args.speculate:
            row.update({
                "target_steps": c.target_steps,
                "drafted_tokens": c.drafted_tokens,
                "accepted_draft_tokens": c.accepted_draft_tokens,
                "acceptance_rate": round(
                    c.accepted_draft_tokens / c.drafted_tokens, 4)
                    if c.drafted_tokens else 0.0,
            })
        completions.append(row)
    spec_info = {}
    if args.speculate:
        stats = engine.acceptance_stats()
        spec_info = {"speculative": {
            "draft_preset": args.draft_preset,
            "draft_k": args.draft_k,
            "kv_cache": engine.kv_cache,
            **{k: stats[k] for k in ("rounds", "target_steps", "draft_steps",
                                     "drafted", "accepted")},
            "acceptance_rate": round(stats["acceptance_rate"], 4),
            "accepted_per_target_step": round(
                stats["accepted_per_target_step"], 4),
        }}
        if engine.weight_bytes is not None:
            spec_info["speculative"]["draft_weights"] = \
                weight_bytes_summary(engine.weight_bytes)
        if args.paged:
            spec_info["speculative"]["page_stats"] = engine.page_stats()
    estats = None if args.speculate else engine.expert_stats()
    if estats is not None:
        expert_info["experts"] = {
            **{k: estats[k] for k in (
                "capacity", "n_experts", "n_sites", "cached_experts", "hits",
                "misses", "evictions")},
            "hit_rate": round(estats["hit_rate"], 4),
            **{k: estats[k] for k in (
                "store_bytes", "cache_bytes", "resident_bytes", "hot_bytes",
                "cold_bytes", "dense_bytes")},
            "resident_ratio": round(estats["ratio"], 4),
            "sites": estats["sites"],
        }
    paged_info = {}
    if args.paged and not args.speculate:
        stats = engine.page_stats()
        paged_info = {
            "paged": True,
            "kv": engine.kv,
            "page_size": engine.geometry.page_size,
            "prefill_chunk": engine.geometry.prefill_chunk,
            **stats,
        }
        if stats["pages_in_use"]:
            paged_info.update(engine.kv_bytes())
    print(
        json.dumps(
            {
                "arch": cfg.name,
                "policy": policy_name,
                "requests": len(done),
                "generated_tokens": total_tokens,
                "ticks": engine.ticks,
                "wall_s": round(dt, 3),
                "tokens_per_s": round(total_tokens / dt, 1),
                "completions": completions,
                **recipe_info,
                **compress_info,
                **expert_info,
                **spec_info,
                "attention": {
                    "backend": getattr(engine, "attn_backend", "auto"),
                    "engine": "paged" if args.paged else "fixed"},
                "device": str(engine.device),
                **paged_info,
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
