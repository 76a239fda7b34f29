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
either engine.  Flags of the reference launcher whose features are not ported yet
(``--speculate``, ``--expert-cache``, ``--expert-precision auto``) exit
with a message naming the ROADMAP item that will bring them.
There is no lint gate yet: the static analyzer is a late slice of the
port, and the launcher says so.  Like the reference launcher it has no flag
that sets ``fused`` on the policy, so its matmuls take the non-kernel
paths; the matmul kernels are reached through the engine API (see
``chip_smoke.py``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def _not_ported(flag: str, item: str) -> SystemExit:
    return SystemExit(
        f"{flag} is not supported by the PyTorch port yet — ROADMAP.md "
        f"Queue A, '{item}'")


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
                    help="not ported yet")
    ap.add_argument("--expert-precision", default="flat",
                    choices=("flat", "auto"), help="'auto' is not ported yet")
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
    ap.add_argument("--speculate", action="store_true", help="not ported yet")
    ap.add_argument("--draft-preset", default="w4a8_abfp",
                    help="not ported yet (--speculate)")
    ap.add_argument("--draft-k", type=int, default=4,
                    help="not ported yet (--speculate)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="per-request sampling temperature (0 = greedy)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="per-request top-k sampling cutoff (0 = full "
                    "distribution)")
    ap.add_argument("--no-lint", action="store_true",
                    help="accepted for compatibility: there is no lint gate "
                    "in the port yet")
    ap.add_argument("--device", default="cuda",
                    help="where the model lives and runs (default: the "
                    "card; 'cpu' must be asked for)")
    args = ap.parse_args(argv)

    if args.speculate:
        raise _not_ported("--speculate", "Speculative + MoE serving")
    if args.expert_cache is not None or args.expert_precision != "flat":
        raise _not_ported("--expert-cache / --expert-precision auto",
                          "Speculative + MoE serving")

    from repro_torch.configs import get_config
    from repro_torch.core.policy import (preset, replace_enabled,
                                         with_attn_backend)
    from repro_torch.models import build_model
    from repro_torch.models.serving_transforms import weight_bytes_summary
    from repro_torch.nn.module import make_generator
    from repro_torch.serve.engine import (PagedServeEngine, Request,
                                          ServeEngine)

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
    print("note: no pre-flight lint gate in the PyTorch port yet (the "
          "static analyzer is a later slice)", file=sys.stderr)

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
    if args.paged:
        engine = PagedServeEngine(
            model, params, n_slots=args.n_slots, max_len=args.max_len,
            policy=policy, compress=args.compress, page_size=args.page_size,
            n_pages=args.n_pages, kv=args.kv, device=args.device,
        )
    else:
        engine = ServeEngine(
            model, params, n_slots=args.n_slots, max_len=args.max_len,
            policy=policy, compress=args.compress, device=args.device,
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
    completions = [
        {"uid": c.uid, "prompt_len": c.prompt_len, "n_tokens": len(c.tokens),
         "finished_reason": c.finished_reason}
        for c in done
    ]
    paged_info = {}
    if args.paged:
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
                "attention": {"backend": engine.attn_backend,
                              "engine": "paged" if args.paged else "fixed"},
                "device": str(engine.device),
                **paged_info,
            }
        )
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
