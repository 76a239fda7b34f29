"""Training launcher: ``python -m repro_torch.launch.train --arch <id> ...``.

The reference's training launcher, with its flags and its summary keys:
builds the model from an arch config (optionally reduced), the
deterministic data pipeline, the quantization policy, the (optionally QAT)
train step, and runs the fault-tolerant loop with checkpointing; with
``--recipe`` it then applies a PTQ recipe to the trained weights and
reports the quantized evaluation beside the fp one.

It runs on the card unless ``--device cpu`` is given; there the train
step is deterministic as it stands (the index and gather backwards
accumulate by sorting, or into distinct elements), so a restarted run is
bit-identical to an uninterrupted one without
``torch.use_deterministic_algorithms`` (``chip_smoke.py --phases train``
checks both).  Before any weight is built the qlint pre-flight gate
(``repro_torch.launch.lint.preflight``) lints the policy, the recipe and
the training shape; an error (an unknown ``--recipe`` is QL101) exits
with code 2 and the report on stderr, before anything is allocated on the
card.  ``--no-lint`` bypasses the gate.  An image classifier (``--arch
vit-b16``) exits as the reference's launcher does.
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="opt-tiny")
    ap.add_argument("--reduced", action="store_true",
                    help="use the arch's reduced CPU-scale config")
    ap.add_argument("--policy", default="fp32")
    ap.add_argument("--recipe", default=None,
                    help="QuantRecipe name to apply post-training (PTQ on "
                    "the final weights, e.g. smoothquant+gptq)")
    ap.add_argument("--qat", action="store_true",
                    help="enable the PWL-STE backward (paper eqn (5))")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--weight-decay", type=float, default=0.01)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--corpus-tokens", type=int, default=200_000)
    ap.add_argument("--corpus-path", default=None,
                    help="text file to train on (default: synthetic)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=50)
    ap.add_argument("--metrics", default=None)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--abfp-n", type=int, default=64)
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the qlint pre-flight gate")
    ap.add_argument("--device", default="cuda",
                    help="where the model lives and trains (default: the "
                    "card; 'cpu' must be asked for)")
    return ap


def make_everything(args):
    """(model, params, opt, opt_state, loader, train_step, eval_fn,
    policy)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core.policy import has_layer_rules, preset
    from repro_torch.data.corpus import synthetic_corpus, text_corpus
    from repro_torch.data.loader import LMLoader, eval_batches
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.step import TrainStepConfig, make_train_step

    device = getattr(args, "device", "cuda")
    cfg = get_config(args.arch)
    if cfg.family == "vit":
        raise SystemExit(
            f"{args.arch} is an image classifier; this launcher drives "
            "token-LM training. Use `python -m benchmarks.run --only "
            "vit_table` for the ViT workload.")
    if args.reduced:
        cfg = cfg.reduced()
    if args.recipe:
        # post-training PTQ recipe: calibration taps every layer eagerly
        cfg = cfg.replace(scan_layers=False, remat="none")
    policy = preset(args.policy, n=args.abfp_n, n_layers=cfg.n_layers)
    if has_layer_rules(policy):
        cfg = cfg.replace(scan_layers=False)
    if args.qat and policy.enabled:
        policy = policy.with_ste(True)
    if not getattr(args, "no_lint", False):
        # pre-flight gate: errors abort before any weights are built
        from repro_torch.configs.base import ShapeSpec
        from repro_torch.launch.lint import preflight

        shape = ShapeSpec("train_cli", args.seq_len, args.global_batch,
                          "train")
        preflight(cfg, policy, args.recipe or None, shape=shape,
                  scan_layers=cfg.scan_layers, where="train")

    model = build_model(cfg, device=device)
    params = model.init(make_generator(args.seed, device))

    if args.corpus_path:
        stream = text_corpus(args.corpus_path)
    else:
        stream = synthetic_corpus(args.corpus_tokens,
                                  vocab=min(cfg.vocab, 503), seed=args.seed)
    n_eval = max(len(stream) // 10, args.seq_len * 2 + 2)
    train_stream, eval_stream = stream[:-n_eval], stream[-n_eval:]
    loader = LMLoader(train_stream, seq_len=args.seq_len,
                      global_batch=args.global_batch, seed=args.seed)
    loader.tokens_per_step = args.seq_len * args.global_batch

    opt = AdamW(lr=warmup_cosine(args.lr, args.warmup, args.steps),
                weight_decay=args.weight_decay)
    opt_state = opt.init(params)
    step_fn = make_train_step(
        model, opt, policy, TrainStepConfig(microbatches=args.microbatches))

    def eval_fn(params, max_batches: int = 8, eval_policy=None, q=None):
        losses = []
        with torch.no_grad():
            for batch in eval_batches(eval_stream, args.seq_len,
                                      min(args.global_batch, 8),
                                      max_batches=max_batches):
                loss, _ = model.loss(params, batch,
                                     eval_policy if eval_policy is not None
                                     else policy, q=q)
                losses.append(float(loss))
        ppl = float(np.exp(np.mean(losses))) if losses else float("nan")
        return {"eval_loss": float(np.mean(losses)), "eval_ppl": ppl}

    return model, params, opt, opt_state, loader, step_fn, eval_fn, policy


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    from repro_torch.checkpoint.manager import CheckpointConfig
    from repro_torch.train.loop import LoopConfig, run

    (model, params, opt, opt_state, loader, step_fn, eval_fn,
     policy) = make_everything(args)

    ckpt = None
    if args.ckpt_dir:
        ckpt = CheckpointConfig(directory=args.ckpt_dir,
                                interval=args.ckpt_interval)
    loop_cfg = LoopConfig(
        total_steps=args.steps,
        metrics_path=args.metrics,
        checkpoint=ckpt,
        eval_every=args.eval_every,
        handle_sigterm=True,
    )
    result, params, opt_state = run(step_fn, params, opt_state, loader,
                                    loop_cfg, eval_fn=eval_fn)
    final_eval = eval_fn(params)
    summary = {
        "arch": args.arch,
        "policy": policy.name,
        "steps": result.last_step + 1,
        "final_loss": result.last_metrics.get("loss"),
        "resumed_from": result.resumed_from,
        "stragglers": result.stragglers,
        **final_eval,
    }
    if args.recipe:
        # post-training PTQ: apply the recipe to the trained weights and
        # report the quantized eval alongside the fp one
        from repro_torch.core.policy import preset, replace_enabled
        from repro_torch.core.recipe import (apply_recipe, get_recipe,
                                             quantizes_weights_offline)

        rec = get_recipe(args.recipe)
        rpolicy = (preset(rec.policy_preset, n_layers=model.cfg.n_layers)
                   if rec.policy_preset else policy)
        batches = [loader.batch_at(s) for s in range(4)]
        # observers only fire at quantized matmuls: calibrate under an
        # enabled policy even when the eval policy is fp32 (W4A16 GPTQ)
        obs = rpolicy if rpolicy.enabled else preset("w4a8_mse")
        res = apply_recipe(rec, model, params, batches, rpolicy,
                           calib_policy=obs)
        eval_policy = rpolicy
        if quantizes_weights_offline(rec):
            # GPTQ already QDQ'd the kernels offline: runtime weight
            # re-quantization would add pure double-quantization noise
            eval_policy = replace_enabled(rpolicy, weight=None)
        req = eval_fn(res.params, eval_policy=eval_policy, q=res.qtree)
        summary.update({
            "recipe": rec.name,
            "recipe_policy": rpolicy.name,
            "recipe_calibrations": res.n_calibrations,
            "recipe_eval_loss": req["eval_loss"],
            "recipe_eval_ppl": req["eval_ppl"],
        })
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
