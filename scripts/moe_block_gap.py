"""Where an MoE block's fused P-C output departs from the ref backend's.

Builds phi3.5-moe-42b-a6.6b at published width and ``chip_smoke.PHI_LAYERS``
layers (random weights from ``--seed``), serves it as ``chip_smoke.py``'s
``moe`` phase does under P-C (compressed weights, ``fused``), and for each
token count of ``--tokens`` (the numerics' tokens, from their seed) and
each of the first ``--blocks`` blocks, fed the ref backend's input of the
block (``chip_smoke.block_calls``), prints one JSON line.

Runs of the block, each against the ref backend's run on the same input:

- ``fused``: the fused policy; ``reordered``: the ref backend with every
  matmul's sums added in another order (``chip_smoke.split_contractions``);
- ``fused:<site>``: the ref backend with only the projection ``<site>``
  (q, k, v, o) under the fused policy (its kernel);
- ``reordered:<site>``: the ref backend with only ``<site>`` (q, k, v, o,
  or ``moe``: the router and expert contractions) reordered.

A fused or reordered run differs from the ref run only at its projections
(and, reordered, the MoE contractions): the single-site runs say which
site carries a block's gap.  For each run, the block's rms gap in units of
the std of its update (as ``block_gaps`` forms it) and the share of its
mean square in the worst 1 in 64 rows; for the fused and reordered runs,
at each stage of the block (the projections' outputs; the attention-BMM
quantizer's q / k / v and probs; the attention output, which is o's input;
the expert input and mid activations after their QDQ; the MoE output) the
rms gap in units of the stage's std and the codes that differ from the ref
run's (a value whose QDQ output moves by more than 1e-3 of itself: a code
flipped at a rounding boundary, or its group's scale), with the tokens
that hold the first K / V flips.

    python3 scripts/moe_block_gap.py [--blocks 2] [--tokens 128,512]
"""

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SITES = ("q", "k", "v", "o")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--blocks", type=int, default=2)
    ap.add_argument("--tokens", default="128,512")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.append(str(ROOT))
    import numpy as np
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core import abfp as abfp_mod
    from repro_torch.core.policy import resolve_policy
    from repro_torch.nn import attention as attn_mod
    from repro_torch.nn import linear as linear_mod
    from repro_torch.nn import moe as moe_mod

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    cfg = get_config("phi3.5-moe-42b-a6.6b").replace(n_layers=cs.PHI_LAYERS)
    eng = cs.build_engine(torch, cfg, args.seed, kernel_path=True)
    model, params, kp = eng.model, eng.params, eng.policy
    rp = cs.ref_backend(kp)
    methods = cs.BLOCK_METHODS["lm"]

    dense_apply = linear_mod.Dense.apply
    attn_qdq, moe_qdq = attn_mod.qdq_activation, moe_mod.qdq_activation
    moe_apply = moe_mod.MoE.apply

    @contextlib.contextmanager
    def traced(fused=(), split=()):
        """Records each stage of the block in a dict; the projections in
        ``fused`` run under the fused policy, those in ``split`` (and the
        MoE contractions, where ``split`` holds 'moe') reordered."""
        rec = {}

        def dense(self, p, x, policy, **kw):
            site = self.name.rsplit("/", 1)[-1]
            ctx = (cs.split_contractions(torch) if site in split
                   else contextlib.nullcontext())
            with ctx:
                y = dense_apply(self, p, x, kp if site in fused else policy,
                                **kw)
            rec[site], rec[site + ".in"] = y, x
            rec[site + ".site"] = self.name
            return y

        def qdq(where):
            def call(x, tq, **kw):
                y = (attn_qdq if where == "attn" else moe_qdq)(x, tq, **kw)
                rec[kw.get("site", "").rsplit("/", 1)[-1]] = y
                return y
            return call

        def moe(self, *a, **kw):
            ctx = (cs.split_contractions(torch) if "moe" in split
                   else contextlib.nullcontext())
            with ctx:
                y, m = moe_apply(self, *a, **kw)
            rec["moe_out"] = y
            return y, m

        linear_mod.Dense.apply = dense
        attn_mod.qdq_activation, moe_mod.qdq_activation = qdq("attn"), qdq(
            "moe")
        moe_mod.MoE.apply = moe
        try:
            yield rec
        finally:
            linear_mod.Dense.apply = dense_apply
            attn_mod.qdq_activation, moe_mod.qdq_activation = (attn_qdq,
                                                               moe_qdq)
            moe_mod.MoE.apply = moe_apply

    def o_codes(rec):
        tq = resolve_policy(kp, rec["o.site"]).input
        c, _, _ = abfp_mod.abfp_quantize(
            rec["o.in"], tq.fmt, axis=-1, n=tq.group, dtype=torch.float32,
            scale_dtype=getattr(torch, tq.scale_dtype))
        return c

    def rows_share(d):
        q = d.reshape(-1, d.shape[-1]).square().sum(-1)
        k = max(1, q.numel() // 64)
        return (q.topk(k).values.sum() / q.sum().clamp_min(1e-30)).item()

    def flips(a, b):
        return (a - b).abs() > 1e-3 * torch.maximum(a.abs(), b.abs())

    def stage(a, b, quantized):
        d = a - b
        out = {"rms": (d.square().mean().sqrt() / b.std()).item(),
               "worst_rows_share": rows_share(d)}
        if quantized:
            out["flips"] = int(flips(a, b).sum())
            out["values"] = b.numel()
        return out

    stages = (("q", False), ("k", False), ("v", False), ("bmm_q", True),
              ("bmm_k", True), ("bmm_v", True), ("probs", True),
              ("o.in", False), ("o", False), ("in", True), ("mid", True),
              ("moe_out", False))
    with torch.no_grad():
        for n_tok in (int(t) for t in args.tokens.split(",")):
            rng = np.random.RandomState(19)  # the numerics' tokens
            toks = torch.as_tensor(rng.randint(0, cfg.vocab, (1, n_tok)),
                                   device="cuda")
            calls, run = cs.block_calls(torch, model, params,
                                        {"tokens": toks}, rp, methods)
            for i, (name, a, kw) in enumerate(calls[:args.blocks]):
                x = a[methods[name][0]]
                # each run: (the block's policy, what ``traced`` changes)
                variants = {"ref": (rp, {}), "fused": (kp, {}),
                            "reordered": (rp, {"split": SITES + ("moe",)})}
                variants.update({f"fused:{s}": (rp, {"fused": (s,)})
                                 for s in SITES})
                variants.update({f"reordered:{s}": (rp, {"split": (s,)})
                                 for s in SITES + ("moe",)})
                recs, ys = {}, {}
                for v, (pol, opts) in variants.items():
                    with traced(**opts) as rec:
                        ys[v] = run(name, a, kw, pol)
                    recs[v] = rec
                ref = ys["ref"]
                unit = (ref - x).std()
                line = {"tokens": n_tok, "block": i, "runs": {}}
                for v, y in ys.items():
                    if v != "ref":
                        d = y - ref
                        line["runs"][v] = {
                            "rms": (d.square().mean().sqrt() / unit).item(),
                            "worst_rows_share": rows_share(d)}
                r0 = recs["ref"]
                line["stages"] = {}
                for v in ("fused", "reordered"):
                    r = recs[v]
                    st = {s: stage(r[s], r0[s], q) for s, q in stages}
                    c0, c = o_codes(r0), o_codes(r)
                    st["o.in"].update(flips=int((c != c0).sum()),
                                      values=c0.numel())
                    for s in ("bmm_k", "bmm_v"):  # (B, S, KV, D): tokens
                        at = flips(r[s], r0[s]).nonzero()[:, 1]
                        st[s]["tokens"] = sorted(set(at.tolist()))[:8]
                    line["stages"][v] = st
                print(json.dumps(line), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
