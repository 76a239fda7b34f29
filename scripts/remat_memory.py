"""Where a QAT gradient's memory peaks under each rematerialization mode.

Builds h2o-danube-1.8b at published width and ``--layers`` layers (random
weights from ``--seed``) on the card and, for each mode of ``--modes``
(``cfg.remat``: none, dots, full), takes one gradient of the loss as the
train step takes it (every floating leaf a fresh leaf that requires grad,
``torch.autograd.grad``) under w4a8_abfp with the straight-through
estimator, on one batch of ``chip_smoke.DANUBE_SHAPE`` (8 x 512) from the
synthetic corpus.  The allocator's history is recorded over the forward
and the backward (``torch.cuda.memory._record_memory_history``), and one
JSON line a mode is printed:

- ``base_bytes``: allocated before the forward (the parameters);
- ``kept_by_forward_bytes``: allocated after the forward, less the base
  (what autograd and the checkpoints keep for the backward);
- ``peak_forward_bytes`` / ``peak_bytes``: the allocator's peak over the
  forward / over forward and backward, less the base;
- ``grads_bytes``: the gradients, allocated after the backward less the
  base;
- ``at_peak``: the blocks live at the peak of the recorded history, by the
  phase that allocated them (forward or backward) and by the innermost
  frame of the port's source on their stack (the ``--top`` largest
  groups: bytes and count), with the number of blocks allocated inside a
  checkpoint's recomputation.

    python3 scripts/remat_memory.py [--layers 24] [--modes dots,full]
"""

import argparse
import json
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
MARK_BYTES = 512 * 12347  # a block size nothing else asks for


def frame_label(frames) -> str:
    """The innermost frame of the port's source (``file:line name``)."""
    for f in frames:
        name = f.get("filename", "")
        if "repro_torch" in name:
            rel = name[name.index("repro_torch"):]
            return f"{rel}:{f.get('line')} {f.get('name')}"
    return "(outside the port)"


def in_recompute(frames) -> bool:
    return any(f.get("filename", "").endswith("checkpoint.py")
               and "recompute" in f.get("name", "") for f in frames)


def peak_blocks(trace) -> tuple:
    """(the live blocks at the history's peak, the index of the first
    event after the forward's marker) from one device's trace."""
    live, total, best, best_at, mark = {}, 0, -1, 0, None
    for i, ev in enumerate(trace):
        act = ev["action"]
        if act == "alloc":
            live[ev["addr"]] = ev
            total += ev["size"]
            if mark is None and ev["size"] == MARK_BYTES:
                mark = i
        elif act in ("free_requested", "free_completed") \
                and ev["addr"] in live:
            total -= live.pop(ev["addr"])["size"]
        if total > best:
            best, best_at = total, i
    live = {}
    for ev in trace[:best_at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] in ("free_requested", "free_completed"):
            live.pop(ev["addr"], None)
    return list(live.values()), mark if mark is not None else len(trace)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--layers", type=int, default=24)
    ap.add_argument("--modes", default="dots,full")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.append(str(ROOT))
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.core.policy import preset
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.data.loader import LMLoader
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.tree import leaves, unflatten

    cfg = get_config("h2o-danube-1.8b").replace(n_layers=args.layers)
    B, S = cs.DANUBE_SHAPE
    loader = LMLoader(synthetic_corpus(B * (S + 1) + 1, vocab=503,
                                       seed=args.seed),
                      seq_len=S, global_batch=B, seed=args.seed)
    batch = loader.batch_at(0)
    policy = preset("w4a8_abfp", n_layers=cfg.n_layers).with_ste(True)
    for mode in args.modes.split(","):
        cs.free_card(torch)
        model = build_model(cfg.replace(remat=mode), device="cuda")
        params = model.init(make_generator(args.seed, "cuda"))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.memory._record_memory_history(max_entries=2_000_000,
                                                 stacks="python")
        req = [p.detach().requires_grad_() if p.is_floating_point() else p
               for p in leaves(params)]
        loss, _ = model.loss(unflatten(params, req), batch, policy)
        torch.cuda.synchronize()
        kept = torch.cuda.memory_allocated() - base
        peak_fwd = torch.cuda.max_memory_allocated() - base
        mark = torch.empty(MARK_BYTES, dtype=torch.uint8, device="cuda")
        del mark
        grads = torch.autograd.grad(loss, [r for r in req
                                           if r.requires_grad])
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
        grads_bytes = torch.cuda.memory_allocated() - base
        snap = torch.cuda.memory._snapshot()
        torch.cuda.memory._record_memory_history(enabled=None)
        trace = max(snap["device_traces"], key=len)
        blocks, mark_at = peak_blocks(trace)
        first_bwd = {id(ev) for ev in trace[mark_at:]}
        groups = defaultdict(lambda: [0, 0])
        recomputed = 0
        for ev in blocks:
            frames = ev.get("frames", [])
            phase = "backward" if id(ev) in first_bwd else "forward"
            g = groups[(phase, frame_label(frames))]
            g[0] += ev["size"]
            g[1] += 1
            recomputed += in_recompute(frames)
        top = sorted(groups.items(), key=lambda kv: -kv[1][0])[:args.top]
        by_phase = defaultdict(int)
        for (phase, _), (n_bytes, _) in groups.items():
            by_phase[phase] += n_bytes
        print(json.dumps({
            "model": cfg.name, "layers": cfg.n_layers, "remat": mode,
            "batch": [B, S], "loss": float(loss), "base_bytes": base,
            "kept_by_forward_bytes": kept, "peak_forward_bytes": peak_fwd,
            "peak_bytes": peak, "grads_bytes": grads_bytes,
            "at_peak": {"bytes_by_phase": dict(by_phase),
                        "blocks_from_recompute": recomputed,
                        "top": [{"phase": p, "frame": f, "bytes": b,
                                 "count": c}
                                for (p, f), (b, c) in top]}}), flush=True)
        del model, params, req, loss, grads, snap, trace, blocks
    return 0


if __name__ == "__main__":
    sys.exit(main())
