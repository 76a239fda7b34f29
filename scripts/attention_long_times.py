"""The long-context prefill chunk's attention on the card, for one tree.

Run it on this checkout, or with ``--src DIR`` on another tree of this
repository (an unpacked ``git archive`` of a parent commit), in turns in
one call, to compare the two on one card: the tree's own kernels are built
into its own ``build/``; the inputs, the engine, the state copy and the
profile are this checkout's ``chip_smoke.py`` helpers.

Prints one JSON line: the card, the kernel that ``flash_attention_quant``
launches at the long path's chunk shape (B = 4, S = 64, T = 8192, H = 28,
KV = 4, D = 128, int8 codes, phased, bk = 512, probs QDQ n = 64; batch rows
starting at 8128, 5000, 2000 and a dead row) and its time (CUDA events, L2
flushed between calls, median of 10); then one paged prefill step of
qwen2-7b at published width and depth with ``max_len`` 8192 (random
weights, ``w4a8_abfp`` with ``fused`` weights, int8 pages of 16, the
``compressed`` attention backend), two rows 3,968 keys into prompts of
4,100 tokens and two idle slots: the step's wall time and, under the
profiler, its device busy time and the attention kernels' time and
launches.  The step is replayed from a copy of the engine's state.
``--recompute`` plans ``attention_long_kernel`` with pass 2 forming the
scores again instead of reading back the ones pass 1 stored.

    python3 scripts/attention_long_times.py [--src DIR] [--recompute]
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT),
                    help="root of the tree whose src/ is timed")
    ap.add_argument("--recompute", action="store_true",
                    help="attention_long_kernel without the score store")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve() / "src"))
    sys.path.append(str(ROOT))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_quant as faq
    from repro_torch.serve.engine import Request

    # after repro_torch: chip_smoke puts this checkout's src/ first on the
    # path, and the package must stay the --src tree's
    import chip_smoke as cs

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    if args.recompute:
        long_plan = faq.plan_attention_long
        faq.plan_attention_long = (
            lambda *a, **kw: long_plan(*a, **kw, store=False))
    out = {"src": str(Path(args.src).resolve()), "card": cs.nvidia_smi_line(),
           "recompute": args.recompute}

    # ---- the chunk call alone
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    B, S, T, H, KV, D = 4, 64, 8192, 28, 4, 128
    inputs = cs.attention_inputs(torch, gen, B=B, S=S, T=T, H=H, KV=KV, D=D,
                                 fp8=False, q_starts=[8128, 5000, 2000, -1])
    kw = dict(scale=D ** -0.5, causal=True, probs_n=64, probs_qmax=127.0,
              probs_qmin=-127.0, block_k=512)
    out["chunk_call"] = {
        "kernel": faq.plan_attention(B, S, T, H, KV, D, 512, 64).kernel,
        "ms": cs.Timer(torch)(
            lambda: faq.flash_attention_quant(*inputs, 1 << 30, **kw),
            iters=10)}
    del inputs
    torch.cuda.empty_cache()

    # ---- one paged prefill step: two rows from 3,968 to 4,032 keys
    cfg = get_config("qwen2-7b")
    eng = cs.build_engine(torch, cfg, 0, kernel_path=True, max_len=8192)
    rng = np.random.RandomState(5)
    for uid in range(2):
        eng.submit(Request(uid=uid, max_new_tokens=2, prompt=rng.randint(
            0, cfg.vocab, size=4100).astype(np.int32)))
    snap = {}
    inner = eng._paged_step

    def paged_step(params, tokens, state, n_valid):
        if not snap and tokens.shape[1] > 1 and eng._pf_pos[0] == 3968:
            snap["args"] = (tokens, cs.clone_state(state), n_valid)
        return inner(params, tokens, state, n_valid)

    eng._paged_step = paged_step
    while not snap:
        eng.tick()
    eng._paged_step = inner
    tokens, state, n_valid = snap["args"]

    walls = []
    for _ in range(3):
        fresh = cs.clone_state(state)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        inner(eng.params, tokens, fresh, n_valid)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    fresh = cs.clone_state(state)
    prof = cs.profile_steps(
        torch, lambda: inner(eng.params, tokens, fresh, n_valid), 1,
        statistics.median(walls), "chunk", watch=tuple(cs.ATTENTION_KERNELS))
    out["chunk_step"] = {
        "keys_seen": 4032, "wall_ms": statistics.median(walls),
        "device_busy_ms": prof.get("device_busy_ms_per_step"),
        "device_idle_share": prof.get("device_idle_share"),
        "attention": {k: v for k, v in prof.get(
            "watched_kernels_per_step", {}).items() if v["launches"]}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
