#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card, ``nvcc`` and nothing else: it builds the CUDA
kernels from the sources in this checkout, holds each against its plain
PyTorch version on the card at the shapes the serving path gives it, then
serves requests through ``PagedServeEngine`` with qwen2-7b at its published
width and depth (random weights from ``--seed``) and shows that the run went
through the kernels.  Without a card it exits non-zero and prints no result.

Phases (each fatal on failure):
  device    card name / power limit, torch / CUDA / nvcc versions
  build     one nvcc per kernel source, all started together
  kernels   kernel vs plain version, then timed (CUDA events, L2 flushed
            between launches, median) beside the plain version and the
            card's bound for the same work
  serve     full width, full depth: 6 greedy requests through the engine;
            launch counts per step asserted (197 matmul + 28 attention)
  reduced   reduced width: the kernel path on the card must emit the tokens
            of the plain path on the CPU (the path the CPU tests hold
            token-identical to the JAX reference)
  identity  full width, 2 layers: the kernel path against the non-kernel
            path (fused=False, attn_backend="ref"), with a last-bit-noise
            control run as the yardstick

The last lines of standard output are: one JSON object {"kernels": [...]},
the card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12

PHASES = ("kernels", "serve", "reduced", "identity")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


# --------------------------------------------------------------------------
# timing
# --------------------------------------------------------------------------
class Timer:
    """Median time of a call on the card: CUDA events around each launch,
    with a buffer larger than the 50 MB L2 rewritten in between so every
    launch finds its operands in device memory, as the serving loop does
    (197 different weights stream through between two uses of one)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


# --------------------------------------------------------------------------
# phase: kernels
# --------------------------------------------------------------------------
def check_quant_matmul(torch, timer, gen, *, M, K, N, packed, label,
                       timed=True) -> dict:
    from repro_torch.core.formats import INT8
    from repro_torch.core.quantize import pack_int4_codes
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_plain)

    n = 64
    G = K // n
    x = torch.randn((M, K), generator=gen, device="cuda")
    # a few outlier channels, as activations have
    x[:, :: 97] *= 8.0
    lim = 8 if packed else 128
    codes = torch.randint(-lim + 1, lim, (N, G, n), generator=gen,
                          device="cuda", dtype=torch.int8)
    if packed:
        codes = pack_int4_codes(codes)
    scales = torch.rand((N, G), generator=gen, device="cuda") * 0.02 + 1e-3
    got = quant_matmul(x, codes, scales, INT8, n=n, packed=packed)
    torch.cuda.synchronize()
    want = quant_matmul_plain(x, codes, scales, INT8, n=n, packed=packed)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    # Same codes, same integer group sums; only the f32 sum over up to 296
    # groups runs in another order: 1e-5 of the largest output magnitude.
    tol = 1e-5 * ref
    ok = bool(torch.isfinite(got).all().item()) and err <= tol
    row = {"shape": label, "M": M, "K": K, "N": N, "packed": packed,
           "max_abs_err": err, "tol": tol, "ok": ok}
    if timed:
        moved = nbytes(x, codes, scales, got)
        row["bytes_ms"] = moved / PEAK_BYTES_PER_S * 1e3
        row["ops_ms"] = 2.0 * M * N * K / PEAK_INT8_OPS * 1e3
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                           else "operations")
        row["ms"] = timer(lambda: quant_matmul(x, codes, scales, INT8, n=n,
                                               packed=packed), iters=10)
        row["plain_ms"] = timer(
            lambda: quant_matmul_plain(x, codes, scales, INT8, n=n,
                                       packed=packed), iters=3, warmup=1)
    log(f"  quant_matmul {label}: " + json.dumps(row))
    if not ok:
        raise SystemExit(f"quant_matmul disagrees with its plain version "
                         f"at {label}: max_abs_err={err} > {tol}")
    return row


def attention_inputs(torch, gen, *, B, S, T, H, KV, D, fp8, q_starts):
    """Cache-style inputs: row b holds q_starts[b] + S tokens; a start of
    -1 makes a dead row (n_valid = 0: every kv position invalid)."""
    q = torch.randn((B, S, H, D), generator=gen, device="cuda")
    raw = torch.randint(-127, 128, (2, B, T, KV, D), generator=gen,
                        device="cuda", dtype=torch.int8)
    if fp8:
        kc, vc = ((c.to(torch.float32) / 16.0).to(torch.float8_e4m3fn)
                  for c in raw)
    else:
        kc, vc = raw[0].contiguous(), raw[1].contiguous()
    ks = torch.rand((B, T, KV), generator=gen, device="cuda") * 0.05 + 1e-3
    vs = torch.rand((B, T, KV), generator=gen, device="cuda") * 0.05 + 1e-3
    starts = torch.tensor(q_starts, dtype=torch.int32, device="cuda")
    steps = torch.arange(S, dtype=torch.int32, device="cuda")[None]
    q_pos = torch.clamp_min(starts, 0)[:, None] + steps
    n_ctx = torch.where(starts >= 0, starts + S, torch.zeros_like(starts))
    idx = torch.arange(T, dtype=torch.int32, device="cuda")[None]
    kv_pos = torch.where(idx < n_ctx[:, None], idx, torch.full_like(idx, -1))
    return q, kc, vc, ks, vs, q_pos.contiguous(), kv_pos.contiguous()


def check_attention(torch, timer, gen, *, S, T, probs, fp8, block_k, label,
                    q_starts, timed=True, window=1 << 30,
                    causal=True) -> dict:
    from repro_torch.kernels.flash_attention_quant import (
        flash_attention_quant, flash_attention_quant_plain)

    B, H, KV, D = 4, 28, 4, 128
    args = attention_inputs(torch, gen, B=B, S=S, T=T, H=H, KV=KV, D=D,
                            fp8=fp8, q_starts=q_starts)
    kw = dict(scale=D ** -0.5, causal=causal, block_k=block_k)
    if probs:
        kw.update(probs_n=64, probs_qmax=127.0, probs_qmin=-127.0)
    got = flash_attention_quant(*args, window, **kw)
    torch.cuda.synchronize()
    want = flash_attention_quant_plain(*args, window, **kw)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = diff.max().item()
    vmax = want.abs().max().item()
    finite = bool(torch.isfinite(got).all().item())
    if probs:
        # a probability sitting on a rounding boundary of the group QDQ
        # may flip one code (exp and the row sum differ in the last bits):
        # the reference's own boundary-tolerant bar
        tol = 5e-3 * vmax
        tight = (diff <= 2e-5 * vmax).float().mean().item()
        ok = finite and err <= tol and tight > 0.99
    else:
        tol = 2e-5 * vmax  # f32 products, sums in another order
        ok = finite and err <= tol
    row = {"shape": label, "S": S, "T": T, "probs_qdq": probs, "fp8": fp8,
           "max_abs_err": err, "tol": tol, "ok": ok}
    if timed:
        moved = nbytes(*args) + nbytes(got)
        row["bytes_ms"] = moved / PEAK_BYTES_PER_S * 1e3
        row["ops_ms"] = 4.0 * B * H * S * T * D / PEAK_F32_FLOPS * 1e3
        row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
        row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                           else "operations")
        row["ms"] = timer(
            lambda: flash_attention_quant(*args, window, **kw), iters=10)
        row["plain_ms"] = timer(
            lambda: flash_attention_quant_plain(*args, window, **kw),
            iters=3, warmup=1)
    log(f"  flash_attention_quant {label}: " + json.dumps(row))
    if not ok:
        raise SystemExit(f"flash_attention_quant disagrees with its plain "
                         f"version at {label}: max_abs_err={err} > {tol}")
    return row


def phase_kernels(torch, seed: int) -> dict:
    log("== kernels: each kernel vs its plain version, then timed")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    timer = Timer(torch)
    mm = []
    # main-path shapes: q/o, k/v, wi/wg, wo at decode (M = 4 slots) and at
    # a prefill tick (M = 4 x 64); lm_head sees the 4 last-token rows only
    for M in (4, 256):
        for name, K, N in (("q,o", 3584, 3584), ("k,v", 3584, 512),
                           ("wi,wg", 3584, 18944), ("wo", 18944, 3584)):
            mm.append(check_quant_matmul(
                torch, timer, gen, M=M, K=K, N=N, packed=True,
                label=f"{name} M={M} K={K} N={N} int4-packed"))
    mm.append(check_quant_matmul(
        torch, timer, gen, M=4, K=3584, N=152064, packed=True,
        label="lm_head M=4 K=3584 N=152064 int4-packed"))
    # off the main path: plain int8 codes (8-bit rules), ragged M and N
    check_quant_matmul(torch, timer, gen, M=4, K=3584, N=512, packed=False,
                       label="int8 codes M=4 K=3584 N=512", timed=False)
    check_quant_matmul(torch, timer, gen, M=13, K=640, N=77, packed=True,
                       label="ragged M=13 K=640 N=77 int4-packed",
                       timed=False)
    check_quant_matmul(torch, timer, gen, M=7, K=640, N=77, packed=False,
                       label="ragged M=7 K=640 N=77 int8", timed=False)
    torch.cuda.empty_cache()

    at = []
    # main path: the exact body with the in-kernel probs QDQ (int8, n = 64)
    at.append(check_attention(
        torch, timer, gen, S=1, T=512, probs=True, fp8=False, block_k=0,
        q_starts=[100, 510, 37, -1], label="decode S=1 T=512 int8 exact"))
    at.append(check_attention(
        torch, timer, gen, S=64, T=512, probs=True, fp8=False, block_k=0,
        q_starts=[0, 448, 128, -1], label="prefill S=64 T=512 int8 exact"))
    # off the main path: fp8 codes, no probs QDQ, and the two long bodies
    check_attention(torch, timer, gen, S=1, T=512, probs=True, fp8=True,
                    block_k=0, q_starts=[100, 510, 37, -1],
                    label="decode S=1 T=512 fp8 exact", timed=False)
    check_attention(torch, timer, gen, S=1, T=512, probs=False, fp8=False,
                    block_k=0, q_starts=[100, 510, 37, -1],
                    label="decode S=1 T=512 int8 exact no-qdq", timed=False)
    check_attention(torch, timer, gen, S=1, T=512, probs=True, fp8=False,
                    block_k=0, q_starts=[100, 510, 37, -1], window=100,
                    label="decode S=1 T=512 int8 exact window=100",
                    timed=False)
    check_attention(torch, timer, gen, S=5, T=512, probs=False, fp8=False,
                    block_k=0, q_starts=[100, 400, 37, -1], causal=False,
                    label="chunk S=5 T=512 int8 exact non-causal",
                    timed=False)
    check_attention(torch, timer, gen, S=1, T=4096, probs=False, fp8=False,
                    block_k=512, q_starts=[4000, 700, 37, -1],
                    label="decode S=1 T=4096 int8 online", timed=False)
    check_attention(torch, timer, gen, S=1, T=4096, probs=True, fp8=False,
                    block_k=512, q_starts=[4000, 700, 37, -1],
                    label="decode S=1 T=4096 int8 phased", timed=False)
    check_attention(torch, timer, gen, S=5, T=4096, probs=True, fp8=True,
                    block_k=512, q_starts=[4000, 700, 37, -1],
                    label="chunk S=5 T=4096 fp8 phased", timed=False)
    torch.cuda.empty_cache()
    return {"quant_matmul": mm, "flash_attention_quant": at}


# --------------------------------------------------------------------------
# phases: serve, identity
# --------------------------------------------------------------------------
def slice_policy(kernel_path: bool):
    """The slice's serving policy: w4a8_abfp; on the kernel path with
    ``fused`` on every entry and the compressed attention backend."""
    from repro_torch.core.policy import (map_policies, preset,
                                         with_attn_backend)

    pol = preset("w4a8_abfp")
    if kernel_path:
        pol = map_policies(pol, lambda p: p.replace(fused=True))
        return with_attn_backend(pol, "compressed")
    return with_attn_backend(pol, "ref")


def make_requests(cfg, seed: int):
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.RandomState(seed)
    lengths = [int(x) for x in rng.randint(32, 201, size=6)]
    return [Request(uid=uid,
                    prompt=rng.randint(0, cfg.vocab, size=n).astype(np.int32),
                    max_new_tokens=16)
            for uid, n in enumerate(lengths)]


def reset_counts() -> None:
    from repro_torch.kernels.flash_attention_quant import \
        flash_attention_quant
    from repro_torch.kernels.quant_matmul import quant_matmul

    quant_matmul.launches = 0
    flash_attention_quant.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels.flash_attention_quant import \
        flash_attention_quant
    from repro_torch.kernels.quant_matmul import quant_matmul

    return {"quant_matmul": quant_matmul.launches,
            "flash_attention_quant": flash_attention_quant.launches}


def build_engine(torch, cfg, seed: int, kernel_path: bool, trace=None,
                 perturb: bool = False):
    """Model with random weights from ``seed`` on the card -> engine with
    compressed weights and int8 pages; the dense tree is freed.  With a
    ``trace`` dict, the logits row behind every emitted token is kept on
    the card under its request's uid, in emission order.  ``perturb``
    scales the embedding table by 1 + 2**-20: RMSNorm undoes the scale up
    to rounding, so the model is the same function fed last-bit noise."""
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.serve.engine import PagedServeEngine

    class Engine(PagedServeEngine):
        def _step(self, tokens, n_valid, mask):
            # rows whose sample is kept: decoding rows, and prefilling
            # rows on the chunk that ends their prompt
            self._emitting = [
                (s, self.req[s].uid) for s in range(self.n_slots)
                if mask[s] and (self.active[s] or self._pf_pos[s]
                                + int(n_valid[s]) >= len(self.req[s].prompt))]
            t0 = time.perf_counter()
            out = super()._step(tokens, n_valid, mask)  # ends in a sync
            self.step_ms.append((tokens.shape[1],
                                 (time.perf_counter() - t0) * 1e3))
            return out

        def _sample(self, logits):
            if trace is not None:
                for s, uid in self._emitting:
                    trace.setdefault(uid, []).append(
                        logits[s, :cfg.vocab].clone())
            return super()._sample(logits)

    model = build_model(cfg)  # device="cuda" by default
    params = model.init(make_generator(seed, "cuda"))
    if perturb:
        params["embed"]["table"] *= 1.0 + 2.0 ** -20
    eng = Engine(model, params, n_slots=4, max_len=512, page_size=16,
                 policy=slice_policy(kernel_path), compress=True, kv="int8")
    eng.step_ms = []  # (tokens per row, wall ms) of every paged step
    del params
    torch.cuda.empty_cache()
    return eng


def check_completions(cfg, eng, done, reqs) -> None:
    if sorted(c.uid for c in done) != [r.uid for r in reqs]:
        raise SystemExit(f"not every request completed: "
                         f"{sorted(c.uid for c in done)}")
    for c in done:
        if len(c.tokens) != 16 or c.finished_reason != "length":
            raise SystemExit(f"request {c.uid}: {len(c.tokens)} tokens, "
                             f"reason {c.finished_reason}")
        if not all(0 <= t < cfg.vocab for t in c.tokens):
            raise SystemExit(f"request {c.uid}: token outside the vocab")
    st = eng.page_stats()
    if st["page_allocs"] != st["page_frees"] or st["pages_in_use"]:
        raise SystemExit(f"page accounting does not balance: {st}")


def phase_serve(torch, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models.serving_transforms import weight_bytes_summary

    log("== serve: qwen2-7b, full width and depth, kernel path")
    cfg = get_config("qwen2-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(torch, cfg, seed, kernel_path=True)
    torch.cuda.synchronize()
    log(f"  model built and compressed in {time.perf_counter() - t0:.1f} s: "
        + json.dumps(weight_bytes_summary(eng.weight_bytes)))
    reqs = make_requests(cfg, seed)
    for r in reqs:
        eng.submit(r)
    reset_counts()
    kv_bytes = None
    t0 = time.perf_counter()
    while eng._has_work():
        eng.tick()
        if kv_bytes is None:
            kv_bytes = eng.kv_bytes()  # at the first tick's occupancy
        if eng.ticks > 2000:
            raise SystemExit("serve phase did not drain in 2000 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    done = eng.done
    check_completions(cfg, eng, done, reqs)
    # every step runs 7 matmuls per layer + lm_head, and one attention
    # call per layer, through the kernels — no site took another road
    per_step = {"quant_matmul": 7 * cfg.n_layers + 1,
                "flash_attention_quant": cfg.n_layers}
    for name, n in per_step.items():
        if counts[name] != n * eng.steps or counts[name] == 0:
            raise SystemExit(
                f"{name}: {counts[name]} launches in {eng.steps} steps, "
                f"expected {n} per step")
    n_tok = sum(len(c.tokens) for c in done)
    by_kind = {"decode": [ms for s, ms in eng.step_ms if s == 1],
               "prefill": [ms for s, ms in eng.step_ms if s > 1]}
    report = {
        "requests": len(done), "prompt_lens": [len(r.prompt) for r in reqs],
        "generated_tokens": n_tok, "ticks": eng.ticks, "steps": eng.steps,
        "wall_s": wall, "tokens_per_s": n_tok / wall,
        "step_ms_median": {k: statistics.median(v)
                           for k, v in by_kind.items() if v},
        "step_counts": {k: len(v) for k, v in by_kind.items()},
        "launches": counts, "launches_per_step": per_step,
        "page_stats": eng.page_stats(), "kv_bytes_first_tick": kv_bytes,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    log("  " + json.dumps(report))
    report["profile"] = profile_decode(
        torch, cfg, eng, seed, report["step_ms_median"]["decode"])
    return report


def profile_decode(torch, cfg, eng, seed: int, step_ms: float) -> dict:
    """Where a decode step's time goes: a few steady decode steps of the
    engine under ``torch.profiler`` (after the counted run; its launches
    are not part of the reported counts)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for r in make_requests(cfg, seed + 1)[:4]:
        eng.submit(r)
    while eng.prefilling.any() or eng.queue or not eng.active.any():
        eng.tick()  # prompts in, every slot decoding
    n_steps = 4
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            eng._decode_tick()
        torch.cuda.synchronize()
    eng.run_until_done(max_ticks=2000)
    events = prof.key_averages()
    # kernel rows only: an operator row repeats its kernels' device time
    dev = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                  for e in events
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0), key=lambda d: -d[1])
    busy_ms = sum(d[1] for d in dev) / n_steps
    out = {"decode_steps_profiled": n_steps,
           "aten_ops_per_step": sum(
               e.count for e in events
               if e.key.startswith("aten::")) / n_steps,
           "decode_step_ms_unprofiled": step_ms}
    if busy_ms <= 0:
        out["device_time"] = "not measured (the profiler saw no device time)"
    else:
        out["device_busy_ms_per_step"] = busy_ms
        out["device_kernel_launches_per_step"] = sum(
            d[2] for d in dev) / n_steps
        # against the step time measured WITHOUT the profiler, whose own
        # cost stretches the host side of the profiled window
        out["device_idle_share"] = max(0.0, 1.0 - busy_ms / step_ms)
        out["top_device_kernels_ms_per_step"] = [
            {"name": k[:60], "ms": ms / n_steps, "launches": c / n_steps}
            for k, ms, c in dev[:8]]
    log("  profile: " + json.dumps(out))
    return out


def phase_reduced(torch, seed: int) -> dict:
    """Kernel path on the card vs plain path on the CPU, reduced config.

    The CPU side is the arithmetic the CPU tests hold token-identical to
    the JAX reference, so this ties the kernels in situ (other head_dim,
    group and GQA shapes than the full model's) to that reference.  At
    this size the quantizer chains are short and the vocabulary small, so
    tokens are expected to be identical; the card and the CPU still sum in
    other orders, so ONE request of six may turn at a near-tie before the
    phase fails."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import (map_policies, preset,
                                         with_attn_backend)
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.serve.engine import PagedServeEngine, Request

    log("== reduced: kernel path on the card vs plain path on the CPU")

    def to_device(tree, dev):
        if isinstance(tree, torch.Tensor):
            return tree.to(dev)
        if isinstance(tree, dict):
            return {k: to_device(v, dev) for k, v in tree.items()}
        return [to_device(v, dev) for v in tree]

    cfg = get_config("qwen2-7b").reduced()
    models = {"cpu": build_model(cfg, device="cpu"), "cuda": build_model(cfg)}
    params = models["cpu"].init(make_generator(seed, "cpu"))
    rows = []
    for n, kv in ((64, "int8"), (64, "fp8"), (32, "int8")):
        pol = map_policies(preset("w4a8_abfp", n=n),
                           lambda p: p.replace(fused=True))
        pol = with_attn_backend(pol, "compressed")
        tokens = {}
        reset_counts()
        for dev, model in models.items():
            eng = PagedServeEngine(
                model, to_device(params, dev), n_slots=3, max_len=96,
                policy=pol, page_size=8, kv=kv, compress=True, device=dev)
            rng = np.random.RandomState(seed + 3)
            for uid, size in enumerate((5, 11, 3, 70, 8, 2)):
                eng.submit(Request(
                    uid=uid, max_new_tokens=6,
                    prompt=rng.randint(0, cfg.vocab, size).astype(np.int32)))
            tokens[dev] = {c.uid: c.tokens for c in eng.run_until_done()}
        counts = read_counts()
        turned = [u for u in tokens["cpu"]
                  if tokens["cpu"][u] != tokens["cuda"][u]]
        row = {"group": n, "kv": kv, "requests_equal": 6 - len(turned),
               "requests": 6, "launches": counts}
        rows.append(row)
        log("  " + json.dumps(row))
        if min(counts.values()) == 0:
            raise SystemExit(f"reduced: a kernel was not launched: {counts}")
        if len(turned) > 1:
            raise SystemExit(
                f"reduced (group {n}, {kv} pages): requests {turned} differ "
                f"between the card and the CPU: {tokens}")
    return {"configs": rows}


def clone_state(state):
    """A deep copy of a paged DecodeState (the pools are updated in place)."""
    caches = [type(c)(*(None if t is None else t.clone() for t in c))
              for c in state.pages.cache]
    return state._replace(
        position=state.position.clone(),
        pages=state.pages._replace(cache=caches,
                                   table=state.pages.table.clone()))


def logit_gap(torch, a, b) -> float:
    """Largest logit difference of two rows in units of the row's std."""
    return ((a - b).abs().max() / b.std()).item()


def single_step_check(torch, cfg, eng_k, eng_p, seed: int) -> dict:
    """One prefill chunk from empty pools, then one decode step from a
    COPY of the same pools, through both paths on identical inputs."""
    model = eng_k.model
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 1)
    geo = eng_k.geometry
    table = torch.full((4, geo.max_pages_per_seq), -1, dtype=torch.int32,
                       device="cuda")
    for row in range(3):  # row 3 stays unmapped: a dead slot
        table[row, :8] = torch.arange(8 * row, 8 * row + 8)

    def fresh():
        st = model.init_paged_state(
            4, page_size=geo.page_size, n_pages=geo.n_pages,
            max_pages_per_seq=geo.max_pages_per_seq, kv="int8")
        return st._replace(pages=st.pages._replace(table=table))

    tokens = torch.randint(0, cfg.vocab, (4, geo.prefill_chunk),
                           generator=gen, device="cuda", dtype=torch.int32)
    n_valid = torch.tensor([64, 35, 1, 0], dtype=torch.int32, device="cuda")
    lk, _ = model.paged_step(eng_k.params, tokens, fresh(), n_valid=n_valid,
                             policy=eng_k.policy)
    lp, state = model.paged_step(eng_p.params, tokens, fresh(),
                                 n_valid=n_valid, policy=eng_p.policy)
    prefill = max(logit_gap(torch, lk[r, :cfg.vocab], lp[r, :cfg.vocab])
                  for r in range(3))
    nxt = torch.argmax(lp[:, :cfg.vocab], dim=-1).to(torch.int32)[:, None]
    one = torch.tensor([1, 1, 1, 0], dtype=torch.int32, device="cuda")
    dk, _ = model.paged_step(eng_k.params, nxt, clone_state(state),
                             n_valid=one, policy=eng_k.policy)
    dp, _ = model.paged_step(eng_p.params, nxt, clone_state(state),
                             n_valid=one, policy=eng_p.policy)
    decode = max(logit_gap(torch, dk[r, :cfg.vocab], dp[r, :cfg.vocab])
                 for r in range(3))
    return {"prefill_chunk_logit_gap_over_std": prefill,
            "decode_step_logit_gap_over_std": decode}


def compare_runs(torch, tok_a, log_a, tok_b, log_b) -> dict:
    """Token agreement of two runs, and the largest logit gap over the
    steps at which both saw the same inputs (up to and at a request's
    first differing token)."""
    worst = 0.0
    divergences = []
    for uid in sorted(tok_b):
        first = next((j for j, (a, b) in
                      enumerate(zip(tok_a[uid], tok_b[uid])) if a != b), None)
        last = len(tok_b[uid]) if first is None else first + 1
        for j in range(last):
            worst = max(worst, logit_gap(torch, log_a[uid][j],
                                         log_b[uid][j]))
        if first is None:
            continue
        la, lb = log_a[uid][first], log_b[uid][first]
        top = torch.topk(lb, 2).values
        divergences.append({
            "uid": uid, "token_index": first,
            "tokens": [tok_a[uid][first], tok_b[uid][first]],
            "top2_margin_over_std": ((top[0] - top[1]) / lb.std()).item(),
            "logit_gap_over_std": logit_gap(torch, la, lb)})
    return {
        "tokens_equal": sum(a == b for uid in tok_b
                            for a, b in zip(tok_a[uid], tok_b[uid])),
        "tokens_total": sum(len(t) for t in tok_b.values()),
        "max_logit_gap_over_std": worst, "divergences": divergences}


# Tolerance of the identity phase, in units of a logits row's standard
# deviation, and its reason.  The two paths add the same f32 terms in other
# orders, so they differ in the last bits.  A last-bit difference can move
# an activation across a rounding boundary of its int8 grid; a quantizer
# turns a perturbation of d code steps into a flip of a whole step with
# probability d, i.e. noise of sqrt(d) steps, and a 2-layer step chains
# about a dozen quantizers, so the noise saturates near the quantization
# noise itself within one step: runs that differ in the last bits anywhere
# end up a few hundredths to a tenth of a std apart and turn tokens whose
# top-2 margin is below that drift.  The control measures this on the card:
# the non-kernel path against itself with its embedding table scaled by
# 1 + 2**-20.  The kernel path may be at most GAP_FACTOR times as far from
# the non-kernel path as that control is over its whole run, and at most
# GAP_MAX in absolute terms; a wrong mask, scale or code would show as O(1).
# (The strict comparison of each kernel with its plain version, at 1e-5, is
# the kernels phase.)
GAP_FACTOR = 3.0
GAP_MAX = 0.3


def phase_identity(torch, seed: int) -> dict:
    from repro_torch.configs import get_config

    log("== identity: full width, 2 layers, kernel vs non-kernel path")
    cfg = get_config("qwen2-7b").replace(n_layers=2)
    runs = {}
    engines = {}
    for name, kernel_path, perturb in (("kernel", True, False),
                                       ("plain", False, False),
                                       ("control", False, True)):
        trace = {}
        eng = build_engine(torch, cfg, seed, kernel_path, trace, perturb)
        reqs = make_requests(cfg, seed)
        for r in reqs:
            eng.submit(r)
        reset_counts()
        done = eng.run_until_done(max_ticks=2000)
        check_completions(cfg, eng, done, reqs)
        counts = read_counts()
        if kernel_path != (counts["quant_matmul"] > 0) or \
                kernel_path != (counts["flash_attention_quant"] > 0):
            raise SystemExit(f"{name}: kernel_path={kernel_path} but launch "
                             f"counts are {counts}")
        runs[name] = ({c.uid: c.tokens for c in done}, trace)
        engines[name] = eng
    step = single_step_check(torch, cfg, engines["kernel"],
                             engines["plain"], seed)
    step_control = single_step_check(torch, cfg, engines["control"],
                                     engines["plain"], seed)
    engines.clear()
    torch.cuda.empty_cache()
    vs_plain = compare_runs(torch, *runs["kernel"], *runs["plain"])
    control = compare_runs(torch, *runs["control"], *runs["plain"])
    limit = min(GAP_MAX, GAP_FACTOR * control["max_logit_gap_over_std"])
    report = {"single_step": step, "single_step_control": step_control,
              "kernel_vs_plain": vs_plain, "control_vs_plain": control,
              "logit_gap_limit": limit,
              "tokens_identical": not vs_plain["divergences"]}
    log("  " + json.dumps(report))
    gaps = dict(step, whole_run=vs_plain["max_logit_gap_over_std"])
    for key, gap in gaps.items():
        if not gap <= limit:
            raise SystemExit(
                f"identity: {key} logit gap {gap} std exceeds {limit}: the "
                "kernel path is further from the non-kernel path than "
                "last-bit noise puts that path from itself (control: "
                f"{control['max_logit_gap_over_std']})")
    for d in vs_plain["divergences"]:
        # a token can only turn where the margin is inside the drift
        if not d["top2_margin_over_std"] <= 2 * d["logit_gap_over_std"]:
            raise SystemExit(f"identity: divergence away from a near-tie: "
                             f"{d}")
    if vs_plain["divergences"]:
        log(f"  tokens differ at {len(vs_plain['divergences'])} near-ties "
            f"(control: {len(control['divergences'])}); logit drift "
            f"{gaps['whole_run']:.3g} std, {limit:.3g} allowed")
    return report


# --------------------------------------------------------------------------
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of: " + ", ".join(PHASES)
                    + " (device and build always run)")
    args = ap.parse_args()
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        ap.error(f"unknown phase(s) {unknown}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 1

    from repro_torch.kernels import build

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    nvcc = subprocess.run([build.find_nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    log("== device: " + smi)
    log(f"  python {sys.version.split()[0]}  torch {torch.__version__}  "
        f"cuda {torch.version.cuda}  nvcc "
        f"{nvcc.strip().splitlines()[-2].strip()}")

    log("== build: one nvcc per kernel source, started together")
    t0 = time.perf_counter()
    logs = build.build_all(extra_flags=("-Xptxas", "-v"))
    for name, text in logs.items():
        used = [ln.strip() for ln in text.splitlines() if "Used" in ln]
        log(f"  {name}: {build.library_path(name).name}; "
            + (" | ".join(used) if used else "already built"))
    log(f"  built in {time.perf_counter() - t0:.1f} s")

    kernel_rows = serve = None
    if "kernels" in phases:
        kernel_rows = phase_kernels(torch, args.seed)
    if "serve" in phases:
        serve = phase_serve(torch, args.seed)
    if "reduced" in phases:
        phase_reduced(torch, args.seed)
    if "identity" in phases:
        phase_identity(torch, args.seed)

    replaces = {
        "quant_matmul": "src/repro/kernels/quant_matmul.py:226",
        "flash_attention_quant":
            "src/repro/kernels/flash_attention_quant.py:223",
    }
    kernels = []
    for name in ("quant_matmul", "flash_attention_quant"):
        rows = (kernel_rows or {}).get(name, [])
        head = rows[0] if rows else {}  # the decode shape launched most
        if name == "quant_matmul" and rows:
            head = next(r for r in rows if r["shape"].startswith("wi,wg M=4"))
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{build.SOURCES[name]}",
            "replaces": replaces[name],
            "launches": serve["launches"][name] if serve else 0,
            "max_abs_err": max((r["max_abs_err"] for r in rows),
                               default=None),
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            "library_ms": None,  # no single PyTorch call computes either
            "timed_shape": head.get("shape"),
            "shapes": rows,
        })
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
