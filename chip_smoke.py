#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card, ``nvcc`` and nothing else: it builds the CUDA
kernels from the sources in this checkout, holds each against its plain
PyTorch version on the card at the shapes the serving paths give it, then
serves requests with qwen2-7b at its published width and depth (random
weights from ``--seed``) through ``PagedServeEngine`` (compressed weights,
int8 pages) and through the fixed-slot ``ServeEngine`` (dense f32 weights),
and shows that each run went through its kernels.  Without a card it exits
non-zero and prints no result.

Phases (each fatal on failure):
  device    card name / power limit, torch / CUDA / nvcc versions
  build     one nvcc per kernel source, all started together
  kernels   kernel vs plain version, then timed (CUDA events, L2 flushed
            between launches, median) beside the plain version, the card's
            bound for the same work and, where one PyTorch call computes
            the same function, that call; for the three matmuls also the
            kernels each M launches (profiler) and the summed forward
            passes; quant_matmul's one-launch decode kernel at M = 1-16
            and its two-launch contract_kernel (up to 4 rows of a wide
            layer) at ragged N, one-group splits and padded groups, timed
            at M = 4 and 16 beside one PyTorch read of the same code bytes,
            and at M = 4 in situ (distinct weights back to back: each
            main-path shape and the decode pass under either route, the
            one-launch kernel at 1-32 K splits); the tensor-core
            contraction (int8, packed int4 and bf16 codes) at ragged
            shapes and every group length that divides K (codes
            zero-padded off the 16 grid); abfp_matmul on
            the bf16 tensor cores bit-equal to abfp_matmul_int8 for int
            formats; flash_attention_quant at each checked shape with the
            kernel it launches read from the profiler
            (attention_decode_kernel on the exact body at 1 position
            up to T = 2048, attention_decode_long_kernel on every other
            call at 1 position: the long path's decode call at T = 8192,
            exact, online and phased, up to T = 32,768;
            attention_prefill_kernel on the exact body from 2 positions
            up to T = 512, attention_long_kernel on every other call from
            2 positions: the long chunk at T = 1024-8192, exact, online
            and phased), the decode, decode-long, prefill and long
            kernels timed beside attention_kernel forced onto the same
            call (prefill and long also beside SDPA: a
            yardstick, not the same function; long also with pass 2
            forming the scores again, held bit-equal, and the bytes of
            the scores it stores), and
            three kernels at S = 1, two of them at S = 2-64 (T = 512);
            flash_attention at the fixed prefill's buckets (timed beside
            SDPA, a yardstick) and ragged, suffix, non-causal, reduced and
            odd head dimensions, the kernel it launches read from the
            profiler (flash_mma_kernel, the only route of plan_flash);
            abfp_qdq bit-exact in every format at n = 16-128 in f32, bf16
            and f16, a base 4 bytes off the 16-byte grid, the edge cases
            of qdq_extremes and groups too long for a set's registers
            (the kernel plan_qdq names read from the profiler), timed at
            M = 256, a whole wi weight and abfp_matmul's pre-pass shapes
            beside y.copy_(x) on the same bytes
  lint      qlint's QL303 against the kernels' own plans on the card:
            abfp_matmul at n = 1,200 / 1,216 and abfp_matmul_int8 at n =
            1,440 / 1,456 (M = 256, K = 4n, N = 4,096), each linted as a
            fused w4a8 site first: where the lint is clean the kernel
            launches (counted) and matches its plain version (timed beside
            it and its bound), where QL303 fires the wrapper raises the
            same text before any launch; launch/serve --arch qwen2-7b
            --full --paged --n-pages 1 exits 2 on QL305 with nothing
            allocated on the card; the --all sweep's summary
  serve     paged, full width, full depth: 6 greedy requests; launch counts
            per step asserted (197 quant_matmul + 28 flash_attention_quant:
            attention_prefill_kernel on chunk steps,
            attention_decode_kernel on decode steps, attention_kernel,
            attention_long_kernel and attention_decode_long_kernel on
            none); profiles of decode steps and
            of prefill steps (M = 256)
  long      paged, full width, 14 of 28 layers, max_len 8192 (T = 8192 in
            every attention call): 4 greedy requests of 6000 / 4100 / 2500
            / 1100 prompt tokens, 8 new tokens each; asserted per step: 99
            quant_matmul + 14 flash_attention_quant launches,
            attention_long_kernel on every chunk step,
            attention_decode_long_kernel on every decode step (S = 1 past
            the decode kernel), attention_kernel on none, neither exact
            kernel; one long chunk step (a row past 4,000 keys) and one
            decode step replayed from a copy of their state, timed,
            profiled (attention and device-busy ms) and their peak memory
            read
  fixed     fixed-slot, full width, 14 of 28 layers, dense f32 weights:
            the same 6 requests under P-int8 (abfp_matmul_int8 +
            flash_attention) and P-fp (abfp_matmul + flash_attention); 99
            matmul launches per forward pass and 14 flash_attention
            launches per prefill (all of flash_mma_kernel) asserted, and
            P-fp's x pre-pass: qdq_stream_kernel before every abfp_matmul
            call of up to 16 rows (counted; 99 a decode tick in the
            profile, none for P-int8); profiles of decode ticks and of one
            192-row prefill (14 flash_mma_kernel launches and no
            flash_kernel, read from the profiler)
  reduced   reduced width: the kernel path on the card must emit the tokens
            of the plain path on the CPU (the path the CPU tests hold
            token-identical to the JAX reference), paged and fixed-slot,
            for qwen2-7b, gemma2-9b, granite-3-8b, h2o-danube-1.8b,
            phi3.5-moe-42b-a6.6b and llama4-scout-17b-a16e; speculative
            qwen2-7b (fixed and paged, against the CPU and the card's
            target-only tokens) and phi3.5-moe's expert store (2 cached,
            against the CPU and, exactly, the card's storeless run)
  identity  full width, 2 layers: the paged kernel path against the
            non-kernel path (fused=False, attn_backend="ref"), with a
            last-bit-noise control run as the yardstick
  spec      qwen2-7b at full width and depth, random weights: speculative
            serving, the fused w8a8_abfp target on the dense f32 tree
            verifying what the w4a8_abfp draft compressed from it
            proposes; the verify pass's new shapes held to their plain
            versions and timed (abfp_matmul at M = 20 and 16 on the
            layers, w8a8; flash_attention_quant at S = 5 over 512 int8
            keys); fixed-slot (int8 ring, compressed attention) at k = 4
            on serve's six requests (197 quant_matmul + 28
            attention_decode_kernel a draft step, 197 abfp_matmul + 28
            attention_prefill_kernel a verify pass, attention_kernel
            none), its first two verify passes held to the target's
            sequential decode steps (identity's bar, from a last-bit
            control), every emitted token the verify argmax, the seeded
            sampler twice alike, a profiled round; k = 3 on two requests
            (16 rows: decode kernels and their x pre-pass); paged over fp
            pages (attention plain), both pools drained; tokens/s, round
            ms, tokens a target step, the tokens shared with a target-only
            run
  ptq       opt-125m at full width and depth: its fused path's kernels held
            to their plain versions and timed at its shapes (both dense
            matmuls at M = 512 up to the 50432-column tied head,
            flash_mma_kernel at D = 64 with one query head a KV head); the
            methods table's five PTQ
            recipes (calibration, SmoothQuant, GPTQ, RPTQ, static MSE) at
            w4a8_mse on the card, their losses and calibration counts; the
            fp32 weights evaluated under P-fp and P-int8 (73 dense matmuls
            and 12 flash_mma_kernel a forward, read from the profiler),
            their logits held to the ref backend's within GAP_FACTOR times
            a last-bit control (and apart from the fp32 weights with no
            QDQ); GPTQ and mse_alpha on the card held
            to the same code on the CPU (ties counted); the launcher's
            ``--recipe sq_gptq_w4a8`` serving a few requests
  vit       vit-b16 (and deit-s16) at full width and depth, random weights,
            224 x 224 synthetic images: the encoder's kernels held to their
            plain versions and timed at its shapes (both dense matmuls at
            M = 197 x 64 and the head at M = 64 and 16, flash_mma_kernel
            non-causal at S = T = 197 beside SDPA); the vision table's five
            policies through the QDQ-sim; fused P-fp (w4a4_abfp, w4a8_abfp,
            w4a4_e2m1) and P-int8 forwards of 64 images held to the ref
            backend (logit gap within GAP_FACTOR times a last-bit control,
            apart from fp32 with no QDQ), 74 dense matmuls and 12
            flash_mma_kernel a forward asserted from the counts and the
            profiler, the head of a 16-image forward in the decode regime;
            wall ms, images/s, device busy ms and idle share of a forward;
            PTQ over the encoder (a w4a8_mse calibration, static_mse at
            w4a4_mse, smoothquant+gptq+static_mse): seconds, Hessian bytes,
            dropped sites, peak memory
  ssm       mamba2-130m at published width and depth, zamba2-7b at
            published width and 27 of its 81 layers, random weights: the kernels at their shapes (ragged N = 3,352 and
            14,576, K up to 14,336; abfp_qdq at the pre-pass shapes and the
            ViT's 16-image head); mamba2-130m served by the fixed-slot
            engine (4 slots, max_len 2048, prompts of 41-1,500 tokens,
            exact-length prefills) under P-fp, P-int8 and P-C, every
            prefill's and tick's launches asserted (49 a forward; P-C 48
            quant_matmul + 1 abfp_matmul) and read by role from the
            profiler, device busy ms / idle split into the SSD scan, the
            conv and the kernels; zamba2-7b through Model under P-fp (a
            loss, a 300-token prefill, 16 decode steps; every forward's
            launches asserted) and P-C raising the reference's ValueError; fused
            logits and every block held to the ref backend against a
            reordered-sum control; prefill + decode against a longer
            prefill at full width; the reduced mamba2 on the card against
            the CPU
  encdec    whisper-large-v3 (8 of its 32 + 32 layers) and internvl2-2b
            (all 24) at published width, random weights, stub inputs from numpy: the kernels at the new
            shapes (flash_attention over 1,500 non-causal keys at G = 1,
            D = 64 and causal at G = 2, D = 128; both dense matmuls at M =
            6,000 and the heads at N = 51,968 / 92,672; quant_matmul at
            Whisper's shapes and InternVL2's step; flash_attention_quant's
            decode kernel at G = 1, D = 64, T = 448 and G = 2, D = 128, T =
            1,024); through Model under P-fp, P-int8 (Whisper) and P-C
            (compressed weights, an int8 ring, the compressed backend): a
            teacher-forced loss (4 x 448 tokens over 4 x 1,500 frames; 4 x
            (256 patches + 512 tokens)), a prefill (4 tokens into 448; 256
            patches + 64 tokens into 1,024) and greedy steps (64; 32),
            every pass's launches asserted by wrapper, by attention kernel
            and for the x pre-pass, a step's kernels by role from the
            profiler; wall ms of the encode, the loss, the prefill and the
            median step, busy ms, idle share and top device operations of
            a step (and under P-fp of the other three), tokens/s, peak
            memory, the cross K/V state's bytes; every
            block held to the ref backend against a reordered-sum control
            (the logits too where that control lies below no QDQ); the
            reduced configs on the card emit the CPU's greedy tokens
  dense_archs gemma2-9b, granite-3-8b and h2o-danube-1.8b at published
            width (gemma2 at 10 of 42 layers, granite at 10 of 40, danube
            at 12 of 24), random weights, one at a time: the kernels at
            the new shapes (flash_attention at D = 80, G = 4 and G = 5
            beside SDPA; flash_attention_quant at D = 80 over 8,192 keys
            with the window of 4,096 inside both long kernels, and at G =
            4; abfp_matmul at the 256,000-wide tied head; K = 12,800);
            gemma2 paged P-C (its softcap keeps attention on the plain
            path: no attention kernel), fixed P-fp and a loss on (2, 512)
            through the chunked tied head; granite paged P-C and fixed
            P-int8; danube fixed P-fp and paged P-C at max_len 8,192 on
            the long phase's prompts; every forward's launches asserted by
            wrapper, attention kernel and x pre-pass; tokens/s, step ms,
            busy ms, idle share and peak memory; logits and every block
            held to the ref backend against a reordered-sum control on 512
            tokens, and the median block on their first 128
  moe       phi3.5-moe-42b-a6.6b at full width, 8 of 32 layers: fixed P-fp
            (the expert stacks QDQ'd every forward), paged P-C (ExpertBank
            int4 codes decompressed every step), the same with the expert
            store (4 experts a layer cached and refreshed into the params:
            tokens equal, stats, bytes, step ms) and --expert-precision
            auto (4 hot experts INT8, 12 INT4), a loss with its aux term,
            expert_loads; llama4-scout-17b-a16e at full width, 4 of 48
            layers: a loss on (2, 256), a (2, 64) prefill and 16 greedy
            steps under P-fp (flash_mma_kernel at G = 5); launches, times
            and numerics as in dense_archs
  train     opt-125m at full width and depth through launch/train's
            make_everything + run, through its pre-flight gate (counted),
            as the ptq phase's launcher run: 20 QAT steps under w4a8_abfp at 16 x
            512 (checkpoints every 10), loss falling, every leaf moved; ms
            a step, tokens/s, peak memory, two profiled steps (busy, idle,
            launches); two runs from one state without deterministic
            algorithms, bit-equal or not; a run stopped after step 10 and restarted
            to 20, bit-equal to the uninterrupted one; the QAT'd weights
            evaluated under fused P-fp and P-int8 (73 dense matmuls and
            12 flash_mma_kernel a forward asserted, logits held to the ref
            backend as in ptq), their kernels at M = 4096 held to their
            plain versions and timed; h2o-danube-1.8b at full width and
            depth, 3 QAT steps at 8 x 512 under remat dots and full (step
            1's loss bit-equal, ms a step, peak memory); opt-125m fp32 2
            microbatches against 1: the loss at the reference's bar, the
            gradients held to a reordered and a nudged full-batch control
            that a planted dropped microbatch must fail
  dist      a world of one over NCCL (a FileStore, no port), meshes
            ("data", "model") and ("pod", "data") = (1, 1): (a) opt-125m at
            full width and depth laid out by shardings_from_axes as
            DTensors, one w4a8_abfp QAT step under use_rules: loss,
            gradients and updated parameters bit-equal to the unsharded
            step (else where they first differ, held to a one-ulp
            embedding control); no kernel launch; (b) saved and restored
            onto the mesh by shardings_for_restore (bit-equal, the report
            printed), then full_tensor() and one fused P-fp forward: 73
            abfp_matmul + 12 flash_attention launches asserted, logits
            bit-equal to the unrestored forward's; (c) compressed_psum_pod
            on (a)'s gradients bit-equal to its plain version, timed; (d)
            a DTensor handed to quant_matmul and flash_attention_quant
            raises TypeError with 0 launches; (e) qwen2-7b's full-width
            restore plans on the (16, 16) and (2, 16, 16) mesh shapes
            (host only, dense and compressed), printed

The last lines of standard output are: one JSON object {"kernels": [...]},
the card's name and power limit, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
from repro_torch.launch.mesh import HBM_BW as PEAK_BYTES_PER_S
from repro_torch.launch.mesh import (PEAK_BF16_FLOPS, PEAK_F32_FLOPS,
                                     PEAK_INT8_OPS, PEAK_TF32_FLOPS)

PHASES = ("kernels", "lint", "serve", "long", "fixed", "reduced", "identity", "spec",
          "ptq", "vit", "ssm", "encdec", "dense_archs", "moe", "train", "dist")

# every kernel: (wrapper module, TPU kernel it replaces)
KERNELS = {
    "quant_matmul": ("quant_matmul",
                     "src/repro/kernels/quant_matmul.py:226"),
    "flash_attention_quant": ("flash_attention_quant",
                              "src/repro/kernels/flash_attention_quant.py:223"),
    "abfp_matmul": ("quant_matmul", "src/repro/kernels/quant_matmul.py:156"),
    "abfp_matmul_int8": ("quant_matmul",
                         "src/repro/kernels/quant_matmul.py:171"),
    "abfp_qdq": ("abfp_qdq", "src/repro/kernels/abfp_qdq.py:52"),
    "flash_attention": ("flash_attention",
                        "src/repro/kernels/flash_attention.py:87"),
}


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
    (197 different weights stream through between two uses of one).

    By default the card is kept busy (``torch.cuda._sleep``, about a
    millisecond) while the host enqueues the events and the call, so the
    time is the device's alone.  ``with_enqueue=True`` leaves the card idle
    meanwhile: a call shorter than its own enqueue then reads as the
    host's time to enqueue it."""

    SLEEP_CYCLES = 2_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, iters: int, warmup: int = 2,
                 with_enqueue: bool = False) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            if not with_enqueue:
                torch.cuda._sleep(self.SLEEP_CYCLES)
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
def bound_fields(moved_bytes: float, ops: float, peak_ops: float,
                 *more: tuple) -> dict:
    """The least time the card could take: the larger of the bytes moved
    once over the memory rate and the operations over their peak rate
    (``more``: further (operations, peak rate) terms, added)."""
    row = {"bytes_ms": moved_bytes / PEAK_BYTES_PER_S * 1e3,
           "ops_ms": sum(n / peak for n, peak in ((ops, peak_ops), *more))
           * 1e3}
    row["bound_ms"] = max(row["bytes_ms"], row["ops_ms"])
    row["bound_by"] = ("bytes" if row["bytes_ms"] >= row["ops_ms"]
                       else "operations")
    return row


def check_quant_matmul(torch, timer, gen, *, M, K, N, packed, label,
                       n=64, timed=True, exact=False) -> dict:
    from repro_torch.core.formats import INT8
    from repro_torch.core.quantize import pack_int4_codes
    from repro_torch.kernels.quant_matmul import (quant_matmul,
                                                  quant_matmul_plain)

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
    # With K = n there is one group: (sum * sx) * sw on both sides, which
    # must be bit-exact and pins the kernel's int32 group sums.
    tol = 0.0 if exact else 1e-5 * ref
    ok = bool(torch.isfinite(got).all().item()) and err <= tol
    row = {"shape": label, "M": M, "K": K, "N": N, "n": n, "packed": packed,
           "max_abs_err": err, "tol": tol, "ok": ok}
    if timed:
        row.update(bound_fields(nbytes(x, codes, scales, got),
                                2.0 * M * N * K, PEAK_INT8_OPS))
        row["ms"] = timer(lambda: quant_matmul(x, codes, scales, INT8, n=n,
                                               packed=packed), iters=10)
        if M <= 16:
            # a yardstick, not the same function: one PyTorch pass that
            # reads the same code bytes once (a sum of them as f32 words)
            words = codes.reshape(-1).view(torch.float32)
            row["read_codes_ms"] = timer(lambda: words.sum(), iters=10)
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


# the kernels of flash_attention_quant, as the profiler names them
ATTENTION_KERNELS = {
    "attention_prefill_kernel": "attention_prefill_kernel",
    "attention_decode_kernel": "attention_decode_kernel",
    "attention_long_kernel": "attention_long_kernel",
    "attention_decode_long_kernel": "attention_decode_long_kernel",
    "attention_kernel": "attention_kernel"}


def attention_pairs(torch, q_pos, kv_pos, window: int, causal: bool):
    """(query, key) pairs of one head that the scores need (the mask keeps
    them) and that P.V needs (those, and every key of a row that keeps
    none: its uniform mean), summed over the batch."""
    qp, kp = q_pos[:, :, None], kv_pos[:, None, :]
    keep = (kp >= 0) & (kp > qp - window)
    if causal:
        keep = keep & (kp <= qp)
    seen = keep.sum(-1)
    return (int(seen.sum().item()),
            int(torch.where(seen > 0, seen, kv_pos.shape[1]).sum().item()))


def check_attention(torch, timer, gen, *, S, T, probs, fp8, block_k, label,
                    q_starts, want_kernel, timed=True, window=1 << 30,
                    causal=True, probs_n=64, H=28, KV=4, D=128,
                    profiled=True) -> dict:
    """One ``flash_attention_quant`` call against its plain version; the
    kernel it launches, read from the profiler, must be ``want_kernel``.
    Timed: beside the plain version, the card's bound for the pairs this
    call's mask keeps (scores as f32 multiply-adds, the plain version's
    chain; P.V as three bf16 products, what f32 accuracy needs on the
    tensor cores), ``attention_kernel`` forced onto the same call (where
    another kernel is planned) and, at S > 1, SDPA as a yardstick.
    ``attention_long_kernel`` is also called with the other score handling
    (pass 2 forming the scores again, or reading back stored ones), which
    must give the same bits; timed, with the bytes of the stored scores.
    ``H``, ``KV``, ``D``: the heads (qwen2-7b's by default) of 4 rows;
    ``profiled``: as ``kernel_launches`` reads the kernel."""
    from repro_torch.kernels import flash_attention_quant as faq

    B = len(q_starts)
    args = attention_inputs(torch, gen, B=B, S=S, T=T, H=H, KV=KV, D=D,
                            fp8=fp8, q_starts=q_starts)
    kw = dict(scale=D ** -0.5, causal=causal, block_k=block_k, probs_n=0,
              probs_qmax=0.0, probs_qmin=0.0)
    if probs:
        kw.update(probs_n=probs_n, probs_qmax=127.0, probs_qmin=-127.0)

    def call():
        return faq.flash_attention_quant(*args, window, **kw)

    got = call()
    torch.cuda.synchronize()
    want = faq.flash_attention_quant_plain(*args, window, **kw)
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
    launched = kernel_launches(torch, faq.flash_attention_quant, call,
                               ATTENTION_KERNELS, {want_kernel: 1}, label,
                               profiled)
    row = {"shape": label, "S": S, "T": T, "probs_qdq": probs, "fp8": fp8,
           "kernel": launched, "max_abs_err": err, "tol": tol, "ok": ok}
    if want_kernel == "attention_long_kernel":
        # the planned score handling (stored, or formed again in pass 2)
        # and the other one give the same bits
        plan = faq.plan_attention(B, S, T, H, KV, D, block_k or T,
                                  kw["probs_n"])
        other = (plan._replace(slots=0) if plan.slots else
                 faq.plan_attention_long(B, S, T, H, KV, D, kw["probs_n"],
                                         store=True))

        def call_other():
            return faq._flash_attention_quant(*args, window, plan=other,
                                              **kw)

        row["stored_equals_recomputed"] = torch.equal(call_other(), got)
    if probs:
        row["within_2e-5"] = tight
    if timed:
        score_pairs, pv_pairs = attention_pairs(torch, args[5], args[6],
                                                window, causal)
        score_ops, pv_ops = 2.0 * H * D * score_pairs, 2.0 * H * D * pv_pairs
        ops = score_ops + pv_ops
        moved = nbytes(*args) + nbytes(got)
        if S == 1:
            # one position a row: a key's K code row and k scale are
            # needed where it is seen, its V row and v scale where its
            # probability is not 0 (every key of a dead row)
            row["bytes_every_key_ms"] = moved / PEAK_BYTES_PER_S * 1e3
            moved = (nbytes(args[0], args[5], args[6], got)
                     + KV * (D + 4) * (score_pairs + pv_pairs))
        row.update(bound_fields(moved, score_ops, PEAK_F32_FLOPS,
                                (3 * pv_ops, PEAK_BF16_FLOPS)))
        # both products as f32 multiply-adds; every (query, key) pair so,
        # as the bound counted before the skip; both as three bf16
        # products each (split terms)
        row["ops_f32_ms"] = ops / PEAK_F32_FLOPS * 1e3
        row["ops_every_pair_ms"] = (4.0 * B * H * S * T * D
                                    / PEAK_F32_FLOPS * 1e3)
        row["ops_bf16_split_ms"] = 3 * ops / PEAK_BF16_FLOPS * 1e3
        row["ms"] = timer(call, iters=10)
        row["plain_ms"] = timer(
            lambda: faq.flash_attention_quant_plain(*args, window, **kw),
            iters=3, warmup=1)
        old = faq.plan_attention_kernel(B, S, H, KV, D, block_k or T)
        if want_kernel == "attention_kernel":
            pass
        elif old.smem_bytes > faq.SMEM_MAX:
            row["attention_kernel_ms"] = None
            row["attention_kernel_is"] = (
                "not measured: its score tile of the whole row exceeds "
                "shared memory")
        else:
            row["attention_kernel_ms"] = timer(
                lambda: faq._flash_attention_quant(*args, window, plan=old,
                                                   **kw), iters=10)
        if want_kernel == "attention_decode_kernel":
            # the long-context decode kernel forced onto the same call: is
            # a second kernel at S = 1 worth its keep here?
            dl = faq.plan_attention_decode_long(B, T, H, KV, D, block_k or T,
                                                kw["probs_n"])

            def call_dl():
                return faq._flash_attention_quant(*args, window, plan=dl,
                                                  **kw)

            d_dl = (call_dl() - want).abs()
            row["decode_long_max_abs_err"] = d_dl.max().item()
            row["decode_long_within_2e-5"] = (
                d_dl <= 2e-5 * vmax).float().mean().item()
            ok = ok and row["decode_long_max_abs_err"] <= tol and (
                not probs or row["decode_long_within_2e-5"] > 0.99)
            row["ok"] = ok
            row["decode_long_ms"] = timer(call_dl, iters=10)
        if want_kernel == "attention_long_kernel":
            row["scratch_bytes"] = faq.long_scratch_bytes(plan)
            row["recompute_ms" if plan.slots else "store_ms"] = timer(
                call_other, iters=10)
        if S > 1:
            # yardstick only, NOT the same function: SDPA, causal GQA f32
            # over K/V dequantized beforehand, no position masks beyond
            # causal, no probs QDQ
            sdpa = torch.nn.functional.scaled_dot_product_attention
            qf = args[0].transpose(1, 2).contiguous()
            kf, vf = ((c.to(torch.float32) * sc[..., None]).transpose(
                1, 2).contiguous() for c, sc in ((args[1], args[3]),
                                                 (args[2], args[4])))
            row["library_ms"] = timer(
                lambda: sdpa(qf, kf, vf, is_causal=True, enable_gqa=True),
                iters=10)
            row["library_is"] = ("SDPA causal GQA f32 over dequantized K/V, "
                                 "no probs QDQ: not the same function")
        else:
            row["library_ms"] = None
    log(f"  flash_attention_quant {label}: " + json.dumps(row))
    if not ok:
        raise SystemExit(f"flash_attention_quant disagrees with its plain "
                         f"version at {label}: max_abs_err={err}, tol {tol}"
                         + (f", {tight} within 2e-5" if probs else "")
                         + (f"; the decode-long kernel forced onto it: "
                            f"{row['decode_long_max_abs_err']}, "
                            f"{row['decode_long_within_2e-5']} within 2e-5"
                            if "decode_long_max_abs_err" in row else ""))
    if row.get("stored_equals_recomputed") is False:
        raise SystemExit(f"attention_long_kernel at {label}: stored and "
                         "recomputed scores give other bits")
    if launched != {want_kernel: 1}:
        raise SystemExit(f"flash_attention_quant at {label} launched "
                         f"{launched}, expected {want_kernel}")
    return row


def attention_route_sweep(torch, timer, gen) -> None:
    """The kernels of ``flash_attention_quant`` on the exact body at
    T = 512 (int8, probs QDQ) and S = 1-64 query positions (the decode
    kernel at S = 1 only): the times ``PREFILL_MIN_S`` and the decode
    route rest on, and each kernel's error against the plain version."""
    from repro_torch.kernels import flash_attention_quant as faq

    B, T, H, KV, D = 4, 512, 28, 4, 128
    kw = dict(scale=D ** -0.5, causal=True, block_k=0, probs_n=64,
              probs_qmax=127.0, probs_qmin=-127.0)
    out = {}
    for S in (1, 2, 3, 4, 5, 8, 16, 64):
        args = attention_inputs(torch, gen, B=B, S=S, T=T, H=H, KV=KV, D=D,
                                fp8=False, q_starts=[100, 448, 37, -1])
        plans = {"attention_kernel": faq.plan_attention_kernel(
                     B, S, H, KV, D, T),
                 "attention_prefill_kernel": faq.plan_attention_prefill(
                     B, S, T, H, KV, D)}
        if S == 1:
            plans["attention_decode_kernel"] = faq.plan_attention_decode(
                B, T, H, KV, D, 64)
        want = faq.flash_attention_quant_plain(*args, 1 << 30, **kw)
        errs = {}
        for k, pl in plans.items():
            got = faq._flash_attention_quant(*args, 1 << 30, plan=pl, **kw)
            errs[f"{k}_max_abs_err"] = (got - want).abs().max().item()
        out[f"S={S}"] = {
            "planned": faq.plan_attention(B, S, T, H, KV, D, T, 64).kernel,
            **errs,
            **{f"{k}_ms": timer(
                lambda: faq._flash_attention_quant(*args, 1 << 30, plan=pl,
                                                   **kw), iters=10)
               for k, pl in plans.items()}}
    log("  flash_attention_quant routes (exact body, T=512, int8, probs "
        "QDQ): " + json.dumps(out))


def activations(torch, gen, shape):
    """Activation-like f32 values: a normal with a few outlier channels and
    an all-zero row (its groups take the 1e-12 scale floor)."""
    x = torch.randn(shape, generator=gen, device="cuda")
    x[..., ::97] *= 8.0
    if x.ndim == 2 and x.shape[0] > 2:
        x[1] = 0.0
    return x


QDQ_KERNELS = {"qdq_stream_kernel": "qdq_stream_kernel",
               "qdq_rows_kernel": "qdq_rows_kernel"}


def qdq_extremes(fmt_name: str, n: int, dtype: str = "float32",
                 seed: int = 0):
    """Groups that pin the QDQ's edges, one kind a row of 4 groups of n
    (a (7, 4 n) f32 numpy array; ``dtype`` says what x will be converted
    to): zeros and -0; values under the 1e-12 scale floor; f32 subnormals;
    a max of 1 among subnormals, tiny normals and zeros; exact ties (the
    group max qmax 2^-3, so the scale is 2^-3 exactly, and every other
    value k + 0.5 steps of the format's grid); maxima near 3e38 (f16: near
    its 65504) among values spread over every exponent; activation-like
    values."""
    import numpy as np

    from repro_torch.core.formats import (IntFormat, get_format,
                                          representable_values)

    fmt = get_format(fmt_name)
    rng = np.random.RandomState(seed)
    shape = (4, n)

    def signs():
        return np.where(rng.rand(*shape) < 0.5, -1.0, 1.0)

    zeros = np.zeros(shape)
    zeros[:, ::3] = -0.0
    floor = rng.uniform(-1.0, 1.0, shape) * 1e-13
    subnormal = rng.uniform(-1.0, 1.0, shape) * 1e-39
    mixed = rng.randn(*shape) * 1e-2
    mixed[:, 1::4] = signs()[:, 1::4] * 1e-40
    mixed[:, 2::4] = signs()[:, 2::4] * 1e-30
    mixed[:, 3::8] = -0.0
    mixed[:, 7::8] = 0.0
    mixed[:, 0] = 1.0
    qmax = fmt.qmax_pos
    if isinstance(fmt, IntFormat):
        grid = np.arange(-qmax, qmax) + 0.5
    else:
        vals = representable_values(fmt)
        grid = (vals[:-1] + vals[1:]) / 2.0
    ties = rng.choice(grid, shape) * signs()
    ties[:, 0] = qmax
    ties *= 2.0 ** -3
    top = 6.0e4 if dtype == "float16" else 3.0e38
    low = -8.0 if dtype == "float16" else -45.0
    huge = signs() * 10.0 ** rng.uniform(low, np.log10(top), shape)
    huge[:, 0] = top
    act = rng.randn(*shape)
    act[:, ::13] *= 8.0
    rows = (zeros, floor, subnormal, mixed, ties, huge, act)
    return np.stack([r.reshape(-1) for r in rows]).astype(np.float32)


def qdq_operand(torch, x32, dtype, offset: int = 0):
    """``x32`` converted to ``dtype``, contiguous, its base ``offset``
    elements past the start of its allocation (which is 256-byte
    aligned)."""
    M, K = x32.shape
    buf = torch.zeros(M * K + offset, dtype=dtype, device="cuda")
    x = buf[offset:].view(M, K)
    x.copy_(x32)
    return x


def check_abfp_qdq(torch, timer, gen, *, M, K, n, fmt_name, label,
                   dtype="float32", offset=0, x32=None, timed=True,
                   profiled=True) -> dict:
    """``abfp_qdq`` at (M, K) in ``dtype`` (``x32``: f32 values on the
    card, else activation-like ones) with its base ``offset`` elements off
    its allocation, against the plain version (``torch.equal``), and the
    kernel one call launches (the planned one, once, read as
    ``kernel_launches`` reads it); timed: beside the bound, the plain
    version and ``y.copy_(x)`` on the same bytes (a yardstick of what the
    card moves at that size)."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import abfp_qdq as aq

    fmt = get_format(fmt_name) if isinstance(fmt_name, str) else fmt_name
    if x32 is None:
        x32 = activations(torch, gen, (M, K))
    x = qdq_operand(torch, x32, getattr(torch, dtype), offset)
    plan = aq.plan_qdq(M * (K // n), n, x.element_size(),
                       x.data_ptr() % 16 == 0, fmt)  # y: a new allocation
    got, by_kernel = wrapper_launches(torch, aq.abfp_qdq,
                                      lambda: aq.abfp_qdq(x, fmt, n=n))
    counted = sum(by_kernel.values())
    want = aq.abfp_qdq_plain(x, fmt, n=n)
    torch.cuda.synchronize()
    # every operation is correctly rounded on both sides: bit-exact
    ok = bool(torch.equal(got, want)) and got.dtype == x.dtype
    same = got == want  # where both are inf the difference is NaN
    err = torch.where(same, 0.0, (got.float() - want.float()).abs()
                      ).max().item()
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32}[x.element_size()]
    seen = kernel_launches(torch, aq.abfp_qdq,
                           lambda: aq.abfp_qdq(x, fmt, n=n), QDQ_KERNELS,
                           {plan.kernel: 1}, f"abfp_qdq {label}", profiled)
    row = {"shape": label, "M": M, "K": K, "n": n, "fmt": fmt.name,
           "dtype": dtype, "offset_bytes": offset * x.element_size(),
           "kernel": plan.kernel, "vec": plan.vec, "lanes": plan.lanes,
           "vpl": plan.vpl, "mode": plan.mode, "threads": plan.threads,
           "blocks": plan.blocks, "launched": seen, "counted": counted,
           "max_abs_err": err, "tol": 0.0,
           "ok": ok and counted == 1 and seen == {plan.kernel: 1},
           "bit_equal": bool(torch.equal(got.view(bits), want.view(bits)))}
    if timed:
        # per element: |x|, max, divide, round, clamp (2), multiply
        row.update(bound_fields(nbytes(x, got), 7.0 * M * K,
                                PEAK_F32_FLOPS))
        row["ms"] = timer(lambda: aq.abfp_qdq(x, fmt, n=n), iters=10)
        row["plain_ms"] = timer(lambda: aq.abfp_qdq_plain(x, fmt, n=n),
                                iters=3, warmup=1)
        y = torch.empty_like(x)
        row["copy_ms"] = timer(lambda: y.copy_(x), iters=10)
        row["library_ms"] = None  # no single PyTorch call computes it
    log(f"  abfp_qdq {label}: " + json.dumps(row))
    if not row["ok"]:
        raise SystemExit(f"abfp_qdq is not bit-exact against its plain "
                         f"version at {label} (max_abs_err={err}), or was "
                         f"counted {counted} times")
    return row


def abfp_qdq_checks(torch, timer, gen) -> list:
    """``abfp_qdq`` timed at the head shape (M = 256, K = 3584: f32 in
    four formats, bf16), a whole wi weight (the simulator's weight QDQ)
    and ``abfp_matmul``'s pre-pass shapes (M = 4, K = 3584 and 18944);
    held against the plain version in every format at n = 16, 32, 48, 64,
    128 in f32, bf16 and f16, with a base 4 bytes off the 16-byte grid, at
    K = 640 with n = 32, 40 and 64, on the edge cases of ``qdq_extremes``,
    and on groups too long for a set's registers and a minifloat with
    subnormal quanta (qdq_rows_kernel).
    Returns the timed rows."""
    from repro_torch.core.formats import BY_NAME, FloatFormat

    t0 = time.perf_counter()
    rows = []
    for fmt in ("int8", "int4", "e2m1", "e4m3"):
        rows.append(check_abfp_qdq(torch, timer, gen, M=256, K=3584, n=64,
                                   fmt_name=fmt, label=f"M=256 K=3584 {fmt}"))
    for fmt in ("int8", "e4m3"):
        rows.append(check_abfp_qdq(torch, timer, gen, M=256, K=3584, n=64,
                                   fmt_name=fmt, dtype="bfloat16",
                                   label=f"M=256 K=3584 bf16 {fmt}"))
    for fmt in ("int4", "e4m3"):
        rows.append(check_abfp_qdq(
            torch, timer, gen, M=18944, K=3584, n=64, fmt_name=fmt,
            label=f"weight N=18944 K=3584 {fmt}"))
        torch.cuda.empty_cache()
    for K in (3584, 18944):
        for fmt in ("int8", "int4", "e2m1", "e4m3"):
            rows.append(check_abfp_qdq(torch, timer, gen, M=4, K=K, n=64,
                                       fmt_name=fmt,
                                       label=f"M=4 K={K} {fmt}"))
    checks = 0
    for dtype in ("float32", "bfloat16", "float16"):
        for fmt in sorted(BY_NAME):
            for n in (16, 32, 48, 64, 128):
                check_abfp_qdq(torch, timer, gen, M=13, K=3840, n=n,
                               fmt_name=fmt, dtype=dtype, timed=False,
                               label=f"M=13 K=3840 n={n} {dtype} {fmt}")
                checks += 1
            for n in (48, 64):
                x32 = torch.from_numpy(qdq_extremes(fmt, n, dtype)).cuda()
                check_abfp_qdq(torch, timer, gen, M=7, K=4 * n, n=n,
                               fmt_name=fmt, dtype=dtype, x32=x32,
                               timed=False,
                               label=f"extremes n={n} {dtype} {fmt}")
                checks += 1
        for fmt in ("int8", "e4m3"):
            check_abfp_qdq(torch, timer, gen, M=13, K=3840, n=64,
                           fmt_name=fmt, dtype=dtype, timed=False,
                           offset=4 // getattr(torch, dtype).itemsize,
                           label=f"base 4 bytes off M=13 K=3840 {dtype} "
                                 f"{fmt}")
            checks += 1
    for fmt in sorted(BY_NAME):
        for n in (64, 40, 32):
            check_abfp_qdq(torch, timer, gen, M=13, K=640, n=n, fmt_name=fmt,
                           label=f"ragged M=13 K=640 n={n} {fmt}",
                           timed=False)
            checks += 1
    for dtype in ("bfloat16", "float16"):
        check_abfp_qdq(torch, timer, gen, M=13, K=640, n=40, fmt_name="e4m3",
                       dtype=dtype, label=f"ragged M=13 K=640 n=40 {dtype}",
                       timed=False)
        checks += 1
    for M, K, n in ((5, 720, 36), (3, 4096, 2048)):
        check_abfp_qdq(torch, timer, gen, M=M, K=K, n=n, fmt_name="int8",
                       label=f"rows kernel M={M} K={K} n={n}", timed=False)
        checks += 1
    # a minifloat whose smallest quanta are subnormal keeps qdq_unit's
    # frexpf / ldexpf arithmetic (qdq_rows_kernel)
    wide = FloatFormat(exp_bits=8, man_bits=3, max_value=448.0)
    for dtype in ("float32", "bfloat16"):
        check_abfp_qdq(torch, timer, gen, M=13, K=3840, n=64, fmt_name=wide,
                       dtype=dtype, label=f"rows kernel e8m3 {dtype}",
                       timed=False)
        checks += 1
    log(f"  abfp_qdq: {checks} untimed checks, all bit-exact; "
        f"{time.perf_counter() - t0:.1f} s in all")
    torch.cuda.empty_cache()
    return rows


def check_dense_matmul(torch, timer, gen, *, kind, M, K, N, n=64, label,
                       timed=True, exact=False, fx="int8",
                       fw="int4") -> dict:
    """``kind`` 'fp' (abfp_matmul) or 'int8' (abfp_matmul_int8); formats
    ``fx`` of x and ``fw`` of w (by default w4a8's: int8 x, int4 w; a name
    of ``get_format`` or "intB" for an int format of B bits).  Where
    abfp_matmul contracts int codes of at most 8 bits on the bf16 tensor
    cores, its result must be abfp_matmul_int8's kernel's, bit for bit."""
    from repro_torch.core.formats import IntFormat, get_format
    from repro_torch.kernels import quant_matmul as qm

    fn, plain = ((qm.abfp_matmul, qm.abfp_matmul_plain) if kind == "fp"
                 else (qm.abfp_matmul_int8, qm.abfp_matmul_int8_plain))
    FX, FW = (IntFormat(int(f[3:])) if f.startswith("int") else
              get_format(f) for f in (fx, fw))
    x = activations(torch, gen, (M, K))
    w = torch.randn((K, N), generator=gen, device="cuda") * K ** -0.5
    got = fn(x, w, FX, FW, n=n)
    torch.cuda.synchronize()
    want = plain(x, w, FX, FW, n=n)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    ref = want.abs().max().item()
    # same codes on both sides; the fp kernel rescales each group's sum of
    # code products where the plain version multiplies QDQ'd values, and
    # the f32 sum over K (fp) or over the groups (int8, whose group sums
    # are exact integers) runs in another order: 1e-5 of the largest
    # output magnitude.  With K = n there is one group: the int8 result is
    # then (sum * sx) * sw on both sides, and must be bit-exact, which pins
    # the kernel's int32 group sums.
    tol = 0.0 if exact else 1e-5 * ref
    ok = bool(torch.isfinite(got).all().item()) and err <= tol
    row = {"shape": label, "M": M, "K": K, "N": N, "n": n, "fx": fx,
           "fw": fw, "max_abs_err": err, "tol": tol, "ok": ok}
    plan = qm.plan_abfp_matmul(M, N, K, n, int8=(kind == "int8"),
                               formats=(FX, FW))
    row.update(regime=plan.regime, n_pad=plan.n_pad, splits=plan.splits,
               blocks=plan.tiles * plan.splits)
    if (kind == "fp" and plan.regime == "prefill"
            and all(isinstance(f, IntFormat) and f.bits <= 8
                    for f in (FX, FW))):
        twin = qm.abfp_matmul_int8(x, w, FX, FW, n=n)
        row["bit_equal_int8"] = bool(torch.equal(got, twin))
        ok = row["ok"] = ok and row["bit_equal_int8"]
    if timed:
        peak = (PEAK_INT8_OPS if kind == "int8" else PEAK_BF16_FLOPS
                if plan.regime == "prefill" else PEAK_F32_FLOPS)
        row.update(bound_fields(nbytes(x, w, got), 2.0 * M * N * K, peak))
        row["ms"] = timer(lambda: fn(x, w, FX, FW, n=n), iters=10)
        row["ms_with_enqueue"] = timer(lambda: fn(x, w, FX, FW, n=n),
                                       iters=10, with_enqueue=True)
        row["plain_ms"] = timer(lambda: plain(x, w, FX, FW, n=n),
                                iters=3, warmup=1)
        row["library_ms"] = None  # no single PyTorch call computes it
    name = "abfp_matmul" if kind == "fp" else "abfp_matmul_int8"
    log(f"  {name} {label}: " + json.dumps(row))
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version (or, on "
                         f"int codes, with abfp_matmul_int8) at {label}: "
                         f"max_abs_err={err} > {tol}")
    return row


# the kernels of flash_attention, as the profiler names them: the
# tensor-core kernel plan_flash routes every call to, and the parent's
# SIMT kernel, which no route takes any more
FLASH_KERNELS = {"flash_mma_kernel": "flash_mma_kernel",
                 "flash_kernel": "flash_kernel"}


def check_flash(torch, timer, gen, *, B=1, S, T, H=28, KV=4, D=128,
                causal=True, q_offset=None, label, timed=True,
                profiled=True) -> dict:
    """One ``flash_attention`` call against its plain version; the kernel
    it launches (read as ``kernel_launches`` reads it) must be the planned
    one
    (``flash_mma_kernel``).  Timed: beside the plain version, SDPA (a
    yardstick) and the card's bound: the bytes moved once are the floor,
    the products as the kernel issues them (three tf32 products a
    product) take less, and the same products as f32 on the CUDA cores
    (``ops_f32_simt_ms``) are a reference."""
    from repro_torch.kernels.ops import flash_attention_gqa
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain,
                                                     plan_flash)

    qh = torch.randn((B, S, H, D), generator=gen, device="cuda")
    kh = torch.randn((B, T, KV, D), generator=gen, device="cuda")
    vh = torch.randn((B, T, KV, D), generator=gen, device="cuda")
    q = qh.transpose(1, 2).reshape(B * H, S, D).contiguous()
    k = kh.transpose(1, 2).reshape(B * KV, T, D).contiguous()
    v = vh.transpose(1, 2).reshape(B * KV, T, D).contiguous()
    kw = dict(scale=D ** -0.5, causal=causal, q_offset=q_offset)
    got = flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    want = flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = 2e-5 * want.abs().max().item()  # f32, sums in another order
    ok = bool(torch.isfinite(got).all().item()) and err <= tol
    if causal and q_offset is not None and q_offset < 0:
        # rows that see no key are exactly 0
        ok = ok and not bool(got[:, :-q_offset].any().item())
    # the GQA front-end (what the model calls) is the same function
    front = flash_attention_gqa(qh, kh, vh, **kw)
    ok = ok and torch.equal(front.transpose(1, 2).reshape(B * H, S, D), got)
    plan = plan_flash(B, S, T, H, KV, D, causal)
    launched = kernel_launches(
        torch, flash_attention, lambda: flash_attention(q, k, v, **kw),
        FLASH_KERNELS, {plan.kernel: 1}, label, profiled)
    row = {"shape": label, "B": B, "S": S, "T": T, "H": H, "KV": KV,
           "D": D, "causal": causal, "kernel": launched,
           "plan": plan._asdict(), "max_abs_err": err, "tol": tol, "ok": ok}
    if timed:
        off = 0 if q_offset is None else q_offset
        # key/query pairs this call's mask keeps; 2 operations each for
        # q.k and for p.v per head_dim element
        pairs = sum(min(T, max(0, i + 1 + off)) for i in range(S)) \
            if causal else S * T
        ops = 4.0 * B * H * D * pairs
        row.update(bound_fields(nbytes(q, k, v, got), 3 * ops,
                                PEAK_TF32_FLOPS))
        row["ops_f32_simt_ms"] = ops / PEAK_F32_FLOPS * 1e3
        row["ms"] = timer(lambda: flash_attention(q, k, v, **kw), iters=10)
        row["plain_ms"] = timer(lambda: flash_attention_plain(q, k, v, **kw),
                                iters=3, warmup=1)
        # yardstick only: PyTorch's own fused attention on the same inputs
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qs, ks, vs = (t.transpose(1, 2) for t in (qh, kh, vh))
        row["library_ms"] = timer(
            lambda: sdpa(qs, ks, vs, is_causal=causal, enable_gqa=True),
            iters=10)
    log(f"  flash_attention {label}: " + json.dumps(row))
    if not ok:
        raise SystemExit(f"flash_attention disagrees with its plain version "
                         f"at {label}: max_abs_err={err} > {tol}")
    if launched != {plan.kernel: 1}:
        raise SystemExit(f"flash_attention at {label} launched {launched}, "
                         f"expected {plan.kernel}")
    return row


# (label, K, N) of the dense qwen2-7b layers, and lm_head
DENSE_SHAPES = (("q,o", 3584, 3584), ("k,v", 3584, 512),
                ("wi,wg", 3584, 18944), ("wo", 18944, 3584))


def fp_decode_checks(torch, timer, gen) -> list:
    """``abfp_matmul``'s decode kernel (M <= 16) beyond the main-path rows:
    timed at M = 16; held against the plain version at every M where its
    row block changes (4, 8, 16) and at M = 17, the first M of the prefill
    kernel; with groups of 32; with minifloats (e4m3 x, e2m1 w); and at
    ragged N with groups of 32.  Returns the timed rows."""
    rows = [check_dense_matmul(torch, timer, gen, kind="fp", M=16, K=K, N=N,
                               label=f"{name} M=16 K={K} N={N}")
            for name, K, N in DENSE_SHAPES]
    for M in (1, 2, 3, 5, 8, 16, 17):
        check_dense_matmul(torch, timer, gen, kind="fp", M=M, K=3584, N=3584,
                           label=f"q,o M={M}", timed=False)
    for name, K, N in DENSE_SHAPES[:2] + (("wo", 18944, 3584),):
        check_dense_matmul(torch, timer, gen, kind="fp", M=4, K=K, N=N, n=32,
                           label=f"{name} M=4 n=32", timed=False)
        check_dense_matmul(torch, timer, gen, kind="fp", M=4, K=K, N=N,
                           fx="e4m3", fw="e2m1", timed=False,
                           label=f"{name} M=4 e4m3 x e2m1 w")
    for M, K, N in ((13, 640, 77), (3, 96, 130)):
        check_dense_matmul(torch, timer, gen, kind="fp", M=M, K=K, N=N, n=32,
                           label=f"ragged M={M} K={K} N={N} n=32",
                           timed=False)
    return rows


def int8_decode_checks(torch, timer, gen) -> list:
    """``abfp_matmul_int8``'s decode kernel (M <= 16) beyond the main-path
    rows: timed at M = 16; held against the plain version at every M where
    its row block changes and at M = 17 (the three-launch path); with
    groups of 32; with int8 weights (w8a8_int8_native's formats) beside
    int4; at ragged N; and bit for bit at K = n (one group) for M <= 16,
    which pins the kernel's exact int32 group sums.  Returns the timed
    rows."""
    rows = [check_dense_matmul(torch, timer, gen, kind="int8", M=16, K=K,
                               N=N, label=f"{name} M=16 K={K} N={N}")
            for name, K, N in DENSE_SHAPES]
    for M in (1, 2, 3, 5, 8, 16, 17):
        check_dense_matmul(torch, timer, gen, kind="int8", M=M, K=3584,
                           N=3584, label=f"q,o M={M}", timed=False)
    for name, K, N in DENSE_SHAPES[:2] + (("wo", 18944, 3584),):
        check_dense_matmul(torch, timer, gen, kind="int8", M=4, K=K, N=N,
                           n=32, label=f"{name} M=4 n=32", timed=False)
        check_dense_matmul(torch, timer, gen, kind="int8", M=4, K=K, N=N,
                           fw="int8", timed=False,
                           label=f"{name} M=4 int8 x int8 w")
    for M, K, N in ((13, 640, 77), (3, 96, 130)):
        check_dense_matmul(torch, timer, gen, kind="int8", M=M, K=K, N=N,
                           n=32, label=f"ragged M={M} K={K} N={N} n=32",
                           timed=False)
    for M, N, n, fw in ((1, 64, 64, "int4"), (16, 130, 64, "int4"),
                        (5, 77, 32, "int4"), (16, 503, 64, "int8"),
                        (8, 130, 32, "int8")):
        check_dense_matmul(torch, timer, gen, kind="int8", M=M, K=n, N=N,
                           n=n, fw=fw, exact=True, timed=False,
                           label=f"one group M={M} K={n} N={N} {fw} w")
    return rows


def forward_pass_ms(rows, at: str) -> dict:
    """One decode forward pass of qwen2-7b from the timed rows at ``at``
    (e.g. "M=4"): 28 x (2 q,o + 2 k,v + 2 wi,wg + wo) + lm_head."""
    by = {r["shape"].split(" ")[0]: r for r in rows
          if f" {at} " in r["shape"] + " " and "ms" in r}
    per_layer = {"q,o": 2, "k,v": 2, "wi,wg": 2, "wo": 1}
    out = {}
    for key in ("ms", "ms_with_enqueue", "ms_in_situ", "bound_ms",
                "read_codes_ms"):
        if any(key not in r for r in by.values()):
            continue
        layers = 28 * sum(c * by[name][key] for name, c in per_layer.items())
        out[key] = layers + (by["lm_head"][key] if "lm_head" in by else 0.0)
    out["lm_head_included"] = "lm_head" in by
    return out


# kernels of one matmul call, by the name the profiler gives them (matched
# as substrings: no name here is part of another kernel's name; the code
# type of mma_contract_kernel names its variant)
REGIME_KERNELS = {
    "fp": {"fp_decode_kernel": "decode", "fp_contract_kernel": "simt",
           "qdq_stream_kernel": "x_qdq",
           "quantize_rows_kernel<__nv_bfloat16": "x_codes",
           "quantize_cols_kernel<__nv_bfloat16": "w_codes",
           "Bf16Codes>": "mma"},
    "int8": {"int8_decode_kernel": "decode",
             "quantize_cols_kernel<signed char": "w_codes",
             "Int8Codes>": "mma",
             "quantize_rows_kernel<signed char": "x_codes"},
    "quant": {"quant_decode_kernel": "decode", "Int4PackedCodes>": "mma",
              "::contract_kernel<": "contract", "at::native::": "pad_copy",
              "quantize_rows_kernel<signed char": "x_codes"},
}

# (M, n) of each call check_regimes profiles, per kind; (M, n, "int12"):
# abfp_matmul with x and w in a 12-bit int format (unit codes bf16 cannot
# hold); (M, n, "wide"): quant_matmul at N = 18944 (wi,wg) instead of 512
REGIME_CASES = {"fp": ((1, 64), (4, 64), (16, 64), (17, 64), (64, 64),
                       (4, 48), (4, 40), (64, 64, "int12")),
                "int8": ((1, 64), (4, 64), (16, 64), (17, 64), (64, 64),
                         (4, 48), (4, 40)),
                "quant": ((1, 64), (4, 64), (8, 64), (16, 64), (17, 64),
                          (256, 64), (4, 40), (16, 40), (17, 40),
                          (1, 64, "wide"), (4, 64, "wide"), (4, 40, "wide"),
                          (16, 64, "wide"))}


def regime_want(kind: str, M: int, n: int, wide: bool = False) -> dict:
    """The kernels one call launches, by role.  fp and int8 up to 16 rows
    at n = 32 or 64: the x QDQ (int8: x's codes) and the decode kernel
    (no w code scratch); otherwise x's codes, w's codes and the
    tensor-core contraction (bf16 codes for fp, int8 for int8); fp with a
    format bf16 cannot hold (``wide``): the x QDQ and the f32 SIMT kernel.
    quant (``quant_matmul``, packed int4): quant_decode_kernel alone up to
    16 rows (x's codes made on chip), but x's codes and contract_kernel up
    to 4 rows of a wide layer (``wide``: N = 18944); x's codes and the
    tensor-core contraction from 17 rows; at a group length off the 32
    grid, first PyTorch's two launches that copy the stored codes into a
    zero-padded buffer (fill, copy)."""
    if kind in ("fp", "int8"):
        if M <= 16 and n in (32, 64):
            return {"x_qdq" if kind == "fp" else "x_codes": 1, "decode": 1}
        if wide:
            return {"x_qdq": 1, "simt": 1}
        return {"x_codes": 1, "w_codes": 1, "mma": 1}
    pad = {"pad_copy": 2} if n % 32 else {}
    if M <= 4 and wide:
        return {**pad, "x_codes": 1, "contract": 1}
    if M <= 16:
        return {**pad, "decode": 1}
    return {**pad, "x_codes": 1, "mma": 1}


# profiler captures taken again, with the phase and what each read (the
# kernels phase reports its own; the run ends with a count by phase)
PROFILER_RETRIES = []
PHASE = {"name": "build"}  # the phase running now


# captures of one call that may read no device event at all before the
# call fails (the profiler drops a whole capture now and then, at times a
# few in a row); a capture that reads events other than the expected ones
# is taken once more only
PROFILER_EMPTY_CAPTURES = 5


def device_launches(torch, call, names_of: dict, want=None,
                    label: str = "a call", roles_only: bool = False) -> dict:
    """Kernel launches of one ``call`` (after a warm call), read from the
    profiler: {role: count}, a kernel named by the first key of
    ``names_of`` its name contains, else by its name's first 90
    characters.  A capture that reads other than ``want`` (with
    ``roles_only``: other counts of ``want``'s roles, whatever else it
    reads; without ``want``: no device event at all; the profiler now and
    then drops an event, or a whole capture) is taken again and recorded
    in ``PROFILER_RETRIES``: a second one that reads other events fails,
    and so does the ``PROFILER_EMPTY_CAPTURES``-th that reads none.  Each
    capture starts with ``lead_spins``, left out of the reading: late in
    a whole run the profiler drops a capture's first launches (an
    opt-125m forward read 72 of its 73 x and w codings twice in a row)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()  # warm: tickets, library
    torch.cuda.synchronize()
    wrong = empty = 0
    while True:
        names = {}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            lead_spins(torch)
            call()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            if (e.device_type != DeviceType.CUDA or not e.count
                    or "spin_kernel" in e.key):
                continue
            hit = [v for k, v in names_of.items() if k in e.key]
            key = hit[0] if hit else e.key[:90]
            names[key] = names.get(key, 0) + e.count
        seen = ({k: names.get(k, 0) for k in want} if roles_only and want
                else names)
        if names and (want is None or seen == want):
            return names
        wrong, empty = wrong + bool(names), empty + (not names)
        PROFILER_RETRIES.append({"phase": PHASE["name"], "call": label,
                                 "capture": wrong + empty,
                                 "read": names, "expected": want})
        log(f"  (profiler capture {wrong + empty} of {label} read {names}, "
            f"expected {want})")
        if wrong >= 2 or empty >= PROFILER_EMPTY_CAPTURES or (
                wrong and empty):
            raise SystemExit(f"{label}: profiler captures read other "
                             f"launches than {want}: "
                             f"{PROFILER_RETRIES[-(wrong + empty):]}")
        time.sleep(0.2)  # let a dropped capture's buffers settle


def wrapper_launches(torch, wrapper, call) -> tuple:
    """(``call()``, {kernel: n}): the launches ``wrapper`` counted by
    kernel during the call (its ``launches_by_kernel`` before and after,
    the kernels it did not launch left out)."""
    before = dict(wrapper.launches_by_kernel)
    out = call()
    torch.cuda.synchronize()
    return out, {k: n - before[k]
                 for k, n in wrapper.launches_by_kernel.items()
                 if n != before[k]}


def kernel_launches(torch, wrapper, call, names_of: dict, want: dict,
                    label: str, profiled: bool = True) -> dict:
    """{kernel: n} of one ``call`` of ``wrapper``: read from the profiler
    (``device_launches``, which holds it to ``want``), or with
    ``profiled=False`` from the wrapper's count by kernel
    (``wrapper_launches``), as late in a whole run the profiler has
    dropped a lone launch's record five captures in a row."""
    if profiled:
        return device_launches(torch, call, names_of, want, label)
    return wrapper_launches(torch, wrapper, call)[1]


def check_regimes(torch, gen, kind: str) -> None:
    """Which kernels one ``abfp_matmul`` (``kind`` 'fp'),
    ``abfp_matmul_int8`` ('int8') or ``quant_matmul`` ('quant') call
    launches at each case of ``REGIME_CASES``, read from the profiler; the
    run fails on any other set than ``regime_want``'s."""
    from repro_torch.core.formats import INT4, INT8, IntFormat
    from repro_torch.core.quantize import pack_int4_codes
    from repro_torch.kernels import quant_matmul as qm

    seen = {}
    for M, n, *wide in REGIME_CASES[kind]:
        K = 3840 if n in (40, 48) else 3584  # whole groups
        N = 18944 if wide == ["wide"] else 512
        fx, fw = (IntFormat(12), IntFormat(12)) if wide else (INT8, INT4)
        x = torch.randn((M, K), generator=gen, device="cuda")
        if kind == "quant":
            codes = pack_int4_codes(torch.randint(
                -8, 8, (N, K // n, n), generator=gen, device="cuda",
                dtype=torch.int8))
            scales = torch.rand((N, K // n), generator=gen, device="cuda")
            name = qm.quant_matmul.__name__

            def call():
                return qm.quant_matmul(x, codes, scales, INT8, n=n,
                                       packed=True)
        else:
            fn = qm.abfp_matmul if kind == "fp" else qm.abfp_matmul_int8
            w = torch.randn((K, N), generator=gen, device="cuda")
            name = fn.__name__

            def call():
                return fn(x, w, fx, fw, n=n)
        want = regime_want(kind, M, n, bool(wide))
        case = f"M={M} n={n}" + (f" {wide[0]}" if wide else "")
        names = device_launches(torch, call, REGIME_KERNELS[kind], want,
                                f"{name} at {case}")
        seen[case] = names
        if names != want:
            raise SystemExit(f"{name} at {case} launched {names}, "
                             f"expected {want}")
    log(f"  {name} regimes (kernel launches a call): " + json.dumps(seen))


def quant_decode_checks(torch, timer, gen) -> list:
    """``quant_matmul`` up to 16 rows beyond the main path's rows, against
    the plain version, packed and int8 codes.  ``quant_decode_kernel``: at
    M = 1, 2, 3, 4, 5, 8 and 16 (each row block) with groups of 32, 64 and
    a zero-padded one (packed 40 -> 64, int8 24 -> 32); at ragged N (77,
    503); at a K whose splits are one group each (K = 8 n on one tile);
    bit for bit at K = n (one group); and at the longest groups it takes
    (512 bytes of a column).  ``contract_kernel`` (up to 4 rows at N >=
    16896): at M = 1-4, the same group lengths, ragged N = 16973, bit for
    bit at K = n.  Timed at M = 16 at the main-path shapes.  Returns the
    timed rows."""
    rows = []
    for name, K, N in DENSE_SHAPES + (("lm_head", 3584, 152064),):
        rows.append(check_quant_matmul(
            torch, timer, gen, M=16, K=K, N=N, packed=True,
            label=f"{name} M=16 K={K} N={N} int4-packed"))
    for packed in (True, False):
        tag = "int4-packed" if packed else "int8"
        for M in (1, 2, 3, 4, 5, 8, 16):
            # int8: 24 pads to 32 (40 would pad to 48: the tensor cores)
            for n in (32, 64, 40 if packed else 24):
                check_quant_matmul(torch, timer, gen, M=M, K=60 * n, N=512,
                                   n=n, packed=packed, timed=False,
                                   label=f"decode M={M} n={n} {tag}")
        for M, N in ((3, 77), (16, 503), (5, 77), (4, 503)):
            check_quant_matmul(torch, timer, gen, M=M, K=640, N=N,
                               packed=packed, timed=False,
                               label=f"decode ragged M={M} N={N} {tag}")
        for M in (4, 16):
            check_quant_matmul(torch, timer, gen, M=M, K=8 * 64, N=64,
                               packed=packed, timed=False,
                               label=f"decode one-group splits M={M} {tag}")
        for M in (1, 4, 5, 16):
            for n in (32, 64):
                check_quant_matmul(torch, timer, gen, M=M, K=n, N=503, n=n,
                                   packed=packed, timed=False, exact=True,
                                   label=f"decode one group M={M} n={n} "
                                         f"{tag}")
        for M in (4, 16):
            n = 1024 if packed else 512
            check_quant_matmul(torch, timer, gen, M=M, K=7 * n, N=130, n=n,
                               packed=packed, timed=False,
                               label=f"decode long groups M={M} n={n} {tag}")
        for M in (1, 2, 3, 4):
            for n in (32, 64, 40 if packed else 24,
                      1024 if packed else 512):
                check_quant_matmul(torch, timer, gen, M=M, K=7 * n, N=16973,
                                   n=n, packed=packed, timed=False,
                                   label=f"contract M={M} n={n} N=16973 "
                                         f"{tag}")
            check_quant_matmul(torch, timer, gen, M=M, K=64, N=16896,
                               packed=packed, timed=False, exact=True,
                               label=f"contract one group M={M} {tag}")
    return rows


def stream_ms(torch, calls, reps: int = 7) -> float:
    """Device ms of ``calls`` run back to back (median of ``reps``), the
    card held by ``torch.cuda._sleep`` while the host enqueues them."""
    for call in calls:
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda._sleep(200_000 * len(calls))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for call in calls:
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


DECODE_SHAPES = (("q,o", 3584, 3584), ("k,v", 3584, 512),
                 ("wi,wg", 3584, 18944), ("wo", 18944, 3584),
                 ("lm_head", 3584, 152064))
DECODE_LAYER = ("q,o", "k,v", "k,v", "q,o", "wi,wg", "wi,wg", "wo")
SWEEP_SPLITS = (1, 2, 4, 8, 16, 32)


def quant_decode_in_situ(torch, gen) -> dict:
    """``quant_matmul`` at M = 4 (packed, n = 64) as a decode step meets
    it, timed by ``stream_ms``: at each main-path shape, distinct weights
    of at least 200 MB in all called back to back, so every call reads its
    codes from device memory and finds L2 full of clean lines of other
    weights (``Timer`` leaves it full of dirty ones); ms a call.  Per
    shape: the planned kernels, the other route (one-launch
    ``quant_decode_kernel``, or x's codes then ``contract_kernel``) and the
    one-launch kernel at each of ``SWEEP_SPLITS`` K splits, each held
    against the plain version first.  Then the decode step's 197 calls
    (28 x ``DECODE_LAYER`` + lm_head, distinct weights): planned, all one
    launch, all two launches."""
    from repro_torch.core.formats import INT8
    from repro_torch.kernels import quant_matmul as qm

    def weights(K, N, count):
        return [(torch.randint(0, 256, (N, K // 64, 32), generator=gen,
                               device="cuda", dtype=torch.uint8),
                 torch.rand((N, K // 64), generator=gen, device="cuda")
                 * 0.02 + 1e-3) for _ in range(count)]

    def one_launch(K, N, splits=None):
        plan = qm.plan_quant_decode(4, N, K, 64, True)
        if splits is None:
            return plan
        t_max = -(-(K // 64) // splits)
        return plan._replace(splits=splits, t_max=t_max,
                             smem_bytes=qm.qd_smem_bytes(32, 4, 64, t_max))

    def two_launch(K, N):
        return qm.ContractPlan(4, -(-N // qm.CONTRACT_CN), 1)

    def call(x, w, plan):
        return lambda: qm._quant_matmul(x, *w, INT8, 64, True, plan)

    out = {}
    for name, K, N in DECODE_SHAPES:
        count = max(2, -(-200_000_000 // (N * K // 2)))
        ws = weights(K, N, count)
        x = torch.randn((4, K), generator=gen, device="cuda")
        want = qm.quant_matmul_plain(x, *ws[0], INT8, n=64, packed=True)
        tol = 1e-5 * want.abs().max().item()
        plans = {"planned": qm.quant_matmul_plan(4, N, K, 64, True),
                 "one_launch": one_launch(K, N),
                 "two_launch": two_launch(K, N)}
        for s in SWEEP_SPLITS:
            plan = one_launch(K, N, s)
            if s <= K // 64 and plan.smem_bytes <= qm.SMEM_MAX:
                plans[f"one_launch splits={s}"] = plan
        row = {}
        for label, plan in plans.items():
            err = (call(x, ws[0], plan)() - want).abs().max().item()
            if not err <= tol:
                raise SystemExit(f"quant_matmul {name} M=4 ({label}) "
                                 f"disagrees: {err} > {tol}")
            row[label] = stream_ms(torch, [call(x, w, plan)
                                           for w in ws]) / count
        out[name] = row
        del ws
    # the decode step's matmuls, distinct weights
    shapes = {name: (K, N) for name, K, N in DECODE_SHAPES}
    order = [*DECODE_LAYER * 28, "lm_head"]
    ws = [weights(*shapes[name], 1)[0] for name in order]
    xs = {K: torch.randn((4, K), generator=gen, device="cuda")
          for K in (3584, 18944)}
    for label, route in (
            ("planned", lambda K, N: qm.quant_matmul_plan(4, N, K, 64, True)),
            ("one_launch", one_launch), ("two_launch", two_launch)):
        calls = [call(xs[shapes[name][0]], w, route(*shapes[name]))
                 for name, w in zip(order, ws)]
        out[f"decode pass ({len(calls)} calls) {label}"] = stream_ms(
            torch, calls)
    del ws
    torch.cuda.empty_cache()
    log("  quant_matmul in situ at M=4 (ms a call; a pass: ms): "
        + json.dumps(out))
    return out


def mma_checks(torch, timer, gen) -> None:
    """``mma_contract_kernel`` on int8 and packed int4 codes (the
    contraction of ``quant_matmul`` above 16 rows and of
    ``abfp_matmul_int8``'s prefill regime) against the plain versions,
    untimed: at M = 17, 33, 64, 128; at ragged N = 77 and 130; with groups
    of 32, 48, 64 and 128 (and 96 for packed codes, which take multiples
    of 32), and of 8, 24, 40 and 512 (codes zero-padded to the grid), each
    below 16 rows and at 192; bit for bit at K = n (one group) at M = 33
    and 64."""
    for packed in (True, False):
        tag = "int4-packed" if packed else "int8"
        for M in (17, 33, 64, 128):
            check_quant_matmul(torch, timer, gen, M=M, K=3584, N=3584,
                               packed=packed, timed=False,
                               label=f"mma q,o M={M} {tag}")
        for M, K, N, n in ((40, 640, 77, 32), (96, 768, 130, 128),
                           (17, 384, 130, 64)):
            check_quant_matmul(torch, timer, gen, M=M, K=K, N=N, n=n,
                               packed=packed, timed=False,
                               label=f"mma ragged M={M} K={K} N={N} n={n} "
                                     f"{tag}")
        groups = (32, 64, 96, 128) if packed else (32, 48, 64, 128)
        for n in groups + (8, 24, 40, 512):
            for M in (4, 192):
                check_quant_matmul(torch, timer, gen, M=M, K=15 * n, N=512,
                                   n=n, packed=packed, timed=False,
                                   label=f"groups M={M} n={n} {tag}")
        for M in (33, 64):
            for n in (32, 64) if packed else (32, 48, 64):
                check_quant_matmul(torch, timer, gen, M=M, K=n, N=130, n=n,
                                   packed=packed, timed=False, exact=True,
                                   label=f"mma one group M={M} n={n} {tag}")
    for fw in ("int4", "int8"):
        for M in (17, 33, 64, 128):
            check_dense_matmul(torch, timer, gen, kind="int8", M=M, K=3584,
                               N=512, fw=fw, timed=False,
                               label=f"mma k,v M={M} {fw} w")
        for M, K, N, n in ((40, 640, 77, 32), (96, 768, 130, 128),
                           (17, 384, 130, 64)):
            check_dense_matmul(torch, timer, gen, kind="int8", M=M, K=K, N=N,
                               n=n, fw=fw, timed=False,
                               label=f"mma ragged M={M} K={K} N={N} n={n} "
                                     f"{fw} w")
        for n in (8, 24, 32, 40, 48, 64, 128, 512):
            for M in (4, 192):
                check_dense_matmul(torch, timer, gen, kind="int8", M=M,
                                   K=15 * n, N=512, n=n, fw=fw, timed=False,
                                   label=f"groups M={M} n={n} {fw} w")
        for M in (33, 64):
            for n in (32, 48, 64):
                check_dense_matmul(torch, timer, gen, kind="int8", M=M, K=n,
                                   N=130, n=n, fw=fw, timed=False,
                                   exact=True,
                                   label=f"mma one group M={M} n={n} {fw} w")


def fp_prefill_checks(torch, timer, gen) -> None:
    """``abfp_matmul`` above 16 rows (the bf16 tensor cores) against the
    plain version, untimed: at M = 17, 33, 64, 192 with ragged N (77, 130),
    at every group length n = 8, 16, 24, 32, 40, 48, 64, 128, 512 (codes
    zero-padded off the 16 grid), in int8 x int4 (then bit-equal to
    ``abfp_matmul_int8``'s kernel), e4m3 x e2m1 (inexact group sums) and
    e5m2 x int8; at wo's K = 18944 in each; and in a 12-bit int format,
    which bf16 cannot hold, on the f32 SIMT kernel at n = 64 and 512."""
    for fx, fw in (("int8", "int4"), ("e4m3", "e2m1"), ("e5m2", "int8")):
        for M in (17, 33, 64, 192):
            for n in (8, 16, 24, 32, 40, 48, 64, 128, 512):
                K = n * max(8, -(-384 // n))
                N = 77 if M % 2 else 130
                check_dense_matmul(torch, timer, gen, kind="fp", M=M, K=K,
                                   N=N, n=n, fx=fx, fw=fw, timed=False,
                                   label=f"bf16 M={M} K={K} N={N} n={n} "
                                         f"{fx} x {fw}")
        check_dense_matmul(torch, timer, gen, kind="fp", M=192, K=18944,
                           N=512, fx=fx, fw=fw, timed=False,
                           label=f"bf16 M=192 K=18944 N=512 {fx} x {fw}")
    for n in (64, 512):
        check_dense_matmul(torch, timer, gen, kind="fp", M=40, K=1024, N=77,
                           n=n, fx="int12", fw="int12", timed=False,
                           label=f"simt M=40 K=1024 N=77 n={n} int12")


def check_pad_copy(torch, timer, gen) -> dict:
    """``quant_matmul`` at a group length off the 32 grid (n = 56, packed
    int4) copies the stored codes into a zero-padded buffer (n_pad = 64)
    before its launch: that copy alone, timed at wi,wg, beside the bytes
    it moves.  Exact: the padded buffer holds the codes and zeros."""
    from repro_torch.kernels import quant_matmul as qm

    N, G, n = 18944, 64, 56
    codes = torch.randint(0, 256, (N, G, n // 2), generator=gen,
                          device="cuda", dtype=torch.uint8)
    padded = qm.pad_group_codes(codes, n, packed=True)
    ok = (padded.shape == (N, G, 32)
          and bool(torch.equal(padded[..., :n // 2], codes))
          and not bool(padded[..., n // 2:].any()))
    row = {"shape": f"pad copy wi,wg N={N} G={G} n={n} int4-packed",
           "max_abs_err": 0.0, "tol": 0.0, "ok": ok}
    row.update(bound_fields(nbytes(codes, padded), 0.0, PEAK_INT8_OPS))
    row["ms"] = timer(lambda: qm.pad_group_codes(codes, n, packed=True),
                      iters=10)
    log("  quant_matmul " + json.dumps(row))
    if not ok:
        raise SystemExit("the zero-padded copy of stored codes is wrong")
    return row


def phase_dense_kernels(torch, timer, gen) -> dict:
    """The fixed-slot path's kernels (abfp_matmul, abfp_matmul_int8,
    flash_attention) and abfp_qdq, at that path's shapes and ragged ones."""
    qdq = abfp_qdq_checks(torch, timer, gen)

    dense = {"fp": [], "int8": []}
    for kind in ("fp", "int8"):
        # decode (4 slots) and the longest prefill bucket (192 rows)
        for M in (4, 192):
            for name, K, N in DENSE_SHAPES:
                dense[kind].append(check_dense_matmul(
                    torch, timer, gen, kind=kind, M=M, K=K, N=N,
                    label=f"{name} M={M} K={K} N={N}"))
        for M in (1, 4):  # lm_head: prefill's last row, decode's 4 slots
            dense[kind].append(check_dense_matmul(
                torch, timer, gen, kind=kind, M=M, K=3584, N=152064,
                label=f"lm_head M={M} K=3584 N=152064"))
        for M in (64, 128):  # the other prefill buckets
            check_dense_matmul(torch, timer, gen, kind=kind, M=M, K=3584,
                               N=3584, label=f"q,o M={M}", timed=False)
        # ragged M and N; K = n (one group: int8 must be bit-exact)
        for M, K, N in ((13, 640, 77), (7, 64, 77), (33, 64, 130)):
            check_dense_matmul(torch, timer, gen, kind=kind, M=M, K=K, N=N,
                               label=f"ragged M={M} K={K} N={N}",
                               timed=False, exact=(kind == "int8"
                                                   and K == 64))
        torch.cuda.empty_cache()
    dense["fp"] += fp_decode_checks(torch, timer, gen)
    dense["int8"] += int8_decode_checks(torch, timer, gen)
    for at in ("M=4", "M=16", "M=192"):
        for kind, rows in dense.items():
            log(f"  {kind} forward pass at {at}: " + json.dumps(
                forward_pass_ms(rows, at)))
    for kind in dense:
        check_regimes(torch, gen, kind)
    mma_checks(torch, timer, gen)
    fp_prefill_checks(torch, timer, gen)
    torch.cuda.empty_cache()

    flash = []
    for S in (64, 128, 192):  # the prefill buckets: S = T, q_offset 0
        flash.append(check_flash(torch, timer, gen, S=S, T=S,
                                 label=f"prefill B=1 S=T={S} causal"))
    check_flash(torch, timer, gen, S=37, T=37, label="ragged S=T=37",
                timed=False)
    check_flash(torch, timer, gen, S=20, T=100, q_offset=80,
                label="suffix S=20 T=100 q_offset=80", timed=False)
    check_flash(torch, timer, gen, B=2, S=50, T=70, causal=False,
                label="non-causal B=2 S=50 T=70", timed=False)
    # the vision encoder's call: three 64-key tiles and a ragged fourth of
    # 5 keys, every row walks them all
    check_flash(torch, timer, gen, B=2, S=197, T=197, H=12, KV=12, D=64,
                causal=False, label="vit non-causal B=2 S=T=197 H=KV=12 "
                "D=64", timed=False)
    check_flash(torch, timer, gen, S=16, T=16, H=4, KV=2, D=16,
                label="reduced S=T=16 H=4 KV=2 D=16", timed=False)
    # a head dimension off the 16-byte copies (4-byte copies, D padded to
    # the 64-wide instantiation) with rows that see no key
    check_flash(torch, timer, gen, S=12, T=20, H=4, KV=2, D=37, q_offset=-4,
                label="odd D=37 q_offset=-4", timed=False)
    torch.cuda.empty_cache()
    return {"abfp_qdq": qdq, "abfp_matmul": dense["fp"],
            "abfp_matmul_int8": dense["int8"], "flash_attention": flash}


def attention_checks(torch, timer, gen) -> list:
    """``flash_attention_quant`` against its plain version at each shape,
    the kernel each call launches (profiler), the timed main-path shapes,
    and the route sweep; returns every check's row."""
    prefill = "attention_prefill_kernel"
    decode, long = "attention_decode_kernel", "attention_long_kernel"
    decode_long = "attention_decode_long_kernel"
    at = []

    def check(**kw):
        at.append(check_attention(torch, timer, gen, **kw))

    # main path: the exact body with the in-kernel probs QDQ (int8, n = 64)
    check(S=1, T=512, probs=True, fp8=False, block_k=0,
          q_starts=[100, 510, 37, -1], label="decode S=1 T=512 int8 exact",
          want_kernel=decode)
    check(S=64, T=512, probs=True, fp8=False, block_k=0,
          q_starts=[0, 448, 128, -1], label="prefill S=64 T=512 int8 exact",
          want_kernel=prefill)
    # the decode kernel at the main path's contexts (41-165 tokens: most
    # ranges skipped), fp8 codes, no probs QDQ, a window, the front end's
    # longest exact body, 128-key groups (ranges of 128 keys, clusters of
    # 4), a ragged T (a last range of 8 keys)
    check(S=1, T=512, probs=True, fp8=False, block_k=0,
          q_starts=[160, 41, 100, -1],
          label="main-path contexts S=1 T=512 int8 exact",
          want_kernel=decode)
    check(S=1, T=512, probs=True, fp8=True, block_k=0,
          q_starts=[100, 510, 37, -1], label="decode S=1 T=512 fp8 exact",
          timed=False, want_kernel=decode)
    check(S=1, T=512, probs=False, fp8=False, block_k=0,
          q_starts=[100, 510, 37, -1],
          label="decode S=1 T=512 int8 exact no-qdq", timed=False,
          want_kernel=decode)
    check(S=1, T=512, probs=True, fp8=False, block_k=0,
          q_starts=[100, 510, 37, -1], window=100,
          label="decode S=1 T=512 int8 exact window=100", timed=False,
          want_kernel=decode)
    check(S=1, T=2048, probs=True, fp8=False, block_k=0,
          q_starts=[2000, 700, 37, -1], label="decode S=1 T=2048 int8 exact",
          timed=False, want_kernel=decode)
    check(S=1, T=512, probs=True, fp8=False, block_k=0, probs_n=128,
          q_starts=[100, 510, 300, -1],
          label="decode S=1 T=512 int8 exact probs n=128", timed=False,
          want_kernel=decode)
    check(S=1, T=200, probs=False, fp8=False, block_k=0,
          q_starts=[199, 41, 150, -1], label="decode S=1 T=200 int8 exact",
          timed=False, want_kernel=decode)
    # off the main path: a non-causal chunk and the two long bodies
    check(S=5, T=512, probs=False, fp8=False, block_k=0,
          q_starts=[100, 400, 37, -1], causal=False,
          label="chunk S=5 T=512 int8 exact non-causal", timed=False,
          want_kernel=prefill)
    check(S=1, T=4096, probs=False, fp8=False, block_k=512,
          q_starts=[4000, 700, 37, -1],
          label="decode S=1 T=4096 int8 online", timed=False,
          want_kernel=decode_long)
    check(S=1, T=4096, probs=True, fp8=False, block_k=512,
          q_starts=[4000, 700, 37, -1],
          label="decode S=1 T=4096 int8 phased", timed=False,
          want_kernel=decode_long)
    check(S=5, T=4096, probs=True, fp8=True, block_k=512,
          q_starts=[4000, 700, 37, -1], label="chunk S=5 T=4096 fp8 phased",
          timed=False, want_kernel=long)
    # the long path's decode step: phased at T = 8192 (bk = 512), rows
    # part-way through its prompts and a finished slot; timed beside
    # attention_kernel forced onto the same call
    check(S=1, T=8192, probs=True, fp8=False, block_k=512,
          q_starts=[6007, 4107, 2507, -1],
          label="long decode S=1 T=8192 int8 phased", want_kernel=decode_long)
    # ... and beyond it: early rows (most units unseen), fp8, a window
    # (every row's first units masked), 32-, 128- and 48-key probs groups
    # (units of 128 and 192 keys; T = 8160 a ragged last tile), the
    # online body, the exact body at T = 8192 (bk = T), and Qwen2-7B's
    # whole context (T = 32,768)
    check(S=1, T=8192, probs=True, fp8=False, block_k=512,
          q_starts=[4000, 700, 37, -1],
          label="long decode S=1 T=8192 int8 phased early rows",
          want_kernel=decode_long)
    check(S=1, T=8192, probs=True, fp8=True, block_k=512,
          q_starts=[6007, 4107, 2507, -1], timed=False,
          label="long decode S=1 T=8192 fp8 phased", want_kernel=decode_long)
    check(S=1, T=8192, probs=True, fp8=False, block_k=512,
          q_starts=[6007, 4107, 2507, -1], window=100, timed=False,
          label="long decode S=1 T=8192 int8 phased window=100",
          want_kernel=decode_long)
    for n in (32, 128):
        check(S=1, T=8192, probs=True, fp8=False, block_k=512, probs_n=n,
              q_starts=[6007, 4107, 2507, -1], timed=False,
              want_kernel=decode_long,
              label=f"long decode S=1 T=8192 int8 phased probs n={n}")
    check(S=1, T=8160, probs=True, fp8=False, block_k=480, probs_n=48,
          q_starts=[6007, 4107, 2507, -1], timed=False,
          want_kernel=decode_long,
          label="long decode S=1 T=8160 int8 phased probs n=48")
    check(S=1, T=8192, probs=False, fp8=False, block_k=512,
          q_starts=[6007, 4107, 2507, -1],
          label="long decode S=1 T=8192 int8 online", want_kernel=decode_long)
    check(S=1, T=8192, probs=True, fp8=False, block_k=0,
          q_starts=[6007, 4107, 2507, -1],
          label="long decode S=1 T=8192 int8 exact", want_kernel=decode_long)
    check(S=1, T=32768, probs=True, fp8=False, block_k=512,
          q_starts=[30000, 16000, 2507, -1],
          label="long decode S=1 T=32768 int8 phased",
          want_kernel=decode_long)
    # the prefill kernel beyond the main path: fp8, no probs QDQ, a window,
    # ragged T (a partial last tile), 32- and 128-key probs groups
    check(S=64, T=512, probs=True, fp8=True, block_k=0,
          q_starts=[0, 448, 128, -1], label="prefill S=64 T=512 fp8 exact",
          timed=False, want_kernel=prefill)
    check(S=64, T=512, probs=False, fp8=False, block_k=0,
          q_starts=[0, 448, 128, -1], window=100,
          label="prefill S=64 T=512 int8 exact no-qdq window=100",
          timed=False, want_kernel=prefill)
    check(S=37, T=200, probs=False, fp8=False, block_k=0,
          q_starts=[0, 163, 90, -1],
          label="chunk S=37 T=200 int8 exact no-qdq", timed=False,
          want_kernel=prefill)
    for n in (32, 128):
        check(S=64, T=512, probs=True, fp8=False, block_k=0,
              q_starts=[0, 448, 128, -1], probs_n=n, want_kernel=prefill,
              timed=False, label=f"prefill S=64 T=512 int8 exact probs n={n}")
    # the long-context chunk: the paged path's call at max_len 8192 (the
    # phased body, bk = 512; rows at the end, middle and start of the
    # context and a dead row), the same call with most units unseen, the
    # exact body past the prefill kernel's score rows, the online body
    check(S=64, T=8192, probs=True, fp8=False, block_k=512,
          q_starts=[8128, 5000, 2000, -1],
          label="long S=64 T=8192 int8 phased", want_kernel=long)
    check(S=64, T=8192, probs=True, fp8=False, block_k=512,
          q_starts=[4000, 700, 37, -1],
          label="long S=64 T=8192 int8 phased early rows", want_kernel=long)
    for T in (1024, 2048):
        check(S=64, T=T, probs=True, fp8=False, block_k=0,
              q_starts=[T - 64, T // 2, 37, -1],
              label=f"long S=64 T={T} int8 exact", want_kernel=long)
    check(S=64, T=4096, probs=False, fp8=False, block_k=512,
          q_starts=[4032, 2000, 37, -1], label="long S=64 T=4096 int8 online",
          want_kernel=long)
    # ... and beyond it: fp8, a window (every row's first units masked),
    # 32- and 128-key probs groups, a ragged chunk, a non-causal chunk
    check(S=64, T=8192, probs=True, fp8=True, block_k=512,
          q_starts=[8128, 5000, 2000, -1], timed=False,
          label="long S=64 T=8192 fp8 phased", want_kernel=long)
    check(S=64, T=8192, probs=True, fp8=False, block_k=512,
          q_starts=[8128, 5000, 2000, -1], window=100, timed=False,
          label="long S=64 T=8192 int8 phased window=100", want_kernel=long)
    for n in (32, 128):
        check(S=64, T=4096, probs=True, fp8=False, block_k=512, probs_n=n,
              q_starts=[4032, 2000, 37, -1], timed=False, want_kernel=long,
              label=f"long S=64 T=4096 int8 phased probs n={n}")
    check(S=37, T=2048, probs=True, fp8=False, block_k=0,
          q_starts=[2011, 700, 0, -1], timed=False, want_kernel=long,
          label="long S=37 T=2048 int8 exact")
    check(S=16, T=4096, probs=False, fp8=False, block_k=512, causal=False,
          q_starts=[4000, 700, 37, -1], timed=False, want_kernel=long,
          label="long S=16 T=4096 int8 online non-causal")
    attention_route_sweep(torch, timer, gen)
    return at


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
    mm += quant_decode_checks(torch, timer, gen)
    in_situ = quant_decode_in_situ(torch, gen)
    for r in mm:
        name = r["shape"].split(" ")[0]
        if r["M"] == 4 and r["shape"] == (
                f"{name} M=4 K={r['K']} N={r['N']} int4-packed") and (
                name in in_situ):
            r["ms_in_situ"] = in_situ[name]["planned"]
    # decode steps (4 and 16 slots); a prefill chunk (no lm_head)
    for at in ("M=4", "M=16", "M=256"):
        log(f"  quant_matmul forward pass at {at}: "
            + json.dumps(forward_pass_ms(mm, at)))
    check_regimes(torch, gen, "quant")
    # off the main path: a group length off the 32 grid (the stored codes
    # copied into a zero-padded buffer, then the call), plain int8 codes
    # (8-bit rules), ragged M and N
    mm.append(check_pad_copy(torch, timer, gen))
    mm.append(check_quant_matmul(
        torch, timer, gen, M=4, K=3584, N=18944, n=56, packed=True,
        label="n=56 wi,wg at M=4: K=3584 N=18944 int4-packed"))
    check_quant_matmul(torch, timer, gen, M=4, K=3584, N=512, packed=False,
                       label="int8 codes M=4 K=3584 N=512", timed=False)
    check_quant_matmul(torch, timer, gen, M=13, K=640, N=77, packed=True,
                       label="ragged M=13 K=640 N=77 int4-packed",
                       timed=False)
    check_quant_matmul(torch, timer, gen, M=7, K=640, N=77, packed=False,
                       label="ragged M=7 K=640 N=77 int8", timed=False)
    torch.cuda.empty_cache()

    at = attention_checks(torch, timer, gen)
    torch.cuda.empty_cache()
    report = {"quant_matmul": mm, "flash_attention_quant": at,
              **phase_dense_kernels(torch, timer, gen),
              "profiler_retries": {"count": len(PROFILER_RETRIES),
                                   "captures": list(PROFILER_RETRIES)}}
    log("  profiler captures taken again: "
        + json.dumps(report["profiler_retries"]))
    return report


# --------------------------------------------------------------------------
# phase: lint
# --------------------------------------------------------------------------
# pre-flight gates passed, by launcher (``count_gates``)
GATES: dict = {}


def count_gates() -> None:
    """Count the launchers' passes through ``preflight`` by ``where``: the
    launchers import it from ``repro_torch.launch.lint`` when they run, so
    the counting wrapper is the one they call.  A blocked launch raises
    before it is counted."""
    from repro_torch.launch import lint as lint_cli

    preflight = lint_cli.preflight
    if getattr(preflight, "counted", False):
        return

    def counted(*args, where="launch", **kw):
        preflight(*args, where=where, **kw)
        GATES[where] = GATES.get(where, 0) + 1

    counted.counted = True
    lint_cli.preflight = counted


# (wrapper, its plain kernel kind, the longest group a block holds, the
# shortest it refuses): quantize_cols_kernel's tile of a group must fit in
# a block's shared memory (plan_abfp_matmul)
LINT_GROUPS = (("abfp_matmul", "fp", 1200, 1216),
               ("abfp_matmul_int8", "int8", 1440, 1456))
LINT_M, LINT_N = 256, 4096  # a paged prefill chunk's rows; K = 4 n


def lint_site(n: int, kind: str) -> list:
    """qlint's QL303 findings at one fused w4a8 site of (K, N) = (4 n,
    LINT_N) with LINT_M rows (``kind`` "int8": compute='int8')."""
    from repro_torch.analysis.kernel_lint import lint_kernels
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.core.policy import preset

    pol = preset("w4a8_abfp", n=n).replace(fused=True)
    if kind == "int8":
        pol = pol.replace(compute="int8")
    return [d for d in lint_kernels(
        get_config("qwen2-7b"), pol, [("blocks.0/ffn/wi", 4 * n, LINT_N, 1)],
        compress=False, shape=ShapeSpec("lint", 1, LINT_M, "decode"))
        if d.code == "QL303"]


def lint_boundaries(torch, timer, gen) -> tuple:
    """(a): at the longest group each fused kernel's block holds the lint is
    clean and the kernel launches once a call (counted) and matches its
    plain version; one group step past it QL303 fires and the wrapper
    raises the same text before any launch."""
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import quant_matmul as qm

    rows, found = {}, []
    for name, kind, clean, refused in LINT_GROUPS:
        fn = getattr(qm, name)
        for n in (clean, refused):
            diags = lint_site(n, kind)
            x = activations(torch, gen, (LINT_M, 4 * n))
            w = torch.randn((4 * n, LINT_N), generator=gen, device="cuda")
            before = fn.launches
            try:
                fn(x, w, get_format("int8"), get_format("int4"), n=n)
                torch.cuda.synchronize()
                raised = None
            except ValueError as e:
                raised = str(e)
            out = {"wrapper": name, "n": n, "M": LINT_M, "K": 4 * n,
                   "N": LINT_N, "ql303": [d.message for d in diags],
                   "raised": raised, "launches": fn.launches - before}
            found.append(out)
            log("  " + json.dumps(out))
            if diags:
                if raised != diags[0].message or out["launches"]:
                    raise SystemExit(f"lint: QL303 fired at {name} n={n} "
                                     f"but the wrapper {out}")
                continue
            if raised is not None or out["launches"] != 1:
                raise SystemExit(f"lint: {name} n={n} linted clean but "
                                 f"{out}")
            rows.setdefault(name, []).append(check_dense_matmul(
                torch, timer, gen, kind=kind, M=LINT_M, K=4 * n, N=LINT_N,
                n=n, label=f"longest group n={n} M={LINT_M} K={4 * n} "
                f"N={LINT_N}"))
        if [bool(f["ql303"]) for f in found[-2:]] != [False, True]:
            raise SystemExit(f"lint: {name}'s boundary moved: {found[-2:]}")
    return rows, found


def lint_gate_blocks(torch) -> dict:
    """(b): a launch the gate refuses allocates nothing on the card."""
    import contextlib
    import io

    from repro_torch.launch import serve as tserve

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    err = io.StringIO()
    code = None
    with contextlib.redirect_stderr(err):
        try:
            tserve.main(["--arch", "qwen2-7b", "--full", "--paged",
                         "--n-pages", "1"])
        except SystemExit as e:
            code = e.code
    torch.cuda.synchronize()
    out = {"exit_code": code, "ql305": "QL305" in err.getvalue(),
           "allocated_before": before,
           "allocated_after": torch.cuda.memory_allocated()}
    log("  launch/serve --arch qwen2-7b --full --paged --n-pages 1: "
        + json.dumps(out))
    if not (code == 2 and out["ql305"]
            and out["allocated_after"] == before):
        raise SystemExit(f"lint: the gate did not block the one-page pool "
                         f"before allocating: {out} {err.getvalue()}")
    return out


def phase_lint(torch, seed: int, smi: str) -> dict:
    import contextlib
    import io

    from repro_torch.launch import lint as lint_cli

    log("== lint: QL303 at the kernels' own shared-memory boundaries, the "
        "pre-flight gate on the card, the --all sweep")
    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 32)
    rows, found = lint_boundaries(torch, Timer(torch), gen)
    torch.cuda.empty_cache()
    report = {"kernel_rows": rows, "boundaries": found,
              "gate": lint_gate_blocks(torch)}
    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = lint_cli.run_sweep(True, os.path.join(
            ROOT, "build", "lint_all.json"), False)
    summary = json.loads(out.getvalue())
    report["sweep"] = dict(summary, rc=rc,
                           seconds=time.perf_counter() - t0)
    log(f"  --all sweep on {smi}: " + json.dumps(report["sweep"]))
    if rc != 0 or not summary["ok"]:
        raise SystemExit(f"lint: the --all sweep found errors: {summary}")
    report["phase_s"] = time.perf_counter() - t_phase
    return report


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


def _wrappers() -> dict:
    import importlib

    return {name: getattr(importlib.import_module(
        f"repro_torch.kernels.{mod}"), name)
        for name, (mod, _) in KERNELS.items()}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0
        by_kernel = getattr(fn, "launches_by_kernel", {})
        for k in by_kernel:
            by_kernel[k] = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def read_kernel_counts(name: str) -> dict:
    """Launches of each kernel of wrapper ``name`` (``flash_attention_quant``:
    attention_kernel, attention_prefill_kernel, attention_decode_kernel,
    attention_long_kernel, attention_decode_long_kernel;
    ``flash_attention``: flash_mma_kernel)."""
    return dict(_wrappers()[name].launches_by_kernel)


def no_attention_kernel(label: str) -> None:
    """Fails if the run counted since ``reset_counts`` launched PR 11's
    ``attention_kernel``: every call of a model path has a redesigned
    kernel."""
    n = read_kernel_counts("flash_attention_quant")["attention_kernel"]
    if n:
        raise SystemExit(f"{label}: attention_kernel launched {n} times")


def build_engine(torch, cfg, seed: int, kernel_path: bool, trace=None,
                 perturb: bool = False, max_len: int = 512, model=None,
                 params=None, policy=None, expert_cache=None):
    """Model with random weights from ``seed`` on the card -> engine with
    compressed weights and int8 pages; the dense tree is freed (unless the
    caller passes ``model`` and ``params`` and keeps them).  With a
    ``trace`` dict, the logits row behind every emitted token is kept on
    the card under its request's uid, in emission order.  ``perturb``
    scales the embedding table by 1 + 2**-20: RMSNorm undoes the scale up
    to rounding, so the model is the same function fed last-bit noise.
    ``policy``: in place of ``slice_policy``; ``expert_cache``: the MoE
    expert store's capacity."""
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

    if model is None:
        model = build_model(cfg)  # device="cuda" by default
        params = model.init(make_generator(seed, "cuda"))
    if perturb:
        params["embed"]["table"] *= 1.0 + 2.0 ** -20
    eng = Engine(model, params, n_slots=4, max_len=max_len, page_size=16,
                 policy=policy or slice_policy(kernel_path), compress=True,
                 kv="int8", expert_cache=expert_cache)
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
    if hasattr(eng, "page_stats"):
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
    by_kernel = read_kernel_counts("flash_attention_quant")
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
    stray = {k: v for k, v in counts.items() if k not in per_step and v}
    if stray:
        raise SystemExit(f"serve: kernels off this path launched: {stray}")
    # attention: the prefill kernel on every chunk step, the decode kernel
    # on every decode step, attention_kernel and the long kernels on none
    from repro_torch.kernels.flash_attention_quant import PREFILL_MIN_S

    chunks = sum(1 for s, _ in eng.step_ms if s >= PREFILL_MIN_S)
    want = {"attention_kernel": 0, "attention_long_kernel": 0,
            "attention_decode_long_kernel": 0,
            "attention_decode_kernel": cfg.n_layers * (eng.steps - chunks),
            "attention_prefill_kernel": cfg.n_layers * chunks}
    if by_kernel != want or not chunks or chunks == eng.steps:
        raise SystemExit(f"serve: attention kernels launched {by_kernel} in "
                         f"{chunks} chunk and {eng.steps - chunks} decode "
                         f"steps, expected {want}")
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
        "launches_by_kernel": by_kernel,
        "page_stats": eng.page_stats(), "kv_bytes_first_tick": kv_bytes,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    log("  " + json.dumps(report))
    report["profile"] = profile_decode(
        torch, cfg, eng, seed, report["step_ms_median"]["decode"])
    report["prefill_profile"] = profile_paged_prefill(torch, cfg, eng, seed)
    return report


# the long phase: prompt lengths (random ids from the seed), new tokens
# the depth of qwen2-7b in phases long and fixed, cut to keep the whole
# script near half its time limit (serve runs all 28 layers)
QWEN_CUT_LAYERS = 14
LONG_PROMPTS = (6000, 4100, 2500, 1100)
LONG_NEW = 8
LONG_MAX_LEN = 8192
LONG_PROFILED_KEYS = 4000  # the profiled chunk step has a row past this


def phase_long(torch, seed: int) -> dict:
    """Paged serving of qwen2-7b at published width and QWEN_CUT_LAYERS of
    its 28 layers with max_len 8192 (so T = 8192 in every attention call):
    4 greedy requests of ``LONG_PROMPTS`` tokens.  Asserted: one
    ``flash_attention_quant`` launch a layer a step, ``attention_long_kernel`` on every chunk step,
    ``attention_decode_long_kernel`` on every decode step (the phased body
    at S = 1), ``attention_kernel`` and both exact kernels on none.  After
    the counted run, one long chunk step (a row past 4,000 seen keys) and
    one decode step are replayed from a copy of their state, timed and
    profiled (the parent's route on the same chunk step:
    ``scripts/attention_long_times.py``)."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention_quant as faq
    from repro_torch.serve.engine import Request

    cfg = get_config("qwen2-7b")
    log(f"== long: qwen2-7b, full width, max_len {LONG_MAX_LEN}")
    log(f"  cut: qwen2-7b runs {QWEN_CUT_LAYERS} of its {cfg.n_layers} "
        "layers")
    cfg = cfg.replace(n_layers=QWEN_CUT_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = build_engine(torch, cfg, seed, kernel_path=True,
                       max_len=LONG_MAX_LEN)
    rng = np.random.RandomState(seed + 5)
    reqs = [Request(uid=3000 + i, max_new_tokens=LONG_NEW,
                    prompt=rng.randint(0, cfg.vocab, size=n).astype(np.int32))
            for i, n in enumerate(LONG_PROMPTS)]
    for r in reqs:
        eng.submit(r)

    # the state before the first chunk step in which a row has seen more
    # than 4,000 keys, and before the first decode step after it
    snaps = {}
    inner = eng._paged_step

    def paged_step(params, tokens, state, n_valid):
        kind = "chunk" if tokens.shape[1] > 1 else "decode"
        if kind not in snaps and (kind == "decode") == ("chunk" in snaps):
            ctx = [eng._pf_pos[s] + int(eng.prefilling[s]) * tokens.shape[1]
                   if kind == "chunk" else eng._pf_pos[s]
                   for s in range(eng.n_slots)]
            if max(ctx) > LONG_PROFILED_KEYS:
                snaps[kind] = (tokens, clone_state(state), n_valid, max(ctx))
        return inner(params, tokens, state, n_valid)

    eng._paged_step = paged_step
    reset_counts()
    t0 = time.perf_counter()
    while eng._has_work():
        eng.tick()
        if eng.ticks > 2000:
            raise SystemExit("long phase did not drain in 2000 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    by_kernel = read_kernel_counts("flash_attention_quant")
    eng._paged_step = inner
    done = eng.done
    if sorted(c.uid for c in done) != [r.uid for r in reqs]:
        raise SystemExit(f"long: not every request completed: "
                         f"{sorted(c.uid for c in done)}")
    for c in done:
        if len(c.tokens) != LONG_NEW or c.finished_reason != "length" or \
                not all(0 <= t < cfg.vocab for t in c.tokens):
            raise SystemExit(f"long: request {c.uid}: {c.tokens}, reason "
                             f"{c.finished_reason}")
    st = eng.page_stats()
    if st["page_allocs"] != st["page_frees"] or st["pages_in_use"]:
        raise SystemExit(f"long: page accounting does not balance: {st}")
    chunks = sum(1 for s, _ in eng.step_ms if s >= faq.PREFILL_MIN_S)
    decodes = eng.steps - chunks
    want_chunks = max(-(-n // 64) for n in LONG_PROMPTS)
    per_step = {"quant_matmul": 7 * cfg.n_layers + 1,
                "flash_attention_quant": cfg.n_layers}
    for name, n in per_step.items():
        if counts[name] != n * eng.steps:
            raise SystemExit(f"long: {name}: {counts[name]} launches in "
                             f"{eng.steps} steps, expected {n} per step")
    stray = {k: v for k, v in counts.items() if k not in per_step and v}
    want = {"attention_kernel": 0, "attention_prefill_kernel": 0,
            "attention_decode_kernel": 0,
            "attention_decode_long_kernel": cfg.n_layers * decodes,
            "attention_long_kernel": cfg.n_layers * chunks}
    if stray or by_kernel != want or chunks != want_chunks or not decodes:
        raise SystemExit(f"long: attention kernels launched {by_kernel} in "
                         f"{chunks} chunk and {decodes} decode steps "
                         f"(expected {want} in {want_chunks} chunk steps); "
                         f"other kernels {stray}")
    n_tok = sum(len(c.tokens) for c in done)
    by_kind = {"decode": [ms for s, ms in eng.step_ms if s == 1],
               "chunk": [ms for s, ms in eng.step_ms if s > 1]}
    report = {
        "requests": len(done), "prompt_lens": list(LONG_PROMPTS),
        "generated_tokens": n_tok, "ticks": eng.ticks, "steps": eng.steps,
        "step_counts": {k: len(v) for k, v in by_kind.items()},
        "wall_s": wall, "tokens_per_s": n_tok / wall,
        "prompt_tokens_per_s": sum(LONG_PROMPTS) / wall,
        "step_ms_median": {k: statistics.median(v)
                           for k, v in by_kind.items()},
        "launches": counts, "launches_per_step": per_step,
        "launches_by_kernel": by_kernel,
        "kv_pool_bytes": sum(t.numel() * t.element_size()
                             for c in eng.state.pages.cache for t in c
                             if t is not None),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        # pass 1's stored scores, allocated by each chunk step's calls
        "long_scratch_bytes_per_call": faq.long_scratch_bytes(
            faq.plan_attention(eng.n_slots, 64, LONG_MAX_LEN, cfg.n_heads,
                               cfg.n_kv, cfg.head_dim, 512, 64)),
    }
    log("  " + json.dumps(report))

    # replays, outside the counted run: one chunk step, one decode step,
    # each timed once warm, then profiled
    profiles = {}
    for kind, (tokens, state, n_valid, ctx) in snaps.items():
        for _ in range(2):  # warm, then the timed run
            fresh = clone_state(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            inner(eng.params, tokens, fresh, n_valid)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated() - start
        fresh = clone_state(state)
        out = profile_steps(
            torch, lambda: inner(eng.params, tokens, fresh, n_valid), 1, ms,
            kind, watch=tuple(ATTENTION_KERNELS))
        out["max_keys_seen"] = ctx
        out["peak_memory_above_start_bytes"] = peak
        profiles[kind] = out
        log(f"  {kind} step profile: " + json.dumps(out))
    report["profiles"] = profiles
    # the replayed decode step: its attention (a launch a layer of the
    # decode kernel for long contexts) and its device time
    dec = profiles.get("decode", {})
    report["decode_step"] = {
        "attention_ms": dec.get("watched_kernels_per_step", {}).get(
            "attention_decode_long_kernel", {}).get("ms", "not measured"),
        "busy_ms": dec.get("device_busy_ms_per_step", "not measured"),
        "wall_ms_unprofiled": dec.get("decode_step_ms_unprofiled")}
    log("  replayed decode step: " + json.dumps(report["decode_step"]))
    return report


def long_requests(cfg, seed: int, n: int, length: int, uid0: int = 1000):
    """``n`` requests of ``length`` random prompt tokens and 2 new tokens."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.RandomState(seed)
    return [Request(uid=uid0 + i, max_new_tokens=2,
                    prompt=rng.randint(0, cfg.vocab, size=length).astype(
                        np.int32))
            for i in range(n)]


def profile_paged_prefill(torch, cfg, eng, seed: int) -> dict:
    """Where a paged prefill step's time goes (after the counted run): four
    prompts of 256 tokens fill every slot, so each step is one 64-token
    chunk a slot (M = 256 rows in every matmul).  The first chunk is timed
    without the profiler, the next two are profiled."""
    for r in long_requests(cfg, seed + 2, eng.n_slots, 256):
        eng.submit(r)
    eng._admit()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._prefill_tick()  # ends in a host copy: synchronized
    step_ms = (time.perf_counter() - t0) * 1e3
    out = profile_steps(torch, eng._prefill_tick, 2, step_ms, "prefill")
    eng.run_until_done(max_ticks=2000)
    log("  prefill profile: " + json.dumps(out))
    return out


def profile_fixed_prefill(torch, cfg, eng, seed: int) -> dict:
    """Where one fixed-slot prefill of 192 rows goes (after the counted
    run): a 180-token prompt, padded to the 192 bucket, admitted once
    without the profiler (its wall time) and once under it."""
    def admit(uid0):
        eng.submit(long_requests(cfg, seed + 2, 1, 180, uid0)[0])
        torch.cuda.synchronize()
        eng._admit()  # prefill, first token (a host copy), slot insert
        torch.cuda.synchronize()

    t0 = time.perf_counter()
    admit(2000)
    step_ms = (time.perf_counter() - t0) * 1e3
    out = profile_steps(torch, lambda: admit(2001), 1, step_ms, "prefill",
                        watch=tuple(FLASH_KERNELS))
    eng.run_until_done(max_ticks=2000)
    log("  prefill profile: " + json.dumps(out))
    return out


PROFILE_NEW = 10


def profile_decode(torch, cfg, eng, seed: int, step_ms: float,
                   watch: tuple = ()) -> dict:
    """Where a decode step's time goes: a few steady decode steps of the
    engine under ``torch.profiler`` (after the counted run; its launches
    are not part of the reported counts); ``watch`` as for
    ``profile_steps``."""
    for r in make_requests(cfg, seed + 1)[:4]:
        # enough tokens for the steps before every slot decodes and the
        # profiled ones: the rest of the requests' 16 is not needed
        r.max_new_tokens = PROFILE_NEW
        eng.submit(r)
    busy = (lambda: eng.prefilling.any()) if hasattr(eng, "prefilling") \
        else (lambda: False)
    while busy() or eng.queue or not eng.active.any():
        eng.tick()  # prompts in, every slot decoding
    step = getattr(eng, "_decode_tick", eng.tick)
    out = profile_steps(torch, step, 4, step_ms, watch=watch)
    eng.run_until_done(max_ticks=2000)
    log("  profile: " + json.dumps(out))
    return out


def lead_spins(torch, n: int = 64) -> None:
    """``n`` one-cycle spin kernels: late in a whole run of this script the
    profiler has dropped the first launches of a capture (on an H100: the
    first 12 of a 614-launch ViT forward, in two captures in a row), so a
    capture that must read every launch starts with these (``spin_kernel``,
    no role's name)."""
    for _ in range(n):
        torch.cuda._sleep(1)


def profile_steps(torch, step, n_steps: int, step_ms: float,
                  kind: str = "decode", watch: tuple = (),
                  lead: bool = False) -> dict:
    """``n_steps`` calls of ``step`` (a ``kind`` step) under
    ``torch.profiler``: operator calls, device busy time and kernel
    launches per step, the device's idle share against ``step_ms`` (a
    step's wall time measured WITHOUT the profiler, whose own cost
    stretches the host side), top kernels, and the device ms and
    launches per step of each kernel whose name holds a ``watch`` entry
    (0 where none ran).  ``lead``: ``lead_spins`` first, left out of
    every figure."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if lead:
            lead_spins(torch)
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernel rows only: an operator row repeats its kernels' device time;
    # names without "void " and namespaces, so 60 characters show the
    # template arguments
    dev = sorted(((e.key.replace("void ", "").replace(
                       "(anonymous namespace)::", ""),
                   e.self_device_time_total / 1e3, e.count)
                  for e in events
                  if e.device_type == DeviceType.CUDA
                  and e.self_device_time_total > 0
                  and not (lead and "spin_kernel" in e.key)),
                 key=lambda d: -d[1])
    busy_ms = sum(d[1] for d in dev) / n_steps
    out = {f"{kind}_steps_profiled": n_steps,
           "aten_ops_per_step": sum(
               e.count for e in events
               if e.key.startswith("aten::")) / n_steps,
           f"{kind}_step_ms_unprofiled": step_ms}
    if busy_ms <= 0:
        out["device_time"] = "not measured (the profiler saw no device time)"
    else:
        out["device_busy_ms_per_step"] = busy_ms
        out["device_kernel_launches_per_step"] = sum(
            d[2] for d in dev) / n_steps
        out["device_idle_share"] = max(0.0, 1.0 - busy_ms / step_ms)
        out["top_device_kernels_ms_per_step"] = [
            {"name": k[:60], "ms": ms / n_steps, "launches": c / n_steps}
            for k, ms, c in dev[:12]]
        watched = {w: [0.0, 0] for w in watch}
        for k, ms, c in dev:
            base = k.split("(")[0].split("<")[0]  # no arguments
            for w in watch:
                if base.endswith(w):
                    watched[w][0] += ms
                    watched[w][1] += c
        out["watched_kernels_per_step"] = {
            w: {"ms": ms / n_steps, "launches": c / n_steps}
            for w, (ms, c) in watched.items()}
    return out


# --------------------------------------------------------------------------
# phase: fixed
# --------------------------------------------------------------------------
# policy of each fixed-slot path -> the matmul kernel it runs
FIXED_PATHS = {"p_int8": "abfp_matmul_int8", "p_fp": "abfp_matmul"}


def fixed_policy(kind: str, n: int = 64, base: str = "w4a8_abfp"):
    """P-int8: w4a8_int8_native; P-fp: ``base`` (w4a8_abfp) without
    attention-BMM QDQ; both with ``fused`` on every entry and the ``fused``
    attention backend.  'compress': w4a8_abfp with an int8 ring cache, ``fused`` and
    the ``compressed`` attention backend (served with compressed weights)."""
    from repro_torch.core.policy import (map_policies, preset,
                                         with_attn_backend, with_kv_cache)

    fused = lambda p: map_policies(p, lambda q: q.replace(fused=True))
    if kind == "compress":
        pol = with_kv_cache(preset("w4a8_abfp", n=n), "int8")
        return with_attn_backend(fused(pol), "compressed")
    if kind == "p_int8":
        pol = preset("w4a8_int8_native", n=n)
    else:
        pol = map_policies(preset(base, n=n),
                           lambda q: q.replace(attn_bmm=False))
    return with_attn_backend(fused(pol), "fused")


class TimedModel:
    """A model facade that keeps the wall time of every prefill (between
    two synchronizations), for the fixed-slot engine's report."""

    def __init__(self, model, torch):
        self._model = model
        self._torch = torch
        self.prefill_ms = []

    def __getattr__(self, name):
        return getattr(self._model, name)

    def prefill(self, *args, **kw):
        self._torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self._model.prefill(*args, **kw)
        self._torch.cuda.synchronize()
        self.prefill_ms.append((time.perf_counter() - t0) * 1e3)
        return out


def fixed_engine(model, params, policy, trace=None, **kw):
    """A ``ServeEngine`` that keeps the wall time of every decode step and,
    with a ``trace`` dict, the logits row behind every emitted token under
    its request's uid, in emission order."""
    from repro_torch.serve.engine import ServeEngine

    vocab = model.cfg.vocab

    class Engine(ServeEngine):
        def _first_token(self, slot, req, logits):
            if trace is not None:
                trace.setdefault(req.uid, []).append(
                    logits[0, :vocab].clone())
            return super()._first_token(slot, req, logits)

        def _sample(self, logits):
            if trace is not None:
                for s in range(self.n_slots):
                    if self.active[s]:
                        trace.setdefault(self.req[s].uid, []).append(
                            logits[s, :vocab].clone())
            return super()._sample(logits)

        def _decode(self):
            t0 = time.perf_counter()
            out = super()._decode()  # ends in a host copy: synchronized
            self.decode_ms.append((time.perf_counter() - t0) * 1e3)
            return out

    eng = Engine(model, params, policy=policy, **kw)
    eng.decode_ms = []
    return eng


def phase_fixed(torch, seed: int) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator

    log("== fixed: qwen2-7b, full width, dense f32 weights, fixed-slot "
        "engine")
    cfg = get_config("qwen2-7b")
    log(f"  cut: qwen2-7b runs {QWEN_CUT_LAYERS} of its {cfg.n_layers} "
        "layers")
    cfg = cfg.replace(n_layers=QWEN_CUT_LAYERS)
    L = cfg.n_layers
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(make_generator(seed, "cuda"))
    torch.cuda.synchronize()
    dense = sum(t.numel() * t.element_size() for t in _leaves(params))
    log(f"  dense model built in {time.perf_counter() - t0:.1f} s: "
        f"{dense} bytes of f32 parameters")
    reports = {}
    for kind, mm in FIXED_PATHS.items():
        timed = TimedModel(model, torch)
        eng = fixed_engine(timed, params, fixed_policy(kind), n_slots=4,
                           max_len=512, prefill_bucket=64)
        reqs = make_requests(cfg, seed)
        for r in reqs:
            eng.submit(r)
        reset_counts()
        t0 = time.perf_counter()
        while eng._has_work():
            eng.tick()
            if eng.ticks > 2000:
                raise SystemExit("fixed phase did not drain in 2000 ticks")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        done = eng.done
        check_completions(cfg, eng, done, reqs)
        # a forward pass (prefill or decode tick) runs 7 matmuls per layer
        # and lm_head through the matmul kernel; a prefill runs one flash
        # attention call per layer; decode attention is the plain
        # reference path, as in the reference package
        passes = eng.prefills + eng.ticks
        want = {mm: (7 * L + 1) * passes, "flash_attention": L * eng.prefills}
        for name, n in want.items():
            if counts[name] != n or n == 0:
                raise SystemExit(
                    f"fixed {kind}: {name} launched {counts[name]} times in "
                    f"{eng.prefills} prefills + {eng.ticks} decode ticks, "
                    f"expected {n}")
        # every prefill's attention: L launches of the tensor-core kernel
        flash_by_kernel = read_kernel_counts("flash_attention")
        if flash_by_kernel != {"flash_mma_kernel": L * eng.prefills}:
            raise SystemExit(f"fixed {kind}: flash_attention's kernels "
                             f"{flash_by_kernel} in {eng.prefills} prefills, "
                             f"expected flash_mma_kernel x {L} each")
        stray = {k: v for k, v in counts.items() if k not in want and v}
        if stray:
            raise SystemExit(f"fixed {kind}: kernels off this path launched: "
                             f"{stray}")
        # P-fp: abfp_matmul QDQs x with abfp_qdq's kernel before every
        # call of up to 16 rows: each decode tick's 7 L + 1 and each
        # prefill's lm_head (its last row)
        x_qdq = read_kernel_counts("abfp_matmul")
        want_qdq = {"qdq_stream_kernel": ((7 * L + 1) * eng.ticks
                                          + eng.prefills
                                          if kind == "p_fp" else 0),
                    "qdq_rows_kernel": 0}
        if x_qdq != want_qdq:
            raise SystemExit(f"fixed {kind}: abfp_matmul's x pre-pass "
                             f"launched {x_qdq}, expected {want_qdq}")
        n_tok = sum(len(c.tokens) for c in done)
        report = {
            "policy": kind, "requests": len(done),
            "prompt_lens": [len(r.prompt) for r in reqs],
            "padded_lens": sorted(eng._padded_lengths),
            "generated_tokens": n_tok, "prefills": eng.prefills,
            "decode_ticks": eng.ticks, "wall_s": wall,
            "tokens_per_s": n_tok / wall,
            "prefill_ms_median": statistics.median(timed.prefill_ms),
            "prefill_ms": timed.prefill_ms,
            "decode_ms_median": statistics.median(eng.decode_ms),
            "launches": counts, "expected_launches": want,
            "flash_attention_by_kernel": flash_by_kernel,
            "x_qdq_launches": x_qdq,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        }
        log("  " + json.dumps(report))
        # a decode tick's x pre-pass, read from the profiler: P-fp 7 L + 1
        # launches of qdq_stream_kernel, P-int8 none; a capture that reads
        # other counts is taken again once, as ``device_launches`` does
        want_qdq = {"qdq_stream_kernel": 7 * L + 1 if kind == "p_fp" else 0,
                    "qdq_rows_kernel": 0}
        for capture in (1, 2):
            report["profile"] = profile_decode(
                torch, cfg, eng, seed, report["decode_ms_median"],
                watch=tuple(QDQ_KERNELS))
            seen = report["profile"].get("watched_kernels_per_step", {})
            tick_qdq = {k: seen.get(k, {}).get("launches")
                        for k in QDQ_KERNELS}
            if tick_qdq == want_qdq:
                break
            PROFILER_RETRIES.append({
                "phase": PHASE["name"], "call": f"fixed {kind} decode tick",
                "capture": capture, "read": tick_qdq, "expected": want_qdq})
        else:
            raise SystemExit(f"fixed {kind}: a profiled decode tick's x "
                             f"pre-pass launched {tick_qdq}")
        report["prefill_profile"] = profile_fixed_prefill(torch, cfg, eng,
                                                          seed)
        # the profiled 192-row prefill's attention, read from the
        # profiler: L launches of flash_mma_kernel, none of flash_kernel
        seen = report["prefill_profile"].get("watched_kernels_per_step", {})
        if (seen.get("flash_mma_kernel", {}).get("launches") != L
                or seen.get("flash_kernel", {}).get("launches")):
            raise SystemExit(f"fixed {kind}: the 192-row prefill launched "
                             f"{seen}, expected flash_mma_kernel x {L} and "
                             "no flash_kernel")
        # the 192-row prefill contracts on the tensor cores
        planned = {"p_int8": "Int8Codes>", "p_fp": "Bf16Codes>"}[kind]
        top = report["prefill_profile"].get("top_device_kernels_ms_per_step",
                                            [])
        if not any(planned in k["name"] for k in top):
            raise SystemExit(f"fixed {kind}: the prefill profile shows no "
                             f"mma_contract_kernel<{planned[:-1]}>: {top}")
        reports[kind] = report
        del eng, timed
        torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return reports


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


# the reduced configs held on the card against the CPU: qwen2-7b, and the
# last families (gemma2's softcap takes no attention kernel)
REDUCED_ARCHS = ("qwen2-7b", "gemma2-9b", "granite-3-8b", "h2o-danube-1.8b",
                 "phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")


def phase_reduced(torch, seed: int) -> dict:
    """Kernel path on the card vs plain path on the CPU, reduced configs.

    The CPU side is the arithmetic the CPU tests hold token-identical to
    the JAX reference, so this ties the kernels in situ (other head_dim,
    group and GQA shapes than the full model's) to that reference.  At
    this size the quantizer chains are short and the vocabulary small, so
    tokens are expected to be identical; the card and the CPU still sum in
    other orders.  Paged: ONE request of six may turn at a near-tie before
    the phase fails.  Fixed-slot: every turned token is judged by the
    identity phase's margin rule (its top-2 margin within twice the logit
    gap of the two runs at that token) and reported.  Every config of
    REDUCED_ARCHS runs every policy; an MoE config's fixed-slot prefills
    take buckets of 64 in a ring of 128 (its routing groups are 64
    tokens)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import (map_policies, preset,
                                         with_attn_backend)
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.serve.engine import PagedServeEngine

    log("== reduced: kernel path on the card vs plain path on the CPU")

    def to_device(tree, dev):
        if isinstance(tree, torch.Tensor):
            return tree.to(dev)
        if isinstance(tree, dict):
            return {k: to_device(v, dev) for k, v in tree.items()}
        return [to_device(v, dev) for v in tree]

    def submit(eng):
        submit_reduced(eng, cfg, seed)

    def check_launched(label, counts, names):
        if cfg.attn_softcap:  # no kernel body has a softcap
            names = [k for k in names if "attention" not in k]
            if counts["flash_attention"] or counts["flash_attention_quant"]:
                raise SystemExit(f"reduced {label}: an attention kernel "
                                 f"under a softcap: {counts}")
        if min(counts[k] for k in names) == 0:
            raise SystemExit(f"reduced {label}: a kernel of the path was not "
                             f"launched: {counts}")

    rows = []
    for arch in REDUCED_ARCHS:
        cfg = get_config(arch).reduced()
        models = {"cpu": build_model(cfg, device="cpu"),
                  "cuda": build_model(cfg)}
        params = models["cpu"].init(make_generator(seed, "cpu"))
        for n, kv in ((64, "int8"), (64, "fp8"), (32, "int8")):
            pol = map_policies(preset("w4a8_abfp", n=n),
                               lambda p: p.replace(fused=True))
            pol = with_attn_backend(pol, "compressed")
            tokens = {}
            reset_counts()
            for dev, model in models.items():
                eng = PagedServeEngine(
                    model, to_device(params, dev), n_slots=3, max_len=96,
                    policy=pol, page_size=8, kv=kv, compress=True,
                    device=dev)
                submit(eng)
                tokens[dev] = {c.uid: c.tokens for c in eng.run_until_done()}
            counts = read_counts()
            turned = [u for u in tokens["cpu"]
                      if tokens["cpu"][u] != tokens["cuda"][u]]
            row = {"arch": cfg.name, "engine": "paged", "group": n, "kv": kv,
                   "requests_equal": 6 - len(turned), "requests": 6,
                   "launches": counts}
            rows.append(row)
            log("  " + json.dumps(row))
            check_launched(f"{arch} paged group {n} {kv}", counts,
                           ("quant_matmul", "flash_attention_quant"))
            no_attention_kernel(f"reduced {arch} paged group {n} {kv}")
            if len(turned) > 1:
                raise SystemExit(
                    f"reduced {arch} (group {n}, {kv} pages): requests "
                    f"{turned} differ between the card and the CPU: {tokens}")
        # fixed-slot engine: P-int8, P-fp, and compressed weights with an
        # int8 ring cache read by the quantized-KV kernel
        fixed_kernels = {"p_int8": ("abfp_matmul_int8", "flash_attention"),
                         "p_fp": ("abfp_matmul", "flash_attention"),
                         "compress": ("quant_matmul",
                                      "flash_attention_quant")}
        bucket, ring = (64, 128) if cfg.family == "moe" else (32, 96)
        for kind, n in (("p_int8", 64), ("p_fp", 32), ("compress", 64)):
            runs = {}
            reset_counts()
            for dev, model in models.items():
                trace = {}
                eng = fixed_engine(model, to_device(params, dev),
                                   fixed_policy(kind, n), trace=trace,
                                   n_slots=3, max_len=ring,
                                   prefill_bucket=bucket,
                                   compress=(kind == "compress"), device=dev)
                submit(eng)
                toks = {c.uid: c.tokens for c in eng.run_until_done()}
                runs[dev] = (toks, {u: [t.cpu() for t in rows_]
                                    for u, rows_ in trace.items()})
            counts = read_counts()
            cmp = compare_runs(torch, *runs["cuda"], *runs["cpu"])
            row = {"arch": cfg.name, "engine": "fixed", "policy": kind,
                   "group": n,
                   "requests_equal": 6 - len(cmp["divergences"]),
                   "requests": 6, "tokens_equal": cmp["tokens_equal"],
                   "tokens_total": cmp["tokens_total"],
                   "max_logit_gap_over_std": cmp["max_logit_gap_over_std"],
                   "divergences": cmp["divergences"], "launches": counts}
            if kind != "compress":
                # the reduced config's prefill attention (D = 16, G = 2)
                # takes the tensor-core kernel too, as plan_flash routes
                # every call
                row["flash_attention_by_kernel"] = read_kernel_counts(
                    "flash_attention")
            rows.append(row)
            log("  " + json.dumps(row))
            check_launched(f"{arch} fixed {kind}", counts,
                           fixed_kernels[kind])
            no_attention_kernel(f"reduced {arch} fixed {kind}")
            if kind != "compress" and row["flash_attention_by_kernel"] != {
                    "flash_mma_kernel": counts["flash_attention"]}:
                raise SystemExit(
                    f"reduced {arch} fixed {kind}: flash_attention's "
                    f"kernels {row['flash_attention_by_kernel']}, expected "
                    f"flash_mma_kernel x {counts['flash_attention']}")
            for d in cmp["divergences"]:
                # a token can only turn where the margin is inside the drift
                if not (d["top2_margin_over_std"]
                        <= 2 * d["logit_gap_over_std"]):
                    raise SystemExit(f"reduced {arch} fixed {kind}: a token "
                                     f"turned away from a near-tie: {d}")
        del models, params
    rows += spec_reduced(torch, seed, to_device, submit_reduced)
    rows.append(expert_reduced(torch, seed, to_device, submit_reduced))
    return {"configs": rows}


def submit_reduced(eng, cfg, seed: int, n: int = 6) -> None:
    """The reduced phase's requests: prompts of 5, 11, 3, 70, 8, 2 tokens
    from ``seed`` + 3, 6 new tokens each; the first ``n``."""
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.RandomState(seed + 3)
    for uid, size in enumerate((5, 11, 3, 70, 8, 2)):
        prompt = rng.randint(0, cfg.vocab, size).astype(np.int32)
        if uid < n:
            eng.submit(Request(uid=uid, max_new_tokens=6, prompt=prompt))


def reduced_gate(label: str, want: dict, got: dict) -> int:
    """Requests whose tokens differ; the phase fails past one (a turn at a
    near-tie, as the reduced paged runs allow)."""
    turned = [u for u in want if want[u] != got[u]]
    if len(turned) > 1:
        raise SystemExit(f"{label}: requests {turned} differ: {want} vs "
                         f"{got}")
    return len(want) - len(turned)


def spec_reduced(torch, seed: int, to_device, submit) -> list:
    """Reduced qwen2-7b served speculatively (k = 3, the phase ``spec``'s
    policies), fixed (int8 ring, ``compressed`` attention) and paged (fp
    pages), on the card and on the CPU; the card's greedy tokens against
    the CPU's and against the card's target-only engine's."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.serve.engine import PagedServeEngine, ServeEngine
    from repro_torch.serve.speculative import SpeculativeServeEngine

    cfg = get_config("qwen2-7b").reduced()
    models = {"cpu": build_model(cfg, device="cpu"),
              "cuda": build_model(cfg)}
    params = models["cpu"].init(make_generator(seed, "cpu"))
    rows = []
    for paged in (False, True):
        target = spec_policy("w8a8_abfp", not paged)
        kw = (dict(page_size=8, prefill_chunk=16) if paged
              else dict(prefill_bucket=32))
        toks = {}
        reset_counts()
        for dev, model in models.items():
            eng = SpeculativeServeEngine(
                model, to_device(params, dev), target_policy=target,
                draft_policy=spec_policy("w4a8_abfp", not paged), draft_k=3,
                n_slots=3, max_len=96, device=dev,
                **(dict(kv_cache="paged", **kw) if paged else kw))
            submit(eng, cfg, seed)
            toks[dev] = {c.uid: c.tokens for c in eng.run_until_done()}
            if dev == "cuda":
                stats = eng.acceptance_stats()
        counts = read_counts()
        base = (PagedServeEngine if paged else ServeEngine)(
            models["cuda"], to_device(params, "cuda"), n_slots=3, max_len=96,
            policy=target, device="cuda", **kw)
        submit(base, cfg, seed)
        target_only = {c.uid: c.tokens for c in base.run_until_done()}
        label = f"reduced {cfg.name} speculative {'paged' if paged else 'fixed'}"
        row = {"arch": cfg.name, "engine": "speculative "
               + ("paged" if paged else "fixed"), "draft_k": 3,
               "requests": 6,
               "requests_equal": reduced_gate(label + " card vs CPU",
                                              toks["cpu"], toks["cuda"]),
               "requests_equal_target_only": reduced_gate(
                   label + " vs target-only", target_only, toks["cuda"]),
               "accepted_per_target_step": stats["accepted_per_target_step"],
               "launches": counts}
        rows.append(row)
        log("  " + json.dumps(row))
        need = ("quant_matmul", "abfp_matmul") + (
            () if paged else ("flash_attention_quant",))
        if min(counts[k] for k in need) == 0:
            raise SystemExit(f"{label}: a kernel of the path was not "
                             f"launched: {counts}")
        no_attention_kernel(label)
    return rows


def expert_reduced(torch, seed: int, to_device, submit) -> dict:
    """Reduced Phi-3.5-MoE paged P-C with ``expert_cache=2``, refreshed
    once the first requests are in, on the card and on the CPU; the card's
    tokens against the CPU's and, exactly, against the card's run without
    a store."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.serve.engine import PagedServeEngine

    cfg = get_config("phi3.5-moe-42b-a6.6b").reduced()
    models = {"cpu": build_model(cfg, device="cpu"),
              "cuda": build_model(cfg)}
    params = models["cpu"].init(make_generator(seed, "cpu"))
    toks, stats = {}, None
    reset_counts()
    for dev, cache in (("cpu", 2), ("cuda", 2), ("cuda", None)):
        eng = PagedServeEngine(
            models[dev], to_device(params, dev), n_slots=3, max_len=96,
            policy=slice_policy(True), page_size=8, kv="int8",
            compress=True, expert_cache=cache, device=dev)
        submit(eng, cfg, seed)
        eng.tick()
        if cache:
            eng.refresh_experts()
        toks[dev, cache] = {c.uid: c.tokens
                            for c in eng.run_until_done()}
        if dev == "cuda" and cache:
            stats = moe_stats_brief(eng)
            counts = read_counts()
    label = f"reduced {cfg.name} expert_cache 2"
    if toks["cuda", 2] != toks["cuda", None]:
        raise SystemExit(f"{label}: the store's tokens on the card differ "
                         f"from the run without one")
    row = {"arch": cfg.name, "engine": "paged expert store", "requests": 6,
           "requests_equal": reduced_gate(label + " card vs CPU",
                                          toks["cpu", 2], toks["cuda", 2]),
           "equal_without_store": True, "expert_stats": stats,
           "launches": counts}
    log("  " + json.dumps(row))
    if not stats["cached_experts"] or not counts["quant_matmul"]:
        raise SystemExit(f"{label}: {row}")
    return row


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
        no_attention_kernel(f"identity {name}")
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
# phase: spec
# --------------------------------------------------------------------------
SPEC_K = 4  # draft tokens a round: the verify pass runs 4 x 5 = 20 rows
SPEC_SHORT = (3, 2, 8)  # draft_k, requests, new tokens: 16 rows a verify
SPEC_TEMPERATURE = (0.8, 20)  # temperature, top-k of the seeded run
SPEC_CHECK_ROUNDS = 2  # verify passes held against sequential decode steps
# launches of each speculative call by wrapper, attention kernel and x
# pre-pass, read from the counts around the call
SPEC_KINDS = ("draft", "verify", "prefill")


def spec_policy(name: str, ring: bool):
    """A speculative side's policy: preset ``name`` with ``fused`` on every
    entry; ``ring``: an int8 ring read by the ``compressed`` attention
    backend, else fp pages (paged speculative serving rejects quantized
    pages, and ``compressed`` over fp storage raises), ``fused`` and no
    attention-BMM QDQ: over fp pages that QDQ groups V along the sequence,
    so a verify chunk's later tokens would move an earlier position's
    codes and the verify pass would not be the sequential steps (the
    reference's too)."""
    from repro_torch.core.policy import (map_policies, preset,
                                         with_attn_backend, with_kv_cache)

    pol = map_policies(preset(name), lambda p: p.replace(
        fused=True, attn_bmm=p.attn_bmm and ring))
    if ring:
        return with_attn_backend(with_kv_cache(pol, "int8"), "compressed")
    return with_attn_backend(pol, "fused")


def save_counts() -> dict:
    return {name: (fn.launches, dict(getattr(fn, "launches_by_kernel", {})))
            for name, fn in _wrappers().items()}


def restore_counts(saved: dict) -> None:
    """Launches made between ``save_counts`` and here (comparisons with
    another path) leave the main path's counts as they were."""
    for name, fn in _wrappers().items():
        fn.launches = saved[name][0]
        if hasattr(fn, "launches_by_kernel"):
            fn.launches_by_kernel.update(saved[name][1])


def count_snapshot() -> dict:
    """Every wrapper's launches, flash_attention_quant's by kernel and
    abfp_matmul's x pre-pass (``qdq_stream_kernel``), flat."""
    out = dict(read_counts())
    out.update(read_kernel_counts("flash_attention_quant"))
    out["prepass"] = read_kernel_counts("abfp_matmul")["qdq_stream_kernel"]
    return out


def spec_counted(eng) -> dict:
    """Wraps the draft side's steps, the target's verify and both sides'
    prefills so that every call's launches are kept (a dict of nonzero
    counts a call, by kind)."""
    calls = {k: [] for k in SPEC_KINDS}

    def wrap(side, name, kind):
        inner = getattr(side, name)

        def call(*a, **kw):
            before = count_snapshot()
            out = inner(*a, **kw)
            after = count_snapshot()
            calls[kind].append({k: after[k] - before[k] for k in after
                                if after[k] != before[k]})
            return out

        setattr(side, name, call)

    wrap(eng.draft, "decode", "draft")
    wrap(eng.target, "verify", "verify")
    wrap(eng.draft, "prefill_into", "prefill")
    wrap(eng.target, "prefill_into", "prefill")
    return calls


def spec_want(cfg, paged: bool, k: int) -> dict:
    """Launches of one draft step and one verify pass: every dense site of
    every layer and the head through ``quant_matmul`` (the compressed
    draft, 4 rows) or ``abfp_matmul`` (the target, 4 (k + 1) rows; its x
    pre-pass where that is at most 16), one ``flash_attention_quant`` a
    layer on the int8 ring (the decode kernel at S = 1, the prefill kernel
    at S = k + 1), none over fp pages (the plain path, as in the
    reference)."""
    n = 7 * cfg.n_layers + 1
    L = 0 if paged else cfg.n_layers
    rows = 4 * (k + 1)
    draft = {"quant_matmul": n, "flash_attention_quant": L,
             "attention_decode_kernel": L}
    verify = {"abfp_matmul": n, "flash_attention_quant": L,
              "attention_prefill_kernel": L,
              "prepass": n if rows <= 16 else 0}
    return {"draft": {a: b for a, b in draft.items() if b},
            "verify": {a: b for a, b in verify.items() if b}}


def clone_ring(state):
    """A deep copy of a fixed-slot DecodeState (its rings are written in
    place)."""
    kv = [type(c)(*(t.clone() if hasattr(t, "clone") else t for t in c))
          for c in state.kv]
    return state._replace(kv=kv, position=state.position.clone())


def spec_gap_check(torch, eng, chunk, mask, vlogits, state0, perturbed
                   ) -> dict:
    """The verify pass's logits at every chunk position against the
    target's own sequential ``decode_step`` logits on the same committed
    context (a copy of the ring taken before the pass), and a control: the
    same sequential steps with the embedding table scaled by 1 + 2**-20
    (the identity phase's last-bit noise).  Gaps in units of the row's
    std, over the active rows."""
    import numpy as np

    model, params, pol = eng.model, eng.target.params, eng.target.policy
    V = model.cfg.vocab
    rows = [s for s in range(eng.n_slots) if mask[s]]
    seqs = {}
    for name, p in (("seq", params), ("control", perturbed)):
        st = clone_ring(state0)
        out = []
        for j in range(chunk.shape[1]):
            lg, st = model.decode_step(
                p, torch.as_tensor(chunk[:, j:j + 1], device="cuda"), st,
                pol)
            out.append(lg[:, :V].float().cpu().numpy())
        seqs[name] = np.stack(out, axis=1)  # (B, S, V)

    def gap(a, b):
        return max(float(np.abs(a[s, j] - b[s, j]).max() / b[s, j].std())
                   for s in rows for j in range(chunk.shape[1]))

    return {"verify_vs_sequential": gap(vlogits[:, :, :V], seqs["seq"]),
            "control_vs_sequential": gap(seqs["control"], seqs["seq"])}


def free_card(torch) -> None:
    """Collect the reference cycles a wrapped engine leaves (its sides'
    methods close over the engine), then return the memory to the card."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def spec_engine(torch, model, params, *, paged: bool, k: int):
    """A ``SpeculativeServeEngine`` on the card: the fused w8a8_abfp target
    on the dense f32 weights, the w4a8_abfp draft compressed from them;
    4 slots, max_len 512; an int8 ring (buckets of 64) or fp pages of 16
    (prefill chunk 64).  Every round's wall ms is kept."""
    from repro_torch.serve.speculative import SpeculativeServeEngine

    class Engine(SpeculativeServeEngine):
        def tick(self):
            rounds = self.stats["rounds"]
            t0 = time.perf_counter()
            super().tick()  # ends in host copies: synchronized
            if self.stats["rounds"] > rounds:
                self.round_ms.append((time.perf_counter() - t0) * 1e3)

    kw = (dict(kv_cache="paged", page_size=16, prefill_chunk=64) if paged
          else dict(prefill_bucket=64))
    eng = Engine(model, params, target_policy=spec_policy("w8a8_abfp",
                                                          not paged),
                 draft_policy=spec_policy("w4a8_abfp", not paged),
                 draft_k=k, n_slots=4, max_len=512, **kw)
    eng.round_ms = []
    return eng


def spec_run(torch, cfg, model, params, *, paged: bool, k: int, reqs,
             smi: str, check_rounds: int = 0) -> dict:
    """Serve ``reqs`` speculatively; assert every draft step's and verify
    pass's launches, the completions' metadata, the emitted greedy tokens
    against the verify logits' argmax and, paged, both pools drained.
    ``check_rounds``: the first verify passes are also held against the
    target's sequential decode steps (``spec_gap_check``)."""
    import numpy as np

    label = f"spec {'paged' if paged else 'fixed'} k={k}"
    free_card(torch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = spec_engine(torch, model, params, paged=paged, k=k)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    calls = spec_counted(eng)
    firsts, rounds, gaps = {}, [], []
    perturbed = None
    if check_rounds:
        perturbed = dict(params, embed=dict(
            params["embed"], table=params["embed"]["table"]
            * (1.0 + 2.0 ** -20)))
    prefill, verify = eng.target.prefill_into, eng.target.verify

    def target_prefill(slot, prompt):
        logits = prefill(slot, prompt)
        firsts[prompt.tobytes()] = int(np.argmax(logits[:cfg.vocab]))
        return logits

    def target_verify(chunk, mask):
        state0 = None
        if len(gaps) < check_rounds:
            state0 = clone_ring(eng.target.state)
        vlogits = verify(chunk, mask)
        rounds.append({eng.req[s].uid: (len(eng.generated[s]),
                                        np.argmax(vlogits[s, :, :cfg.vocab],
                                                  axis=-1).tolist())
                       for s in range(eng.n_slots) if mask[s]})
        if state0 is not None:
            saved = save_counts()
            gaps.append(spec_gap_check(torch, eng, chunk, mask, vlogits,
                                       state0, perturbed))
            restore_counts(saved)
            del state0
        return vlogits

    eng.target.prefill_into, eng.target.verify = target_prefill, \
        target_verify
    for r in reqs:
        eng.submit(r)
    reset_counts()
    t0 = time.perf_counter()
    while eng._has_work():
        eng.tick()
        if eng.ticks > 2000:
            raise SystemExit(f"{label}: did not drain in 2000 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, by_kernel = read_counts(), read_kernel_counts(
        "flash_attention_quant")
    prepass = read_kernel_counts("abfp_matmul")["qdq_stream_kernel"]
    del perturbed
    done = {c.uid: c for c in eng.done}
    new = reqs[0].max_new_tokens
    if sorted(done) != sorted(r.uid for r in reqs) or any(
            len(c.tokens) != new or c.finished_reason != "length"
            or not all(0 <= t < cfg.vocab for t in c.tokens)
            for c in done.values()):
        raise SystemExit(f"{label}: completions "
                         f"{[(c.uid, c.tokens) for c in done.values()]}")
    for c in done.values():
        if not (c.target_steps > 0 and c.drafted_tokens == k * c.target_steps
                and 0 <= c.accepted_draft_tokens <= c.drafted_tokens):
            raise SystemExit(f"{label}: request {c.uid}: {c.target_steps} "
                             f"target steps, {c.drafted_tokens} drafted, "
                             f"{c.accepted_draft_tokens} accepted")
    # every emitted token is the target's argmax at its position: the
    # first one from the prefill logits, then each round's a + 1 tokens
    # from the verify logits' first a + 1 rows
    starts = {}
    for rnd in rounds:
        for uid, (at, _) in rnd.items():
            starts.setdefault(uid, []).append(at)
    for r in reqs:
        toks = done[r.uid].tokens
        if toks[0] != firsts[np.asarray(r.prompt, np.int32).tobytes()]:
            raise SystemExit(f"{label}: request {r.uid}'s first token is "
                             "not the target prefill's argmax")
    for i, rnd in enumerate(rounds):
        for uid, (at, argmax) in rnd.items():
            later = [a for a in starts[uid] if a > at]
            end = min(later) if later else len(done[uid].tokens)
            emitted = done[uid].tokens[at:end]
            if not emitted or emitted != argmax[:len(emitted)]:
                raise SystemExit(f"{label}: round {i}, request {uid} "
                                 f"emitted {emitted}, the verify argmax is "
                                 f"{argmax}")
    want = spec_want(cfg, paged, k)
    for kind in ("draft", "verify"):
        bad = [c for c in calls[kind] if c != want[kind]]
        if bad or not calls[kind]:
            raise SystemExit(f"{label}: {kind} launches {bad[:2]} of "
                             f"{len(calls[kind])} calls, expected "
                             f"{want[kind]} each")
    if by_kernel["attention_kernel"]:
        raise SystemExit(f"{label}: attention_kernel launched "
                         f"{by_kernel['attention_kernel']} times")
    stats = eng.acceptance_stats()
    if stats["draft_steps"] != (k + 1) * stats["rounds"]:
        raise SystemExit(f"{label}: {stats}")
    pages = eng.page_stats()
    for pool, st in pages.items():
        if st["pages_in_use"] or not (
                st["page_allocs"] == st["page_frees"] > 0):
            raise SystemExit(f"{label}: the {pool} pool does not balance: "
                             f"{st}")
    n_tok = sum(len(c.tokens) for c in done.values())
    prefills = calls["prefill"]
    rep = {"engine": "paged" if paged else "fixed", "draft_k": k,
           "verify_rows": 4 * (k + 1), "requests": len(reqs),
           "prompt_lens": [len(r.prompt) for r in reqs],
           "generated_tokens": n_tok, "wall_s": wall,
           "tokens_per_s": n_tok / wall, "engine_build_s": build_s,
           "round_ms_median": statistics.median(eng.round_ms),
           "rounds": stats["rounds"],
           "accepted_per_target_step": stats["accepted_per_target_step"],
           "acceptance_rate": stats["acceptance_rate"],
           "acceptance": stats, "page_stats": pages,
           "launches": counts, "launches_by_kernel": by_kernel,
           "prepass_launches": prepass,
           "launches_per_draft_step": want["draft"],
           "launches_per_verify": want["verify"],
           "draft_steps": len(calls["draft"]),
           "verify_passes": len(calls["verify"]),
           "prefill_launches": {k_: sum(c.get(k_, 0) for c in prefills)
                                for k_ in sorted({x for c in prefills
                                                  for x in c})},
           "tokens": {u: c.tokens for u, c in sorted(done.items())},
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if gaps:
        rep["gap_checks"] = gaps
    log(f"  {label}: {rep['tokens_per_s']:.2f} tokens/s, round "
        f"{rep['round_ms_median']:.1f} ms (median of {len(eng.round_ms)}), "
        f"{rep['accepted_per_target_step']:.3f} tokens a target step, "
        f"acceptance {rep['acceptance_rate']:.3f}; peak "
        f"{rep['peak_memory_bytes'] / 1e9:.2f} GB [{smi}]")
    log(f"  {label}: " + json.dumps(rep))
    return eng, rep


def spec_kernel_checks(torch, seed: int) -> dict:
    """The new shapes of the verify pass, held against their plain
    versions and timed beside the bound: abfp_matmul on qwen2-7b's layers
    at M = 20 (4 slots x 5 tokens: the tensor cores) and M = 16 (k = 3:
    the decode kernels and their x pre-pass), w8a8's int8 weights; the
    prefill kernel at S = 5 over a ring of 512 int8 keys."""
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 41)
    rows = {"abfp_matmul": [], "flash_attention_quant": []}
    for M in (4 * (SPEC_K + 1), 4 * (SPEC_SHORT[0] + 1)):
        for name, K, N in DECODE_SHAPES:
            rows["abfp_matmul"].append(check_dense_matmul(
                torch, timer, gen, kind="fp", M=M, K=K, N=N, fw="int8",
                label=f"spec verify {name} M={M} K={K} N={N} w8a8"))
        torch.cuda.empty_cache()
    rows["flash_attention_quant"].append(check_attention(
        torch, timer, gen, S=SPEC_K + 1, T=512, probs=True, fp8=False,
        block_k=0, q_starts=[100, 507, 37, -1], profiled=False,
        want_kernel="attention_prefill_kernel",
        label=f"spec verify S={SPEC_K + 1} T=512 int8 exact"))
    del timer
    torch.cuda.empty_cache()
    return rows


def phase_spec(torch, seed: int, smi: str) -> dict:
    """Speculative serving of qwen2-7b at published width and full depth,
    random weights from ``seed``: the fused w8a8_abfp target on the dense
    f32 tree verifies what the w4a8_abfp draft compressed from it proposes.
    Fixed-slot (int8 ring, ``compressed`` attention) at k = 4 on ``serve``'s
    six requests, its first rounds held against sequential decode steps;
    at k = 3 (16 rows a verify pass) on two of them, 8 new tokens; paged
    over fp pages of 16 at k = 4; the seeded sampler twice.  A target-only
    run of the same requests counts the tokens both emit."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.serve.engine import Request, ServeEngine

    log("== spec: qwen2-7b, full width and depth, speculative serving")
    t_phase = time.perf_counter()
    report = {"kernel_rows": spec_kernel_checks(torch, seed)}
    cfg = get_config("qwen2-7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(make_generator(seed, "cuda"))
    torch.cuda.synchronize()
    log(f"  dense model built in {time.perf_counter() - t0:.1f} s")
    reqs = make_requests(cfg, seed)
    eng, rep = spec_run(torch, cfg, model, params, paged=False, k=SPEC_K,
                        reqs=reqs, smi=smi, check_rounds=SPEC_CHECK_ROUNDS)
    # the verify pass against sequential decode steps: the identity
    # phase's bar, from this check's own last-bit control
    gaps = rep["gap_checks"]
    control = max(g["control_vs_sequential"] for g in gaps)
    limit = min(GAP_MAX, GAP_FACTOR * control)
    worst = max(g["verify_vs_sequential"] for g in gaps)
    rep["gap_limit"] = limit
    log(f"  verify vs sequential decode steps: logit gap {worst:.4g} std "
        f"(control {control:.4g}, limit {limit:.4g}) over "
        f"{len(gaps)} rounds")
    if not worst <= limit:
        raise SystemExit(f"spec: the verify pass is {worst} std from the "
                         f"target's sequential decode steps, over {limit}")
    weights = eng.weight_bytes
    rep["draft_weight_bytes"] = {
        "dense": weights["dense_kernel_bytes"],
        "compressed": weights["resident_kernel_bytes"]}
    # a profiled round: four more requests, admitted (and a first round
    # run) by one tick
    for r in make_requests(cfg, seed + 1)[:4]:
        r.max_new_tokens = PROFILE_NEW
        eng.submit(r)
    eng.tick()
    rep["profile"] = profile_steps(torch, eng.tick, 2,
                                   rep["round_ms_median"], kind="round")
    eng.run_until_done(max_ticks=2000)
    log("  round profile: " + json.dumps(rep["profile"]))
    # the seeded sampler, twice on the same engine (admission rewrites a
    # slot's rows and reseeds its stream)
    temp, top_k = SPEC_TEMPERATURE
    sampled = []
    for _ in range(2):
        eng.done.clear()
        for r in reqs[:2]:
            eng.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=6,
                               temperature=temp, top_k=top_k,
                               seed=100 + r.uid))
        sampled.append({c.uid: c.tokens
                        for c in eng.run_until_done(max_ticks=2000)})
    if sampled[0] != sampled[1]:
        raise SystemExit(f"spec: seeded sampling is not deterministic: "
                         f"{sampled}")
    rep["sampled"] = {"temperature": temp, "top_k": top_k,
                      "tokens": sampled[0]}
    del eng
    free_card(torch)
    report["fixed"] = rep
    # target-only: the fixed-slot engine under the target's policy
    base = ServeEngine(model, params, n_slots=4, max_len=512,
                       policy=spec_policy("w8a8_abfp", True))
    for r in reqs:
        base.submit(Request(uid=r.uid, prompt=r.prompt, max_new_tokens=16))
    saved = save_counts()
    target_only = {c.uid: c.tokens for c in base.run_until_done()}
    restore_counts(saved)
    del base
    free_card(torch)
    agree = sum(a == b for u, t in target_only.items()
                for a, b in zip(t, rep["tokens"][u]))
    report["target_only_agreement"] = {
        "tokens_equal": agree,
        "tokens_total": sum(len(t) for t in target_only.values()),
        "requests_equal": sum(t == rep["tokens"][u]
                              for u, t in target_only.items())}
    log("  speculative vs target-only tokens: "
        + json.dumps(report["target_only_agreement"]))
    torch.cuda.empty_cache()
    k, n_req, new = SPEC_SHORT
    short = [Request(uid=r.uid, prompt=r.prompt, max_new_tokens=new)
             for r in reqs[:n_req]]
    eng, report["fixed_short"] = spec_run(torch, cfg, model, params,
                                          paged=False, k=k, reqs=short,
                                          smi=smi)
    del eng
    eng, report["paged"] = spec_run(torch, cfg, model, params, paged=True,
                                    k=SPEC_K, reqs=reqs, smi=smi)
    del eng, model, params
    free_card(torch)
    runs = [report[k_] for k_ in ("fixed", "fixed_short", "paged")]
    arch_totals(report, runs)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"  spec launches on the main paths: {json.dumps(report['launches'])}"
        f", attention by kernel {json.dumps(report['launches_by_kernel'])},"
        f" x pre-pass {report['prepass_launches']}; phase "
        f"{report['phase_s']:.1f} s [{smi}]")
    return report


# --------------------------------------------------------------------------
# phase: ptq
# --------------------------------------------------------------------------
# the methods table's variants (benchmarks/tables.py methods_table, plus
# RPTQ) and the calibrations the recipe engine runs for each
PTQ_RECIPES = (("static_mse", 1), ("smoothquant+static_mse", 2),
               ("gptq+static_mse", 2), ("smoothquant+gptq+static_mse", 3),
               ("rptq_w4a8", 1))
PTQ_BATCHES = 4  # calibration batches, and held-out evaluation batches
PTQ_SHAPE = (4, 128)  # the benchmarks' calibration batch (common.py:333)
PTQ_TIE = 1e-9  # a GPTQ code may differ only this close to a boundary


def ptq_dense(cfg) -> int:
    """Dense matmuls of one opt forward: q, k, v, o, wi, wo a layer, and
    the tied head."""
    return 6 * cfg.n_layers + 1


def ptq_batches(cfg, seed: int):
    """Calibration and held-out batches of random tokens from
    ``RandomState(seed + 1)``; labels are the next token (-1 at the end)."""
    import numpy as np

    rng = np.random.RandomState(seed + 1)
    calib = [{"tokens": rng.randint(0, cfg.vocab, PTQ_SHAPE).astype(
        np.int32)} for _ in range(PTQ_BATCHES)]
    evals = []
    for _ in range(PTQ_BATCHES):
        t = rng.randint(0, cfg.vocab, PTQ_SHAPE).astype(np.int32)
        labels = np.roll(t, -1, axis=1)
        labels[:, -1] = -1
        evals.append({"tokens": t, "labels": labels})
    return calib, evals


def ptq_eval(torch, model, params, evals, policy, q=None):
    """(mean loss over the held-out batches, wall ms of each batch)."""
    losses, ms = [], []
    with torch.no_grad():
        for b in evals:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, _ = model.loss(params, b, policy, q)
            losses.append(float(loss))  # synchronizes
            ms.append((time.perf_counter() - t0) * 1e3)
    return statistics.fmean(losses), ms


def ptq_logits(torch, model, params, batch, policy):
    """One batch's logits over the real vocabulary (the padded columns
    cut)."""
    with torch.no_grad():
        logits, _ = model.apply(params, batch, policy)
    return logits[..., :model.cfg.vocab]


class PTQTimers:
    """Wraps ``quant_transforms.calibrate`` and ``gptq_quantize`` (the
    names the recipe passes call) to time each call between two
    synchronizations and keep each calibrator and its Hessian bytes."""

    def __init__(self, torch):
        from repro_torch.models import quant_transforms as qt

        self.torch, self.qt = torch, qt
        self.orig = (qt.calibrate, qt.gptq_quantize)
        self.calib_s, self.gptq_s, self.calibs = [], [], []
        self.hessian_bytes = 0

    def _timed(self, fn, into):
        torch = self.torch

        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            into.append(time.perf_counter() - t0)
            return out
        return call

    def __enter__(self):
        cal = self._timed(self.orig[0], self.calib_s)

        def calibrate(*a, **kw):
            c = cal(*a, **kw)
            self.calibs.append(c)
            self.hessian_bytes = max(self.hessian_bytes, sum(
                nbytes(st.outer) for st in c.stats.values()
                if st.outer is not None))
            return c
        self.qt.calibrate = calibrate
        self.qt.gptq_quantize = self._timed(self.orig[1], self.gptq_s)
        return self

    def __exit__(self, *exc):
        self.qt.calibrate, self.qt.gptq_quantize = self.orig
        return False


def fused_logit_gap(torch, model, params, batch, kp, label: str) -> dict:
    """One batch's logits under the fused policy ``kp`` against the ref
    backend's, in units of their std, held as the identity phase holds its
    paths: at most GAP_FACTOR times as far as the ref backend moves from
    itself when its embedding table is scaled by 1 + 2**-20 (the kernels
    add the same f32 terms in other orders, and a last bit can move a
    value across a rounding boundary), and at most GAP_MAX; the weights
    with no QDQ at all (fp32) must lie beyond that limit."""
    from repro_torch.core.policy import preset

    rp = ref_backend(kp)
    ref = ptq_logits(torch, model, params, batch, rp)
    gap = logit_gap(torch, ptq_logits(torch, model, params, batch, kp), ref)
    nudged = dict(params, embed=dict(
        params["embed"], table=params["embed"]["table"] * (1 + 2.0 ** -20)))
    last_bit = logit_gap(torch, ptq_logits(torch, model, nudged, batch, rp),
                         ref)
    no_qdq = logit_gap(torch, ptq_logits(torch, model, params, batch,
                                         preset("fp32")), ref)
    del ref, nudged
    limit = min(GAP_MAX, GAP_FACTOR * last_bit)
    log(f"  {label} fused logits {gap:.3g} std from the ref backend's "
        f"(limit {limit:.3g}; last-bit control {last_bit:.3g}, fp32 with "
        f"no QDQ {no_qdq:.3g})")
    if not gap <= limit < no_qdq:
        raise SystemExit(f"{label} fused logits are {gap} std from the ref "
                         f"backend's; limit {limit}, no-QDQ control "
                         f"{no_qdq}")
    return {"logit_gap_over_std": gap, "last_bit_control_over_std": last_bit,
            "no_qdq_control_over_std": no_qdq, "logit_gap_limit": limit}


def gptq_card_vs_cpu(torch, params, calib) -> dict:
    """GPTQ of blocks.0/attn/q (K = 768) and blocks.0/ffn/wo (K = 3072)
    with the card's Hessians, on the card and on the CPU in float64.  The
    outputs must be equal but in columns whose first differing row the CPU
    rounded from within ``PTQ_TIE`` of a boundary (a tie: float64 inverse
    and Cholesky factors differ in their last bits between cuSOLVER and
    LAPACK); the elements and columns that differ are counted."""
    import numpy as np

    from repro_torch.core import gptq as tg
    from repro_torch.core.formats import INT4

    out = {}
    for group, name, site in (("attn", "q", "blocks.0/attn/q/in"),
                              ("ffn", "wo", "blocks.0/ffn/wo/in")):
        w = params["blocks"][0][group][name]["kernel"]
        H = calib.stats[site].outer
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        card, _ = tg.gptq_quantize(w, H, INT4)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        units, orig = [], tg._quant_col

        def rec(row, scale, fmt, out=None):
            units.append((row / scale).numpy())
            return orig(row, scale, fmt, out=out)

        tg._quant_col = rec
        try:
            t0 = time.perf_counter()
            cpu, _ = tg.gptq_quantize(w.cpu(), H.cpu(), INT4)
            cpu_s = time.perf_counter() - t0
        finally:
            tg._quant_col = orig
        diff = (card.cpu() != cpu).numpy()
        u = np.stack(units)
        dist = np.abs(np.abs(u - np.floor(u)) - 0.5)
        cols = np.nonzero(diff.any(axis=0))[0]
        for n in cols:
            first = int(np.argmax(diff[:, n]))
            if not dist[first, n] <= PTQ_TIE:
                raise SystemExit(
                    f"ptq: GPTQ of blocks.0/{group}/{name} differs between "
                    f"the card and the CPU at row {first}, column {n}, "
                    f"{dist[first, n]} quanta from a rounding boundary")
        out[f"blocks.0/{group}/{name}"] = {
            "K": int(w.shape[0]), "N": int(w.shape[1]),
            "elements_differing": int(diff.sum()),
            "tie_columns": int(cols.size), "card_s": card_s,
            "cpu_s": cpu_s}
    return out


def mse_card_vs_cpu(torch, calib) -> dict:
    """``mse_alpha`` (int8, per tensor) of every layer-0 site on the card
    and on the CPU over the same reservoir rows.  Equal but at near-ties:
    a chosen candidate that differs must have a float64 mean error within
    the float64 summation bound of the other's; counted."""
    from repro_torch.core import calibration as tc
    from repro_torch.core.formats import INT8

    sites = ties = 0
    for site, st in calib.stats.items():
        if not site.startswith("blocks.0/"):
            continue
        sites += 1
        host = tc.RunningStats(absmax=st.absmax.cpu(),
                               ch_absmax=st.ch_absmax.cpu(),
                               samples=[x.cpu() for x in st.samples])
        card = float(tc.mse_alpha(st, INT8))
        cpu = float(tc.mse_alpha(host, INT8))
        if card == cpu:
            continue
        x = torch.cat(host.samples)
        amax = tc.max_alpha(host)
        fr = tc.linspace_fracs(100)
        errs = tc._grid_errors(x, amax, fr, INT8, False)
        i_card = int(torch.argmin((amax * fr - card).abs()))
        i_cpu = int(torch.argmin((amax * fr - cpu).abs()))
        ea, eb = float(errs[i_card]), float(errs[i_cpu])
        if not abs(ea - eb) <= x.numel() * 2.0 ** -53 * (ea + eb):
            raise SystemExit(f"ptq: mse_alpha at {site}: card {card} vs "
                             f"CPU {cpu} is not a near-tie ({ea} vs {eb})")
        ties += 1
    return {"sites": sites, "near_ties": ties}


def ptq_forward_launches(torch, model, params, batch, policy, roles: dict,
                         label: str) -> dict:
    """Kernel launches of one forward, read from the profiler: the dense
    matmul's three kernels and flash_mma_kernel must each launch as often
    as the path has matmuls and attention layers (the norms, residual adds
    and layout copies launch PyTorch's own kernels beside them)."""
    dense = ptq_dense(model.cfg)
    want = {"x_codes": dense, "w_codes": dense, "mma": dense,
            "flash": model.cfg.n_layers}

    def call():
        with torch.no_grad():
            model.apply(params, batch, policy)

    return device_launches(torch, call, roles, want, label, roles_only=True)


# the dense matmuls of an opt-125m forward at the phase's 512 rows: (label,
# K, N); and its attention call (4 x 128 positions, 12 heads of 64)
PTQ_MATMULS = (("q,k,v,o", 768, 768), ("wi", 768, 3072), ("wo", 3072, 768),
               ("tied head", 768, 50432))


def ptq_kernel_checks(torch, seed: int) -> dict:
    """Each kernel of the phase's fused evaluation against its plain
    version at the shapes that path gives it, timed beside the plain
    version and the card's bound: both dense matmuls at M = 512 for every
    (K, N) of the model, flash_attention at D = 64 with one query head a KV
    head."""
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 7)
    rows = {"abfp_matmul": [], "abfp_matmul_int8": [], "flash_attention": []}
    M = PTQ_SHAPE[0] * PTQ_SHAPE[1]
    for kind, name in (("fp", "abfp_matmul"), ("int8", "abfp_matmul_int8")):
        for label, K, N in PTQ_MATMULS:
            rows[name].append(check_dense_matmul(
                torch, timer, gen, kind=kind, M=M, K=K, N=N,
                label=f"opt {label} M={M} K={K} N={N}"))
    # the kernel is read from the wrapper's count here: after the earlier
    # phases the profiler drops this lone launch's device record (the
    # capture holds its cudaLaunchKernel and nothing on the card, five
    # captures in a row), while a capture of a whole forward reads every
    # launch (ptq_forward_launches: 12 flash_mma_kernel a forward)
    rows["flash_attention"].append(check_flash(
        torch, timer, gen, B=PTQ_SHAPE[0], S=PTQ_SHAPE[1], T=PTQ_SHAPE[1],
        H=12, KV=12, D=64, label=f"opt B={PTQ_SHAPE[0]} S=T={PTQ_SHAPE[1]} "
        "H=KV=12 D=64", profiled=False))
    del timer
    torch.cuda.empty_cache()
    return rows


def phase_ptq(torch, seed: int, smi: str) -> dict:
    import contextlib
    import io

    from repro_torch.configs import get_config
    from repro_torch.core.policy import preset, replace_enabled
    from repro_torch.core.recipe import apply_recipe, quantizes_weights_offline
    from repro_torch.launch import serve as tserve
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator

    log("== ptq: opt-125m, full width and depth, PTQ recipes at w4a8_mse")
    t_phase = time.perf_counter()
    kernel_rows = ptq_kernel_checks(torch, seed)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config("opt-125m")
    model = build_model(cfg)
    params = model.init(make_generator(seed, "cuda"))
    calib, evals = ptq_batches(cfg, seed)
    pol = preset("w4a8_mse", n_layers=cfg.n_layers)
    prequant = replace_enabled(pol, weight=None)
    fp32, _ = ptq_eval(torch, model, params, evals, preset("fp32"))
    report = {"model": cfg.name, "calib_batches": [PTQ_BATCHES, *PTQ_SHAPE],
              "fp32_loss": fp32, "recipes": {}, "kernel_rows": kernel_rows}
    hessian_calib = mse_calib = None
    for name, n_cal in PTQ_RECIPES:
        with PTQTimers(torch) as tm:
            t0 = time.perf_counter()
            res = apply_recipe(name, model, params, calib, pol)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if res.n_calibrations != n_cal or len(tm.calib_s) != n_cal:
            raise SystemExit(f"ptq: {name} ran {res.n_calibrations} "
                             f"calibrations, expected {n_cal}")
        if res.dropped_sites != ("embed/attend/in",):
            raise SystemExit(f"ptq: {name} dropped {res.dropped_sites}")
        off = quantizes_weights_offline(name)
        loss, ms = ptq_eval(torch, model, res.params, evals,
                            prequant if off else pol, q=res.qtree)
        if name == "static_mse":
            mse_calib = tm.calibs[0]
        if name == "gptq+static_mse":
            hessian_calib = next(c for c in tm.calibs if c.collect_outer)
        row = {"loss": loss, "calibrations": res.n_calibrations,
               "steps": [s for s, _ in res.steps], "wall_s": wall,
               "calibration_s": tm.calib_s, "eval_ms": ms,
               "hessian_bytes": tm.hessian_bytes}
        if tm.gptq_s:
            row.update(gptq_kernels=len(tm.gptq_s),
                       gptq_total_s=sum(tm.gptq_s),
                       gptq_median_s=statistics.median(tm.gptq_s))
            if len(tm.gptq_s) != 6 * cfg.n_layers:
                raise SystemExit(f"ptq: {name} ran GPTQ on "
                                 f"{len(tm.gptq_s)} kernels")
        report["recipes"][name] = row
        log(f"  {name}: loss {loss:.6f} (fp32 {fp32:.6f}), "
            f"{res.n_calibrations} calibrations, {wall:.2f} s")
        del res

    # the fused kernels on the fp32 weights, against the ref backend
    roles = {**REGIME_KERNELS["fp"], **REGIME_KERNELS["int8"],
             "flash_mma_kernel": "flash"}
    reset_counts()
    fused = {}
    for kind in FIXED_PATHS:
        kp = fixed_policy(kind)
        rp = ref_backend(kp)
        lk, ms_k = ptq_eval(torch, model, params, evals, kp)
        lr, ms_r = ptq_eval(torch, model, params, evals, rp)
        fused[kind] = {"loss": lk, "ref_backend_loss": lr,
                       "relative_loss_gap": abs(lk - lr) / abs(lr),
                       **fused_logit_gap(torch, model, params, evals[0], kp,
                                         f"ptq: {kind}"),
                       "eval_ms": ms_k, "ref_eval_ms": ms_r}
        log(f"  {kind} fused: loss {lk:.6f}, ref backend {lr:.6f}")
    counts = read_counts()
    # each kind: the held-out batches and the logits' forward
    runs = PTQ_BATCHES + 1
    want = {"abfp_matmul": ptq_dense(cfg) * runs,
            "abfp_matmul_int8": ptq_dense(cfg) * runs,
            "flash_attention": 2 * cfg.n_layers * runs}
    got = {k: v for k, v in counts.items() if v}
    if got != want:
        raise SystemExit(f"ptq: the fused evaluations launched {got}, "
                         f"expected {want}")
    for kind in FIXED_PATHS:
        fused[kind]["forward_launches"] = ptq_forward_launches(
            torch, model, params, evals[0], fixed_policy(kind), roles,
            f"opt-125m {kind} forward")
    report["fused"] = fused
    report["launches"] = counts

    report["gptq_card_vs_cpu"] = gptq_card_vs_cpu(torch, params,
                                                  hessian_calib)
    report["mse_alpha_card_vs_cpu"] = mse_card_vs_cpu(torch, mse_calib)
    del hessian_calib, mse_calib
    log("  card vs CPU: " + json.dumps({
        "gptq": report["gptq_card_vs_cpu"],
        "mse_alpha": report["mse_alpha_card_vs_cpu"]}))

    # the launcher, as a user runs it (through its pre-flight gate)
    out = io.StringIO()
    gates = GATES.get("serve", 0)
    with contextlib.redirect_stdout(out):
        rc = tserve.main(["--arch", "opt-125m", "--full", "--recipe",
                          "sq_gptq_w4a8", "--n-requests", "4",
                          "--max-new-tokens", "8", "--max-len", "256",
                          "--seed", str(seed)])
    served = json.loads(out.getvalue().strip().splitlines()[-1])
    served["gates_passed"] = GATES.get("serve", 0) - gates
    if (rc != 0 or served["recipe"] != "sq_gptq_w4a8"
            or served["recipe_calibrations"] != 3
            or served["requests"] != 4 or served["gates_passed"] != 1
            or not served["device"].startswith("cuda")):
        raise SystemExit(f"ptq: the launcher reported {served}")
    report["launcher"] = served
    log("  launcher: " + json.dumps(served))

    rows = report["recipes"]
    cal_s = [t for r in rows.values() for t in r["calibration_s"]]
    gq = [r for r in rows.values() if "gptq_total_s" in r]
    eval_ms = [t for r in rows.values() for t in r["eval_ms"]]
    report["summary"] = {
        "calibration_s_median": statistics.median(cal_s),
        "gptq_total_s": [r["gptq_total_s"] for r in gq],
        "gptq_median_s_per_kernel": [r["gptq_median_s"] for r in gq],
        "eval_ms_per_batch_median": statistics.median(eval_ms),
        "fused_eval_ms_per_batch": {k: statistics.median(v["eval_ms"])
                                    for k, v in fused.items()},
        "hessian_bytes": max(r["hessian_bytes"] for r in rows.values()),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "phase_s": time.perf_counter() - t_phase}
    sm = report["summary"]
    log(f"  seconds per calibration (median of {len(cal_s)}): "
        f"{sm['calibration_s_median']:.3f} [{smi}]")
    log(f"  GPTQ: {sm['gptq_total_s']} s in all, median "
        f"{sm['gptq_median_s_per_kernel']} s per kernel "
        f"({6 * cfg.n_layers} kernels) [{smi}]")
    log(f"  evaluation ms per batch (median): "
        f"{sm['eval_ms_per_batch_median']:.2f}; fused "
        f"{sm['fused_eval_ms_per_batch']} [{smi}]")
    log(f"  Hessian bytes: {sm['hessian_bytes']} [{smi}]")
    log(f"  peak memory: {sm['peak_memory_bytes']} bytes [{smi}]")
    log("  " + json.dumps({k: v for k, v in report.items()
                           if k not in ("launcher", "kernel_rows")}))
    del params, model
    torch.cuda.empty_cache()
    return report


# --------------------------------------------------------------------------
# phase: vit
# --------------------------------------------------------------------------
VIT_BATCH = 64  # the reference's evaluation batch (benchmarks/common.py)
VIT_SMALL = 16  # its calibration batch: the head (M = 16) takes the decode
VIT_CALIB = 4   # calibration batches of VIT_SMALL images
# the vision table's QDQ-sim policies (benchmarks/tables.py vit_table)
VIT_SIM = ("fp32", "w4a4_abfp", "w4a8_abfp", "w4a4_e2m1", "w4a4_e1m2")
# the fused runs: (label, path, the vision policy it runs)
VIT_FUSED = (("p_fp w4a4_abfp", "p_fp", "w4a4_abfp"),
             ("p_fp w4a8_abfp", "p_fp", "w4a8_abfp"),
             ("p_fp w4a4_e2m1", "p_fp", "w4a4_e2m1"),
             ("p_int8", "p_int8", "w4a8_int8_native"))
# (label, K, N) of ViT-B/16's dense matmuls; the patch projection's K is
# 16 x 16 x 3 = 768, its N d_model; the head's N 1000 classes padded to 1024
VIT_MATMULS = (("q,k,v,o,patch", 768, 768), ("wi", 768, 3072),
               ("wo", 3072, 768))
VIT_HEAD_N = 1024
VIT_PTQ = (("static_mse", 0), ("smoothquant+gptq+static_mse", 2))
VIT_DROPPED = ("head/in", "patch_embed/in")


def vit_dense(cfg) -> int:
    """Dense matmuls of one encoder forward: the patch projection, q, k, v,
    o, wi and wo a layer, and the head."""
    return 6 * cfg.n_layers + 2


def ref_backend(policy):
    """The same policy through the plain paths: the ref matmul backend, f32
    contraction, the ref attention backend."""
    from repro_torch.core.policy import map_policies, with_attn_backend

    return with_attn_backend(map_policies(policy, lambda q: q.replace(
        fused=False, compute="fp")), "ref")


def vit_images(cfg, n: int, seed: int):
    """``n`` synthetic images of ``cfg``'s size (224 x 224 x 3) and 10
    classes from ``seed + 1`` (the class count only sets the labels; 1000
    classes would build 1.2 GB of float64 templates)."""
    from repro_torch.data import synthetic_images

    return synthetic_images(n, image_size=cfg.image_size,
                            n_channels=cfg.n_channels, n_classes=10,
                            seed=seed + 1)


def vit_logits(torch, model, params, batch, policy):
    """One batch's logits over the real classes (the padded columns cut)."""
    with torch.no_grad():
        logits, _ = model.apply(params, batch, policy)
    return logits[:, :model.cfg.n_classes]


def vit_eval(torch, model, params, batch, policy, q=None) -> dict:
    """CE and top-1 of one batch through ``model.loss`` and its wall ms
    (between two synchronizations)."""
    with torch.no_grad():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ce, m = model.loss(params, batch, policy, q)
        out = {"loss": float(ce), "top1": float(m["acc"])}  # synchronizes
    out["wall_ms"] = (time.perf_counter() - t0) * 1e3
    return out


def vit_gap(torch, model, params, batch, kp, no_qdq) -> dict:
    """The fused policy ``kp``'s logits against its ref backend's, in units
    of their std, held as the ptq phase holds opt's: at most GAP_FACTOR
    times as far as the ref backend moves from itself when every token's
    embedding is scaled by 1 + 2**-20, and at most GAP_MAX; the fp32
    weights with no QDQ (``no_qdq``, their logits) must lie beyond that
    limit.  The embedding is the patch projection plus ``pos_embed`` (and
    the cls token), so all three are scaled: ``pos_embed`` alone (entries
    near 0.02) moves the sum by less than its last bit."""
    rp = ref_backend(kp)
    ref = vit_logits(torch, model, params, batch, rp)
    gap = logit_gap(torch, vit_logits(torch, model, params, batch, kp), ref)
    e = 1 + 2.0 ** -20
    nudged = dict(params, pos_embed=params["pos_embed"] * e,
                  patch_embed={k: v * e
                               for k, v in params["patch_embed"].items()})
    if "cls" in params:
        nudged["cls"] = params["cls"] * e
    last_bit = logit_gap(torch, vit_logits(torch, model, nudged, batch, rp),
                         ref)
    out = {"logit_gap_over_std": gap, "last_bit_control_over_std": last_bit,
           "no_qdq_control_over_std": logit_gap(torch, no_qdq, ref),
           "logit_gap_limit": min(GAP_MAX, GAP_FACTOR * last_bit)}
    # the controls, read from the ref backend alone, say whether this
    # check can tell the fused path from one without QDQ: not where the
    # ref backend's own last-bit spread, GAP_FACTOR times, reaches it
    out["held"] = GAP_FACTOR * last_bit < out["no_qdq_control_over_std"]
    return out


def lm_attend(inner, a, policy) -> None:
    """A captured ``TransformerLM._block_apply`` call's ``attend`` (index
    4), which closes over the forward's policy, replaced by the full
    sequence's attention under ``policy`` (positions 0..S-1, the layer's
    window)."""
    import torch

    B, S = a[1].shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=a[1].device)
    window = int(inner.layer_windows_py()[int(a[3].split(".")[1])])
    a[4] = lambda attn, ap, h, qa: attn.apply(
        ap, h, positions=positions[None].expand(B, S), policy=policy,
        window=window)


# each block method of a model's inner module: (index of its input x, index
# of its policy among the positional arguments[, a rewrite of the other
# arguments for ``policy``]); a method that returns a tuple returns x first
BLOCK_METHODS = {
    "vit": {"_block_apply": (1, 3)},       # (bp, x, positions, policy, q)
    "lm": {"_block_apply": (1, 2, lm_attend)},  # (bp, x, policy, name, attend)
    "hybrid": {"_mamba_block": (1, 2),     # (bp, x, policy)
               # (sparams, lora, x, x0, positions, policy)
               "_shared_block": (2, 5)},
    # (bp, x, positions, policy) / (bp, x, positions, enc, enc_pos, policy)
    "encdec": {"_enc_block": (1, 3), "_dec_block": (1, 5)},
}


def moe_routes():
    """A context that keeps every ``MoE.route`` call's (probs, dispatch),
    in call order, in the list it yields."""
    import contextlib

    from repro_torch.nn import moe as moe_mod

    @contextlib.contextmanager
    def ctx():
        routes = []
        route = moe_mod.MoE.route

        def recorded(self, router, xg):
            out = route(self, router, xg)
            routes.append((out[0], out[1]))
            return out

        moe_mod.MoE.route = recorded
        try:
            yield routes
        finally:
            moe_mod.MoE.route = route

    return ctx()


def moe_turns(torch, recs, top_k: int):
    """The tokens whose routing one MoE block's fused or reordered run
    turns against the ref run (``recs``: the block's (probs, dispatch) of
    its ref, fused and reordered runs, and any after them): a token whose
    top-k experts differ lies at a tie if its ref probabilities' margin
    between the k-th and the next expert is within GAP_FACTOR times twice
    the largest change the reordered run makes to any probability of the
    block (what a last bit can reach); a token whose experts agree but
    whose dispatch differs was displaced by a turn through the capacity
    fill (counted, allowed only in a group that holds a turn).  Returns
    (the rows to hold (B * S,), turns, displaced, all turns at ties)."""
    (p0, d0), *others = recs[:3]
    G, T, E = p0.shape
    keep = torch.ones((G, T), dtype=torch.bool, device=p0.device)
    top0 = torch.topk(p0, top_k, dim=-1).indices.sort(dim=-1).values
    sorted0 = p0.sort(dim=-1, descending=True).values
    margin = sorted0[..., top_k - 1] - sorted0[..., top_k] \
        if top_k < E else torch.full_like(sorted0[..., 0], float("inf"))
    reach = GAP_FACTOR * 2 * (others[-1][0] - p0).abs().max()
    turns = displaced = 0
    tied = True
    for p, d in others:
        sel0, sel = d0.sum(-1) > 0, d.sum(-1) > 0
        moved = (sel0 != sel).any(-1)  # (G, T)
        top = torch.topk(p, top_k, dim=-1).indices.sort(dim=-1).values
        turned = (top != top0).any(-1)
        tied = tied and bool((margin <= reach)[turned].all())
        cascade = moved & ~turned
        tied = tied and bool((turned.any(-1) | ~cascade.any(-1)).all())
        turns += int(turned.sum())
        displaced += int(cascade.sum())
        keep &= ~(turned | moved)
    return keep.reshape(-1), turns, displaced, tied


def block_calls(torch, model, params, batch, rp, methods: dict) -> tuple:
    """Every call of a method of ``methods`` (a table of BLOCK_METHODS) in
    one forward of ``batch`` under the policy ``rp``, as (name, args,
    kwargs), and ``run(name, args, kwargs, policy)``: that block again on
    the same input under ``policy``, its output x."""
    inner = model.inner
    cls = type(inner)
    saved = {n: getattr(cls, n) for n in methods}
    calls = []

    def capture(name):
        def call(self, *a, **kw):
            calls.append((name, a, kw))
            return saved[name](self, *a, **kw)
        return call

    for n in methods:
        setattr(cls, n, capture(n))
    try:
        with torch.no_grad():
            model.apply(params, batch, rp)
    finally:
        for n, fn in saved.items():
            setattr(cls, n, fn)

    def run(name, a, kw, policy):
        a = list(a)
        at, *rewrite = methods[name][1:]
        a[at] = policy
        for fn in rewrite:
            fn(inner, a, policy)
        y = saved[name](inner, *a, **kw)
        return y[0] if isinstance(y, tuple) else y

    return calls, run


def block_gaps(torch, model, params, batch, kp, methods: dict) -> dict:
    """Each block of the fused policy ``kp`` fed the ref backend's input of
    that block (every call of a method of ``methods``, a table of
    BLOCK_METHODS, captured from one ref-backend forward of ``batch``; a
    decoder block also gets the ref backend's encoder states) against the
    ref backend's output of the block: the root mean square of the
    difference (and its largest element) in units of the std of the
    block's update (its output less its input); beside it two controls on
    the same input: the ref backend's block with every matmul's f32 sum
    split into two halves of K (the same terms added in another order, as
    the kernels add them), and the fp32 block with no QDQ on the same
    weights (on compressed weights the same codes: a path that skips the
    activations' QDQ).  A code flipped at a rounding boundary moves a few
    elements; quantization moves all of them, so the mean square tells the
    two apart where a largest element cannot.

    The largest gap is held to at most GAP_FACTOR times the largest
    reordered control and GAP_MAX.  That bar separates no QDQ where it lies
    below the smallest no-QDQ control; where it does not (void), the
    median block's gap is held the same way to the medians, and that bar
    must separate.

    In an MoE block the router may turn a token's experts where two of its
    probabilities tie (``moe_turns``): such tokens, and those they
    displace, are left out of the mean square and counted; a turn away
    from a tie fails."""
    from repro_torch.core.policy import preset

    rp = ref_backend(kp)
    calls, run = block_calls(torch, model, params, batch, rp, methods)
    rows = []
    routing_tied = True
    with moe_routes() as routes:  # each MoE block run's (probs, dispatch)
        with torch.no_grad():
            for name, a, kw in calls:
                x = a[methods[name][0]]
                routes.clear()
                ref = run(name, a, kw, rp)
                fused = run(name, a, kw, kp)
                with split_contractions(torch):
                    moved = run(name, a, kw, rp)
                plain = run(name, a, kw, preset("fp32"))
                unit = (ref - x).std()
                ys = (fused, moved, plain)
                row = {"block": name.strip("_")}
                keep = slice(None)
                if routes:
                    keep, row["routing_turns"], row["displaced"], tied = \
                        moe_turns(torch, routes, model.cfg.top_k)
                    routing_tied = routing_tied and tied
                diff = [(y - ref).reshape(-1, y.shape[-1])[keep]
                        for y in ys]
                row["rms"] = [(d.square().mean().sqrt() / unit).item()
                              for d in diff]
                row["max"] = [(d.abs().max() / unit).item() for d in diff]
                # the share of the mean square its worst rows (tokens; 1 in
                # 64) carry: a code flipped at a boundary moves a few rows,
                # a wrong operation all of them
                sq = [d.square().sum(-1) for d in diff[:2]]
                k = max(1, sq[0].numel() // 64)
                row["worst_rows_share"] = [
                    (q.topk(k).values.sum() / q.sum().clamp_min(1e-30))
                    .item() for q in sq]
                row["index"] = len(rows)
                rows.append(row)
    col = lambda i: [r["rms"][i] for r in rows]
    gap, moved = max(col(0)), max(col(1))
    med = [statistics.median(col(i)) for i in range(3)]
    out = {"blocks": len(rows), "block_gap_rms": gap,
           "block_reordered_control_rms": moved,
           "block_no_qdq_control_rms": min(col(2)),
           "block_gap_limit": min(GAP_MAX, GAP_FACTOR * moved),
           "block_median_rms": med,
           "block_median_limit": min(GAP_MAX, GAP_FACTOR * med[1]),
           "worst": max(rows, key=lambda r: r["rms"][0]), "rows": rows}
    out["block_held"] = out["block_gap_limit"] < out["block_no_qdq_control_rms"]
    out["block_median_held"] = out["block_median_limit"] < med[2]
    out["block_ok"] = gap <= out["block_gap_limit"] and (out["block_held"] or (
        out["block_median_held"] and med[0] <= out["block_median_limit"]))
    if any("routing_turns" in r for r in rows):
        out["routing_turns"] = sum(r["routing_turns"] for r in rows)
        out["routing_displaced"] = sum(r["displaced"] for r in rows)
        out["routing_at_ties"] = routing_tied
        out["block_ok"] = out["block_ok"] and routing_tied
    return out


def block_text(out: dict) -> str:
    """``block_gaps``'s bars as one log phrase."""
    med = out["block_median_rms"]
    return (
        f"{out['blocks']} blocks on the ref backend's inputs: rms "
        f"{out['block_gap_rms']:.6g} of the update's std (limit "
        f"{out['block_gap_limit']:.6g}; sums reordered "
        f"{out['block_reordered_control_rms']:.6g}, no QDQ "
        f"{out['block_no_qdq_control_rms']:.6g}"
        + ("" if out["block_held"] else "; void: it does not separate no QDQ")
        + f"; median block {med[0]:.6g}, limit "
        f"{out['block_median_limit']:.6g}, reordered {med[1]:.6g}, no QDQ "
        f"{med[2]:.6g}" + (
            "" if out["block_held"] else " held" if out["block_median_held"]
            else " void") + (
            f"; router turns {out['routing_turns']} (all at ties: "
            f"{out['routing_at_ties']}), {out['routing_displaced']} tokens "
            "displaced, both left out" if "routing_turns" in out else "")
        + "; worst " + json.dumps(out["worst"]) + ")")


def vit_counted(torch, fn) -> tuple:
    """``fn()`` and the launches it made, read from the wrappers' counts:
    {wrapper: n} and {kernel: n} of flash_attention's and of abfp_matmul's
    x pre-pass."""
    from repro_torch.kernels import quant_matmul as qm

    def read():
        return (read_counts(), read_kernel_counts("flash_attention"),
                dict(qm.abfp_matmul.launches_by_kernel))

    before = read()
    out = fn()
    torch.cuda.synchronize()
    after = read()
    diff = [{k: a[k] - b[k] for k in a if a[k] != b[k]}
            for a, b in zip(after, before)]
    return out, {**diff[0], "by_kernel": {**diff[1], **diff[2]}}


def vit_want(cfg, mm: str, M: int) -> dict:
    """One fused forward's launches: every dense matmul through ``mm``,
    one flash_mma_kernel a layer; abfp_matmul's x pre-pass
    (qdq_stream_kernel) once where the head takes the decode regime."""
    n = vit_dense(cfg)
    by_kernel = {"flash_mma_kernel": cfg.n_layers}
    if mm == "abfp_matmul" and M <= 16:
        by_kernel["qdq_stream_kernel"] = 1
    return {mm: n, "flash_attention": cfg.n_layers, "by_kernel": by_kernel}


def vit_roles(cfg, kind: str, M: int) -> dict:
    """One fused forward's kernels by role, read from the profiler: every
    matmul but the head at 197 M rows (the prefill regime: x's codes, w's
    codes, the tensor-core contraction), the head at M rows (the decode
    regime up to 16), one flash_mma_kernel a layer."""
    n = vit_dense(cfg)
    head_decode = M <= 16
    want = {"x_codes": n - head_decode, "w_codes": n - head_decode,
            "mma": n - head_decode, "decode": int(head_decode),
            "flash": cfg.n_layers}
    if kind == "p_fp":
        want["x_qdq"] = int(head_decode)
    else:
        want["x_codes"] += int(head_decode)  # int8 decode: x's codes first
    return want


def vit_forward_report(torch, model, params, batch, policy, kind, label,
                       smi) -> dict:
    """A fused forward's wall ms (median of 5, between synchronizations),
    images/s, its kernels by role from one profiled forward (asserted),
    and device busy ms, idle share and top kernels of two more."""
    def forward():
        with torch.no_grad():
            model.apply(params, batch, policy)

    ms = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(ms[1:])
    M = len(batch["labels"])
    roles = {**REGIME_KERNELS["fp"], **REGIME_KERNELS["int8"],
             "flash_mma_kernel": "flash"}
    launched = device_launches(
        torch, lambda: (lead_spins(torch), forward()), roles,
        vit_roles(model.cfg, kind, M), label, roles_only=True)
    prof = profile_steps(torch, forward, 2, wall, "forward", lead=True)
    out = {"images": M, "wall_ms": wall, "wall_ms_each": ms,
           "images_per_s": M / wall * 1e3, "kernels_by_role": launched,
           **{k: v for k, v in prof.items()
              if k != "watched_kernels_per_step"}}
    log(f"  {label}: {wall:.2f} ms a forward, "
        f"{out['images_per_s']:.1f} images/s, device busy "
        f"{prof.get('device_busy_ms_per_step', 'not measured')} ms, idle "
        f"{prof.get('device_idle_share', 'not measured')} [{smi}]")
    return out


def vit_kernel_checks(torch, seed: int) -> dict:
    """Each kernel of the encoder's fused path against its plain version
    at the shapes that path gives it, timed beside the plain version and
    the card's bound: both dense matmuls at M = 197 x 64 for every (K, N)
    of ViT-B/16 and at the head (M = 64 and 16); flash_attention
    non-causal at 64 images, S = T = 197, 12 heads of 64 (SDPA, is_causal
    False, the yardstick)."""
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    rows = {"abfp_matmul": [], "abfp_matmul_int8": [], "flash_attention": []}
    M = 197 * VIT_BATCH
    for kind, name in (("fp", "abfp_matmul"), ("int8", "abfp_matmul_int8")):
        for label, K, N in VIT_MATMULS:
            rows[name].append(check_dense_matmul(
                torch, timer, gen, kind=kind, M=M, K=K, N=N,
                label=f"vit {label} M={M} K={K} N={N}"))
        for m in (VIT_BATCH, VIT_SMALL):
            rows[name].append(check_dense_matmul(
                torch, timer, gen, kind=kind, M=m, K=768, N=VIT_HEAD_N,
                label=f"vit head M={m} K=768 N={VIT_HEAD_N}"))
        torch.cuda.empty_cache()
    # read from the wrapper's count, as the ptq phase's check is
    rows["flash_attention"].append(check_flash(
        torch, timer, gen, B=VIT_BATCH, S=197, T=197, H=12, KV=12, D=64,
        causal=False, label=f"vit non-causal B={VIT_BATCH} S=T=197 "
        "H=KV=12 D=64", profiled=False))
    del timer
    torch.cuda.empty_cache()
    return rows


def vit_fused_runs(torch, model, params, batch, runs, no_qdq, label
                   ) -> dict:
    """Each fused run of ``runs`` ((label, path, vision policy)): its
    loss / top-1 beside the ref backend's, its logits' gap (``vit_gap``,
    asserted), and one forward's launches (asserted, ``vit_want``)."""
    out = {}
    M = len(batch["labels"])
    for name, kind, base in runs:
        kp = fixed_policy(kind, base=base)
        ev, got = vit_counted(torch, lambda: vit_eval(
            torch, model, params, batch, kp))
        want = vit_want(model.cfg, FIXED_PATHS[kind], M)
        if got != want:
            raise SystemExit(f"vit: {label} {name} forward launched {got}, "
                             f"expected {want}")
        gap, fused_logits = vit_counted(torch, lambda: vit_gap(
            torch, model, params, batch, kp, no_qdq))
        if fused_logits != want:  # the gap's one fused forward
            raise SystemExit(f"vit: {label} {name} logits' forward launched "
                             f"{fused_logits}, expected {want}")
        ev["ref_backend"] = vit_eval(torch, model, params, batch,
                                     ref_backend(kp))
        out[name] = {**ev, **gap, "launches": got}
        log(f"  {label} {name} fused: loss {ev['loss']:.6f} (ref backend "
            f"{ev['ref_backend']['loss']:.6f}); logits "
            f"{gap['logit_gap_over_std']:.3g} std from the ref backend's "
            f"(limit {gap['logit_gap_limit']:.3g}; last-bit control "
            f"{gap['last_bit_control_over_std']:.3g}, fp32 with no QDQ "
            f"{gap['no_qdq_control_over_std']:.3g}"
            + ("" if gap["held"] else "; void: the controls are as far "
               "apart as no QDQ, the blocks below are held instead") + ")")
        if gap["held"] and not gap["logit_gap_over_std"] <= gap[
                "logit_gap_limit"]:
            raise SystemExit(f"vit: {label} {name} fused logits: {gap}")
    return out


def vit_block_checks(torch, model, params, batch, runs, label, out) -> None:
    """``block_gaps`` of each fused run of ``runs`` into its row of
    ``out``, held."""
    for name, kind, base in runs:
        blocks = block_gaps(torch, model, params, batch,
                            fixed_policy(kind, base=base), BLOCK_METHODS["vit"])
        out[name].update(blocks)
        log(f"  {label} {name} " + block_text(blocks) + "; "
            + json.dumps(blocks["rows"]))
        if not blocks["block_ok"]:
            raise SystemExit(f"vit: {label} {name} fused blocks: " + str(
                {k: v for k, v in blocks.items() if k != "rows"}))


def vit_ptq(torch, cfg, seed: int, calib, evb, smi) -> dict:
    """PTQ over the encoder (``cfg`` with ``scan_layers=False``): one
    calibration over VIT_CALIB x VIT_SMALL images under w4a8_mse, then
    ``static_mse`` at w4a4_mse (the vision table's recipe) and
    ``smoothquant+gptq+static_mse`` from it, each q tree evaluated through
    the ref backend; seconds, Hessian bytes, dropped sites, peak memory."""
    from repro_torch.core.policy import preset, replace_enabled
    from repro_torch.core.recipe import apply_recipe, quantizes_weights_offline
    from repro_torch.models import build_model
    from repro_torch.models import quant_transforms as qt
    from repro_torch.nn.module import make_generator

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg = cfg.replace(scan_layers=False)
    model = build_model(cfg)
    params = model.init(make_generator(seed, "cuda"))
    obs, pol = preset("w4a8_mse"), preset("w4a4_mse")
    report = {"model": cfg.name, "calib_batches": [VIT_CALIB, VIT_SMALL],
              "recipes": {}}
    with PTQTimers(torch) as tm:
        cal = qt.calibrate(model, params, calib, obs)
    report.update(calibration_s=tm.calib_s[0], sites=len(cal.stats))
    for name, n_cal in VIT_PTQ:
        with PTQTimers(torch) as tm:
            t0 = time.perf_counter()
            res = apply_recipe(name, model, params, calib, pol, calib=cal,
                               calib_policy=obs)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if res.n_calibrations != n_cal or len(tm.calib_s) != n_cal:
            raise SystemExit(f"vit: {name} ran {res.n_calibrations} "
                             f"calibrations, expected {n_cal}")
        if res.dropped_sites != VIT_DROPPED:
            raise SystemExit(f"vit: {name} dropped {res.dropped_sites}")
        off = quantizes_weights_offline(name)
        ev = vit_eval(torch, model, res.params, evb,
                      replace_enabled(pol, weight=None) if off else pol,
                      q=res.qtree)
        row = {**ev, "calibrations": res.n_calibrations,
               "steps": [s for s, _ in res.steps], "wall_s": wall,
               "calibration_s": tm.calib_s,
               "hessian_bytes": tm.hessian_bytes,
               "dropped_sites": list(res.dropped_sites)}
        if tm.gptq_s:
            if len(tm.gptq_s) != 6 * cfg.n_layers:
                raise SystemExit(f"vit: {name} ran GPTQ on "
                                 f"{len(tm.gptq_s)} kernels")
            row.update(gptq_kernels=len(tm.gptq_s),
                       gptq_total_s=sum(tm.gptq_s),
                       gptq_median_s=statistics.median(tm.gptq_s))
        report["recipes"][name] = row
        log(f"  ptq {name}: loss {ev['loss']:.6f}, top-1 {ev['top1']:.4f}, "
            f"{res.n_calibrations} calibrations, {wall:.2f} s [{smi}]")
        del res
    report["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del params, model, cal
    torch.cuda.empty_cache()
    return report


def phase_vit(torch, seed: int, smi: str) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import preset, with_attn_backend
    from repro_torch.data import ImageLoader
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator

    log("== vit: vit-b16 and deit-s16 at full width and depth, 224 x 224 "
        "images")
    t_phase = time.perf_counter()
    kernel_rows = vit_kernel_checks(torch, seed)
    cfg = get_config("vit-b16")
    x, y = vit_images(cfg, VIT_CALIB * VIT_SMALL + VIT_BATCH, seed)
    loader = ImageLoader(x[:VIT_CALIB * VIT_SMALL], y[:VIT_CALIB * VIT_SMALL],
                         global_batch=VIT_SMALL, seed=77)
    calib = [loader.batch_at(i) for i in range(VIT_CALIB)]
    ev = {"images": torch.from_numpy(np.ascontiguousarray(
              x[VIT_CALIB * VIT_SMALL:])).cuda(),
          "labels": torch.from_numpy(y[VIT_CALIB * VIT_SMALL:]).cuda()}
    small = {k: v[:VIT_SMALL] for k, v in ev.items()}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    report = {"kernel_rows": kernel_rows, "images": VIT_BATCH}
    model = build_model(cfg)
    params = model.init(make_generator(seed, "cuda"))

    # the vision table's policies through the QDQ-sim (plain PyTorch)
    report["qdq_sim"] = {}
    for name in VIT_SIM:
        pol = with_attn_backend(preset(name), "ref")
        r, got = vit_counted(torch, lambda: vit_eval(
            torch, model, params, ev, pol))
        if got != {"by_kernel": {}}:
            raise SystemExit(f"vit: the QDQ-sim under {name} launched {got}")
        report["qdq_sim"][name] = r
        log(f"  {name} (ref backend): loss {r['loss']:.6f}, top-1 "
            f"{r['top1']:.4f}, {r['wall_ms']:.1f} ms")
    no_qdq = vit_logits(torch, model, params, ev, preset("fp32"))

    # the fused kernels: every count from 0 before the path, read after
    reset_counts()
    report["fused"] = vit_fused_runs(torch, model, params, ev, VIT_FUSED,
                                     no_qdq, cfg.name)
    small_kp = fixed_policy("p_fp")
    _, got = vit_counted(torch, lambda: vit_logits(
        torch, model, params, small, small_kp))
    want = vit_want(cfg, "abfp_matmul", VIT_SMALL)
    if got != want:
        raise SystemExit(f"vit: the {VIT_SMALL}-image P-fp forward launched "
                         f"{got}, expected {want}")
    deit_cfg = get_config("deit-s16")
    deit = build_model(deit_cfg)
    deit_params = deit.init(make_generator(seed, "cuda"))
    deit_no_qdq = vit_logits(torch, deit, deit_params, ev, preset("fp32"))
    report["deit"] = {"fused": vit_fused_runs(
        torch, deit, deit_params, ev, VIT_FUSED[1:2], deit_no_qdq,
        deit_cfg.name)}
    counts = read_counts()
    report["launches"] = counts
    report["launches_by_kernel"] = {
        "flash_attention": read_kernel_counts("flash_attention"),
        "abfp_matmul": read_kernel_counts("abfp_matmul")}
    # 3 P-fp and 1 P-int8 run of ViT-B, 1 P-fp of DeiT-S, 2 forwards each
    # (loss, logits), and the 16-image P-fp forward
    n, L = vit_dense(cfg), cfg.n_layers
    want = {"abfp_matmul": n * (2 * 4 + 1), "abfp_matmul_int8": n * 2,
            "flash_attention": L * (2 * 5 + 1)}
    got = {k: v for k, v in counts.items() if v}
    if got != want or report["launches_by_kernel"]["flash_attention"] != {
            "flash_mma_kernel": want["flash_attention"]}:
        raise SystemExit(f"vit: the fused runs launched {got} "
                         f"({report['launches_by_kernel']}), expected {want}")
    log("  launches: " + json.dumps(report["launches_by_kernel"]))
    vit_block_checks(torch, model, params, ev, VIT_FUSED, cfg.name,
                     report["fused"])
    vit_block_checks(torch, deit, deit_params, ev, VIT_FUSED[1:2],
                     deit_cfg.name, report["deit"]["fused"])

    # wall time, kernels by role and device time of single forwards
    report["forwards"] = {
        "vit-b16 p_fp w4a8_abfp": vit_forward_report(
            torch, model, params, ev, fixed_policy("p_fp"),
            "p_fp", f"vit-b16 P-fp forward, {VIT_BATCH} images", smi),
        "vit-b16 p_int8": vit_forward_report(
            torch, model, params, ev, fixed_policy("p_int8"),
            "p_int8", f"vit-b16 P-int8 forward, {VIT_BATCH} images", smi),
        f"vit-b16 p_fp w4a8_abfp {VIT_SMALL} images": vit_forward_report(
            torch, model, params, small, small_kp, "p_fp",
            f"vit-b16 P-fp forward, {VIT_SMALL} images", smi),
        "deit-s16 p_fp w4a8_abfp": vit_forward_report(
            torch, deit, deit_params, ev,
            fixed_policy("p_fp"), "p_fp",
            f"deit-s16 P-fp forward, {VIT_BATCH} images", smi)}
    report["forward_peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    del params, model, deit_params, deit, no_qdq, deit_no_qdq
    torch.cuda.empty_cache()

    report["ptq"] = vit_ptq(torch, cfg, seed, calib, ev, smi)
    pq = report["ptq"]
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"  ptq: calibration {pq['calibration_s']:.3f} s ({pq['sites']} "
        f"sites), GPTQ "
        + json.dumps({k: [r.get("gptq_total_s"), r.get("gptq_median_s")]
                      for k, r in pq["recipes"].items()})
        + f" s, Hessian bytes "
        f"{max(r['hessian_bytes'] for r in pq['recipes'].values())}, "
        f"peak {pq['peak_memory_bytes']} bytes [{smi}]")
    log(f"  forward peak memory {report['forward_peak_memory_bytes']} "
        f"bytes; phase {report['phase_s']:.1f} s [{smi}]")
    log("  " + json.dumps({k: v for k, v in report.items()
                           if k != "kernel_rows"}))
    return report


# --------------------------------------------------------------------------
# phase: ssm
# --------------------------------------------------------------------------
# mamba2-130m served by the fixed-slot engine: one prompt below, one at and
# the rest past the chunk of 256; 1,500 tokens span 6 chunks, the last one
# padded
SSM_PROMPTS = (41, 77, 149, 256, 300, 1500)
SSM_NEW = 16
SSM_MAX_LEN = 2048
# the engine's policies -> the wrapper of the Mamba2 projections (P-C: the
# tied head stays dense, through abfp_matmul)
SSM_MM = {"p_fp": "abfp_matmul", "p_int8": "abfp_matmul_int8",
          "p_c": "quant_matmul"}
SSM_GAP_TOKENS = (2, 300)  # the logits checks' batch: across the chunk
ZAMBA_LOSS = (2, 256)
ZAMBA_PREFILL = (2, 300)
ZAMBA_MAX_LEN = 332
ZAMBA_STEPS = 16
# zamba2-7b's depth, cut to keep the whole script near half its time
# limit: 9 groups of two Mamba2 blocks and the shared attention block
ZAMBA_LAYERS = 27
# the profiler's names of the time a profiled step spends in the SSD scan
# and the causal conv (record_function ranges around Mamba2's methods)
SSM_RANGES = {"_ssd": "ssm._ssd", "_conv": "ssm._conv",
              "_conv_step": "ssm._conv", "_state_step": "ssm._ssd"}


def ssm_policy(kind: str):
    """P-fp and P-C: w4a8_abfp, ``fused``; P-int8: w4a8_int8_native (the
    fixed phase's policies; the SSM family has no attention to route)."""
    return fixed_policy("p_int8" if kind == "p_int8" else "p_fp")


def ssm_matmuls(cfg) -> list:
    """(label, K, N, calls a forward, part) of an SSM or hybrid forward's
    dense matmuls; part "head" for the tied head, else "body"."""
    di = cfg.ssm_expand * cfg.d_model
    proj = (2 * di + 2 * cfg.ssm_groups * cfg.ssm_state
            + di // cfg.ssm_head_dim)
    d, head = cfg.d_model, ("head", cfg.d_model, cfg.vocab_padded, 1, "head")
    if cfg.family == "ssm":
        L = cfg.n_layers
        return [("in_proj", d, proj, L, "body"),
                ("out_proj", di, d, L, "body"), head]
    G = cfg.n_layers // cfg.shared_attn_every
    M = G * (cfg.shared_attn_every - 1)
    hd = cfg.n_heads * cfg.head_dim_
    kv = cfg.n_kv * cfg.head_dim_
    return [("in_proj", d, proj, M, "body"), ("out_proj", di, d, M, "body"),
            ("q", 2 * d, hd, G, "body"), ("k,v", 2 * d, kv, 2 * G, "body"),
            ("o", hd, d, G, "body"), ("wi,wg", d, cfg.d_ff, 2 * G, "body"),
            ("wo", cfg.d_ff, d, G, "body"), head]


def ssm_forward_calls(cfg, kind: str) -> dict:
    """Wrapper calls of one fused forward: every matmul through the
    policy's kernel, but under P-C the body through quant_matmul and the
    tied head through abfp_matmul."""
    calls = {name: 0 for name in KERNELS}
    for _, _, _, n, part in ssm_matmuls(cfg):
        mm = "abfp_matmul" if kind == "p_c" and part == "head" else \
            SSM_MM[kind]
        calls[mm] += n
    return calls


def ssm_prepass(cfg, kind: str, M: int, M_head: int) -> int:
    """abfp_matmul's x pre-pass (qdq_stream_kernel) in one forward: each of
    its calls of up to 16 rows."""
    if kind == "p_int8":
        return 0
    return sum(n for _, _, _, n, part in ssm_matmuls(cfg)
               if (part == "head" or kind == "p_fp")
               and (M_head if part == "head" else M) <= 16)


def ssm_role_names(kind: str) -> dict:
    """Kernel-name substring -> role, for the kernels of ``kind``'s path
    (P-C: quant_matmul's and abfp_matmul's), and both attention wrappers'
    kernels, which no SSM path launches."""
    kinds = {"p_fp": ("fp",), "p_int8": ("int8",), "p_c": ("quant", "fp")}
    names = {k: f"{mk} {role}" for mk in kinds[kind]
             for k, role in REGIME_KERNELS[mk].items()
             if k != "at::native::"}
    names.update({"flash_mma_kernel": "flash", "attention_": "flash_quant"})
    return names


def ssm_roles(cfg, kind: str, M: int, M_head: int) -> dict:
    """One fused forward's kernels by role (``regime_want`` of each matmul
    at its rows: M in the body, M_head at the head), every other role of
    the path's kernels and the attention kernels 0."""
    from repro_torch.kernels import quant_matmul as qm

    want = dict.fromkeys(ssm_role_names(kind).values(), 0)
    for _, K, N, n, part in ssm_matmuls(cfg):
        rows = M_head if part == "head" else M
        mk = ("fp" if part == "head" and kind == "p_c" else
              {"p_fp": "fp", "p_int8": "int8", "p_c": "quant"}[kind])
        wide = mk == "quant" and N >= qm.CONTRACT_MIN_N
        for role, c in regime_want(mk, rows, 64, wide).items():
            want[f"{mk} {role}"] += c * n
    return want


class CountingModel(TimedModel):
    """A model facade that keeps, for every prefill and decode step, its
    wall ms (between two synchronizations), its rows and the wrappers'
    launches and abfp_matmul's x pre-pass it made."""

    def __init__(self, model, torch):
        super().__init__(model, torch)
        self.prefills = []
        self.ticks = []

    def _counted(self, fn, out, rows, *args, **kw):
        from repro_torch.kernels import quant_matmul as qm

        before = (read_counts(), qm.abfp_matmul.launches_by_kernel[
            "qdq_stream_kernel"])
        self._torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args, **kw)
        self._torch.cuda.synchronize()
        after = (read_counts(), qm.abfp_matmul.launches_by_kernel[
            "qdq_stream_kernel"])
        out.append({"rows": rows, "ms": (time.perf_counter() - t0) * 1e3,
                    "launches": {k: v - before[0][k]
                                 for k, v in after[0].items()},
                    "prepass": after[1] - before[1]})
        return res

    def prefill(self, params, batch, *args, **kw):
        return self._counted(self._model.prefill, self.prefills,
                             batch["tokens"].shape[1], params, batch,
                             *args, **kw)

    def decode_step(self, params, token, *args, **kw):
        return self._counted(self._model.decode_step, self.ticks,
                             token.shape[0], params, token, *args, **kw)


def ssm_ranges(torch):
    """A context that wraps Mamba2's ``_ssd``, ``_conv``, ``_conv_step``
    and ``_state_step`` in ``record_function`` ranges (``SSM_RANGES``), so a
    profile can tell their device time apart."""
    import contextlib

    from repro_torch.nn.ssm import Mamba2

    @contextlib.contextmanager
    def ctx():
        saved = {name: getattr(Mamba2, name) for name in SSM_RANGES}

        def wrap(name, fn):
            def call(*a, **kw):
                with torch.profiler.record_function(SSM_RANGES[name]):
                    return fn(*a, **kw)
            return call

        for name, fn in saved.items():
            setattr(Mamba2, name, wrap(name, fn))
        try:
            yield
        finally:
            for name, fn in saved.items():
                setattr(Mamba2, name, fn)

    return ctx()


def ssm_profile(torch, step, n_steps: int, step_ms: float, kind: str,
                roles: dict) -> dict:
    """``n_steps`` calls of ``step`` under the profiler, with the SSD scan
    and the conv in ranges: device busy ms a step and idle share against
    ``step_ms`` (wall, unprofiled), launches a step, top kernels, and the
    device ms a step split into the SSD scan (its einsums, cumsum and
    exps), the conv, the port's matmul kernels (by ``roles``: kernel-name
    substrings) and the rest."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    labels = set(SSM_RANGES.values())
    torch.cuda.synchronize()
    with ssm_ranges(torch), profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as p:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    events = p.key_averages()
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in events
           if e.device_type == DeviceType.CUDA
           and e.self_device_time_total > 0 and e.key not in labels]
    busy = sum(ms for _, ms, _ in dev) / n_steps
    out = {f"{kind}_steps_profiled": n_steps,
           f"{kind}_step_ms_unprofiled": step_ms,
           "aten_ops_per_step": sum(e.count for e in events
                                    if e.key.startswith("aten::")) / n_steps}
    if busy <= 0:
        out["device_time"] = "not measured (the profiler saw no device time)"
        return out
    split = {label: sum(e.device_time_total for e in events
                        if e.key == label and e.device_type == DeviceType.CPU)
             / 1e3 / n_steps for label in sorted(labels)}
    split["matmul kernels"] = sum(
        ms for k, ms, _ in dev if any(r in k for r in roles)) / n_steps
    split["rest"] = busy - sum(split.values())
    out.update({"device_busy_ms_per_step": busy,
                "device_idle_share": max(0.0, 1.0 - busy / step_ms),
                "device_kernel_launches_per_step":
                    sum(c for _, _, c in dev) / n_steps,
                "device_ms_split_per_step": split,
                "top_device_kernels_ms_per_step": [
                    {"name": k.replace("void ", "")[:60], "ms": ms / n_steps,
                     "launches": c / n_steps}
                    for k, ms, c in sorted(dev, key=lambda d: -d[1])[:10]]})
    return out


def ssm_kernel_checks(torch, seed: int) -> dict:
    """The kernels at the SSM slice's shapes, held against their plain
    versions and timed beside them and the bound: mamba2-130m's in_proj
    (768 x 3,352: N ragged), out_proj and tied head under both dense
    matmuls at a tick (M = 4) and the 1,500-token prefill, its Mamba2
    projections under quant_matmul (P-C); zamba2-7b's matmuls under
    abfp_matmul at a decode step (M = 2) and the prefill (M = 600): in_proj
    (N = 14,576), out_proj and the shared q, k, v (K = 7,168), o, wi / wg,
    wo (K = 14,336) and the head; abfp_qdq at the pre-pass shapes of a
    P-fp tick and decode step, and at the ViT's 16-image head (M = 16,
    K = 768)."""
    from repro_torch.configs import get_config

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 13)
    rows = {"abfp_matmul": [], "abfp_matmul_int8": [], "quant_matmul": [],
            "abfp_qdq": []}
    mamba, zamba = get_config("mamba2-130m"), get_config("zamba2-7b")
    for label, K, N, _, part in ssm_matmuls(mamba):
        for M in ((4,) if part == "head" else (4, 1500)):
            for kind, name in (("fp", "abfp_matmul"),
                               ("int8", "abfp_matmul_int8")):
                rows[name].append(check_dense_matmul(
                    torch, timer, gen, kind=kind, M=M, K=K, N=N,
                    label=f"mamba2 {label} M={M} K={K} N={N}"))
            if part == "body":
                rows["quant_matmul"].append(check_quant_matmul(
                    torch, timer, gen, M=M, K=K, N=N, packed=True,
                    label=f"mamba2 {label} M={M} K={K} N={N} int4"))
    seen = set()
    for label, K, N, _, _ in ssm_matmuls(zamba):
        if (K, N) in seen:  # out_proj and q, k, v share (7168, 3584)
            continue
        seen.add((K, N))
        for M in (2, 600):
            rows["abfp_matmul"].append(check_dense_matmul(
                torch, timer, gen, kind="fp", M=M, K=K, N=N,
                label=f"zamba2 {label} M={M} K={K} N={N}"))
        torch.cuda.empty_cache()
    for M, K, where in ((16, 768, "vit head"), (4, 768, "mamba2 tick"),
                        (4, 1536, "mamba2 tick"), (2, 3584, "zamba2 step"),
                        (2, 7168, "zamba2 step"), (2, 14336, "zamba2 step")):
        rows["abfp_qdq"].append(check_abfp_qdq(
            torch, timer, gen, M=M, K=K, n=64, fmt_name="int8",
            label=f"{where} pre-pass M={M} K={K} int8", profiled=False))
    del timer
    torch.cuda.empty_cache()
    return rows


def ssm_requests(cfg, seed: int):
    import numpy as np

    from repro_torch.serve.engine import Request

    rng = np.random.RandomState(seed + 5)
    return [Request(uid=uid,
                    prompt=rng.randint(0, cfg.vocab, size=n).astype(np.int32),
                    max_new_tokens=SSM_NEW)
            for uid, n in enumerate(SSM_PROMPTS)]


def ssm_state_bytes(state, n_slots: int) -> float:
    return sum(t.numel() * t.element_size() for t in _leaves(state.ssm)
               if hasattr(t, "numel")) / n_slots


def ssm_serve(torch, model, params, kind: str, seed: int, smi: str
              ) -> dict:
    """mamba2-130m through the fixed-slot engine under ``kind``: the six
    requests drained, every prefill's and tick's launches asserted from the
    wrappers' counts (each forward ``ssm_forward_calls``, the x pre-pass
    ``ssm_prepass``; no other kernel), then one tick (4 slots decoding)
    and the 1,500-token prefill read by role from the profiler (asserted:
    ``ssm_roles``) and profiled."""
    cfg = model.cfg
    counted = CountingModel(model, torch)
    eng = fixed_engine(counted, params, ssm_policy(kind), n_slots=4,
                       max_len=SSM_MAX_LEN, compress=(kind == "p_c"))
    reqs = ssm_requests(cfg, seed)
    for r in reqs:
        eng.submit(r)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    while eng._has_work():
        eng.tick()
        if eng.ticks > 500:
            raise SystemExit(f"ssm {kind}: the engine did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_completions(cfg, eng, eng.done, reqs)
    label = f"ssm {cfg.name} {kind}"
    want = ssm_forward_calls(cfg, kind)
    for what, log_ in (("prefill", counted.prefills),
                       ("tick", counted.ticks)):
        for call in log_:
            # a prefill's head takes its last row, a tick every slot's
            pre = (ssm_prepass(cfg, kind, call["rows"], 1)
                   if what == "prefill" else ssm_prepass(cfg, kind, 4, 4))
            if call["launches"] != want or call["prepass"] != pre:
                raise SystemExit(
                    f"{label}: a {what} of {call['rows']} rows launched "
                    f"{call['launches']} and {call['prepass']} x pre-passes,"
                    f" expected {want} and {pre}")
    passes = len(counted.prefills) + len(counted.ticks)
    if passes != eng.prefills + eng.ticks:
        raise SystemExit(f"{label}: {passes} forwards counted")
    n_tok = sum(len(c.tokens) for c in eng.done)
    long_ms = [c["ms"] for c in counted.prefills
               if c["rows"] == max(SSM_PROMPTS)]
    report = {
        "policy": kind, "requests": len(eng.done),
        "prompt_lens": list(SSM_PROMPTS), "generated_tokens": n_tok,
        "prefills": eng.prefills, "ticks": eng.ticks, "wall_s": wall,
        "tokens_per_s": n_tok / wall,
        "prefill_ms": {c["rows"]: c["ms"] for c in counted.prefills},
        "prefill_1500_ms": long_ms[0],
        "tick_ms_median": statistics.median(c["ms"] for c in counted.ticks),
        "launches": counts,
        "prepass_launches": sum(c["prepass"]
                                for c in counted.prefills + counted.ticks),
        "slot_state_bytes": ssm_state_bytes(eng.state, eng.n_slots),
        "weight_bytes": (None if eng.weight_bytes is None else {
            k: eng.weight_bytes[k] for k in ("dense_kernel_bytes",
                                             "resident_kernel_bytes",
                                             "compressed_sites")}),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    log(f"  {label}: {n_tok} tokens in {wall:.2f} s "
        f"({report['tokens_per_s']:.1f} tokens/s), tick "
        f"{report['tick_ms_median']:.2f} ms, 1500-token prefill "
        f"{report['prefill_1500_ms']:.2f} ms [{smi}]")
    # one tick with every slot decoding, and the 1500-token prefill: their
    # kernels by role from the profiler, then a profile of each
    names = ssm_role_names(kind)
    for r in make_requests(cfg, seed + 1)[:4]:
        eng.submit(r)
    while eng.queue or not eng.active.all():
        eng.tick()
    # each capture starts with spin kernels: late in a whole run the
    # profiler has dropped a capture's first launches (see lead_spins)
    report["tick_roles"] = device_launches(
        torch, lambda: (lead_spins(torch), eng._decode()), names,
        ssm_roles(cfg, kind, 4, 4), f"{label} tick", roles_only=True)
    tick_ms = statistics.median(eng.decode_ms[-8:])  # tick and sampling
    report["tick_profile"] = ssm_profile(torch, eng._decode, 4, tick_ms,
                                         "tick", names)
    eng.run_until_done(max_ticks=500)
    toks = torch.as_tensor(reqs[-1].prompt[None], device="cuda")

    def prefill():
        return model.prefill(eng.params, {"tokens": toks}, eng.policy,
                             max_len=SSM_MAX_LEN)

    report["prefill_roles"] = device_launches(
        torch, lambda: (lead_spins(torch), prefill()), names,
        ssm_roles(cfg, kind, toks.shape[1], 1),
        f"{label} 1500-token prefill", roles_only=True)
    report["prefill_profile"] = ssm_profile(
        torch, prefill, 1, report["prefill_1500_ms"], "prefill", names)
    for what in ("tick", "prefill"):
        prof = report[f"{what}_profile"]
        log(f"  {label} {what}: device busy "
            f"{prof.get('device_busy_ms_per_step', 'not measured')} ms, idle "
            f"{prof.get('device_idle_share', 'not measured')}; split "
            + json.dumps(prof.get("device_ms_split_per_step")) + f" [{smi}]")
        log(f"  {label} {what} profile: " + json.dumps(prof))
    log(f"  {label}: " + json.dumps({k: v for k, v in report.items()
                                     if not k.endswith("_profile")}))
    del eng
    torch.cuda.empty_cache()
    return report


def split_contractions(torch):
    """A context in which the plain paths add each contraction's terms in
    another order: every f32 matmul as the sum of its two halves of K
    (the MoE block's router and expert contractions too), and every group
    sum of codes as the sum of its two halves of the groups — the last-bit
    control of the logits and block checks."""
    import contextlib

    from repro_torch.core import simulate as sim
    from repro_torch.nn import moe as moe_mod

    fp_matmul, contract = sim._fp_matmul, sim.group_contract
    moe_contract = moe_mod.contract

    def split_k(x, w, compute_dtype):
        torch.backends.cuda.matmul.allow_tf32 = False
        h = w.shape[0] // 2
        xc, wc = x.to(compute_dtype), w.to(compute_dtype)
        y = torch.matmul(xc[..., :h], wc[:h]) + torch.matmul(xc[..., h:],
                                                             wc[h:])
        return y.to(torch.float32)

    def split_groups(xc, xs, wc, ws, *, max_abs_product):
        h = xc.shape[-2] // 2
        if h == 0:
            return contract(xc, xs, wc, ws, max_abs_product=max_abs_product)
        return (contract(xc[..., :h, :], xs[..., :h], wc[:, :h], ws[:, :h],
                         max_abs_product=max_abs_product)
                + contract(xc[..., h:, :], xs[..., h:], wc[:, h:],
                           ws[:, h:], max_abs_product=max_abs_product))

    def split_einsum(spec, a, b):
        # the contracted axis: a's last, wherever it sits in b
        ins, _ = spec.split("->")
        sa, sb = ins.split(",")
        ax = sb.index(sa[-1])
        h = a.shape[-1] // 2
        lo = [slice(None)] * b.ndim
        hi = list(lo)
        lo[ax], hi[ax] = slice(None, h), slice(h, None)
        return (moe_contract(spec, a[..., :h], b[tuple(lo)])
                + moe_contract(spec, a[..., h:], b[tuple(hi)]))

    @contextlib.contextmanager
    def ctx():
        sim._fp_matmul, sim.group_contract = split_k, split_groups
        moe_mod.contract = split_einsum
        try:
            yield
        finally:
            sim._fp_matmul, sim.group_contract = fp_matmul, contract
            moe_mod.contract = moe_contract

    return ctx()


def lm_logits(torch, model, params, toks, policy):
    with torch.no_grad():
        return model.apply(params, {"tokens": toks}, policy)[0][
            ..., :model.cfg.vocab]


# the share of an MoE model's tokens that lm_gap may leave out for router
# turns: the whole-logits bar must still judge most of them
LOGIT_LEFT_OUT_MAX = 0.5


def lm_gap(torch, model, params, toks, kp, no_qdq) -> dict:
    """The fused policy ``kp``'s logits against its ref backend's, in units
    of their std, beside the ref backend moved by a last bit (its sums
    reordered: ``split_contractions``) and the fp32 weights with no QDQ
    (``no_qdq``, their logits).  Held (at most GAP_FACTOR times the control
    and GAP_MAX) only where GAP_FACTOR times the control lies below the
    no-QDQ control: on random weights a deep recurrence may carry a last
    bit as far as no QDQ.  In an MoE model a token whose experts turn in
    some layer (``moe_turns``) against the ref run, in the fused or the
    reordered run, and a token it displaces, are left out of the logits
    compared, and counted, and the check fails where they are more than
    LOGIT_LEFT_OUT_MAX of the tokens.  Whether a turn lay at a tie is not
    judged here: after a first turn every later layer's input differs from
    the ref run's, so its probabilities are not the ref run's moved by a
    last bit; ``block_gaps`` judges each turn where each block gets the
    same input."""
    rp = ref_backend(kp)
    with moe_routes() as routes:
        ref = lm_logits(torch, model, params, toks, rp)
        n = len(routes)
        fused = lm_logits(torch, model, params, toks, kp)
        with split_contractions(torch):
            moved = lm_logits(torch, model, params, toks, rp)
    V = ref.shape[-1]
    keep = torch.ones(ref.numel() // V, dtype=torch.bool, device=ref.device)
    turns = displaced = 0
    for i in range(n):  # each MoE layer: ref, fused, reordered
        k, t, d, _ = moe_turns(torch, routes[i::n], model.cfg.top_k)
        keep &= k
        turns, displaced = turns + t, displaced + d

    def gap(a):
        d = (a - ref).reshape(-1, V)[keep]
        return (d.abs().max() / ref.std()).item()

    out = {"logit_gap_over_std": gap(fused),
           "reordered_control_over_std": gap(moved),
           "no_qdq_control_over_std": logit_gap(torch, no_qdq, ref)}
    out["logit_gap_limit"] = min(GAP_MAX, GAP_FACTOR
                                 * out["reordered_control_over_std"])
    out["held"] = (GAP_FACTOR * out["reordered_control_over_std"]
                   < out["no_qdq_control_over_std"])
    out["ok"] = (not out["held"]
                 or out["logit_gap_over_std"] <= out["logit_gap_limit"])
    if n:
        left = int((~keep).sum())
        out.update(logit_routing_turns=turns,
                   logit_routing_displaced=displaced,
                   logit_rows_left_out=left,
                   logit_rows_left_out_limit=LOGIT_LEFT_OUT_MAX * keep.numel())
        out["ok"] = out["ok"] and left <= out["logit_rows_left_out_limit"]
    return out


def ssm_numerics(torch, model, params, kp, label, smi, served=None) -> dict:
    """``lm_gap`` and ``block_gaps`` of one fused policy on
    SSM_GAP_TOKENS (``served``: the compressed tree and its serving
    policy, held against the same tree through the plain paths), asserted.
    """
    import numpy as np

    from repro_torch.core.policy import preset

    cfg = model.cfg
    rng = np.random.RandomState(17)
    shape = SSM_GAP_TOKENS if cfg.family == "ssm" else ZAMBA_LOSS
    toks = torch.as_tensor(rng.randint(0, cfg.vocab, shape), device="cuda")
    no_qdq = lm_logits(torch, model, params, toks, preset("fp32"))
    tree, pol = (params, kp) if served is None else served
    out = lm_gap(torch, model, tree, toks, pol, no_qdq)
    out.update(block_gaps(torch, model, tree, {"tokens": toks}, pol,
                          BLOCK_METHODS["hybrid" if cfg.family == "hybrid"
                                        else "lm"]))
    log(f"  {label}: logits {out['logit_gap_over_std']:.6g} std from the "
        f"ref backend's (limit {out['logit_gap_limit']:.6g}; sums reordered "
        f"{out['reordered_control_over_std']:.6g}, no QDQ "
        f"{out['no_qdq_control_over_std']:.6g}"
        + ("" if out["held"] else "; void: a last bit moves them as far as "
           "no QDQ, the blocks are held instead") + "); "
        + block_text(out) + f" [{smi}]")
    del out["rows"]
    if not (out["ok"] and out["block_ok"]):
        raise SystemExit(f"{label}: " + json.dumps(out))
    return out


def recurrence_check(torch, model, params, toks, n: int, label: str,
                     max_len: int | None = None) -> dict:
    """fp32, no kernels: ``prefill`` of the first n tokens then decode
    steps to the end give the logits a ``prefill`` of all of them gives at
    the last position, within rtol 5e-3 / atol 5e-4."""
    from repro_torch.core.policy import preset

    pol = preset("fp32")
    before = read_counts()
    with torch.no_grad():
        want, _ = model.prefill(params, {"tokens": toks}, pol,
                                max_len=max_len)
        got, st = model.prefill(params, {"tokens": toks[:, :n]}, pol,
                                max_len=max_len)
        for t in range(n, toks.shape[1]):
            got, st = model.decode_step(params, toks[:, t:t + 1], st, pol)
    if read_counts() != before:
        raise SystemExit(f"{label}: the fp32 recurrence launched a kernel")
    err = (got - want).abs()
    excess = (err - (5e-4 + 5e-3 * want.abs())).max().item()
    out = {"prefix": n, "tokens": toks.shape[1],
           "max_abs_err": err.max().item(), "ok": excess <= 0}
    log(f"  {label} recurrence {n} -> {toks.shape[1]}: " + json.dumps(out))
    if not out["ok"]:
        raise SystemExit(f"{label}: prefill + decode disagrees with the "
                         f"longer prefill: {out}")
    return out


def ssm_reduced(torch, seed: int) -> dict:
    """mamba2-130m ``.reduced()`` served on the card through the kernels
    against the CPU's plain path (the arithmetic the CPU tests hold
    token-identical to the JAX reference), as phase ``reduced`` holds the
    fixed-slot engine: P-fp, P-int8 and P-C at group 32, every turned token
    judged by the margin rule."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.serve.engine import Request

    cfg = get_config("mamba2-130m").reduced()
    models = {"cpu": build_model(cfg, device="cpu"), "cuda": build_model(cfg)}
    params = models["cpu"].init(make_generator(seed, "cpu"))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    rows = []
    for kind in SSM_MM:
        pol = fixed_policy("p_int8" if kind == "p_int8" else "p_fp", n=32)
        runs = {}
        reset_counts()
        for dev, model in models.items():
            trace = {}
            eng = fixed_engine(model, to(params, dev), pol, trace=trace,
                               n_slots=3, max_len=96, device=dev,
                               compress=(kind == "p_c"))
            rng = np.random.RandomState(seed + 3)
            for uid, size in enumerate((5, 11, 3, 70, 8, 2)):
                eng.submit(Request(
                    uid=uid, max_new_tokens=6,
                    prompt=rng.randint(0, cfg.vocab, size).astype(np.int32)))
            toks = {c.uid: c.tokens for c in eng.run_until_done()}
            runs[dev] = (toks, {u: [t.cpu() for t in r]
                                for u, r in trace.items()})
        counts = read_counts()
        cmp = compare_runs(torch, *runs["cuda"], *runs["cpu"])
        row = {"policy": kind, "requests_equal": 6 - len(cmp["divergences"]),
               "tokens_equal": cmp["tokens_equal"],
               "tokens_total": cmp["tokens_total"],
               "max_logit_gap_over_std": cmp["max_logit_gap_over_std"],
               "divergences": cmp["divergences"], "launches": counts}
        rows.append(row)
        log("  reduced mamba2 " + json.dumps(row))
        if not counts[SSM_MM[kind]] or any(
                counts[k] for k in ("flash_attention",
                                    "flash_attention_quant")):
            raise SystemExit(f"ssm reduced {kind}: launched {counts}")
        for d in cmp["divergences"]:
            if not d["top2_margin_over_std"] <= 2 * d["logit_gap_over_std"]:
                raise SystemExit(f"ssm reduced {kind}: a token turned away "
                                 f"from a near-tie: {d}")
    return {"configs": rows}


def zamba_run(torch, model, params, seed: int, smi: str) -> dict:
    """zamba2-7b under P-fp through ``Model``: one ``loss`` on ZAMBA_LOSS
    tokens, a ``prefill`` of ZAMBA_PREFILL into a ring of ZAMBA_MAX_LEN and
    ZAMBA_STEPS decode steps, every call's launches asserted (each forward
    ``ssm_forward_calls``; the x pre-pass at the head of the prefill and at
    every matmul of a step), one step read by role from the profiler and
    profiled."""
    import numpy as np

    cfg = model.cfg
    kp = ssm_policy("p_fp")
    rng = np.random.RandomState(seed + 7)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab, ZAMBA_LOSS),
                           device="cuda")
    labels = torch.roll(toks, -1, dims=1)
    labels[:, -1] = -1
    ptoks = torch.as_tensor(rng.randint(0, cfg.vocab, ZAMBA_PREFILL),
                            device="cuda")
    want = ssm_forward_calls(cfg, "p_fp")
    report = {}
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    calls = []
    counted = CountingModel(model, torch)
    with torch.no_grad():
        t0 = time.perf_counter()
        before = read_counts()
        loss, _ = model.loss(params, {"tokens": toks, "labels": labels}, kp)
        torch.cuda.synchronize()
        report["loss_ms"] = (time.perf_counter() - t0) * 1e3
        report["loss"] = float(loss)
        calls.append(("loss", {k: v - before[k]
                               for k, v in read_counts().items()}))
        logits, st = counted.prefill(params, {"tokens": ptoks}, kp,
                                     max_len=ZAMBA_MAX_LEN)
        for _ in range(ZAMBA_STEPS):
            tok = torch.argmax(logits[:, :cfg.vocab], dim=-1)[:, None]
            logits, st = counted.decode_step(params, tok.to(torch.int32),
                                             st, kp)
    counts = read_counts()
    calls += [("prefill", c["launches"]) for c in counted.prefills]
    calls += [("step", c["launches"]) for c in counted.ticks]
    for what, got in calls:
        if got != want:
            raise SystemExit(f"zamba2 {what}: launched {got}, expected "
                             f"{want}")
    pre = [c["prepass"] for c in counted.prefills + counted.ticks]
    want_pre = [1] + [sum(n for *_, n, _ in ssm_matmuls(cfg))] * ZAMBA_STEPS
    if pre != want_pre:
        raise SystemExit(f"zamba2: x pre-passes {pre}, expected {want_pre}")
    if not torch.isfinite(logits[:, :cfg.vocab]).all():
        raise SystemExit("zamba2: non-finite logits")
    report.update({
        "launches": counts, "forward_calls": want,
        "prefill_ms": counted.prefills[0]["ms"],
        "step_ms_median": statistics.median(c["ms"] for c in counted.ticks),
        "slot_state_bytes": ssm_state_bytes(st, ZAMBA_PREFILL[0]),
        "slot_kv_bytes": sum(t.numel() * t.element_size()
                             for c in st.kv for t in (c.k, c.v))
        / ZAMBA_PREFILL[0],
        "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    names = ssm_role_names("p_fp")

    def step():
        with torch.no_grad():
            return model.decode_step(params, tok.to(torch.int32), st, kp)

    report["step_roles"] = device_launches(
        torch, lambda: (lead_spins(torch), step()), names,
        ssm_roles(cfg, "p_fp", 2, 2), "zamba2 decode step", roles_only=True)
    report["step_profile"] = ssm_profile(torch, step, 2,
                                         report["step_ms_median"], "step",
                                         names)
    prof = report["step_profile"]
    log(f"  zamba2-7b P-fp: loss {report['loss']:.6f} "
        f"({report['loss_ms']:.1f} ms), prefill {report['prefill_ms']:.1f} "
        f"ms, step {report['step_ms_median']:.1f} ms (busy "
        f"{prof.get('device_busy_ms_per_step', 'not measured')}, idle "
        f"{prof.get('device_idle_share', 'not measured')}; split "
        + json.dumps(prof.get("device_ms_split_per_step")) + f") [{smi}]")
    log("  zamba2-7b P-fp: " + json.dumps(report))
    return report


def zamba_compressed(torch, model, params) -> dict:
    """P-C on the hybrid: compressed weights under the fused policy raise
    the reference's ValueError at the first shared q (``serving_policy``
    drops the weight quantizer; the decompressed kernel then meets the
    fused backend, which needs both), after the first group's Mamba2
    projections ran through quant_matmul."""
    from repro_torch.models import serving_transforms as st

    kp = ssm_policy("p_c")
    served = st.compress_weights(params, kp)
    toks = torch.zeros((1, 8), dtype=torch.int32, device="cuda")
    reset_counts()
    try:
        with torch.no_grad():
            model.apply(served, {"tokens": toks}, st.serving_policy(kp))
    except ValueError as e:
        msg = str(e)
    else:
        raise SystemExit("zamba2 P-C: compressed weights under a fused "
                         "policy did not raise")
    counts = {k: v for k, v in read_counts().items() if v}
    want = {"quant_matmul": 2 * (model.cfg.shared_attn_every - 1)}
    if "needs both" not in msg or counts != want:
        raise SystemExit(f"zamba2 P-C: raised {msg!r} after {counts}, "
                         f"expected the fused backend's ValueError after "
                         f"{want}")
    del served
    torch.cuda.empty_cache()
    log(f"  zamba2-7b P-C: raised the reference's ValueError after {counts}: "
        f"{msg}")
    return {"raised": msg, "launches_before": counts}


def phase_ssm(torch, seed: int, smi: str) -> dict:
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import serving_transforms as st
    from repro_torch.nn.module import make_generator

    log("== ssm: mamba2-130m through the fixed-slot engine, zamba2-7b "
        "through Model, full width")
    t_phase = time.perf_counter()
    report = {"kernel_rows": ssm_kernel_checks(torch, seed)}
    totals = {name: 0 for name in KERNELS}
    prepass = 0

    # mamba2-130m: the engine under the three policies
    cfg = get_config("mamba2-130m")
    model = build_model(cfg)
    params = model.init(make_generator(seed, "cuda"))
    report["mamba2"] = {}
    for kind in SSM_MM:
        r = ssm_serve(torch, model, params, kind, seed, smi)
        report["mamba2"][kind] = r
        for k, v in r["launches"].items():
            totals[k] += v
        prepass += r["prepass_launches"]
    report["mamba2_numerics"] = {}
    for kind in SSM_MM:
        kp = ssm_policy(kind)
        served = None
        if kind == "p_c":
            served = (st.compress_weights(params, kp),
                      st.serving_policy(kp))
        report["mamba2_numerics"][kind] = ssm_numerics(
            torch, model, params, kp, f"mamba2 {kind}", smi, served)
    rng = np.random.RandomState(seed + 9)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab, (2, 260)),
                           device="cuda")
    report["mamba2_recurrence"] = recurrence_check(
        torch, model, params, toks, 250, "mamba2")
    del params, model
    torch.cuda.empty_cache()

    # zamba2-7b: Model under P-fp, and P-C's raise
    cfg = get_config("zamba2-7b")
    log(f"  cut: zamba2-7b runs {ZAMBA_LAYERS} of its {cfg.n_layers} layers "
        f"({ZAMBA_LAYERS // cfg.shared_attn_every} of its "
        f"{cfg.n_layers // cfg.shared_attn_every} groups)")
    cfg = cfg.replace(n_layers=ZAMBA_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(make_generator(seed, "cuda"))
    torch.cuda.synchronize()
    report["zamba2_init_s"] = time.perf_counter() - t0
    report["zamba2_param_bytes"] = sum(t.numel() * t.element_size()
                                       for t in _leaves(params))
    log(f"  zamba2-7b built in {report['zamba2_init_s']:.1f} s: "
        f"{report['zamba2_param_bytes']} bytes of f32 parameters")
    z = zamba_run(torch, model, params, seed, smi)
    report["zamba2"] = z
    for k, v in z["launches"].items():
        totals[k] += v
    prepass += 1 + ZAMBA_STEPS * sum(n for *_, n, _ in ssm_matmuls(cfg))
    report["zamba2_numerics"] = ssm_numerics(
        torch, model, params, ssm_policy("p_fp"), "zamba2 p_fp", smi)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab, (2, 304)),
                           device="cuda")
    report["zamba2_recurrence"] = recurrence_check(
        torch, model, params, toks, 300, "zamba2", max_len=ZAMBA_MAX_LEN)
    report["zamba2_p_c"] = zamba_compressed(torch, model, params)
    del params, model
    torch.cuda.empty_cache()

    report["reduced"] = ssm_reduced(torch, seed)
    report["launches"] = totals
    report["prepass_launches"] = prepass
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"  ssm launches on the main paths: {json.dumps(totals)}, x "
        f"pre-pass {prepass}; phase {report['phase_s']:.1f} s [{smi}]")
    return report


# --------------------------------------------------------------------------
# phase: encdec
# --------------------------------------------------------------------------
# whisper-large-v3: 4 streams of 1,500 stub frame embeddings (the encoder's
# 30-second window, arXiv:2212.04356 section 2.2), the decoder's context of
# 448 tokens; a 4-token prompt, 64 greedy steps
WHISPER_STREAMS = 4
WHISPER_FRAMES = 1500
WHISPER_CTX = 448
WHISPER_PROMPT = 4
WHISPER_STEPS = 64
# internvl2-2b: 4 rows of 256 stub patch embeddings before 512 text tokens
# (the loss) or a 64-token prompt (the prefill, into a ring of 1,024); 32
# greedy steps
INTERN_ROWS = 4
INTERN_TEXT = 512
INTERN_PROMPT = 64
INTERN_MAX_LEN = 1024
INTERN_STEPS = 32
# encoder and decoder depth, cut to keep the whole script near half its
# time limit
ENCDEC_LAYERS = {"whisper-large-v3": 8}
ENCDEC_RUNS = {"whisper-large-v3": ("p_fp", "p_int8", "p_c"),
               "internvl2-2b": ("p_fp", "p_c")}
# the reduced configs on the card against the CPU: a prompt and greedy steps
ENCDEC_REDUCED = {"prompt": 5, "steps": 8, "frames": 24, "max_len": 32}
# the matmul wrapper of each path's body (P-C: compressed weights)
ENCDEC_MM = {"p_fp": "abfp_matmul", "p_int8": "abfp_matmul_int8",
             "p_c": "quant_matmul"}


def encdec_policy(kind: str, n: int = 64):
    """P-fp and P-int8: ``fixed_policy``'s (the ``fused`` attention backend;
    P-fp without attention-BMM QDQ, so self-attention takes the flash
    kernel); P-C: ``fixed_policy("compress")`` (an int8 ring, the
    ``compressed`` backend), to pair with compressed weights."""
    return fixed_policy("compress" if kind == "p_c" else kind, n=n)


def encdec_serve(model, params, kind: str, n: int = 64):
    """(params, policy) as a run serves them: P-C compresses the weights
    (packed int4 codes; the tied embedding stays dense) and pairs them with
    ``serving_policy``."""
    from repro_torch.models import serving_transforms as st

    kp = encdec_policy(kind, n)
    if kind != "p_c":
        return params, kp
    return st.compress_weights(params, kp), st.serving_policy(kp)


def encdec_matmuls(cfg, what: str, M: int, M_enc: int = 0) -> list:
    """(label, K, N, calls, rows, part) of the dense matmuls of one
    ``what`` ("forward": ``apply`` / ``loss`` / ``prefill``, "decode": a
    step) at ``M`` decoder rows (``M_enc`` encoder rows), the head at its
    own rows (a prefill's: its last position a row).  Whisper: 6 an encoder
    layer (q, k, v, o, wi, wo), 12 a decoder layer (self q, k, v, o, cross
    q, k, v, o: k and v of the decoder input are projected and then
    replaced, as in the reference; cross/k and cross/v of the encoder
    states, at the encoder's rows; wi, wo), 10 at a step (the cross K/V come
    from the state); the tied head.  InternVL2: q, k, v, o, wi, wg, wo a
    layer and the untied head."""
    d, L = cfg.d_model, cfg.n_layers
    hd, kv = cfg.n_heads * cfg.head_dim_, cfg.n_kv * cfg.head_dim_
    head = ("head", d, cfg.vocab_padded, 1, M, "head")
    if cfg.family == "encdec":
        E, f = cfg.encoder_layers, cfg.d_ff
        rows = [("attn", d, d, 8 * L, M, "body"), ("wi", d, f, L, M, "body"),
                ("wo", f, d, L, M, "body")]
        if what == "forward":
            rows += [("enc attn", d, d, 4 * E, M_enc, "body"),
                     ("enc wi", d, f, E, M_enc, "body"),
                     ("enc wo", f, d, E, M_enc, "body"),
                     ("cross k,v", d, kv, 2 * L, M_enc, "body")]
        return rows + [head]
    return [("q,o", d, hd, 2 * L, M, "body"), ("k,v", d, kv, 2 * L, M, "body"),
            ("wi,wg", d, cfg.d_ff, 2 * L, M, "body"),
            ("wo", cfg.d_ff, d, L, M, "body"), head]


def encdec_calls(cfg, kind: str, mms: list) -> dict:
    """Wrapper calls of one pass over ``mms`` (``encdec_matmuls``): every
    matmul through the path's kernel, but under P-C the tied head (Whisper)
    through abfp_matmul."""
    calls = {name: 0 for name in KERNELS}
    for *_, n, _, part in mms:
        mm = ("abfp_matmul" if kind == "p_c" and part == "head"
              and cfg.tied_embeddings else ENCDEC_MM[kind])
        calls[mm] += n
    return calls


def encdec_flash(cfg, kind: str, what: str) -> dict:
    """Attention launches of one pass: under P-fp / P-int8 one
    flash_mma_kernel a self-attention call of a full sequence (Whisper's
    encoder and decoder layers, InternVL2's layers), none at a step; under
    P-C (attention-BMM QDQ: the plain path at full sequences) one
    attention_decode_kernel a decoder layer at a step; cross-attention never
    takes a kernel."""
    L = cfg.n_layers
    if kind == "p_c":
        return ({"flash_attention_quant": L} if what == "decode" else {})
    if what == "decode":
        return {}
    return {"flash_attention": L + cfg.encoder_layers}


def encdec_prepass(cfg, kind: str, mms: list) -> int:
    """abfp_matmul's x pre-pass (qdq_stream_kernel): each of its calls of up
    to 16 rows."""
    if kind == "p_int8":
        return 0
    return sum(n for *_, n, rows, part in mms
               if rows <= 16 and (kind == "p_fp" or (
                   part == "head" and cfg.tied_embeddings)))


def encdec_roles(cfg, kind: str, mms: list) -> dict:
    """One pass's matmul kernels by role (``regime_want`` of each matmul at
    its rows), every other role of the path's kernels 0."""
    from repro_torch.kernels import quant_matmul as qm

    names = encdec_role_names(kind)
    want = dict.fromkeys(names.values(), 0)
    for _, K, N, n, rows, part in mms:
        mk = ("fp" if kind == "p_c" and part == "head"
              and cfg.tied_embeddings else
              {"p_fp": "fp", "p_int8": "int8", "p_c": "quant"}[kind])
        wide = mk == "quant" and N >= qm.CONTRACT_MIN_N
        for role, c in regime_want(mk, rows, 64, wide).items():
            want[f"{mk} {role}"] += c * n
    return want


def encdec_role_names(kind: str) -> dict:
    """Kernel-name substring -> role of the matmul kernels of ``kind``'s
    path (P-C: quant_matmul's and abfp_matmul's) and both attention
    wrappers' kernels."""
    kinds = {"p_fp": ("fp",), "p_int8": ("int8",), "p_c": ("quant", "fp")}
    names = {k: f"{mk} {role}" for mk in kinds[kind]
             for k, role in REGIME_KERNELS[mk].items()
             if k != "at::native::"}
    names.update({"flash_mma_kernel": "flash", **ATTENTION_KERNELS})
    return names


def encdec_kernel_checks(torch, seed: int) -> dict:
    """The kernels at the slice's new shapes, held against their plain
    versions and timed beside them and the bound: flash_attention over
    Whisper's 1,500 encoder keys (non-causal, G = 1, D = 64: 23 full 64-key
    tiles and one of 28; SDPA beside it), its decoder's 448 causal
    positions, InternVL2's prefills (causal, G = 2, D = 128, S = T = 320
    and 768); both dense matmuls at the encoder's M = 6,000 rows (not a
    multiple of 64) and a step's 4, Whisper's tied head (N = 51,968) at a
    step and the loss's 1,792 rows, InternVL2's layers and untied head (N =
    92,672) at a step and its loss's 3,072 rows; quant_matmul (packed int4)
    at Whisper's shapes (M = 4 and 6,000) and InternVL2's at a step (the
    head at N = 92,672 through contract_kernel); flash_attention_quant at a
    P-C decode step of each (int8 ring, probs QDQ: Whisper T = 448, G = 1,
    D = 64; InternVL2 T = 1,024, G = 2, D = 128); abfp_qdq at the x
    pre-pass shapes."""
    from repro_torch.configs import get_config

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 17)
    rows = {"abfp_matmul": [], "abfp_matmul_int8": [], "quant_matmul": [],
            "flash_attention": [], "flash_attention_quant": [],
            "abfp_qdq": []}
    wh, iv = get_config("whisper-large-v3"), get_config("internvl2-2b")
    M_enc = WHISPER_STREAMS * WHISPER_FRAMES
    rows["flash_attention"] += [
        check_flash(torch, timer, gen, B=WHISPER_STREAMS, S=WHISPER_FRAMES,
                    T=WHISPER_FRAMES, H=20, KV=20, D=64, causal=False,
                    label=f"whisper encoder non-causal B={WHISPER_STREAMS} "
                    f"S=T={WHISPER_FRAMES} H=KV=20 D=64", profiled=False),
        check_flash(torch, timer, gen, B=WHISPER_STREAMS, S=WHISPER_CTX,
                    T=WHISPER_CTX, H=20, KV=20, D=64,
                    label=f"whisper decoder causal B={WHISPER_STREAMS} "
                    f"S=T={WHISPER_CTX} H=KV=20 D=64", profiled=False)]
    for S in (iv.vision_patches + INTERN_PROMPT,
              iv.vision_patches + INTERN_TEXT):
        rows["flash_attention"].append(check_flash(
            torch, timer, gen, B=INTERN_ROWS, S=S, T=S, H=16, KV=8, D=128,
            label=f"internvl2 causal B={INTERN_ROWS} S=T={S} H=16 KV=8 "
            "D=128", profiled=False))
    d, f = wh.d_model, wh.d_ff
    for label, K, N in (("q,k,v,o", d, d), ("wi", d, f), ("wo", f, d)):
        for M in (M_enc, 4):
            for kind, name in (("fp", "abfp_matmul"),
                               ("int8", "abfp_matmul_int8")):
                rows[name].append(check_dense_matmul(
                    torch, timer, gen, kind=kind, M=M, K=K, N=N,
                    label=f"whisper {label} M={M} K={K} N={N}"))
            rows["quant_matmul"].append(check_quant_matmul(
                torch, timer, gen, M=M, K=K, N=N, packed=True,
                label=f"whisper {label} M={M} K={K} N={N} int4"))
    for M in (4, WHISPER_STREAMS * WHISPER_CTX):
        for kind, name in (("fp", "abfp_matmul"),
                           ("int8", "abfp_matmul_int8")):
            rows[name].append(check_dense_matmul(
                torch, timer, gen, kind=kind, M=M, K=d, N=wh.vocab_padded,
                label=f"whisper head M={M} K={d} N={wh.vocab_padded}"))
        torch.cuda.empty_cache()
    for label, K, N, *_ in encdec_matmuls(iv, "decode", 4):
        rows["abfp_matmul"].append(check_dense_matmul(
            torch, timer, gen, kind="fp", M=4, K=K, N=N,
            label=f"internvl2 {label} M=4 K={K} N={N}"))
        rows["quant_matmul"].append(check_quant_matmul(
            torch, timer, gen, M=4, K=K, N=N, packed=True,
            label=f"internvl2 {label} M=4 K={K} N={N} int4"))
    M = INTERN_ROWS * (iv.vision_patches + INTERN_TEXT)
    rows["abfp_matmul"].append(check_dense_matmul(
        torch, timer, gen, kind="fp", M=M, K=iv.d_model, N=iv.vocab_padded,
        label=f"internvl2 head M={M} K={iv.d_model} N={iv.vocab_padded}"))
    torch.cuda.empty_cache()
    for T, q_starts, H, KV, D, label in (
            (WHISPER_CTX, [WHISPER_PROMPT + WHISPER_STEPS - 1, 447, 200, 4],
             20, 20, 64, "whisper"),
            (INTERN_MAX_LEN, [iv.vision_patches + INTERN_PROMPT
                              + INTERN_STEPS - 1, 1023, 600, 320],
             16, 8, 128, "internvl2")):
        rows["flash_attention_quant"].append(check_attention(
            torch, timer, gen, S=1, T=T, probs=True, fp8=False, block_k=0,
            q_starts=q_starts, H=H, KV=KV, D=D, profiled=False,
            label=f"{label} decode S=1 T={T} H={H} KV={KV} D={D} int8 exact",
            want_kernel="attention_decode_kernel"))
    for M, K, where in ((4, d, "whisper step"), (4, f, "whisper step"),
                        (16, d, "whisper prefill"), (4, iv.d_model,
                                                     "internvl2 step"),
                        (4, iv.d_ff, "internvl2 step")):
        rows["abfp_qdq"].append(check_abfp_qdq(
            torch, timer, gen, M=M, K=K, n=64, fmt_name="int8",
            label=f"{where} pre-pass M={M} K={K} int8", profiled=False))
    del timer
    torch.cuda.empty_cache()
    return rows


def encdec_counted(torch, fn) -> tuple:
    """``fn()`` and what it launched: the wrappers' counts, the attention
    kernels by name and abfp_matmul's x pre-pass."""
    from repro_torch.kernels import quant_matmul as qm

    def read():
        return (read_counts(), read_kernel_counts("flash_attention"),
                read_kernel_counts("flash_attention_quant"),
                qm.abfp_matmul.launches_by_kernel["qdq_stream_kernel"])

    before = read()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    after = read()
    got = {k: v - before[0][k] for k, v in after[0].items()
           if v != before[0][k]}
    kern = {k: v - b for a, bb in ((after[1], before[1]),
                                   (after[2], before[2]))
            for (k, v), b in zip(a.items(), bb.values()) if v != b}
    return out, ms, got, kern, after[3] - before[3]


def encdec_check(label, got, kern, pre, want, want_pre) -> None:
    """The launches of one pass against their count from the code: the
    wrappers' counts, the attention kernels by name (every flash_attention
    a flash_mma_kernel, every flash_attention_quant an
    attention_decode_kernel: attention_kernel never) and the x pre-pass."""
    want_kern = {}
    if want.get("flash_attention"):
        want_kern["flash_mma_kernel"] = want["flash_attention"]
    if want.get("flash_attention_quant"):
        want_kern["attention_decode_kernel"] = want["flash_attention_quant"]
    want = {k: v for k, v in want.items() if v}
    if got != want or kern != want_kern or pre != want_pre:
        raise SystemExit(f"encdec {label}: launched {got}, by kernel {kern}, "
                         f"{pre} x pre-passes; expected {want}, {want_kern}, "
                         f"{want_pre}")


def encdec_inputs(torch, cfg, seed: int, rows: int, n_tokens: int) -> dict:
    """Stub inputs from numpy and ``seed``: tokens, next-token labels over
    them, and Whisper's frame embeddings (standard normal) or InternVL2's
    patch embeddings (at the embedding table's scale, 0.02)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (rows, n_tokens)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    if cfg.family == "encdec":
        batch["frames"] = rng.randn(rows, WHISPER_FRAMES,
                                    cfg.d_model).astype(np.float32)
    else:
        batch["patch_embeds"] = (0.02 * rng.randn(
            rows, cfg.vision_patches, cfg.d_model)).astype(np.float32)
    return {k: torch.as_tensor(v, device="cuda") for k, v in batch.items()}


def encdec_run(torch, model, params, kind: str, seed: int, smi: str) -> dict:
    """One policy through ``Model``: a teacher-forced ``loss`` (Whisper:
    4 x 448 tokens over 4 x 1,500 frames; InternVL2: 4 x (256 patches + 512
    tokens), labels over the text), a ``prefill`` (Whisper: 4 tokens into
    max_len 448; InternVL2: 256 patches + 64 tokens into 1,024) and greedy
    decode steps (64 / 32), every pass's launches asserted against
    ``encdec_calls`` / ``encdec_flash`` / ``encdec_prepass``; wall ms of
    each (Whisper's encode alone too), tokens/s of the decode loop, a
    step's kernels by role from the profiler (asserted) and a profile (busy
    ms, idle share, top device operations) of two steps, and under P-fp
    also of the encode, the loss and the prefill (a profile of the plain
    attention paths' tens of thousands of operations takes seconds, and
    P-fp runs the same kernels at the same shapes); peak memory."""
    cfg = model.cfg
    whisper = cfg.family == "encdec"
    B = WHISPER_STREAMS if whisper else INTERN_ROWS
    n_loss = WHISPER_CTX if whisper else INTERN_TEXT
    n_prompt = WHISPER_PROMPT if whisper else INTERN_PROMPT
    max_len = WHISPER_CTX if whisper else INTERN_MAX_LEN
    steps = WHISPER_STEPS if whisper else INTERN_STEPS
    P = 0 if whisper else cfg.vision_patches
    M_enc = B * WHISPER_FRAMES
    label = f"{cfg.name} {kind}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    served, pol = encdec_serve(model, params, kind)
    batch = encdec_inputs(torch, cfg, seed + 21, B, n_loss)
    pbatch = {k: v for k, v in encdec_inputs(
        torch, cfg, seed + 23, B, n_prompt).items() if k != "labels"}
    report = {"policy": kind, "rows": B}
    reset_counts()  # every count from 0 before the path, read after it
    with torch.no_grad():
        # the loss: one teacher-forced forward
        mms = encdec_matmuls(cfg, "forward", B * (P + n_loss), M_enc)
        loss, report["loss_ms"], got, kern, pre = encdec_counted(
            torch, lambda: model.loss(served, batch, pol)[0])
        report["loss"] = float(loss)
        encdec_check(f"{label} loss", got, kern, pre,
                     {**encdec_calls(cfg, kind, mms),
                      **encdec_flash(cfg, kind, "forward")},
                     encdec_prepass(cfg, kind, mms))
        report["loss_launches"] = got
        # the prefill, then greedy steps
        mms = encdec_matmuls(cfg, "forward", B * (P + n_prompt), M_enc)
        mms[-1] = mms[-1][:4] + (B, "head")  # the last position a row
        (logits, st), report["prefill_ms"], got, kern, pre = encdec_counted(
            torch, lambda: model.prefill(served, pbatch, pol,
                                         max_len=max_len))
        encdec_check(f"{label} prefill", got, kern, pre,
                     {**encdec_calls(cfg, kind, mms),
                      **encdec_flash(cfg, kind, "forward")},
                     encdec_prepass(cfg, kind, mms))
        if int(st.position) != P + n_prompt:
            raise SystemExit(f"encdec {label}: position {int(st.position)}")
        report["prefill_launches"] = got
        mms = encdec_matmuls(cfg, "decode", B)
        want_step = {**encdec_calls(cfg, kind, mms),
                     **encdec_flash(cfg, kind, "decode")}
        step_ms, toks = [], []
        for _ in range(steps):
            tok = torch.argmax(logits[:, :cfg.vocab], dim=-1).to(
                torch.int32)[:, None]
            toks.append(tok)
            (logits, st), ms, got, kern, pre = encdec_counted(
                torch, lambda: model.decode_step(served, tok, st, pol))
            encdec_check(f"{label} decode step", got, kern, pre, want_step,
                         encdec_prepass(cfg, kind, mms))
            step_ms.append(ms)
        if not torch.isfinite(logits[:, :cfg.vocab]).all():
            raise SystemExit(f"encdec {label}: non-finite logits")
        if int(st.position) != P + n_prompt + steps:
            raise SystemExit(f"encdec {label}: position {int(st.position)}")
    report.update({
        "launches": read_counts(),
        "attention_quant_by_kernel": read_kernel_counts(
            "flash_attention_quant"),
        "prepass_launches": read_kernel_counts("abfp_matmul")[
            "qdq_stream_kernel"],
        "step_launches": want_step, "steps": steps,
        "step_ms_median": statistics.median(step_ms),
        "decode_tokens_per_s": B * steps / sum(step_ms) * 1e3,
        "tokens": torch.cat(toks, dim=1)[0, :16].tolist(),
        "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    if whisper:
        report["cross_kv_bytes"] = nbytes(st.cross_k, st.cross_v)
        report["ring_bytes"] = sum(nbytes(*(t for t in c if torch.is_tensor(
            t))) for c in st.kv)
    # a step's kernels by role from the profiler, then profiles
    names = encdec_role_names(kind)

    def step():
        with torch.no_grad():
            return model.decode_step(served, tok, st, pol)

    report["step_roles"] = device_launches(
        torch, lambda: (lead_spins(torch), step()), names,
        {**encdec_roles(cfg, kind, mms),
         **{k: want_step.get("flash_attention_quant", 0)
            for k in ("attention_decode_kernel",)},
         "attention_kernel": 0, "flash": 0},
        f"{label} decode step", roles_only=True)
    prof = {"step": profile_steps(torch, step, 2, report["step_ms_median"],
                                  "decode", lead=True)}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    passes = {"loss": (lambda: model.loss(served, batch, pol),
                       report["loss_ms"]),
              "prefill": (lambda: model.prefill(served, pbatch, pol,
                                                max_len=max_len),
                          report["prefill_ms"])}
    if whisper:
        frames = batch["frames"]
        enc = lambda: model.inner.encode(served, frames, pol)
        report["encode_ms"] = timed(enc)
        passes["encode"] = (enc, report["encode_ms"])
    if kind != "p_fp":
        passes = {}
    for what, (fn, ms) in passes.items():
        def one(fn=fn):
            with torch.no_grad():
                fn()
        prof[what] = profile_steps(torch, one, 1, ms, what, lead=True)
    report["profiles"] = prof
    brief = {w: (p.get("device_busy_ms_per_step", "not measured"),
                 p.get("device_idle_share", "not measured"))
             for w, p in prof.items()}
    log(f"  {label}: loss {report['loss']:.6f} ({report['loss_ms']:.1f} ms), "
        + (f"encode {report['encode_ms']:.1f} ms, " if whisper else "")
        + f"prefill {report['prefill_ms']:.1f} ms, step "
        f"{report['step_ms_median']:.2f} ms (median of {steps}), "
        f"{report['decode_tokens_per_s']:.1f} tokens/s; busy ms, idle "
        + json.dumps(brief) + f"; peak {report['peak_memory_bytes']} bytes "
        f"[{smi}]")
    log(f"  {label}: " + json.dumps(report))
    del served, st
    torch.cuda.empty_cache()
    return report


def encdec_numerics(torch, model, params, kind: str, seed: int, smi: str
                    ) -> dict:
    """One stream (Whisper: 1,500 frames and 448 tokens; InternVL2: 256
    patches and 512 tokens) through the fused policy ``kind`` on the
    served tree: the logits against the ref backend's beside its
    reordered-sum control and fp32 on the same tree (under P-C the same
    int4 codes, so the control is the path without activation QDQ; held
    only where GAP_FACTOR times the first lies below the second), and every
    block on the ref backend's inputs (``block_gaps``), asserted."""
    from repro_torch.core.policy import preset

    cfg = model.cfg
    batch = encdec_inputs(torch, cfg, seed + 29, 1,
                          WHISPER_CTX if cfg.family == "encdec"
                          else INTERN_TEXT)
    del batch["labels"]
    served, kp = encdec_serve(model, params, kind)

    def logits(pol):
        with torch.no_grad():
            return model.apply(served, batch, pol)[0][..., :cfg.vocab]

    rp = ref_backend(kp)
    ref = logits(rp)
    with split_contractions(torch):
        moved = logits(rp)
    out = {"logit_gap_over_std": logit_gap(torch, logits(kp), ref),
           "reordered_control_over_std": logit_gap(torch, moved, ref),
           "no_qdq_control_over_std": logit_gap(
               torch, logits(preset("fp32")), ref)}
    out["logit_gap_limit"] = min(GAP_MAX, GAP_FACTOR
                                 * out["reordered_control_over_std"])
    out["held"] = (GAP_FACTOR * out["reordered_control_over_std"]
                   < out["no_qdq_control_over_std"])
    out["ok"] = not out["held"] or out["logit_gap_over_std"] <= out[
        "logit_gap_limit"]
    out.update(block_gaps(torch, model, served, batch, kp,
                          BLOCK_METHODS["encdec" if cfg.family == "encdec"
                                        else "lm"]))
    log(f"  {cfg.name} {kind}: logits {out['logit_gap_over_std']:.6g} std "
        f"from the ref backend's (limit {out['logit_gap_limit']:.6g}; sums "
        f"reordered {out['reordered_control_over_std']:.6g}, no QDQ "
        f"{out['no_qdq_control_over_std']:.6g}"
        + ("" if out["held"] else "; void: a last bit moves them as far as "
           "no QDQ, the blocks are held instead") + "); "
        + block_text(out) + f" [{smi}]")
    del out["rows"]
    if not (out["ok"] and out["block_ok"]):
        raise SystemExit(f"encdec {cfg.name} {kind}: " + json.dumps(out))
    del served
    torch.cuda.empty_cache()
    return out


def encdec_reduced(torch, seed: int) -> dict:
    """Both configs ``.reduced()`` on the card through the kernels against
    the CPU's plain path (the arithmetic the CPU tests hold to the JAX
    reference): a prefill and greedy decode steps under P-fp, P-int8 and
    P-C at group 16; the card must emit the CPU's tokens exactly."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to(v, dev) for v in tree]
        return tree.to(dev)

    R = ENCDEC_REDUCED
    rows = []
    for arch in ENCDEC_RUNS:
        cfg = get_config(arch).reduced()
        models = {"cpu": build_model(cfg, device="cpu"),
                  "cuda": build_model(cfg)}
        params = models["cpu"].init(make_generator(seed, "cpu"))
        rng = np.random.RandomState(seed + 31)
        batch = {"tokens": rng.randint(0, cfg.vocab, (3, R["prompt"]))
                 .astype(np.int32)}
        if cfg.family == "encdec":
            batch["frames"] = rng.randn(3, R["frames"], cfg.d_model).astype(
                np.float32)
        else:
            batch["patch_embeds"] = (0.02 * rng.randn(
                3, cfg.vision_patches, cfg.d_model)).astype(np.float32)
        for kind in ("p_fp", "p_int8", "p_c"):
            toks, counts = {}, {}
            for dev, model in models.items():
                tree, pol = encdec_serve(model, to(params, dev), kind, n=16)
                reset_counts()
                with torch.no_grad():
                    logits, st = model.prefill(tree, batch, pol,
                                               max_len=R["max_len"])
                    out = []
                    for _ in range(R["steps"]):
                        tok = torch.argmax(logits[:, :cfg.vocab], dim=-1).to(
                            torch.int32)[:, None]
                        out.append(tok.cpu())
                        logits, st = model.decode_step(tree, tok, st, pol)
                toks[dev] = torch.cat(out, dim=1)
                counts[dev] = {k: v for k, v in read_counts().items() if v}
            row = {"arch": cfg.name, "policy": kind,
                   "tokens_equal": int((toks["cuda"] == toks["cpu"]).sum()),
                   "tokens_total": toks["cpu"].numel(),
                   "launches": counts["cuda"]}
            rows.append(row)
            log("  reduced " + json.dumps(row))
            if not counts["cuda"].get(ENCDEC_MM[kind]) or counts["cpu"]:
                raise SystemExit(f"encdec reduced {cfg.name} {kind}: "
                                 f"launched {counts}")
            if row["tokens_equal"] != row["tokens_total"]:
                raise SystemExit(f"encdec reduced {cfg.name} {kind}: the card"
                                 f" emitted {toks['cuda'].tolist()}, the CPU "
                                 f"{toks['cpu'].tolist()}")
    return {"configs": rows}


def phase_encdec(torch, seed: int, smi: str) -> dict:
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator

    log("== encdec: whisper-large-v3 and internvl2-2b at full width through "
        "Model")
    t_phase = time.perf_counter()
    report = {"kernel_rows": encdec_kernel_checks(torch, seed)}
    stamps = {"kernel_checks": time.perf_counter() - t_phase}
    totals = {name: 0 for name in KERNELS}
    by_kernel = {name: 0 for name in ATTENTION_KERNELS}
    prepass = 0
    for arch, kinds in ENCDEC_RUNS.items():
        cfg = get_config(arch)
        if arch in ENCDEC_LAYERS:
            n = ENCDEC_LAYERS[arch]
            log(f"  cut: {arch} runs {n} of its {cfg.encoder_layers} encoder "
                f"and {n} of its {cfg.n_layers} decoder layers")
            cfg = cfg.replace(n_layers=n, encoder_layers=n)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        model = build_model(cfg)
        params = model.init(make_generator(seed, "cuda"))
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in _leaves(params))
        rep = {"init_s": time.perf_counter() - t0, "params": n_params,
               "param_bytes": 4 * n_params}
        log(f"  {arch} built in {rep['init_s']:.1f} s: {n_params} "
            f"parameters, {rep['param_bytes']} bytes in f32")
        for kind in kinds:
            r = encdec_run(torch, model, params, kind, seed, smi)
            for k, v in r["launches"].items():
                totals[k] += v
            for k, v in r["attention_quant_by_kernel"].items():
                by_kernel[k] += v
            prepass += r["prepass_launches"]
            rep[kind] = r
            stamps[f"{arch} {kind}"] = time.perf_counter() - t_phase
        if cfg.family == "encdec":
            st_bytes = rep["p_fp"]["cross_kv_bytes"]
            log(f"  {arch}: cross K/V state {st_bytes} bytes ({cfg.n_layers}"
                f" x {WHISPER_STREAMS} x {WHISPER_FRAMES} x "
                f"{cfg.n_kv * cfg.head_dim_} x 2 x 4 B)")
        rep["numerics"] = {kind: encdec_numerics(torch, model, params, kind,
                                                 seed, smi)
                           for kind in kinds}
        stamps[f"{arch} numerics"] = time.perf_counter() - t_phase
        report[arch] = rep
        del params, model
        torch.cuda.empty_cache()
    report["reduced"] = encdec_reduced(torch, seed)
    stamps["reduced"] = time.perf_counter() - t_phase
    report["seconds_at"] = stamps
    report["launches"] = totals
    report["launches_by_kernel"] = by_kernel
    report["prepass_launches"] = prepass
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"  encdec launches on the main paths: {json.dumps(totals)}, "
        f"flash_attention_quant by kernel {json.dumps(by_kernel)}, x "
        f"pre-pass {prepass}; phase {report['phase_s']:.1f} s (seconds at "
        f"the end of each part: {json.dumps(stamps)}) [{smi}]")
    return report


# --------------------------------------------------------------------------
# phases: dense_archs, moe
# --------------------------------------------------------------------------
PHI_LAYERS = 8  # of 32: 42.7 GB of f32 (the whole model is 167.5 GB)
SCOUT_LAYERS = 4  # of 48: 41.5 GB of f32 (the whole model is 406.9 GB)
GEMMA_LOSS = (2, 512)  # through the 256k tied head in chunks of 512
PHI_LOSS = (2, 512)
SCOUT_LOSS, SCOUT_PREFILL, SCOUT_STEPS = (2, 256), (2, 64), 16
# the numerics' batch: inside every sliding window (the fused prefill drops
# the window, as the reference's does: ROADMAP.md Queue C), and long enough
# that a block's gap is not decided by whether one K code flips.  A K code
# at a rounding boundary moves every later query's scores: at its first
# 128 tokens Phi-3.5's first P-C block reads 3.1x its reordered control
# because q / k / v, which agree with the plain ones to 1.2e-7, flip the
# K code of token 58 and the reordered sums flip none; at 512 tokens both
# flip K codes at tokens 191, 300 and 345 and read alike
# (``scripts/moe_block_gap.py``).  On those first ARCH_SHORT_TOKENS the
# median block is held as well: one flip moves one block, a fault of the
# path every block.
ARCH_GAP_TOKENS = (1, 512)
ARCH_SHORT_TOKENS = 128
# the depth of the dense configs in dense_archs, cut to keep the whole
# script inside 900 s on a slow host beside the spec phase (their kernel
# shapes do not depend on the depth)
DENSE_CUT_LAYERS = {"gemma2-9b": 10, "granite-3-8b": 10,
                    "h2o-danube-1.8b": 12}


def arch_sites(cfg) -> int:
    """Dense matmul sites a layer: q, k, v, o, and the FFN's wi, wg, wo
    (the MoE block's expert stacks are einsums on QDQ'd weights, as in the
    reference: no kernel site)."""
    return 4 if cfg.family == "moe" else 7


def arch_calls(cfg, kind: str, head: bool = True) -> dict:
    """Matmul wrapper launches of one forward under ``kind`` ('p_c' on
    compressed weights, 'p_fp', 'p_int8'), attention aside: every dense
    site of every layer and (``head``) the head.  Under P-C a tied head
    keeps its runtime weight QDQ (``serving_policy``: the table is never
    compressed), so it runs ``abfp_matmul``."""
    n = arch_sites(cfg) * cfg.n_layers
    if kind == "p_c":
        if cfg.tied_embeddings:
            return {"quant_matmul": n, "abfp_matmul": int(head)}
        return {"quant_matmul": n + int(head)}
    return {FIXED_PATHS[kind]: n + int(head)}


def arch_probe(cfg) -> int:
    """Matmul launches of the expert store's routing probe at admission
    (``expert_loads``: every dense site, no head; attention at the full
    prompt takes the plain path under attention-BMM QDQ)."""
    return arch_sites(cfg) * cfg.n_layers


def moe_stats_brief(eng) -> dict | None:
    """``expert_stats()`` without the per-site lists."""
    st = eng.expert_stats()
    return None if st is None else {k: v for k, v in st.items()
                                    if k != "sites"}


def arch_attention(cfg) -> int:
    """Attention-kernel launches of a forward: one a layer, none under an
    attention softcap (no kernel body has one: ``flash_ok`` and
    ``_compressed_eligible`` are false, as in the reference)."""
    return 0 if cfg.attn_softcap else cfg.n_layers


def arch_expect(label: str, got: dict, want: dict) -> None:
    want = {k: v for k, v in want.items() if v}
    got = {k: v for k, v in got.items() if v}
    if got != want:
        raise SystemExit(f"{label}: launched {got}, expected {want}")


def arch_kernel_checks(torch, seed: int) -> dict:
    """The kernels at the shapes the last model families give them, held
    against their plain versions and timed beside them and the bound:
    flash_attention at Danube's D = 80 (padded to 128 in the kernel),
    Granite's and Phi-3.5's 4 query heads a KV head and Llama-4's 5 (SDPA
    beside each); flash_attention_quant at D = 80 over 8,192 keys with the
    window of 4,096 inside the long kernels (Danube's paged decode and
    chunk) and at 4 query heads a KV head (Granite's and Phi-3.5's paged
    decode and prefill); abfp_matmul at Gemma2's 256,000-wide tied head (a
    step's 4 rows and a loss chunk's 1,024) and layers, Danube's and
    Llama-4's; abfp_matmul_int8 and quant_matmul at Granite's K = 12,800;
    quant_matmul at Gemma2's, Phi-3.5's and Danube's P-C shapes; abfp_qdq
    at the new pre-pass widths."""
    from repro_torch.configs import get_config

    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 37)
    rows = {"abfp_matmul": [], "abfp_matmul_int8": [], "quant_matmul": [],
            "flash_attention": [], "flash_attention_quant": [],
            "abfp_qdq": []}
    ge, gr, da = (get_config(a) for a in ("gemma2-9b", "granite-3-8b",
                                          "h2o-danube-1.8b"))
    phi, sc = get_config("phi3.5-moe-42b-a6.6b"), get_config(
        "llama4-scout-17b-a16e")
    for cfg, B, S in ((da, 1, 64), (da, 1, 256), (gr, 1, 256),
                      (sc, *SCOUT_PREFILL), (sc, *SCOUT_LOSS)):
        H, KV, D = cfg.n_heads, cfg.n_kv, cfg.head_dim_
        rows["flash_attention"].append(check_flash(
            torch, timer, gen, B=B, S=S, T=S, H=H, KV=KV, D=D,
            label=f"{cfg.name} causal B={B} S=T={S} H={H} KV={KV} D={D}",
            profiled=False))
    for cfg, S, T, bk, q_starts, want, what in (
            (da, 1, LONG_MAX_LEN, 512, [6007, 4107, 2507, -1],
             "attention_decode_long_kernel", "long decode"),
            (da, 64, LONG_MAX_LEN, 512, [5952, 4032, 2000, -1],
             "attention_long_kernel", "long"),
            (gr, 1, 512, 0, [100, 510, 37, -1], "attention_decode_kernel",
             "decode"),
            (gr, 64, 512, 0, [0, 448, 128, -1], "attention_prefill_kernel",
             "prefill")):
        H, KV, D, w = cfg.n_heads, cfg.n_kv, cfg.head_dim_, cfg.window
        body = "phased" if bk else "exact"
        rows["flash_attention_quant"].append(check_attention(
            torch, timer, gen, S=S, T=T, probs=True, fp8=False, block_k=bk,
            q_starts=q_starts, H=H, KV=KV, D=D, window=w or 1 << 30,
            profiled=False, want_kernel=want,
            label=f"{cfg.name} {what} S={S} T={T} H={H} KV={KV} D={D} int8 "
            f"{body}" + (f" window={w}" if w else "")))
    d = ge.d_model
    for M in (4, GEMMA_LOSS[0] * 512):
        rows["abfp_matmul"].append(check_dense_matmul(
            torch, timer, gen, kind="fp", M=M, K=d, N=ge.vocab_padded,
            label=f"gemma2-9b tied head M={M} K={d} N={ge.vocab_padded}"))
        torch.cuda.empty_cache()
    for cfg, M in ((ge, 4), (da, 4), (sc, SCOUT_PREFILL[0])):
        for label, K, N in arch_shapes(cfg):
            rows["abfp_matmul"].append(check_dense_matmul(
                torch, timer, gen, kind="fp", M=M, K=K, N=N,
                label=f"{cfg.name} {label} M={M} K={K} N={N}"))
        torch.cuda.empty_cache()
    for label, K, N in arch_shapes(gr):
        for M in (4, 256):
            rows["abfp_matmul_int8"].append(check_dense_matmul(
                torch, timer, gen, kind="int8", M=M, K=K, N=N,
                label=f"granite-3-8b {label} M={M} K={K} N={N}"))
            rows["quant_matmul"].append(check_quant_matmul(
                torch, timer, gen, M=M, K=K, N=N, packed=True,
                label=f"granite-3-8b {label} M={M} K={K} N={N} int4"))
    for cfg in (ge, phi, da):
        for label, K, N in arch_shapes(cfg):
            if cfg is not da or label == "head":
                rows["quant_matmul"].append(check_quant_matmul(
                    torch, timer, gen, M=4, K=K, N=N, packed=True,
                    label=f"{cfg.name} {label} M=4 K={K} N={N} int4"))
        torch.cuda.empty_cache()
    for M, K, where in ((4, ge.d_model, "gemma2-9b"),
                        (4, da.d_model, "h2o-danube-1.8b"),
                        (SCOUT_PREFILL[0], sc.d_model, "llama4-scout")):
        rows["abfp_qdq"].append(check_abfp_qdq(
            torch, timer, gen, M=M, K=K, n=64, fmt_name="int8",
            label=f"{where} pre-pass M={M} K={K} int8", profiled=False))
    del timer
    torch.cuda.empty_cache()
    return rows


def arch_shapes(cfg) -> list:
    """(label, K, N) of a layer's distinct dense sites and the untied head
    (the MoE block's experts are no kernel site)."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    q, kv = cfg.n_heads * hd, cfg.n_kv * hd
    out = [("q", d, q), ("k,v", d, kv), ("o", q, d)]
    if cfg.family != "moe":
        out += [("wi,wg", d, f), ("wo", f, d)]
    if not cfg.tied_embeddings:
        out.append(("head", d, cfg.vocab_padded))
    return out


# the arch_numerics checks that failed in the running phase: the phase
# finishes its other runs, then fails (``arch_failures``)
ARCH_FAILED = []


def arch_failures(phase: str) -> None:
    if ARCH_FAILED:
        raise SystemExit(f"{phase}: numerics failed: "
                         + json.dumps(ARCH_FAILED))


def arch_numerics(torch, model, tree, kp, label: str, smi: str) -> dict:
    """``lm_gap`` and ``block_gaps`` of the fused policy ``kp`` on ``tree``
    (a served tree is held against the same codes through the plain
    paths), on ARCH_GAP_TOKENS, and ``block_gaps``' median bar on their
    first ARCH_SHORT_TOKENS, asserted: a failure is kept in ARCH_FAILED
    and fails the phase at its end."""
    import numpy as np

    from repro_torch.core.policy import preset

    cfg = model.cfg
    t0 = time.perf_counter()
    rng = np.random.RandomState(19)
    toks = torch.as_tensor(rng.randint(0, cfg.vocab, ARCH_GAP_TOKENS),
                           device="cuda")
    no_qdq = lm_logits(torch, model, tree, toks, preset("fp32"))
    out = lm_gap(torch, model, tree, toks, kp, no_qdq)
    out.update(block_gaps(torch, model, tree, {"tokens": toks}, kp,
                          BLOCK_METHODS["lm"]))
    log(f"  {label}: logits {out['logit_gap_over_std']:.6g} std from the "
        f"ref backend's (limit {out['logit_gap_limit']:.6g}; sums reordered "
        f"{out['reordered_control_over_std']:.6g}, no QDQ "
        f"{out['no_qdq_control_over_std']:.6g}"
        + ("" if out["held"] else "; void: a last bit moves them as far as "
           "no QDQ, the blocks are held instead")
        + (f"; {out['logit_rows_left_out']} tokens left out (limit "
           f"{out['logit_rows_left_out_limit']:g}): router turns "
           f"{out['logit_routing_turns']}, "
           f"{out['logit_routing_displaced']} displaced"
           if "logit_routing_turns" in out else "") + "); "
        + block_text(out) + f" [{smi}]")
    out["block_rows"] = [
        {k: r[k] for k in ("index", "rms", "worst_rows_share")}
        for r in out.pop("rows")]
    short = block_gaps(torch, model, tree,
                       {"tokens": toks[:, :ARCH_SHORT_TOKENS]}, kp,
                       BLOCK_METHODS["lm"])
    med = short["block_median_rms"]
    out["short"] = {
        "tokens": ARCH_SHORT_TOKENS, "block_median_rms": med,
        "block_median_limit": short["block_median_limit"],
        "block_median_held": short["block_median_held"],
        "block_gap_rms": short["block_gap_rms"],
        "block_reordered_control_rms": short["block_reordered_control_rms"],
        "worst": short["worst"],
        "routing_at_ties": short.get("routing_at_ties", True)}
    out["short"]["ok"] = (short["block_median_held"]
                          and med[0] <= short["block_median_limit"]
                          and out["short"]["routing_at_ties"])
    log(f"  {label}: first {ARCH_SHORT_TOKENS} tokens: median block "
        f"{med[0]:.6g} (limit {short['block_median_limit']:.6g}; sums "
        f"reordered {med[1]:.6g}, no QDQ {med[2]:.6g}"
        + ("" if short["block_median_held"] else "; void: FAILS")
        + f"; router turns at ties: {out['short']['routing_at_ties']}); "
        f"largest block {short['block_gap_rms']:.6g} against reordered "
        f"{short['block_reordered_control_rms']:.6g} (block "
        f"{short['worst']['index']}; not held here: one K code can decide it)"
        f"; numerics in {time.perf_counter() - t0:.1f} s [{smi}]")
    if not (out["ok"] and out["block_ok"] and out["short"]["ok"]):
        log(f"  {label}: numerics FAILED")
        ARCH_FAILED.append({"run": label, **{k: v for k, v in out.items()
                                             if k != "block_rows"}})
    return out


def arch_requests(cfg, seed: int, long: bool):
    """``serve``'s six requests, or ``long``'s four prompts of 6,000 /
    4,100 / 2,500 / 1,100 tokens and 8 new each."""
    import numpy as np

    from repro_torch.serve.engine import Request

    if not long:
        return make_requests(cfg, seed)
    rng = np.random.RandomState(seed + 5)
    return [Request(uid=3000 + i, max_new_tokens=LONG_NEW,
                    prompt=rng.randint(0, cfg.vocab, size=n).astype(np.int32))
            for i, n in enumerate(LONG_PROMPTS)]


def arch_brief(label: str, rep: dict, smi: str) -> None:
    prof = rep.get("profile", {})
    log(f"  {label}: {rep['tokens_per_s']:.2f} tokens/s, step ms (median) "
        + json.dumps(rep["step_ms_median"]) + ", busy "
        f"{prof.get('device_busy_ms_per_step', 'not measured')} ms, idle "
        f"{prof.get('device_idle_share', 'not measured')} of a decode step; "
        f"peak {rep['peak_memory_bytes'] / 1e9:.2f} GB [{smi}]")


def arch_paged(torch, cfg, seed: int, long: bool, smi: str) -> dict:
    """``PagedServeEngine`` on ``cfg`` at full width under P-C (compressed
    weights, int8 pages of 16, the compressed backend; the dense tree
    freed): ``serve``'s requests at max_len 512, or ``long``'s at 8,192 (T
    = 8,192 in every attention call, the sliding window masking keys
    inside the long kernels).  Asserted per step: the matmul and attention
    launches by wrapper and kernel, the head's x pre-pass; then a profiled
    decode step and the numerics on the served tree."""
    from repro_torch.kernels.flash_attention_quant import PREFILL_MIN_S
    from repro_torch.models.serving_transforms import weight_bytes_summary

    max_len = LONG_MAX_LEN if long else 512
    label = f"{cfg.name} paged p_c max_len {max_len}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(torch, cfg, seed, kernel_path=True, max_len=max_len)
    torch.cuda.synchronize()
    log(f"  {label}: built and compressed in {time.perf_counter() - t0:.1f}"
        " s: " + json.dumps(weight_bytes_summary(eng.weight_bytes)))
    reqs = arch_requests(cfg, seed, long)
    for r in reqs:
        eng.submit(r)
    reset_counts()
    t0 = time.perf_counter()
    while eng._has_work():
        eng.tick()
        if eng.ticks > 2000:
            raise SystemExit(f"{label}: did not drain in 2000 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    by_kernel = read_kernel_counts("flash_attention_quant")
    prepass = read_kernel_counts("abfp_matmul")["qdq_stream_kernel"]
    done = eng.done
    new = LONG_NEW if long else 16
    if sorted(c.uid for c in done) != sorted(r.uid for r in reqs) or any(
            len(c.tokens) != new or not all(0 <= t < cfg.vocab
                                            for t in c.tokens)
            for c in done):
        raise SystemExit(f"{label}: completions "
                         f"{[(c.uid, c.tokens) for c in done]}")
    st = eng.page_stats()
    if st["page_allocs"] != st["page_frees"] or st["pages_in_use"]:
        raise SystemExit(f"{label}: page accounting does not balance: {st}")
    chunks = sum(1 for s, _ in eng.step_ms if s >= PREFILL_MIN_S)
    decodes = eng.steps - chunks
    attn = arch_attention(cfg)
    want = {k: v * eng.steps for k, v in arch_calls(cfg, "p_c").items()}
    want["flash_attention_quant"] = attn * eng.steps
    if eng.expert_store is not None:
        # the routing probe at each admission (``_observe_experts``): a
        # forward of the prompt without the head, its attention plain
        want["quant_matmul"] += arch_probe(cfg) * len(reqs)
    arch_expect(label, counts, want)
    want_kernel = dict.fromkeys(by_kernel, 0)
    want_kernel["attention_long_kernel" if long else
                "attention_prefill_kernel"] = attn * chunks
    want_kernel["attention_decode_long_kernel" if long else
                "attention_decode_kernel"] = attn * decodes
    want_prepass = eng.steps if cfg.tied_embeddings else 0
    if by_kernel != want_kernel or prepass != want_prepass or not (
            chunks and decodes):
        raise SystemExit(f"{label}: attention kernels {by_kernel} and "
                         f"{prepass} x pre-passes in {chunks} chunk and "
                         f"{decodes} decode steps; expected {want_kernel}, "
                         f"{want_prepass}")
    n_tok = sum(len(c.tokens) for c in done)
    by_kind = {"decode": [ms for s, ms in eng.step_ms if s == 1],
               "chunk": [ms for s, ms in eng.step_ms if s > 1]}
    rep = {"policy": "p_c", "max_len": max_len,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "generated_tokens": n_tok, "steps": eng.steps,
           "step_counts": {k: len(v) for k, v in by_kind.items()},
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "step_ms_median": {k: statistics.median(v)
                              for k, v in by_kind.items()},
           "launches": counts, "launches_by_kernel": by_kernel,
           "prepass_launches": prepass,
           "launches_per_step": {**arch_calls(cfg, "p_c"),
                                 "flash_attention_quant": attn},
           "weight_bytes": weight_bytes_summary(eng.weight_bytes),
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "tokens": {c.uid: c.tokens for c in done},
           "expert_stats": moe_stats_brief(eng)}
    rep["profile"] = profile_decode(
        torch, cfg, eng, seed, rep["step_ms_median"]["decode"],
        watch=("quant_decode_kernel", "contract_kernel",
               "attention_decode_kernel", "attention_decode_long_kernel"))
    arch_brief(label, rep, smi)
    rep["numerics"] = arch_numerics(torch, eng.model, eng.params,
                                    eng.policy, label, smi)
    log(f"  {label}: " + json.dumps(rep))
    del eng
    torch.cuda.empty_cache()
    return rep


def arch_fixed(torch, model, params, kind: str, seed: int, smi: str
               ) -> dict:
    """The fixed-slot ``ServeEngine`` on dense f32 weights under P-fp or
    P-int8: ``serve``'s six requests (4 slots, max_len 512, buckets of 64).
    Asserted: every forward's matmul launches, each prefill's
    flash_mma_kernel launches (none under a softcap) and P-fp's x
    pre-pass; then a profiled decode tick and the numerics."""
    cfg = model.cfg
    label = f"{cfg.name} fixed {kind}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    timed = TimedModel(model, torch)
    kp = fixed_policy(kind)
    eng = fixed_engine(timed, params, kp, n_slots=4, max_len=512,
                       prefill_bucket=64)
    reqs = make_requests(cfg, seed)
    for r in reqs:
        eng.submit(r)
    reset_counts()
    t0 = time.perf_counter()
    while eng._has_work():
        eng.tick()
        if eng.ticks > 2000:
            raise SystemExit(f"{label}: did not drain in 2000 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_completions(cfg, eng, eng.done, reqs)
    passes = eng.prefills + eng.ticks
    per = arch_calls(cfg, kind)
    want = {k: v * passes for k, v in per.items()}
    attn = arch_attention(cfg)
    want["flash_attention"] = attn * eng.prefills
    arch_expect(label, counts, want)
    flash = read_kernel_counts("flash_attention")
    prepass = read_kernel_counts("abfp_matmul")["qdq_stream_kernel"]
    want_pre = (sum(per.values()) * eng.ticks + eng.prefills
                if kind == "p_fp" else 0)
    if flash != {"flash_mma_kernel": attn * eng.prefills} or \
            prepass != want_pre:
        raise SystemExit(f"{label}: flash_attention's kernels {flash}, "
                         f"{prepass} x pre-passes; expected "
                         f"flash_mma_kernel x {attn * eng.prefills}, "
                         f"{want_pre}")
    n_tok = sum(len(c.tokens) for c in eng.done)
    rep = {"policy": kind, "prompt_lens": [len(r.prompt) for r in reqs],
           "padded_lens": sorted(eng._padded_lengths),
           "generated_tokens": n_tok, "prefills": eng.prefills,
           "decode_ticks": eng.ticks, "wall_s": wall,
           "tokens_per_s": n_tok / wall,
           "step_ms_median": {
               "prefill": statistics.median(timed.prefill_ms),
               "decode": statistics.median(eng.decode_ms)},
           "launches": counts, "launches_per_forward": per,
           "flash_attention_by_kernel": flash, "prepass_launches": prepass,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    rep["profile"] = profile_decode(
        torch, cfg, eng, seed, rep["step_ms_median"]["decode"],
        watch=("fp_decode_kernel", "int8_decode_kernel",
               "qdq_stream_kernel"))
    arch_brief(label, rep, smi)
    rep["numerics"] = arch_numerics(torch, model, params, kp, label, smi)
    log(f"  {label}: " + json.dumps(rep))
    del eng, timed
    torch.cuda.empty_cache()
    return rep


def arch_batch(torch, cfg, seed: int, shape) -> dict:
    """Tokens of ``shape`` from ``seed`` and next-token labels (-1 last)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, shape).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": torch.as_tensor(toks, device="cuda"),
            "labels": torch.as_tensor(labels, device="cuda")}


def arch_model(torch, model, params, kind: str, seed: int, smi: str, *,
               loss_shape, prefill_shape=None, steps: int = 0,
               loads: bool = False) -> dict:
    """Through ``Model`` on dense f32 weights under P-fp: ``loss`` on
    ``loss_shape`` tokens (the head in ``logits_chunk`` chunks where the
    config sets one; an MoE config adds 0.01 x its aux loss, which must be
    positive), ``expert_loads`` on the same tokens (``loads``), a
    ``prefill`` of ``prefill_shape`` and ``steps`` greedy decode steps;
    every pass's launches asserted (wrapper, attention kernel, x
    pre-pass), wall ms, a profiled step, peak memory."""
    cfg = model.cfg
    label = f"{cfg.name} model {kind}"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kp = fixed_policy(kind)
    attn = arch_attention(cfg)
    rep = {"policy": kind}
    batch = arch_batch(torch, cfg, seed + 41, loss_shape)

    def arch_counted(torch, fn):
        """``fn()``, its wall ms and what it launched, by wrapper, attention
        kernel and x pre-pass (``qdq_stream_kernel``), in one dict."""
        out, ms, got, kern, pre = encdec_counted(torch, fn)
        return out, ms, {**got, **kern, "qdq_stream_kernel": pre}

    reset_counts()  # every count from 0 before the path, read after it
    with torch.no_grad():
        (loss, m), rep["loss_ms"], got = arch_counted(
            torch, lambda: model.loss(params, batch, kp))
        arch_expect(f"{label} loss", got, {
            **arch_calls(cfg, kind), "flash_attention": attn,
            "flash_mma_kernel": attn})
        rep.update(loss=float(loss), aux=float(m["aux"]))
        if not (torch.isfinite(loss) and (rep["aux"] > 0) == (
                cfg.family == "moe")):
            raise SystemExit(f"{label}: loss {rep['loss']}, aux {rep['aux']}")
        if loads:
            ld, rep["expert_loads_ms"], got = arch_counted(
                torch, lambda: model.expert_loads(params, batch["tokens"],
                                                  policy=kp))
            arch_expect(f"{label} expert_loads", got, {
                **arch_calls(cfg, kind, head=False), "flash_attention": attn,
                "flash_mma_kernel": attn})
            cap = batch["tokens"].numel() * cfg.top_k
            if ld.shape != (cfg.n_layers, cfg.n_experts) or not (
                    0 < float(ld.sum(dim=1).max()) <= cap):
                raise SystemExit(f"{label}: expert loads {ld.tolist()}")
            rep["expert_loads"] = ld.tolist()
        if prefill_shape:
            B, P = prefill_shape
            pb = {"tokens": arch_batch(torch, cfg, seed + 43,
                                       prefill_shape)["tokens"]}
            (logits, st), rep["prefill_ms"], got = arch_counted(
                torch, lambda: model.prefill(params, pb, kp,
                                             max_len=P + steps))
            n1 = sum(arch_calls(cfg, kind).values())
            arch_expect(f"{label} prefill", got, {
                **arch_calls(cfg, kind), "flash_attention": attn,
                "flash_mma_kernel": attn,
                "qdq_stream_kernel": int(kind == "p_fp")})
            step_ms, toks = [], []
            for _ in range(steps):
                tok = torch.argmax(logits[:, :cfg.vocab], dim=-1).to(
                    torch.int32)[:, None]
                toks.append(tok)
                (logits, st), ms, got = arch_counted(
                    torch, lambda: model.decode_step(params, tok, st, kp))
                arch_expect(f"{label} decode step", got, {
                    **arch_calls(cfg, kind),
                    "qdq_stream_kernel": n1 * int(kind == "p_fp")})
                step_ms.append(ms)
            if not torch.isfinite(logits[:, :cfg.vocab]).all() or int(
                    st.position) != P + steps:
                raise SystemExit(f"{label}: decode ended at position "
                                 f"{int(st.position)} or non-finite")
            rep.update(steps=steps, step_ms_median=statistics.median(step_ms),
                       decode_tokens_per_s=B * steps / sum(step_ms) * 1e3,
                       tokens=torch.cat(toks, dim=1)[0].tolist())
    # the main path's counts, read before the profiled steps launch more
    rep["launches"] = read_counts()
    rep["attention_by_kernel"] = read_kernel_counts("flash_attention")
    rep["prepass_launches"] = read_kernel_counts("abfp_matmul")[
        "qdq_stream_kernel"]
    rep["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    if prefill_shape:
        def step():
            with torch.no_grad():
                return model.decode_step(params, tok, st, kp)

        rep["profile"] = profile_steps(torch, step, 2, rep["step_ms_median"],
                                       "decode", lead=True)
    prof = rep.get("profile", {})
    log(f"  {label}: loss {rep['loss']:.6f} (aux {rep['aux']:.6g}) in "
        f"{rep['loss_ms']:.1f} ms"
        + (f", expert_loads {rep['expert_loads_ms']:.1f} ms" if loads else
           "")
        + (f", prefill {rep['prefill_ms']:.1f} ms, step "
           f"{rep['step_ms_median']:.2f} ms (median of {steps}), "
           f"{rep['decode_tokens_per_s']:.1f} tokens/s, busy "
           f"{prof.get('device_busy_ms_per_step', 'not measured')} ms, idle "
           f"{prof.get('device_idle_share', 'not measured')}"
           if prefill_shape else "")
        + f"; peak {rep['peak_memory_bytes'] / 1e9:.2f} GB [{smi}]")
    return rep


def arch_build(torch, cfg, seed: int):
    """Model and random f32 weights from ``seed`` on the card."""
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg)
    params = model.init(make_generator(seed, "cuda"))
    torch.cuda.synchronize()
    n = sum(t.numel() for t in _leaves(params))
    log(f"  {cfg.name}: {cfg.n_layers} layers built in "
        f"{time.perf_counter() - t0:.1f} s: {n} parameters, {4 * n} bytes "
        "in f32")
    return model, params


def arch_totals(report: dict, runs) -> None:
    """The launches of every counted run, by wrapper, attention kernel
    and x pre-pass, into ``report``."""
    totals = {name: 0 for name in KERNELS}
    by_kernel = {name: 0 for name in ATTENTION_KERNELS}
    prepass = 0
    for r in runs:
        for k, v in r["launches"].items():
            totals[k] += v
        for k, v in r.get("launches_by_kernel", {}).items():
            by_kernel[k] += v
        prepass += r["prepass_launches"]
    report.update(launches=totals, launches_by_kernel=by_kernel,
                  prepass_launches=prepass)


def phase_dense_archs(torch, seed: int, smi: str) -> dict:
    """Gemma2-9B, Granite-3-8B and H2O-Danube-1.8B at published width
    (depth: DENSE_CUT_LAYERS), random weights from ``seed``, one at a time: the kernels at
    their new shapes; Gemma2 paged P-C (attention on the plain path: its
    softcap), fixed P-fp and a loss on (2, 512) through the chunked 256k
    tied head; Granite paged P-C and fixed P-int8; Danube fixed P-fp
    (flash_mma_kernel at D = 80) and paged P-C at max_len 8,192 on
    ``long``'s prompts (the window of 4,096 inside the long kernels)."""
    from repro_torch.configs import get_config

    log("== dense_archs: gemma2-9b, granite-3-8b, h2o-danube-1.8b at full "
        "width")
    t_phase = time.perf_counter()
    report = {"kernel_rows": arch_kernel_checks(torch, seed)}
    stamps = {"kernel_checks": time.perf_counter() - t_phase}
    runs = []
    for arch, paged_long, fixed, loss in (
            ("gemma2-9b", False, "p_fp", GEMMA_LOSS),
            ("granite-3-8b", False, "p_int8", None),
            ("h2o-danube-1.8b", True, "p_fp", None)):
        cfg = get_config(arch)
        if arch in DENSE_CUT_LAYERS:
            log(f"  cut: {arch} runs {DENSE_CUT_LAYERS[arch]} of its "
                f"{cfg.n_layers} layers")
            cfg = cfg.replace(n_layers=DENSE_CUT_LAYERS[arch])
        rep = {"paged": arch_paged(torch, cfg, seed, paged_long, smi)}
        model, params = arch_build(torch, cfg, seed)
        rep["fixed"] = arch_fixed(torch, model, params, fixed, seed, smi)
        runs += [rep["paged"], rep["fixed"]]
        if loss:
            rep["model"] = arch_model(torch, model, params, fixed, seed, smi,
                                      loss_shape=loss)
            runs.append(rep["model"])
        del model, params
        torch.cuda.empty_cache()
        report[arch] = rep
        stamps[arch] = time.perf_counter() - t_phase
    arch_totals(report, runs)
    report["seconds_at"] = stamps
    report["phase_s"] = time.perf_counter() - t_phase
    arch_failures("dense_archs")
    log(f"  dense_archs launches on the main paths: "
        f"{json.dumps(report['launches'])}, attention by kernel "
        f"{json.dumps(report['launches_by_kernel'])}, x pre-pass "
        f"{report['prepass_launches']}; phase {report['phase_s']:.1f} s "
        f"(seconds at the end of each part: {json.dumps(stamps)}) [{smi}]")
    return report


PHI_EXPERT_CACHE = 4  # the reference's E // 4 for Phi-3.5's 16 experts
PHI_AUTO = (2, 8)  # requests and new tokens of the precision-auto run


def moe_store(torch, cfg, seed: int, smi: str, storeless: dict) -> dict:
    """Phi-3.5-MoE paged P-C with the expert store, beside ``arch_paged``'s
    run without one (a store of capacity 0).  First the launcher's
    ``--expert-precision auto``: routing frequencies of two synthetic
    one-group prompts (seed + 2), the 4 hottest experts INT8 and the rest
    INT4 under ``*/experts.{e}`` rules, served on a few requests.  Then
    ``expert_cache`` = E // 4 (the dense tree freed before serving),
    ``refresh_experts()`` once the first requests are in and again once
    the last one is: its tokens must be the storeless run's, exactly (a
    cached copy is ``decompress_kernel`` of its entry, the function
    ``ExpertBank.dense`` applies)."""
    import numpy as np

    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.serve.experts import (assign_expert_precision,
                                           hot_experts, route_frequencies)

    free_card(torch)
    model = build_model(cfg)
    params = model.init(make_generator(seed, "cuda"))
    pol = slice_policy(True)
    prng = np.random.RandomState(seed + 2)
    gt = max(1, cfg.moe_group_tokens)
    probe = [prng.randint(0, cfg.vocab, (1, gt)).astype(np.int32)
             for _ in range(2)]
    saved = save_counts()
    loads = route_frequencies(model, params, probe, policy=pol)
    restore_counts(saved)
    # --expert-precision auto: hot experts INT8, cold INT4
    n_hot = max(1, cfg.n_experts // 4)
    eng = build_engine(torch, cfg, seed, True, model=model, params=params,
                       policy=assign_expert_precision(loads, pol,
                                                      n_hot=n_hot))
    n_req, new = PHI_AUTO
    auto_reqs = arch_requests(cfg, seed, False)[:n_req]
    for r in auto_reqs:
        r.max_new_tokens = new
        eng.submit(r)
    done = eng.run_until_done(max_ticks=2000)
    if len(done) != n_req or any(len(c.tokens) != new or not all(
            0 <= t < cfg.vocab for t in c.tokens) for c in done):
        raise SystemExit(f"{cfg.name} precision auto: completions "
                         f"{[(c.uid, c.tokens) for c in done]}")
    auto = eng.expert_stats()
    flat = storeless["expert_stats"]
    fmts = sorted({r["fmt"] for r in eng.weight_bytes["sites"]
                   if "/experts." in r["site"]})
    auto_rep = {
        "hot_experts": hot_experts(loads, n_hot),
        "loads": [float(x) for x in np.asarray(loads).sum(axis=0)],
        "expert_formats": fmts, "resident_bytes": auto["resident_bytes"],
        "flat_int4_resident_bytes": flat["resident_bytes"],
        "dense_bytes": auto["dense_bytes"],
        "tokens": {c.uid: c.tokens for c in done}}
    log(f"  {cfg.name} precision auto: experts {fmts}, resident "
        f"{auto['resident_bytes']} bytes against flat INT4's "
        f"{flat['resident_bytes']} (dense {auto['dense_bytes']}) [{smi}]")
    del eng
    free_card(torch)
    # the store: E // 4 experts a layer cached, refreshed into the params
    label = f"{cfg.name} paged p_c expert_cache {PHI_EXPERT_CACHE}"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = build_engine(torch, cfg, seed, True, model=model, params=params,
                       expert_cache=PHI_EXPERT_CACHE)
    del params
    free_card(torch)
    build_s = time.perf_counter() - t0
    reqs = arch_requests(cfg, seed, False)
    for r in reqs:
        eng.submit(r)
    refresh_ms = []

    def refresh():
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng.refresh_experts()
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t) * 1e3)

    t0 = time.perf_counter()
    eng.tick()  # the first four requests admitted and observed
    refresh()
    while eng._has_work():
        queued = len(eng.queue)
        eng.tick()
        if queued and not eng.queue:
            refresh()  # the last admission's routes in the cache too
        if eng.ticks > 2000:
            raise SystemExit(f"{label}: did not drain in 2000 ticks")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = {c.uid: c.tokens for c in eng.done}
    if tokens != storeless["tokens"]:
        raise SystemExit(f"{label}: tokens {tokens} differ from the run "
                         f"without a store: {storeless['tokens']}")
    stats = eng.expert_stats()
    share = sum(r["resident_bytes"] for r in eng.weight_bytes["sites"]
                if "/experts." in r["site"])
    if stats["store_bytes"] != share or not stats["cached_experts"]:
        raise SystemExit(f"{label}: store bytes {stats['store_bytes']} vs "
                         f"the byte report's expert share {share}, "
                         f"{stats['cached_experts']} cached")
    banks = [b["ffn"]["wi"] for b in eng.params["blocks"]]
    dense_entries = sum(not hasattr(e, "codes") for b in banks
                        for e in b.entries)
    decode = [ms for s_, ms in eng.step_ms if s_ == 1]
    n_tok = sum(len(t) for t in tokens.values())
    rep = {"expert_cache": PHI_EXPERT_CACHE, "engine_build_s": build_s,
           "wall_s": wall, "tokens_per_s": n_tok / wall,
           "step_ms_median": {"decode": statistics.median(decode)},
           "refresh_ms": refresh_ms, "tokens_equal_storeless": True,
           "dense_entries_served": dense_entries,
           "expert_stats": moe_stats_brief(eng),
           "store_vs_byte_report_expert_share": [stats["store_bytes"],
                                                 share],
           "peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "precision_auto": auto_rep}
    rep["profile"] = profile_decode(torch, cfg, eng, seed,
                                    rep["step_ms_median"]["decode"])
    log(f"  {label}: " + json.dumps(rep))
    log(f"  {label}: decode step {rep['step_ms_median']['decode']:.1f} ms "
        f"wall, {rep['profile'].get('device_busy_ms_per_step')} busy; "
        f"without a store {storeless['step_ms_median']['decode']:.1f} / "
        f"{storeless['profile'].get('device_busy_ms_per_step')}; peak "
        f"{rep['peak_memory_bytes'] / 1e9:.2f} GB [{smi}]")
    del eng
    free_card(torch)
    return rep


def phase_moe(torch, seed: int, smi: str) -> dict:
    """Phi-3.5-MoE at full width and PHI_LAYERS of its 32 layers: fixed
    P-fp (the expert stacks QDQ'd every forward), paged P-C (``ExpertBank``
    int4 codes decompressed every step, as the reference does), then with
    the expert store (``moe_store``: E // 4 experts cached and refreshed
    into the params, tokens equal; ``--expert-precision auto``), a loss
    with its aux term and ``expert_loads``; Llama-4-Scout at full width and
    SCOUT_LAYERS of 48: a loss on (2, 256), a (2, 64) prefill and 16
    greedy steps under P-fp."""
    from repro_torch.configs import get_config

    log("== moe: phi3.5-moe-42b-a6.6b and llama4-scout-17b-a16e at full "
        "width")
    t_phase = time.perf_counter()
    phi = get_config("phi3.5-moe-42b-a6.6b")
    sc = get_config("llama4-scout-17b-a16e")
    for cfg, n in ((phi, PHI_LAYERS), (sc, SCOUT_LAYERS)):
        log(f"  cut: {cfg.name} runs {n} of its {cfg.n_layers} layers "
            f"({cfg.replace(n_layers=n).n_params()} of {cfg.n_params()} "
            "parameters)")
    phi, sc = phi.replace(n_layers=PHI_LAYERS), sc.replace(
        n_layers=SCOUT_LAYERS)
    report = {"reduced_depth": {phi.name: PHI_LAYERS, sc.name: SCOUT_LAYERS}}
    model, params = arch_build(torch, phi, seed)
    rep = {"fixed": arch_fixed(torch, model, params, "p_fp", seed, smi)}
    rep["model"] = arch_model(torch, model, params, "p_fp", seed, smi,
                              loss_shape=PHI_LOSS, loads=True)
    del model, params
    rep["paged"] = arch_paged(torch, phi, seed, False, smi)
    rep["store"] = moe_store(torch, phi, seed, smi, rep["paged"])
    report[phi.name] = rep
    stamps = {phi.name: time.perf_counter() - t_phase}
    model, params = arch_build(torch, sc, seed)
    report[sc.name] = {"model": arch_model(
        torch, model, params, "p_fp", seed, smi, loss_shape=SCOUT_LOSS,
        prefill_shape=SCOUT_PREFILL, steps=SCOUT_STEPS)}
    report[sc.name]["numerics"] = arch_numerics(
        torch, model, params, fixed_policy("p_fp"), f"{sc.name} model p_fp",
        smi)
    del model, params
    torch.cuda.empty_cache()
    stamps[sc.name] = time.perf_counter() - t_phase
    arch_totals(report, [rep["paged"], rep["fixed"], rep["model"],
                         report[sc.name]["model"]])
    report["seconds_at"] = stamps
    report["phase_s"] = time.perf_counter() - t_phase
    arch_failures("moe")
    log(f"  moe launches on the main paths: {json.dumps(report['launches'])}"
        f", attention by kernel {json.dumps(report['launches_by_kernel'])},"
        f" x pre-pass {report['prepass_launches']}; phase "
        f"{report['phase_s']:.1f} s (seconds at the end of each part: "
        f"{json.dumps(stamps)}) [{smi}]")
    return report


# --------------------------------------------------------------------------
# --------------------------------------------------------------------------
# phase: train
# --------------------------------------------------------------------------
# opt-125m through the launcher: QAT under w4a8_abfp (the reference's
# `python -m repro.launch.train` flags), checkpoints every 10 steps
TRAIN_FLAGS = ("--arch", "opt-125m", "--policy", "w4a8_abfp", "--qat",
               "--steps", "20", "--seq-len", "512", "--global-batch", "16",
               "--warmup", "5", "--ckpt-interval", "10")
TRAIN_KILL = 10  # (b): the run stops after this step's checkpoint
TRAIN_EVAL_BATCHES = 4  # (e): of 8 x 512 tokens (M = 4096)
TRAIN_PROFILED = 2  # steps under the profiler
DANUBE_STEPS = 3
DANUBE_SHAPE = (8, 512)
TRAIN_DIR = os.path.join(ROOT, "build", "train_checkpoints")


def train_args(seed: int, ckpt: str, *extra):
    from repro_torch.launch import train as tlaunch

    return tlaunch.build_argparser().parse_args(
        [*TRAIN_FLAGS, "--seed", str(seed), "--ckpt-dir", ckpt,
         "--device", "cuda", *extra])


def train_eval_batch(args) -> dict:
    """The launcher's first evaluation batch (its held-out tail of the
    synthetic corpus, as ``make_everything`` cuts it)."""
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.data.loader import eval_batches

    stream = synthetic_corpus(args.corpus_tokens, vocab=503, seed=args.seed)
    n_eval = max(len(stream) // 10, args.seq_len * 2 + 2)
    return next(eval_batches(stream[-n_eval:], args.seq_len,
                             min(args.global_batch, 8), max_batches=1))


def train_loop(args, total: int):
    """``make_everything`` + ``run`` as the launcher's ``main`` drives them,
    stopped after ``total`` steps -> (result, params, opt_state, the
    launcher's pieces)."""
    from repro_torch.checkpoint.manager import CheckpointConfig
    from repro_torch.launch import train as tlaunch
    from repro_torch.train.loop import LoopConfig, run

    parts = tlaunch.make_everything(args)
    model, params, opt, opt_state, loader, step_fn, eval_fn, policy = parts
    res, params, opt_state = run(
        step_fn, params, opt_state, loader,
        LoopConfig(total_steps=total, checkpoint=CheckpointConfig(
            directory=args.ckpt_dir, interval=args.ckpt_interval)))
    return res, params, opt_state, parts


def tree_clone(tree):
    from repro_torch.tree import tree_map

    return tree_map(lambda t: t.clone(), tree)


def train_steps_ms(torch, step_fn, params, state, loader, first: int,
                   n: int) -> list:
    """Wall ms of ``n`` steps on ``params`` / ``state`` (updated in place),
    each between two synchronizations."""
    ms = []
    for k in range(first, first + n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, state, m = step_fn(params, state, loader.batch_at(k))
        float(m["loss"])  # synchronizes
        ms.append((time.perf_counter() - t0) * 1e3)
    return ms


def train_determinism(torch, step_fn, params, state, loader) -> bool:
    """Whether the train step is bit-reproducible without
    ``use_deterministic_algorithms``: two runs of two steps from copies of
    one state, compared bit for bit."""
    from repro_torch.tree import leaves

    runs = []
    for _ in range(2):
        p, s = tree_clone(params), tree_clone(state)
        train_steps_ms(torch, step_fn, p, s, loader, 0, 2)
        runs.append(p)
    return all(torch.equal(a, b) for a, b in zip(leaves(runs[0]),
                                                 leaves(runs[1])))


def train_kernel_checks(torch, seed: int) -> dict:
    """The fused evaluation's kernels at its M = 4096 rows (8 x 512): both
    dense matmuls at every (K, N) of opt-125m, flash_attention at B = 8,
    S = T = 512, one query head a KV head (beside SDPA)."""
    timer = Timer(torch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 11)
    rows = {"abfp_matmul": [], "abfp_matmul_int8": [], "flash_attention": []}
    B, S = DANUBE_SHAPE
    M = B * S
    for kind, name in (("fp", "abfp_matmul"), ("int8", "abfp_matmul_int8")):
        for label, K, N in PTQ_MATMULS:
            rows[name].append(check_dense_matmul(
                torch, timer, gen, kind=kind, M=M, K=K, N=N,
                label=f"opt train eval {label} M={M} K={K} N={N}"))
    rows["flash_attention"].append(check_flash(
        torch, timer, gen, B=B, S=S, T=S, H=12, KV=12, D=64,
        label=f"opt train eval B={B} S=T={S} H=KV=12 D=64", profiled=False))
    del timer
    torch.cuda.empty_cache()
    return rows


def train_fused_eval(torch, model, params, eval_fn, args, report) -> None:
    """(e) The QAT'd weights evaluated through the fused P-fp and P-int8
    forwards (the route the benchmark tables take): every forward's
    launches, the loss beside the ref backend's, the logits gap."""
    batch = train_eval_batch(args)
    dense, layers = ptq_dense(model.cfg), model.cfg.n_layers
    for kind, mm in FIXED_PATHS.items():
        kp = fixed_policy(kind)
        before = read_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = eval_fn(params, max_batches=TRAIN_EVAL_BATCHES, eval_policy=kp)
        wall = (time.perf_counter() - t0) * 1e3 / TRAIN_EVAL_BATCHES
        got = {k: v - before[k] for k, v in read_counts().items()
               if v != before[k]}
        want = {mm: dense * TRAIN_EVAL_BATCHES,
                "flash_attention": layers * TRAIN_EVAL_BATCHES}
        if got != want:
            raise SystemExit(f"train: the {kind} evaluation launched {got}, "
                             f"expected {want} ({dense} matmuls and {layers} "
                             f"flash_attention a forward)")
        saved = save_counts()  # the gap check's forwards are not counted
        t0 = time.perf_counter()
        ref = eval_fn(params, max_batches=TRAIN_EVAL_BATCHES,
                      eval_policy=ref_backend(kp))
        ref_wall = (time.perf_counter() - t0) * 1e3 / TRAIN_EVAL_BATCHES
        gap = fused_logit_gap(torch, model, params, batch, kp,
                              f"train: {kind}")
        restore_counts(saved)
        report["fused_eval"][kind] = {
            "eval_loss": ev["eval_loss"], "ref_backend_loss": ref["eval_loss"],
            "relative_loss_gap": abs(ev["eval_loss"] - ref["eval_loss"])
            / abs(ref["eval_loss"]),
            "launches_per_forward": {k: v / TRAIN_EVAL_BATCHES
                                     for k, v in got.items()},
            "eval_ms_per_batch": wall, "ref_eval_ms_per_batch": ref_wall,
            **gap}
        log(f"  (e) {kind}: eval loss {ev['eval_loss']:.6f}, ref backend "
            f"{ref['eval_loss']:.6f}; {wall:.1f} ms a batch of 8 x 512 "
            f"(ref backend {ref_wall:.1f})")


def train_danube(torch, seed: int, smi: str) -> dict:
    """(d) H2O-Danube-1.8B at published width and depth: QAT steps at
    8 x 512 under its remat="dots", then "full"; step 1's loss bit-equal
    across the two, peak memory and ms a step of each."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import preset
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.data.loader import LMLoader
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.step import make_train_step
    from repro_torch.tree import leaves

    cfg = get_config("h2o-danube-1.8b")
    B, S = DANUBE_SHAPE
    stream = synthetic_corpus(B * (S + 1) * DANUBE_STEPS + 1,
                              vocab=min(cfg.vocab, 503), seed=seed)
    loader = LMLoader(stream, seq_len=S, global_batch=B, seed=seed)
    policy = preset("w4a8_abfp", n_layers=cfg.n_layers).with_ste(True)
    out = {"model": cfg.name, "batch": [B, S], "steps": DANUBE_STEPS}
    for remat in ("dots", "full"):
        free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        model = build_model(cfg.replace(remat=remat), device="cuda")
        params = model.init(make_generator(seed, "cuda"))
        n_params = sum(p.numel() for p in leaves(params))
        opt = AdamW(lr=warmup_cosine(3e-4, 1, DANUBE_STEPS),
                    weight_decay=0.01)
        state = opt.init(params)
        step = make_train_step(model, opt, policy)
        losses, ms = [], []
        for k in range(DANUBE_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            # the step returns ``params`` itself: bind no name to it, so
            # that nothing of this mode outlives the ``del`` below
            state, m = step(params, state, loader.batch_at(k))[1:]
            losses.append(float(m["loss"]))
            ms.append((time.perf_counter() - t0) * 1e3)
        out[remat] = {"losses": losses, "step_ms": ms,
                      "step_ms_median_after_first": statistics.median(ms[1:]),
                      "allocated_before_bytes": before,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                      "n_params": n_params}
        log(f"  (d) {cfg.name} remat={remat}: losses {losses}, step ms "
            f"{[round(t, 1) for t in ms]}, peak "
            f"{out[remat]['peak_memory_bytes'] / 1e9:.2f} GB ("
            f"{before / 1e9:.2f} GB allocated before the model) [{smi}]")
        if not all(map(math.isfinite, losses)):
            raise SystemExit(f"train: {cfg.name} remat={remat} losses "
                             f"{losses}")
        del model, params, state, step, opt
    out["n_params"] = out["dots"]["n_params"]
    out["first_loss_bit_equal"] = (out["dots"]["losses"][0]
                                   == out["full"]["losses"][0])
    out["all_losses_bit_equal"] = (out["dots"]["losses"]
                                   == out["full"]["losses"])
    if not out["first_loss_bit_equal"]:
        raise SystemExit(f"train: {cfg.name} step 1's loss differs between "
                         f"remat dots {out['dots']['losses'][0]} and full "
                         f"{out['full']['losses'][0]}")
    free_card(torch)
    return out


MICRO_BAR = 4.0  # (c): a split may move the gradient 4x what a control does


def grad_gaps(torch, got, want) -> dict:
    """How far the gradient ``got`` lies from ``want`` (lists of leaves):
    the relative L2 gap over the whole tree, and each leaf's own (its
    absolute gap where ``want``'s leaf is all zero)."""
    d2 = n2 = 0.0
    by_leaf = []
    for a, b in zip(got, want):
        dl = float(((a - b).double() ** 2).sum())
        nl = float((b.double() ** 2).sum())
        d2, n2 = d2 + dl, n2 + nl
        by_leaf.append((dl / nl) ** 0.5 if nl > 0 else dl ** 0.5)
    return {"tree": (d2 / n2) ** 0.5, "leaves": by_leaf}


def grad_gate(gaps: dict, control: dict, paths) -> list:
    """What ``gaps`` breaks of the bar ``MICRO_BAR`` x ``control``: the
    tree's gap, and each leaf's gap against that leaf's control."""
    bad = []
    if gaps["tree"] > MICRO_BAR * control["tree"]:
        bad.append(f"tree gap {gaps['tree']:.3g} > {MICRO_BAR} x "
                   f"{control['tree']:.3g}")
    over = [(p, g, c) for p, g, c in zip(paths, gaps["leaves"],
                                         control["leaves"])
            if g > MICRO_BAR * c]
    if over:
        p, g, c = max(over, key=lambda r: r[1] / max(r[2], 1e-300))
        bad.append(f"{len(over)} leaves over their bar, the worst {p} "
                   f"{g:.3g} against a control of {c:.3g}")
    return bad


def train_microbatches(torch, seed: int) -> dict:
    """(c) opt-125m fp32 at 16 x 512 from one set of weights: 2
    microbatches against 1.  The loss is held to the reference's bar
    (``tests/test_train_loop.py``: 1e-4).  A microbatched gradient sums
    the same terms in another order, so it is held to what reordering
    does, read on the card: the full-batch gradient with the batch's rows
    reversed, and with every weight moved by 2**-20 of itself up or down
    at random (the larger of the two, by tree and by leaf; ``grad_gate``);
    the train steps' global gradient norms too (their ratio less one, at
    most the tree's bar).  A planted fault (microbatch 2 dropped, with and
    without the division by 2; the division left out) must break that
    bar, else the check is blind.  One train step each from copies of the
    weights: the reference's parameter bar (rtol 1e-4, atol 1e-5) is
    reported, not held — AdamW's first step moves every parameter by
    about lr, whatever its gradient's size, so a gradient that reordering
    moves across zero moves its parameter by up to 2 lr."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core.policy import preset
    from repro_torch.data.corpus import synthetic_corpus
    from repro_torch.data.loader import LMLoader
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.optim.adamw import AdamW
    from repro_torch.optim.schedule import warmup_cosine
    from repro_torch.train.step import (TrainStepConfig, make_loss_and_grads,
                                        make_train_step)
    from repro_torch.tree import flatten_with_paths, leaves, tree_map

    cfg = get_config("opt-125m")
    model = build_model(cfg, device="cuda")
    params = model.init(make_generator(seed, "cuda"))
    paths = [p for p, _ in flatten_with_paths(params)]
    loader = LMLoader(synthetic_corpus(16 * 513 + 1, vocab=503, seed=seed),
                      seq_len=512, global_batch=16, seed=seed)
    batch = loader.batch_at(0)
    pol = preset("fp32")
    full, split = (make_loss_and_grads(model, pol, n) for n in (1, 2))
    l1, _, g1 = full(params, batch)
    l2, _, g2 = split(params, batch)
    _, _, g_rev = full(params, {k: np.ascontiguousarray(v[::-1])
                                for k, v in batch.items()})
    gen = make_generator(seed + 1, "cuda")

    def nudged(p):  # each weight times 1 + 2**-20 or 1 - 2**-20
        sign = torch.randint(0, 2, p.shape, generator=gen, device="cuda")
        return p * (1 + 2.0 ** -20 * (2 * sign - 1).to(p.dtype))

    _, _, g_nudge = full(tree_map(nudged, params), batch)
    _, _, g_first = full(params, {k: v[:8] for k, v in batch.items()})
    gaps = {"reversed": grad_gaps(torch, g_rev, g1),
            "nudged": grad_gaps(torch, g_nudge, g1),
            "microbatches_2": grad_gaps(torch, g2, g1),
            "fault_dropped": grad_gaps(torch, [g / 2 for g in g_first], g1),
            "fault_dropped_renormalized": grad_gaps(torch, g_first, g1),
            "fault_no_division": grad_gaps(torch, [g * 2 for g in g2], g1)}
    control = {"tree": max(gaps["reversed"]["tree"], gaps["nudged"]["tree"]),
               "leaves": [max(a, b) for a, b in zip(
                   gaps["reversed"]["leaves"], gaps["nudged"]["leaves"])]}
    del g_rev, g_nudge, g_first
    out = {"loss_1": float(l1), "loss_2": float(l2),
           "loss_gap": abs(float(l1) - float(l2)), "bar": MICRO_BAR,
           "control_tree": control["tree"],
           "gaps": {k: {"tree": v["tree"], "worst_leaf": max(v["leaves"]),
                        "worst_leaf_over_control": max(
                            g / max(c, 1e-300) for g, c in zip(
                                v["leaves"], control["leaves"]))}
                    for k, v in gaps.items()},
           "violations": {k: grad_gate(v, control, paths)
                          for k, v in gaps.items()
                          if k not in ("reversed", "nudged")}}
    del g1, g2
    # the steps themselves: the reference's parameter bar, reported
    opt = AdamW(lr=warmup_cosine(3e-4, 5, 20), weight_decay=0.01)
    (p1, _, m1), (p2, _, m2) = (
        make_train_step(model, opt, pol, TrainStepConfig(n))(
            tree_clone(params), opt.init(params), batch) for n in (1, 2))
    n1, n2 = float(m1["grad_norm"]), float(m2["grad_norm"])
    out.update(grad_norm_1=n1, grad_norm_2=n2,
               grad_norm_gap=abs(n2 / n1 - 1.0),
               step_loss_equal=bool(torch.equal(m1["loss"], m2["loss"])),
               params=sum(a.numel() for a in leaves(p1)),
               params_outside_reference_bar=sum(
                   int(((a - b).abs() > 1e-5 + 1e-4 * b.abs()).sum())
                   for a, b in zip(leaves(p1), leaves(p2))),
               params_max_abs_gap=max(float((a - b).abs().max())
                                      for a, b in zip(leaves(p1),
                                                      leaves(p2))))
    log("  (c) microbatches 2 vs 1: " + json.dumps(out))
    v = out["violations"]
    blind = [k for k in v if k.startswith("fault") and not v[k]]
    if not (out["loss_gap"] < 1e-4 and not v["microbatches_2"]
            and out["grad_norm_gap"] <= MICRO_BAR * control["tree"]
            and not blind):
        raise SystemExit(f"train: (c) microbatches 2 vs 1: loss gap "
                         f"{out['loss_gap']}, grad norm gap "
                         f"{out['grad_norm_gap']}, outside the control's "
                         f"bar: {v['microbatches_2']}; planted faults the "
                         f"bar does not see: {blind}")
    del model, params, p1, p2
    free_card(torch)
    return out


def phase_train(torch, seed: int, smi: str) -> dict:
    import shutil

    from repro_torch.configs import ShapeSpec
    from repro_torch.launch.roofline import model_flops
    from repro_torch.nn.module import make_generator
    from repro_torch.tree import flatten_with_paths, leaves

    log("== train: opt-125m QAT through launch/train (full width and "
        "depth), kill and resume, fused evaluation; h2o-danube-1.8b QAT "
        "steps under remat dots / full")
    t_phase = time.perf_counter()
    report = {"kernel_rows": train_kernel_checks(torch, seed),
              "fused_eval": {}}
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    try:
        reset_counts()
        # (a) the uninterrupted run, through the launcher's gate
        free_card(torch)
        torch.cuda.reset_peak_memory_stats()
        gates_before = GATES.get("train", 0)
        args = train_args(seed, os.path.join(TRAIN_DIR, "a"))
        res_a, params, state, parts = train_loop(args, args.steps)
        model, _, _, _, loader, step_fn, eval_fn, policy = parts
        peak = torch.cuda.max_memory_allocated()
        hist = res_a.history
        losses = [h["loss"] for h in hist]
        norms = [h["grad_norm"] for h in hist]
        step_ms = statistics.median(h["time_s"] for h in hist[2:]) * 1e3
        n_params = sum(p.numel() for p in leaves(params))
        tokens = loader.tokens_per_step
        a = {"policy": policy.name, "steps": len(hist), "losses": losses,
             "grad_norms": norms, "step_ms_median_3_20": step_ms,
             "tokens_per_s": tokens / step_ms * 1e3,
             "peak_memory_bytes": peak, "n_params": n_params,
             # 6 N operations a token (N the config's count, as the
             # roofline's cost model takes it), f32 on the CUDA cores
             "model_flops_per_step": model_flops(model.cfg, ShapeSpec(
                 "train", args.seq_len, args.global_batch, "train"), 1),
             "gates_passed": GATES.get("train", 0) - gates_before}
        a["f32_peak_share"] = (a["model_flops_per_step"] / (step_ms / 1e3)
                               / PEAK_F32_FLOPS)
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]
                and min(norms) > 0 and a["gates_passed"] == 1):
            raise SystemExit(f"train: (a) losses {losses}, grad norms "
                             f"{norms}, pre-flight gates passed "
                             f"{a['gates_passed']}")
        # every leaf moved: the launcher's initial weights, drawn again
        init = model.init(make_generator(seed, "cuda"))
        still = [p for (p, x), y in zip(flatten_with_paths(init),
                                        leaves(params)) if torch.equal(x, y)]
        del init
        if still:
            raise SystemExit(f"train: (a) leaves that did not move: {still}")
        report["a"] = a
        log(f"  (a) {model.cfg.name} {policy.name}: losses {losses[0]:.4f} "
            f"-> {losses[-1]:.4f}, grad norms {min(norms):.3g}-"
            f"{max(norms):.3g}, {step_ms:.1f} ms a step (median of steps "
            f"3-20), {a['tokens_per_s']:.0f} tokens/s, peak "
            f"{peak / 1e9:.2f} GB [{smi}]")
        p2, s2 = tree_clone(params), tree_clone(state)
        report["a"]["profile"] = profile_steps(
            torch, lambda: step_fn(p2, s2, loader.batch_at(args.steps)),
            TRAIN_PROFILED, step_ms, kind="train")
        log("  (a) profile: " + json.dumps(report["a"]["profile"]))
        report["a"]["bit_equal_without_deterministic_algorithms"] = (
            train_determinism(torch, step_fn, p2, s2, loader))
        log("  (a) two runs without deterministic algorithms bit-equal: "
            f"{report['a']['bit_equal_without_deterministic_algorithms']}")
        del p2, s2

        # (b) killed after step 10 (its checkpoint written), restarted
        args_b = train_args(seed, os.path.join(TRAIN_DIR, "b"))
        res_b, _, _, _ = train_loop(args_b, TRAIN_KILL)
        free_card(torch)
        res_r, params_r, state_r, _ = train_loop(args_b, args_b.steps)
        b = {"resumed_from": res_r.resumed_from,
             "losses": [h["loss"] for h in res_r.history],
             "losses_bit_equal": [h["loss"] for h in res_r.history]
             == losses[TRAIN_KILL:],
             "params_bit_equal": all(torch.equal(x, y) for x, y in zip(
                 leaves(params_r), leaves(params))),
             "opt_state_bit_equal": all(torch.equal(x, y) for x, y in zip(
                 leaves(state_r), leaves(state)))}
        report["b"] = b
        log("  (b) kill and resume: " + json.dumps(b))
        if not (b["resumed_from"] == TRAIN_KILL and b["losses_bit_equal"]
                and b["params_bit_equal"] and b["opt_state_bit_equal"]):
            raise SystemExit(f"train: (b) the resumed run is not the "
                             f"uninterrupted one: {b}")
        del params_r, state_r, res_b
        free_card(torch)

        # (e) the fused evaluation of (a)'s weights
        train_fused_eval(torch, model, params, eval_fn, args, report)
        report["launches"] = read_counts()
        del params, state, parts, model, step_fn, eval_fn
        free_card(torch)
        report["d"] = train_danube(torch, seed, smi)
        report["c"] = train_microbatches(torch, seed)
    finally:
        shutil.rmtree(TRAIN_DIR, ignore_errors=True)
        free_card(torch)
    report["phase_s"] = time.perf_counter() - t_phase
    log("  " + json.dumps({k: v for k, v in report.items()
                           if k != "kernel_rows"}))
    return report


# --------------------------------------------------------------------------
# phase: dist
# --------------------------------------------------------------------------
DIST_SHAPE = (8, 512)  # (a): the QAT step's batch (M = 4096 in (b)'s forward)
DIST_TIMED = 5  # (c): calls of compressed_psum_pod timed (median)
DIST_DIR = os.path.join(ROOT, "build", "dist")


class PlanMesh:
    """A mesh's axis names and shape, for the restore plans of meshes larger
    than this host (``restore_specs`` reads nothing else)."""

    def __init__(self, names, shape):
        import types

        self.axis_names = tuple(names)
        self.devices = types.SimpleNamespace(shape=tuple(shape))


def dist_world_of_one(torch):
    """The default process group: a world of one over NCCL, initialised from
    a ``FileStore`` under ``build/`` (no port).  A failed init fails the
    phase."""
    import datetime

    import torch.distributed as dist

    os.makedirs(DIST_DIR, exist_ok=True)
    path = os.path.join(DIST_DIR, "store")
    if os.path.exists(path):
        os.remove(path)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.FileStore(path, 1), rank=0,
                            world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    return dist


def whole(t):
    """A DTensor's whole value; a plain tensor as it is."""
    from repro_torch.dist.sharding import is_dtensor

    return t.full_tensor() if is_dtensor(t) else t


def dist_batch(torch, cfg, seed: int) -> dict:
    """``DIST_SHAPE`` random tokens from ``RandomState(seed + 3)`` on the
    card; labels are the next token (-1 at the end)."""
    import numpy as np

    t = np.random.RandomState(seed + 3).randint(
        0, cfg.vocab, DIST_SHAPE).astype(np.int32)
    labels = np.roll(t, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": torch.from_numpy(t).cuda(),
            "labels": torch.from_numpy(labels).cuda()}


def dist_step(torch, model, params, batch, policy) -> dict:
    """The loss and gradients (``make_loss_and_grads``), then one train step
    (in place on ``params``) and its wall ms; every tensor returned whole."""
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import (TrainStepConfig, make_loss_and_grads,
                                        make_train_step)
    from repro_torch.tree import leaves

    _, _, grads = make_loss_and_grads(model, policy)(params, batch)
    opt = AdamW(lr=1e-3)
    state = opt.init(params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, m = make_train_step(model, opt, policy, TrainStepConfig())(
        params, state, batch)
    loss = whole(m["loss"])
    float(loss)  # synchronizes
    return {"ms": (time.perf_counter() - t0) * 1e3, "loss": loss,
            "grads": [whole(g) for g in grads],
            "params": [whole(p) for p in leaves(params)]}


def dist_gaps(torch, names, got: dict, want: dict) -> dict:
    """Bit-equality of two ``dist_step`` results, and where they first
    differ: the loss's gap, and per tree the largest gap over the leaf's
    largest value."""

    def tree_gap(a, b):
        first, worst = None, 0.0
        for n, x, y in zip(names, a, b):
            if torch.equal(x, y):
                continue
            d = float((x.double() - y.double()).abs().max()
                      / max(float(y.double().abs().max()), 1e-30))
            first = first or [n, d]
            worst = max(worst, d)
        return first, worst

    out = {"loss_gap": abs(float(got["loss"]) - float(want["loss"]))}
    for key in ("grads", "params"):
        out[f"{key}_first"], out[f"{key}_gap"] = tree_gap(got[key],
                                                          want[key])
    out["bit_equal"] = not any(out[f"{k}_gap"]
                               for k in ("loss", "grads", "params"))
    return out


def psum_plain(torch, grads, errors, npods: int = 1):
    """``compressed_psum_pod``'s arithmetic with no collective: what every
    pod gets when there is one."""
    from repro_torch.core.formats import INT8
    from repro_torch.core.quantize import (dequantize, div_by_constant,
                                           quantize)

    red, errs = [], []
    for g, e in zip(grads, errors):
        g32 = g.to(torch.float32) + e
        alpha = torch.clamp_min(torch.amax(torch.abs(g32)), 1e-8)
        codes, scale = quantize(g32, alpha, INT8)
        red.append(div_by_constant(dequantize(codes.to(torch.int32), scale),
                                   npods).to(g.dtype))
        errs.append(g32 - dequantize(codes, scale))
    return red, errs


def events_ms(torch, fn, n: int) -> float:
    """Median ms of ``n`` calls of ``fn``, CUDA events around each."""
    fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def dist_refusals(torch, mesh) -> dict:
    """(d) A DTensor handed to ``quant_matmul`` and to
    ``flash_attention_quant``: each raises ``TypeError`` before any
    launch."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.core.formats import INT8
    from repro_torch.kernels.flash_attention_quant import \
        flash_attention_quant
    from repro_torch.kernels.quant_matmul import quant_matmul

    rep = [Replicate()] * mesh.ndim
    dt = lambda t: distribute_tensor(t, mesh, rep)
    x = dt(torch.randn(4, 512, device="cuda"))
    codes = torch.zeros(256, 512, dtype=torch.int8, device="cuda")
    scales = torch.ones(512, 8, device="cuda")
    qh = dt(torch.randn(1, 1, 4, 128, device="cuda"))
    kc = torch.zeros(1, 64, 1, 128, dtype=torch.int8, device="cuda")
    ks = torch.ones(1, 64, 1, device="cuda")
    pos = torch.zeros(1, 1, dtype=torch.int32, device="cuda")
    kvp = torch.arange(64, dtype=torch.int32, device="cuda")[None]
    calls = {"quant_matmul": lambda: quant_matmul(x, codes, scales, INT8,
                                                  64, True),
             "flash_attention_quant": lambda: flash_attention_quant(
                 qh, kc, kc, ks, ks, pos, kvp, 64, scale=128 ** -0.5)}
    reset_counts()
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = "returned"
        except TypeError as e:
            out[name] = str(e)
    launched = {k: v for k, v in read_counts().items() if v}
    if launched or not all("DTensor" in v for v in out.values()):
        raise SystemExit(f"dist: (d) a DTensor reached a kernel: {out}, "
                         f"launches {launched}")
    return {"raised": out, "launches": launched}


def dist_plans(torch) -> dict:
    """(e) qwen2-7b's restore plans at full width and depth on the
    production mesh shapes, dense and compressed (``meta`` tensors: host
    only)."""
    from repro_torch.configs import get_config
    from repro_torch.core.policy import preset
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.elastic import restore_specs
    from repro_torch.models import build_model
    from repro_torch.models.serving_transforms import (compress_axes,
                                                       compress_weights)

    t0 = time.perf_counter()
    model = build_model(get_config("qwen2-7b"), device="meta")
    meta = model.init(torch.Generator())
    axes = model.param_axes()
    comp = compress_weights(meta, preset("w4a8_abfp"))
    trees = {"dense": (axes, meta),
             "compressed": (compress_axes(axes, comp), comp)}
    out = {}
    for mname, names, shape in (
            ("16x16", ("data", "model"), (16, 16)),
            ("2x16x16", ("pod", "data", "model"), (2, 16, 16))):
        for kind, (ax, tree) in trees.items():
            _, report = restore_specs(ax, tree, PlanMesh(names, shape),
                                      shd.DEFAULT_RULES)
            out[f"{mname} {kind}"] = {
                "summary": report.summary(),
                "fallbacks": sorted({(f.logical, f.size, f.ways, f.kept)
                                     for f in report.fallbacks})}
            log(f"  (e) qwen2-7b {kind} on {mname}: {report.summary()}; "
                f"fallbacks by (axis, size, ways, kept): "
                f"{out[f'{mname} {kind}']['fallbacks']}")
    out["host_s"] = time.perf_counter() - t0
    return out


def phase_dist(torch, seed: int, smi: str) -> dict:
    import shutil

    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.checkpoint import store
    from repro_torch.configs import get_config
    from repro_torch.core.policy import preset
    from repro_torch.dist import sharding as shd
    from repro_torch.dist.elastic import shardings_for_restore
    from repro_torch.launch import specs as sp
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import build_model
    from repro_torch.nn.module import make_generator
    from repro_torch.optim.compression import compressed_psum_pod
    from repro_torch.tree import flatten_with_paths, leaves, tree_map

    log("== dist: a world of one over NCCL, (1, 1) meshes; opt-125m's "
        "sharded QAT step, elastic restore + fused forward, "
        "compressed_psum_pod, kernel refusals, qwen2-7b's restore plans")
    t_phase = time.perf_counter()
    dist = dist_world_of_one(torch)
    report = {}
    try:
        mesh = make_debug_mesh(1, 1)  # ("data", "model"), on the card
        rules = dict(shd.DEFAULT_RULES)
        cfg = get_config("opt-125m")
        model = build_model(cfg, device="cuda")
        params0 = model.init(make_generator(seed, "cuda"))
        names = [p for p, _ in flatten_with_paths(params0)]
        batch = dist_batch(torch, cfg, seed)
        policy = preset("w4a8_abfp").with_ste(True)
        psh = sp.shardings_from_axes(model.param_axes(), mesh, rules, params0)
        bsh = sp.shardings_from_axes({"tokens": ("batch", None),
                                      "labels": ("batch", None)}, mesh,
                                     rules, batch)

        # (a) the sharded QAT step against the unsharded one
        reset_counts()
        plain = dist_step(torch, model, tree_clone(params0), batch, policy)
        sharded_params = sp.distribute(tree_clone(params0), psh)
        with shd.use_rules(mesh, rules):
            sharded = dist_step(torch, model, sharded_params,
                                sp.distribute(batch, bsh), policy)
        launched = {k: v for k, v in read_counts().items() if v}
        gaps = dist_gaps(torch, names, sharded, plain)
        a = {"policy": policy.name, "batch": list(DIST_SHAPE),
             "loss": float(plain["loss"]), "n_leaves": len(names),
             "placements": {n: str(t.placements) for n, t in
                            list(zip(names, leaves(sharded_params)))[:4]},
             "step_ms": {"unsharded": plain["ms"], "sharded": sharded["ms"]},
             "launches": launched, **gaps}
        if not gaps["bit_equal"]:
            # the unsharded step with one ulp moved in half the embedding
            ctrl = tree_clone(params0)
            half = ctrl["embed"]["table"].view(-1)
            half = half[:half.numel() // 2]
            half.copy_(torch.nextafter(half, torch.full_like(half, math.inf)))
            a["control"] = dist_gaps(torch, names, dist_step(
                torch, model, ctrl, batch, policy), plain)
            del ctrl
            held = all(gaps[f"{k}_gap"] <= a["control"][f"{k}_gap"]
                       for k in ("loss", "grads", "params"))
            a["held_to_control"] = held
        report["a"] = a
        log("  (a) " + json.dumps(a))
        if launched or not (gaps["bit_equal"] or a["held_to_control"]):
            raise SystemExit(f"dist: (a) the sharded step is not the "
                             f"unsharded one: {a}")

        # (b) saved, restored onto the mesh, gathered, one fused forward
        ck = os.path.join(DIST_DIR, "ck")
        shutil.rmtree(ck, ignore_errors=True)
        saved = [whole(p) for p in leaves(sharded_params)]
        t0 = time.perf_counter()
        store.save_pytree(ck, 1, sharded_params)
        store.mark_committed(ck, 1)
        save_s = time.perf_counter() - t0
        meta = build_model(cfg, device="meta").init(torch.Generator())
        shardings, rep = shardings_for_restore(model.param_axes(), meta,
                                               mesh, rules)
        t0 = time.perf_counter()
        restored = store.restore_pytree(ck, 1, meta, shardings=shardings)
        restore_s = time.perf_counter() - t0
        rleaves = leaves(restored)
        b = {"summary": rep.summary(), "fallbacks": len(rep.fallbacks),
             "dtensors": all(map(shd.is_dtensor, rleaves)),
             "bit_equal": all(torch.equal(whole(x), y)
                              for x, y in zip(rleaves, saved)),
             "save_s": save_s, "restore_s": restore_s}
        full = tree_map(whole, restored)
        unrestored = tree_map(whole, sharded_params)
        del restored, sharded_params
        fwd = {"tokens": batch["tokens"]}
        kp = fixed_policy("p_fp")
        reset_counts()
        logits = ptq_logits(torch, model, full, fwd, kp)
        report["launches"] = read_counts()
        got = {k: v for k, v in report["launches"].items() if v}
        want = {"abfp_matmul": ptq_dense(cfg),
                "flash_attention": cfg.n_layers}
        kept = save_counts()  # the comparison's forward is not counted
        b["logits_bit_equal"] = torch.equal(
            logits, ptq_logits(torch, model, unrestored, fwd, kp))
        restore_counts(kept)
        b["forward_launches"] = got
        report["b"] = b
        log(f"  (b) {rep.summary()}; " + json.dumps(b))
        if not (b["dtensors"] and b["bit_equal"] and got == want
                and b["logits_bit_equal"]):
            raise SystemExit(f"dist: (b) restore or fused forward: {b}; "
                             f"launches expected {want}")
        del full, unrestored, logits

        # (c) the int8-compressed pod all-reduce on (a)'s gradients
        pmesh = init_device_mesh("cuda", (1, 1),
                                 mesh_dim_names=("pod", "data"))
        grads = plain["grads"]
        errors = [torch.zeros_like(g, dtype=torch.float32) for g in grads]
        red, enew = compressed_psum_pod(grads, errors, pmesh)
        pred, penew = psum_plain(torch, grads, errors)
        c = {"leaves": len(grads),
             "bytes": sum(g.numel() * g.element_size() for g in grads),
             "bit_equal": all(torch.equal(x, y) for x, y in zip(
                 red + enew, pred + penew)),
             "ms": events_ms(torch, lambda: compressed_psum_pod(
                 grads, errors, pmesh), DIST_TIMED),
             "plain_ms": events_ms(torch, lambda: psum_plain(
                 torch, grads, errors), DIST_TIMED)}
        report["c"] = c
        log(f"  (c) compressed_psum_pod over {c['leaves']} gradients "
            f"({c['bytes']} bytes): {c['ms']:.3f} ms, plain "
            f"{c['plain_ms']:.3f} ms, bit-equal {c['bit_equal']} [{smi}]")
        if not c["bit_equal"]:
            raise SystemExit(f"dist: (c) compressed_psum_pod is not its "
                             f"plain version: {c}")
        del plain, sharded, red, enew, pred, penew

        # (d), (e)
        report["d"] = dist_refusals(torch, mesh)
        log("  (d) " + json.dumps(report["d"]))
        report["e"] = dist_plans(torch)
    finally:
        dist.destroy_process_group()
        shutil.rmtree(DIST_DIR, ignore_errors=True)
        free_card(torch)
    report["phase_s"] = time.perf_counter() - t_phase
    log(f"  dist phase {report['phase_s']:.1f} s [{smi}]")
    return report


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

    count_gates()
    runs = {"kernels": lambda: phase_kernels(torch, args.seed),
            "lint": lambda: phase_lint(torch, args.seed, smi),
            "serve": lambda: phase_serve(torch, args.seed),
            "long": lambda: phase_long(torch, args.seed),
            "fixed": lambda: phase_fixed(torch, args.seed),
            "reduced": lambda: phase_reduced(torch, args.seed),
            "identity": lambda: phase_identity(torch, args.seed),
            "spec": lambda: phase_spec(torch, args.seed, smi),
            "ptq": lambda: phase_ptq(torch, args.seed, smi),
            "vit": lambda: phase_vit(torch, args.seed, smi),
            "ssm": lambda: phase_ssm(torch, args.seed, smi),
            "encdec": lambda: phase_encdec(torch, args.seed, smi),
            "dense_archs": lambda: phase_dense_archs(torch, args.seed, smi),
            "moe": lambda: phase_moe(torch, args.seed, smi),
            "train": lambda: phase_train(torch, args.seed, smi),
            "dist": lambda: phase_dist(torch, args.seed, smi)}
    done = {}
    phase_s = {"build": round(time.perf_counter() - t_start, 1)}
    for name in PHASES:
        if name in phases:
            PHASE["name"] = name
            t0 = time.perf_counter()
            done[name] = runs[name]()
            phase_s[name] = round(time.perf_counter() - t0, 1)
    log("== seconds by phase: " + json.dumps(phase_s))
    (kernel_rows, lint, serve, long_ctx, fixed, spec, ptq, vit, ssm, encdec,
     dense, moe, train, dist) = (done.get(p) for p in (
         "kernels", "lint", "serve", "long", "fixed", "spec", "ptq", "vit",
         "ssm", "encdec", "dense_archs", "moe", "train", "dist"))
    retakes = {p: {"empty": 0, "other": 0} for p in phases}
    for r in PROFILER_RETRIES:
        retakes.setdefault(r["phase"], {"empty": 0, "other": 0})[
            "other" if r["read"] else "empty"] += 1
    log("== profiler captures taken again, by phase: " + json.dumps(retakes))

    # launches of each kernel on the main paths, each counted from 0 just
    # before its run: the paged serve run, the long-context run, the two
    # fixed-slot runs, the three speculative runs, the PTQ phase's fused
    # evaluations, the vision
    # phase's fused forwards, the SSM phase's served and Model runs, the
    # encdec phase's Model runs, the last families' served and Model runs
    # the training phase's fused evaluations of its QAT'd weights and the
    # distribution phase's fused forward of its restored weights
    paths = {"serve": (serve or {}).get("launches", {}),
             "long": (long_ctx or {}).get("launches", {}),
             **{f"fixed_{k}": r["launches"] for k, r in (fixed or {}).items()},
             "spec": (spec or {}).get("launches", {}),
             "ptq": (ptq or {}).get("launches", {}),
             "vit": (vit or {}).get("launches", {}),
             "ssm": (ssm or {}).get("launches", {}),
             "encdec": (encdec or {}).get("launches", {}),
             "dense_archs": (dense or {}).get("launches", {}),
             "moe": (moe or {}).get("launches", {}),
             "train": (train or {}).get("launches", {}),
             "dist": (dist or {}).get("launches", {})}
    # the lint phase's longest groups and the ptq, vit, ssm, encdec,
    # dense_archs, moe and train paths' shapes join their kernels' rows
    kernel_rows = dict(kernel_rows or {})
    for extra in (lint, spec, ptq, vit, ssm, encdec, dense, moe, train):
        for name, rows in (extra or {}).get("kernel_rows", {}).items():
            kernel_rows[name] = kernel_rows.get(name, []) + rows
    # the shape whose numbers head a kernel's entry: the decode shape
    # launched most (matmuls), the longest prefill bucket (flash attention)
    head_shape = {"quant_matmul": "wi,wg M=4", "abfp_matmul": "wi,wg M=4",
                  "abfp_matmul_int8": "wi,wg M=4",
                  "flash_attention": "prefill B=1 S=T=192",
                  "abfp_qdq": "M=256 K=3584 int8"}
    kernels = []
    for name, (mod, replaces) in KERNELS.items():
        rows = (kernel_rows or {}).get(name, [])
        head = next((r for r in rows
                     if r["shape"].startswith(head_shape.get(name, ""))), {})
        by_path = {p: c[name] for p, c in paths.items() if c.get(name)}
        if name == "abfp_qdq":
            # its kernel is abfp_matmul's x pre-pass on the P-fp path
            by_path.update({f"fixed_{k}": r["x_qdq_launches"][
                "qdq_stream_kernel"] for k, r in (fixed or {}).items()
                if r["x_qdq_launches"]["qdq_stream_kernel"]})
            # and before the vision path's 16-image head
            vit_qdq = ((vit or {}).get("launches_by_kernel", {})
                       .get("abfp_matmul", {}).get("qdq_stream_kernel"))
            if vit_qdq:
                by_path["vit"] = vit_qdq
            # and on the SSM, encdec and last families' paths' P-fp and
            # P-C matmuls of up to 16 rows
            for p, r in (("spec", spec), ("ssm", ssm), ("encdec", encdec),
                         ("dense_archs", dense), ("moe", moe)):
                if (r or {}).get("prepass_launches"):
                    by_path[p] = r["prepass_launches"]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{build.SOURCES[mod]}",
            "replaces": replaces,
            "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            # abfp_qdq's own wrapper is on no model path, in the reference
            # as here; its kernel is, as abfp_matmul's x pre-pass
            "on_main_path": bool(by_path) or name != "abfp_qdq",
            "max_abs_err": max((r["max_abs_err"] for r in rows),
                               default=None),
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            # only flash_attention has one PyTorch call computing the same
            # function (scaled_dot_product_attention); a yardstick only
            "library_ms": head.get("library_ms"),
            "timed_shape": head.get("shape"),
            "shapes": rows,
        })
    # abfp_qdq: the kernel and the x pre-pass of a profiled P-fp decode
    # tick, and the copy yardstick at the head shape
    qdq = kernels[[k["name"] for k in kernels].index("abfp_qdq")]
    qdq_head = next((r for r in (kernel_rows or {}).get("abfp_qdq", [])
                     if r["shape"].startswith(head_shape["abfp_qdq"])), {})
    tick = ((fixed or {}).get("p_fp", {}).get("profile", {})
            .get("watched_kernels_per_step", {}).get("qdq_stream_kernel"))
    qdq.update({"kernel": "qdq_stream_kernel",
                "via": "abfp_matmul's x pre-pass (decode and simt regimes)",
                "copy_ms": qdq_head.get("copy_ms"),
                "p_fp_decode_tick": tick})
    # flash_attention: its one kernel, and the bytes floor beside the
    # operations (as issued: three tf32 products a product; and as f32 on
    # the CUDA cores, a reference)
    fa = kernels[[k["name"] for k in kernels].index("flash_attention")]
    fa_head = next((r for r in (kernel_rows or {}).get("flash_attention", [])
                    if r["shape"].startswith(head_shape["flash_attention"])),
                   {})
    fa.update({"kernel": "flash_mma_kernel",
               "launches_by_kernel": {"flash_mma_kernel": fa["launches"]},
               "bytes_ms": fa_head.get("bytes_ms"),
               "ops_tf32_split_ms": fa_head.get("ops_ms"),
               "ops_f32_simt_ms": fa_head.get("ops_f32_simt_ms")})
    # flash_attention_quant's prefill, decode, long and decode-long
    # kernels: an entry each, timed at the main paths' prefill / decode /
    # long chunk / long decode shape, launched on the serve path's chunk /
    # decode steps and the long path's chunk / decode steps
    rows = (kernel_rows or {}).get("flash_attention_quant", [])
    by_path = {p: (r or {}).get("launches_by_kernel") or {}
               for p, r in (("serve", serve), ("long", long_ctx),
                            ("spec", spec), ("encdec", encdec),
                            ("dense_archs", dense), ("moe", moe))}
    kernels[[k["name"] for k in kernels].index("flash_attention_quant")][
        "launches_by_kernel"] = by_path
    for kernel, timed_shape, replaces in (
            ("attention_prefill_kernel", "prefill S=64 T=512 int8 exact",
             "(_kernel_exact, :109)"),
            ("attention_decode_kernel", "decode S=1 T=512 int8 exact",
             "(_kernel_exact, :109)"),
            ("attention_long_kernel", "long S=64 T=8192 int8 phased",
             "(_kernel_phased, :167; _kernel_online, :128; _kernel_exact, "
             ":109)"),
            ("attention_decode_long_kernel",
             "long decode S=1 T=8192 int8 phased",
             "(_kernel_phased, :167; _kernel_online, :128; _kernel_exact, "
             ":109)")):
        head = next((r for r in rows if r["shape"] == timed_shape), {})
        launched = {p: c.get(kernel, 0) for p, c in by_path.items()
                    if c.get(kernel, 0)}
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_quant.cu",
            "replaces": "src/repro/kernels/flash_attention_quant.py:223 "
                        + replaces,
            "launches": sum(launched.values()),
            "launches_by_path": launched,
            "on_main_path": True, "wrapper": "flash_attention_quant",
            "max_abs_err": max((r["max_abs_err"] for r in rows
                                if r.get("kernel") == {kernel: 1}),
                               default=None),
            "ms": head.get("ms"), "plain_ms": head.get("plain_ms"),
            "bound_ms": head.get("bound_ms"),
            "bound_by": head.get("bound_by"),
            "library_ms": head.get("library_ms"),
            "library_is": head.get("library_is"),
            "attention_kernel_ms": head.get("attention_kernel_ms"),
            "timed_shape": head.get("shape"),
        })
        for key in ("recompute_ms", "store_ms", "scratch_bytes"):
            if key in head:
                kernels[-1][key] = head[key]
    log(f"== done in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
