"""``attention_prefill_kernel``: the exact body of ``flash_attention_quant``
at S > 1 on the bf16 tensor cores, emulated on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there and reads from the profiler which kernel each call
launches).  What it computes is pinned here by an emulation of its
arithmetic, fed the same numpy inputs as the reference package's
``flash_attention_quant_gqa`` (Pallas, interpret mode) and the port's
plain version:

  * each block serves ``plan_attention_prefill``'s positions of one KV
    head (row = position * G + head) and walks only the 64-key tiles some
    row of it can see, or every tile when a position sees no key;
  * scores as the plain version forms them on the card: k = code * ks in
    f32, one fmaf chain over d = 0 .. D - 1 from 0 a (row, key), times
    scale; masked scores the finite -1e9;
  * softmax as the kernel's warp does it: lane l sums keys t0 + l and
    t0 + 32 + l of each walked tile in order, then a butterfly; p = e /
    sum, the group QDQ, w = p * vs;
  * P.V on the tensor cores: w split into three bf16 terms hi + mid + lo;
    a 16-key MMA step adds the exact sum of 16 products (bf16 times a
    code) to an f32 accumulator, rounding once (hi terms in one
    accumulator, mid then lo in another).

Tolerances are the card's bars (``chip_smoke.check_attention``): 2e-5 of
the largest output without the probs QDQ (f32 products, sums in another
order); with it, 5e-3 and at least 99 % of the elements within 2e-5 (a
probability on a rounding boundary of the QDQ may flip one code).
Skipping tiles is held bit-equal to walking them all.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.policy import TensorQuant as JTensorQuant
from repro.kernels import ops as jkops
from repro_torch.core.policy import TensorQuant as TTensorQuant
from repro_torch.core.quantize import div_by_constant
from repro_torch.kernels import flash_attention_quant as faq
from repro_torch.kernels import ops as tkops

NEG_INF = -1e9
KEYS = faq.PREFILL_KEYS


# --------------------------------------------------------------------------
# the emulation
# --------------------------------------------------------------------------
def split3(x: torch.Tensor):
    """f32 -> hi, mid, lo (bf16 values held in f32): each term the bf16
    nearest what the terms before it leave."""
    hi = x.to(torch.bfloat16).to(torch.float32)
    r = x - hi
    mid = r.to(torch.bfloat16).to(torch.float32)
    lo = (r - mid).to(torch.bfloat16).to(torch.float32)
    return hi, mid, lo


def mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc + a @ b over one 16-wide step: bf16 x code products are exact,
    their sum is exact in f64, and the f32 accumulator rounds once."""
    return (acc.double() + a.double() @ b.double()).to(torch.float32)


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf: a * b is exact in f64, a * b + c rounded to f64 then to f32
    (a double rounding that differs from one rounding only on ties)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def lane_sum(e: torch.Tensor) -> torch.Tensor:
    """Row sums as the kernel's warp forms them: e (rows, tiles, 2, 32),
    each lane adding its keys in order, then a butterfly over lanes."""
    v = torch.zeros(e.shape[0], 32)
    for i in range(e.shape[1]):
        for h in range(2):
            v = v + e[:, i, h]
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v[:, :1]


def probs_qdq(p: torch.Tensor, n: int, qmax: float, qmin: float):
    """Group QDQ of probabilities along the last axis (groups of n)."""
    pg = p.reshape(p.shape[0], -1, n)
    alpha = pg.amax(-1, keepdim=True).to(torch.bfloat16).to(torch.float32)
    step = div_by_constant(torch.clamp_min(alpha, 1e-12), qmax)
    return (torch.clamp(torch.round(pg / step), qmin, qmax) * step
            ).reshape(p.shape)


def live_tiles(vis: torch.Tensor, pos_alive: torch.Tensor, n_tiles: int,
               pn: int, skip: bool) -> list:
    """Tiles a block walks: those a row can see (whole probs groups when a
    group spans tiles); all of them when a position sees no key."""
    if not skip or not bool(pos_alive.all()):
        return list(range(n_tiles))
    pad = n_tiles * KEYS - vis.shape[1]
    seen = torch.nn.functional.pad(vis, (0, pad)).reshape(
        vis.shape[0], n_tiles, KEYS).any(-1).any(0)
    span = pn // KEYS if pn > KEYS else 1
    out = []
    for t0 in range(0, n_tiles, span):
        if bool(seen[t0:t0 + span].any()):
            out += list(range(t0, t0 + span))
    return out


def emulate(qh, kc, vc, ks, vs, q_pos, kv_pos, window, *, scale,
            causal=True, probs_n=0, probs_qmax=0.0, probs_qmin=0.0,
            skip=True):
    """``attention_prefill_kernel``'s arithmetic on CPU tensors (the
    arguments of ``flash_attention_quant``, exact body)."""
    B, S, H, D = qh.shape
    T, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    plan = faq.plan_attention_prefill(B, S, T, H, KV, D)
    n_tiles = -(-T // KEYS)
    kcf, vcf = kc.to(torch.float32), vc.to(torch.float32)
    out = torch.zeros(B, S, H, D)
    for b in range(B):
        for kvh in range(KV):
            for s0 in range(0, S, plan.positions):
                n_pos = min(plan.positions, S - s0)
                q = qh[b, s0:s0 + n_pos, kvh * G:(kvh + 1) * G].reshape(-1, D)
                qp = q_pos[b, s0:s0 + n_pos].repeat_interleave(G)[:, None]
                kp = kv_pos[b][None]
                vis = (kp >= 0) & (kp > qp - window)
                if causal:
                    vis = vis & (kp <= qp)
                tiles = live_tiles(vis, vis.reshape(n_pos, G, T)[:, 0]
                                   .any(-1), n_tiles, probs_n, skip)
                keys = torch.tensor([t for i in tiles
                                     for t in range(i * KEYS, (i + 1) * KEYS)])
                real = keys < T
                kk = torch.where(real, keys, 0)
                # scores: the plain version's k = code * ks, one f32 chain
                # over d a (row, key)
                k = kcf[b, kk, kvh] * ks[b, kk, kvh][:, None] * real[:, None]
                acc = torch.zeros(q.shape[0], len(keys))
                for d in range(D):
                    acc = fma(q[:, d, None], k[None, :, d], acc)
                s = torch.where(vis[:, kk] & real, acc * scale, NEG_INF)
                # softmax over the keys that exist, the kernel's sum order
                m = torch.where(real, s, -math.inf).amax(-1, keepdim=True)
                e = torch.where(real, torch.exp(s - m), 0.0)
                ssum = lane_sum(e.reshape(-1, len(tiles), 2, 32))
                p = torch.where(real, e / ssum, 0.0)
                if probs_n:
                    p = probs_qdq(p, probs_n, probs_qmax, probs_qmin)
                w = p * vs[b, kk, kvh] * real
                # P.V, 16 keys a step
                vt = vcf[b, kk, kvh] * real[:, None]
                w_hi, w_mid, w_lo = split3(w)
                o_hi = o_lo = torch.zeros(q.shape[0], D)
                for t in range(0, len(keys), 16):
                    o_hi = mma(o_hi, w_hi[:, t:t + 16], vt[t:t + 16])
                    o_lo = mma(o_lo, w_mid[:, t:t + 16], vt[t:t + 16])
                    o_lo = mma(o_lo, w_lo[:, t:t + 16], vt[t:t + 16])
                out[b, s0:s0 + n_pos, kvh * G:(kvh + 1) * G] = (
                    o_hi + o_lo).reshape(n_pos, G, D)
    return out


# --------------------------------------------------------------------------
# inputs: cache-style rows (chip_smoke.attention_inputs, in numpy)
# --------------------------------------------------------------------------
def _inputs(B, S, T, H, KV, D, q_starts, *, fp8=False, seed=0):
    """Row b holds q_starts[b] + S tokens; a start of -1 makes a dead row
    (every kv position invalid)."""
    rng = np.random.RandomState(seed)
    qh = rng.randn(B, S, H, D).astype(np.float32)
    codes = rng.randint(-127, 128, (2, B, T, KV, D)).astype(np.float32)
    if fp8:
        codes = codes / 16.0  # e4m3-representable values
    ks = (rng.rand(B, T, KV) * 0.05 + 1e-3).astype(np.float32)
    vs = (rng.rand(B, T, KV) * 0.05 + 1e-3).astype(np.float32)
    starts = np.asarray(q_starts)
    q_pos = (np.maximum(starts, 0)[:, None] + np.arange(S)).astype(np.int32)
    n_ctx = np.where(starts >= 0, starts + S, 0)
    idx = np.arange(T)[None]
    kv_pos = np.where(idx < n_ctx[:, None], idx, -1).astype(np.int32)
    return qh, codes[0], codes[1], ks, vs, q_pos, kv_pos


def _torch_args(inp, fp8):
    qh, kc, vc, ks, vs, q_pos, kv_pos = inp
    ct = torch.float8_e4m3fn if fp8 else torch.int8
    return (torch.from_numpy(qh), torch.from_numpy(kc).to(ct),
            torch.from_numpy(vc).to(ct), torch.from_numpy(ks),
            torch.from_numpy(vs), torch.from_numpy(q_pos),
            torch.from_numpy(kv_pos))


def _reference(inp, fp8, *, window, causal, probs_n):
    """The reference package's front-end (Pallas kernel, interpret mode)."""
    qh, kc, vc, ks, vs, q_pos, kv_pos = inp
    ct = jnp.float8_e4m3fn if fp8 else jnp.int8
    tq = JTensorQuant("int8", group=probs_n) if probs_n else None
    return np.asarray(jkops.flash_attention_quant_gqa(
        jnp.asarray(qh), jnp.asarray(kc, ct), jnp.asarray(vc, ct),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(q_pos),
        jnp.asarray(kv_pos),
        window=None if window is None else jnp.asarray(window, jnp.int32),
        causal=causal, probs_tq=tq, interpret=True))


def _within_bars(got, want, probs: bool):
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    vmax = np.abs(want).max()
    diff = np.abs(got - want)
    if probs:
        assert diff.max() <= 5e-3 * vmax, (diff.max(), vmax)
        assert (diff <= 2e-5 * vmax).mean() > 0.99
    else:
        assert diff.max() <= 2e-5 * vmax, (diff.max(), vmax)


# (fp8, probs_n, causal, window): B = 4 rows starting at 0, T - S, 37 and
# a dead row; T = 192 (three tiles), S = 16, H = 4, KV = 2 (G = 2), D = 32
CASES = {
    "int8-probs": (False, 64, True, None),
    "int8": (False, 0, True, None),
    "fp8-probs": (True, 64, True, None),
    "fp8-noncausal": (True, 0, False, None),
    "int8-probs-window": (False, 64, True, 40),
    "int8-probs-n32": (False, 32, True, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_against_reference_and_plain(case):
    fp8, probs_n, causal, window = CASES[case]
    B, S, T, H, KV, D = 4, 16, 192, 4, 2, 32
    inp = _inputs(B, S, T, H, KV, D, [0, T - S, 37, -1], fp8=fp8, seed=3)
    args = _torch_args(inp, fp8)
    kw = dict(scale=D ** -0.5, causal=causal, probs_n=probs_n,
              probs_qmax=127.0 if probs_n else 0.0,
              probs_qmin=-127.0 if probs_n else 0.0)
    win = (T + S + 1) if window is None else window
    assert faq.plan_attention(B, S, T, H, KV, D, T, probs_n).kernel == \
        "attention_prefill_kernel"
    got = emulate(*args, win, **kw)
    plain = faq.flash_attention_quant_plain(*args, win, **kw)
    _within_bars(got, plain, bool(probs_n))
    ref = _reference(inp, fp8, window=window, causal=causal, probs_n=probs_n)
    _within_bars(got, ref, bool(probs_n))
    # the dead row is the uniform mean over all T keys, as the plain version
    _within_bars(got[3], plain[3], bool(probs_n))


def test_emulation_ragged_tiles_and_wide_groups():
    """T = 100 (a partial last tile: its missing keys take no part) without
    the probs QDQ, and 128-key groups spanning two tiles (walked together)
    with it."""
    inp = _inputs(3, 8, 100, 4, 2, 16, [0, 92, 30], seed=5)
    args = _torch_args(inp, False)
    kw = dict(scale=0.25, causal=True)
    got = emulate(*args, 1 << 20, **kw)
    _within_bars(got, faq.flash_attention_quant_plain(*args, 1 << 20, **kw),
                 False)
    inp = _inputs(3, 8, 256, 4, 2, 16, [0, 248, 120], seed=6)
    args = _torch_args(inp, False)
    kw = dict(scale=0.25, causal=True, probs_n=128, probs_qmax=127.0,
              probs_qmin=-127.0)
    got = emulate(*args, 1 << 20, **kw)
    _within_bars(got, faq.flash_attention_quant_plain(*args, 1 << 20, **kw),
                 True)


@pytest.mark.parametrize("probs_n", [0, 64, 128])
def test_skipping_tiles_is_bit_exact(probs_n):
    """Tiles no row of a block can see hold exact zeros (exp(-1e9 - m) is
    0, a zero group QDQs to 0, a zero product adds nothing), so skipping
    them leaves every output bit as it is; the block of the dead row walks
    every tile either way."""
    B, S, T, H, KV, D = 4, 8, 512, 4, 2, 16
    inp = _inputs(B, S, T, H, KV, D, [0, 504, 200, -1], seed=7)
    args = _torch_args(inp, False)
    kw = dict(scale=0.25, causal=True, probs_n=probs_n,
              probs_qmax=127.0 if probs_n else 0.0,
              probs_qmin=-127.0 if probs_n else 0.0)
    q_pos, kv_pos = args[5], args[6]
    # row 0 sees one tile of eight; row 2 four
    vis = (kv_pos[0] >= 0) & (kv_pos[0] <= q_pos[0, -1])
    assert int(vis.sum()) == S
    skipped = emulate(*args, 1 << 20, **kw, skip=True)
    walked = emulate(*args, 1 << 20, **kw, skip=False)
    assert torch.equal(skipped, walked)


# --------------------------------------------------------------------------
# the split
# --------------------------------------------------------------------------
@settings(max_examples=400, deadline=None)
@given(st.floats(min_value=2.0 ** -100, max_value=2.0 ** 127, width=32),
       st.booleans())
def test_three_bf16_terms_carry_an_f32(x, neg):
    """hi + mid + lo is within 2^-24 |x| of x for every f32 of normal size
    (up to 2^127: past bf16's largest finite value hi rounds to inf)."""
    v = torch.tensor([-x if neg else x], dtype=torch.float32)
    hi, mid, lo = split3(v)
    for t in (hi, mid, lo):
        assert torch.equal(t.to(torch.bfloat16).to(torch.float32), t)
    err = abs(hi.double() + mid.double() + lo.double() - v.double()).item()
    assert err <= 2.0 ** -24 * abs(v.item())


def test_two_terms_do_not_carry_an_f32():
    """Why three: hi + mid leaves up to about 2^-17 of x."""
    v = torch.tensor([1.0 + 2.0 ** -9 + 2.0 ** -18 + 2.0 ** -23])
    hi, mid, _ = split3(v)
    assert abs((hi.double() + mid.double() - v.double()).item()) > 2.0 ** -20


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------
# (B, S, T, H, KV, D, bk, probs_n) -> (kernel, positions, rows, grid,
# shared memory, keys a block owns): every shape chip_smoke.py checks, the
# main path's first (the decode ranges: test_torch_attention_decode.py)
@pytest.mark.parametrize("shape,want", [
    ((4, 64, 512, 28, 4, 128, 512, 64),
     ("attention_prefill_kernel", 8, 64, (8, 4, 4), 225616, 512)),
    ((4, 1, 512, 28, 4, 128, 512, 64),
     ("attention_decode_kernel", 1, 7, (8, 4, 4), 57056, 64)),
    ((4, 1, 512, 28, 4, 128, 512, 0),
     ("attention_decode_kernel", 1, 7, (8, 4, 4), 57056, 64)),
    ((4, 5, 512, 28, 4, 128, 512, 0),
     ("attention_prefill_kernel", 5, 64, (1, 4, 4), 225616, 512)),
    ((4, 37, 200, 28, 4, 128, 200, 0),
     ("attention_prefill_kernel", 8, 64, (5, 4, 4), 156976, 200)),
    ((4, 64, 512, 28, 4, 128, 512, 32),
     ("attention_prefill_kernel", 8, 64, (8, 4, 4), 225616, 512)),
    ((4, 64, 512, 28, 4, 128, 512, 128),
     ("attention_prefill_kernel", 8, 64, (8, 4, 4), 225616, 512)),
    ((4, 1, 4096, 28, 4, 128, 512, 0),
     ("attention_decode_long_kernel", 1, 7, (8, 4, 4), 81552, 512)),
    ((4, 1, 4096, 28, 4, 128, 512, 64),
     ("attention_decode_long_kernel", 1, 7, (8, 4, 4), 81552, 512)),
    ((4, 5, 4096, 28, 4, 128, 512, 64),
     ("attention_long_kernel", 5, 64, (8, 4, 4), 161296, 4096)),
    # the route sweep's S = 2, 16; one tile more than the longest score
    # row that fits at D = 128 (T = 512): the exact body up to T = 2048
    # takes attention_long_kernel; a probs group that straddles tiles
    # (n = 48) stays on attention_kernel; a shorter head dimension fits
    # more keys (D = 64, T = 640)
    ((4, 2, 512, 28, 4, 128, 512, 64),
     ("attention_prefill_kernel", 2, 64, (1, 4, 4), 225616, 512)),
    ((4, 16, 512, 28, 4, 128, 512, 64),
     ("attention_prefill_kernel", 8, 64, (2, 4, 4), 225616, 512)),
    ((4, 64, 576, 28, 4, 128, 576, 64),
     ("attention_long_kernel", 8, 64, (8, 4, 4), 160856, 576)),
    ((4, 64, 640, 28, 4, 64, 640, 64),
     ("attention_prefill_kernel", 8, 64, (8, 4, 4), 218976, 640)),
    ((4, 64, 2048, 28, 4, 128, 2048, 64),
     ("attention_long_kernel", 8, 64, (32, 4, 4), 161040, 2048)),
    ((1, 64, 480, 28, 4, 128, 480, 48),
     ("attention_kernel", 2, 14, (32, 4, 1), 64768, 480)),
])
def test_plan(shape, want):
    plan = faq.plan_attention(*shape)
    assert tuple(plan)[:6] == want
    B, S, T, H, KV, D, bk, probs_n = shape
    if plan.kernel not in ("attention_long_kernel",
                           "attention_decode_long_kernel"):
        assert (plan.cluster, plan.slots) == (1, 0)
    if plan.kernel == "attention_prefill_kernel":
        assert plan.smem_bytes == faq.prefill_smem_bytes(T, D) <= 232448
        assert plan.positions * (H // KV) <= plan.rows == 64
    elif plan.kernel == "attention_decode_kernel":
        assert plan == faq.plan_attention_decode(B, T, H, KV, D, shape[7])
    elif plan.kernel == "attention_long_kernel":
        assert plan == faq.plan_attention_long(B, S, T, H, KV, D, probs_n)
        assert plan.smem_bytes == faq.long_smem_bytes(T, D) <= 232448
        assert plan.cluster == faq.long_cluster(T)
    elif plan.kernel == "attention_decode_long_kernel":
        assert plan == faq.plan_attention_decode_long(B, T, H, KV, D, bk,
                                                      probs_n)
        assert plan.cluster == plan.grid[0]
    else:
        assert plan.smem_bytes == faq.plan_attention_kernel(
            B, S, H, KV, D, bk).smem_bytes


def test_main_path_routes_pinned():
    """The paged prefill chunk (S = 64, T = 512) takes the prefill kernel
    in one wave (128 blocks on 132 SMs); decode (S = 1) takes the decode
    kernel."""
    chunk = faq.plan_attention(4, 64, 512, 28, 4, 128, 512, 64)
    assert chunk.kernel == "attention_prefill_kernel"
    assert math.prod(chunk.grid) == 128
    assert faq.plan_attention(4, 1, 512, 28, 4, 128, 512, 64).kernel == \
        "attention_decode_kernel"
    assert faq.PREFILL_MIN_S >= 2


def test_cpu_tensors_run_the_plain_version():
    """A CPU call counts no launch of either kernel, through the GQA
    front-end as the model calls it."""
    inp = _inputs(2, 16, 64, 4, 2, 16, [0, 48], seed=9)
    args = _torch_args(inp, False)
    before = (faq.flash_attention_quant.launches,
              dict(faq.flash_attention_quant.launches_by_kernel))
    tq = TTensorQuant("int8", group=64)
    got = tkops.flash_attention_quant_gqa(*args, probs_tq=tq)
    assert got.shape == (2, 16, 4, 16)
    assert (faq.flash_attention_quant.launches,
            faq.flash_attention_quant.launches_by_kernel) == before
