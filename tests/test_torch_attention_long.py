"""``attention_long_kernel``: every ``flash_attention_quant`` call at S > 1
whose score rows outgrow ``attention_prefill_kernel`` (the paged prefill
chunk of a long context: exact, online and phased bodies), emulated on the
CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there and reads from the profiler which kernel each call
launches).  What it computes is pinned here by an emulation of its
arithmetic, fed the same numpy inputs as the port's plain version and, for
the long bodies, the reference package's front-end (Pallas, interpret
mode):

  * a 64-row tile (row = position * G + head) of one KV head walks the
    64-key units some row of it sees (every unit when a position sees no
    key; whole probs groups), dealt out in key order over a cluster of
    ``long_cluster(T)`` blocks as contiguous ranges of whole groups;
  * scores as the plain version forms them: k = code * ks in f32, one
    fmaf chain over d = 0 .. D - 1 from 0 a (row, key), times scale;
    masked -1e9, keys past T out of the row;
  * pass 1: per unit mu = max s and sigma = sum exp(s - mu) (lane l adds
    keys l and l + 32, then a butterfly), folded in key order, m' =
    max(m, mu), l' = l exp(m - m') + sigma exp(mu - m'); the blocks' (m, l)
    merged: m their maximum, l the sum of l_c exp(m_c - m) in block order;
  * pass 2: p = exp(s - m) / l (online: exp(s - m)), the group QDQ, w = p *
    vs, P.V on the tensor cores (w split into three bf16 terms, 16 keys a
    step, f32 accumulators), the blocks' partials added in block order;
    online divides by max(l, 1e-30).

Tolerances are the card's bars (``chip_smoke.check_attention``): 2e-5 of
the largest output without the probs QDQ; with it, 5e-3 and at least 99 %
of the elements within 2e-5.  Skipping units is held bit-equal to walking
them all.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import TensorQuant as JTensorQuant
from repro.kernels import ops as jkops
from repro_torch.core.policy import TensorQuant as TTensorQuant
from repro_torch.kernels import flash_attention_quant as faq
from repro_torch.kernels import ops as tkops
from test_torch_attention_prefill import (NEG_INF, _inputs, _torch_args,
                                          _within_bars, fma, live_tiles, mma,
                                          probs_qdq, split3)

KEYS = faq.PREFILL_KEYS


def butterfly(v: torch.Tensor) -> torch.Tensor:
    """A warp's sum of its 32 lanes (rows, 32): xor 16, 8, 4, 2, 1."""
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v[:, 0]


def fold(m, l, s):
    """Pass 1's step over one unit's scores s (rows, 64): mu = max s, sigma
    = sum exp(s - mu) in the warp's order, folded into (m, l)."""
    mu = s.amax(-1)
    e = torch.exp(s - mu[:, None])
    sg = butterfly(e[:, :32] + e[:, 32:])
    m_new = torch.maximum(m, mu)
    return m_new, l * torch.exp(m - m_new) + sg * torch.exp(mu - m_new)


def emulate(qh, kc, vc, ks, vs, q_pos, kv_pos, window, *, scale,
            causal=True, probs_n=0, probs_qmax=0.0, probs_qmin=0.0,
            block_k=0, skip=True, cluster=None):
    """``attention_long_kernel``'s arithmetic on CPU tensors (the arguments
    of ``flash_attention_quant``); ``cluster`` overrides the blocks a tile
    is split over; ``skip=False`` walks the units no row sees as well."""
    B, S, H, D = qh.shape
    T, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    bk = faq._tiling(S, T, block_k, probs_n)
    online = bk != T and not probs_n
    plan = faq.plan_attention_long(B, S, T, H, KV, D, probs_n)
    C = plan.cluster if cluster is None else cluster
    n_units = -(-T // KEYS)
    span = probs_n // KEYS if probs_n > KEYS else 1
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
                units = live_tiles(vis, vis.reshape(n_pos, G, T)[:, 0]
                                   .any(-1), n_units, probs_n, True)
                groups = len(units) // span
                ranges = [units[(c * groups // C) * span:
                                ((c + 1) * groups // C) * span]
                          for c in range(C)]
                if not skip:
                    # walk the unseen units too, each in the block of the
                    # next seen one (leading ones in the first block,
                    # trailing ones in the last), so that every seen unit
                    # stays in the block the kernel deals it to
                    firsts = [r[0] for r in ranges if r]
                    bounds = iter(zip([0] + firsts[1:], firsts[1:] + [n_units]))
                    ranges = [list(range(*next(bounds))) if r else []
                              for r in ranges]

                def scores(u):
                    keys = torch.arange(u * KEYS, (u + 1) * KEYS)
                    real = keys < T
                    kk = torch.where(real, keys, 0)
                    seen = vis[:, kk] & real
                    acc = torch.zeros(q.shape[0], KEYS)
                    if bool(seen.any()):  # a unit no row sees: no products
                        k = kcf[b, kk, kvh] * ks[b, kk, kvh][:, None]
                        for d in range(D):
                            acc = fma(q[:, d, None], k[None, :, d], acc)
                    s = torch.where(seen, acc * scale, NEG_INF)
                    return torch.where(real, s, -math.inf), kk, real

                if not bool(vis.any()):  # a dead tile: the uniform mean
                    out[b, s0:s0 + n_pos, kvh * G:(kvh + 1) * G] = dead_mean(
                        vcf[b, :, kvh], vs[b, :, kvh], ranges, T, online,
                        probs_n, probs_qmax, probs_qmin)
                    continue

                # pass 1: each block folds its units in key order
                stats = []
                for rng in ranges:
                    m = torch.full((q.shape[0],), faq.M_INIT)
                    l = torch.zeros(q.shape[0])
                    for u in rng:
                        m, l = fold(m, l, scores(u)[0])
                    stats.append((m, l))
                m = torch.stack([mc for mc, _ in stats]).amax(0)
                l = torch.zeros_like(m)
                for mc, lc in stats:  # block order
                    l = l + lc * torch.exp(mc - m)

                # pass 2: probabilities, the group QDQ, P.V; partials added
                # in block order
                o = torch.zeros(q.shape[0], D)
                for rng in ranges:
                    o_hi = o_lo = torch.zeros(q.shape[0], D)
                    for g0 in range(0, len(rng), span):
                        parts = [scores(u) for u in rng[g0:g0 + span]]
                        e = torch.exp(torch.cat([s for s, _, _ in parts], 1)
                                      - m[:, None])
                        p = e if online else e / l[:, None]
                        if probs_n:
                            p = probs_qdq(p, probs_n, probs_qmax, probs_qmin)
                        kk = torch.cat([k for _, k, _ in parts])
                        real = torch.cat([r for _, _, r in parts])
                        w = p * vs[b, kk, kvh] * real
                        vt = vcf[b, kk, kvh] * real[:, None]
                        w_hi, w_mid, w_lo = split3(w)
                        for t in range(0, len(kk), 16):
                            o_hi = mma(o_hi, w_hi[:, t:t + 16], vt[t:t + 16])
                            o_lo = mma(o_lo, w_mid[:, t:t + 16], vt[t:t + 16])
                            o_lo = mma(o_lo, w_lo[:, t:t + 16], vt[t:t + 16])
                    o = o + (o_hi + o_lo)
                if online:
                    o = o / torch.clamp_min(l, 1e-30)[:, None]
                out[b, s0:s0 + n_pos, kvh * G:(kvh + 1) * G] = o.reshape(
                    n_pos, G, D)
    return out


def dead_mean(vcf, vs, ranges, T, online, probs_n, qmax, qmin):
    """A tile where no position sees a key: every key's probability is w =
    1 / T (online: 1, divided by T at the end), QDQ'd; block c adds (w
    vs_t) code_t to column d over its units, key h, h + nh, ... of each in
    thread (h, d) (nh = 256 // D), then the nh sums in order, then the
    blocks' sums in block order."""
    D = vcf.shape[1]
    w = torch.tensor([1.0 if online else 1.0 / T])
    if probs_n:
        w = probs_qdq(w[None], 1, qmax, qmin)[0]
    nh = 256 // D
    o = torch.zeros(D)
    for rng in ranges:
        acc = torch.zeros(nh, D)
        for u in rng:
            for key in range(KEYS):
                t = u * KEYS + key
                if t < T:
                    h = key % nh
                    acc[h] = fma((w * vs[t]).expand(D), vcf[t], acc[h])
        part = torch.zeros(D)
        for h in range(nh):
            part = part + acc[h]
        o = o + part
    if online:
        o = o / T
    return o


def _kw(probs_n, block_k, causal=True, scale=None, D=16):
    return dict(scale=D ** -0.5 if scale is None else scale, causal=causal,
                probs_n=probs_n, probs_qmax=127.0 if probs_n else 0.0,
                probs_qmin=-127.0 if probs_n else 0.0, block_k=block_k)


# --------------------------------------------------------------------------
# the emulation against the plain version
# --------------------------------------------------------------------------
# (T, block_k, probs_n, fp8, causal, window, S, starts): B = 4, H = 4,
# KV = 2 (G = 2), D = 16; bk < T is a long body (phased with the probs
# QDQ, else online), bk = T the exact body
CASES = {
    # the main path's phased call, cut down: 8 blocks a tile, rows at the
    # end of the context, in its middle, near its start, and dead
    "phased-n64-C8": (4096, 512, 64, False, True, None, 16,
                      [4080, 2500, 300, -1]),
    "phased-starts-early": (4096, 512, 64, False, True, None, 16,
                            [2000, 700, 37, -1]),
    "online": (4096, 512, 0, False, True, None, 16, [4080, 2500, 300, -1]),
    "exact-C2": (1024, 0, 64, False, True, None, 16, [1008, 600, 37, -1]),
    "exact-no-qdq-C4": (2048, 0, 0, False, True, None, 16,
                        [2032, 600, 37, -1]),
    "phased-fp8": (2048, 512, 64, True, True, None, 16, [2032, 900, 37, -1]),
    "phased-window": (2048, 512, 64, False, True, 100, 16,
                      [2032, 900, 37, -1]),
    "phased-n32": (2048, 512, 32, False, True, None, 16, [2032, 900, 37, -1]),
    "phased-n128": (2048, 512, 128, False, True, None, 16,
                    [2032, 900, 37, -1]),
    "ragged-S37": (1024, 0, 64, False, True, None, 37, [987, 400, 0, -1]),
    "noncausal": (1024, 512, 0, False, False, None, 16, [1008, 600, 37, -1]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_against_plain(case):
    T, bk, probs_n, fp8, causal, window, S, starts = CASES[case]
    B, H, KV, D = 4, 4, 2, 16
    inp = _inputs(B, S, T, H, KV, D, starts, fp8=fp8, seed=11)
    args = _torch_args(inp, fp8)
    kw = _kw(probs_n, bk, causal)
    win = (T + S + 1) if window is None else window
    assert faq.plan_attention(B, S, T, H, KV, D, bk or T, probs_n).kernel \
        == "attention_long_kernel"
    got = emulate(*args, win, **kw)
    plain = faq.flash_attention_quant_plain(*args, win, **kw)
    _within_bars(got, plain, bool(probs_n))
    # the dead row is the uniform mean over all T keys, as the plain version
    _within_bars(got[3], plain[3], bool(probs_n))


@pytest.mark.parametrize("probs_n,block_k", [(0, 512), (64, 512), (128, 0),
                                             (32, 0)])
def test_skipping_units_is_bit_exact(probs_n, block_k):
    """Units no row of a tile sees add exactly +0 to (m, l) once a seen unit
    has set m (exp(-1e9 - m) is 0) and, before one, are wiped out by it;
    their probabilities are exact zeros: skipping them leaves every output
    bit as it is.  The dead row's tile walks every unit either way."""
    B, S, T, H, KV, D = 4, 8, 2048, 4, 2, 16
    inp = _inputs(B, S, T, H, KV, D, [40, 1500, 700, -1], seed=7)
    args = _torch_args(inp, False)
    kw = _kw(probs_n, block_k)
    skipped = emulate(*args, 1 << 20, **kw, skip=True)
    walked = emulate(*args, 1 << 20, **kw, skip=False)
    assert torch.equal(skipped, walked)


@pytest.mark.parametrize("probs_n", [0, 64])
def test_leading_masked_units(probs_n):
    """A window leaves every row's first units (a whole bk tile and more)
    masked: the plain version's recurrence sets m = -1e9 on that tile and
    the first seen one wipes it out; the kernel skips those units, and
    walking them instead gives the same bits."""
    B, S, T, H, KV, D = 2, 8, 2048, 4, 2, 16
    inp = _inputs(B, S, T, H, KV, D, [1900, 1300], seed=13)
    args = _torch_args(inp, False)
    kw = _kw(probs_n, 512)
    window = 200  # row 0 sees keys 1701-1907, row 1 1101-1307
    plain = faq.flash_attention_quant_plain(*args, window, **kw)
    got = emulate(*args, window, **kw)
    _within_bars(got, plain, bool(probs_n))
    assert torch.equal(got, emulate(*args, window, **kw, skip=False))


@pytest.mark.parametrize("T", [8192, 1000])
def test_dead_tile_statistics_are_exact(T):
    """A tile where no position sees a key skips pass 1: its (m, l) are set
    to -1e9 and the count of its keys.  Walking its units gives those bits:
    exp(0) = 1 per key, sums of integers below 2^24, and the merge over the
    cluster's blocks adds them to exactly T."""
    n_units = -(-T // KEYS)
    C = faq.long_cluster(T)
    merged = []
    for c in range(C):
        rng = range(c * n_units // C, (c + 1) * n_units // C)
        m = torch.full((4,), faq.M_INIT)
        l = torch.zeros(4)
        for u in rng:
            keys = torch.arange(u * KEYS, (u + 1) * KEYS)
            s = torch.where(keys < T, NEG_INF, -math.inf).expand(4, KEYS)
            m, l = fold(m, l, s)
        count = sum(min(KEYS, T - u * KEYS) for u in rng)
        assert torch.equal(m, torch.full((4,), NEG_INF)) and torch.equal(
            l, torch.full((4,), float(count)))
        merged.append((m, l))
    m = torch.stack([mc for mc, _ in merged]).amax(0)
    l = sum(lc * torch.exp(mc - m) for mc, lc in merged)
    assert torch.equal(l, torch.full((4,), float(T)))


def test_split_over_the_cluster_is_within_the_bars():
    """One block a tile, two, or eight: the same statistics up to rounding
    (maxima are exact, sums in another grouping)."""
    B, S, T, H, KV, D = 2, 8, 4096, 4, 2, 16
    inp = _inputs(B, S, T, H, KV, D, [4000, 2100], seed=17)
    args = _torch_args(inp, False)
    kw = _kw(64, 512)
    plain = faq.flash_attention_quant_plain(*args, 1 << 20, **kw)
    for C in (1, 2, 8):
        _within_bars(emulate(*args, 1 << 20, **kw, cluster=C), plain, True)


# --------------------------------------------------------------------------
# the plain long bodies against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("probs_n", [0, 64])
def test_plain_long_bodies_match_reference(probs_n):
    """Through both front-ends at T past ``single_block_max`` (the online
    body, or the phased one with the probs QDQ): the reference's Pallas
    kernel in interpret mode against the port's plain version, on cache
    rows like the paged path's (a dead row, rows part-way through)."""
    B, S, T, H, KV, D = 4, 8, 256, 4, 2, 16
    inp = _inputs(B, S, T, H, KV, D, [240, 130, 37, -1], seed=19)
    args = _torch_args(inp, False)
    tq = TTensorQuant("int8", group=probs_n) if probs_n else None
    before = faq.flash_attention_quant.launches
    got = tkops.flash_attention_quant_gqa(*args, probs_tq=tq, block_k=64,
                                          single_block_max=64)
    assert faq.flash_attention_quant.launches == before  # CPU: plain
    qh, kc, vc, ks, vs, q_pos, kv_pos = inp
    want = np.asarray(jkops.flash_attention_quant_gqa(
        jnp.asarray(qh), jnp.asarray(kc, jnp.int8),
        jnp.asarray(vc, jnp.int8), jnp.asarray(ks), jnp.asarray(vs),
        jnp.asarray(q_pos), jnp.asarray(kv_pos),
        probs_tq=JTensorQuant("int8", group=probs_n) if probs_n else None,
        block_k=64, single_block_max=64, interpret=True))
    if probs_n:  # the reference's boundary-tolerant bar for phased
        diff = np.abs(got.numpy() - want)
        assert diff.max() < 5e-3 * np.abs(want).max(), diff.max()
        assert (diff <= 1e-5 * np.abs(want).max()).mean() > 0.9
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # and the kernel's arithmetic against the same plain call
    kw = _kw(probs_n, 64)
    _within_bars(emulate(*args, T + S + 1, **kw),
                 faq.flash_attention_quant_plain(*args, T + S + 1, **kw),
                 bool(probs_n))


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------
# (S, T, bk, probs_n) at B = 4, 28 / 4 heads, D = 128 -> kernel: the
# paged path's calls at max_len 512 and 8192, and the bodies between
@pytest.mark.parametrize("shape,kernel", [
    ((64, 512, 512, 64), "attention_prefill_kernel"),    # serve's chunk
    ((64, 1024, 1024, 64), "attention_long_kernel"),     # exact, past smem
    ((64, 2048, 2048, 64), "attention_long_kernel"),
    ((64, 8192, 512, 64), "attention_long_kernel"),      # phased, main path
    ((64, 4096, 512, 0), "attention_long_kernel"),       # online
    ((5, 4096, 512, 64), "attention_long_kernel"),
    ((2, 8192, 512, 64), "attention_long_kernel"),
    ((37, 1024, 1024, 64), "attention_long_kernel"),
    ((64, 1024, 1024, 32), "attention_long_kernel"),
    ((64, 1024, 1024, 128), "attention_long_kernel"),
    ((64, 960, 960, 48), "attention_kernel"),  # groups off the 64-key units
    ((1, 512, 512, 64), "attention_decode_kernel"),      # decode
    ((1, 2048, 2048, 64), "attention_decode_kernel"),
    # decode past single_block_max
    ((1, 8192, 512, 64), "attention_decode_long_kernel"),
    ((1, 4096, 512, 0), "attention_decode_long_kernel"),
])
def test_routes(shape, kernel):
    S, T, bk, probs_n = shape
    assert faq.plan_attention(4, S, T, 28, 4, 128, bk, probs_n).kernel == \
        kernel


def test_main_path_long_plan():
    """The paged chunk at max_len 8192 (S = 64, phased, bk = 512): 8
    positions x 7 heads a tile, each tile over a cluster of 8 blocks, 1,024
    blocks of 161,808 bytes of shared memory (one a SM), each storing at
    most 16 score tiles of 16 KB; at T = 1024 and 2048 clusters of 2 and
    4."""
    plan = faq.plan_attention(4, 64, 8192, 28, 4, 128, 512, 64)
    assert plan == faq.AttentionPlan("attention_long_kernel", 8, 64,
                                     (64, 4, 4), 161808, 8192, 8, 16)
    assert faq.long_slots(8192, 64, 8) == 16
    # 256 MiB of stored scores a call; none when pass 2 forms them again
    assert faq.long_scratch_bytes(plan) == 1024 * 16 * 64 * 64 * 4
    again = faq.plan_attention_long(4, 64, 8192, 28, 4, 128, 64, store=False)
    assert again == plan._replace(slots=0)
    assert faq.long_scratch_bytes(again) == 0
    # a block's share of the units, whole groups of 2 at n = 128; the
    # largest share when the units do not split evenly (9 over 1 block)
    assert [faq.long_slots(T, n, faq.long_cluster(T))
            for T, n in ((8192, 128), (1024, 64), (576, 0), (2048, 256))] \
        == [16, 8, 9, 8]
    assert plan.smem_bytes == faq.long_smem_bytes(8192, 128) <= 232448
    assert [faq.long_cluster(T) for T in (576, 1024, 2048, 4096, 8192,
                                          32768)] == [1, 2, 4, 8, 8, 8]
    # the smallest exact call past the prefill kernel's score rows
    assert faq.prefill_smem_bytes(576, 128) > 232448
    assert faq.plan_attention(4, 64, 576, 28, 4, 128, 576, 64).grid == \
        (8, 4, 4)


@pytest.mark.parametrize("B,T,slots", [
    (4, 8192, 16),    # the paged chunk at max_len 8192: 256 MiB, stored
    (4, 1024, 8),     # 32 MiB
    (4, 16384, 0),    # 1 GiB past the cap: pass 2 forms the scores again
    (8, 8192, 0),     # more slots, the same
])
def test_scores_are_stored_within_the_cap(B, T, slots):
    """Pass 1 stores the scores where they take at most
    ``LONG_SCRATCH_MAX`` bytes; past it the plan has no slots and the call
    allocates nothing.  Either way the kernel gives the same bits (the
    emulation has one arithmetic; the card holds the two against each
    other in ``chip_smoke.check_attention``)."""
    plan = faq.plan_attention(B, 64, T, 28, 4, 128, 512, 64)
    assert plan.kernel == "attention_long_kernel" and plan.slots == slots
    stored = faq.plan_attention_long(B, 64, T, 28, 4, 128, 64, store=True)
    assert stored.slots == faq.long_slots(T, 64, plan.cluster) > 0
    assert (faq.long_scratch_bytes(stored) <= faq.LONG_SCRATCH_MAX) == \
        bool(slots)
    assert faq.long_scratch_bytes(plan) == (
        faq.long_scratch_bytes(stored) if slots else 0)


def test_forced_plan_is_checked():
    """A CUDA call is refused before any launch when a forced long plan
    does not match its cluster split (the check runs on shapes alone: a
    meta tensor stands in for the card's)."""
    B, S, T, H, KV, D = 4, 64, 4096, 28, 4, 128
    plan = faq.plan_attention_long(B, S, T, H, KV, D, 64)._replace(
        grid=(8, 4, 4))
    with pytest.raises(ValueError, match="long_cluster"):
        faq._flash_attention_quant(
            *_meta_args(B, S, T, H, KV, D), 1 << 20, plan=plan,
            scale=0.1, causal=True, probs_n=64, probs_qmax=127.0,
            probs_qmin=-127.0, block_k=512)


def _meta_args(B, S, T, H, KV, D):
    m = dict(device="meta")
    return (torch.empty(B, S, H, D, **m),
            torch.empty(B, T, KV, D, dtype=torch.int8, **m),
            torch.empty(B, T, KV, D, dtype=torch.int8, **m),
            torch.empty(B, T, KV, **m), torch.empty(B, T, KV, **m),
            torch.empty(B, S, dtype=torch.int32, **m),
            torch.empty(B, T, dtype=torch.int32, **m))


def test_cpu_tensors_run_the_plain_version():
    """A CPU call at a long T counts no launch of any kernel, through the
    GQA front-end as the model calls it (phased: T past the front end's
    single_block_max)."""
    inp = _inputs(2, 16, 2112, 4, 2, 16, [2000, 600], seed=9)
    args = _torch_args(inp, False)
    assert "attention_long_kernel" in \
        faq.flash_attention_quant.launches_by_kernel
    before = (faq.flash_attention_quant.launches,
              dict(faq.flash_attention_quant.launches_by_kernel))
    got = tkops.flash_attention_quant_gqa(
        *args, probs_tq=TTensorQuant("int8", group=64))
    assert got.shape == (2, 16, 4, 16)
    assert (faq.flash_attention_quant.launches,
            faq.flash_attention_quant.launches_by_kernel) == before


# --------------------------------------------------------------------------
# the slice: a paged engine whose max_len takes the long bodies
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def reduced_engine_parts():
    """Reduced qwen2-7b (2 layers, d_model 64) on the CPU, its weights
    carried across from the reference by the bridge, and the slice's
    policy (groups of 16 divide the reduced widths); the reference's model,
    weights and policy beside them."""
    import jax

    from repro.configs import get_config as j_get_config
    from repro.core import policy as jp
    from repro.models import build_model as j_build_model
    from repro.nn.module import unbox
    from repro_torch import bridge
    from repro_torch.configs import get_config as t_get_config
    from repro_torch.core import policy as tp
    from repro_torch.models import build_model as t_build_model

    jcfg = j_get_config("qwen2-7b").reduced()
    jmodel = j_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    jpol = jp.map_policies(jp.preset("w4a8_abfp", n=16),
                           lambda p: p.replace(fused=True))
    tcfg = t_get_config("qwen2-7b").reduced()
    assert (tcfg.n_layers, tcfg.d_model) == (2, 64)
    model = t_build_model(tcfg, device="cpu")
    params = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                      device="cpu")
    pol = tp.map_policies(tp.preset("w4a8_abfp", n=16),
                          lambda p: p.replace(fused=True))
    return (tcfg, model, params, tp.with_attn_backend(pol, "compressed"),
            (jmodel, jparams, jp.with_attn_backend(jpol, "compressed")))


def test_long_max_len_serves_the_exact_bodys_tokens(reduced_engine_parts,
                                                    monkeypatch):
    """``max_len`` 2112 makes every attention call T = 2112, past the front
    end's ``single_block_max``: prefill chunks and decode steps take the
    phased body (the probs QDQ is on), which ``attention_long_kernel`` and
    ``attention_decode_long_kernel`` run on the card.  With contexts far
    shorter than either max_len, the engine serves the tokens of the same
    engine at max_len 256, whose calls take the exact body, and of the
    reference's engine at max_len 2112 (its Pallas kernel in interpret
    mode).

    The port's legs run on one intra-op thread: the plain attention at T =
    2112 is a chain of large elementwise ops, whose thread barriers stall
    when the suite's workers share the cores (measured on 8 cores with
    five busy processes beside it: 309 s on 8 threads, 3.4 s alone on
    one).  The thread count changes no result the test compares."""
    from repro.serve import engine as jeng
    from repro_torch.serve import engine as teng

    cfg, model, params, pol, (jmodel, jparams, jpol) = reduced_engine_parts
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    lengths = (5, 70, 11, 130, 3)

    def serve(mod, max_len, model=model, params=params, pol=pol, **kw):
        eng = mod.PagedServeEngine(model, params, n_slots=3,
                                   max_len=max_len, policy=pol,
                                   page_size=16, kv="int8", compress=True,
                                   **kw)
        rng = np.random.RandomState(23)
        for i, n in enumerate(lengths):
            eng.submit(mod.Request(
                uid=i, prompt=rng.randint(0, cfg.vocab, size=n).astype(
                    np.int32), max_new_tokens=4))
        return {c.uid: c.tokens for c in eng.run_until_done()}

    keys = []
    front = tkops.flash_attention_quant_gqa

    def spy(qh, k_codes, *a, **kw):
        keys.append(k_codes.shape[1])
        return front(qh, k_codes, *a, **kw)

    try:
        monkeypatch.setattr(tkops, "flash_attention_quant_gqa", spy)
        long_tokens = serve(teng, 2112, device="cpu")
        assert keys and set(keys) == {2112}  # every call past 2048 keys
        monkeypatch.undo()
        assert long_tokens == serve(teng, 256, device="cpu")
    finally:
        torch.set_num_threads(threads)
    assert all(len(t) == 4 for t in long_tokens.values())
    assert long_tokens == serve(jeng, 2112, model=jmodel, params=jparams,
                                pol=jpol)
