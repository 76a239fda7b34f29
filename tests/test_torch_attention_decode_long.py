"""``attention_decode_long_kernel``: every ``flash_attention_quant`` call at
S = 1 past ``attention_decode_kernel``'s shared memory (the decode step of
a long context: exact, online and phased bodies), emulated on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there and reads from the profiler which kernel each call
launches).  What it computes is pinned here by an emulation of its
arithmetic, fed the same numpy inputs as the reference package's
front-end (Pallas, interpret mode) and the port's plain version:

  * one cluster of C blocks a (batch, KV head), all G query heads of the
    KV head in each block; the units (64 keys, or lcm(64, n): whole probs
    groups) with a key the row sees are dealt out in key order as
    contiguous ranges; a block walks the seen 64-key tiles of its range,
    a dead row (no key seen) every tile;
  * scores as the plain version forms them: k = code * ks in f32, one
    fmaf chain over d = 0 .. D - 1 from 0 a (row, key), times scale;
    masked -1e9, keys past T out of the row; the range's scores stay
    resident between the passes;
  * m and l the reference's recurrence over its KV tiles of bk keys, in
    tile order: M_j the maximum of M_{j-1} (from M_INIT) and the blocks'
    parts of tile j (exact); l_j = l_{j-1} * exp(M_{j-1} - M_j) + S_j in
    f32, S_j the f64 sum of exp(s - M_j) over tile j rounded once: a
    block's part as its warp forms it (lane l adds keys l, l + 32, ... of
    each 64-key tile in order, then a butterfly), the part of the block
    whose later tiles it is first, then the first tiles of the blocks
    starting in it, in block order;
  * p = exp(s - m) / l (online: exp(s - m)) over the resident row, the
    group QDQ over it;
    P.V on the tensor cores: w = p * vs split into three bf16 terms, a
    16-key MMA step adding the exact sum of 16 products (bf16 times a
    code) to an f32 accumulator, rounding once (hi terms in one
    accumulator, mid then lo in another), over each walked tile in order;
    the blocks' partials added in block order; online divides by max(l,
    1e-30);
  * a dead row: l = T (every tile sums bk exp(0) = 1), every p = 1 / T
    (online 1) after the QDQ, one column sum of V for all G rows (no K
    loaded).

Tolerances are the card's bars (``chip_smoke.check_attention``): 2e-5 of
the largest output without the probs QDQ; with it, 5e-3 and at least 99 %
of the elements within 2e-5.  Skipping unseen units is held bit-equal to
walking them all.
"""

import math
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import TensorQuant as JTensorQuant
from repro.kernels import ops as jkops
from repro_torch.core.policy import TensorQuant as TTensorQuant
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention_quant as faq
from repro_torch.kernels import ops as tkops
from test_torch_attention_decode import (_inputs, _torch_args, _within_bars,
                                         fma, probs_qdq, visible)
from test_torch_attention_prefill import mma, split3

NEG_INF = -1e9
KEYS = faq.DECODE_TILE


def lane_sum_f64(e: torch.Tensor) -> torch.Tensor:
    """A warp's f64 sum of each row of e (rows, a multiple of 32 keys):
    lane l adds keys l, l + 32, ... in order, then a butterfly."""
    v = torch.zeros(e.shape[0], 32, dtype=torch.float64)
    for chunk in e.double().reshape(e.shape[0], -1, 32).unbind(1):
        v = v + chunk
    lanes = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, lanes ^ o]
    return v[:, 0]


def recurrence(blocks, T, bk, G):
    """m and l of the G rows from the blocks' (tiles, _, scores): each bk
    tile's maximum over the blocks' parts (-1e9 where no block holds a
    key of it), the prefix maxima M_j from M_INIT, each tile's sum of
    exp(s - M_j) as the kernel adds it (``attention_decode_long_kernel``'s
    stats), then l_j = l_{j-1} * exp(M_{j-1} - M_j) + S_j in f32."""
    nb = T // bk
    parts = []  # per block: its first tile, and the bk tile of each column
    for tiles, _, s in blocks:
        if not tiles:
            parts.append((-1, None))
            continue
        key = (torch.tensor(tiles)[:, None] * KEYS
               + torch.arange(KEYS)).reshape(-1)
        parts.append((tiles[0] * KEYS // bk,
                      torch.where(key < T, key // bk, -1)))
    tmax = torch.full((nb, G), NEG_INF)
    for (_, col), (_, _, s) in zip(parts, blocks):
        for j in range(nb) if col is not None else ():
            if bool((col == j).any()):
                tmax[j] = torch.maximum(tmax[j], s[:, col == j].amax(-1))
    M = torch.empty(nb, G)
    m = torch.full((G,), faq.M_INIT)
    for j in range(nb):
        m = torch.maximum(m, tmax[j])
        M[j] = m
    m, l = torch.full((G,), faq.M_INIT), torch.zeros(G)
    for j in range(nb):
        # the slot's part (the one block holding tile j past its first
        # tile), then the first tiles of the blocks starting in it
        slot = torch.zeros(G, dtype=torch.float64)
        heads = []
        for (fc, col), (_, _, s) in zip(parts, blocks):
            if col is None or not bool((col == j).any()):
                continue
            e = torch.where(col == j, torch.exp(s - M[j][:, None]), 0.0)
            if fc == j:
                heads.append(lane_sum_f64(e))
            else:
                slot = lane_sum_f64(e)
        for h in heads:
            slot = slot + h
        l = l * torch.exp(m - M[j]) + slot.to(torch.float32)
        m = M[j]
    return m, l


def _ranges(vis, T, probs_n, C, skip):
    """The units each of the C blocks is dealt (in key order), the tiles
    the row sees, and whether the row is dead."""
    span = faq.decode_unit(probs_n) // KEYS
    n_tiles = -(-T // KEYS)
    n_units = -(-n_tiles // span)
    seen = torch.nn.functional.pad(vis, (0, n_tiles * KEYS - T)).reshape(
        n_tiles, KEYS).any(-1)
    dead = not bool(vis.any())
    live = [u for u in range(n_units)
            if dead or bool(seen[u * span:(u + 1) * span].any())]
    ranges = [live[c * len(live) // C:(c + 1) * len(live) // C]
              for c in range(C)]
    if not skip and not dead:
        # walk the unseen units too, each in the block of the next seen
        # one (leading ones in the first block, trailing ones in the
        # last), so that every seen unit stays in the block it is dealt to
        firsts = [r[0] for r in ranges if r]
        bounds = iter(zip([0] + firsts[1:], firsts[1:] + [n_units]))
        ranges = [list(range(*next(bounds))) if r else [] for r in ranges]
    return ranges, seen, dead


def emulate(qh, kc, vc, ks, vs, q_pos, kv_pos, window, *, scale,
            causal=True, probs_n=0, probs_qmax=0.0, probs_qmin=0.0,
            block_k=0, skip=True, cluster=None):
    """``attention_decode_long_kernel``'s arithmetic on CPU tensors (the
    arguments of ``flash_attention_quant``, S = 1); ``cluster`` overrides
    the blocks a (batch, KV head) is split over; ``skip=False`` walks the
    units and tiles the row does not see as well."""
    B, S, H, D = qh.shape
    assert S == 1
    T, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    bk = faq._tiling(S, T, block_k, probs_n)
    online = bk != T and not probs_n
    plan = faq.plan_attention_decode_long(B, T, H, KV, D, bk, probs_n)
    C = plan.cluster if cluster is None else cluster
    span = faq.decode_unit(probs_n) // KEYS
    n_tiles = -(-T // KEYS)
    kcf, vcf = kc.to(torch.float32), vc.to(torch.float32)
    vis_all = visible(q_pos, kv_pos, window, causal)
    out = torch.zeros(B, 1, H, D)
    for b in range(B):
        vis = vis_all[b]
        ranges, seen, dead = _ranges(vis, T, probs_n, C, skip)
        for kvh in range(KV):
            q = qh[b, 0, kvh * G:(kvh + 1) * G]
            k = kcf[b, :, kvh] * ks[b, :, kvh][:, None]
            blocks = []
            for rng in ranges:
                # my tiles in the order they sit in the score rows
                tiles = [u * span + i for u in rng for i in range(span)]
                walked = [ti for ti, g in enumerate(tiles) if g < n_tiles
                          and (dead or not skip or bool(seen[g]))]
                s = None
                if not dead:
                    t = torch.tensor([g * KEYS + j for g in tiles
                                      for j in range(KEYS)], dtype=torch.long)
                    real = t < T
                    tt = torch.where(real, t, 0)
                    acc = torch.zeros(G, len(t))
                    if len(t):
                        for d in range(D):
                            acc = fma(q[:, d, None], k[tt, d][None], acc)
                    s = torch.where(vis[tt] & real, acc * scale, NEG_INF)
                    s = torch.where(real, s, -math.inf)
                blocks.append((tiles, walked, s))
            # m and l: the recurrence over the bk tiles (a dead row's l
            # is T)
            if dead:
                l = torch.full((G,), float(T))
                w = torch.tensor([[1.0]]) if online else 1.0 / l[:1, None]
                if probs_n:
                    w = probs_qdq(w, 1, probs_qmax, probs_qmin)
            else:
                m, l = recurrence(blocks, T, bk, G)
            o = torch.zeros(G, D)
            for tiles, walked, s in blocks:
                if not dead:
                    p = torch.exp(s - m[:, None])
                    p = p if online else p / l[:, None]
                    if probs_n and p.shape[1]:
                        p = probs_qdq(p, probs_n, probs_qmax, probs_qmin)
                if dead:
                    o = o + dead_column_sum(vcf[b, :, kvh], vs[b, :, kvh],
                                            w[0, 0], tiles, walked, T)
                    continue
                o_hi = o_lo = torch.zeros(G, D)
                for ti in walked:
                    t = tiles[ti] * KEYS + torch.arange(KEYS)
                    real = t < T
                    tt = torch.where(real, t, 0)
                    pt = p[:, ti * KEYS:(ti + 1) * KEYS]
                    wt = pt * torch.where(real, vs[b, tt, kvh], 0.0)
                    vt = vcf[b, tt, kvh] * real[:, None]
                    w_hi, w_mid, w_lo = split3(wt)
                    for k0 in range(0, KEYS, 16):
                        sl = slice(k0, k0 + 16)
                        o_hi = mma(o_hi, w_hi[:, sl], vt[sl])
                        o_lo = mma(o_lo, w_mid[:, sl], vt[sl])
                        o_lo = mma(o_lo, w_lo[:, sl], vt[sl])
                o = o + (o_hi + o_lo)  # block order
            if online:
                o = o / torch.clamp_min(l, 1e-30)[:, None]
            out[b, 0, kvh * G:(kvh + 1) * G] = o
    return out


def dead_column_sum(vcf, vs, w, tiles, walked, T):
    """A dead row's block: thread (h, d) adds fmaf(w * vs_t, code_t, acc)
    over keys h, h + nh, ... of each walked tile to column d (nh = 256 //
    D), then the nh partial sums in order; the same for every row."""
    D = vcf.shape[1]
    nh = 256 // D
    acc = torch.zeros(nh, D)
    for ti in walked:
        t0 = tiles[ti] * KEYS
        for k0 in range(0, KEYS, nh):
            t = t0 + k0 + torch.arange(nh)
            ok = (t < T) & (k0 + torch.arange(nh) < KEYS)
            tt = torch.clamp(t, max=T - 1)
            new = fma((w * vs[tt])[:, None], vcf[tt], acc)
            acc = torch.where(ok[:, None], new, acc)
    part = torch.zeros(D)
    for h in range(nh):
        part = part + acc[h]
    return part


def _kw(probs_n, block_k, D, causal=True):
    return dict(scale=D ** -0.5, causal=causal, probs_n=probs_n,
                probs_qmax=127.0 if probs_n else 0.0,
                probs_qmin=-127.0 if probs_n else 0.0, block_k=block_k)


def _reference(inp, fp8, *, window, causal, probs_n, block_k, T):
    """The reference package's front-end (Pallas kernel, interpret mode)
    on the same call: block_k = T the exact body (single_block_max = T),
    else the online / phased body over tiles of block_k."""
    qh, kc, vc, ks, vs, q_pos, kv_pos = inp
    ct = jnp.float8_e4m3fn if fp8 else jnp.int8
    tq = JTensorQuant("int8", group=probs_n) if probs_n else None
    exact = block_k in (0, T)
    return np.asarray(jkops.flash_attention_quant_gqa(
        jnp.asarray(qh), jnp.asarray(kc, ct), jnp.asarray(vc, ct),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(q_pos),
        jnp.asarray(kv_pos),
        window=None if window is None else jnp.asarray(window, jnp.int32),
        causal=causal, probs_tq=tq, block_k=T if exact else block_k,
        single_block_max=T if exact else block_k, interpret=True))


# --------------------------------------------------------------------------
# the emulation against the reference and the plain version
# --------------------------------------------------------------------------
# (T, block_k, probs_n, fp8, causal, window, D, starts): B = 4 rows (the
# end of the context, its middle, its start, a dead row), H = 14, KV = 2
# (G = 7, as Qwen2-7B); block_k < T a long body (phased with the probs
# QDQ, else online), block_k = 0 the exact body.  T = 4 x block_k.
CASES = {
    "phased-n64": (512, 128, 64, False, True, None, 16, [500, 300, 37, -1]),
    "phased-n32": (512, 128, 32, False, True, None, 16, [500, 300, 37, -1]),
    "phased-n128": (512, 128, 128, False, True, None, 16,
                    [500, 300, 37, -1]),
    "phased-n48": (576, 192, 48, False, True, None, 16, [570, 300, 37, -1]),
    "online": (512, 128, 0, False, True, None, 16, [500, 300, 37, -1]),
    "online-D32": (256, 64, 0, False, True, None, 32, [250, 130, 0, -1]),
    "exact-n64": (512, 0, 64, False, True, None, 16, [500, 300, 37, -1]),
    "exact-no-qdq": (512, 0, 0, False, True, None, 32, [500, 300, 37, -1]),
    "phased-fp8": (512, 128, 64, True, True, None, 16, [500, 300, 37, -1]),
    "online-fp8": (512, 128, 0, True, True, None, 16, [500, 300, 37, -1]),
    "phased-window": (512, 128, 64, False, True, 100, 16,
                      [500, 300, 37, -1]),
    "online-window": (512, 128, 0, False, True, 40, 16, [500, 300, 37, -1]),
    "exact-ragged-T": (200, 0, 0, False, True, None, 16, [199, 130, 0, -1]),
    "phased-noncausal": (512, 128, 64, False, False, None, 16,
                         [500, 300, 37, -1]),
    # KV tiles off the 64-key grid: a tile's bounds fall inside a 64-key
    # tile and inside a block's range
    "online-bk96": (384, 96, 0, False, True, None, 16, [380, 200, 37, -1]),
    "phased-n32-bk96": (384, 96, 32, False, True, None, 16,
                        [380, 200, 37, -1]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_against_reference_and_plain(case):
    T, bk, probs_n, fp8, causal, window, D, starts = CASES[case]
    B, H, KV = 4, 14, 2
    inp = _inputs(B, T, H, KV, D, starts, fp8=fp8, seed=3)
    args = _torch_args(inp, fp8)
    kw = _kw(probs_n, bk, D, causal)
    win = (T + 2) if window is None else window
    got = emulate(*args, win, **kw)
    plain = faq.flash_attention_quant_plain(*args, win, **kw)
    _within_bars(got, plain, bool(probs_n))
    ref = _reference(inp, fp8, window=window, causal=causal, probs_n=probs_n,
                     block_k=bk, T=T)
    _within_bars(got, ref, bool(probs_n))
    # the dead row is the uniform mean over all T keys, as both
    _within_bars(got[3], plain[3], bool(probs_n))
    _within_bars(got[3], ref[3], bool(probs_n))


def test_exact_body_past_the_decode_kernel():
    """The exact body at T = 16,384, D = 32 (G = 7): past what
    ``attention_decode_kernel``'s ranges hold, so the route is this
    kernel's (a cluster of 8 blocks of 2,048 keys); rows deep into the
    context, near its start, and dead."""
    B, T, H, KV, D = 2, 16384, 14, 2, 32
    assert faq.plan_attention_decode(B, T, H, KV, D, 64).smem_bytes > \
        faq.SMEM_MAX
    plan = faq.plan_attention(B, 1, T, H, KV, D, T, 64)
    assert (plan.kernel, plan.grid, plan.keys) == (
        "attention_decode_long_kernel", (8, KV, B), 2048)
    inp = _inputs(B, T, H, KV, D, [12000, -1], seed=5)
    args = _torch_args(inp, False)
    kw = _kw(64, 0, D)
    got = emulate(*args, T + 2, **kw)
    _within_bars(got, faq.flash_attention_quant_plain(*args, T + 2, **kw),
                 True)


@pytest.mark.parametrize("probs_n,block_k", [(0, 128), (64, 128), (32, 0),
                                             (128, 128), (48, 192)])
def test_skipping_units_is_bit_exact(probs_n, block_k):
    """A unit or tile no row sees holds exact zeros (exp(-1e9 - m) is 0, a
    zero group QDQs to 0, a zero product adds nothing), and its scores
    (-1e9) are below every seen one, so the maximum stands.  Skipping it
    leaves every output bit as walking it does; the dead row walks every
    unit either way."""
    B, T, H, KV, D = 4, 768, 14, 2, 16
    inp = _inputs(B, T, H, KV, D, [41, 700, 300, -1], seed=7)
    args = _torch_args(inp, False)
    kw = _kw(probs_n, block_k, D)
    for window in (1 << 20, 150):
        vis = visible(args[5], args[6], window, True)
        n_tiles = T // KEYS
        seen = vis.reshape(B, n_tiles, KEYS).any(-1)
        assert int((~seen[:3]).sum()) >= 6  # tiles the live rows skip
        skipped = emulate(*args, window, **kw, skip=True)
        walked = emulate(*args, window, **kw, skip=False)
        assert torch.equal(skipped.view(torch.int32),
                           walked.view(torch.int32))


def test_split_over_the_cluster_is_within_the_bars():
    """One block a (batch, KV head), two, or eight: the same statistics up
    to rounding (maxima are exact, sums in another grouping)."""
    B, T, H, KV, D = 4, 1024, 14, 2, 16
    inp = _inputs(B, T, H, KV, D, [1000, 600, 37, -1], seed=17)
    args = _torch_args(inp, False)
    kw = _kw(64, 256, D)
    plain = faq.flash_attention_quant_plain(*args, 1 << 20, **kw)
    for C in (1, 2, 8):
        _within_bars(emulate(*args, 1 << 20, **kw, cluster=C), plain, True)


def test_dead_row_statistics_and_column_sum():
    """A dead row takes l = T: walking its tiles gives those bits (every
    score -1e9 is each tile's maximum, exp(0) = 1 a key, the tile sums
    exact integers and every factor exp(0) = 1), through the recurrence
    over bk tiles as the plain version runs it; every p is then 1 / T, so
    its output is one column sum of V for all G rows."""
    T, C, bk = 8192, 8, 512
    n_units = T // KEYS
    blocks = []
    for c in range(C):
        rng = list(range(c * n_units // C, (c + 1) * n_units // C))
        blocks.append((rng, rng, torch.full((7, len(rng) * KEYS), NEG_INF)))
    m, l = recurrence(blocks, T, bk, 7)
    assert torch.equal(m, torch.full((7,), NEG_INF))
    assert torch.equal(l, torch.full((7,), float(T)))
    # ... and through the emulation: every head of the dead row alike
    inp = _inputs(2, 512, 14, 2, 16, [-1, 200], seed=21)
    args = _torch_args(inp, False)
    got = emulate(*args, 1 << 20, **_kw(64, 128, 16))
    assert torch.equal(got[0, 0, :7], got[0, 0, :1].expand(7, 16))


@pytest.mark.parametrize("probs_n,block_k", [(0, 0), (16, 0), (16, 32)])
def test_plain_version_scores_are_the_kernels_chain(probs_n, block_k):
    """The plain version forms each score as the kernels do, one fmaf chain
    over d = 0 .. D - 1 from 0 (a library product sums in its own order,
    and at S = 1 on an H100 most scores then differ in the last bit), and
    the phased body's denominator by the reference's recurrence over bk
    tiles in f32, each tile's sum the f32 nearest its exact (f64) value.
    With V the identity (one-hot code rows, unit scales) the output of the
    exact and phased bodies is the probability row itself, held bit-equal
    to that arithmetic."""
    T, D = 64, 128  # (here the CPU's einsum sums 106 of 128 otherwise)
    rng = np.random.RandomState(31)
    qh = torch.from_numpy(rng.randn(1, 1, 2, D).astype(np.float32))
    kc = torch.from_numpy(rng.randint(-127, 128, (1, T, 1, D))).to(
        torch.int8)
    ks = torch.from_numpy((rng.rand(1, T, 1) * 0.05).astype(np.float32))
    vc = torch.eye(T, D, dtype=torch.int8).reshape(1, T, 1, D)
    vs = torch.ones(1, T, 1)
    q_pos = torch.tensor([[50]], dtype=torch.int32)
    kv_pos = torch.arange(T, dtype=torch.int32)[None]
    kw = _kw(probs_n, block_k, D)
    got = faq.flash_attention_quant_plain(qh, kc, vc, ks, vs, q_pos, kv_pos,
                                          T + 2, **kw)[0, 0, :, :T]
    k = kc[0, :, 0].to(torch.float32) * ks[0, :, 0, None]
    acc = torch.zeros(2, T)
    for d in range(D):
        acc = fma(qh[0, 0, :, d, None], k[None, :, d], acc)
    s = torch.where(kv_pos[0] <= 50, acc * kw["scale"], NEG_INF)
    if block_k:  # phased: the recurrence over the two tiles
        m, l = torch.full((2, 1), faq.M_INIT), torch.zeros(2, 1)
        for t0 in range(0, T, block_k):
            st = s[:, t0:t0 + block_k]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            tile = torch.exp(st - m_new).double().sum(-1, keepdim=True)
            l = l * torch.exp(m - m_new) + tile.to(torch.float32)
            m = m_new
        e = torch.exp(s - m)
    else:  # exact
        e = torch.exp(s - s.amax(-1, keepdim=True))
        l = e.sum(-1, keepdim=True)
    p = e / l
    if probs_n:
        p = probs_qdq(p, probs_n, kw["probs_qmax"], kw["probs_qmin"])
    assert torch.equal(got, p)


@pytest.mark.parametrize("seed", [41, 43])
def test_plain_tile_sums_against_the_reference(seed):
    """At a size where the plain version's tile sums (the f32 nearest each
    exact one) and torch's own f32 reductions of the same e give other l
    bits in some rows, the plain version still holds to the reference's
    phased body (Pallas, interpret mode) at the card's bars (int8 codes;
    with fp8 codes at seed 41 it holds 98.3 % within 2e-5, as PR 22's
    plain version did: PERF.md section 7)."""
    B, T, H, KV, D, bk = 4, 2048, 14, 2, 16, 512
    fp8 = False
    inp = _inputs(B, T, H, KV, D, [2040, 1500, 700, -1], fp8=fp8, seed=seed)
    args = _torch_args(inp, fp8)
    qh, kc, _, ks, _, q_pos, kv_pos = args
    kw = _kw(64, bk, D)
    # the plain version's scores, then l both ways over the bk tiles
    k = kc.to(torch.float32) * ks[..., None]
    acc = torch.zeros(B, KV, H // KV, T)
    qg = qh[:, 0].reshape(B, KV, H // KV, D)
    for d in range(D):
        acc = fma(qg[..., d, None], k.permute(0, 2, 1, 3)[:, :, None, :, d],
                  acc)
    vis = visible(q_pos, kv_pos, T + 2, True)[:, None, None]
    s = torch.where(vis, acc * kw["scale"], NEG_INF)
    ls = []
    for pinned in (True, False):
        m = torch.full(s.shape[:-1], faq.M_INIT)
        l = torch.zeros(s.shape[:-1])
        for t0 in range(0, T, bk):
            mn = torch.maximum(m, s[..., t0:t0 + bk].amax(-1))
            e = torch.exp(s[..., t0:t0 + bk] - mn[..., None])
            tile = (e.double().sum(-1).to(torch.float32) if pinned
                    else e.sum(-1))
            l = l * torch.exp(m - mn) + tile
            m = mn
        ls.append(l)
    assert bool((ls[0] != ls[1])[:3].any())
    plain = faq.flash_attention_quant_plain(*args, T + 2, **kw)
    ref = _reference(inp, fp8, window=None, causal=True, probs_n=64,
                     block_k=bk, T=T)
    _within_bars(plain, ref, True)


# --------------------------------------------------------------------------
# the planner and the routes
# --------------------------------------------------------------------------
def test_long_path_decode_plan():
    """The long path's decode call (B = 4 slots, T = 8192, 28 / 4 heads,
    D = 128, phased, bk = 512, n = 64): clusters of 8 blocks, each holding
    up to 1,024 keys (G x 1,024 f32 scores, 28 KB), the statistics of
    its 16 bk tiles in the ring's memory, 128 blocks in one wave on 132
    SMs; Qwen2-7B's whole
    context (T = 32,768) fits too (112 KB of scores)."""
    plan = faq.plan_attention(4, 1, 8192, 28, 4, 128, 512, 64)
    assert plan == faq.AttentionPlan("attention_decode_long_kernel", 1, 7,
                                     (8, 4, 4), 96464, 1024, 8, 0)
    assert math.prod(plan.grid) == 128 <= 132
    assert plan.smem_bytes == faq.decode_long_smem_bytes(
        7, 1024, 8192, 128, 64, 512)
    full = faq.plan_attention(4, 1, 32768, 28, 4, 128, 512, 64)
    assert (full.kernel, full.grid, full.keys) == (
        "attention_decode_long_kernel", (8, 4, 4), 4096)
    assert 4 * 7 * 4096 == 114688 < full.smem_bytes <= faq.SMEM_MAX
    # the exact body at T = 8192 (bk = T): past the decode kernel's ranges
    exact = faq.plan_attention(4, 1, 8192, 28, 4, 128, 8192, 64)
    assert faq.plan_attention_decode(4, 8192, 28, 4, 128, 64).smem_bytes > \
        faq.SMEM_MAX
    assert exact == plan


@pytest.mark.parametrize("T,probs_n,want", [
    (8192, 64, (8, 1024)),
    (8192, 0, (8, 1024)),
    (8192, 32, (8, 1024)),
    (8192, 128, (8, 1024)),     # units of 128 keys
    (8160, 48, (8, 1152)),      # units of lcm(64, 48) = 192 keys
    (4096, 0, (8, 512)),
    (256, 0, (4, 64)),          # fewer units than 8: a smaller cluster
    (45056, 64, (8, 5632)),     # the longest that fits at G = 7, bk = 512
])
def test_decode_long_plan(T, probs_n, want):
    bk = 480 if probs_n == 48 else min(T, 512)
    plan = faq.plan_attention_decode_long(4, T, 28, 4, 128, bk, probs_n)
    assert (plan.cluster, plan.keys) == want
    assert plan.grid == (plan.cluster, 4, 4)
    unit = faq.decode_unit(probs_n)
    assert plan.keys % unit == 0 and (probs_n == 0 or unit % probs_n == 0)
    # a block holds its share of every unit of T
    assert plan.keys == -(-(-(-T // unit)) // plan.cluster) * unit
    assert plan.smem_bytes <= faq.SMEM_MAX


# (B, S, T, bk, probs_n) at 28 / 4 heads, D = 128 -> kernel
@pytest.mark.parametrize("shape,kernel", [
    ((4, 1, 8192, 512, 64), "attention_decode_long_kernel"),  # long decode
    ((4, 1, 4096, 512, 0), "attention_decode_long_kernel"),   # online
    ((4, 1, 8192, 8192, 64), "attention_decode_long_kernel"),  # exact
    ((4, 1, 32768, 512, 64), "attention_decode_long_kernel"),
    ((4, 1, 8160, 480, 48), "attention_decode_long_kernel"),  # n = 48
    ((4, 1, 480, 480, 48), "attention_decode_kernel"),
    ((4, 1, 512, 512, 64), "attention_decode_kernel"),
    ((4, 1, 46080, 512, 64), "attention_kernel"),  # past shared memory
    ((4, 64, 960, 960, 48), "attention_kernel"),   # S >= 2, n = 48
    ((4, 64, 8192, 512, 64), "attention_long_kernel"),
])
def test_routes(shape, kernel):
    B, S, T, bk, probs_n = shape
    assert faq.plan_attention(B, S, T, 28, 4, 128, bk, probs_n).kernel == \
        kernel


def test_every_s1_call_within_shared_memory_takes_a_decode_kernel():
    """At G = 7, D = 128, every S = 1 body up to T = 32,768 (and any probs
    group length) takes one of the two decode kernels, never
    ``attention_kernel``."""
    for T in (2048, 2112, 4096, 4608, 8192, 16384, 32768):
        for n in (0, 32, 48, 64, 128):
            Tp = -(-T // n) * n if n else T
            tiled = tkops.fit_block(Tp, start=512, multiple=n or 1)
            for bk in (Tp, tiled):
                plan = faq.plan_attention(4, 1, Tp, 28, 4, 128, bk, n)
                assert plan.kernel in ("attention_decode_kernel",
                                       "attention_decode_long_kernel"), \
                    (T, n, bk, plan)


def _meta_args(B, T, H, KV, D):
    m = dict(device="meta")
    return (torch.empty(B, 1, H, D, **m),
            torch.empty(B, T, KV, D, dtype=torch.int8, **m),
            torch.empty(B, T, KV, D, dtype=torch.int8, **m),
            torch.empty(B, T, KV, **m), torch.empty(B, T, KV, **m),
            torch.empty(B, 1, dtype=torch.int32, **m),
            torch.empty(B, T, dtype=torch.int32, **m))


@pytest.mark.parametrize("change", [dict(keys=512), dict(grid=(4, 4, 4)),
                                    dict(cluster=16, grid=(16, 4, 4)),
                                    dict(keys=1000)])
def test_forced_plan_is_checked(change):
    """A CUDA call is refused before any launch when a forced plan gives a
    block less than its share of the units, a grid off its cluster, or a
    cluster past the portable 8 blocks (a meta tensor stands in for the
    card's)."""
    B, T, H, KV, D = 4, 8192, 28, 4, 128
    plan = faq.plan_attention_decode_long(B, T, H, KV, D, 512, 64)._replace(
        **change)
    with pytest.raises(ValueError, match="attention_decode_long_kernel"):
        faq._flash_attention_quant(
            *_meta_args(B, T, H, KV, D), 1 << 20, plan=plan, scale=0.1,
            causal=True, probs_n=64, probs_qmax=127.0, probs_qmin=-127.0,
            block_k=512)


def test_kernel_source_takes_the_plan():
    """The kernel is a ``__global__`` of flash_attention_quant.cu launched
    as a cluster (``cudaLaunchKernelEx``); its tile, ring and cluster
    constants are the planner's, and its cluster, range and shared memory
    come from the plan (no second copy of those rules in the source)."""
    source = (build.CSRC_DIR /
              build.SOURCES["flash_attention_quant"]).read_text()
    assert faq._KERNEL_IDS["attention_decode_long_kernel"] == 4
    assert "if (kernel == 4)" in source
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", source))
    assert int(consts["kDLTile"]) == faq.DECODE_TILE
    assert int(consts["kDClusterMax"]) == faq.DECODE_CLUSTER
    assert int(consts["kDLStages"]) == faq.DECODE_LONG_STAGES
    assert source.count(
        "cudaLaunchKernelEx(&cfg, attention_decode_long_kernel") == 1
    for rule in ("decode_long_smem_bytes", "plan_attention_decode_long"):
        assert not re.search(rf"\b{rule}\(", source), rule
    body = source[source.index("attention_decode_long_kernel(const Params"):]
    body = body[:body.index("int launch_decode_long")]
    for field in ("p.cluster", "p.keys", "p.bk", "p.unit"):
        assert field in body, field
    lib = types.SimpleNamespace(repro_flash_attention_quant=(
        types.SimpleNamespace(argtypes=None, restype=None)))
    entry = re.search(r'extern "C" int repro_flash_attention_quant\(([^)]*)\)',
                      source).group(1)
    assert len(faq._bind(lib).argtypes) == entry.count(",") + 1


def test_cpu_tensors_run_the_plain_version():
    """A CPU decode call at a long T counts no launch of any kernel,
    through the GQA front-end as the model calls it (phased: T past the
    front end's single_block_max)."""
    inp = _inputs(2, 2112, 14, 2, 16, [2000, -1], seed=9)
    args = _torch_args(inp, False)
    assert "attention_decode_long_kernel" in \
        faq.flash_attention_quant.launches_by_kernel
    before = (faq.flash_attention_quant.launches,
              dict(faq.flash_attention_quant.launches_by_kernel))
    tq = TTensorQuant("int8", group=64)
    got = tkops.flash_attention_quant_gqa(*args, probs_tq=tq)
    assert got.shape == (2, 1, 14, 16)
    assert (faq.flash_attention_quant.launches,
            faq.flash_attention_quant.launches_by_kernel) == before
    # the emulation of the same call (the front end's phased body, bk from
    # fit_block) within the bars of it
    bk = tkops.fit_block(2112, start=512, multiple=64)
    _within_bars(emulate(*args, 2112 + 2, **_kw(64, bk, 16)), got, True)
