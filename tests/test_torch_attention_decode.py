"""``attention_decode_kernel``: the exact body of ``flash_attention_quant``
at S = 1 over a cluster of blocks, emulated on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there and reads from the profiler which kernel each call
launches).  What it computes is pinned here by an emulation of its
arithmetic, fed the same numpy inputs as the reference package's
``flash_attention_quant_gqa`` (Pallas, interpret mode) and the port's
plain version:

  * one cluster of C blocks a (batch, KV head); block c owns keys
    [c L, c L + L) (``decode_range``), all G query heads of the KV head;
    a block whose range no row sees takes no part (max -inf, sum +0, P.V
    +0), unless the row sees no key at all;
  * scores as the plain version forms them on the card: k = code * ks in
    f32, one fmaf chain over d = 0 .. D - 1 from 0 a (row, key), times
    scale; masked scores the finite -1e9;
  * softmax across the cluster: the maximum over every block's maxima;
    e = exp(s - m); a block's partial sum as its warp forms it (lane l
    adds keys l, l + 32, ... of the range in order, then a butterfly);
    the C partial sums added in block order; p = e / sum; the group QDQ
    inside the range;
  * P.V: warp w's partial, fmaf(p, code * vs, acc) over keys w, w + 8,
    ... of the range in order; the 8 warps' partials added in warp order,
    then the C blocks' partials in block order.

Tolerances are the card's bars (``chip_smoke.check_attention``): 2e-5 of
the largest output without the probs QDQ (f32 products, sums in another
order); with it, 5e-3 and at least 99 % of the elements within 2e-5 (a
probability on a rounding boundary of the QDQ may flip one code).
Skipping ranges is held bit-equal to walking them all.
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
WARPS = 8  # warps of a block


# --------------------------------------------------------------------------
# the emulation
# --------------------------------------------------------------------------
def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """fmaf: a * b is exact in f64, a * b + c rounded to f64 then to f32
    (a double rounding that differs from one rounding only on ties)."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def warp_sum(e: torch.Tensor) -> torch.Tensor:
    """Sums over the last axis (a multiple of 32 keys) as a warp forms
    them: lane l adds keys l, l + 32, ... in order, then a butterfly."""
    lanes = e.reshape(*e.shape[:-1], -1, 32)
    v = torch.zeros(lanes.shape[:-2] + (32,))
    for i in range(lanes.shape[-2]):
        v = v + lanes[..., i, :]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., idx ^ o]
    return v[..., 0]


def probs_qdq(p: torch.Tensor, n: int, qmax: float, qmin: float):
    """Group QDQ of probabilities along the last axis (groups of n)."""
    pg = p.reshape(*p.shape[:-1], -1, n)
    alpha = pg.amax(-1, keepdim=True).to(torch.bfloat16).to(torch.float32)
    step = div_by_constant(torch.clamp_min(alpha, 1e-12), qmax)
    return (torch.clamp(torch.round(pg / step), qmin, qmax) * step
            ).reshape(p.shape)


def visible(q_pos, kv_pos, window, causal):
    """(B, T): the keys each batch row's one query position sees."""
    qp = q_pos[:, :1]
    vis = (kv_pos >= 0) & (kv_pos > qp - window)
    return vis & (kv_pos <= qp) if causal else vis


def emulate(qh, kc, vc, ks, vs, q_pos, kv_pos, window, *, scale,
            causal=True, probs_n=0, probs_qmax=0.0, probs_qmin=0.0,
            skip=True):
    """``attention_decode_kernel``'s arithmetic on CPU tensors (the
    arguments of ``flash_attention_quant``, exact body, S = 1); with
    ``skip=False`` every block walks its range."""
    B, S, H, D = qh.shape
    assert S == 1
    T, KV = kc.shape[1], kc.shape[2]
    G = H // KV
    plan = faq.plan_attention_decode(B, T, H, KV, D, probs_n)
    C, L = plan.grid[0], plan.keys
    t = torch.arange(C * L).reshape(C, L)
    real = t < T                       # (C, L): keys past T are no key
    tt = torch.where(real, t, 0)
    vis = visible(q_pos, kv_pos, window, causal)
    vis_r = vis[:, tt] & real          # (B, C, L)
    dead = ~vis.any(-1)
    live = vis_r.any(-1) | dead[:, None]
    if not skip:
        live = torch.ones_like(live)
    live5 = live[:, None, :, None, None]  # (B, 1, C, 1, 1)
    # scores (B, KV, C, G, L): the plain version's chain
    k = (kc.to(torch.float32) * ks[..., None])[:, tt].permute(0, 3, 1, 2, 4)
    q = qh[:, 0].reshape(B, KV, G, D)
    acc = torch.zeros(B, KV, C, G, L)
    for d in range(D):
        acc = fma(q[:, :, None, :, d, None], k[:, :, :, None, :, d], acc)
    s = torch.where(vis_r[:, None, :, None, :], acc * scale, NEG_INF)
    # the cluster's maxima; a block that takes no part gives -inf
    m_c = torch.where(real[:, None, :], s, -math.inf).amax(-1)
    m = torch.where(live5[..., 0], m_c, -math.inf).amax(2, keepdim=True)
    e = torch.where(real[:, None, :] & live5, torch.exp(s - m[..., None]),
                    0.0)
    part_sum = warp_sum(e)             # (B, KV, C, G)
    total = torch.zeros(B, KV, G)
    for c in range(C):
        total = total + part_sum[:, :, c]
    p = e / total[:, :, None, :, None]
    if probs_n:
        p = probs_qdq(p, probs_n, probs_qmax, probs_qmin)
    # P.V: warp w's partial over keys w, w + 8, ... of the range in
    # order; the 8 warps' partials in warp order; then block order
    v = (vc.to(torch.float32) * vs[..., None])[:, tt].permute(0, 3, 1, 2, 4)
    warps = torch.zeros(WARPS, B, KV, C, G, D)
    for j in range(L):
        w = j % WARPS
        warps[w] = fma(p[..., j, None], v[:, :, :, None, j, :], warps[w])
    pv = torch.zeros(B, KV, C, G, D)
    for w in range(WARPS):
        pv = pv + warps[w]
    out = torch.zeros(B, KV, G, D)
    for c in range(C):
        out = out + pv[:, :, c]
    return out.reshape(B, 1, H, D)


# --------------------------------------------------------------------------
# inputs: cache-style rows (chip_smoke.attention_inputs, in numpy)
# --------------------------------------------------------------------------
def _inputs(B, T, H, KV, D, q_starts, *, fp8=False, seed=0):
    """Row b holds q_starts[b] + 1 tokens and queries the last; a start of
    -1 makes a dead row (every kv position invalid)."""
    rng = np.random.RandomState(seed)
    qh = rng.randn(B, 1, H, D).astype(np.float32)
    codes = rng.randint(-127, 128, (2, B, T, KV, D)).astype(np.float32)
    if fp8:
        codes = codes / 16.0  # e4m3-representable values
    ks = (rng.rand(B, T, KV) * 0.05 + 1e-3).astype(np.float32)
    vs = (rng.rand(B, T, KV) * 0.05 + 1e-3).astype(np.float32)
    starts = np.asarray(q_starts)
    q_pos = np.maximum(starts, 0)[:, None].astype(np.int32)
    n_ctx = np.where(starts >= 0, starts + 1, 0)
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
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    vmax = np.abs(want).max()
    diff = np.abs(got - want)
    if probs:
        assert diff.max() <= 5e-3 * vmax, (diff.max(), vmax)
        assert (diff <= 2e-5 * vmax).mean() > 0.99
    else:
        assert diff.max() <= 2e-5 * vmax, (diff.max(), vmax)


def _qdq_kw(probs_n):
    return dict(probs_n=probs_n, probs_qmax=127.0 if probs_n else 0.0,
                probs_qmin=-127.0 if probs_n else 0.0)


# (fp8, probs_n, causal, window): B = 4 rows at positions 160, 41, 100
# and a dead row (the main path's contexts); T = 512 (eight 64-key
# ranges, fewer for 128-key groups), H = 4, KV = 2 (G = 2), D = 32
CASES = {
    "int8-probs64": (False, 64, True, None),
    "int8": (False, 0, True, None),
    "fp8-probs64": (True, 64, True, None),
    "fp8": (True, 0, True, None),
    "int8-probs32": (False, 32, True, None),
    "int8-probs128": (False, 128, True, None),
    "fp8-probs128": (True, 128, True, None),
    "int8-probs64-window": (False, 64, True, 40),
    "int8-noncausal": (False, 0, False, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulation_against_reference_and_plain(case):
    fp8, probs_n, causal, window = CASES[case]
    B, T, H, KV, D = 4, 512, 4, 2, 32
    inp = _inputs(B, T, H, KV, D, [160, 41, 100, -1], fp8=fp8, seed=3)
    args = _torch_args(inp, fp8)
    kw = dict(scale=D ** -0.5, causal=causal, **_qdq_kw(probs_n))
    win = (T + 2) if window is None else window
    assert faq.plan_attention(B, 1, T, H, KV, D, T, probs_n).kernel == \
        "attention_decode_kernel"
    got = emulate(*args, win, **kw)
    plain = faq.flash_attention_quant_plain(*args, win, **kw)
    _within_bars(got, plain, bool(probs_n))
    ref = _reference(inp, fp8, window=window, causal=causal, probs_n=probs_n)
    _within_bars(got, ref, bool(probs_n))
    # the dead row is the uniform mean over all T keys, as the plain version
    _within_bars(got[3], plain[3], bool(probs_n))


@pytest.mark.parametrize("T,probs_n", [(200, 0), (150, 64), (100, 32)])
def test_emulation_ragged_and_padded_T(T, probs_n):
    """T = 200 without the probs QDQ: four 64-key ranges, the last of 8
    keys.  T = 150 (n = 64) and 100 (n = 32): the front end pads T to a
    multiple of n with kv_pos = -1 (192, 128), and the emulation takes the
    padded call; the reference pads on its own."""
    B, H, KV, D = 3, 4, 2, 16
    inp = _inputs(B, T, H, KV, D, [T - 1, 41, -1], seed=5)
    kw = dict(scale=0.25, causal=True, **_qdq_kw(probs_n))
    args = _torch_args(inp, False)
    if probs_n:
        pad = -T % probs_n
        qh, kc, vc, ks, vs, q_pos, kv_pos = args
        fpad = torch.nn.functional.pad
        args = (qh, fpad(kc, (0, 0, 0, 0, 0, pad)),
                fpad(vc, (0, 0, 0, 0, 0, pad)), fpad(ks, (0, 0, 0, pad)),
                fpad(vs, (0, 0, 0, pad)), q_pos,
                fpad(kv_pos, (0, pad), value=-1))
        assert args[1].shape[1] % probs_n == 0
    Tp = args[1].shape[1]
    C, L = faq.decode_range(Tp, probs_n)
    assert (C - 1) * L < Tp < C * L or Tp == C * L
    got = emulate(*args, 1 << 20, **kw)
    _within_bars(got, faq.flash_attention_quant_plain(*args, 1 << 20, **kw),
                 bool(probs_n))
    ref = _reference(inp, False, window=None, causal=True, probs_n=probs_n)
    _within_bars(got, ref, bool(probs_n))
    # the port's front end (CPU: the plain version) pads the same way
    tq = TTensorQuant("int8", group=probs_n) if probs_n else None
    front = tkops.flash_attention_quant_gqa(*_torch_args(inp, False),
                                            scale=0.25, probs_tq=tq)
    _within_bars(got, front, bool(probs_n))


@pytest.mark.parametrize("probs_n", [0, 32, 64, 128])
def test_skipping_ranges_is_bit_exact(probs_n):
    """A range no row sees holds exact zeros (exp(-1e9 - m) is 0, a zero
    group QDQs to 0, a zero product adds nothing), and its maximum is
    below every visible score, so skipping it leaves every output bit as
    it is; the dead row walks every range either way."""
    B, T, H, KV, D = 4, 512, 4, 2, 16
    inp = _inputs(B, T, H, KV, D, [41, 500, 200, -1], seed=7)
    args = _torch_args(inp, False)
    kw = dict(scale=0.25, causal=True, **_qdq_kw(probs_n))
    C, L = faq.decode_range(T, probs_n)
    for window in (1 << 20, 64):
        vis = visible(args[5], args[6], window, True)
        seen = torch.nn.functional.pad(vis, (0, C * L - T)).reshape(
            B, C, L).any(-1)
        assert int((~seen[:3]).sum()) >= 3  # ranges the live rows skip
        skipped = emulate(*args, window, **kw, skip=True)
        walked = emulate(*args, window, **kw, skip=False)
        assert torch.equal(skipped.view(torch.int32),
                           walked.view(torch.int32))


# --------------------------------------------------------------------------
# the ranges and the planner
# --------------------------------------------------------------------------
# (T, probs_n) -> (blocks of a cluster, keys of a range)
@pytest.mark.parametrize("T,probs_n,want", [
    (512, 64, (8, 64)),     # the main path: one wave of 16 x 8 blocks
    (512, 0, (8, 64)),
    (512, 32, (8, 64)),
    (512, 128, (4, 128)),   # ranges of whole groups: a smaller cluster
    (2048, 64, (8, 256)),   # the front end's longest exact body
    (200, 0, (4, 64)),      # ragged: the last range holds 8 keys
    (160, 32, (3, 64)),
    (480, 48, (3, 192)),    # a group off the 64 grid: lcm(64, 48) keys
    (64, 64, (1, 64)),
    (4096, 64, (8, 512)),
])
def test_decode_range(T, probs_n, want):
    assert faq.decode_range(T, probs_n) == want


@settings(max_examples=300, deadline=None)
@given(st.sampled_from([0, 16, 32, 48, 64, 128, 256]),
       st.integers(min_value=1, max_value=8192))
def test_decode_ranges_tile_T(probs_n, T):
    """At most 8 ranges of whole 64-key tiles and whole probs groups, none
    empty, together covering T."""
    if probs_n:
        T = -(-T // probs_n) * probs_n  # the front end's padded T
    C, L = faq.decode_range(T, probs_n)
    assert 1 <= C <= faq.DECODE_CLUSTER
    assert L % faq.DECODE_TILE == 0
    assert probs_n == 0 or L % probs_n == 0
    assert (C - 1) * L < T <= C * L


def test_main_path_decode_plan():
    """The paged decode step (B = 4 slots, T = 512, 28 / 4 heads, D = 128,
    probs groups of 64): clusters of 8 blocks of 64 keys, 128 blocks in
    one wave on 132 SMs; at T = 2048 ranges of 256 keys need more than the
    default 48 KB of shared memory (the kernel asks for it)."""
    plan = faq.plan_attention(4, 1, 512, 28, 4, 128, 512, 64)
    assert plan == faq.AttentionPlan("attention_decode_kernel", 1, 7,
                                     (8, 4, 4), 57056, 64)
    assert math.prod(plan.grid) == 128 <= 132
    long = faq.plan_attention(4, 1, 2048, 28, 4, 128, 2048, 64)
    assert (long.kernel, long.grid, long.keys) == (
        "attention_decode_kernel", (8, 4, 4), 256)
    assert 48 * 1024 < long.smem_bytes == faq.decode_smem_bytes(
        7, 256, 128) <= 232448


# (B, S, T, bk, probs_n) at 28 / 4 heads, D = 128 -> kernel
@pytest.mark.parametrize("shape,kernel", [
    ((4, 1, 512, 512, 64), "attention_decode_kernel"),     # exact, S = 1
    ((4, 1, 512, 512, 0), "attention_decode_kernel"),
    ((4, 1, 200, 200, 0), "attention_decode_kernel"),
    ((1, 1, 2048, 2048, 128), "attention_decode_kernel"),
    ((4, 2, 512, 512, 64), "attention_prefill_kernel"),    # exact, S >= 2
    ((4, 64, 512, 512, 64), "attention_prefill_kernel"),
    ((4, 1, 4096, 512, 0), "attention_decode_long_kernel"),    # online
    ((4, 1, 4096, 512, 64), "attention_decode_long_kernel"),   # phased
    ((4, 5, 4096, 512, 64), "attention_long_kernel"),
    # ranges past 227 KB
    ((4, 1, 8192, 8192, 64), "attention_decode_long_kernel"),
    # a probs group off the 64 grid: units of lcm(64, 48) = 192 keys
    ((4, 1, 8160, 480, 48), "attention_decode_long_kernel"),
])
def test_routes(shape, kernel):
    B, S, T, bk, probs_n = shape
    assert faq.plan_attention(B, S, T, 28, 4, 128, bk, probs_n).kernel == \
        kernel


def test_cpu_tensors_run_the_plain_version():
    """A CPU call at S = 1 counts no launch of any kernel, through the GQA
    front-end as the model calls it."""
    inp = _inputs(2, 64, 4, 2, 16, [40, 63], seed=9)
    args = _torch_args(inp, False)
    assert "attention_decode_kernel" in \
        faq.flash_attention_quant.launches_by_kernel
    before = (faq.flash_attention_quant.launches,
              dict(faq.flash_attention_quant.launches_by_kernel))
    tq = TTensorQuant("int8", group=64)
    got = tkops.flash_attention_quant_gqa(*args, probs_tq=tq)
    assert got.shape == (2, 1, 4, 16)
    assert (faq.flash_attention_quant.launches,
            faq.flash_attention_quant.launches_by_kernel) == before
