"""``flash_mma_kernel``: dense flash attention on the tensor cores at f32
accuracy, emulated on the CPU.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there and reads from the profiler which kernel each call
launches).  What it computes is pinned here by an emulation of its
arithmetic, fed the same numpy inputs as the reference package's
``flash_attention`` (Pallas, interpret mode), its oracle
``flash_attention_ref`` and the port's plain version:

  * a block serves three m16 tiles of rows (row = position * G + head) of
    one KV head, tiles b, b + nb and b + 2 nb of the head's n16 (nb blocks
    a head), and walks the 64-key tiles up to its last row's causal limit;
    warp (m16 tile, key part) forms the scores of 16 rows and 16 keys of
    each tile, and a part no row of its m16 tile can see is neither
    multiplied nor summed;
  * each f32 operand is split into tf32 terms big + small (round to
    nearest, ties away); an MMA step of 8 adds the exact sum of its 8
    products to an f32 accumulator, rounding once; the scores keep one
    accumulator a term (small * big, big * small, big * big) over d in
    steps of 8, added as (sb + bs) + bb; P.V keeps one for the small
    terms (small * big, then big * small) and one for big * big, added
    as bb + small at the end;
  * the online recurrence per 64-key tile: s * scale or -1e30, the row
    max over the tile's four parts, guarded p and corr; each part keeps
    its own running sum, l_i = fma(l_i, corr, sum_i) with sum_i as the 4
    lanes of a quad form it (each lane its 4 keys in order, then two
    butterflies); acc * corr, then P.V over the tile's live parts in key
    order, 8 keys an MMA step;
  * out = acc / max(l_0 + l_1 + l_2 + l_3, 1e-30), the sums added in part
    order.

Tolerance: the card's bar (``chip_smoke.check_flash``), 2e-5 of the
largest output (f32-accurate products, sums in another order).  Rows that
see no key are exactly 0, and skipping tiles is bit-equal to walking them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.kernels import flash_attention as j_fa
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as tops

NEG_INF = -1e30
ROWS, KEYS = t_fa.FLASH_ROWS, t_fa.FLASH_KEYS
MT = ROWS // 16  # m16 tiles of a block
PARTS = 4  # key parts of a tile, a warp each per m16 tile
PART = KEYS // PARTS
BAR = 2e-5  # of the largest output, as chip_smoke.check_flash


# --------------------------------------------------------------------------
# the emulation
# --------------------------------------------------------------------------
def tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: the nearest tf32 (10 fraction bits), ties away
    from zero, as an f32 with its 13 low bits zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor, terms: int = 3):
    """(big, small) tf32 terms of x; with ``terms=1`` small is 0 (one
    plain tf32 product, the scheme the split replaces)."""
    big = tf32(x)
    small = tf32(x - big) if terms == 3 else torch.zeros_like(x)
    return big, small


def mma(acc: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """acc + a @ b over one 8-wide MMA step: tf32 products are exact in
    f64, their sum too (to far below f32's precision), and the f32
    accumulator rounds once."""
    return (acc.double() + a.double() @ b.double()).to(torch.float32)


def mma3(acc, a, b, terms):
    """One step of three tf32 products into the accumulators ``acc`` =
    (small * big, big * small, big * big), or, given two, (the small
    terms' products in that order, big * big)."""
    ab, as_ = split(a, terms)
    bb, bs = split(b, terms)
    *lo, hi = acc
    if terms == 3:
        lo[0] = mma(lo[0], as_, bb)
        lo[-1] = mma(lo[-1], ab, bs)
    return (*lo, mma(hi, ab, bb))


def fma(a, b, c):
    """fmaf: a * b exact in f64, + c rounded to f64 then to f32."""
    return (a.double() * b.double() + c.double()).to(torch.float32)


def correction(m, m_new):
    return torch.where(m <= NEG_INF / 2, torch.zeros_like(m),
                       torch.exp(m - m_new))


def quad_sum(p: torch.Tensor) -> torch.Tensor:
    """Row sums of p (rows, 16 keys) as the 4 lanes of a quad form them:
    lane t4 adds keys 8 nt + 2 t4 + e in order (nt, e), then the
    butterflies xor 1 and xor 2."""
    lane = []
    for t4 in range(4):
        s = torch.zeros(p.shape[0])
        for nt in range(PART // 8):
            for e in range(2):
                s = s + p[:, 8 * nt + 2 * t4 + e]
        lane.append(s)
    a, b = lane[0] + lane[1], lane[2] + lane[3]
    return (a + b)[:, None]


def emulate(q, k, v, *, scale=None, causal=True, q_offset=None,
            skip=True, terms=3):
    """``flash_mma_kernel``'s arithmetic on CPU tensors (the arguments of
    ``flash_attention``); ``skip=False`` walks every tile and part."""
    BH, S, D = q.shape
    BHkv, T, _ = k.shape
    G = BH // BHkv
    scale = D ** -0.5 if scale is None else scale
    if q_offset is None:
        q_offset = 0
    dp = t_fa.plan_flash(BHkv, S, T, G, 1, D, causal).head_dim
    pad = lambda x: torch.nn.functional.pad(x, (0, dp - D))  # noqa: E731
    n_all = -(-T // KEYS)
    kp = torch.nn.functional.pad(pad(k), (0, 0, 0, n_all * KEYS - T))
    vp = torch.nn.functional.pad(pad(v), (0, 0, 0, n_all * KEYS - T))
    out = torch.zeros(BH, S, D)
    rows_total = S * G

    def last_key(row):
        return min(row // G + q_offset, T - 1) if causal else T - 1

    for bkv in range(BHkv):
        qrows = pad(q[bkv * G:(bkv + 1) * G]).transpose(0, 1).reshape(
            rows_total, dp)  # row = position * G + head
        n16 = -(-rows_total // 16)
        nb = -(-n16 // MT)
        for b in range(nb):  # block b: m16 tiles b, b + nb, b + 2 nb
            row0 = [16 * (b + i * nb) for i in range(MT)]
            last = max(r for r in row0 if r < rows_total)
            block_lim = last_key(min(last + 15, rows_total - 1))
            n_tiles = (block_lim // KEYS + 1 if block_lim >= 0 else 0) \
                if skip else n_all
            for w0 in row0:
                if w0 >= rows_total:
                    continue
                rows = [min(w0 + i, rows_total - 1) for i in range(16)]
                lim = torch.tensor([last_key(r) for r in rows])
                warp_lim = last_key(min(w0 + 15, rows_total - 1))
                qa = qrows[rows]
                m = torch.full((16, 1), NEG_INF)
                l = [torch.zeros(16, 1) for _ in range(PARTS)]
                acc = (torch.zeros(16, dp),) * 2  # (small terms, big)
                for j in range(n_tiles):
                    kt = [j * KEYS + PART * part for part in range(PARTS)]
                    live = [not skip or t0 <= warp_lim for t0 in kt]
                    ss = []
                    for t0, on in zip(kt, live):
                        s = torch.full((16, PART), NEG_INF)
                        if on:
                            kh = kp[bkv, t0:t0 + PART]
                            st = (torch.zeros(16, PART),) * 3
                            for d0 in range(0, dp, 8):
                                st = mma3(st, qa[:, d0:d0 + 8],
                                          kh[:, d0:d0 + 8].T, terms)
                            s = (st[0] + st[1]) + st[2]
                            keys = t0 + torch.arange(PART)
                            s = torch.where(keys[None, :] <= lim[:, None],
                                            s * scale,
                                            torch.tensor(NEG_INF))
                        ss.append(s)
                    m_new = m
                    for s in ss:
                        m_new = torch.maximum(m_new, s.amax(-1, keepdim=True))
                    corr = correction(m, m_new)
                    ps = []
                    for part, (s, on) in enumerate(zip(ss, live)):
                        p = torch.where(s <= NEG_INF / 2, torch.zeros(()),
                                        torch.exp(s - m_new))
                        l[part] = fma(l[part], corr,
                                      quad_sum(p) if on else
                                      torch.zeros(16, 1))
                        ps.append(p)
                    acc = tuple(a * corr for a in acc)
                    for t0, p, on in zip(kt, ps, live):
                        if not on:
                            continue
                        for h in range(0, PART, 8):
                            acc = mma3(acc, p[:, h:h + 8],
                                       vp[bkv, t0 + h:t0 + h + 8], terms)
                    m = m_new
                den = l[0]
                for part in range(1, PARTS):
                    den = den + l[part]
                o = (acc[1] + acc[0]) / torch.clamp_min(den, 1e-30)
                for i in range(16):
                    R = w0 + i
                    if R < rows_total:
                        out[bkv * G + R % G, R // G] = o[i, :D]
    return out


# --------------------------------------------------------------------------
# against the reference and the plain version
# --------------------------------------------------------------------------
def _qkv(seed, BH, S, T, D, BHkv):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)  # noqa: E731
    return f(BH, S, D), f(BHkv, T, D), f(BHkv, T, D)


def _within_bar(got, want):
    want = torch.from_numpy(np.array(want))
    err = (got - want).abs().max().item()
    assert err <= BAR * want.abs().max().item(), err


# (causal, BHkv, G, S, T, D, q_offset): the main path's shape at a few
# positions (G = 7, D = 128), the reduced config (G = 2, D = 16), G = 1,
# ragged S and T past one tile, a suffix, positive and negative offsets,
# non-causal with two batches' KV heads, an odd head_dim, and one (batch,
# head) of the ViT's encoder call (non-causal, G = 1, D = 64, S = T = 197:
# three 64-key tiles and a ragged fourth of 5 keys, every row walks all)
CASES = [
    (True, 1, 7, 10, 10, 128, None),
    (True, 2, 2, 16, 16, 16, None),
    (True, 1, 2, 70, 70, 16, None),
    (True, 1, 1, 37, 37, 16, None),
    (True, 1, 1, 20, 100, 16, 80),
    (True, 2, 2, 12, 40, 16, 5),
    (True, 1, 7, 12, 20, 16, -4),
    (False, 4, 2, 9, 70, 16, None),
    (False, 1, 1, 5, 37, 128, None),
    (True, 1, 2, 13, 13, 37, None),
    (False, 1, 1, 197, 197, 64, None),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_emulation_against_reference_and_plain(case):
    causal, BHkv, G, S, T, D, q_offset = case
    q, k, v = _qkv(S * T + D, BHkv * G, S, T, D, BHkv)
    kw = dict(scale=D ** -0.5, causal=causal, q_offset=q_offset)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    got = emulate(tq, tk, tv, **kw)
    _within_bar(got, t_fa.flash_attention_plain(tq, tk, tv, **kw))
    # the reference takes as many KV heads as query heads
    krep, vrep = (jnp.asarray(np.repeat(x, G, axis=0)) for x in (k, v))
    want = j_fa.flash_attention(jnp.asarray(q), krep, vrep, block_q=8,
                                block_k=8, interpret=True, **kw)
    _within_bar(got, want)
    if causal and q_offset is not None and q_offset < 0:
        # rows that see no key come out exactly 0 (the oracle's softmax
        # over all -1e30 gives them the mean instead)
        assert torch.equal(got[:, :-q_offset],
                           torch.zeros_like(got[:, :-q_offset]))
        assert bool((got[:, -q_offset:] != 0).any())
        return
    _within_bar(got, jref.flash_attention_ref(
        jnp.asarray(q), krep, vrep, **kw))


@pytest.mark.parametrize("case", [(True, 1, 7, 24, 24, 16, None),
                                  (True, 1, 2, 40, 130, 16, 90),
                                  (True, 1, 2, 12, 20, 16, -4)])
def test_skipping_tiles_is_bit_exact(case):
    """Keys no row can see give p = 0 and corr = 1 (0 for a row that has
    seen nothing), so the tiles and parts the kernel skips leave every
    output bit as walking them does."""
    causal, BHkv, G, S, T, D, q_offset = case
    q, k, v = (torch.from_numpy(x) for x in _qkv(7, BHkv * G, S, T, D,
                                                   BHkv))
    kw = dict(scale=0.25, causal=causal, q_offset=q_offset)
    skipped = emulate(q, k, v, **kw)
    walked = emulate(q, k, v, skip=False, **kw)
    assert torch.equal(skipped, walked)


def test_one_tf32_term_misses_the_bar():
    """Why three products: one tf32 product a product (10 fraction bits)
    leaves the main path's head shape far outside the bar."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, 7, 12, 12, 128, 1))
    want = t_fa.flash_attention_plain(q, k, v)
    bar = BAR * want.abs().max().item()
    one = (emulate(q, k, v, terms=1) - want).abs().max().item()
    three = (emulate(q, k, v) - want).abs().max().item()
    assert three <= bar < 10 * bar < one


# --------------------------------------------------------------------------
# the split
# --------------------------------------------------------------------------
_F32 = st.floats(min_value=2.0 ** -60, max_value=2.0 ** 60, width=32)


@settings(max_examples=300, deadline=None)
@given(_F32, _F32, st.booleans(), st.booleans())
def test_three_tf32_products_carry_an_f32_product(x, y, nx, ny):
    """small * big + big * small + big * big is within 3 * 2^-22 of the
    exact product x * y of two f32s (the dropped small * small and the two
    rounding residuals)."""
    a = torch.tensor([[-x if nx else x]], dtype=torch.float32)
    b = torch.tensor([[-y if ny else y]], dtype=torch.float32)
    for t in split(a) + split(b):
        assert torch.equal(tf32(t), t)
    (ab, as_), (bb, bs) = split(a), split(b)
    got = (as_.double() * bb.double() + ab.double() * bs.double()
           + ab.double() * bb.double())
    exact = a.double() * b.double()
    assert abs((got.double() - exact).item()) <= \
        3 * 2.0 ** -22 * abs(exact.item())


@settings(max_examples=100, deadline=None)
@given(st.integers(0, 2 ** 31 - 1), st.sampled_from([16, 128]))
def test_split_dot_is_within_the_bar_of_f32(seed, D):
    """A score's dot product over d in MMA steps of 8 (f32 sums, an
    accumulator a term, added at the end) is as close to the exact one as
    f32 sums allow: within 2e-5 of the sum of |q_d k_d|."""
    rng = np.random.RandomState(seed)
    a = torch.from_numpy(rng.randn(1, D).astype(np.float32))
    b = torch.from_numpy(rng.randn(D, 1).astype(np.float32))
    st = (torch.zeros(1, 1),) * 3
    for d0 in range(0, D, 8):
        st = mma3(st, a[:, d0:d0 + 8], b[d0:d0 + 8], 3)
    s = (st[0] + st[1]) + st[2]
    exact = (a.double() @ b.double()).item()
    assert abs(s.item() - exact) <= BAR * (a.double().abs() @
                                           b.double().abs()).item()


# --------------------------------------------------------------------------
# the planner
# --------------------------------------------------------------------------
SMEM_MAX = 232448  # bytes of shared memory a block may use on sm_90


@pytest.mark.parametrize("S,blocks", [(64, 40), (128, 76), (192, 112)])
def test_main_path_plan(S, blocks):
    """The fixed-slot prefill buckets (B = 1, S = T, H = 28, KV = 4, D =
    128): 7 * S rows of each KV head in tiles of 48; at S = 192, 112
    blocks, one wave on 132 SMs."""
    plan = t_fa.plan_flash(1, S, S, 28, 4, 128)
    assert plan == ("flash_mma_kernel", 128, 48, blocks, 214272)
    assert plan.smem_bytes == t_fa.flash_smem_bytes(128) <= SMEM_MAX
    assert plan.grid <= 132
    assert plan.grid == -(-7 * S // plan.rows) * 4


# (B, S, T, H, KV, D, causal) -> (head_dim, grid, shared memory): every
# other shape chip_smoke.py checks, then head dimensions off the widths
@pytest.mark.parametrize("shape,want", [
    ((1, 37, 37, 28, 4, 128, True), (128, 24, 214272)),
    ((1, 20, 100, 28, 4, 128, True), (128, 12, 214272)),
    ((2, 50, 70, 28, 4, 128, False), (128, 64, 214272)),
    ((1, 16, 16, 4, 2, 16, True), (16, 2, 56576)),
    ((1, 13, 13, 4, 2, 37, True), (64, 2, 124160)),
    ((3, 5, 9, 6, 1, 1, True), (16, 3, 56576)),
    ((1, 8, 8, 2, 2, 32, False), (32, 2, 79104)),
    ((1, 200, 200, 64, 1, 128, True), (128, 267, 214272)),
    # the ViT-B/16 and DeiT-S/16 encoders at 64 images: 5 row tiles of
    # 197 rows for each of 768 / 384 (image, head) pairs
    ((64, 197, 197, 12, 12, 64, False), (64, 3840, 124160)),
    ((64, 197, 197, 6, 6, 64, False), (64, 1920, 124160)),
])
def test_plan_routes_pinned(shape, want):
    plan = t_fa.plan_flash(*shape)
    assert plan.kernel == "flash_mma_kernel" and plan.rows == 48
    assert (plan.head_dim, plan.grid, plan.smem_bytes) == want
    assert plan.smem_bytes <= SMEM_MAX
    assert plan.head_dim in t_fa.FLASH_WIDTHS and plan.head_dim >= shape[5]


def test_plan_refuses_wide_heads():
    with pytest.raises(ValueError, match="head_dim"):
        t_fa.plan_flash(1, 8, 8, 4, 4, 129)


def test_cpu_tensors_run_the_plain_version():
    """A CPU call counts no launch, through the GQA front-end as the model
    calls it, and equals the plain version."""
    rng = np.random.RandomState(11)
    qh, kh, vh = (torch.from_numpy(rng.randn(2, 24, h, 16).astype(
        np.float32)) for h in (4, 2, 2))
    before = (t_fa.flash_attention.launches,
              dict(t_fa.flash_attention.launches_by_kernel))
    got = tops.flash_attention_gqa(qh, kh, vh)
    assert (t_fa.flash_attention.launches,
            t_fa.flash_attention.launches_by_kernel) == before
    q = qh.transpose(1, 2).reshape(8, 24, 16)
    k, v = (x.transpose(1, 2).reshape(4, 24, 16) for x in (kh, vh))
    assert torch.equal(got.transpose(1, 2).reshape(8, 24, 16),
                       t_fa.flash_attention_plain(q, k, v))
