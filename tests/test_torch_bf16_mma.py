"""``abfp_matmul`` on the bf16 tensor cores, and every group length on the
card: the rule that sends a format to the bf16 contraction, the padded
code layouts, the planners at every (M, n), and an emulation of the
kernels' arithmetic against the plain versions and the reference package
on the same numpy inputs.

The kernels run only on the card (``chip_smoke.py`` holds them against
the plain versions there).  What they compute is pinned here: x = u sx and
w = v sw with u, v the unit codes ``qdq_unit`` returns, held as bf16 and
zero-padded per group to ``pad_group(n)``; each group's P = u . v formed
in K steps of 16 codes (one m16n8k16 MMA, f32 sums) and carried over the
group's chunks; ``(P * sx) * sw`` in f32, groups added in order within a
K split, the split partials in split order.

Tolerances: 1e-5 of the largest output against the plain versions and the
reference (the plain version multiplies QDQ'd values, the kernel rescales
each group's sum: they differ in f32 rounding and in summation order);
bit-equal where the arithmetic is the same: int codes on the bf16 path
against the int8 path's emulation (exact group sums, same grid, same fold
order), and padded against unpadded layouts of the plain contraction
(a zero code adds exactly 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.formats import get_format as j_get_format
from repro.kernels import ops as jkops
from repro.kernels import quant_matmul as j_mm
from repro.kernels import ref as jref
from repro_torch.core import abfp as abfp_mod
from repro_torch.core.formats import (BY_NAME, FloatFormat, IntFormat,
                                      representable_values)
from repro_torch.core.formats import get_format as t_get_format
from repro_torch.core.quantize import (div_by_constant, pack_int4_codes,
                                       unpack_int4_codes)
from repro_torch.kernels import quant_matmul as t_mm

INT8 = t_get_format("int8")


def _x(seed, M, K):
    """Activation-like values: normal, a few outlier columns, a zero row
    (its groups take the 1e-12 scale floor)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K) * (1 + 7 * (rng.rand(1, K) > 0.9))
    if M > 1:
        x[1] = 0.0
    return x.astype(np.float32)


def _w(seed, K, N):
    return (np.random.RandomState(seed).randn(K, N) / np.sqrt(K)).astype(
        np.float32)


def _within(got, want, frac=1e-5):
    """|got - want| <= frac * max |want|, everywhere."""
    got, want = np.asarray(got), np.asarray(want)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= frac * np.abs(want).max(), (err, np.abs(want).max())


# --------------------------------------------------------------------------
# which formats the bf16 contraction takes
# --------------------------------------------------------------------------
def _grid(fmt) -> torch.Tensor:
    """Every value the format's grid holds, both signs."""
    v = torch.from_numpy(representable_values(fmt).astype(np.float32))
    return torch.cat([v, -v])


def _round_trips(t: torch.Tensor) -> bool:
    return bool(torch.equal(t.to(torch.bfloat16).to(torch.float32), t))


@pytest.mark.parametrize("name", sorted(BY_NAME))
@settings(max_examples=60, deadline=None)
@given(data=st.data())
def test_unit_codes_round_trip_through_bf16(name, data):
    """Whatever a value scaled into the format's range (and beyond it, to
    be clipped) becomes under ``qdq_unit``, bf16 holds it exactly."""
    fmt = BY_NAME[name]
    top = float(fmt.qmax_pos) * 1.5
    vals = data.draw(st.lists(
        st.floats(-top, top, width=32, allow_subnormal=True),
        min_size=1, max_size=64))
    u = fmt.qdq_unit(torch.tensor(vals, dtype=torch.float32))
    assert _round_trips(u)
    assert _round_trips(fmt.qdq_unit(_grid(fmt)))
    assert t_mm.bf16_holds_codes(fmt)


# formats around the rule's edges, beside the named ones
EDGE_FORMATS = [IntFormat(bits=9), IntFormat(bits=9, narrow_range=False),
                IntFormat(bits=10), IntFormat(bits=12), IntFormat(bits=16),
                FloatFormat(exp_bits=5, man_bits=7),
                FloatFormat(exp_bits=6, man_bits=7),
                FloatFormat(exp_bits=4, man_bits=8),
                FloatFormat(exp_bits=5, man_bits=10),
                FloatFormat(exp_bits=3, man_bits=9)]


@pytest.mark.parametrize("fmt", list(BY_NAME.values()) + EDGE_FORMATS,
                         ids=lambda f: f"{f.name}-{getattr(f, 'qmin', '')}")
def test_planner_takes_simt_exactly_where_bf16_fails(fmt):
    """``abfp_matmul`` contracts on the bf16 tensor cores exactly when bf16
    holds every value of the format's grid, and on the f32 SIMT kernel
    otherwise (either operand's format); decode does not look."""
    holds = _round_trips(_grid(fmt))
    assert t_mm.bf16_holds_codes(fmt) == holds
    for formats in ((fmt, INT8), (INT8, fmt)):
        plan = t_mm.plan_abfp_matmul(64, 130, 512, 64, formats=formats)
        assert plan.regime == ("prefill" if holds else "simt")
        assert t_mm.plan_abfp_matmul(4, 130, 512, 64,
                                     formats=formats).regime == "decode"


# --------------------------------------------------------------------------
# planners at every group length
# --------------------------------------------------------------------------
@pytest.mark.parametrize("n", [8, 16, 24, 32, 40, 48, 64, 96, 128, 512])
@pytest.mark.parametrize("M", [1, 4, 16, 17, 64, 192])
def test_planners_at_every_group_length(M, n):
    """``plan_abfp_matmul`` (both entries) and ``quant_matmul_plan`` plan on
    the padded group length: the decode kernels up to 16 rows at n = 32,
    64, quant_decode_kernel up to 16 rows where the padded group is 16
    (packed 32) codes times a power of two, else the tensor-core
    contraction at K = G n_pad, whose ring fits in a block."""
    K, N = 8 * n, 3584
    G = K // n
    n_pad = -(-n // 16) * 16
    for int8 in (False, True):
        plan = t_mm.plan_abfp_matmul(M, N, K, n, int8=int8)
        if M <= 16 and n in (32, 64):
            assert plan.regime == "decode" and plan.n_pad == n
            continue
        mma = t_mm.plan_mma_contract(M, N, G * n_pad, n_pad,
                                     "int8" if int8 else "bf16")
        assert plan.regime == "prefill" and plan.n_pad == n_pad
        assert (plan.block_rows, plan.tiles, plan.splits,
                plan.smem_bytes) == (64, mma.tiles, mma.splits,
                                     mma.smem_bytes)
        assert mma.grid == (28, -(-M // 64), plan.splits)
        assert n_pad % mma.chunk == 0
        assert mma.chunk * (1 if int8 else 2) <= t_mm.MMA_CHUNK_MAX
        assert plan.smem_bytes <= 232448
    for packed in (False, True):
        q_pad = t_mm.pad_group(n, packed)
        assert q_pad == -(-n // (32 if packed else 16)) * (32 if packed
                                                          else 16)
        qp = t_mm.quant_matmul_plan(M, N, K, n, packed)
        lanes = q_pad // (32 if packed else 16)
        if M <= 16 and lanes & (lanes - 1) == 0:
            assert qp == t_mm.plan_quant_decode(M, N, G * q_pad, q_pad,
                                                packed)
            assert qp.smem_bytes <= 232448
        else:
            assert qp == t_mm.plan_int8_contract(M, N, G * q_pad, q_pad,
                                                 packed)


def test_bf16_ring_holds_64_codes_a_stage():
    """``mma_chunk`` counts bytes: a stage holds 128 bytes of a row's x
    codes, so 64 bf16 codes, and longer groups are cut in multiples of 16
    codes; int8 keeps 128 codes."""
    got = {n: t_mm.mma_chunk(n, code_bytes=2)
           for n in (16, 48, 64, 80, 96, 128, 160, 512)}
    assert got == {16: 16, 48: 48, 64: 64, 80: 16, 96: 48, 128: 64,
                   160: 32, 512: 64}
    assert t_mm.mma_chunk(128) == 128
    plan = t_mm.plan_mma_contract(192, 18944, 3584, 64, "bf16")
    assert plan.grid == (148, 3, 1) and plan.chunk == 64
    assert plan.smem_bytes == 4 * (64 * 144 + 128 * 144 + 4 * 192)
    with pytest.raises(ValueError, match="multiple of 16"):
        t_mm.plan_mma_contract(64, 64, 320, 40, "bf16")


# --------------------------------------------------------------------------
# the kernels' arithmetic
# --------------------------------------------------------------------------
def _unit_codes(a: torch.Tensor, fmt, n: int, n_pad: int):
    """quantize_rows_kernel / quantize_cols_kernel: (R, K) f32 -> unit codes
    (R, G, n_pad) as float64, zero in the pad, and scales (R, G) f32."""
    R, K = a.shape
    ag = a.reshape(R, K // n, n)
    alpha = ag.abs().amax(dim=-1)
    alpha = torch.clamp_min(alpha.to(torch.bfloat16).to(torch.float32), 1e-12)
    scale = div_by_constant(alpha, fmt.qmax_pos)
    u = fmt.qdq_unit(ag / scale[..., None])
    out = torch.zeros((R, K // n, n_pad), dtype=torch.float64)
    out[..., :n] = u.to(torch.float64)
    return out, scale


def _contract(xc, sx, wc, sw, plan, step, exact):
    """``mma_contract_kernel``'s arithmetic: xc (M, G, n_pad) and wc (N, G,
    n_pad) codes, sx (M, G), sw (N, G).  Per split, per group: K steps of
    ``step`` codes (one MMA each), the group sum carried over them, exact
    (int32) or rounded to f32 after every step (f32 sums on the bf16 tensor
    cores); then ((float)P * sx) * sw, groups in order, splits in order."""
    M, G, _ = xc.shape
    N = wc.shape[0]
    partials = []
    for lo, hi in t_mm.split_bounds(G, plan.splits):
        acc = torch.zeros((M, N))
        for g in range(lo, hi):
            P = torch.zeros((M, N), dtype=torch.float64)
            for k in range(0, xc.shape[2], step):
                P = P + xc[:, g, k:k + step] @ wc[:, g, k:k + step].t()
                if not exact:
                    P = P.to(torch.float32).to(torch.float64)
            if exact:
                assert P.abs().max() < 2 ** 24
            P = P.to(torch.float32)
            acc = acc + (P * sx[:, g, None]) * sw[None, :, g]
        partials.append(acc)
    y = partials[0]
    for p in partials[1:]:
        y = y + p
    return y


def _bf16_emulation(x, w, fx, fw, n):
    M, K = x.shape
    N = w.shape[1]
    plan = t_mm.plan_abfp_matmul(M, N, K, n, formats=(fx, fw))
    assert plan.regime == "prefill"
    u, sx = _unit_codes(x, fx, n, plan.n_pad)
    v, sw = _unit_codes(w.t().contiguous(), fw, n, plan.n_pad)
    # bf16 holds every code: the operands the MMAs read are these values
    assert torch.equal(u.to(torch.bfloat16).to(torch.float64), u)
    assert torch.equal(v.to(torch.bfloat16).to(torch.float64), v)
    return _contract(u, sx, v, sw, plan, 16, exact=False)


def _int8_emulation(x, w, fx, fw, n):
    """abfp_matmul_int8's prefill regime on the same (padded) layout: int8
    codes, K steps of 32 codes and one of 16 where a chunk leaves it."""
    M, K = x.shape
    N = w.shape[1]
    plan = t_mm.plan_abfp_matmul(M, N, K, n, int8=True)
    u, sx = _unit_codes(x, fx, n, plan.n_pad)
    v, sw = _unit_codes(w.t().contiguous(), fw, n, plan.n_pad)
    return _contract(u, sx, v, sw, plan, 16, exact=True)


FP_FORMATS = [("int4", "int8"), ("e2m1", "e4m3"), ("e5m2", "e5m2")]
FP_GROUPS = [8, 16, 40, 64, 512]


@pytest.mark.parametrize("n", FP_GROUPS)
@pytest.mark.parametrize("fx,fw", FP_FORMATS)
def test_bf16_emulation_is_the_plain_function(fx, fw, n):
    """The emulated three launches against ``abfp_matmul_plain`` and the
    reference's oracle ``abfp_matmul_ref`` (and the port's), within 1e-5 of
    the largest output, at M = 20 (above 16 rows)."""
    M, N = 20, 24
    K = max(2 * n, 1024 if n == 512 else 0)
    x, w = _x(M + n, M, K), _w(N + n, K, N)
    tx, tw = t_get_format(fx), t_get_format(fw)
    got = _bf16_emulation(torch.from_numpy(x), torch.from_numpy(w), tx, tw, n)
    want = t_mm.abfp_matmul_plain(torch.from_numpy(x), torch.from_numpy(w),
                                  tx, tw, n=n)
    _within(got.numpy(), want.numpy())
    _within(got.numpy(), jref.abfp_matmul_ref(
        jnp.asarray(x), jnp.asarray(w), j_get_format(fx), j_get_format(fw),
        n=n))


@pytest.mark.parametrize("n", FP_GROUPS)
@pytest.mark.parametrize("fx,fw", FP_FORMATS)
def test_bf16_emulation_is_the_reference_kernel(fx, fw, n):
    """Against the reference's Pallas ``abfp_matmul`` (interpret mode) at a
    tiny shape, within 1e-5 of the largest output."""
    M, N = 18, 8
    K = 2 * n
    x, w = _x(3 * n + 1, M, K), _w(5 * n, K, N)
    want = j_mm.abfp_matmul(jnp.asarray(x), jnp.asarray(w),
                            j_get_format(fx), j_get_format(fw), n=n,
                            block_m=jkops.fit_block(M),
                            block_n=jkops.fit_block(N), block_k=K,
                            interpret=True)
    got = _bf16_emulation(torch.from_numpy(x), torch.from_numpy(w),
                          t_get_format(fx), t_get_format(fw), n)
    _within(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", FP_GROUPS)
@pytest.mark.parametrize("fx,fw", [("int8", "int4"), ("int8", "int8"),
                                   ("int4", "int4")])
def test_int_codes_on_bf16_are_the_int8_kernel(fx, fw, n):
    """For int formats every group sum is exact on both paths, on the same
    grid, folded in the same order: the bf16 emulation is bit for bit the
    int8 path's, within 1e-5 of ``abfp_matmul_int8_plain`` (which sums its
    groups in another order), and bit for bit that too at K = n."""
    tx, tw = t_get_format(fx), t_get_format(fw)
    M, N = 33, 40
    for K in (n, 4 * n if n < 512 else 1024):
        x = torch.from_numpy(_x(K + n, M, K))
        w = torch.from_numpy(_w(K * 3 + n, K, N))
        got = _bf16_emulation(x, w, tx, tw, n)
        assert torch.equal(got, _int8_emulation(x, w, tx, tw, n))
        want = t_mm.abfp_matmul_int8_plain(x, w, tx, tw, n=n)
        if K == n:
            assert torch.equal(got, want)
        else:
            _within(got.numpy(), want.numpy())


# --------------------------------------------------------------------------
# zero-padded layouts
# --------------------------------------------------------------------------
PAD_GROUPS = [8, 24, 40, 48]


def _stored(seed, N, G, n, packed):
    rng = np.random.RandomState(seed)
    lo, hi = (-8, 8) if packed else (-128, 128)
    codes = rng.randint(lo, hi, size=(N, G, n)).astype(np.int8)
    scales = (rng.rand(N, G) * 0.02 + 1e-3).astype(np.float32)
    return codes, scales


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("n", PAD_GROUPS)
def test_quant_matmul_padded_layout_is_the_plain_function(n, packed):
    """quant_matmul's codes as the kernels read them (x's written padded,
    the stored weight copied into a padded buffer): the plain contraction
    on the padded layout is bit for bit the unpadded plain version, the
    emulated kernel (quant_decode_kernel's plan below 16 rows, the tensor
    cores above) within 1e-5, and both match the reference's Pallas
    kernel."""
    n_pad = t_mm.pad_group(n, packed)
    for M, K, N in ((4, 4 * n, 24), (40, 6 * n, 24)):
        G = K // n
        x = _x(M * n + K, M, K)
        c, s = _stored(N + n + M, N, G, n, packed)
        codes, scales = torch.from_numpy(c), torch.from_numpy(s)
        stored = pack_int4_codes(codes) if packed else codes
        padded = t_mm.pad_group_codes(stored, n, packed)
        assert padded.shape == (N, G, n_pad // 2 if packed else n_pad)
        wk = unpack_int4_codes(padded) if packed else padded
        assert torch.equal(wk[:, :, :n], codes) and not wk[:, :, n:].any()
        xt = torch.from_numpy(x)
        xc, sx, _ = abfp_mod.abfp_quantize(xt, INT8, axis=-1, n=n,
                                           dtype=torch.float32)
        xp = torch.zeros((M, G, n_pad))
        xp[..., :n] = xc
        want = t_mm.quant_matmul_plain(xt, stored, scales, INT8, n=n,
                                       packed=packed)
        bound = 8.0 if packed else 128.0
        assert torch.equal(t_mm.group_contract(
            xp, sx, wk, scales, max_abs_product=127.0 * bound), want)
        plan = t_mm.quant_matmul_plan(M, N, K, n, packed)
        decode = M <= 16 and (n_pad // (32 if packed else 16)) in (1, 2, 4)
        assert isinstance(plan, t_mm.QuantDecodePlan if decode
                          else t_mm.MmaPlan)
        got = _contract(xp.to(torch.float64), sx, wk.to(torch.float64),
                        scales, plan, 16, exact=True)
        _within(got.numpy(), want.numpy())
        ref = j_mm.quant_matmul(jnp.asarray(x), jnp.asarray(c),
                                jnp.asarray(s), j_get_format("int8"), n=n,
                                block_m=jkops.fit_block(M),
                                block_n=jkops.fit_block(N), block_k=K,
                                interpret=True)
        _within(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("n", PAD_GROUPS)
@pytest.mark.parametrize("fw", ["int4", "int8"])
def test_abfp_int8_padded_layout_is_the_plain_function(fw, n):
    """abfp_matmul_int8's prefill regime on codes zero-padded to
    ``pad_group(n)``: the plain contraction on that layout is bit for bit
    the unpadded plain version, the emulated kernel within 1e-5, and both
    match the reference's oracle ``int8_matmul_ref``."""
    tx, tw = INT8, t_get_format(fw)
    n_pad = t_mm.pad_group(n)
    for M, K, N in ((4, 4 * n, 24), (40, 6 * n, 24)):
        x = torch.from_numpy(_x(M + K, M, K))
        w = torch.from_numpy(_w(K + n, K, N))
        want = t_mm.abfp_matmul_int8_plain(x, w, tx, tw, n=n)
        u, sx = _unit_codes(x, tx, n, n_pad)
        v, sw = _unit_codes(w.t().contiguous(), tw, n, n_pad)
        assert torch.equal(t_mm.group_contract(
            u, sx, v, sw, max_abs_product=127.0 * tw.qmax_pos), want)
        got = _int8_emulation(x, w, tx, tw, n)
        _within(got.numpy(), want.numpy())
        oracle = jref.int8_matmul_ref(jnp.asarray(x.numpy()),
                                      jnp.asarray(w.numpy()),
                                      j_get_format("int8"),
                                      j_get_format(fw), n=n)
        _within(got.numpy(), np.asarray(oracle))
