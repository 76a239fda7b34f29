"""The dense-weight kernels' plain versions vs the reference: ``abfp_qdq``,
``abfp_matmul`` and ``abfp_matmul_int8`` of the port against the reference
package's Pallas kernels (interpret mode) and its ``kernels.ref`` oracles,
on the same numpy inputs.

Tolerances, each with its reason:
  * ``abfp_qdq``: BIT-EQUAL to the reference's oracle ``abfp_qdq_ref``,
    every format — every operation (bf16 round of the group max, the
    divisions, round-half-even, frexp/ldexp) is correctly rounded on both
    stacks.  The reference's Pallas kernel itself differs from that oracle
    by one ulp of the scale: jitted, XLA turns its ``alpha / qmax`` into
    ``alpha * (1 / qmax)``.  The port divides, as the oracle does (and as
    its CUDA kernel must: the card holds it bit-exact to the plain
    version); the test pins the reference kernel to the port's arithmetic
    with that reciprocal scale, bit for bit, so the one difference is named.
  * the matmuls: rtol = atol = 1e-5 — the QDQ'd operands (or the integer
    codes and their exact group sums) are the same; only the f32 sum over
    K (fp path) or over the groups (int8 path) runs in another order.
"""

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jp
from repro.core.formats import get_format as j_get_format
from repro.kernels import abfp_qdq as j_qdq_mod
from repro.kernels import ops as jops
from repro.kernels import quant_matmul as j_mm
from repro.kernels import ref as jref
from repro_torch.core import policy as tp
from repro_torch.core.formats import IntFormat
from repro_torch.core.formats import get_format as t_get_format
from repro_torch.kernels import abfp_qdq as t_qdq_mod
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as t_mm
from repro_torch.kernels import ref as tref

FORMATS = ["int2", "int3", "int4", "int6", "int8", "e2m1", "e1m2", "e4m3",
           "e5m2"]


def _x(seed, M, K):
    """Activation-like values: normal, a few outlier columns, a zero row
    (its groups take the 1e-12 scale floor)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K) * (1 + 7 * (rng.rand(1, K) > 0.9))
    x[1] = 0.0
    return x.astype(np.float32)


def _close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def _qdq_reciprocal_scale(x: np.ndarray, fmt, n: int) -> np.ndarray:
    """The port's group QDQ with ``scale = alpha * (1 / qmax)`` in f32 —
    the scale XLA computes inside the reference's jitted kernel."""
    M, K = x.shape
    xg = torch.from_numpy(x).reshape(M, K // n, n)
    alpha = xg.abs().amax(dim=-1, keepdim=True)
    alpha = torch.clamp_min(alpha.to(torch.bfloat16).to(torch.float32),
                            1e-12)
    scale = alpha * torch.tensor(np.float32(1.0) / np.float32(fmt.qmax_pos))
    return (fmt.qdq_unit(xg / scale) * scale).reshape(M, K).numpy()


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("shape,n", [((16, 256), 64), ((8, 96), 32)])
def test_qdq_plain_bit_equal_to_reference(fmt, shape, n):
    x = _x(zlib.crc32(f"{fmt}/{n}".encode()) % 1000, *shape)
    before = t_qdq_mod.abfp_qdq.launches
    got = t_qdq_mod.abfp_qdq(torch.from_numpy(x), t_get_format(fmt), n=n)
    assert t_qdq_mod.abfp_qdq.launches == before  # CPU: the plain version
    oracle = jref.abfp_qdq_ref(jnp.asarray(x), j_get_format(fmt), n=n)
    assert np.array_equal(got.numpy(), np.asarray(oracle))
    port_oracle = tref.abfp_qdq_ref(torch.from_numpy(x), t_get_format(fmt),
                                    n=n)
    assert torch.equal(got, port_oracle)
    kernel = j_qdq_mod.abfp_qdq(jnp.asarray(x), j_get_format(fmt), n=n,
                                block_m=shape[0], block_k=shape[1],
                                interpret=True)
    assert np.array_equal(np.asarray(kernel),
                          _qdq_reciprocal_scale(x, t_get_format(fmt), n))
    # which is within one ulp of the scale of the port's result
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=2.4e-7,
                               atol=0)


def test_qdq_ref_along_axis0_and_ops_front_end():
    x = _x(5, 64, 48)
    for fmt in ("int4", "e4m3"):
        want = jref.abfp_qdq_ref(jnp.asarray(x), j_get_format(fmt), n=32,
                                 axis=0)
        got = tref.abfp_qdq_ref(torch.from_numpy(x), t_get_format(fmt),
                                n=32, axis=0)
        assert np.array_equal(got.numpy(), np.asarray(want))
    x3 = _x(6, 12, 128).reshape(3, 4, 128)
    want = jops.abfp_qdq(jnp.asarray(x3), j_get_format("int8"), n=64,
                         interpret=True)
    got = tops.abfp_qdq(torch.from_numpy(x3), t_get_format("int8"), n=64)
    assert got.shape == (3, 4, 128)
    assert np.array_equal(np.asarray(want).reshape(12, 128),
                          _qdq_reciprocal_scale(x3.reshape(12, 128),
                                                t_get_format("int8"), 64))
    assert np.array_equal(got.numpy(), np.asarray(
        jref.abfp_qdq_ref(jnp.asarray(x3), j_get_format("int8"), n=64)))


@pytest.mark.parametrize("fx,fw", [("int8", "int4"), ("int8", "int8"),
                                   ("e4m3", "int4"), ("e2m1", "e1m2")])
@pytest.mark.parametrize("mkn,n", [((16, 256, 48), 64), ((8, 192, 40), 32)])
def test_abfp_matmul_plain_vs_reference(fx, fw, mkn, n):
    M, K, N = mkn
    x = _x(M + N, M, K)
    w = (np.random.RandomState(K).randn(K, N) / np.sqrt(K)).astype(
        np.float32)
    jx, jw = j_get_format(fx), j_get_format(fw)
    tx, tw = t_get_format(fx), t_get_format(fw)
    want = j_mm.abfp_matmul(jnp.asarray(x), jnp.asarray(w), jx, jw, n=n,
                            block_m=M, block_n=N, block_k=K, interpret=True)
    before = t_mm.abfp_matmul.launches
    got = t_mm.abfp_matmul(torch.from_numpy(x), torch.from_numpy(w), tx, tw,
                           n=n)
    assert t_mm.abfp_matmul.launches == before
    _close(got, want)
    _close(got, jref.abfp_matmul_ref(jnp.asarray(x), jnp.asarray(w), jx, jw,
                                     n=n))
    _close(got, tref.abfp_matmul_ref(torch.from_numpy(x),
                                     torch.from_numpy(w), tx, tw, n=n))


@pytest.mark.parametrize("fx,fw", [("int8", "int4"), ("int8", "int8"),
                                   ("int4", "int4")])
@pytest.mark.parametrize("mkn,n", [((16, 256, 48), 64), ((8, 192, 40), 32),
                                   ((5, 64, 7), 16)])
def test_abfp_matmul_int8_plain_vs_reference(fx, fw, mkn, n):
    M, K, N = mkn
    x = _x(M * N, M, K)
    w = (np.random.RandomState(N).randn(K, N) / np.sqrt(K)).astype(
        np.float32)
    jx, jw = j_get_format(fx), j_get_format(fw)
    tx, tw = t_get_format(fx), t_get_format(fw)
    want = j_mm.abfp_matmul_int8(jnp.asarray(x), jnp.asarray(w), jx, jw,
                                 n=n, block_m=M, block_n=N, block_k=K,
                                 interpret=True)
    before = t_mm.abfp_matmul_int8.launches
    got = t_mm.abfp_matmul_int8(torch.from_numpy(x), torch.from_numpy(w),
                                tx, tw, n=n)
    assert t_mm.abfp_matmul_int8.launches == before
    _close(got, want)
    _close(got, jref.int8_matmul_ref(jnp.asarray(x), jnp.asarray(w), jx, jw,
                                     n=n))
    _close(got, tref.int8_matmul_ref(torch.from_numpy(x),
                                     torch.from_numpy(w), tx, tw, n=n))


def test_matmul_errors_match_reference():
    x = np.zeros((4, 100), np.float32)
    w = np.zeros((100, 8), np.float32)
    i8 = (j_get_format("int8"), t_get_format("int8"))
    for j_fn, t_fn in ((j_mm.abfp_matmul, t_mm.abfp_matmul),
                       (j_mm.abfp_matmul_int8, t_mm.abfp_matmul_int8)):
        with pytest.raises(ValueError) as je:
            j_fn(jnp.asarray(x), jnp.asarray(w), i8[0], i8[0], n=64,
                 interpret=True)
        with pytest.raises(ValueError) as te:
            t_fn(torch.from_numpy(x), torch.from_numpy(w), i8[1], i8[1],
                 n=64)
        assert str(te.value) == str(je.value)
        assert "not a multiple of the ABFP group length" in str(te.value)
        with pytest.raises(ValueError, match="contraction mismatch"):
            t_fn(torch.zeros(4, 64), torch.zeros(128, 8), i8[1], i8[1], n=64)
    with pytest.raises(ValueError, match="not a multiple"):
        t_qdq_mod.abfp_qdq(torch.zeros(2, 100), i8[1], n=64)
    with pytest.raises(TypeError, match="IntFormat"):
        tref.int8_matmul_ref(torch.zeros(2, 64), torch.zeros(64, 2),
                             t_get_format("e4m3"), i8[1])


@pytest.mark.parametrize("preset", ["w4a8_abfp", "w4a8_int8_native",
                                    "w4a4_e2m1"])
def test_fused_front_end_takes_leading_dims(preset):
    """``ops.abfp_matmul_fused`` on a (…, K) input, against the reference's
    wrapper (interpret mode); any M and N — here M = 3 * 5, N = 40."""
    x = _x(11, 15, 128).reshape(3, 5, 128)
    w = (np.random.RandomState(2).randn(128, 40) / 11.3).astype(np.float32)
    jpol = jp.preset(preset).replace(fused=True)
    tpol = tp.preset(preset).replace(fused=True)
    want = jops.abfp_matmul_fused(jnp.asarray(x), jnp.asarray(w), jpol,
                                  interpret=True)
    got = tops.abfp_matmul_fused(torch.from_numpy(x), torch.from_numpy(w),
                                 tpol)
    assert got.shape == (3, 5, 40)
    _close(got, want)
    with pytest.raises(ValueError, match="needs both x and w quantizers"):
        tops.abfp_matmul_fused(torch.from_numpy(x), torch.from_numpy(w),
                               tpol.replace(weight=None))


def test_format_args_describe_the_grid():
    """The kernels' description of a format is the format's own grid."""
    assert t_qdq_mod.format_args(t_get_format("int4")) == (1, 7.0, -7.0, 0,
                                                           0, 0)
    for name in ("e2m1", "e1m2", "e4m3", "e5m2"):
        f = t_get_format(name)
        assert t_qdq_mod.format_args(f) == (
            0, f.qmax_pos, 0.0, f.man_bits, f.min_normal_exp,
            f.max_biased_exp - f._bias)


# ---------------------------------------------------------------------------
# The decode regime's plan (pure Python: the CPU reaches it; the kernel runs
# it on the card)
# ---------------------------------------------------------------------------
# (K, N) of qwen2-7b's dense layers and lm_head; the reduced config's q
# (G = 1), wo (G = 2) and its ragged lm_head (N = 503)
DECODE_SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
                 (3584, 152064), (64, 64), (128, 64), (64, 503), (640, 77),
                 (64, 130)]


@pytest.mark.parametrize("n", [64, 32])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("K,N", DECODE_SHAPES)
def test_decode_plan_splits_whole_groups_and_fills_the_card(K, N, M, n):
    plan = t_mm.plan_abfp_matmul(M, N, K, n)
    assert plan.regime == "decode"
    assert plan.block_rows == (4 if M <= 4 else 8 if M <= 8 else 16)
    assert plan.block_rows >= M
    assert plan.tiles == -(-N // 64)
    G = K // n
    bounds = t_mm.split_bounds(G, plan.splits)
    # contiguous, non-empty runs of whole groups that cover K exactly
    assert bounds[0][0] == 0 and bounds[-1][1] == G
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert sum((hi - lo) * n for lo, hi in bounds) == K
    # at least two waves of blocks on 132 SMs, unless there are too few
    # groups
    blocks = plan.tiles * plan.splits
    assert blocks >= 2 * t_mm.SMS or plan.splits == G
    # no more splits than the planned waves need; beyond two waves, two
    # groups or more a split
    if plan.splits > 1:
        waves = t_mm.DECODE_WAVES * t_mm.SMS
        assert plan.tiles * (plan.splits - 1) < waves
        assert plan.tiles < waves  # a ticket buffer of that size suffices
        if plan.tiles * (plan.splits - 1) >= 2 * t_mm.SMS:
            assert all(hi - lo >= 2 for lo, hi in bounds)
    assert plan.smem_bytes <= 227 * 1024


def test_decode_plan_at_the_main_path_shapes():
    """The grids of a decode tick at M = 4, n = 64: up to eight waves of
    blocks, at least two groups a split beyond two waves."""
    grid = {(K, N): (p.tiles, p.splits) for K, N in DECODE_SHAPES[:5]
            for p in [t_mm.plan_abfp_matmul(4, N, K, 64)]}
    assert t_mm.DECODE_WAVES == 8
    assert grid[(3584, 512)] == (8, 33)       # k,v: two waves, 1-2 groups
    assert grid[(3584, 3584)] == (56, 19)     # q,o: 2-3 groups a split
    assert grid[(18944, 3584)] == (56, 19)    # wo: 15-16 groups a split
    assert grid[(3584, 18944)] == (296, 4)    # wi,wg
    assert grid[(3584, 152064)] == (2376, 1)  # lm_head needs no split
    # the shared memory the wrapper reckons is the ring's: 4 stages of an
    # (n, 64 + 4) w tile and a (BM, n) x tile
    p = t_mm.plan_abfp_matmul(4, 512, 3584, 64)
    assert p.smem_bytes == 4 * 4 * (64 * 68 + 4 * 64)
    p = t_mm.plan_abfp_matmul(16, 512, 3584, 32)
    assert p.smem_bytes == 4 * 4 * (32 * 68 + 16 * 32)
    assert max(t_mm.plan_abfp_matmul(M, 64, 64, n).smem_bytes
               for M in (1, 16) for n in t_mm.DECODE_GROUPS) <= 227 * 1024


@pytest.mark.parametrize("M", [17, 64, 192])
def test_more_than_16_rows_take_the_prefill_kernel(M):
    """The bf16 tensor-core contraction on its own plan: 64 x 128 tiles, K
    split into whole groups until the blocks fill the SMs, 4 ring stages
    of (64 + 128) rows of 64 bf16 codes (128 bytes, padded to 144) and
    192 scales."""
    plan = t_mm.plan_abfp_matmul(M, 3584, 3584, 64)
    mma = t_mm.plan_mma_contract(M, 3584, 3584, 64, "bf16")
    assert plan.regime == "prefill" and plan.n_pad == 64
    assert (plan.block_rows, plan.tiles, plan.splits, plan.smem_bytes) == (
        mma.block_rows, mma.tiles, mma.splits, mma.smem_bytes)
    assert plan.tiles == 28 * -(-M // 64)
    assert plan.splits == -(-t_mm.SMS // plan.tiles)
    assert plan.smem_bytes == 4 * (64 * 144 + 128 * 144 + 4 * 192)


def test_plan_falls_back_to_the_prefill_kernel_or_raises():
    # group lengths the decode kernel is not built for: the tensor cores,
    # on codes zero-padded to a multiple of 16
    for n in (8, 16, 40, 48, 128, 256, 512):
        plan = t_mm.plan_abfp_matmul(4, 64, 1024 // n * n, n)
        assert plan.regime == "prefill" and plan.n_pad == -(-n // 16) * 16
    assert t_mm.plan_abfp_matmul(16, 64, 512, 32).regime == "decode"
    # a format whose unit codes bf16 cannot hold: the f32 SIMT kernel, at
    # 64 rows a block, 32 where a long group would not fit, else it raises
    int12 = IntFormat(bits=12)
    fmts = (int12, t_get_format("int4"))
    assert t_mm.plan_abfp_matmul(4, 64, 480, 48, formats=fmts)[:2] == (
        "simt", 64)
    assert t_mm.plan_abfp_matmul(4, 64, 512, 64, formats=fmts)[0] == "decode"
    assert t_mm.plan_abfp_matmul(17, 64, 1024, 512, formats=fmts)[:2] == (
        "simt", 32)
    with pytest.raises(ValueError, match="more shared memory"):
        t_mm.plan_abfp_matmul(4, 64, 1024, 1024, formats=fmts)
    # K = 0: one empty split, the kernel writes zeros
    assert t_mm.plan_abfp_matmul(4, 64, 0, 64).splits == 1


@pytest.mark.parametrize("M,K,N,n", [(4, 3584, 512, 64), (16, 18944, 3584, 64),
                                     (1, 3584, 152064, 64), (3, 640, 77, 32),
                                     (20, 3584, 512, 64)])
def test_split_scratch_has_the_planned_size(M, K, N, n):
    plan = t_mm.plan_abfp_matmul(M, N, K, n)
    stream = M * K * N  # a stream of this case's own: a fresh buffer
    part = t_mm.split_partials(plan, M, N, "cpu", stream)
    if plan.splits == 1:
        assert part is None
    else:
        assert part.shape == (plan.splits * M * N,)
        assert part.dtype == torch.float32
        # one ticket per column tile, from a buffer of that many
        assert plan.tiles <= t_mm.DECODE_WAVES * t_mm.SMS


def test_split_scratch_is_kept_per_stream_and_grown():
    """Calls on one stream share one partials buffer, grown to the largest
    plan seen; another stream gets its own."""
    small = t_mm.plan_abfp_matmul(4, 512, 3584, 64)      # 33 splits
    large = t_mm.plan_abfp_matmul(16, 3584, 18944, 64)   # 19 splits
    stream = 0x5eed
    a = t_mm.split_partials(small, 4, 512, "cpu", stream)
    assert t_mm.split_partials(small, 4, 512, "cpu", stream) is a
    b = t_mm.split_partials(large, 16, 3584, "cpu", stream)
    assert b.numel() == large.splits * 16 * 3584 > a.numel()
    assert t_mm.split_partials(small, 4, 512, "cpu", stream) is b
    other = t_mm.split_partials(small, 4, 512, "cpu", stream + 1)
    assert other is not b and other.numel() == small.splits * 4 * 512


def _split_k_emulation(x, w, fx, fw, n, plan):
    """The decode kernel's arithmetic in PyTorch: per split, per group, the
    QDQ'd group product added to the split's sum once; the split sums
    added in split order."""
    M, K = x.shape
    xq = t_qdq_mod.abfp_qdq_plain(x, fx, n=n)
    wq = t_qdq_mod.abfp_qdq_plain(w.t().contiguous(), fw, n=n).t()
    y = torch.zeros((M, w.shape[1]))
    for lo, hi in t_mm.split_bounds(K // n, plan.splits):
        acc = torch.zeros_like(y)
        for g in range(lo, hi):
            k = slice(g * n, (g + 1) * n)
            acc = acc + xq[:, k] @ wq[k]
        y = y + acc
    return y


@pytest.mark.parametrize("fx,fw", [("int8", "int4"), ("e4m3", "e2m1")])
@pytest.mark.parametrize("M,K,N,n", [(4, 1024, 40, 64), (16, 512, 130, 32),
                                     (2, 64, 77, 64)])
def test_split_k_is_the_plain_function(fx, fw, M, K, N, n):
    """Cutting K as the plan does changes only the order of the f32 sum:
    the emulated kernel agrees with ``abfp_matmul_plain`` (and so with the
    reference) within 1e-5; a CPU tensor runs the plain version itself."""
    x = torch.from_numpy(_x(M * K, M, K))
    w = torch.from_numpy((np.random.RandomState(N).randn(K, N)
                          / np.sqrt(K)).astype(np.float32))
    tx, tw = t_get_format(fx), t_get_format(fw)
    plan = t_mm.plan_abfp_matmul(M, N, K, n)
    assert plan.regime == "decode"
    assert 1 <= plan.splits <= K // n
    want = t_mm.abfp_matmul_plain(x, w, tx, tw, n=n)
    _close(_split_k_emulation(x, w, tx, tw, n, plan), want)
    before = t_mm.abfp_matmul.launches
    got = t_mm.abfp_matmul(x, w, tx, tw, n=n)
    assert t_mm.abfp_matmul.launches == before
    assert torch.equal(got, want)
    _close(got, jref.abfp_matmul_ref(jnp.asarray(x.numpy()),
                                     jnp.asarray(w.numpy()),
                                     j_get_format(fx), j_get_format(fw), n=n))
