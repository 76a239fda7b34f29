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
