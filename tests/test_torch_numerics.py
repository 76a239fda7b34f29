"""Port numerics vs the reference package: formats, QDQ, ABFP, INT4 packing.

The same numpy inputs go through ``repro`` (JAX, CPU) and ``repro_torch``
(PyTorch, CPU).  Everything here is held BIT-EXACT: the reference pins these
bit patterns (format grids, bf16 scales, round-half-even codes, nibble
packing), so any tolerance would hide a real divergence.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import abfp as j_abfp
from repro.core import formats as j_formats
from repro.core import quantize as j_quant
from repro_torch.core import abfp as t_abfp
from repro_torch.core import formats as t_formats
from repro_torch.core import quantize as t_quant

FORMATS = sorted(j_formats.BY_NAME)
INT_FORMATS = [n for n in FORMATS if n.startswith("int")]


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def assert_same_bits(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_array_equal(_bits(got), _bits(np.asarray(want)))


def _adversarial(fmt, rng) -> np.ndarray:
    """Random values over the format's range plus ties, grid points,
    subnormals, zeros, powers of two and out-of-range magnitudes."""
    grid = j_formats.representable_values(fmt).astype(np.float32)
    mids = (grid[:-1] + grid[1:]) / 2  # exact ties between neighbours
    pows = 2.0 ** np.arange(-20, 18, dtype=np.float32)
    special = np.concatenate([
        grid, mids, np.nextafter(mids, np.inf), np.nextafter(mids, -np.inf),
        pows, np.nextafter(pows, 0), [0.0, 1e-30, 1e-12, 1e6, 3e38],
    ]).astype(np.float32)
    rand = (rng.randn(4096) * fmt.qmax_pos / 2).astype(np.float32)
    x = np.concatenate([special, -special, rand])
    return x.astype(np.float32)


def test_registries_match():
    assert sorted(t_formats.BY_NAME) == FORMATS
    for name in FORMATS:
        j, t = j_formats.get_format(name), t_formats.get_format(name)
        assert (j.name, j.bits, j.qmax_pos) == (t.name, t.bits, t.qmax_pos)
        np.testing.assert_array_equal(j_formats.representable_values(j),
                                      t_formats.representable_values(t))


@pytest.mark.parametrize("name", FORMATS)
def test_qdq_unit_bit_exact(name):
    rng = np.random.RandomState(sum(map(ord, name)))
    x = _adversarial(j_formats.get_format(name), rng)
    want = j_formats.get_format(name).qdq_unit(jnp.asarray(x))
    got = t_formats.get_format(name).qdq_unit(torch.from_numpy(x))
    assert_same_bits(got, want)


@pytest.mark.parametrize("name", FORMATS)
def test_qdq_unit_lands_on_grid(name):
    fmt = t_formats.get_format(name)
    rng = np.random.RandomState(1)
    x = torch.from_numpy(_adversarial(j_formats.get_format(name), rng))
    y = fmt.qdq_unit(x).abs().numpy()
    grid = t_formats.representable_values(fmt).astype(np.float32)
    assert np.isin(y, grid).all()


@pytest.mark.parametrize("name", FORMATS)
def test_qdq_bit_exact(name):
    rng = np.random.RandomState(7)
    x = (rng.randn(64, 96) * 3).astype(np.float32)
    x[3] = 0.0
    for alpha in (np.float32(2.5), np.abs(x).max(-1, keepdims=True),
                  np.float32(0.0)):
        want = j_quant.qdq(jnp.asarray(x), jnp.asarray(alpha),
                           j_formats.get_format(name))
        got = t_quant.qdq(torch.from_numpy(x), torch.as_tensor(alpha),
                          t_formats.get_format(name))
        assert_same_bits(got, want)


@pytest.mark.parametrize("name", INT_FORMATS)
def test_quantize_dequantize_equal(name):
    rng = np.random.RandomState(11)
    x = (rng.randn(32, 128) * 2).astype(np.float32)
    alpha = np.abs(x).max(-1, keepdims=True)
    jc, js = j_quant.quantize(jnp.asarray(x), jnp.asarray(alpha),
                              j_formats.get_format(name))
    tc, ts = t_quant.quantize(torch.from_numpy(x), torch.from_numpy(alpha),
                              t_formats.get_format(name))
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_same_bits(ts, js)
    assert_same_bits(t_quant.dequantize(tc, ts), j_quant.dequantize(jc, js))


def test_int4_pack_unpack_equal():
    rng = np.random.RandomState(5)
    codes = rng.randint(-8, 8, size=(7, 5, 64)).astype(np.int8)
    jp = j_quant.pack_int4_codes(jnp.asarray(codes))
    tp = t_quant.pack_int4_codes(torch.from_numpy(codes))
    assert tp.dtype == torch.uint8
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(t_quant.unpack_int4_codes(tp).numpy(),
                                  codes)
    np.testing.assert_array_equal(
        t_quant.unpack_int4_codes(tp).numpy(),
        np.asarray(j_quant.unpack_int4_codes(jp)))
    with pytest.raises(ValueError, match="even last dim"):
        t_quant.pack_int4_codes(torch.zeros((2, 3), dtype=torch.int8))


def _abfp_input(rng, shape):
    x = (rng.randn(*shape) * rng.rand(*shape[:-1], 1) * 4).astype(np.float32)
    x[0, :64] = 0.0  # an all-zero group: scale floors at 1e-12
    # group maxima that sit exactly between two bf16 values (ties)
    x[1, 0] = np.float32(1.0 + 2.0 ** -8)
    x[1, 1:64] *= 0.1
    x[2, 0] = np.float32(1.0 + 3 * 2.0 ** -8)
    x[2, 1:64] *= 0.1
    return x


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("k,n,axis", [(256, 64, -1), (200, 64, -1),
                                      (96, 32, 0), (100, 16, 1)])
def test_abfp_qdq_bit_exact(name, k, n, axis):
    rng = np.random.RandomState(k + n)
    shape = (k, 70) if axis == 0 else (70, k)
    x = _abfp_input(rng, shape if axis != 0 else (70, k))
    if axis == 0:
        x = np.ascontiguousarray(x.T)
    want = j_abfp.abfp_qdq(jnp.asarray(x), j_formats.get_format(name),
                           axis=axis, n=n)
    got = t_abfp.abfp_qdq(torch.from_numpy(x), t_formats.get_format(name),
                          axis=axis, n=n)
    assert got.shape == x.shape
    assert_same_bits(got, want)


@pytest.mark.parametrize("scale_dtype", ["bfloat16", "float32", "float16"])
def test_abfp_scales_bit_exact(scale_dtype):
    rng = np.random.RandomState(3)
    x = _abfp_input(rng, (40, 200))  # K = 200 pads to 256
    want = j_abfp.abfp_scales(jnp.asarray(x), n=64,
                              scale_dtype=jnp.dtype(scale_dtype))
    got = t_abfp.abfp_scales(torch.from_numpy(x), n=64,
                             scale_dtype=getattr(torch, scale_dtype))
    assert_same_bits(got, want)


@pytest.mark.parametrize("name", INT_FORMATS)
def test_abfp_quantize_equal(name):
    rng = np.random.RandomState(9)
    x = _abfp_input(rng, (24, 200))
    jc, js, jmeta = j_abfp.abfp_quantize(
        jnp.asarray(x), j_formats.get_format(name), n=64)
    tc, ts, tmeta = t_abfp.abfp_quantize(
        torch.from_numpy(x), t_formats.get_format(name), n=64)
    assert tuple(tmeta) == tuple(jmeta) == (56, 200)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert_same_bits(ts, js)


def test_qdq_ste_forward_and_gradient():
    import jax

    rng = np.random.RandomState(13)
    x = (rng.randn(16, 64) * 2).astype(np.float32)
    alpha = np.float32(1.5)
    jf = j_formats.get_format("int4")
    tf = t_formats.get_format("int4")
    want, vjp = jax.vjp(lambda v: j_quant.qdq_ste(v, jnp.asarray(alpha), jf),
                        jnp.asarray(x))
    g = rng.randn(16, 64).astype(np.float32)
    (want_g,) = vjp(jnp.asarray(g))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = t_quant.maybe_ste(xt, torch.as_tensor(alpha), tf, ste=True)
    got.backward(torch.from_numpy(g))
    assert_same_bits(got, want)
    assert_same_bits(xt.grad, want_g)
    # ste=False is the plain QDQ
    assert_same_bits(
        t_quant.maybe_ste(torch.from_numpy(x), alpha, tf, ste=False), want)
