"""Port matmul chokepoint vs the reference.

Tolerances, each with its reason:
  * ``ref`` backend: rtol 1e-5 (+ atol 1e-5 near zero) — both stacks QDQ
    identically and differ only in f32 summation order of the matmul.
  * plain ``quant_matmul`` vs the reference's Pallas kernel run in
    interpret mode, and vs ``_compressed_group_matmul``: the integer group
    sums are exact on both sides; the f32 sum across groups runs in another
    order — rtol 1e-5 (+ atol scaled to the output magnitude).
  * port ``int8`` backend vs port compressed-aligned path: EQUAL (the
    reference's own pin).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jp
from repro.core import simulate as jsim
from repro.core.formats import get_format as j_get_format
from repro.kernels import ops as jkops
from repro.kernels.quant_matmul import quant_matmul as j_quant_matmul
from repro.models import serving_transforms as jst
from repro_torch.core import policy as tp
from repro_torch.core import simulate as tsim
from repro_torch.core.formats import get_format as t_get_format
from repro_torch.kernels import ops as tkops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.models import serving_transforms as tst


def _close(got, want, rtol=1e-5):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _xw(seed, M=12, K=200, N=40):
    rng = np.random.RandomState(seed)
    x = (rng.randn(M, K) * (1 + 4 * (rng.rand(1, K) > 0.95))).astype(
        np.float32)
    w = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("preset", [
    "fp32", "w4a8_abfp", "w4a4_abfp", "w4a4_e2m1", "w4_ae4m3_abfp",
    "w4a8_mse", "w4a16", "w8a8_int8_native", "w4a8_int8_native"])
def test_qmatmul_dense_backends(preset):
    x, w = _xw(1)
    want = jsim.qmatmul(jnp.asarray(x), jnp.asarray(w), jp.preset(preset))
    pol = tp.preset(preset)
    got = tsim.qmatmul(torch.from_numpy(x), torch.from_numpy(w), pol)
    assert (tsim.execution_backend(pol, torch.from_numpy(w)).name
            == jsim.execution_backend(jp.preset(preset),
                                      jnp.asarray(w)).name)
    _close(got, want)


def test_qmatmul_output_quantizer_and_batched_input():
    x, w = _xw(2)
    x3 = x.reshape(3, 4, -1)
    jq = jp.preset("w4a8_abfp")
    tq = tp.preset("w4a8_abfp")
    want = jsim.qmatmul(jnp.asarray(x3), jnp.asarray(w),
                        jq.replace(output=jq.input.replace(group=8)))
    got = tsim.qmatmul(torch.from_numpy(x3), torch.from_numpy(w),
                       tq.replace(output=tq.input.replace(group=8)))
    assert got.shape == (3, 4, 40)
    # the output QDQ turns a last-bit difference into at most one int8
    # step of its group: compare at that granularity
    step = float(np.abs(np.asarray(want)).max()) / 127
    assert np.abs(got.numpy() - np.asarray(want)).max() <= step * 1.01
    assert (np.abs(got.numpy() - np.asarray(want)) <= 1e-5).mean() > 0.98


def test_dense_fused_backend_raises_naming_the_roadmap():
    x, w = _xw(3)
    pol = tp.preset("w4a8_abfp").replace(fused=True)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue B"):
        tsim.qmatmul(torch.from_numpy(x), torch.from_numpy(w), pol)
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue B"):
        tsim.attn_backends()["fused"].fn()


@pytest.mark.parametrize("fmt", ["int4", "int8"])
@pytest.mark.parametrize("n", [32, 64])
@pytest.mark.parametrize("mkn", [(16, 128, 48), (8, 256, 24)])
def test_plain_quant_matmul_vs_reference_kernel_interpret(fmt, n, mkn):
    M, K, N = mkn
    x, w = _xw(n + M, M, K, N)
    from repro.core.abfp import abfp_quantize as j_abfp_quantize

    codes, scales, _ = j_abfp_quantize(jnp.asarray(w), j_get_format(fmt),
                                       axis=0, n=n, dtype=jnp.int8)
    want = j_quant_matmul(
        jnp.asarray(x), codes, scales.astype(jnp.float32),
        j_get_format("int8"), n=n, block_m=jkops.fit_block(M),
        block_n=jkops.fit_block(N), interpret=True)
    tcodes = torch.from_numpy(np.array(codes))
    tscales = torch.from_numpy(np.asarray(scales, np.float32))
    got = tqm.quant_matmul(torch.from_numpy(x), tcodes, tscales,
                           t_get_format("int8"), n=n)
    _close(got, want)
    if fmt == "int4":  # the packed entry computes the same function
        from repro_torch.core.quantize import pack_int4_codes

        got_p = tqm.quant_matmul(torch.from_numpy(x),
                                 pack_int4_codes(tcodes), tscales,
                                 t_get_format("int8"), n=n, packed=True)
        assert torch.equal(got_p, got)


@pytest.mark.parametrize("fmt", ["int4", "int8"])
def test_fused_policy_routes_compressed_kernel(fmt):
    """policy.fused + compressed weights: the compressed backend hands the
    aligned int path to quant_matmul (through the padding wrapper), on both
    stacks; K = 200 pads to the 64-group."""
    x, w = _xw(5, 10, 200, 32)
    jtq = jp.TensorQuant(fmt, scaler="abfp", group=64)
    ttq = tp.TensorQuant(fmt, scaler="abfp", group=64)
    jin = jp.TensorQuant("int8", scaler="abfp", group=64)
    tin = tp.TensorQuant("int8", scaler="abfp", group=64)
    jpol = jp.QuantPolicy(name="t", input=jin, weight=jtq, fused=True)
    tpol = tp.QuantPolicy(name="t", input=tin, weight=ttq, fused=True)
    jck = jst.compress_kernel(jnp.asarray(w), jtq)
    tck = tst.compress_kernel(torch.from_numpy(w), ttq)
    want = jsim.qmatmul(jnp.asarray(x), jck, jst.serving_policy(jpol))
    before = tqm.quant_matmul.launches
    got = tsim.qmatmul(torch.from_numpy(x), tck, tst.serving_policy(tpol))
    assert tqm.quant_matmul.launches == before  # CPU tensor: plain version
    _close(got, want)
    # and against the reference's non-kernel compressed path
    want2 = jsim._compressed_group_matmul(
        jnp.asarray(x), jck, jpol.replace(fused=False), site="",
        in_alpha=None)
    _close(got, want2)
    # the wrapper itself, batched input
    got3 = tkops.quant_matmul_fused(torch.from_numpy(x).reshape(2, 5, 200),
                                    tck, tin)
    assert torch.equal(got3.reshape(10, 32), got)


@pytest.mark.parametrize("wfmt", ["int4", "int8"])
def test_int8_backend_equals_compressed_aligned_path(wfmt):
    x, w = _xw(6, 9, 256, 48)
    tin = tp.TensorQuant("int8", scaler="abfp", group=64)
    tw = tp.TensorQuant(wfmt, scaler="abfp", group=64)
    pol = tp.QuantPolicy(name="t", input=tin, weight=tw, compute="int8")
    native = tsim.qmatmul(torch.from_numpy(x), torch.from_numpy(w), pol)
    ck = tst.compress_kernel(torch.from_numpy(w), tw)
    served = tsim.qmatmul(torch.from_numpy(x), ck, tst.serving_policy(pol))
    assert torch.equal(native, served)
    # and the plain version of the kernel is that same arithmetic
    fused = tsim.qmatmul(torch.from_numpy(x), ck,
                         tst.serving_policy(pol.replace(fused=True)))
    assert torch.equal(fused, served)


@pytest.mark.parametrize("preset", ["w4_ae4m3_abfp", "w4a8_mse", "w4a16"])
def test_compressed_unaligned_path(preset):
    """Inputs that are not int-ABFP of the stored group QDQ x per their
    rule and contract fp activations against the codes."""
    x, w = _xw(7, 6, 200, 24)
    jck = jst.compress_kernel(jnp.asarray(w), jp.preset(preset).weight)
    tck = tst.compress_kernel(torch.from_numpy(w), tp.preset(preset).weight)
    want = jsim.qmatmul(jnp.asarray(x), jck,
                        jst.serving_policy(jp.preset(preset)))
    got = tsim.qmatmul(torch.from_numpy(x), tck,
                       tst.serving_policy(tp.preset(preset)))
    _close(got, want)


def test_quant_matmul_shape_errors():
    x = torch.zeros(4, 128)
    codes = torch.zeros(8, 2, 64, dtype=torch.int8)
    scales = torch.ones(8, 2)
    fmt = t_get_format("int8")
    with pytest.raises(ValueError, match="stored group length"):
        tqm.quant_matmul(x, codes, scales, fmt, n=32)
    with pytest.raises(ValueError, match="but x has K"):
        tqm.quant_matmul(torch.zeros(4, 192), codes, scales, fmt, n=64)
    with pytest.raises(ValueError, match="w_scales shape"):
        tqm.quant_matmul(x, codes, torch.ones(8, 3), fmt, n=64)


def test_fit_block_matches_reference():
    for dim, start, mult in [(96, 64, 1), (4096, 512, 64), (24, 256, 1),
                             (192, 512, 64), (7, 256, 1)]:
        assert tkops.fit_block(dim, start, mult) == \
            jkops.fit_block(dim, start, mult)
    with pytest.raises(ValueError, match="not a multiple"):
        tkops.fit_block(100, 64, 64)
