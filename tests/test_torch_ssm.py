"""The Mamba2 block of the port vs the reference, on the same numpy inputs
and weights: ``softplus``, ``_segsum_exp``, ``RMSNormGated``,
``Mamba2.apply`` (S below, at and across the chunk, and below d_conv - 1),
its ``return_cache`` and ``decode_step``, under fp32, w4a8_abfp (ref
backend) and the fused P-fp / P-int8 policies (every projection through
``abfp_matmul`` / ``abfp_matmul_int8``; on the CPU the wrappers run their
plain versions, the reference its Pallas kernels in interpret mode), and
with compressed projections (``quant_matmul``).

Tolerances: fp32 outputs and states rtol 1e-5, atol 1e-6 (f32 einsums and
the chunk cumsum sum in another order: they are not bit-pinned); quantized
outputs rtol 1e-4, atol 1e-5 (the codes agree at this size, given the same
inputs); ``softplus`` and ``_segsum_exp`` within 1 ulp (rtol 2e-7, and
atol the least normal f32: XLA on the CPU flushes subnormal results to
0).  The reference's block runs jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jp
from repro.models import serving_transforms as jst
from repro.nn import norms as j_norms
from repro.nn import ssm as j_ssm
from repro.nn.module import unbox
from repro_torch.core import policy as tp
from repro_torch.kernels import quant_matmul as t_qm
from repro_torch.models import serving_transforms as tst
from repro_torch.nn import norms as t_norms
from repro_torch.nn import ssm as t_ssm

N_GROUP = 16  # divides d_model (32) and d_inner (64)
DIMS = dict(d_model=32, d_state=16, head_dim=16, chunk=8)
FP32 = dict(rtol=1e-5, atol=1e-6)
QDQ = dict(rtol=1e-4, atol=1e-5)
POLICIES = ("fp32", "w4a8_abfp", "p_fp", "p_int8")


def _policy(mod, name):
    if name == "fp32":
        return mod.preset("fp32")
    fused = lambda p: mod.map_policies(p, lambda q: q.replace(fused=True))
    if name == "p_fp":
        return fused(mod.preset("w4a8_abfp", n=N_GROUP))
    if name == "p_int8":
        return fused(mod.preset("w4a8_int8_native", n=N_GROUP))
    return mod.preset(name, n=N_GROUP)


def _tol(name):
    return FP32 if name == "fp32" else QDQ


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _block(groups):
    """The reference's Mamba2 with ``groups`` B/C groups and its weights,
    and the port's with the same weights."""
    kw = dict(DIMS, n_groups=groups)
    jm = j_ssm.Mamba2(**kw)
    jparams = jax.device_get(unbox(jm.init(jax.random.PRNGKey(3))))
    # a nonzero conv bias and spread-out dt_bias / D exercise every term
    rng = np.random.RandomState(4)
    jparams["conv_b"] = rng.randn(jm.conv_channels).astype(np.float32) * 0.1
    jparams["dt_bias"] = rng.randn(jm.n_heads).astype(np.float32) - 2.0
    jparams["D"] = rng.rand(jm.n_heads).astype(np.float32) + 0.5
    return jm, jparams, t_ssm.Mamba2(**kw), _to_torch(jparams)


@pytest.fixture(scope="module")
def blocks():
    return {g: _block(g) for g in (1, 2)}


def _x(S, seed=0, B=2):
    return np.random.RandomState(seed).randn(B, S, DIMS["d_model"]).astype(
        np.float32)


def _jit_apply(jm, policy, **kw):
    """The reference block's ``apply`` under ``policy``, jitted (op by op
    it spends ten times as long compiling the same primitives)."""
    return jax.jit(lambda p, x: jm.apply(p, x, policy, **kw))


def _jit_decode(jm, policy):
    return jax.jit(lambda p, x, c: jm.decode_step(p, x, c, policy=policy))


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def test_softplus_is_logaddexp():
    x = np.concatenate([np.linspace(-60, 60, 2001),
                        [0.0, 19.9, 20.0, 20.1, 25.0, 88.0, -88.0]])
    x = x.astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = t_ssm.softplus(torch.from_numpy(x)).numpy()
    # XLA on the CPU flushes subnormal results (softplus(-88)) to 0
    np.testing.assert_allclose(got, want, rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)
    # past torch's threshold of 20 its softplus is x itself; the
    # reference's is not
    big = torch.tensor([25.0])
    assert t_ssm.softplus(big) == float(jax.nn.softplus(25.0))


def test_segsum_exp_selects_away_the_overflow():
    """exp of the positive differences above the diagonal overflows to
    inf: selecting them away leaves no NaN, and below it matches."""
    rng = np.random.RandomState(5)
    # decreasing, as the cumulated dt * A is: every difference above the
    # diagonal is positive, up to 240
    cs = np.cumsum(-rng.rand(2, 3, 8, 4).astype(np.float32) * 30.0, axis=2)
    want = np.asarray(j_ssm._segsum_exp(jnp.asarray(cs)))
    got = t_ssm._segsum_exp(torch.from_numpy(cs)).numpy()
    assert np.isfinite(got).all()
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(cs[..., :, None, :]
                               - cs[..., None, :, :])).any()
    # XLA on the CPU flushes subnormal results to 0
    np.testing.assert_allclose(got, want, rtol=2e-7,
                               atol=np.finfo(np.float32).tiny)
    assert (np.triu(np.ones((8, 8)), 1)[None, None, :, :, None] * got
            == 0).all()


def test_rms_norm_gated_is_the_references():
    rng = np.random.RandomState(6)
    x, z = (rng.randn(3, 5, 64).astype(np.float32) for _ in range(2))
    scale = rng.rand(64).astype(np.float32) + 0.5
    want = j_norms.RMSNormGated(64).apply({"scale": jnp.asarray(scale)},
                                          jnp.asarray(x), jnp.asarray(z))
    got = t_norms.RMSNormGated(64).apply(
        {"scale": torch.from_numpy(scale)}, torch.from_numpy(x),
        torch.from_numpy(z))
    _close(got, want, FP32)
    init = t_norms.RMSNormGated(64).init(device="cpu")["scale"]
    assert init.shape == (64,) and bool((init == 1).all())


# (policy, S) of each block: fp32 at every S; P-fp below and across the
# chunk; the other quantized policies across it, as is a second B/C group
CASES = {1: [("fp32", 2), ("fp32", 8), ("fp32", 13), ("p_fp", 2),
             ("p_fp", 13), ("w4a8_abfp", 13), ("p_int8", 13)],
         2: [("fp32", 13), ("p_fp", 13)]}


@pytest.mark.parametrize("groups, policy, S", [
    (g, p, S) for g in (1, 2) for p, S in CASES[g]])
def test_apply_and_cache_match_reference(blocks, groups, policy, S):
    """S = 2 (below the chunk of 8 and below d_conv - 1: the conv tail is
    left-padded), 8 (one whole chunk) and 13 (across: the last chunk
    padded with dt = 0)."""
    jm, jparams, tm, tparams = blocks[groups]
    x = _x(S, seed=S)
    want, jcache = _jit_apply(jm, _policy(jp, policy), return_cache=True)(
        jparams, jnp.asarray(x))
    got, cache = tm.apply(tparams, torch.from_numpy(x), _policy(tp, policy),
                          return_cache=True)
    assert got.shape == (2, S, DIMS["d_model"])
    assert cache.conv.shape == (2, 3, tm.conv_channels)
    assert cache.state.shape == (2, tm.n_heads, 16, 16)
    _close(got, want, _tol(policy))
    _close(cache.conv, jcache.conv, _tol(policy))
    _close(cache.state, jcache.state, _tol(policy))


@pytest.mark.parametrize("groups, policy", [
    (g, p) for g in (1, 2) for p in POLICIES
    if (g == 1 and p != "w4a8_abfp") or p == "fp32"])
def test_decode_steps_continue_the_prefill_cache(blocks, groups, policy):
    """Decode steps from a 13-step prompt's cache: each step's output and
    the carried conv window and state match the reference's."""
    jm, jparams, tm, tparams = blocks[groups]
    x = _x(13, seed=7)
    _, jcache = _jit_apply(jm, _policy(jp, policy), return_cache=True)(
        jparams, jnp.asarray(x))
    _, cache = tm.apply(tparams, torch.from_numpy(x), _policy(tp, policy),
                        return_cache=True)
    steps = _x(4, seed=8)
    decode = _jit_decode(jm, _policy(jp, policy))
    for t in range(4):
        xt = steps[:, t:t + 1]
        want, jcache = decode(jparams, jnp.asarray(xt), jcache)
        got, cache = tm.decode_step(tparams, torch.from_numpy(xt), cache,
                                    policy=_policy(tp, policy))
        _close(got, want, _tol(policy))
    _close(cache.conv, jcache.conv, _tol(policy))
    _close(cache.state, jcache.state, _tol(policy))


@pytest.mark.parametrize("groups", [1, 2])
def test_padding_leaves_the_final_state_unchanged(blocks, groups):
    """Prompts of any length: the chunk-padded scan's final state is the
    one a step-by-step decode from an empty cache reaches, and the one an
    unpadded scan (chunk = S) reaches."""
    _, _, tm, tparams = blocks[groups]
    pol = tp.preset("fp32")
    for S in (3, 13):
        x = torch.from_numpy(_x(S, seed=9))
        ys, padded = tm.apply(tparams, x, pol, return_cache=True)
        whole = t_ssm.Mamba2(**dict(DIMS, chunk=S,
                                    n_groups=tm.n_groups)).apply(
            tparams, x, pol, return_cache=True)[1]
        cache = tm.init_cache(2, device="cpu")
        for t in range(S):
            y, cache = tm.decode_step(tparams, x[:, t:t + 1], cache,
                                      policy=pol)
            np.testing.assert_allclose(y[:, 0].numpy(), ys[:, t].numpy(),
                                       rtol=1e-4, atol=1e-5)
        for c in (whole, cache):
            np.testing.assert_allclose(padded.state.numpy(),
                                       c.state.numpy(), **FP32)
            np.testing.assert_allclose(padded.conv.numpy(), c.conv.numpy(),
                                       **FP32)


def test_compressed_projections_match_reference(blocks, monkeypatch):
    """in_proj / out_proj as packed int4 codes, served fused: both
    projections through ``quant_matmul`` (the plain version on the CPU;
    the reference's Pallas kernel in interpret mode)."""
    jm, jparams, tm, tparams = blocks[1]
    pol = _policy(jp, "p_fp")
    jserved = jst.compress_weights(jparams, pol)
    tserved = tst.compress_weights(tparams, _policy(tp, "p_fp"))
    assert tserved["in_proj"]["kernel"].packed
    calls = []
    plain = t_qm.quant_matmul
    monkeypatch.setattr(t_qm, "quant_matmul",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    x = _x(13, seed=10)
    want, jcache = _jit_apply(jm, jst.serving_policy(pol),
                              return_cache=True)(jserved, jnp.asarray(x))
    got, cache = tm.apply(tserved, torch.from_numpy(x),
                          tst.serving_policy(_policy(tp, "p_fp")),
                          return_cache=True)
    assert len(calls) == 2
    _close(got, want, QDQ)
    _close(cache.state, jcache.state, QDQ)
    xt = _x(1, seed=11)
    want, _ = _jit_decode(jm, jst.serving_policy(pol))(
        jserved, jnp.asarray(xt), jcache)
    got, _ = tm.decode_step(tserved, torch.from_numpy(xt), cache,
                            policy=tst.serving_policy(_policy(tp, "p_fp")))
    assert len(calls) == 4
    _close(got, want, QDQ)


@pytest.mark.parametrize("groups", [1, 2])
def test_init_shapes_and_values_are_the_references(blocks, groups):
    jm, jparams, tm, _ = blocks[groups]
    got = tm.init(torch.Generator().manual_seed(0), device="cpu")
    ref = jax.device_get(unbox(jm.init(jax.random.PRNGKey(0))))
    assert jax.tree_util.tree_map(np.shape, ref) == {
        k: (jax.tree_util.tree_map(lambda t: tuple(t.shape), v)
            if isinstance(v, dict) else tuple(v.shape))
        for k, v in got.items()}
    # the deterministic entries are the reference's values
    for k in ("conv_b", "A_log", "D", "dt_bias"):
        np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=1e-6)
    np.testing.assert_array_equal(got["norm"]["scale"].numpy(),
                                  ref["norm"]["scale"])
    assert tm.proj_out == jm.proj_out and tm.conv_channels == jm.conv_channels
