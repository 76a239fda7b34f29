"""Plain ``flash_attention_quant`` of the port vs the reference's Pallas
kernel run in interpret mode, through both GQA front-ends.

Tolerance: atol 1e-5 on outputs of magnitude <= ~6 — f32 products with
sums in another order, and exp implementations that differ in the last
bits.  With the probs QDQ on, a probability sitting exactly on a rounding
boundary may flip one code between the two stacks; those cases use the
boundary-tolerant bar the reference's own test of its ``phased`` body
documents (max deviation < 5e-3, at least 90 % of elements within 1e-5).
Rows with no valid key are masked out of the comparison where the paths
may legitimately differ.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.policy import preset as j_preset
from repro.kernels import ops as jkops
from repro_torch.core.policy import preset as t_preset
from repro_torch.kernels import flash_attention_quant as tfaq
from repro_torch.kernels import ops as tkops


def _inputs(B, S, T, H, KV, D, *, fp8=False, q_offset=0, seed=0):
    rng = np.random.RandomState(seed)
    qh = rng.randn(B, S, H, D).astype(np.float32)
    codes = rng.randint(-127, 128, (2, B, T, KV, D)).astype(np.float32)
    if fp8:
        codes = codes / 16.0  # e4m3-representable values
    ks = (rng.rand(B, T, KV) * 0.05 + 1e-3).astype(np.float32)
    vs = (rng.rand(B, T, KV) * 0.05 + 1e-3).astype(np.float32)
    q_pos = np.broadcast_to(
        q_offset + np.arange(S, dtype=np.int32)[None], (B, S)).copy()
    kv_pos = np.broadcast_to(np.arange(T, dtype=np.int32)[None],
                             (B, T)).copy()
    return qh, codes[0], codes[1], ks, vs, q_pos, kv_pos


def _both(inp, *, fp8=False, window=None, **kw):
    qh, kc, vc, ks, vs, q_pos, kv_pos = inp
    jct = jnp.float8_e4m3fn if fp8 else jnp.int8
    tct = torch.float8_e4m3fn if fp8 else torch.int8
    jkw = dict(kw)
    tkw = dict(kw)
    if "probs" in kw:
        jkw["probs_tq"] = j_preset("w4a8_abfp").input if kw["probs"] else None
        tkw["probs_tq"] = t_preset("w4a8_abfp").input if kw["probs"] else None
        del jkw["probs"], tkw["probs"]
    want = jkops.flash_attention_quant_gqa(
        jnp.asarray(qh), jnp.asarray(kc, jct), jnp.asarray(vc, jct),
        jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(q_pos),
        jnp.asarray(kv_pos),
        window=None if window is None else jnp.asarray(window, jnp.int32),
        interpret=True, **jkw)
    before = tfaq.flash_attention_quant.launches
    got = tkops.flash_attention_quant_gqa(
        torch.from_numpy(qh), torch.from_numpy(kc).to(tct),
        torch.from_numpy(vc).to(tct), torch.from_numpy(ks),
        torch.from_numpy(vs), torch.from_numpy(q_pos),
        torch.from_numpy(kv_pos), window=window, **tkw)
    assert tfaq.flash_attention_quant.launches == before  # CPU: plain
    return got.numpy(), np.asarray(want)


@pytest.mark.parametrize("fp8", [False, True])
@pytest.mark.parametrize("probs", [False, True])
def test_exact_body_gqa_decode_suffix(fp8, probs):
    inp = _inputs(2, 8, 64, 4, 2, 16, fp8=fp8, q_offset=56, seed=1)
    got, want = _both(inp, fp8=fp8, causal=True, probs=probs)
    diff = np.abs(got - want)
    if probs:
        assert diff.max() < 5e-3 and (diff <= 1e-5).mean() > 0.9
    else:
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_exact_body_probs_padded_groups():
    # T = 40 zero-pads to the 64-group; padded slots carry kv_pos = -1
    inp = _inputs(1, 4, 40, 2, 2, 16, q_offset=36, seed=2)
    got, want = _both(inp, causal=True, probs=True)
    diff = np.abs(got - want)
    assert diff.max() < 5e-3 and (diff <= 1e-5).mean() > 0.9


def test_noncausal_and_square():
    inp = _inputs(1, 16, 40, 4, 4, 8, seed=3)
    got, want = _both(inp, causal=False)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    inp = _inputs(2, 32, 32, 4, 2, 16, seed=4)
    got, want = _both(inp, causal=True)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fp8", [False, True])
def test_online_body_multi_block(fp8):
    # T = 96 with single_block_max = 32 forces the online multi-tile body
    # and the fit_block back-off (96 % 64 != 0 -> bk = 32)
    inp = _inputs(1, 24, 96, 2, 1, 16, fp8=fp8, q_offset=72, seed=5)
    got, want = _both(inp, fp8=fp8, causal=True, block_k=64,
                      single_block_max=32)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("fp8", [False, True])
def test_phased_body_multi_block_probs(fp8):
    inp = _inputs(1, 8, 128, 2, 1, 16, fp8=fp8, q_offset=120, seed=6)
    got, want = _both(inp, fp8=fp8, causal=True, probs=True, block_k=64,
                      single_block_max=32)
    diff = np.abs(got - want)
    assert diff.max() < 5e-3, diff.max()
    assert (diff <= 1e-5).mean() > 0.9


@pytest.mark.parametrize("body", ["exact", "online", "phased"])
def test_window_masked_slots_and_garbage(body):
    """Sliding window + unwritten slots (kv_pos = -1) holding garbage
    codes and absurd scales: the garbage never reaches the output, and
    flipping it leaves the port's output BIT-identical."""
    qh, kc, vc, ks, vs, q_pos, kv_pos = _inputs(2, 4, 64, 4, 2, 16,
                                                q_offset=40, seed=7)
    kv_pos = np.where(np.arange(64)[None] < 44, kv_pos, -1).astype(np.int32)
    kv_pos[1] = -1  # row 1 has no valid key at all
    kw = dict(causal=True, window=9)
    if body != "exact":
        kw.update(block_k=32, single_block_max=16)
    if body == "phased":
        kw["probs"] = True
    got, want = _both((qh, kc, vc, ks, vs, q_pos, kv_pos), **kw)
    live = slice(0, 1)  # row 1 is dead: masked out of the comparison
    diff = np.abs(got[live] - want[live])
    if body == "phased":
        assert diff.max() < 5e-3 and (diff <= 1e-5).mean() > 0.9
    else:
        np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=0)
    kc2, ks2 = kc.copy(), ks.copy()
    kc2[:, 44:] = -kc2[:, 44:] * 0 + 77
    ks2[:, 44:] = ks2[:, 44:] * 1e6 + 42.0
    got2, _ = _both((qh, kc2, vc, ks2, vs, q_pos, kv_pos), **kw)
    assert np.array_equal(got2[live], got[live])


def test_tiling_errors_use_reference_messages():
    q = torch.zeros(1, 2, 2, 16)
    kc = torch.zeros(1, 48, 2, 16, dtype=torch.int8)
    s = torch.ones(1, 48, 2)
    qp = torch.zeros(1, 2, dtype=torch.int32)
    kp = torch.zeros(1, 48, dtype=torch.int32)
    with pytest.raises(ValueError, match="do not tile"):
        tfaq.flash_attention_quant(q, kc, kc, s, s, qp, kp, 100, scale=1.0,
                                   block_k=32)
    with pytest.raises(ValueError, match="ABFP group"):
        tfaq.flash_attention_quant(q, kc, kc, s, s, qp, kp, 100, scale=1.0,
                                   block_k=24, probs_n=16, probs_qmax=127.0,
                                   probs_qmin=-127.0)
