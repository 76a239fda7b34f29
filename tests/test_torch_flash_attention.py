"""Dense flash attention and the attention module's prefill paths, port vs
reference, on the same numpy inputs.

Tolerance 1e-5 (rtol and atol) throughout, with its reason: the same f32
scores, masks and softmax recurrence; only the order of the f32 sums (and
the reference's materialized vs online softmax) differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jp
from repro.kernels import flash_attention as j_fa
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.nn import attention as jattn
from repro_torch.core import policy as tp
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.nn import attention as tattn

TOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)


def _qkv(seed, BH, S, T, D, BHkv=None):
    rng = np.random.RandomState(seed)
    f = lambda *s: rng.randn(*s).astype(np.float32)
    return f(BH, S, D), f(BHkv or BH, T, D), f(BHkv or BH, T, D)


_SHAPES = [(32, 32, None, 8), (48, 48, 0, 16), (8, 40, 32, 8),
           (16, 24, 3, 8)]


@pytest.mark.parametrize("causal,S,T,q_offset,bk", [
    *[(True, *s) for s in _SHAPES + [(12, 20, -4, 4)]],
    *[(False, *s) for s in _SHAPES]])
def test_plain_vs_reference_kernel_and_oracle(causal, S, T, q_offset, bk):
    q, k, v = _qkv(S * T, 3, S, T, 16)
    kw = dict(scale=0.3, causal=causal, q_offset=q_offset)
    want = j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), block_q=8, block_k=bk,
                                interpret=True, **kw)
    before = t_fa.flash_attention.launches
    got = t_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), block_q=8, block_k=bk,
                               **kw)
    assert t_fa.flash_attention.launches == before  # CPU: plain version
    assert got.dtype == torch.float32 and got.shape == (3, S, 16)
    _close(got, want)
    if causal and q_offset is not None and q_offset < 0:
        # rows that see no key at all: the guards give exactly 0
        assert torch.equal(got[:, :-q_offset], torch.zeros_like(
            got[:, :-q_offset]))
        return
    oracle = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), **kw)
    _close(got, oracle)
    _close(tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), **kw), oracle)


def test_rectangular_causal_without_offset_raises_the_same_message():
    q, k, v = _qkv(1, 2, 4, 9, 8)
    with pytest.raises(ValueError) as je:
        j_fa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True)
    with pytest.raises(ValueError) as te:
        t_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v))
    assert str(te.value) == str(je.value)
    assert "needs an explicit q_offset" in str(te.value)
    # non-causal or explicit offset: fine
    t_fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), causal=False)
    with pytest.raises(ValueError, match="does not group"):
        t_fa.flash_attention(torch.zeros(3, 4, 8), torch.zeros(2, 4, 8),
                             torch.zeros(2, 4, 8))


@pytest.mark.parametrize("H,KV", [(4, 2), (6, 1), (4, 4)])
def test_gqa_front_end_equals_repeat_kv_reference(H, KV):
    """Indexing KV head h // G is the repeat the reference performs."""
    rng = np.random.RandomState(H * KV)
    B, S, D = 2, 24, 16
    qh = rng.randn(B, S, H, D).astype(np.float32)
    kh = rng.randn(B, S, KV, D).astype(np.float32)
    vh = rng.randn(B, S, KV, D).astype(np.float32)
    want = jops.flash_attention_gqa(jnp.asarray(qh), jnp.asarray(kh),
                                    jnp.asarray(vh), block_q=8, block_k=8,
                                    interpret=True)
    got = tops.flash_attention_gqa(torch.from_numpy(qh), torch.from_numpy(kh),
                                   torch.from_numpy(vh), block_q=8, block_k=8)
    assert got.shape == (B, S, H, D)
    _close(got, want)
    # the repeat-KV reference, materialized
    G = H // KV
    q = torch.from_numpy(qh).transpose(1, 2).reshape(B * H, S, D)
    k = torch.from_numpy(kh).repeat_interleave(G, dim=2).transpose(
        1, 2).reshape(B * H, S, D)
    v = torch.from_numpy(vh).repeat_interleave(G, dim=2).transpose(
        1, 2).reshape(B * H, S, D)
    rep = tref.flash_attention_ref(q, k, v).reshape(B, H, S, D).transpose(
        1, 2)
    _close(got, rep)


# ---------------------------------------------------------------------------
# the attention module's full-sequence paths
# ---------------------------------------------------------------------------
def _attn_params(seed, d, H, KV, D):
    rng = np.random.RandomState(seed)
    dense = lambda i, o, bias: dict(
        kernel=(rng.randn(i, o) / np.sqrt(i)).astype(np.float32),
        **({"bias": (0.1 * rng.randn(o)).astype(np.float32)} if bias
           else {}))
    return {"q": dense(d, H * D, True), "k": dense(d, KV * D, True),
            "v": dense(d, KV * D, True), "o": dense(H * D, d, False)}


def _both(p):
    to_j = jax.tree_util.tree_map(jnp.asarray, p)
    to_t = {k: {n: torch.from_numpy(a) for n, a in v.items()}
            for k, v in p.items()}
    return to_j, to_t


@pytest.mark.parametrize("path,backend,preset,S", [
    ("flash", "fused", "fp32", 40),
    ("flash", "auto", "fp32", 24),  # the module's opt-in flag
    ("flash", "fused", "w4a8_int8_native", 32),
    ("reference", "ref", "w4a8_abfp", 24),
    ("blockwise", "ref", "fp32", 64),
    ("blockwise", "ref", "w4a8_abfp", 64),
])
def test_attention_apply_paths_match_reference(path, backend, preset, S,
                                               monkeypatch):
    """``Attention.apply`` through each of its three paths (the flash
    kernel where ``flash_ok`` holds, the reference, the blockwise loop at
    S >= ``blockwise_min_seq``) with ``n_valid`` masking, vs the
    reference module; the returned K/V too."""
    d, H, KV, D = 32, 4, 2, 8
    kw = dict(d_model=d, n_heads=H, n_kv=KV, head_dim=D, qkv_bias=True,
              q_block=16, kv_block=16, blockwise_min_seq=64,
              use_flash_kernel=backend == "auto")
    jat = jattn.Attention(**kw)
    tat = tattn.Attention(**kw)
    jparams, tparams = _both(_attn_params(S, d, H, KV, D))
    rng = np.random.RandomState(S + 1)
    x = rng.randn(2, S, d).astype(np.float32)
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), (2, S))
    n_valid = np.array([S, S - 5], np.int32)
    jpol = jp.with_attn_backend(jp.preset(preset, n=8), backend)
    tpol = tp.with_attn_backend(tp.preset(preset, n=8), backend)
    calls = []
    flash = tops.flash_attention_gqa
    monkeypatch.setattr(tops, "flash_attention_gqa",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    before = t_fa.flash_attention.launches
    jy, (jk, jv) = jat.apply(jparams, jnp.asarray(x),
                             positions=jnp.asarray(pos), policy=jpol,
                             return_kv=True, n_valid=jnp.asarray(n_valid))
    ty, (tk, tv) = tat.apply(tparams, torch.from_numpy(x),
                             positions=torch.from_numpy(pos.copy()),
                             policy=tpol, return_kv=True,
                             n_valid=torch.from_numpy(n_valid))
    assert t_fa.flash_attention.launches == before
    assert bool(calls) == (path == "flash")  # the path the rule picks
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)
    assert torch.equal(tk[1, S - 5:], torch.zeros_like(tk[1, S - 5:]))
