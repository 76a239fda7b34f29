"""``Attention.paged_step`` of the port vs the reference, layer level.

The same weights, inputs and page table go through both stacks for one
prefill chunk and three decode writes.  After every step the page pools
(codes AND scales of int8 / fp8 pages) must be EQUAL — the S == 1 monotone
requantization keeps the reference's op order, so its drift is the same
drift — and the layer output must agree to atol 1e-5 (f32 matmuls and
softmax in another summation order; outputs are O(1)).  Both attention branches are driven:
dequantize-then-reference and the compressed branch (the reference runs
its Pallas kernel in interpret mode, the port its plain version).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import policy as jp
from repro.nn.attention import Attention as JAttention
from repro_torch.core import policy as tp
from repro_torch.nn.attention import Attention as TAttention

D_MODEL, H, KV, HD, PS, NL = 64, 4, 2, 16, 8, 5
N_PAGES = 12


def _params(rng):
    def dense(i, o, bias):
        p = {"kernel": (rng.randn(i, o) / np.sqrt(i)).astype(np.float32)}
        if bias:
            p["bias"] = (rng.randn(o) * 0.1).astype(np.float32)
        return p

    return {"q": dense(D_MODEL, H * HD, True), "k": dense(D_MODEL, KV * HD,
                                                          True),
            "v": dense(D_MODEL, KV * HD, True),
            "o": dense(H * HD, D_MODEL, False)}


def _tree(p, fn):
    return {k: {kk: fn(vv) for kk, vv in v.items()} for k, v in p.items()}


def _policies(name, backend, kv):
    out = []
    for mod in (jp, tp):
        pol = mod.preset(name, n=16)
        pol = mod.with_kv_cache(pol, kv) if kv != "fp" else pol
        out.append(mod.with_attn_backend(pol, backend))
    return out


def _assert_pool_equal(tc, jc, what):
    if jc.k_scale is None:
        # fp pages hold the raw f32 projections (f32 matmul + rope in
        # another summation order): close, not bit-equal
        assert tc.k_scale is None and tc.v_scale is None
        for field in ("k", "v"):
            np.testing.assert_allclose(
                getattr(tc, field).numpy(), np.asarray(getattr(jc, field)),
                rtol=1e-5, atol=1e-6, err_msg=f"{what}: {field}")
        return
    for field in ("k", "v", "k_scale", "v_scale"):
        t, j = getattr(tc, field), getattr(jc, field)
        tb = t.view(torch.uint8) if t.dtype == torch.float8_e4m3fn else t
        jb = np.asarray(j)
        jb = jb.view(np.uint8) if jb.dtype.itemsize == 1 and \
            jb.dtype.kind not in "iu" else jb
        if tb.dtype == torch.float32:
            np.testing.assert_array_equal(
                tb.numpy().view(np.uint32), jb.view(np.uint32),
                err_msg=f"{what}: {field}")
        else:
            np.testing.assert_array_equal(tb.numpy(), jb,
                                          err_msg=f"{what}: {field}")


@pytest.mark.parametrize("name,backend,kv", [
    ("w4a8_abfp", "ref", "int8"),
    ("w4a8_abfp", "compressed", "int8"),
    ("w4a8_abfp", "compressed", "fp8"),
    ("fp32", "ref", "fp8"),
    ("fp32", "compressed", "int8"),
    ("fp32", "auto", "fp"),
])
def test_paged_step_pool_and_output(name, backend, kv):
    rng = np.random.RandomState(17)
    params = _params(rng)
    jpol, tpol = _policies(name, backend, kv)
    kw = dict(d_model=D_MODEL, n_heads=H, n_kv=KV, head_dim=HD,
              qkv_bias=True, rope_theta=1e6, name="blocks.0/attn")
    jattn, tattn = JAttention(**kw), TAttention(**kw)
    jparams = _tree(params, jnp.asarray)
    tparams = _tree(params, torch.from_numpy)
    jcache = jattn.init_paged_cache(N_PAGES, PS, kv=kv)
    tcache = tattn.init_paged_cache(N_PAGES, PS, kv=kv, device="cpu")

    # rows 0 and 1 serve; row 2 is masked (n_valid = 0, unmapped table)
    table = np.full((3, NL), -1, np.int32)
    table[0, :3] = [4, 1, 7]
    table[1, :4] = [0, 9, 2, 5]
    pos = np.zeros(3, np.int32)
    chunk = 16  # two pages per prefill chunk
    x = rng.randn(3, chunk, D_MODEL).astype(np.float32)
    steps = [(x, np.array([13, 16, 0], np.int32))]  # one prefill chunk
    for _ in range(3):  # three decode writes into partly filled pages
        steps.append((rng.randn(3, 1, D_MODEL).astype(np.float32) * 1.5,
                      np.array([1, 1, 0], np.int32)))
    for i, (xs, n_valid) in enumerate(steps):
        jy, jcache = jattn.paged_step(
            jparams, jnp.asarray(xs), jcache, page_table=jnp.asarray(table),
            position=jnp.asarray(pos), n_valid=jnp.asarray(n_valid),
            policy=jpol, window=jnp.asarray(1 << 30, jnp.int32))
        ty, tcache = tattn.paged_step(
            tparams, torch.from_numpy(xs), tcache,
            page_table=torch.from_numpy(table),
            position=torch.from_numpy(pos),
            n_valid=torch.from_numpy(n_valid), policy=tpol, window=1 << 30)
        _assert_pool_equal(tcache, jcache, f"step {i}")
        live = n_valid > 0
        for b in np.nonzero(live)[0]:
            np.testing.assert_allclose(
                ty.numpy()[b, :n_valid[b]], np.asarray(jy)[b, :n_valid[b]],
                atol=1e-5, rtol=1e-5, err_msg=f"step {i} row {b}")
        pos = pos + n_valid


def test_compressed_over_fp_storage_raises_reference_message():
    kw = dict(d_model=D_MODEL, n_heads=H, n_kv=KV, head_dim=HD)
    rng = np.random.RandomState(0)
    params = _tree(_params(rng), torch.from_numpy)
    tattn = TAttention(**kw)
    cache = tattn.init_paged_cache(4, PS, kv="fp", device="cpu")
    pol = tp.with_attn_backend(tp.preset("fp32"), "compressed")
    with pytest.raises(ValueError, match="needs quantized KV storage"):
        tattn.paged_step(
            params, torch.zeros(1, 1, D_MODEL), cache,
            page_table=torch.zeros((1, 2), dtype=torch.int32),
            position=torch.zeros(1, dtype=torch.int32),
            n_valid=torch.ones(1, dtype=torch.int32), policy=pol)
    with pytest.raises(ValueError, match="unknown paged KV storage"):
        tattn.init_paged_cache(4, PS, kv="int4", device="cpu")


def test_chunk_not_multiple_of_page_raises():
    kw = dict(d_model=D_MODEL, n_heads=H, n_kv=KV, head_dim=HD)
    rng = np.random.RandomState(0)
    params = _tree(_params(rng), torch.from_numpy)
    tattn = TAttention(**kw)
    cache = tattn.init_paged_cache(4, PS, kv="int8", device="cpu")
    with pytest.raises(ValueError, match="not a multiple of the KV page"):
        tattn.paged_step(
            params, torch.zeros(1, 12, D_MODEL), cache,
            page_table=torch.zeros((1, 2), dtype=torch.int32),
            position=torch.zeros(1, dtype=torch.int32),
            n_valid=torch.full((1,), 12, dtype=torch.int32),
            policy=tp.preset("fp32"))
