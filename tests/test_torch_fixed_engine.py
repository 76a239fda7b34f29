"""The slice as a whole: the fixed-slot ``ServeEngine`` of the port vs the
reference engine, on weights carried across by the bridge.

The reference model is initialised in JAX (reduced qwen2-7b, 2 layers), its
parameter tree goes through ``jax.device_get`` and
``repro_torch.bridge.from_repro_params``, and both engines serve the same
mixed-length trace greedily with bucketed prefill.  Tokens must be
IDENTICAL (the reference pins token identity at this size) under fp32,
w4a8_abfp, the slice's two kernel policies — P-int8 (w4a8_int8_native,
fused, ``fused`` attention: ``abfp_matmul_int8`` + ``flash_attention``)
and P-fp (w4a8_abfp without attention-BMM QDQ, fused, ``fused`` attention:
``abfp_matmul`` + ``flash_attention``) — and compressed serving with an
int8 ring cache and the ``compressed`` attention backend.  On the CPU the
port's kernel wrappers run their plain versions; the reference runs its
Pallas kernels in interpret mode.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.models import build_model as j_build_model
from repro.nn.module import unbox
from repro.serve import engine as jeng
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tp
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as t_build_model
from repro_torch.serve import engine as teng

N_GROUP = 16  # divides the reduced head_dim and every reduced width


def _trace(mod, vocab, lengths=(5, 11, 3, 70, 8, 2), max_new=5, seed=3):
    rng = np.random.RandomState(seed)
    return [mod.Request(uid=i,
                        prompt=rng.randint(0, vocab, size=n).astype(np.int32),
                        max_new_tokens=max_new)
            for i, n in enumerate(lengths)]


@pytest.fixture(scope="module")
def stacks():
    jcfg = j_get_config("qwen2-7b").reduced()
    jmodel = j_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tcfg = t_get_config("qwen2-7b").reduced()
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                       device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _policy(mod, name):
    """(policy, engine kwargs) of each configuration, on either stack."""
    fused = lambda p: mod.map_policies(p, lambda q: q.replace(fused=True))
    if name == "fp32":
        return mod.preset("fp32"), {}
    if name == "w4a8_abfp":
        return mod.preset("w4a8_abfp", n=N_GROUP), {}
    if name == "p_int8":
        pol = fused(mod.preset("w4a8_int8_native", n=N_GROUP))
        return mod.with_attn_backend(pol, "fused"), {}
    if name == "p_fp":
        pol = mod.map_policies(mod.preset("w4a8_abfp", n=N_GROUP),
                               lambda q: q.replace(attn_bmm=False))
        return mod.with_attn_backend(fused(pol), "fused"), {}
    assert name == "compress"
    pol = mod.with_kv_cache(mod.preset("w4a8_abfp", n=N_GROUP), "int8")
    return (mod.with_attn_backend(fused(pol), "compressed"),
            {"compress": True})


def _serve(mod, model, params, policy, vocab, **kw):
    eng = mod.ServeEngine(model, params, n_slots=3, max_len=96,
                          policy=policy, **kw)
    for r in _trace(mod, vocab):
        eng.submit(r)
    done = eng.run_until_done()
    return eng, {c.uid: c.tokens for c in done}


@pytest.mark.parametrize("name", ["fp32", "w4a8_abfp", "p_int8", "p_fp",
                                  "compress"])
def test_fixed_engine_tokens_identical_to_reference(stacks, name):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    jpol, jkw = _policy(jp, name)
    tpol, tkw = _policy(tp, name)
    _, want = _serve(jeng, jmodel, jparams, jpol, jcfg.vocab, **jkw)
    before = (tqm.abfp_matmul.launches, tqm.abfp_matmul_int8.launches,
              tfa.flash_attention.launches)
    eng, got = _serve(teng, tmodel, tparams, tpol, tcfg.vocab, device="cpu",
                      **tkw)
    # CPU tensors: the wrappers ran their plain versions, no kernel
    assert (tqm.abfp_matmul.launches, tqm.abfp_matmul_int8.launches,
            tfa.flash_attention.launches) == before
    assert got == want
    assert all(len(t) == 5 for t in got.values())
    assert eng.attn_backend == jp.attn_backend_mode(jpol)
    if name == "compress":
        assert eng.state.kv[0].k.dtype == torch.int8
        assert eng.weight_bytes["compressed_sites"] > 0


@pytest.mark.parametrize("name", ["fp32", "w4a8_abfp"])
def test_paged_equals_fixed_inside_the_port(stacks, name):
    *_, tcfg, tmodel, tparams = stacks
    pol, _ = _policy(tp, name)
    _, fixed = _serve(teng, tmodel, tparams, pol, tcfg.vocab, device="cpu")
    paged = teng.PagedServeEngine(tmodel, tparams, n_slots=3, max_len=96,
                                  policy=pol, page_size=8, device="cpu")
    for r in _trace(teng, tcfg.vocab):
        paged.submit(r)
    assert {c.uid: c.tokens for c in paged.run_until_done()} == fixed


def test_bucketing_bounds_prefill_shapes(stacks):
    *_, tcfg, tmodel, tparams = stacks
    eng = teng.ServeEngine(tmodel, tparams, n_slots=2, max_len=96,
                           prefill_bucket=32, device="cpu")
    lengths = (3, 5, 17, 30, 31, 33, 40, 60, 64, 65, 70, 2)
    for r in _trace(teng, tcfg.vocab, lengths=lengths, max_new=2):
        eng.submit(r)
    done = eng.run_until_done()
    assert len(done) == len(lengths) == eng.prefills
    # prompts of 2..70 tokens pad to 32, 64 or 96 (max_len caps 96)
    assert eng.prefill_compiles == 3 <= -(-96 // 32)
    # bucketed prefill is token-identical to an exact-length one
    exact = teng.ServeEngine(tmodel, tparams, n_slots=2, max_len=96,
                             prefill_bucket=1, device="cpu")
    for r in _trace(teng, tcfg.vocab, lengths=lengths, max_new=2):
        exact.submit(r)
    assert ({c.uid: c.tokens for c in exact.run_until_done()}
            == {c.uid: c.tokens for c in done})
    assert exact.prefill_compiles == len(set(lengths))


def test_engine_rejects_what_the_reference_rejects(stacks):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    fp8 = tp.with_kv_cache(tp.preset("w4a8_abfp"), "fp8")
    with pytest.raises(ValueError) as te:
        teng.ServeEngine(tmodel, tparams, policy=fp8, device="cpu")
    with pytest.raises(ValueError) as je:
        jeng.ServeEngine(jmodel, jparams,
                         policy=jp.with_kv_cache(jp.preset("w4a8_abfp"),
                                                 "fp8"))
    assert str(te.value) == str(je.value) and "paged-only" in str(te.value)
    comp = tp.with_attn_backend(tp.preset("w4a8_abfp"), "compressed")
    with pytest.raises(ValueError, match="needs quantized KV storage"):
        teng.ServeEngine(tmodel, tparams, policy=comp, device="cpu")
    eng = teng.ServeEngine(tmodel, tparams, max_len=16, device="cpu")
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        eng.submit(teng.Request(uid=0, prompt=np.zeros(12, np.int32),
                                max_new_tokens=8))
    eng.submit(teng.Request(uid=1, prompt=np.zeros(6, np.int32),
                            max_new_tokens=8))
    with pytest.raises(teng.TickBudgetExhausted) as e:
        eng.run_until_done(max_ticks=2)
    assert e.value.unfinished == [1]


def test_fixed_engine_defaults_to_the_card(stacks):
    *_, tcfg, tmodel, tparams = stacks
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        teng.ServeEngine(tmodel, tparams)
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.inner.init_decode_state(2, 16)  # device defaults to cuda


def test_prefill_and_decode_match_reference(stacks):
    """Model level, P-int8: prefill logits and one aligned decode step."""
    import jax.numpy as jnp

    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    jpol, _ = _policy(jp, "p_int8")
    tpol, _ = _policy(tp, "p_int8")
    rng = np.random.RandomState(7)
    tokens = rng.randint(0, jcfg.vocab, (2, 32)).astype(np.int32)
    jl, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jpol,
                             max_len=48)
    tl, tst = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                             tpol, max_len=48)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    nxt = np.array(jnp.argmax(jl[:, :jcfg.vocab], -1))[:, None]
    jd, _ = jmodel.decode_step(jparams, jnp.asarray(nxt, jnp.int32), jst,
                               jpol)
    td, tst2 = tmodel.decode_step(tparams, torch.from_numpy(nxt).int(), tst,
                                  tpol)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-4,
                               atol=1e-4)
    assert int(tst2.position) == 33
    assert tst2.kv[0].k.shape == (2, 48, tcfg.n_kv * tcfg.head_dim_)


def test_apply_matches_reference(stacks):
    """Full-sequence forward (``Model.apply``) under P-fp: logits at every
    position."""
    import jax.numpy as jnp

    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    jpol, _ = _policy(jp, "p_fp")
    tpol, _ = _policy(tp, "p_fp")
    tokens = np.random.RandomState(9).randint(0, jcfg.vocab, (2, 24))
    tokens = tokens.astype(np.int32)
    jl, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens)}, jpol)
    tl, aux = tmodel.apply(tparams, {"tokens": torch.from_numpy(tokens)},
                           tpol)
    assert tl.shape == (2, 24, tcfg.vocab_padded) and float(aux) == 0.0
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-4)


def test_launcher_fixed_engine_on_cpu(capsys):
    assert tserve.main(["--device", "cpu", "--policy", "w4a8_int8_native",
                        "--attn-backend", "fused", "--n-requests", "3",
                        "--max-new-tokens", "3", "--max-len", "32"]) == 0
    out = capsys.readouterr().out.strip().splitlines()[-1]
    import json

    rep = json.loads(out)
    assert rep["requests"] == 3 and rep["generated_tokens"] == 9
    assert rep["attention"] == {"backend": "fused", "engine": "fixed"}
    assert rep["device"] == "cpu"
