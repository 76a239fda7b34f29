"""The slice as a whole: ``PagedServeEngine`` of the port vs the reference
engine, on weights carried across by the bridge.

The reference model is initialised in JAX (reduced qwen2-7b, 2 layers),
its parameter tree goes through ``jax.device_get`` and
``repro_torch.bridge.from_repro_params``, and both engines serve the same
mixed-length trace greedily.  Tokens must be IDENTICAL (the reference pins
token identity at this size) under fp32 and under the slice's policy:
w4a8_abfp + fused + compressed weights + int8 pages + compressed attention.
On the CPU the port's kernel wrappers run their plain versions; the
reference runs its Pallas kernels in interpret mode.
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
from repro_torch.models import build_model as t_build_model
from repro_torch.nn.module import make_generator
from repro_torch.serve import engine as teng


def _mixed_trace(mod, vocab, lengths=(5, 11, 3, 70, 8, 2), max_new=5,
                 seed=3):
    rng = np.random.RandomState(seed)
    return [mod.Request(uid=i,
                        prompt=rng.randint(0, vocab, size=n).astype(np.int32),
                        max_new_tokens=max_new)
            for i, n in enumerate(lengths)]


def _both_stacks(scan_layers: bool):
    jcfg = j_get_config("qwen2-7b").reduced().replace(
        scan_layers=scan_layers)
    jmodel = j_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tcfg = t_get_config("qwen2-7b").reduced()
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                       device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


@pytest.fixture(scope="module")
def setup():
    """Reference layers stacked along a leading axis (its default
    scan-over-layers form): the bridge unstacks them."""
    return _both_stacks(scan_layers=True)


def _policy(mod, name, cfg):
    if name == "fp32":
        return mod.preset("fp32"), dict(kv="auto", compress=False)
    # the slice's policy (group 16 divides the reduced head_dim and widths)
    pol = mod.preset("w4a8_abfp", n=16)
    pol = mod.map_policies(pol, lambda p: p.replace(fused=True))
    pol = mod.with_attn_backend(pol, "compressed")
    return pol, dict(kv="int8", compress=True)


def _serve(mod, model, params, policy, vocab, **kw):
    eng = mod.PagedServeEngine(model, params, n_slots=3, max_len=96,
                               policy=policy, page_size=8, **kw)
    for r in _mixed_trace(mod, vocab):
        eng.submit(r)
    done = eng.run_until_done()
    return eng, {c.uid: c.tokens for c in done}


@pytest.mark.parametrize("name", ["fp32", "slice"])
def test_paged_engine_tokens_identical_to_reference(setup, name):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = setup
    jpol, jkw = _policy(jp, name, jcfg)
    tpol, tkw = _policy(tp, name, tcfg)
    _, want = _serve(jeng, jmodel, jparams, jpol, jcfg.vocab, **jkw)
    eng, got = _serve(teng, tmodel, tparams, tpol, tcfg.vocab, device="cpu",
                      **tkw)
    assert got == want
    st = eng.page_stats()
    assert st["page_allocs"] == st["page_frees"] > 0
    assert st["pages_in_use"] == 0
    assert all(len(t) == 5 for t in got.values())


def test_engine_reports_match_reference():
    # reference layers as a list: the bridge keeps the list, and the
    # per-site byte report then has the same rows on both sides
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = _both_stacks(False)
    assert isinstance(jparams["blocks"], list)
    jpol, jkw = _policy(jp, "slice", jcfg)
    tpol, tkw = _policy(tp, "slice", tcfg)
    je = jeng.PagedServeEngine(jmodel, jparams, n_slots=2, max_len=64,
                               policy=jpol, page_size=8, **jkw)
    te = teng.PagedServeEngine(tmodel, tparams, n_slots=2, max_len=64,
                               policy=tpol, page_size=8, device="cpu", **tkw)
    for mod, eng, vocab in ((jeng, je, jcfg.vocab), (teng, te, tcfg.vocab)):
        for r in _mixed_trace(mod, vocab, lengths=(20, 9)):
            eng.submit(r)
        eng.tick()
    assert te.kv_bytes() == je.kv_bytes()
    assert te.page_stats() == je.page_stats()
    assert te.weight_bytes == je.weight_bytes
    assert te.attn_backend == je.attn_backend == "compressed"
    assert te.kv == je.kv == "int8"


def test_engine_errors(setup):
    *_, tcfg, tmodel, tparams = setup
    with pytest.raises(ValueError, match="needs quantized KV storage"):
        teng.PagedServeEngine(
            tmodel, tparams, device="cpu", kv="fp",
            policy=tp.with_attn_backend(tp.preset("fp32"), "compressed"))
    with pytest.raises(ValueError, match="cannot admit a maximal request"):
        teng.PagedServeEngine(tmodel, tparams, device="cpu", n_pages=2,
                              max_len=64, page_size=8)
    with pytest.raises(ValueError, match="not a multiple of the KV page"):
        teng.PagedServeEngine(tmodel, tparams, device="cpu", page_size=8,
                              prefill_chunk=12)
    eng = teng.PagedServeEngine(tmodel, tparams, device="cpu", max_len=16)
    with pytest.raises(ValueError, match="exceeds engine max_len"):
        eng.submit(teng.Request(uid=0, prompt=np.zeros(12, np.int32),
                                max_new_tokens=8))
    eng.submit(teng.Request(uid=1, prompt=np.zeros(6, np.int32),
                            max_new_tokens=8))
    with pytest.raises(teng.TickBudgetExhausted) as e:
        eng.run_until_done(max_ticks=2)
    assert e.value.unfinished == [1]


def test_default_device_is_the_card_and_never_degrades(setup):
    *_, tcfg, tmodel, tparams = setup
    if torch.cuda.is_available():
        pytest.skip("this test is about a machine without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        t_build_model(tcfg)
    with pytest.raises(RuntimeError, match="cuda"):
        tmodel.inner.init(make_generator(0, "cpu"))  # device defaults to cuda
    with pytest.raises(RuntimeError, match="cuda"):
        teng.PagedServeEngine(tmodel, tparams)
    with pytest.raises(RuntimeError, match="cuda"):
        bridge.from_repro_params({}, tcfg)


def test_sampling_is_seeded_per_request(setup):
    *_, tcfg, tmodel, tparams = setup

    def run(seed):
        eng = teng.PagedServeEngine(tmodel, tparams, device="cpu", n_slots=2,
                                    max_len=64, page_size=8)
        rng = np.random.RandomState(0)
        for uid in range(3):
            eng.submit(teng.Request(
                uid=uid, prompt=rng.randint(0, tcfg.vocab, 7).astype(np.int32),
                max_new_tokens=6, temperature=0.9 if uid else 0.0,
                top_k=20, seed=seed + uid))
        return {c.uid: c.tokens for c in eng.run_until_done()}

    a, b, c = run(5), run(5), run(6)
    assert a == b  # same seeds, same streams
    assert a[0] == c[0]  # the greedy request ignores the seed
    assert (a[1], a[2]) != (c[1], c[2])
    assert all(0 <= t < tcfg.vocab for toks in a.values() for t in toks)


def test_bridge_rejects_unknown_keys(setup):
    jcfg, _, jparams, tcfg, *_ = setup
    tree = jax.device_get(jparams)
    bad = dict(tree, extra={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(KeyError, match="unknown top-level key"):
        bridge.from_repro_params(bad, tcfg, device="cpu")
    blocks = tree["blocks"]
    if isinstance(blocks, dict):
        blocks = dict(blocks, moe={"router": np.zeros((2, 2, 2), np.float32)})
    else:
        blocks = [dict(blocks[0], moe={"router": np.zeros((2, 2))})] + \
            list(blocks[1:])
    with pytest.raises(KeyError, match="unknown parameter key"):
        bridge.from_repro_params(dict(tree, blocks=blocks), tcfg,
                                 device="cpu")
    with pytest.raises(ValueError, match="n_layers"):
        bridge.from_repro_params(tree, tcfg.replace(n_layers=3),
                                 device="cpu")
