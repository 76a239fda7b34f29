"""Speculative serving in the port against the reference, on weights carried
across by the bridge: ``chunk_step`` (the verify pass) against sequential
``decode_step`` on the f32 and the int8 ring and against the reference's
``chunk_step``, an invalid chunk tail that leaves live ring entries alone,
the paged verify pass and a rollback off the page grid, ``greedy_accept``
and ``rejection_accept`` bit-equal to the reference's, the engine's greedy
tokens equal to target-only serving and to the reference's
``SpeculativeServeEngine`` (fixed and paged), both page pools drained,
seeded sampling, and the constructor errors with the reference's text.

Reduced qwen2-7b carries the step-level checks, the reference's opt-tiny
proxy (``tests/test_speculative.py``) the engine-level ones.  Each
reference output is computed once, in a module fixture.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import messages as jmsg
from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.models import build_model as j_build_model
from repro.nn.module import unbox
from repro.serve import engine as jeng
from repro.serve import speculative as jspec
from repro_torch import bridge
from repro_torch.analysis import messages as tmsg
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tp
from repro_torch.models import build_model as t_build_model
from repro_torch.models.lm import DecodeState
from repro_torch.serve import engine as teng
from repro_torch.serve import speculative as tspec
from repro_torch.serve.kv_pages import PageGeometry

TOL = dict(rtol=2e-4, atol=2e-4)  # f32 logits summed in another order
N_GROUP = 16  # divides every reduced width


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's steps here are small eager ops; on one intra-op thread
    they do not wait on thread barriers when the suite's workers share
    the cores (a 0.2 s engine run took 16 s on 8 threads beside them).
    The thread count changes no result compared here."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _stacks(jcfg, tcfg, key: int):
    jmodel = j_build_model(jcfg)
    jparams = jax.device_get(unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(key))))
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jparams, tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


@pytest.fixture(scope="module")
def qwen():
    return _stacks(j_get_config("qwen2-7b").reduced(),
                   t_get_config("qwen2-7b").reduced(), 0)


OPT_TINY = dict(n_layers=2, d_model=64, n_heads=4, n_kv=4, head_dim=16,
                d_ff=256, vocab=211)


@pytest.fixture(scope="module")
def opt():
    """The reference's tiny OPT proxy for the engine-level checks."""
    return _stacks(j_get_config("opt-tiny").replace(**OPT_TINY),
                   t_get_config("opt-tiny").replace(**OPT_TINY), 1)


def _clone(state: DecodeState) -> DecodeState:
    """A deep copy of a ring DecodeState (the port writes it in place)."""
    kv = [type(c)(*(t.clone() if isinstance(t, torch.Tensor) else t
                    for t in c)) for c in state.kv]
    return state._replace(kv=kv, position=state.position.clone())


def _kv_policy(mod, ring: str):
    pol = mod.preset("fp32")
    return pol if ring == "fp" else mod.with_kv_cache(pol, "int8")


# ---------------------------------------------------------------------------
# the verify pass: one chunk == k sequential decode steps
# ---------------------------------------------------------------------------
PROMPT = np.array([3, 1, 4, 1, 5, 9, 2], np.int32)
CHUNK = np.array([7, 2, 9, 4], np.int32)


@pytest.fixture(scope="module")
def ref_chunk(qwen):
    """The reference's chunk_step logits on PROMPT + CHUNK, per ring."""
    jcfg, jmodel, jparams = qwen[:3]
    out = {}
    for ring in ("fp", "int8"):
        pol = _kv_policy(jp, ring)
        _, st0 = jmodel.prefill(jparams, {"tokens": jnp.asarray(PROMPT[None])},
                                pol, max_len=32)
        lg, _ = jmodel.chunk_step(jparams, jnp.asarray(CHUNK[None]), st0,
                                  n_valid=jnp.asarray([4], jnp.int32),
                                  policy=pol)
        out[ring] = np.asarray(lg[0])
    return out


@pytest.mark.parametrize("ring", ["fp", "int8"])
def test_chunk_step_matches_sequential_decode(qwen, ref_chunk, ring):
    tmodel, tparams = qwen[4], qwen[5]
    pol = _kv_policy(tp, ring)
    _, st0 = tmodel.prefill(tparams, {"tokens": PROMPT[None]}, pol,
                            max_len=32)
    assert (st0.kv[0].k_scale is not None) == (ring == "int8")
    st = _clone(st0)
    seq = []
    for t in CHUNK:
        lg, st = tmodel.decode_step(tparams, torch.tensor([[t]]), st, pol)
        seq.append(lg[0].numpy())
    lgc, stc = tmodel.chunk_step(tparams, torch.as_tensor(CHUNK[None]),
                                 _clone(st0), n_valid=torch.tensor([4]),
                                 policy=pol)
    assert lgc.shape == (1, 4, tmodel.cfg.vocab_padded)
    np.testing.assert_allclose(lgc[0].numpy(), np.stack(seq), **TOL)
    assert int(stc.position.reshape(-1)[0]) == int(st.position) == 11
    # the chunk wrote what the sequential steps wrote
    for a, b in zip(stc.kv, st.kv):
        np.testing.assert_allclose(a.k.float().numpy(), b.k.float().numpy(),
                                   **TOL)
    np.testing.assert_allclose(lgc[0].numpy(), ref_chunk[ring], **TOL)


def test_chunk_step_invalid_tail_preserves_live_entries(qwen):
    """A row with n_valid < S must not clobber the ring slots its invalid
    tail maps to: here the tail's position 16 wraps onto slot 0, which
    still holds the live position 0."""
    tmodel, tparams = qwen[4], qwen[5]
    pol = tp.preset("fp32")
    prompt = np.arange(1, 14, dtype=np.int32)  # 13 tokens in a ring of 16
    _, st0 = tmodel.prefill(tparams, {"tokens": prompt[None]}, pol,
                            max_len=16)
    toks = torch.tensor([[7, 2, 9, 4]])
    lg_part, st_part = tmodel.chunk_step(
        tparams, toks, _clone(st0), n_valid=torch.tensor([2]), policy=pol)
    lg_ref, st_ref = tmodel.chunk_step(
        tparams, toks[:, :2], _clone(st0), n_valid=torch.tensor([2]),
        policy=pol)
    np.testing.assert_allclose(lg_part[0, :2].numpy(), lg_ref[0].numpy(),
                               **TOL)
    assert int(st_part.position[0]) == int(st_ref.position[0]) == 15
    for a, b in zip(st_part.kv, st_ref.kv):
        assert torch.equal(a.k, b.k) and torch.equal(a.v, b.v)
    nxt = torch.tensor([[11]])
    la, _ = tmodel.decode_step(tparams, nxt, st_part, pol)
    lb, _ = tmodel.decode_step(tparams, nxt, st_ref, pol)
    np.testing.assert_array_equal(la.numpy(), lb.numpy())


def test_chunk_longer_than_the_ring_raises(qwen):
    tmodel, tparams = qwen[4], qwen[5]
    pol = tp.preset("fp32")
    _, st0 = tmodel.prefill(tparams, {"tokens": PROMPT[None, :3]}, pol,
                            max_len=4)
    with pytest.raises(ValueError, match="exceeds the ring-buffer cache "
                       "size 4; a chunk must not wrap over itself"):
        tmodel.chunk_step(tparams, torch.zeros((1, 5), dtype=torch.int32),
                          st0, n_valid=torch.tensor([5]), policy=pol)


def test_chunk_step_rejects_ssm_models():
    cfg = t_get_config("mamba2-130m").reduced()
    model = t_build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    st = model.init_decode_state(1, 16)
    with pytest.raises(TypeError, match="chunk_step is attention-family"):
        model.chunk_step(params, torch.zeros((1, 2), dtype=torch.int32), st,
                         n_valid=torch.tensor([2]))
    with pytest.raises(TypeError, match="speculative serving is "
                       "attention-family only"):
        tspec.SpeculativeServeEngine(
            model, params, draft_policy=tp.preset("w4a8_abfp"),
            compress_draft=False, device="cpu")


# ---------------------------------------------------------------------------
# the paged side
# ---------------------------------------------------------------------------
PAGED_GEO = PageGeometry(page_size=4, n_pages=16, max_len=32,
                         prefill_chunk=8)
PAGED_PROMPTS = [np.array([3, 1, 4, 1, 5], np.int32),        # ctx 5
                 np.array([2, 7, 1, 8, 2, 8, 1], np.int32)]  # ctx 7
PAGED_CHUNK = np.array([[9, 2, 6, 5], [4, 4, 3, 3]], np.int32)


def _paged_side(spec, model, params, pol, n_slots=2, geo=PAGED_GEO, **kw):
    return spec._PagedSide(model, params, pol, n_slots=n_slots, max_len=32,
                           geometry=geo, **kw)


def _fresh(spec, model, params, pol, **kw):
    side = _paged_side(spec, model, params, pol, **kw)
    for s, p in enumerate(PAGED_PROMPTS):
        side.reserve(s, len(p) + 8)
        side.prefill_into(s, p)
    ctx = np.array([len(p) for p in PAGED_PROMPTS], np.int32)
    side.set_positions(ctx if spec is jspec
                       else torch.as_tensor(ctx))
    return side


@pytest.fixture(scope="module")
def ref_paged_verify(qwen):
    jmodel, jparams = qwen[1], qwen[2]
    side = _fresh(jspec, jmodel, jparams, jp.preset("fp32"))
    return side.verify(PAGED_CHUNK, np.ones(2, bool))


def test_paged_verify_matches_sequential(qwen, ref_paged_verify):
    tmodel, tparams = qwen[4], qwen[5]
    pol = tp.preset("fp32")
    mask = np.ones(2, bool)
    vlog = _fresh(tspec, tmodel, tparams, pol, device="cpu").verify(
        PAGED_CHUNK, mask)
    assert vlog.shape == (2, 4, tmodel.cfg.vocab_padded)
    seq = _fresh(tspec, tmodel, tparams, pol, device="cpu")
    for j in range(PAGED_CHUNK.shape[1]):
        lg = seq.decode(PAGED_CHUNK[:, j:j + 1], mask)
        np.testing.assert_allclose(vlog[:, j], lg, **TOL)
    np.testing.assert_allclose(vlog, ref_paged_verify, **TOL)


def test_paged_rollback_non_page_aligned(qwen):
    """Verify overshoots, positions roll back to a point inside a page,
    decoding resumes: the stale K/V written past it must be invisible."""
    tmodel, tparams = qwen[4], qwen[5]
    pol = tp.preset("fp32")
    geo = PageGeometry(page_size=4, n_pages=8, max_len=32, prefill_chunk=8)
    prompt = PAGED_PROMPTS[0]  # ctx 5: mid-page
    mask = np.ones(1, bool)
    side = _paged_side(tspec, tmodel, tparams, pol, n_slots=1, geo=geo,
                       device="cpu")
    side.reserve(0, len(prompt) + 12)
    side.prefill_into(0, prompt)
    side.set_positions(torch.tensor([5], dtype=torch.int32))
    side.verify(PAGED_CHUNK[:1], mask)  # writes positions 5..8
    # accept 2 of 4: commit [9, 2] and roll back to 7 (the page boundary
    # is at 8)
    side.set_positions(torch.tensor([7], dtype=torch.int32))
    lg = side.decode(np.array([[6]], np.int32), mask)
    ref = _paged_side(tspec, tmodel, tparams, pol, n_slots=1, geo=geo,
                      device="cpu")
    ref.reserve(0, len(prompt) + 12)
    ref.prefill_into(0, np.concatenate([prompt, [9, 2]]).astype(np.int32))
    ref.set_positions(torch.tensor([7], dtype=torch.int32))
    np.testing.assert_allclose(
        lg, ref.decode(np.array([[6]], np.int32), mask), **TOL)


# ---------------------------------------------------------------------------
# acceptance rules: the reference's numpy, bit for bit
# ---------------------------------------------------------------------------
def test_greedy_accept_is_the_references():
    rng = np.random.RandomState(11)
    for _ in range(64):
        k = int(rng.randint(1, 6))
        vlogits = rng.randn(k + 1, 13).astype(np.float32)
        drafts = np.argmax(vlogits[:k], axis=-1)
        cut = int(rng.randint(0, k + 1))  # first disagreement (k: none)
        if cut < k:
            drafts[cut] = (drafts[cut] + 1 + rng.randint(12)) % 13
        got = tspec.greedy_accept(drafts, vlogits)
        assert got == jspec.greedy_accept(drafts, vlogits)
        assert got[0] == cut


@pytest.mark.parametrize("temperature,top_k", [(0.7, 0), (1.3, 5),
                                               (0.05, 3)])
def test_rejection_accept_is_the_references(temperature, top_k):
    rng = np.random.RandomState(5)
    outcomes = set()
    for seed in range(48):
        k = 3
        vlogits = rng.randn(k + 1, 17).astype(np.float32)
        dlogits = (vlogits[:k] + rng.randn(k, 17).astype(np.float32)
                   * rng.choice([0.0, 0.5, 3.0]))
        drafts = rng.randint(0, 17, size=k)
        r_t, r_j = np.random.default_rng(seed), np.random.default_rng(seed)
        got = tspec.rejection_accept(r_t, drafts, dlogits, vlogits,
                                     temperature, top_k)
        assert got == jspec.rejection_accept(r_j, drafts, dlogits, vlogits,
                                             temperature, top_k)
        assert r_t.random() == r_j.random()  # the streams moved alike
        outcomes.add(got[0])
        p = np.random.default_rng(seed)
        assert (tspec._host_sample(p, vlogits[0], temperature, top_k)
                == jspec._host_sample(np.random.default_rng(seed),
                                      vlogits[0], temperature, top_k))
    assert len(outcomes) > 1  # both accepting and rejecting paths ran


# ---------------------------------------------------------------------------
# the engine: greedy tokens == target-only == the reference's
# ---------------------------------------------------------------------------
LENGTHS = (5, 11, 3, 17, 8, 2)


def _mixed_trace(mod, vocab, max_new=5):
    rng = np.random.RandomState(7)
    return [mod.Request(uid=i,
                        prompt=rng.randint(0, vocab, n).astype(np.int32),
                        max_new_tokens=max_new)
            for i, n in enumerate(LENGTHS)]


def _spec_kw(mod, kv_cache: str) -> dict:
    kw = dict(target_policy=mod.preset("fp32"),
              draft_policy=mod.preset("w4a8_abfp"), draft_k=2, n_slots=3,
              max_len=64)
    if kv_cache == "paged":
        kw.update(kv_cache="paged", page_size=4, prefill_chunk=8)
    return kw


def _serve(eng, mod, vocab, n=len(LENGTHS)):
    for r in _mixed_trace(mod, vocab)[:n]:
        eng.submit(r)
    return eng, {c.uid: c.tokens for c in eng.run_until_done()}


@pytest.fixture(scope="module")
def ref_spec(opt):
    jcfg, jmodel, jparams = opt[:3]
    return {kv: _serve(jspec.SpeculativeServeEngine(
        jmodel, jparams, **_spec_kw(jp, kv)), jeng, jcfg.vocab)[1]
        for kv in ("fixed", "paged")}


@pytest.mark.parametrize("kv_cache", ["fixed", "paged"])
def test_speculative_greedy_tokens(opt, ref_spec, kv_cache):
    tcfg, tmodel, tparams = opt[3:]
    if kv_cache == "paged":
        base = teng.PagedServeEngine(tmodel, tparams, n_slots=3, max_len=64,
                                     policy=tp.preset("fp32"), page_size=4,
                                     prefill_chunk=8, device="cpu")
    else:
        base = teng.ServeEngine(tmodel, tparams, n_slots=3, max_len=64,
                                policy=tp.preset("fp32"), device="cpu")
    _, target_only = _serve(base, teng, tcfg.vocab)
    eng, toks = _serve(tspec.SpeculativeServeEngine(
        tmodel, tparams, device="cpu", **_spec_kw(tp, kv_cache)), teng,
        tcfg.vocab)
    assert toks == target_only
    assert toks == ref_spec[kv_cache]
    st = eng.acceptance_stats()
    assert st["accepted_per_target_step"] > 1.0  # the draft paid off
    assert st["draft_steps"] == 3 * st["rounds"]
    for c in eng.done:
        assert c.target_steps > 0
        assert c.drafted_tokens == 2 * c.target_steps
        assert 0 <= c.accepted_draft_tokens <= c.drafted_tokens
    if kv_cache == "paged":
        # zero pages in use after the drain, on BOTH pools
        for name, pool in eng.page_stats().items():
            assert pool["pages_in_use"] == 0, name
            assert pool["page_allocs"] == pool["page_frees"] > 0, name
    else:
        assert eng.page_stats() == {}


def test_speculative_int8_ring_kernel_policies_equal_target_only(qwen):
    """The chip's fixed-slot configuration at reduced width: a fused
    w8a8_abfp target and a compressed w4a8_abfp draft, both over an int8
    ring read by the ``compressed`` attention backend (verify at S = 4
    through ``flash_attention_quant``'s front end); greedy tokens equal
    the target-only engine's under the target's policy (which the fixed
    engine tests hold to the reference; the reference's speculative
    engine is compared in ``test_speculative_greedy_tokens``)."""
    fused = lambda p: tp.map_policies(p, lambda q: q.replace(fused=True))
    pol = lambda name: tp.with_attn_backend(fused(tp.with_kv_cache(
        tp.preset(name, n=N_GROUP), "int8")), "compressed")
    tcfg, tmodel, tparams = qwen[3:]
    kw = dict(n_slots=3, max_len=64, prefill_bucket=32, device="cpu")
    _, want = _serve(teng.ServeEngine(tmodel, tparams,
                                      policy=pol("w8a8_abfp"), **kw),
                     teng, tcfg.vocab, n=3)
    eng, got = _serve(tspec.SpeculativeServeEngine(
        tmodel, tparams, target_policy=pol("w8a8_abfp"),
        draft_policy=pol("w4a8_abfp"), draft_k=3, **kw), teng, tcfg.vocab,
        n=3)
    assert got == want
    assert eng.acceptance_stats()["accepted"] > 0


def test_speculative_sampling_is_seed_deterministic(opt):
    tcfg, tmodel, tparams = opt[3:]

    def run():
        eng = tspec.SpeculativeServeEngine(
            tmodel, tparams, target_policy=tp.preset("fp32"),
            draft_policy=tp.preset("w4a8_abfp"), draft_k=2, n_slots=2,
            max_len=64, device="cpu")
        rng = np.random.RandomState(3)
        for i, n in enumerate((6, 4, 9)):
            eng.submit(teng.Request(
                uid=i, prompt=rng.randint(0, tcfg.vocab, n).astype(np.int32),
                max_new_tokens=5, temperature=0.8, top_k=20, seed=100 + i))
        return {c.uid: c.tokens for c in eng.run_until_done()}

    first = run()
    assert first == run()
    assert all(len(t) == 5 for t in first.values())


# ---------------------------------------------------------------------------
# constructor errors: the reference's messages
# ---------------------------------------------------------------------------
def _ctor_error(spec, model, params, mod, **kw):
    with pytest.raises(ValueError) as e:
        eng = spec.SpeculativeServeEngine(model, params, **kw)
        eng.submit(mod.Request(uid=0, prompt=np.zeros(8, np.int32),
                               max_new_tokens=8))
    return str(e.value)


@pytest.mark.parametrize("case", ["draft_k", "kv_mismatch",
                                  "quantized_pages", "max_len"])
def test_constructor_errors_carry_the_references_messages(opt, case):
    def kw(mod):
        target, draft = mod.preset("fp32"), mod.preset("w4a8_abfp")
        int8 = lambda p: mod.with_kv_cache(p, "int8")
        return {
            "draft_k": dict(target_policy=target, draft_policy=draft,
                            draft_k=0, max_len=64),
            "kv_mismatch": dict(target_policy=target,
                                draft_policy=int8(draft), max_len=64),
            "quantized_pages": dict(target_policy=int8(target),
                                    draft_policy=int8(draft), max_len=64,
                                    kv_cache="paged"),
            "max_len": dict(target_policy=target, draft_policy=draft,
                            draft_k=4, max_len=16),
        }[case]

    got = _ctor_error(tspec, opt[4], opt[5], teng, device="cpu", **kw(tp))
    want = _ctor_error(jspec, opt[1], opt[2], jeng, **kw(jp))
    assert got == want
    expected = {"draft_k": tmsg.spec_draft_k_message(0, 64),
                "kv_mismatch": tmsg.spec_kv_mismatch_message("int8",
                                                             "requant"),
                "quantized_pages": tmsg.spec_quantized_pages_message("int8"),
                "max_len": None}[case]
    if expected is not None:
        assert got == expected


def test_messages_are_the_references():
    for name, args in (("spec_kv_mismatch_message", ("int8", "requant")),
                       ("spec_quantized_pages_message", ("fp8",)),
                       ("spec_draft_k_message", (0, 64))):
        assert getattr(tmsg, name)(*args) == getattr(jmsg, name)(*args)
