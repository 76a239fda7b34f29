"""The state-space family in the port vs the reference: mamba2-130m
``.reduced()`` (2 Mamba2 blocks, d_model 64, chunk 16, vocab 503 padded
to 512, tied head) on weights carried across by the bridge — ``apply``,
``loss``, ``prefill`` and ``decode_step`` logits, the fixed-slot
``ServeEngine``'s greedy tokens for prompts of mixed lengths (exact-length
prefills, per-slot recurrent state), dense and compressed, the error cases
(``n_valid``, paged state), the bridge on stacked and listed trees, and the
full config's parameter shapes.

Tolerances (``torch_ssm_helpers``): fp32 logits rtol 1e-5, atol 1e-5 (f32
sums in another order).  Under the quantized policies each Mamba2 block
agrees with the reference's given the same input (``test_torch_ssm.py``),
but the stacks' RMSNorms round their f32 mean and rsqrt differently in the
last bit, which moves a few int8 activation codes across a rounding
boundary: the logits are held to 3 % of the root mean square by which QDQ
itself moves them (the fp32 run against the quantized one), measured at
under 1.5 %, and the greedy tokens are equal.  The reference runs jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.models import build_model as j_build_model
from repro.models import serving_transforms as jst
from repro.nn.module import unbox
from repro.serve import engine as jeng
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs
from repro_torch.core import policy as tp
from repro_torch.models import build_model as t_build_model
from repro_torch.models import serving_transforms as tst
from repro_torch.nn.ssm import SSMCache
from repro_torch.serve import engine as teng

from torch_ssm_helpers import FP32, Calls, held, shapes

ARCH = "mamba2-130m"
N_GROUP = 16  # divides d_model (64) and d_inner (128)
POLICIES = ("fp32", "w4a8_abfp", "p_fp", "p_int8")
B, S = 2, 20  # S spans the chunk of 16: the second chunk is padded


def _policy(mod, name):
    """(policy, engine kwargs); p_fp / p_int8: ``fused`` on every entry;
    compress: P-fp over compressed weights (P-C)."""
    fused = lambda p: mod.map_policies(p, lambda q: q.replace(fused=True))
    if name == "fp32":
        return mod.preset("fp32"), {}
    if name == "p_fp":
        return fused(mod.preset("w4a8_abfp", n=N_GROUP)), {}
    if name == "p_int8":
        return fused(mod.preset("w4a8_int8_native", n=N_GROUP)), {}
    if name == "compress":
        return fused(mod.preset("w4a8_abfp", n=N_GROUP)), {"compress": True}
    return mod.preset(name, n=N_GROUP), {}


@pytest.fixture(scope="module")
def stacks():
    jcfg = j_get_config(ARCH).reduced()
    jmodel = j_build_model(jcfg)
    jparams = unbox(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    tcfg = t_get_config(ARCH).reduced()
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                       device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def ref_logits(stacks):
    """The reference's logits of every policy in ``POLICIES`` on one batch
    (the real vocab), from one jitted function."""
    jcfg, jmodel, jparams, *_ = stacks
    toks = _tokens(jcfg)
    pols = [_policy(jp, name)[0] for name in POLICIES]
    fn = jax.jit(lambda p, t: [jmodel.apply(p, {"tokens": t}, pol)[0]
                               for pol in pols])
    return toks, dict(zip(POLICIES, fn(jparams, jnp.asarray(toks))))


# ------------------------------------------------------------ forward pass
@pytest.mark.parametrize("policy", POLICIES)
def test_apply_matches_reference(stacks, ref_logits, policy, monkeypatch):
    jcfg, _, _, tcfg, tmodel, tparams = stacks
    toks, want = ref_logits
    calls = Calls(monkeypatch)
    got, aux = tmodel.apply(tparams, {"tokens": toks},
                            _policy(tp, policy)[0])
    assert got.shape == (B, S, tcfg.vocab_padded) and float(aux) == 0.0
    assert bool((got[..., tcfg.vocab:] == -1e9).all())
    V = tcfg.vocab
    held(got[..., :V], want[policy][..., :V], want["fp32"][..., :V], policy)
    # in_proj and out_proj a block, and the tied head
    kernel = {"p_fp": "abfp_matmul", "p_int8": "abfp_matmul_int8"}.get(
        policy)
    want_calls = dict.fromkeys(Calls.NAMES, 0)
    if kernel:
        want_calls[kernel] = 2 * tcfg.n_layers + 1
    assert calls.calls == want_calls


def test_loss_matches_reference(stacks):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    toks = _tokens(jcfg, seed=2)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    want, wm = jax.jit(lambda p: jmodel.loss(p, batch, jp.preset("fp32")))(
        jparams)
    got, m = tmodel.loss(tparams, batch, tp.preset("fp32"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(m["aux"]) == float(wm["aux"]) == 0.0


@pytest.mark.parametrize("policy", ["fp32", "p_fp"])
def test_prefill_and_decode_match_reference(stacks, ref_logits, policy):
    """A 12-token prefill (one padded chunk) then 8 decode steps: each
    step's logits, the position and every layer's conv window and state."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    toks, ref = ref_logits
    no_qdq = np.asarray(ref["fp32"])  # the same tokens' fp32 logits
    jpol, tpol = _policy(jp, policy)[0], _policy(tp, policy)[0]
    jpre = jax.jit(lambda p, t, pol=jpol: jmodel.prefill(
        p, {"tokens": t}, pol, max_len=32))
    jdec = jax.jit(lambda p, t, s, pol=jpol: jmodel.decode_step(p, t, s, pol))
    want, js = jpre(jparams, toks[:, :12])
    got, ts = tmodel.prefill(tparams, {"tokens": toks[:, :12]}, tpol,
                             max_len=32)
    V = tcfg.vocab
    held(got[:, :V], want[:, :V], no_qdq[:, 11, :V], policy)
    assert int(ts.position) == 12 and ts.kv is None
    assert len(ts.ssm) == tcfg.n_layers
    assert all(isinstance(c, SSMCache) for c in ts.ssm)
    for t in range(12, S):
        tok = toks[:, t:t + 1]
        want, js = jdec(jparams, tok, js)
        got, ts = tmodel.decode_step(tparams, torch.from_numpy(tok), ts,
                                     tpol)
    held(got[:, :V], want[:, :V], no_qdq[:, -1, :V], policy)
    assert int(ts.position) == S
    for i, c in enumerate(ts.ssm):
        for got_c, want_c in ((c.conv, js.ssm.conv[i]),
                              (c.state, js.ssm.state[i])):
            if policy == "fp32":
                np.testing.assert_allclose(got_c.numpy(),
                                           np.asarray(want_c), **FP32)


def test_prefill_then_decode_equals_a_longer_prefill(stacks):
    """Recurrence consistency inside the port (fp32): a prefill of the
    first n tokens and decode steps give, at the same position, the logits
    of a prefill of all the tokens — across the chunk boundary (12 -> 20)
    and from one token."""
    *_, tcfg, tmodel, tparams = stacks
    toks = torch.from_numpy(_tokens(tcfg, seed=4))
    pol = tp.preset("fp32")
    want, _ = tmodel.prefill(tparams, {"tokens": toks}, pol)
    for n in (12, 1):
        got, st = tmodel.prefill(tparams, {"tokens": toks[:, :n]}, pol)
        for t in range(n, S):
            got, st = tmodel.decode_step(tparams, toks[:, t:t + 1], st, pol)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=5e-3,
                                   atol=5e-4)


# ---------------------------------------------------------------- serving
def _trace(mod, vocab, lengths=(2, 40), max_new=4, seed=3):
    """Prompts below d_conv - 1 (2) and across two chunk boundaries (40)."""
    rng = np.random.RandomState(seed)
    return [mod.Request(uid=i,
                        prompt=rng.randint(0, vocab, size=n).astype(np.int32),
                        max_new_tokens=max_new)
            for i, n in enumerate(lengths)]


def _serve(mod, model, params, policy, vocab, **kw):
    eng = mod.ServeEngine(model, params, n_slots=3, max_len=64,
                          policy=policy, **kw)
    for r in _trace(mod, vocab):
        eng.submit(r)
    return eng, {c.uid: c.tokens for c in eng.run_until_done()}


@pytest.mark.parametrize("name", ["fp32", "compress"])
def test_serve_engine_tokens_identical_to_reference(stacks, name,
                                                    monkeypatch):
    """Greedy tokens of the fixed-slot engine, dense (fp32) and compressed
    (P-C: in_proj / out_proj as packed int4 codes through ``quant_matmul``,
    the tied head through ``abfp_matmul``), equal the reference engine's;
    every prefill is exact-length (one per distinct prompt length).  The
    fused dense path's logits and decode are held by the tests above."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    jpol, jkw = _policy(jp, name)
    tpol, tkw = _policy(tp, name)
    _, want = _serve(jeng, jmodel, jparams, jpol, jcfg.vocab, **jkw)
    calls = Calls(monkeypatch)
    eng, got = _serve(teng, tmodel, tparams, tpol, tcfg.vocab,
                      device="cpu", **tkw)
    assert got == want
    assert len(got) == 2 and all(len(t) == 4 for t in got.values())
    assert eng.prefill_compiles == 2 and eng.prefills == 2
    assert eng.state.kv is None and len(eng.state.ssm) == tcfg.n_layers
    forwards = eng.prefills + eng.ticks
    L = tcfg.n_layers
    if name == "compress":
        assert eng.weight_bytes["compressed_sites"] == 2 * L
        assert calls.calls == {"abfp_matmul": forwards,
                               "abfp_matmul_int8": 0,
                               "quant_matmul": 2 * L * forwards}
    else:
        assert calls.calls == dict.fromkeys(Calls.NAMES, 0)


def test_engine_slot_state_is_the_prefill_state(stacks):
    """The slot's conv window and SSM state after admission are the batch-1
    prefill's, row for row."""
    *_, tcfg, tmodel, tparams = stacks
    pol = tp.preset("fp32")
    eng = teng.ServeEngine(tmodel, tparams, n_slots=3, max_len=64,
                           policy=pol, device="cpu")
    req = _trace(teng, tcfg.vocab, lengths=(9,))[0]
    eng.submit(req)
    eng._admit()
    _, sub = tmodel.prefill(tparams, {"tokens": req.prompt[None]}, pol)
    for full, part in zip(eng.state.ssm, sub.ssm):
        for f, p in zip(full, part):
            assert torch.equal(f[0], p[0])
            assert not f[1:].any()
    assert eng.state.position.tolist() == [9, 0, 0]


# ------------------------------------------------------------- the errors
def test_bucketed_prefill_and_paged_state_raise_as_the_reference(stacks):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    toks = _tokens(jcfg, shape=(1, 8))
    nv = np.array([5], np.int32)
    with pytest.raises(ValueError, match="exact length") as je:
        jmodel.prefill(jparams, {"tokens": toks}, jp.preset("fp32"),
                       n_valid=nv)
    with pytest.raises(ValueError, match="exact length") as te:
        tmodel.prefill(tparams, {"tokens": toks}, tp.preset("fp32"),
                       n_valid=torch.from_numpy(nv))
    assert str(te.value) == str(je.value)
    kw = dict(page_size=8, n_pages=16, max_pages_per_seq=8)
    with pytest.raises(TypeError, match="attention-family only") as je:
        jmodel.init_paged_state(2, **kw)
    with pytest.raises(TypeError, match="attention-family only") as te:
        tmodel.init_paged_state(2, **kw)
    assert str(te.value) == str(je.value)
    with pytest.raises(TypeError, match="attention-family only"):
        teng.PagedServeEngine(tmodel, tparams, n_slots=2, max_len=64,
                              device="cpu")


# ------------------------------------------------------------- the bridge
def test_bridge_carries_stacked_and_listed_trees(stacks):
    """The reference's scan-stacked tree and its listed one
    (``scan_layers=False``) carry across to the same per-layer dicts."""
    jcfg, jmodel, jparams, tcfg, _, tparams = stacks
    stacked = jax.device_get(jparams)
    assert stacked["blocks"]["mamba"]["in_proj"]["kernel"].shape == (
        2, 64, 296)
    listed_model = j_build_model(jcfg.replace(scan_layers=False))
    listed = jax.device_get(unbox(jax.jit(listed_model.init)(
        jax.random.PRNGKey(0))))
    assert isinstance(listed["blocks"], list)
    got = bridge.from_repro_params(listed, tcfg, device="cpu")
    for i in range(tcfg.n_layers):
        for k, v in listed["blocks"][i]["mamba"].items():
            if isinstance(v, dict):
                v = v.get("kernel", v.get("scale"))
                t = got["blocks"][i]["mamba"][k]
                t = t.get("kernel", t.get("scale"))
            else:
                t = got["blocks"][i]["mamba"][k]
            np.testing.assert_array_equal(t.numpy(), np.asarray(v))
        np.testing.assert_array_equal(
            tparams["blocks"][i]["mamba"]["A_log"].numpy(),
            stacked["blocks"]["mamba"]["A_log"][i])
    bad = dict(stacked, lora=stacked["embed"])
    with pytest.raises(KeyError, match="hybrid"):
        bridge.from_repro_params(bad, tcfg, device="cpu")


def test_full_config_parameter_shapes_are_the_references():
    """mamba2-130m at published size: the port's tree (built on the meta
    device: nothing allocated) holds, layer by layer, the shapes of the
    reference's ``jax.eval_shape(model.init)``."""
    jcfg, tcfg = j_get_config(ARCH), t_get_config(ARCH)
    want = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), unbox(want))
    got = shapes(t_build_model(tcfg, device="meta").init(None))
    stacked = want.pop("blocks")
    blocks = got.pop("blocks")
    assert got == want
    assert len(blocks) == tcfg.n_layers == 24
    per_layer = jax.tree_util.tree_map(
        lambda s: s[1:], stacked, is_leaf=lambda s: isinstance(s, tuple))
    assert all(b == per_layer for b in blocks)
    assert blocks[0]["mamba"]["in_proj"]["kernel"] == (768, 3352)
    assert got["embed"]["table"] == (50432, 768)


# ---------------------------------------------------------- configs, card
def test_config_is_the_references():
    assert {"mamba2-130m", "zamba2-7b"} <= set(list_configs())
    tcfg, jcfg = t_get_config(ARCH), j_get_config(ARCH)
    for key in ("family", "n_layers", "d_model", "vocab", "vocab_padded",
                "ssm_state", "ssm_expand", "ssm_head_dim", "ssm_chunk",
                "ssm_conv", "ssm_groups", "tied_embeddings", "norm"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    assert tcfg.n_params() == jcfg.n_params() == 128_999_424


def test_build_model_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default does not raise")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build_model(t_get_config(ARCH))
    assert t_build_model(t_get_config(ARCH).reduced(),
                         device="cpu").device.type == "cpu"


def test_compressed_tree_and_serving_policy(stacks):
    """Every Mamba2 projection becomes packed int4 codes; the tied table
    stays dense and keeps its runtime weight QDQ."""
    *_, tcfg, _, tparams = stacks
    pol = _policy(tp, "compress")[0]
    served = tst.compress_weights(tparams, pol)
    for b in served["blocks"]:
        for site in ("in_proj", "out_proj"):
            k = b["mamba"][site]["kernel"]
            assert isinstance(k, tst.CompressedKernel) and k.packed
    assert isinstance(served["embed"]["table"], torch.Tensor)
    sp = tst.serving_policy(pol)
    assert tp.resolve_policy(sp, "embed/attend").weight is not None
    assert tp.resolve_policy(sp, "blocks.0/mamba/in_proj").weight is None
    ref = jst.serving_policy(_policy(jp, "compress")[0])
    assert jp.resolve_policy(ref, "embed/attend").weight is not None
