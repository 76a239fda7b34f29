"""The encoder-decoder family in the port vs the reference: whisper-large-v3
``.reduced()`` (2 encoder and 2 decoder layers, d_model 64, 4 heads and 2
KV heads of 16, vocab 503 padded to 512, tied head) on weights carried
across by the bridge, with 24 stub frame embeddings a stream — ``encode``,
``apply`` / ``loss`` under fp32, w4a8_abfp and the fused P-fp / P-int8
policies (every matmul through ``abfp_matmul`` / ``abfp_matmul_int8``, the
encoder's and the decoder's self-attention through ``flash_attention``; on
the CPU each wrapper runs its plain version, the reference its Pallas
kernels in interpret mode), ``prefill`` and 8 greedy ``decode_step``s from
the f32 ring, the int8 ring and on compressed weights (P-C: the int8 ring
through ``flash_attention_quant``), the errors the reference raises, the
bridge, the sinusoid table, the full config's parameter shapes and the
launcher.

Tolerance: rtol 1e-4, atol 1e-4 on logits and losses (f32 contractions
summed in another order; the quantizer codes agree at this size), as the
vision and opt parity tests hold theirs; greedy tokens equal.  The
reference runs jitted.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.models import build_model as j_build_model
from repro.models import lm as j_lm
from repro.models import serving_transforms as jst
from repro.nn.module import unbox
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs
from repro_torch.core import policy as tp
from repro_torch.kernels import flash_attention as t_fa
from repro_torch.kernels import flash_attention_quant as t_faq
from repro_torch.kernels import quant_matmul as t_qm
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as t_build_model
from repro_torch.models import lm as t_lm
from repro_torch.models import serving_transforms as tst
from repro_torch.models.encdec import EncDecState

from torch_ssm_helpers import shapes

ARCH = "whisper-large-v3"
TOL = dict(rtol=1e-4, atol=1e-4)
N_GROUP = 16  # divides every width of the reduced config (16, 32, 64, 128)
B, S, S_ENC = 2, 12, 24
PROMPT, MAX_LEN, STEPS = 4, 16, 8
POLICIES = ("fp32", "w4a8_abfp", "p_fp", "p_int8")
# an int8 ring's decode logits against the reference's, as a share of the
# rms by which QDQ moves them: one K / V code flipped at a rounding boundary
# moves them 4.0 % (see the decode test)
RING_SHARE = 0.1


def _policy(mod, name):
    """A policy of either stack; p_fp / p_int8: the fused paths (``fused``
    on every entry, the ``fused`` attention backend; P-fp without
    attention-BMM QDQ, so self-attention takes the flash kernel); p_c:
    w4a8_abfp, ``fused``, an int8 ring and the ``compressed`` backend (to
    pair with compressed weights)."""
    fused = lambda p: mod.map_policies(p, lambda q: q.replace(fused=True))
    if name == "fp32":
        return mod.preset("fp32")
    if name == "p_int8":
        return mod.with_attn_backend(
            fused(mod.preset("w4a8_int8_native", n=N_GROUP)), "fused")
    if name == "p_fp":
        pol = mod.map_policies(mod.preset("w4a8_abfp", n=N_GROUP),
                               lambda q: q.replace(attn_bmm=False))
        return mod.with_attn_backend(fused(pol), "fused")
    if name == "int8_ring":
        return mod.with_kv_cache(mod.preset("w4a8_abfp", n=N_GROUP), "int8")
    if name == "p_c":
        pol = mod.with_kv_cache(mod.preset("w4a8_abfp", n=N_GROUP), "int8")
        return mod.with_attn_backend(fused(pol), "compressed")
    return mod.preset(name, n=N_GROUP)


@pytest.fixture(scope="module")
def stacks():
    jcfg = j_get_config(ARCH).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jax.device_get(unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0))))
    tcfg = t_get_config(ARCH).reduced()
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jparams, tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _batch(cfg, seed=1, shape=(B, S)):
    rng = np.random.RandomState(seed)
    return {"tokens": rng.randint(0, cfg.vocab, shape).astype(np.int32),
            "frames": rng.randn(shape[0], S_ENC, cfg.d_model).astype(
                np.float32)}


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def ref_logits(stacks):
    """The reference's logits of every policy in ``POLICIES`` on one batch,
    from one jitted function."""
    jcfg, jmodel, jparams, *_ = stacks
    batch = _batch(jcfg)
    pols = [_policy(jp, name) for name in POLICIES]
    fn = jax.jit(lambda p, b: [jmodel.apply(p, b, pol)[0] for pol in pols])
    return batch, dict(zip(POLICIES, fn(jparams, batch)))


class _Calls:
    """Calls of the kernel wrappers the model makes (on the CPU each runs
    its plain version)."""

    WRAPPERS = ((t_qm, "abfp_matmul"), (t_qm, "abfp_matmul_int8"),
                (t_qm, "quant_matmul"), (t_fa, "flash_attention"),
                (t_faq, "flash_attention_quant"))

    def __init__(self, monkeypatch):
        self.calls = {name: 0 for _, name in self.WRAPPERS}
        for mod, name in self.WRAPPERS:
            monkeypatch.setattr(mod, name, self._counted(
                name, getattr(mod, name)))

    def _counted(self, name, fn):
        def call(*a, **kw):
            self.calls[name] += 1
            return fn(*a, **kw)
        return call

    def take(self) -> dict:
        out = {k: v for k, v in self.calls.items() if v}
        self.calls = dict.fromkeys(self.calls, 0)
        return out


def _forward_calls(cfg, policy, decode=False) -> dict:
    """Wrapper calls of one forward: 6 matmuls an encoder layer (q, k, v, o,
    wi, wo); 12 a decoder layer (self q, k, v, o; cross q, k, v, o — k and v
    of the decoder input are projected and then replaced, as in the
    reference — cross/k and cross/v of the encoder states, wi, wo), 10 at a
    decode step (the cross K/V come from the state); the tied head; under
    the fused backend one flash_attention a self-attention call."""
    E, L = cfg.encoder_layers, cfg.n_layers
    mm = {"p_fp": "abfp_matmul", "p_int8": "abfp_matmul_int8"}.get(policy)
    if mm is None:
        return {}
    if decode:
        return {mm: 10 * L + 1}
    return {mm: 6 * E + 12 * L + 1, "flash_attention": E + L}


@pytest.mark.parametrize("policy", POLICIES)
def test_apply_matches_reference(stacks, ref_logits, policy, monkeypatch):
    *_, tcfg, tmodel, tparams = stacks
    batch, want = ref_logits
    calls = _Calls(monkeypatch)
    got, aux = tmodel.apply(tparams, batch, _policy(tp, policy))
    assert got.shape == (B, S, tcfg.vocab_padded) and float(aux) == 0.0
    _close(got, want[policy])
    assert torch.all(got[..., tcfg.vocab:] == t_lm.NEG_INF)
    assert calls.take() == _forward_calls(tcfg, policy)


@pytest.mark.parametrize("policy", ("fp32", "p_int8"))
def test_loss_encode_and_hidden_match_reference(stacks, policy):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    batch = _batch(jcfg, seed=2)
    labels = np.roll(batch["tokens"], -1, axis=1)
    labels[:, -1] = -1
    batch["labels"] = labels
    jpol, tpol = _policy(jp, policy), _policy(tp, policy)
    want, wenc, wh = jax.jit(lambda p: (
        jmodel.loss(p, batch, jpol)[0],
        jmodel.inner.encode(p, jnp.asarray(batch["frames"]), jpol)[0],
        jmodel.apply(p, batch, jpol, return_hidden=True)[0]))(jparams)
    got, m = tmodel.loss(tparams, batch, tpol)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(m["aux"]) == 0.0
    enc, pos = tmodel.inner.encode(tparams, torch.from_numpy(
        batch["frames"]), tpol)
    _close(enc, wenc)
    assert torch.equal(pos, torch.arange(S_ENC, dtype=torch.int32)[
        None].expand(B, S_ENC))
    th, _ = tmodel.apply(tparams, batch, tpol, return_hidden=True)
    _close(th, wh)


def _served(mod, st, params, policy):
    """(params, policy) as served: P-C compresses the weights (packed int4
    codes) and pairs them with ``serving_policy``."""
    pol = _policy(mod, policy)
    if policy != "p_c":
        return params, pol
    return st.compress_weights(params, pol), st.serving_policy(pol)


@pytest.mark.parametrize("policy", ("fp32", "int8_ring", "p_c"))
def test_prefill_and_greedy_decode_match_reference(stacks, policy,
                                                   monkeypatch):
    """A 4-token prefill into a ring of 16, then 8 greedy decode steps (the
    reference's argmax fed back to both), each step's logits against the
    reference's and the port's own argmax equal to it: from the f32 ring
    (fp32), the int8 ring (w4a8_abfp with ``kv_cache='int8'``: dequantized
    on the plain path) and on compressed weights (P-C: the int8 ring
    through flash_attention_quant, every matmul through quant_matmul but
    the tied head's abfp_matmul).  The int8 rings are held as
    ``torch_ssm_helpers.held`` holds quantized logits: a K / V projection
    summed in another order can put a value a few ulps from a rounding
    boundary of its int8 code (measured: 4e-6 of a code step, at one step
    of this run), and the flipped code moves the later steps' logits by
    4.0 % of the rms by which QDQ moves them (1e-6 before it), so the
    int8 ring under w4a8_abfp is held within ``RING_SHARE`` of that rms.
    P-C flips no code in this run (5e-7 of that rms at every step) and is
    held at ``TOL``, as fp32 is, beside a check that QDQ does move its
    logits."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    batch = _batch(jcfg, seed=3, shape=(B, PROMPT))

    def served(p):  # the reference compresses inside its jitted steps
        return _served(jp, jst, p, policy)

    jpre = jax.jit(lambda p, b: jmodel.prefill(
        served(p)[0], b, served(p)[1], max_len=MAX_LEN))
    jdec = jax.jit(lambda p, t, s: jmodel.decode_step(
        served(p)[0], t, s, served(p)[1]))
    tp_params, tpol = _served(tp, tst, tparams, policy)
    calls = _Calls(monkeypatch)
    want, js = jpre(jparams, batch)
    got, ts = tmodel.prefill(tp_params, batch, tpol, max_len=MAX_LEN)
    assert isinstance(ts, EncDecState) and int(ts.position) == PROMPT
    int8 = policy != "fp32"
    assert (ts.kv[0].k.dtype == torch.int8) == int8 == (
        js.kv.k.dtype == jnp.int8)
    assert tuple(ts.cross_k.shape) == js.cross_k.shape == (
        tcfg.n_layers, B, S_ENC, tcfg.n_kv * tcfg.head_dim_)
    _close(ts.cross_k, js.cross_k)
    np.testing.assert_array_equal(ts.enc_pos.numpy(), np.asarray(js.enc_pos))
    pre_calls = calls.take()
    V = tcfg.vocab
    fed, toks_t, logits = [], [], []
    for step in range(STEPS + 1):
        logits.append((got[:, :V], np.asarray(want)[:, :V]))
        toks_t.append(torch.argmax(got[:, :V], dim=-1).numpy())
        tok = np.asarray(jnp.argmax(want[:, :V], axis=-1), np.int32)[:, None]
        fed.append(tok)
        if step == STEPS:
            break
        want, js = jdec(jparams, tok, js)
        got, ts = tmodel.decode_step(tp_params, torch.tensor(tok), ts,
                                     tpol)
    np.testing.assert_array_equal(np.stack(toks_t),
                                  np.concatenate(fed, axis=1).T)
    assert int(ts.position) == PROMPT + STEPS
    # the same positions' fp32 logits: the no-QDQ yardstick of ``held``
    seq = dict(batch, tokens=np.concatenate([batch["tokens"]] + fed[:-1],
                                            axis=1))
    no_qdq = np.asarray(jax.jit(lambda p: jmodel.apply(
        p, seq, jp.preset("fp32"))[0])(jparams))[:, PROMPT - 1:, :V]
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    for i, (g, w) in enumerate(logits):
        gap, qdq = rms(g.numpy() - w), rms(no_qdq[:, i] - w)
        if policy == "int8_ring":
            assert qdq > 0.01 and gap <= RING_SHARE * qdq, (i, gap, qdq)
            continue
        assert policy == "fp32" or qdq > 0.01, (i, qdq)
        _close(g, w)
    if policy == "fp32":
        for i, c in enumerate(ts.kv):
            _close(c.k, js.kv.k[i])
            _close(c.v, js.kv.v[i])
    if policy == "p_c":
        L, E = tcfg.n_layers, tcfg.encoder_layers
        # the prefill: attention-BMM QDQ keeps every attention on the plain
        # path; each decode step's self-attention reads the int8 ring
        assert pre_calls == {"quant_matmul": 6 * E + 12 * L,
                             "abfp_matmul": 1}
        assert calls.take() == {"quant_matmul": STEPS * 10 * L,
                                "abfp_matmul": STEPS,
                                "flash_attention_quant": STEPS * L}


def test_init_decode_state_ignores_kv_quant_as_the_reference(stacks):
    """An f32 ring even with ``kv_quant=True``, zero cross K/V of
    ``enc_len`` positions and position 0: the reference's state, field by
    field."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    js = jmodel.init_decode_state(B, MAX_LEN, enc_len=S_ENC, kv_quant=True)
    ts = tmodel.init_decode_state(B, MAX_LEN, enc_len=S_ENC, kv_quant=True)
    assert len(ts.kv) == tcfg.n_layers and ts.kv[0].k_scale is None
    assert tuple(ts.kv[0].k.shape) == js.kv.k.shape[1:]
    assert ts.kv[0].k.dtype == torch.float32
    assert js.kv.k.dtype == jnp.float32
    assert tuple(ts.cross_v.shape) == js.cross_v.shape
    np.testing.assert_array_equal(ts.enc_pos.numpy(), np.asarray(js.enc_pos))
    assert int(ts.position) == int(js.position) == 0


def test_policy_maps_raise_as_the_reference(stacks):
    """Layer-indexed rules: ``reject_layer_rules`` in ``apply``, ``prefill``
    and ``decode_step``; site-rule maps: ``compress_weights`` and
    ``prequantize_weights`` (the tree's paths are not its sites) — the
    reference's messages, word for word.  A flat policy compresses the
    cross-attention projections too."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    batch = _batch(jcfg, shape=(1, 4))
    layer = lambda mod: mod.PolicyMap(name="l", rules=(mod.PolicyRule(
        "blocks.0/*", mod.preset("fp32")),), default=mod.preset("w4a8_abfp"))
    jstate = jmodel.init_decode_state(1, 8, enc_len=S_ENC)
    tstate = tmodel.init_decode_state(1, 8, enc_len=S_ENC)
    tok = np.zeros((1, 1), np.int32)
    for run_j, run_t in (
            (lambda: jmodel.apply(jparams, batch, layer(jp)),
             lambda: tmodel.apply(tparams, batch, layer(tp))),
            (lambda: jmodel.prefill(jparams, batch, layer(jp)),
             lambda: tmodel.prefill(tparams, batch, layer(tp))),
            (lambda: jmodel.decode_step(jparams, tok, jstate, layer(jp)),
             lambda: tmodel.decode_step(tparams, torch.from_numpy(tok),
                                        tstate, layer(tp)))):
        with pytest.raises(NotImplementedError, match="EncDecLM") as je:
            run_j()
        with pytest.raises(NotImplementedError, match="EncDecLM") as te:
            run_t()
        assert str(te.value) == str(je.value)
    messages = []
    for mod, params, st in ((jp, jparams, jst), (tp, tparams, tst)):
        pm = mod.PolicyMap(name="m", rules=(
            mod.PolicyRule("cross/*", mod.preset("fp32")),),
            default=mod.preset("w4a8_abfp"))
        for fn in (st.compress_weights, st.prequantize_weights):
            with pytest.raises(NotImplementedError,
                               match="site addresses") as e:
                fn(params, pm)
            messages.append(str(e.value))
    assert messages[:2] == messages[2:]
    served = tst.compress_weights(tparams, tp.preset("w4a8_abfp"))
    for nm in ("q", "k", "v", "o"):
        assert isinstance(served["decoder"][1]["cross_attn"][nm]["kernel"],
                          tst.CompressedKernel)
    assert isinstance(served["encoder"][0]["mlp"]["wo"]["kernel"],
                      tst.CompressedKernel)
    assert served["embed"]["table"] is tparams["embed"]["table"]


def test_bridge_carries_the_encdec_tree(stacks):
    """Stacked (L, ...) and listed layers alike; a missing or a foreign key
    and a wrong layer count raise."""
    jcfg, jmodel, jparams, tcfg, _, tparams = stacks
    assert len(tparams["encoder"]) == tcfg.encoder_layers
    assert len(tparams["decoder"]) == tcfg.n_layers
    np.testing.assert_array_equal(
        tparams["decoder"][1]["cross_attn"]["k"]["bias"].numpy(),
        jparams["decoder"]["cross_attn"]["k"]["bias"][1])
    np.testing.assert_array_equal(
        tparams["encoder"][0]["mlp"]["wi"]["kernel"].numpy(),
        jparams["encoder"]["mlp"]["wi"]["kernel"][0])
    listed = dict(jparams, decoder=[
        jax.tree_util.tree_map(lambda a, i=i: a[i], jparams["decoder"])
        for i in range(tcfg.n_layers)])
    again = bridge.from_repro_params(listed, tcfg, device="cpu")
    assert torch.equal(again["decoder"][1]["ln_x"]["scale"],
                       tparams["decoder"][1]["ln_x"]["scale"])
    with pytest.raises(KeyError, match="missing"):
        bridge.from_repro_params({k: v for k, v in jparams.items()
                                  if k != "enc_norm"}, tcfg, device="cpu")
    with pytest.raises(KeyError, match="encdec"):
        bridge.from_repro_params(jparams, t_get_config("qwen2-7b").reduced(),
                                 device="cpu")
    with pytest.raises(ValueError, match="decoder layers"):
        bridge.from_repro_params(jparams, tcfg.replace(n_layers=3),
                                 device="cpu")


@pytest.mark.parametrize("S_len,d", [(S_ENC, 64), (1500, 1280)])
def test_sinusoid_table_is_the_references_within_one_ulp(S_len, d):
    """The encoder's position table: the reference's jitted ``_sinusoid``
    (XLA folds it: ``10000 ** (dim / d)`` correctly rounded, the division
    taken as a product with the f32 reciprocal, XLA's own sin and cos)
    against the port's, formed once on the host.  The exponent and the
    angle are bit-equal by construction; XLA's sin and cos are not
    correctly rounded, so the bar is one unit in the last place of every
    entry, with at most 2 % of the entries off (1.3 % measured at Whisper's
    1,500 x 1,280).  torch's own f32 ``pow``, division, ``sin`` and ``cos``
    would miss it: a quarter of the entries off, by up to an ulp of the
    angle."""
    want = np.asarray(jax.jit(j_lm._sinusoid, static_argnums=(0, 1))(
        S_len, d))
    got = t_lm._sinusoid(S_len, d).numpy()
    assert got.dtype == np.float32 and got.shape == (S_len, d)
    assert np.all(np.abs(got - want) <= np.spacing(np.abs(want)))
    assert np.mean(got != want) <= 0.02
    naive = t_lm._sinusoid_at(torch.arange(S_len, dtype=torch.int32)[None],
                              d)[0].numpy()
    if S_len == 1500:
        assert np.mean(naive != want) > 0.2


def test_full_config_parameter_shapes_are_the_references():
    """whisper-large-v3 at published size (1.62 billion parameters with the
    65,536 learned positions, 6.5 GB in f32): the port's tree built on the meta device holds the
    shapes of the reference's ``jax.eval_shape(model.init)``, layer by
    layer; the config's fields and parameter count are the reference's."""
    jcfg, tcfg = j_get_config(ARCH), t_get_config(ARCH)
    for key in ("family", "n_layers", "encoder_layers", "d_model",
                "n_heads", "n_kv", "head_dim_", "d_ff", "vocab",
                "vocab_padded", "act", "norm", "pos", "max_position",
                "tied_embeddings"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    assert tcfg.vocab_padded == 51968
    assert tcfg.n_params() == jcfg.n_params() == 1_534_525_440
    want = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), unbox(want))
    got = shapes(t_build_model(tcfg, device="meta").init(None))
    leaf = lambda s: isinstance(s, tuple)
    for key, n in (("encoder", 32), ("decoder", 32)):
        layers = got.pop(key)
        block = jax.tree_util.tree_map(lambda s: s[1:], want.pop(key),
                                       is_leaf=leaf)
        assert len(layers) == n and all(b == block for b in layers)
    assert got == want
    assert want["pos_embed"] == (65536, 1280)
    assert ARCH in list_configs()


# --------------------------------------------------------------- launcher
@pytest.mark.parametrize("arch,paged,error", [
    ("whisper-large-v3", False, TypeError),
    ("whisper-large-v3", True, AttributeError),
    ("internvl2-2b", False, KeyError),
    ("internvl2-2b", True, None)])
def test_launcher_fails_as_the_reference(arch, paged, error, capsys):
    """The reference launcher serves neither family: the fixed-slot engine
    takes no ``EncDecState`` (``TypeError``), ``EncDecLM`` has no paged state
    (``AttributeError``), a VLM prefill without patch embeddings fails in
    ``_split_batch`` (``KeyError``); the paged engine serves a VLM's text
    alone.  The port's launcher does the same."""
    flags = ["--arch", arch, "--n-requests", "2", "--max-new-tokens", "3",
             "--max-len", "32", "--device", "cpu"] + (["--paged"] if paged
                                                      else [])
    if error is None:
        assert tserve.main(flags) == 0
        assert '"engine": "paged"' in capsys.readouterr().out
        return
    with pytest.raises(error, match={
            TypeError: "EncDecState", AttributeError: "init_paged_state",
            KeyError: "patch_embeds"}[error]):
        tserve.main(flags)
