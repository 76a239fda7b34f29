"""The VLM family in the port vs the reference: internvl2-2b ``.reduced()``
(2 layers, d_model 64, 4 heads and 2 KV heads of 16, SwiGLU, RMSNorm, rope
theta 1e6, vocab 503 padded to 512, untied head) on weights carried across
by the bridge, with 8 stub patch embeddings prepended to the text —
``apply`` under fp32, w4a8_abfp and the fused P-fp / P-int8 policies
(every matmul through ``abfp_matmul`` / ``abfp_matmul_int8``, the causal
self-attention over patches and text through ``flash_attention``; on the
CPU each wrapper runs its plain version, the reference its Pallas kernels
in interpret mode), ``loss`` over the text positions only, ``prefill``
after the patches and 8 greedy ``decode_step``s (fp32, and P-C on
compressed weights: the int8 ring through ``flash_attention_quant``), the
bridge and the full config's parameter shapes.

Tolerance: fp32 logits rtol 1e-4, atol 1e-4, losses rtol 1e-5, as in
``test_torch_encdec.py``.  Quantized logits are held as the SSM tests hold
theirs (``torch_ssm_helpers.held``): the stacks' RMSNorms round their mean
and rsqrt differently in the last bit, which can move an int8 activation
code of the next projection (P-int8 here: 1.0-1.7 % of the rms by which
QDQ moves the logits; the ABFP policies 5e-7), and the losses within the
same share of how far QDQ moves the loss (measured 0.8 %).  The P-C decode
logits are held at the fp32 tolerance, beside a check that QDQ moves them;
greedy tokens equal.  The reference runs jitted.
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
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import list_configs
from repro_torch.core import policy as tp
from repro_torch.models import build_model as t_build_model
from repro_torch.models import serving_transforms as tst
from repro_torch.models.lm import DecodeState, cross_entropy

from test_torch_encdec import _Calls, _close, _policy
from torch_ssm_helpers import QDQ_SHARE, held, shapes

ARCH = "internvl2-2b"
B, P, S = 2, 8, 12
PROMPT, MAX_LEN, STEPS = 4, 24, 8
POLICIES = ("fp32", "w4a8_abfp", "p_fp", "p_int8")


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


def _batch(cfg, seed=1, n_tokens=S):
    """Tokens, ``vision_patches`` patch embeddings at the embedding table's
    scale, and next-token labels over the text (-1 at its end)."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, cfg.vocab, (B, n_tokens)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels,
            "patch_embeds": (0.02 * rng.randn(
                B, cfg.vision_patches, cfg.d_model)).astype(np.float32)}


@pytest.fixture(scope="module")
def ref_logits(stacks):
    jcfg, jmodel, jparams, *_ = stacks
    batch = _batch(jcfg)
    pols = [_policy(jp, name) for name in POLICIES]
    fn = jax.jit(lambda p, b: [jmodel.apply(p, b, pol)[0] for pol in pols])
    return batch, dict(zip(POLICIES, fn(jparams, batch)))


@pytest.mark.parametrize("policy", POLICIES)
def test_apply_matches_reference(stacks, ref_logits, policy, monkeypatch):
    """Logits at every position, the patches' too; one forward's wrapper
    calls: q, k, v, o, wi, wg and wo a layer and the untied head, one
    flash_attention a layer under the fused backend."""
    *_, tcfg, tmodel, tparams = stacks
    batch, want = ref_logits
    calls = _Calls(monkeypatch)
    got, aux = tmodel.apply(tparams, batch, _policy(tp, policy))
    assert got.shape == (B, P + S, tcfg.vocab_padded) and float(aux) == 0.0
    V = tcfg.vocab
    if policy == "fp32":
        _close(got, want[policy])
    else:
        held(got[..., :V], want[policy][..., :V], want["fp32"][..., :V],
             policy)
    L = tcfg.n_layers
    mm = {"p_fp": "abfp_matmul", "p_int8": "abfp_matmul_int8"}.get(policy)
    assert calls.take() == ({} if mm is None else
                            {mm: 7 * L + 1, "flash_attention": L})


@pytest.mark.parametrize("policy", ("fp32", "p_int8"))
def test_loss_drops_the_patch_positions(stacks, policy):
    """``loss`` is the CE of the text positions' logits (the first
    ``vision_patches`` dropped) against labels over the text, as the
    reference's; the hidden states cover every position."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    batch = _batch(jcfg, seed=2)
    jpol, tpol = _policy(jp, policy), _policy(tp, policy)
    want, want_fp32, wh = jax.jit(lambda p: (
        jmodel.loss(p, batch, jpol)[0],
        jmodel.loss(p, batch, jp.preset("fp32"))[0],
        jmodel.apply(p, batch, jpol, return_hidden=True)[0]))(jparams)
    got, m = tmodel.loss(tparams, batch, tpol)
    assert float(m["aux"]) == 0.0
    if policy == "fp32":
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    else:
        moved = abs(float(want_fp32) - float(want))
        assert moved > 0.01
        assert abs(float(got) - float(want)) <= QDQ_SHARE * moved
    logits, _ = tmodel.apply(tparams, batch, tpol)
    manual = cross_entropy(logits[:, P:], torch.from_numpy(batch["labels"]),
                           tcfg.vocab)
    np.testing.assert_allclose(float(got), float(manual), rtol=1e-6)
    th, _ = tmodel.apply(tparams, batch, tpol, return_hidden=True)
    assert th.shape == (B, P + S, tcfg.d_model)
    if policy == "fp32":
        _close(th, wh)


@pytest.mark.parametrize("policy", ("fp32", "p_c"))
def test_prefill_after_patches_and_greedy_decode_match_reference(
        stacks, policy, monkeypatch):
    """A prefill of 8 patches and 4 prompt tokens into a ring of 24 (the
    state's position 12), then 8 greedy decode steps from position 12 on
    (the reference's argmax fed back to both): each step's logits against
    the reference's and the port's argmax equal to it; fp32, and P-C on
    compressed weights (every matmul, the untied head's too, through
    quant_matmul; each step's self-attention through
    flash_attention_quant over the int8 ring)."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    batch = _batch(jcfg, seed=3, n_tokens=PROMPT)
    del batch["labels"]

    def served(mod, st, params):
        pol = _policy(mod, policy)
        if policy != "p_c":
            return params, pol
        return st.compress_weights(params, pol), st.serving_policy(pol)

    jpre = jax.jit(lambda p, b: jmodel.prefill(
        served(jp, jst, p)[0], b, served(jp, jst, p)[1], max_len=MAX_LEN))
    jdec = jax.jit(lambda p, t, s: jmodel.decode_step(
        served(jp, jst, p)[0], t, s, served(jp, jst, p)[1]))
    tparams_s, tpol = served(tp, tst, tparams)
    calls = _Calls(monkeypatch)
    want, js = jpre(jparams, batch)
    got, ts = tmodel.prefill(tparams_s, batch, tpol, max_len=MAX_LEN)
    assert isinstance(ts, DecodeState)
    assert int(ts.position) == int(js.position) == P + PROMPT
    assert (ts.kv[0].k.dtype == torch.int8) == (policy == "p_c")
    calls.take()
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
        got, ts = tmodel.decode_step(tparams_s, torch.tensor(tok), ts, tpol)
    np.testing.assert_array_equal(np.stack(toks_t),
                                  np.concatenate(fed, axis=1).T)
    assert int(ts.position) == P + PROMPT + STEPS
    seq = dict(batch, tokens=np.concatenate([batch["tokens"]] + fed[:-1],
                                            axis=1))
    no_qdq = np.asarray(jax.jit(lambda p: jmodel.apply(
        p, seq, jp.preset("fp32"))[0])(jparams))[:, P + PROMPT - 1:, :V]
    rms = lambda a: float(np.sqrt(np.mean(np.square(a))))
    for i, (g, w) in enumerate(logits):
        assert policy == "fp32" or rms(no_qdq[:, i] - w) > 0.01, i
        _close(g, w)
    if policy == "p_c":
        L = tcfg.n_layers
        assert calls.take() == {"quant_matmul": STEPS * (7 * L + 1),
                                "flash_attention_quant": STEPS * L}


def test_bridge_carries_the_vlm_tree(stacks):
    """A decoder LM's tree with an untied ``lm_head``; without the head it
    is refused."""
    jcfg, jmodel, jparams, tcfg, _, tparams = stacks
    assert set(tparams) == {"embed", "blocks", "final_norm", "lm_head"}
    np.testing.assert_array_equal(tparams["lm_head"]["kernel"].numpy(),
                                  jparams["lm_head"]["kernel"])
    np.testing.assert_array_equal(
        tparams["blocks"][1]["ffn"]["wg"]["kernel"].numpy(),
        jparams["blocks"]["ffn"]["wg"]["kernel"][1])
    with pytest.raises(KeyError, match="lm_head"):
        bridge.from_repro_params({k: v for k, v in jparams.items()
                                  if k != "lm_head"}, tcfg, device="cpu")


def test_full_config_parameter_shapes_are_the_references():
    """internvl2-2b at published size (1.89 billion parameters, 7.6 GB in
    f32): the port's tree on the meta device holds the shapes of the
    reference's ``jax.eval_shape(model.init)``; the config's fields and
    parameter count are the reference's."""
    jcfg, tcfg = j_get_config(ARCH), t_get_config(ARCH)
    for key in ("family", "n_layers", "d_model", "n_heads", "n_kv",
                "head_dim_", "d_ff", "vocab", "vocab_padded", "act", "norm",
                "rope_theta", "vision_patches", "tied_embeddings"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    assert tcfg.vocab_padded == 92672 and tcfg.vision_patches == 256
    assert tcfg.n_params() == jcfg.n_params() == 1_889_533_952
    want = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), unbox(want))
    got = shapes(t_build_model(tcfg, device="meta").init(None))
    leaf = lambda s: isinstance(s, tuple)
    blocks = got.pop("blocks")
    block = jax.tree_util.tree_map(lambda s: s[1:], want.pop("blocks"),
                                   is_leaf=leaf)
    assert len(blocks) == 24 and all(b == block for b in blocks)
    assert got == want
    assert want["lm_head"]["kernel"] == (2048, 92672)
    assert ARCH in list_configs()
