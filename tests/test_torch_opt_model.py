"""opt-tiny (2 layers) in the port vs the reference, on weights carried
across by the bridge: LayerNorm with bias, ReLU MLP, learned positions and
the tied embedding readout through every entry point — ``apply``,
``prefill`` + ``decode_step``, ``paged_step`` and ``loss`` — and
``apply(q=)`` with the reference's static-scale q tree bridged over.

Tolerance: rtol 1e-4, atol 1e-4 on logits and losses, the qwen2 parity
tests' bar (f32 contractions summed in another order; quantizer codes
agree, so no code flips are amplified at this size).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.core.recipe import apply_recipe as j_apply_recipe
from repro.models import build_model as j_build_model
from repro.nn.module import unbox
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tp
from repro_torch.models import build_model as t_build_model

TOL = dict(rtol=1e-4, atol=1e-4)
N_GROUP = 16  # divides opt-tiny's head_dim (32) and every width


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.fixture(scope="module")
def stacks():
    jcfg = j_get_config("opt-tiny").replace(n_layers=2)
    jmodel = j_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tcfg = t_get_config("opt-tiny").replace(n_layers=2)
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                       device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _policies(name):
    if name == "fp32":
        return jp.preset("fp32"), tp.preset("fp32")
    return (jp.preset(name, n=N_GROUP, n_layers=2),
            tp.preset(name, n=N_GROUP, n_layers=2))


def _tokens(seed, shape, vocab):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(
        np.int32)


def test_config_is_the_reference_config(stacks):
    jcfg, _, _, tcfg, _, tparams = stacks
    for key in ("n_layers", "d_model", "n_heads", "n_kv", "head_dim_",
                "d_ff", "vocab", "vocab_padded", "act", "norm", "pos",
                "max_position", "tied_embeddings", "qkv_bias"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    full = t_get_config("opt-125m")
    assert (full.n_layers, full.d_model, full.n_heads, full.d_ff,
            full.vocab_padded) == (12, 768, 12, 3072, 50432)
    assert "lm_head" not in tparams and "pos_embed" in tparams
    assert set(tparams["blocks"][0]["ln1"]) == {"scale", "bias"}


@pytest.mark.parametrize("policy", ["fp32", "w4a8_abfp", "w4a8_mse"])
def test_apply_matches_reference(stacks, policy):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    jpol, tpol = _policies(policy)
    tokens = _tokens(3, (2, 24), jcfg.vocab)
    jl, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens)}, jpol)
    tl, aux = tmodel.apply(tparams, {"tokens": tokens}, tpol)
    assert tl.shape == (2, 24, tcfg.vocab_padded) and float(aux) == 0.0
    _close(tl, jl)


@pytest.mark.parametrize("policy", ["fp32", "w4a8_abfp"])
def test_prefill_and_decode_match_reference(stacks, policy):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    jpol, tpol = _policies(policy)
    tokens = _tokens(4, (2, 20), jcfg.vocab)
    jl, jst = jmodel.prefill(jparams, {"tokens": jnp.asarray(tokens)}, jpol,
                             max_len=32)
    tl, tst = tmodel.prefill(tparams, {"tokens": torch.from_numpy(tokens)},
                             tpol, max_len=32)
    _close(tl, jl)
    for _ in range(3):
        nxt = np.array(jnp.argmax(jl[:, :jcfg.vocab], -1),
                         np.int32)[:, None]
        jl, jst = jmodel.decode_step(jparams, jnp.asarray(nxt), jst, jpol)
        tl, tst = tmodel.decode_step(tparams, torch.from_numpy(nxt), tst,
                                     tpol)
        _close(tl, jl)
    assert int(tst.position) == 23


def test_paged_step_matches_reference(stacks):
    """A 16-token prefill chunk (one row padded to 10) then a decode tick,
    through each stack's paged step over the same page table."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    jpol, tpol = _policies("w4a8_abfp")
    geo = dict(page_size=8, n_pages=8, max_pages_per_seq=4)
    table = np.arange(8, dtype=np.int32).reshape(2, 4)
    jst = jmodel.init_paged_state(2, **geo)
    jst = jst._replace(pages=jst.pages._replace(table=jnp.asarray(table)))
    tst = tmodel.init_paged_state(2, **geo)
    tst = tst._replace(pages=tst.pages._replace(
        table=torch.from_numpy(table)))
    tokens = _tokens(5, (2, 16), jcfg.vocab)
    n_valid = np.array([16, 10], np.int32)
    for step in range(2):
        jl, jst = jmodel.paged_step(jparams, jnp.asarray(tokens), jst,
                                    n_valid=jnp.asarray(n_valid),
                                    policy=jpol)
        tl, tst = tmodel.paged_step(tparams, torch.from_numpy(tokens), tst,
                                    n_valid=torch.from_numpy(n_valid),
                                    policy=tpol)
        _close(tl, jl)
        tokens = np.array(jnp.argmax(jl[:, :jcfg.vocab], -1),
                            np.int32)[:, None]
        n_valid = np.array([1, 1], np.int32)
    assert tst.position.tolist() == [17, 11]


@pytest.mark.parametrize("logits_chunk", [0, 8])
def test_loss_matches_reference(stacks, logits_chunk):
    """``Model.loss`` (masked next-token CE), whole or over 8-position
    chunks of the head (``chunked_lm_loss``)."""
    jcfg, _, jparams, tcfg, _, tparams = stacks
    jmodel = j_build_model(jcfg.replace(logits_chunk=logits_chunk))
    tmodel = t_build_model(tcfg.replace(logits_chunk=logits_chunk),
                           device="cpu")
    jpol, tpol = _policies("w4a8_abfp")
    tokens = _tokens(6, (2, 24), jcfg.vocab)
    labels = np.roll(tokens, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": tokens, "labels": labels}
    jloss, jm = jmodel.loss(jparams, jax.tree_util.tree_map(jnp.asarray,
                                                            batch), jpol)
    tloss, tm = tmodel.loss(tparams, batch, tpol)
    _close(tloss, jloss)
    _close(tm["ce"], jm["ce"])


def test_apply_with_bridged_qtree_matches_reference(stacks):
    """The reference's static-MSE q tree (w4a8_mse), carried across as
    device tensors, drives the port's layers to the reference's logits;
    without it the static scalers fall back to dynamic max, which moves
    the logits."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    jpol, tpol = _policies("w4a8_mse")
    calib = [{"tokens": _tokens(s, (2, 16), jcfg.vocab)} for s in (7, 8)]
    res = j_apply_recipe("static_mse", jmodel, jparams, calib, jpol)
    qtree = bridge.from_repro_qtree(jax.device_get(res.qtree), device="cpu")
    alpha = qtree["blocks"][1]["attn"]["probs"]["in_alpha"]
    assert alpha.dtype == torch.float32 and alpha.device.type == "cpu"
    tokens = _tokens(9, (2, 16), jcfg.vocab)
    jl, _ = jmodel.apply(jparams, {"tokens": jnp.asarray(tokens)}, jpol,
                         q=res.qtree)
    tl, _ = tmodel.apply(tparams, {"tokens": tokens}, tpol, q=qtree)
    _close(tl, jl)
    dyn, _ = tmodel.apply(tparams, {"tokens": tokens}, tpol)
    assert not torch.allclose(dyn, tl, **TOL)
