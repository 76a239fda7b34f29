"""The last dense configs in the port vs the reference: gemma2-9b,
granite-3-8b and h2o-danube-1.8b ``.reduced()`` (2 layers, d_model 64, 4
heads and 2 KV heads of 16, vocab 503 padded to 512) on weights carried
across by the bridge.  Gemma2 brings alternating local (window 8 reduced)
and global layers, attention and final softcaps, GeGLU, (1 + w) RMSNorms
before and after each half, the sqrt(d) embedding scale and a tied head;
Granite a tied head; Danube a sliding window on every layer and an untied
head.

``apply`` under fp32, w4a8_abfp and the fused P-fp / P-int8 policies (every
matmul through ``abfp_matmul`` / ``abfp_matmul_int8``, self-attention
through ``flash_attention`` where the reference takes its flash kernel:
never under Gemma2's softcap; on the CPU each wrapper runs its plain
version, the reference its Pallas kernels in interpret mode), the chunked
loss through the softcapped tied head, both engines' greedy tokens
(fixed-slot under P-fp, paged under P-C: compressed weights,
int8 pages, the ``compressed`` backend), the reference's fused prefill
that drops the window, the bridge and the full configs' shapes.

Tolerance: fp32 logits rtol 1e-4, atol 1e-4; quantized logits within the
``held`` share of how far QDQ moves them (``torch_ssm_helpers``); tokens
equal, paged ones up to a turn at a tie (``torch_arch_helpers``).  The
reference runs jitted.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.models import build_model as j_build_model
from repro.nn.module import unbox
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tp
from repro_torch.models import build_model as t_build_model

from test_torch_encdec import _Calls
from torch_arch_helpers import (TOL, both_stacks, policy, serve_fixed,
                                serve_paged, tokens_equal_or_tied)
from torch_ssm_helpers import held, shapes

ARCHS = ("gemma2-9b", "granite-3-8b", "h2o-danube-1.8b")
POLICIES = ("fp32", "w4a8_abfp", "p_fp", "p_int8")
B, S = 2, 24  # past the reduced window of 8


@pytest.fixture(scope="module", params=ARCHS)
def stacks(request):
    return both_stacks(request.param)


@pytest.fixture(scope="module")
def ref_logits(stacks):
    """The reference's logits under every policy of ``POLICIES`` on one
    batch, from one jitted function."""
    jcfg, jmodel, jparams, *_ = stacks
    rng = np.random.RandomState(1)
    batch = {"tokens": rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)}
    pols = [policy(jp, name)[0] for name in POLICIES]
    fn = jax.jit(lambda p, b: [jmodel.apply(p, b, pol)[0] for pol in pols])
    return batch, dict(zip(POLICIES, fn(jparams, batch)))


@pytest.mark.parametrize("name", POLICIES)
def test_apply_matches_reference(stacks, ref_logits, name, monkeypatch):
    """Logits at every position; one forward's wrapper calls: 7 matmuls a
    layer and the head, one flash_attention a layer under the fused
    backend except under Gemma2's attention softcap (``flash_ok`` is false
    there, as in the reference)."""
    *_, tcfg, tmodel, tparams = stacks
    batch, want = ref_logits
    calls = _Calls(monkeypatch)
    got, aux = tmodel.apply(tparams, batch, policy(tp, name)[0])
    assert got.shape == (B, S, tcfg.vocab_padded) and float(aux) == 0.0
    V = tcfg.vocab
    if name == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name]), **TOL)
    else:
        held(got[..., :V], want[name][..., :V], want["fp32"][..., :V], name)
    L = tcfg.n_layers
    mm = {"p_fp": "abfp_matmul", "p_int8": "abfp_matmul_int8"}.get(name)
    flash = 0 if tcfg.attn_softcap else L
    assert calls.take() == ({} if mm is None else
                            {mm: 7 * L + 1,
                             **({"flash_attention": flash} if flash else {})})


def test_fixed_engine_tokens_equal_reference(stacks):
    """P-fp: bucketed prefills (the 70-token prompt in a bucket of 128,
    which the routing groups of the MoE configs also need) and batched
    decode."""
    (_, want), (eng, got) = serve_fixed(stacks, "p_fp")
    assert got == want and all(len(t) == 5 for t in got.values())


def test_paged_engine_tokens_equal_reference(stacks):
    """P-C: compressed weights (the tied head keeps its runtime weight QDQ),
    int8 pages and the ``compressed`` attention backend (Gemma2's softcap
    takes the dequantize-then-reference path, as in the reference); a
    token may turn only at a tie."""
    jcfg = stacks[0]
    (je, want, jrows), (te, got, trows) = serve_paged(stacks, "p_c")
    turns = tokens_equal_or_tied(want, got, jrows, trows, jcfg.vocab)
    assert len(turns) <= 1, turns
    assert te.page_stats() == je.page_stats()
    # under scan-over-layers the reference reports one stacked site per
    # kernel kind; the port one per layer: the totals are the same
    for key in ("dense_kernel_bytes", "resident_kernel_bytes", "ratio"):
        assert te.weight_bytes[key] == je.weight_bytes[key], key


def test_chunked_loss_matches_reference(stacks):
    """``Model.loss`` through ``chunked_lm_loss`` (logits_chunk 8 on both
    stacks: the full configs of gemma2 and llama4 chunk their head) under
    fp32, beside the unchunked loss."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    rng = np.random.RandomState(2)
    toks = rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    jchunk = j_build_model(jcfg.replace(logits_chunk=8))
    want = jax.jit(lambda p: jchunk.loss(p, batch, jp.preset("fp32"))[0])(
        jparams)
    tchunk = t_build_model(tcfg.replace(logits_chunk=8), device="cpu")
    got, m = tchunk.loss(tparams, batch, tp.preset("fp32"))
    whole, _ = tmodel.loss(tparams, batch, tp.preset("fp32"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(got), float(whole), rtol=1e-5)
    assert float(m["aux"]) == 0.0


def test_fused_prefill_drops_the_window_as_the_reference_does():
    """Reduced Danube (window 8) under the fused attention backend at S =
    24: the reference's fused prefill calls the flash kernel with no window
    (``nn/attention.py:445-458``), so both stacks attend globally and
    causally, and both differ from the ``ref`` backend, which honours the
    window.  A fault of the reference, mirrored (ROADMAP.md Queue C)."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = both_stacks(
        "h2o-danube-1.8b")
    assert tcfg.window == 8 and not tcfg.alt_local_global
    rng = np.random.RandomState(4)
    batch = {"tokens": rng.randint(0, jcfg.vocab, (B, S)).astype(np.int32)}
    pols = {b: policy(jp, "fp32")[0] for b in ("fused", "ref")}
    want = jax.jit(lambda p: {b: jmodel.apply(p, batch, jp.with_attn_backend(
        pol, b))[0] for b, pol in pols.items()})(jparams)
    got = {b: tmodel.apply(tparams, batch, tp.with_attn_backend(
        tp.preset("fp32"), b))[0] for b in pols}
    for b in pols:
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want[b]),
                                   **TOL)
    V = tcfg.vocab
    w = np.asarray(want["fused"])[..., :V] - np.asarray(want["ref"])[..., :V]
    g = (got["fused"] - got["ref"])[..., :V].numpy()
    # the first 8 positions see no key past the window: equal there
    np.testing.assert_allclose(g[:, :8], 0.0, atol=1e-4)
    assert np.abs(w[:, 8:]).max() > 0.05 and np.abs(g[:, 8:]).max() > 0.05
    np.testing.assert_allclose(g, w, **TOL)


def test_bridge_carries_the_trees(stacks):
    """Gemma2's post-norms, the tied heads of Gemma2 and Granite (no
    ``lm_head``), Danube's untied head."""
    jcfg, _, jparams, tcfg, _, tparams = stacks
    b1 = tparams["blocks"][1]
    assert ("ln1_post" in b1) == tcfg.post_norms == ("ln1_post" in
                                                     jparams["blocks"])
    assert ("lm_head" in tparams) == (not tcfg.tied_embeddings)
    np.testing.assert_array_equal(b1["ffn"]["wg"]["kernel"].numpy(),
                                  jparams["blocks"]["ffn"]["wg"]["kernel"][1])
    if tcfg.post_norms:
        np.testing.assert_array_equal(
            b1["ln2_post"]["scale"].numpy(),
            jparams["blocks"]["ln2_post"]["scale"][1])


FULL = {"gemma2-9b": (9_241_100_288, 256_000, 42),
        "granite-3-8b": (8_171_552_768, 49_408, 40),
        "h2o-danube-1.8b": (1_831_075_840, 32_000, 24)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_shapes_are_the_references(arch):
    """At published size: the fields and parameter count are the
    reference's, and the port's tree on the meta device holds the shapes of
    the reference's ``jax.eval_shape(model.init)``."""
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    for key in ("family", "n_layers", "d_model", "n_heads", "n_kv",
                "head_dim_", "d_ff", "vocab", "vocab_padded", "act", "norm",
                "norm_plus_one", "post_norms", "window", "alt_local_global",
                "attn_softcap", "final_softcap", "rope_theta",
                "tied_embeddings", "logits_chunk"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    n, vocab, layers = FULL[arch]
    assert tcfg.n_params() == jcfg.n_params() == n
    assert tcfg.vocab_padded == vocab
    want = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), unbox(want))
    got = shapes(t_build_model(tcfg, device="meta").init(None))
    leaf = lambda s: isinstance(s, tuple)
    blocks = got.pop("blocks")
    block = jax.tree_util.tree_map(lambda s: s[1:], want.pop("blocks"),
                                   is_leaf=leaf)
    assert len(blocks) == layers and all(b == block for b in blocks)
    assert got == want
    assert torch.Size(got["embed"]["table"]) == (vocab, tcfg.d_model)
