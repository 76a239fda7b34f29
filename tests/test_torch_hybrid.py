"""The Zamba2 hybrid in the port vs the reference: zamba2-7b ``.reduced()``
(one group of 2 Mamba2 blocks and one shared-attention invocation with its
LoRA, d_model 64, 4 heads of 16 over concat(x, x0), vocab 503 padded to
512, tied head) on weights carried across by the bridge — ``apply``,
``loss``, ``prefill`` and ``decode_step`` past the ring's wrap, dense
(fp32, w4a8_abfp, the fused P-fp) and compressed, the errors the reference
raises (compressed weights under a fused policy, site-rule and layer-rule
policy maps, ``ServeEngine``, ``n_valid``), the bridge, the full config's
parameter shapes and the launcher.

Tolerances as in ``torch_ssm_helpers``: fp32 logits rtol 1e-5, atol
1e-5; quantized logits within 3 % of the rms by which QDQ moves them (the
stacks' RMSNorms differ in the last bit, which can move an int8 code).  The
LoRA B matrices are drawn nonzero here (the init zeroes them), so the
folded deltas count.  The reference runs jitted.
"""

import json

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
from repro_torch.core import policy as tp
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as t_build_model
from repro_torch.models import serving_transforms as tst
from repro_torch.models.hybrid import HybridState
from repro_torch.serve import engine as teng

from torch_ssm_helpers import FP32, Calls, held, shapes

ARCH = "zamba2-7b"
N_GROUP = 16  # divides d_model (64), 2 d_model and d_ff (128)
POLICIES = ("fp32", "w4a8_abfp", "p_fp")
# the prefill / decode and compressed runs: their fp32 counterpart is the
# ``ref_logits`` fixture's run on the same tokens
B, S = 2, 12


def _policy(mod, name):
    if name == "fp32":
        return mod.preset("fp32")
    if name == "p_fp":
        return mod.map_policies(mod.preset("w4a8_abfp", n=N_GROUP),
                                lambda q: q.replace(fused=True))
    return mod.preset(name, n=N_GROUP)


@pytest.fixture(scope="module")
def stacks():
    jcfg = j_get_config(ARCH).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jax.device_get(unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0))))
    rng = np.random.RandomState(7)
    for nm, lo in jparams["lora"].items():
        lo["B"] = (rng.randn(*lo["B"].shape) * 0.05).astype(np.float32)
    tcfg = t_get_config(ARCH).reduced()
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jparams, tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def _tokens(cfg, seed=1, shape=(B, S)):
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def ref_logits(stacks):
    jcfg, jmodel, jparams, *_ = stacks
    toks = _tokens(jcfg)
    pols = [_policy(jp, name) for name in POLICIES]
    fn = jax.jit(lambda p, t: [jmodel.apply(p, {"tokens": t}, pol)[0]
                               for pol in pols])
    return toks, dict(zip(POLICIES, fn(jparams, jnp.asarray(toks))))


@pytest.mark.parametrize("policy", POLICIES)
def test_apply_matches_reference(stacks, ref_logits, policy, monkeypatch):
    *_, tcfg, tmodel, tparams = stacks
    toks, want = ref_logits
    calls = Calls(monkeypatch)
    got, aux = tmodel.apply(tparams, {"tokens": toks}, _policy(tp, policy))
    assert got.shape == (B, S, tcfg.vocab_padded) and float(aux) == 0.0
    V = tcfg.vocab
    held(got[..., :V], want[policy][..., :V], want["fp32"][..., :V], policy)
    # per group: 2 projections a Mamba2 block, q, k, v, o, wi, wg, wo of
    # the shared invocation; and the tied head
    n = (2 * (tcfg.shared_attn_every - 1) + 7) * (
        tcfg.n_layers // tcfg.shared_attn_every) + 1
    assert calls.calls == {"abfp_matmul": n if policy == "p_fp" else 0,
                           "abfp_matmul_int8": 0, "quant_matmul": 0}


def test_loss_and_hidden_match_reference(stacks):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    toks = _tokens(jcfg, seed=2)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    fp = jp.preset("fp32")
    want, _ = jax.jit(lambda p: jmodel.loss(p, batch, fp))(jparams)
    got, m = tmodel.loss(tparams, batch, tp.preset("fp32"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    assert float(m["aux"]) == 0.0
    jh = jax.jit(lambda p: jmodel.apply(p, batch, fp,
                                        return_hidden=True)[0])(jparams)
    th, _ = tmodel.apply(tparams, batch, tp.preset("fp32"),
                         return_hidden=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **FP32)


@pytest.mark.parametrize("policy", ["fp32", "compressed"])
def test_prefill_and_decode_past_the_ring_wrap(stacks, ref_logits, policy):
    """A 6-token prefill into a ring of 8, then 6 decode steps (positions 6
    to 11: the ring wraps at 8), each step's logits against the
    reference's, dense (fp32) and compressed (w4a8_abfp served: packed
    int4 codes, q / k / v decompressed for the LoRA); the position, the
    ring's contents and ``x0`` (carried unchanged, as the reference
    carries it)."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    toks, ref = ref_logits
    no_qdq = np.asarray(ref["fp32"])  # the same tokens' fp32 logits
    pol = jp.preset("w4a8_abfp", n=N_GROUP)

    def served(p):  # the reference compresses inside its jitted steps
        return p if policy == "fp32" else jst.compress_weights(p, pol)

    if policy == "fp32":
        jpol, tpol = _policy(jp, policy), _policy(tp, policy)
    else:
        jpol = jst.serving_policy(pol)
        tpol = tst.serving_policy(tp.preset("w4a8_abfp", n=N_GROUP))
        tparams = tst.compress_weights(tparams,
                                       tp.preset("w4a8_abfp", n=N_GROUP))
    jpre = jax.jit(lambda p, t: jmodel.prefill(served(p), {"tokens": t},
                                               jpol, max_len=8))
    jdec = jax.jit(lambda p, t, s: jmodel.decode_step(served(p), t, s,
                                                      jpol))
    V = tcfg.vocab
    want, js = jpre(jparams, toks[:, :6])
    got, ts = tmodel.prefill(tparams, {"tokens": toks[:, :6]}, tpol,
                             max_len=8)
    assert isinstance(ts, HybridState) and int(ts.position) == 6
    held(got[:, :V], want[:, :V], no_qdq[:, 5, :V], policy)
    x0 = ts.x0.clone()
    for t in range(6, S):
        tok = toks[:, t:t + 1]
        want, js = jdec(jparams, tok, js)
        got, ts = tmodel.decode_step(tparams, torch.from_numpy(tok), ts,
                                     tpol)
        held(got[:, :V], want[:, :V], no_qdq[:, t, :V], policy)
    assert int(ts.position) == S and torch.equal(ts.x0, x0)
    np.testing.assert_allclose(x0.numpy(), np.asarray(js.x0), **FP32)
    if policy == "fp32":
        for g, kvc in enumerate(ts.kv):
            np.testing.assert_allclose(kvc.k.numpy(),
                                       np.asarray(js.kv.k[g]), **FP32)
        for g, group in enumerate(ts.ssm):
            for j, c in enumerate(group):
                np.testing.assert_allclose(c.state.numpy(), np.asarray(
                    js.ssm.state[g, j]), **FP32)


def test_compressed_weights_match_reference(stacks, ref_logits,
                                            monkeypatch):
    """Compressed serving (w4a8_abfp, not fused: the reference's hybrid
    runs no kernel on compressed weights, see below): the Mamba2, shared
    o and MLP kernels as packed int4 codes, the shared q / k / v
    decompressed before the LoRA is folded in."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    pol_j, pol_t = jp.preset("w4a8_abfp", n=N_GROUP), tp.preset(
        "w4a8_abfp", n=N_GROUP)
    tserved = tst.compress_weights(tparams, pol_t)
    for nm in ("q", "k", "v", "o"):
        assert isinstance(tserved["shared"]["attn"][nm]["kernel"],
                          tst.CompressedKernel)
    assert isinstance(tserved["mamba_groups"][0][1]["mamba"]["in_proj"][
        "kernel"], tst.CompressedKernel)
    toks, ref = ref_logits
    want = jax.jit(lambda p, t: jmodel.apply(
        jst.compress_weights(p, pol_j), {"tokens": t},
        jst.serving_policy(pol_j))[0])(jparams, toks)
    decompress = []
    real = tst.decompress_kernel
    monkeypatch.setattr(tst, "decompress_kernel",
                        lambda *a, **kw: decompress.append(1)
                        or real(*a, **kw))
    got, _ = tmodel.apply(tserved, {"tokens": toks},
                          tst.serving_policy(pol_t))
    assert len(decompress) == 3 * tcfg.n_layers // tcfg.shared_attn_every
    V = tcfg.vocab
    held(got[..., :V], np.asarray(want)[..., :V], ref["fp32"][..., :V],
         "w4a8_abfp")


def test_compressed_weights_under_a_fused_policy_raise_as_the_reference(
        stacks):
    """``serving_policy`` drops the weight quantizer; the decompressed
    shared q then meets the fused backend, which needs both quantizers:
    the reference raises this ValueError, and so does the port."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    pol_j, pol_t = _policy(jp, "p_fp"), _policy(tp, "p_fp")
    toks = _tokens(jcfg, seed=6, shape=(1, 4))
    with pytest.raises(ValueError, match="needs both") as je:
        jax.jit(lambda p, t: jmodel.apply(
            jst.compress_weights(p, pol_j), {"tokens": t},
            jst.serving_policy(pol_j)))(jparams, toks)
    with pytest.raises(ValueError, match="needs both") as te:
        tmodel.apply(tst.compress_weights(tparams, pol_t), {"tokens": toks},
                     tst.serving_policy(pol_t))
    assert str(te.value) == str(je.value)


def test_policy_maps_raise_as_the_reference(stacks):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    for mod, params, st in ((jp, jparams, jst), (tp, tparams, tst)):
        pm = mod.PolicyMap(name="m", rules=(
            mod.PolicyRule("*attn*", mod.preset("fp32")),),
            default=mod.preset("w4a8_abfp"))
        for fn in (st.compress_weights, st.prequantize_weights):
            with pytest.raises(NotImplementedError, match="site addresses"):
                fn(params, pm)
    toks = _tokens(jcfg, shape=(1, 4))
    layer = lambda mod: mod.PolicyMap(name="l", rules=(mod.PolicyRule(
        "blocks.0/*", mod.preset("fp32")),), default=mod.preset("w4a8_abfp"))
    with pytest.raises(NotImplementedError, match="HybridLM") as je:
        jmodel.apply(jparams, {"tokens": toks}, layer(jp))
    with pytest.raises(NotImplementedError, match="HybridLM") as te:
        tmodel.apply(tparams, {"tokens": toks}, layer(tp))
    assert str(te.value) == str(je.value)


def test_engines_and_bucketed_prefill_raise_as_the_reference(stacks):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    with pytest.raises(TypeError, match="HybridState") as je:
        jeng.ServeEngine(jmodel, jparams, n_slots=2, max_len=32)
    with pytest.raises(TypeError, match="HybridState") as te:
        teng.ServeEngine(tmodel, tparams, n_slots=2, max_len=32,
                         device="cpu")
    assert str(te.value) == str(je.value)
    toks = _tokens(jcfg, shape=(1, 4))
    with pytest.raises(TypeError, match="n_valid"):
        jmodel.prefill(jparams, {"tokens": toks}, jp.preset("fp32"),
                       n_valid=np.array([3], np.int32))
    with pytest.raises(TypeError, match="n_valid"):
        tmodel.prefill(tparams, {"tokens": toks}, tp.preset("fp32"),
                       n_valid=torch.tensor([3], dtype=torch.int32))


def test_bridge_carries_the_hybrid_tree(stacks):
    jcfg, jmodel, jparams, tcfg, _, tparams = stacks
    G, k1 = 1, tcfg.shared_attn_every - 1
    assert len(tparams["mamba_groups"]) == G
    assert all(len(g) == k1 for g in tparams["mamba_groups"])
    np.testing.assert_array_equal(
        tparams["mamba_groups"][0][1]["mamba"]["conv_w"].numpy(),
        jparams["mamba_groups"]["mamba"]["conv_w"][0, 1])
    np.testing.assert_array_equal(tparams["lora"][0]["v"]["B"].numpy(),
                                  jparams["lora"]["v"]["B"][0])
    assert tuple(tparams["shared"]["attn"]["o"]["kernel"].shape) == (64, 64)
    bad = {k: v for k, v in jparams.items() if k != "lora"}
    with pytest.raises(KeyError, match="missing"):
        bridge.from_repro_params(bad, tcfg, device="cpu")
    with pytest.raises(ValueError, match="groups"):
        bridge.from_repro_params(jparams, tcfg.replace(n_layers=6),
                                 device="cpu")


def test_full_config_parameter_shapes_are_the_references():
    """zamba2-7b at published size (4.5 billion parameters, 18 GB in f32):
    the port's tree built on the meta device (nothing allocated) holds the
    shapes of the reference's ``jax.eval_shape(model.init)``, group by
    group and block by block."""
    jcfg, tcfg = j_get_config(ARCH), t_get_config(ARCH)
    want = jax.eval_shape(j_build_model(jcfg).init, jax.random.PRNGKey(0))
    want = jax.tree_util.tree_map(lambda a: tuple(a.shape), unbox(want))
    got = shapes(t_build_model(tcfg, device="meta").init(None))
    leaf = lambda s: isinstance(s, tuple)
    groups, lora = got.pop("mamba_groups"), got.pop("lora")
    wgroups, wlora = want.pop("mamba_groups"), want.pop("lora")
    assert got == want
    assert len(groups) == len(lora) == 27
    block = jax.tree_util.tree_map(lambda s: s[2:], wgroups, is_leaf=leaf)
    assert all(len(g) == 2 and all(b == block for b in g) for g in groups)
    assert all(lo == jax.tree_util.tree_map(lambda s: s[1:], wlora,
                                            is_leaf=leaf) for lo in lora)
    assert block["mamba"]["in_proj"]["kernel"] == (3584, 14576)
    assert got["shared"]["attn"]["q"]["kernel"] == (7168, 3584)
    assert jax.tree_util.tree_map(lambda s: s[:2], wgroups, is_leaf=leaf)[
        "ln"]["scale"] == (27, 2)


def test_config_is_the_references():
    tcfg, jcfg = t_get_config(ARCH), j_get_config(ARCH)
    for key in ("family", "n_layers", "d_model", "n_heads", "n_kv",
                "head_dim_", "d_ff", "vocab", "act", "ssm_state",
                "ssm_head_dim", "ssm_chunk", "shared_attn_every",
                "lora_rank", "tied_embeddings"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    assert tcfg.n_params() == jcfg.n_params() == 4_530_031_616


# --------------------------------------------------------------- launcher
def test_launcher_serves_mamba2_and_refuses_what_the_reference_refuses(
        capsys):
    flags = ["--n-requests", "2", "--max-new-tokens", "3", "--max-len", "32",
             "--device", "cpu"]
    assert tserve.main(["--arch", "mamba2-130m", *flags]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["arch"] == "mamba2-130m-reduced" and got["requests"] == 2
    assert got["attention"]["engine"] == "fixed"
    with pytest.raises(TypeError, match="HybridState"):
        tserve.main(["--arch", "zamba2-7b", *flags])
    with pytest.raises(TypeError, match="attention-family only"):
        tserve.main(["--arch", "mamba2-130m", "--paged", *flags])
