"""The MoE family in the port vs the reference: the block alone (top-k
routing with GShard's sequential capacity fill, the Switch aux loss, the
one-hot dispatch and combine, per-expert policy sub-sites), and
phi3.5-moe-42b-a6.6b / llama4-scout-17b-a16e ``.reduced()`` (2 layers,
d_model 64, 4 experts of d_ff 128, top-2 / top-1, routing groups of 64
tokens, vocab 503 padded to 512) on weights carried across by the bridge:
logits and the aux loss under fp32, w4a8_abfp and P-fp, ``loss``,
``expert_loads``, ``compress_weights`` into ``ExpertBank``s, both engines'
greedy tokens, the launcher and the full configs' shapes.

The expert contractions are plain f32 ``torch.einsum`` on QDQ'd weights
(the reference computes them outside any Pallas kernel too).  Tolerance:
dispatch and loads exact; combine, outputs and fp32 logits rtol / atol
1e-5 (1e-4 for logits: f32 sums in another order); quantized logits within
the ``held`` share of how far QDQ moves them.  Where a token's expert
choice differs between the stacks inside a model, its router
probabilities must be tied (``routing_turns``).  The reference runs
jitted, except where its intermediates are read (eagerly, through a
recording ``jnp``).
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
from repro.nn import moe as j_moe
from repro.nn.module import unbox
from repro_torch.analysis.messages import expert_cache_requires_compress_message
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tp
from repro_torch.launch import serve as tserve
from repro_torch.models import build_model as t_build_model
from repro_torch.models import serving_transforms as tst
from repro_torch.nn import moe as t_moe

from test_torch_encdec import _Calls
from torch_arch_helpers import (TOL, both_stacks, policy, serve_fixed,
                                serve_paged, tokens_equal_or_tied)
from torch_ssm_helpers import held, shapes

ARCHS = ("phi3.5-moe-42b-a6.6b", "llama4-scout-17b-a16e")
TIGHT = dict(rtol=1e-5, atol=1e-5)
# a router probability tie: two experts' probabilities this close (f32
# softmax outputs near 1 / E) can order either way once the router input
# differs in its last bit
TIE = 1e-6


class _RecordingJnp:
    """``jnp`` for the reference's ``nn/moe.py``, keeping the operands and
    result of every einsum by its spec (under ``jax.jit`` the traced
    values, which the jitted function returns)."""

    def __init__(self):
        self.seen = {}

    def __getattr__(self, name):
        return getattr(jnp, name)

    def einsum(self, spec, *ops, **kw):
        out = jnp.einsum(spec, *ops, **kw)
        self.seen.setdefault(spec, []).append((ops, out))
        return out


def _record_reference(monkeypatch):
    rec = _RecordingJnp()
    monkeypatch.setattr(j_moe, "jnp", rec)
    return rec


def _record_port(monkeypatch):
    """The port's ``MoE.route`` outputs, call by call."""
    seen = []
    route = t_moe.MoE.route

    def call(self, router, xg):
        out = route(self, router, xg)
        seen.append(out)
        return out

    monkeypatch.setattr(t_moe.MoE, "route", call)
    return seen


D, F, E = 32, 64, 4
BLOCKS = {  # case -> (top_k, capacity_factor, policy)
    "fp32": (2, 1.25, "fp32"),
    "overflow": (2, 0.5, "fp32"),
    "top1": (1, 1.25, "fp32"),
    "w4a8_abfp": (2, 1.25, "w4a8_abfp"),
    "expert_rules": (2, 0.5, "experts"),
}


def _block_policy(mod, name):
    if name != "experts":
        return mod.preset(name, n=16)
    # expert 1 at 4-bit weights and activations, expert 2 fp32, the rest
    # (and the block's activations) at w4a8: the per-expert sub-sites
    return mod.PolicyMap(name="experts", rules=(
        ("*/experts.1", mod.preset("w4a4_abfp", n=16)),
        ("*/experts.2", mod.preset("fp32")),
    ), default=mod.preset("w4a8_abfp", n=16))


@pytest.mark.parametrize("case", BLOCKS)
def test_block_matches_reference(case, monkeypatch):
    """The same x and weights through both blocks: dispatch exactly equal,
    combine, aux loss and output to f32 tolerance, ``expert_load`` exact;
    the overflow cases drop tokens (capacity 4 for 32 assignments)."""
    k, cf, pname = BLOCKS[case]
    kw = dict(n_experts=E, top_k=k, capacity_factor=cf, group_tokens=16,
              name="blocks.0/ffn")
    jblock, tblock = j_moe.MoE(D, F, **kw), t_moe.MoE(D, F, **kw)
    params = jax.device_get(unbox(jblock.init(jax.random.PRNGKey(7))))
    x = np.random.RandomState(3).randn(2, 16, D).astype(np.float32)
    rec = _record_reference(monkeypatch)
    seen = _record_port(monkeypatch)

    def ref(p, x):
        y, m = jblock.apply(p, x, _block_policy(jp, pname))
        return (y, m, rec.seen["gtec,gtd->gecd"][0][0][0],
                rec.seen["gtec,gecd->gtd"][0][0][0])

    want, wm, w_dispatch, w_combine = jax.jit(ref)(params, x)
    tparams = {n: torch.from_numpy(np.array(v)) for n, v in params.items()}
    got, gm = tblock.apply(tparams, torch.from_numpy(x),
                           _block_policy(tp, pname))
    (_, dispatch, combine, fill), = seen
    np.testing.assert_array_equal(dispatch.numpy(), np.asarray(w_dispatch))
    np.testing.assert_allclose(combine.numpy(), np.asarray(w_combine),
                               **TIGHT)
    np.testing.assert_array_equal(gm["expert_load"].numpy(),
                                  np.asarray(wm["expert_load"]))
    np.testing.assert_allclose(float(gm["moe_aux_loss"]),
                               float(wm["moe_aux_loss"]), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)
    C = tblock.capacity(16)
    assert dispatch.shape == (2, 16, E, C)
    routed = int(fill.sum())
    assert routed <= 2 * 16 * k
    if cf < 1:
        assert C == 4 and routed < 2 * 16 * k  # tokens dropped
    if pname == "experts":
        # expert 2 fp32, expert 1 at 4 bits: each expert's own rule
        assert tp.has_expert_rules(_block_policy(tp, pname))


@pytest.fixture(scope="module", params=ARCHS)
def stacks(request):
    return both_stacks(request.param)


def _tokens(cfg, seed, shape=(2, 32)):
    # 2 x 32 tokens: one routing group of 64, as the reduced configs group
    return np.random.RandomState(seed).randint(0, cfg.vocab, shape).astype(
        np.int32)


@pytest.fixture(scope="module")
def ref_runs(stacks):
    """The reference's logits and aux loss under fp32, w4a8_abfp and P-fp,
    and its expert loads, from one jitted function."""
    jcfg, jmodel, jparams, *_ = stacks
    toks = _tokens(jcfg, 1)
    names = ("fp32", "w4a8_abfp", "p_fp")
    pols = [policy(jp, n)[0] for n in names]
    fn = jax.jit(lambda p: ([jmodel.apply(p, {"tokens": toks}, pol)
                             for pol in pols],
                            jmodel.expert_loads(p, toks)))
    outs, loads = fn(jparams)
    return toks, dict(zip(names, outs)), loads


@pytest.mark.parametrize("name", ("fp32", "w4a8_abfp", "p_fp"))
def test_logits_and_aux_match_reference(stacks, ref_runs, name,
                                        monkeypatch):
    """Logits at every position and the summed aux loss; under P-fp the
    dense matmuls (q, k, v, o and the head) go through ``abfp_matmul`` and
    the attention through ``flash_attention``, the experts through
    einsum."""
    *_, tcfg, tmodel, tparams = stacks
    toks, want, _ = ref_runs
    calls = _Calls(monkeypatch)
    got, aux = tmodel.apply(tparams, {"tokens": toks}, policy(tp, name)[0])
    wl, wa = want[name]
    V = tcfg.vocab
    if name == "fp32":
        np.testing.assert_allclose(got.numpy(), np.asarray(wl), **TOL)
    else:
        held(got[..., :V], wl[..., :V], want["fp32"][0][..., :V], name)
    np.testing.assert_allclose(float(aux), float(wa), rtol=1e-5)
    assert float(aux) > 0
    L = tcfg.n_layers
    assert calls.take() == ({} if name != "p_fp" else
                            {"abfp_matmul": 4 * L + 1, "flash_attention": L})


def test_expert_loads_match_reference(stacks, ref_runs):
    """``Model.expert_loads``: (n_layers, n_experts) routed tokens after
    capacity, exactly the reference's; an SSM or dense config raises."""
    *_, tcfg, tmodel, tparams = stacks
    toks, _, want = ref_runs
    got = tmodel.expert_loads(tparams, toks)
    assert got.shape == (tcfg.n_layers, tcfg.n_experts)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(got.sum()) <= tcfg.n_layers * toks.size * tcfg.top_k
    dense = t_build_model(t_get_config("qwen2-7b").reduced(), device="cpu")
    with pytest.raises(TypeError, match="not an MoE config"):
        dense.expert_loads({}, toks)


def routing_turns(want, got, probs):
    """Tokens whose experts differ between the reference's dispatch
    ``want`` and the port's ``got`` (G, T, E, C) in one block, each with
    the port's router probabilities ``probs`` (G, T, E): every such token
    must hold two experts within TIE of each other."""
    a, b = (np.asarray(d).sum(-1) > 0 for d in (want, got))
    turned = np.argwhere((a != b).any(-1))
    p = np.sort(np.asarray(probs), axis=-1)
    for g, t in turned:
        assert np.diff(p[g, t]).min() <= TIE, (g, t, p[g, t])
    return len(turned)


def test_routing_inside_the_model_turns_only_at_ties(stacks, monkeypatch):
    """Both stacks under w4a8_abfp (the router's input carries the QDQ'd
    attention half of its block): each block's dispatch, read from both,
    is the same, up to tokens whose router probabilities tie."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    toks = _tokens(jcfg, 5)
    rec = _record_reference(monkeypatch)
    seen = _record_port(monkeypatch)
    pol = policy(jp, "w4a8_abfp")[0]
    # unrolled layers: one traced dispatch a block, returned by the jit
    jun = j_build_model(jcfg.replace(scan_layers=False))
    blocks = [jax.tree_util.tree_map(lambda a, i=i: a[i], jparams["blocks"])
              for i in range(jcfg.n_layers)]
    ref = jax.jit(lambda p: (jun.apply(p, {"tokens": toks}, pol)[0], [
        ops[0] for ops, _ in rec.seen["gtec,gtd->gecd"]]))(
        dict(jparams, blocks=blocks))[1]
    tmodel.apply(tparams, {"tokens": toks}, policy(tp, "w4a8_abfp")[0])
    assert len(ref) == len(seen) == tcfg.n_layers
    turned = sum(routing_turns(w, d, p) for w, (p, d, _, _) in zip(ref, seen))
    assert turned == 0  # none at this seed; any would have to be ties


def test_loss_adds_the_aux_term(stacks):
    """``Model.loss`` = CE + 0.01 aux, as the reference's, under fp32."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    toks = _tokens(jcfg, 2)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    batch = {"tokens": toks, "labels": labels}
    want, wm = jax.jit(lambda p: jmodel.loss(p, batch, jp.preset("fp32")))(
        jparams)
    got, gm = tmodel.loss(tparams, batch, tp.preset("fp32"))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(float(gm["aux"]), float(wm["aux"]), rtol=1e-5)
    np.testing.assert_allclose(float(got),
                               float(gm["ce"]) + 0.01 * float(gm["aux"]),
                               rtol=1e-6)


def _expert_map(mod):
    """Expert 0 at int8 weights, expert 3 fp32 (dense), the rest int4."""
    return mod.PolicyMap(name="banks", rules=(
        ("*/experts.0", mod.preset("w8a8_abfp", n=16)),
        ("*/experts.3", mod.preset("fp32")),
    ), default=mod.preset("w4a8_abfp", n=16))


def test_compress_weights_builds_the_references_expert_banks(stacks):
    """``compress_weights`` on an MoE tree under a per-expert map: each
    expert stack becomes an ``ExpertBank`` whose entries (int8 codes,
    packed int4 codes, a dense fp32 slice) equal the reference's, the
    router stays dense, the byte report counts the same totals; the served
    tree's logits equal the reference's."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    jserved = jax.device_get(jst.compress_weights(jparams, _expert_map(jp)))
    tserved = tst.compress_weights(tparams, _expert_map(tp))
    for i, blk in enumerate(tserved["blocks"]):
        ffn, jffn = blk["ffn"], jserved["blocks"]["ffn"]
        assert torch.equal(ffn["router"], tparams["blocks"][i]["ffn"][
            "router"])
        for kind in ("wi", "wg", "wo"):
            bank, jbank = ffn[kind], jffn[kind]
            assert isinstance(bank, tst.ExpertBank)
            assert bank.n_experts == jbank.n_experts == tcfg.n_experts
            for e, (te, je) in enumerate(zip(bank.entries, jbank.entries)):
                if isinstance(je, jst.CompressedKernel):
                    assert isinstance(te, tst.CompressedKernel)
                    assert (te.fmt_name, te.packed, te.pad, te.k) == (
                        je.fmt_name, je.packed, je.pad, je.k)
                    np.testing.assert_array_equal(
                        te.codes.numpy(), np.asarray(je.codes)[i])
                    np.testing.assert_array_equal(
                        te.scale.numpy(), np.asarray(je.scale)[i])
                else:
                    assert e == 3 and isinstance(te, torch.Tensor)
                    np.testing.assert_array_equal(te.numpy(),
                                                  np.asarray(je)[i])
            assert [getattr(x, "fmt_name", "dense") for x in bank.entries] \
                == ["int8", "int4", "int4", "dense"]
    trep = tst.weight_bytes_report(tparams, tserved)
    jrep = jst.weight_bytes_report(jparams, jserved)
    for key in ("dense_kernel_bytes", "resident_kernel_bytes"):
        assert trep[key] == jrep[key], key
    rows = {r["site"]: r for r in trep["sites"]}
    assert rows["blocks.1/ffn/experts.3"]["kind"] == "dense"
    assert rows["blocks.1/ffn/experts.0"]["fmt"] == "int8"
    # the dense bank entry and the decompressed ones feed the same einsum
    toks = _tokens(jcfg, 3)
    spol = jst.serving_policy(_expert_map(jp))
    want, no_qdq = jax.jit(lambda p, q: (
        jmodel.apply(p, {"tokens": toks}, spol)[0],
        jmodel.apply(q, {"tokens": toks}, jp.preset("fp32"))[0]))(
        jserved, jparams)
    got = tmodel.apply(tserved, {"tokens": toks},
                       tst.serving_policy(_expert_map(tp)))[0]
    V = tcfg.vocab
    held(got[..., :V], want[..., :V], no_qdq[..., :V], "served")
    bank = tserved["blocks"][0]["ffn"]["wi"]
    np.testing.assert_array_equal(
        bank.dense(torch.float32)[3].numpy(),
        tparams["blocks"][0]["ffn"]["wi"][3].numpy())


def test_fixed_engine_tokens_equal_reference(stacks):
    """P-fp: the dense matmuls through ``abfp_matmul``, the expert stacks
    QDQ'd every forward; bucketed prefills of 16 and 128 tokens (whole
    routing groups)."""
    (_, want), (_, got) = serve_fixed(stacks, "p_fp")
    assert got == want and all(len(t) == 5 for t in got.values())


def test_paged_engine_tokens_equal_reference(stacks):
    """P-C: ``ExpertBank`` int4 codes decompressed each step, the dense
    sites through ``quant_matmul``, int8 pages through the ``compressed``
    backend; a token may turn only at a tie."""
    jcfg = stacks[0]
    (je, want, jrows), (te, got, trows) = serve_paged(stacks, "p_c")
    turns = tokens_equal_or_tied(want, got, jrows, trows, jcfg.vocab)
    assert len(turns) <= 1, turns
    for key in ("dense_kernel_bytes", "resident_kernel_bytes", "ratio"):
        assert te.weight_bytes[key] == je.weight_bytes[key], key


def test_launcher_serves_an_moe_arch(capsys):
    """``--arch phi3.5-moe-42b-a6.6b`` reaches the paged engine on the CPU
    (reduced), compressed, with an expert store (capacity 0) whose stats
    the report carries; ``--expert-cache`` without ``--compress`` exits
    with the reference's message."""
    assert tserve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--paged",
                        "--compress", "--policy", "w4a8_abfp", "--kv",
                        "int8", "--n-requests", "2", "--max-new-tokens", "3",
                        "--max-len", "64", "--n-slots", "2",
                        "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["arch"] == "phi3.5-moe-42b-a6.6b-reduced"
    assert got["requests"] == 2 and got["compressed_sites"] > 0
    assert got["experts"]["capacity"] == 0 and got["experts"]["misses"] > 0
    with pytest.raises(SystemExit) as e:
        tserve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--paged",
                     "--expert-cache", "2", "--device", "cpu"])
    assert str(e.value) == expert_cache_requires_compress_message()


FULL = {"phi3.5-moe-42b-a6.6b": (41_873_833_984, 32_256, 32),
        "llama4-scout-17b-a16e": (101_731_532_800, 202_240, 48)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_parameter_shapes_are_the_references(arch):
    """At published size (on the meta device): fields, parameter counts
    and the reference's ``jax.eval_shape(model.init)`` shapes."""
    jcfg, tcfg = j_get_config(arch), t_get_config(arch)
    for key in ("family", "n_layers", "d_model", "n_heads", "n_kv",
                "head_dim_", "d_ff", "vocab", "vocab_padded", "act", "norm",
                "n_experts", "top_k", "capacity_factor", "moe_group_tokens",
                "rope_theta", "tied_embeddings", "logits_chunk"):
        assert getattr(tcfg, key) == getattr(jcfg, key), key
    n, vocab, layers = FULL[arch]
    assert tcfg.n_params() == jcfg.n_params() == n
    assert tcfg.n_active_params() == jcfg.n_active_params()
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
    assert block["ffn"]["wi"] == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
