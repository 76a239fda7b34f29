"""What the dense-arch and MoE parity tests of the port share: both stacks
of a reduced config on the bridge's weights, the policies by name, and
both engines of both stacks serving one trace with every emitted token's
logits row kept, so that a token that turns is shown to turn at a tie."""

import jax
import numpy as np

from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.models import build_model as j_build_model
from repro.nn.module import unbox
from repro.serve import engine as jeng
from repro.serve import steps as jsteps
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tp
from repro_torch.models import build_model as t_build_model
from repro_torch.serve import engine as teng

N_GROUP = 16  # divides every width of the reduced configs
TOL = dict(rtol=1e-4, atol=1e-4)  # f32 logits summed in another order
LENGTHS = (5, 11, 3, 70, 8, 2)
# Paged serving over int8 pages: a K or V projection summed in another
# order can land a few ulps from a code's rounding boundary, and the code
# then differs (the int8 ring's account in ``test_torch_encdec.py``).  A
# token may turn only where the reference's top-2 margin lies within twice
# the logit gap of the two stacks at that token, and the gap before it
# stays within this share of the row's std (measured 2.9 % on reduced
# granite-3-8b; with fp pages the same run agrees to the last bit).
TIE_GAP_SHARE = 0.05


def both_stacks(arch: str):
    """(reference config, model, params; port config, model, params) of
    ``arch``'s reduced config, the port's tree carried across."""
    jcfg = j_get_config(arch).reduced()
    jmodel = j_build_model(jcfg)
    jparams = jax.device_get(unbox(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0))))
    tcfg = t_get_config(arch).reduced()
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jparams, tcfg, device="cpu")
    return jcfg, jmodel, jparams, tcfg, tmodel, tparams


def policy(mod, name: str):
    """(policy, engine kwargs) of either stack by name.  p_fp / p_int8: the
    fused matmul paths with the ``fused`` attention backend (P-fp without
    attention-BMM QDQ); p_c: w4a8_abfp, ``fused``, compressed weights and
    the ``compressed`` backend over int8 KV (pages or ring)."""
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
    assert name == "p_c", name
    pol = mod.with_kv_cache(mod.preset("w4a8_abfp", n=N_GROUP), "int8")
    return (mod.with_attn_backend(fused(pol), "compressed"),
            {"compress": True, "kv": "int8"})


def trace(mod, vocab: int, max_new: int = 5, seed: int = 3):
    rng = np.random.RandomState(seed)
    return [mod.Request(uid=i,
                        prompt=rng.randint(0, vocab, size=n).astype(np.int32),
                        max_new_tokens=max_new)
            for i, n in enumerate(LENGTHS)]


def _emitting(eng, tokens, n_valid):
    """The (slot, uid) pairs whose sample a paged step keeps: decoding
    rows, and prefilling rows on the chunk that ends their prompt."""
    if tokens.shape[1] == 1:
        return [(s, eng.req[s].uid) for s in range(eng.n_slots)
                if eng.active[s]]
    return [(s, eng.req[s].uid) for s in range(eng.n_slots)
            if eng.prefilling[s]
            and eng._pf_pos[s] + int(n_valid[s]) >= len(eng.req[s].prompt)]


def _record_reference(eng, rows: dict):
    """The reference's paged step, jitted as its engine jits it, with the
    logits kept for every emitted token."""
    def fn(params, tokens, state, n_valid, keys, temps, topk):
        logits, state = eng.model.paged_step(
            params, tokens, state, n_valid=n_valid, policy=eng.policy)
        toks, new_keys = jsteps.sample_step(logits, keys, temps, topk)
        return toks[:, 0], state, new_keys, logits

    jfn = jax.jit(fn)

    def step(params, tokens, state, n_valid, keys, temps, topk):
        emit = _emitting(eng, np.asarray(tokens), np.asarray(n_valid))
        tok, state, keys, logits = jfn(params, tokens, state, n_valid, keys,
                                       temps, topk)
        logits = np.asarray(logits)
        for s, uid in emit:
            rows.setdefault(uid, []).append(logits[s])
        return tok, state, keys

    eng._step = step


def _record_port(eng, rows: dict):
    inner, sample = eng._step, eng._sample
    emit = []

    def step(tokens, n_valid, mask):
        emit[:] = _emitting(eng, tokens, n_valid)
        return inner(tokens, n_valid, mask)

    def keep(logits):
        for s, uid in emit:
            rows.setdefault(uid, []).append(logits[s].numpy().copy())
        return sample(logits)

    eng._step, eng._sample = step, keep


def serve_paged(stacks, name: str, n_slots=3, max_len=128):
    """Both stacks' ``PagedServeEngine`` on ``trace``: (engine, tokens,
    logits rows) of each, reference first."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    out = []
    for mod, pmod, model, params, extra, record in (
            (jeng, jp, jmodel, jparams, {}, _record_reference),
            (teng, tp, tmodel, tparams, {"device": "cpu"}, _record_port)):
        pol, kw = policy(pmod, name)
        eng = mod.PagedServeEngine(model, params, n_slots=n_slots,
                                   max_len=max_len, policy=pol, page_size=8,
                                   **kw, **extra)
        rows = {}
        record(eng, rows)
        for r in trace(mod, jcfg.vocab):
            eng.submit(r)
        toks = {c.uid: c.tokens for c in eng.run_until_done()}
        out.append((eng, toks, rows))
    return out


def serve_fixed(stacks, name: str, n_slots=3, max_len=128):
    """Both stacks' fixed-slot ``ServeEngine`` on ``trace``: (engine,
    tokens) of each, reference first."""
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = stacks
    out = []
    for mod, pmod, model, params, extra in (
            (jeng, jp, jmodel, jparams, {}),
            (teng, tp, tmodel, tparams, {"device": "cpu"})):
        pol, kw = policy(pmod, name)
        kw.pop("kv", None)  # the ring's storage follows the policy
        eng = mod.ServeEngine(model, params, n_slots=n_slots,
                              max_len=max_len, policy=pol, **kw, **extra)
        for r in trace(mod, jcfg.vocab):
            eng.submit(r)
        out.append((eng, {c.uid: c.tokens for c in eng.run_until_done()}))
    return out


def tokens_equal_or_tied(want: dict, got: dict, want_rows: dict,
                         got_rows: dict, vocab: int) -> list:
    """Every request's tokens equal the reference's, up to a turn at a
    tie: at the first token that differs the reference's top-2 margin lies
    within twice the two stacks' logit gap there, the port's token is the
    reference's runner-up, and every row before it is within
    TIE_GAP_SHARE of its std.  Returns the turns found."""
    assert sorted(got) == sorted(want)
    turns = []
    for uid, w in want.items():
        g = got[uid]
        assert len(g) == len(w), uid
        k = next((i for i, (a, b) in enumerate(zip(w, g)) if a != b), None)
        upto = len(w) if k is None else k + 1
        for i in range(upto):
            rw, rg = want_rows[uid][i][:vocab], got_rows[uid][i][:vocab]
            gap = float(np.abs(rw - rg).max())
            if i < upto - 1 or k is None:
                assert gap <= TIE_GAP_SHARE * float(rw.std()), (uid, i, gap)
        if k is None:
            continue
        rw = want_rows[uid][k][:vocab]
        gap = float(np.abs(rw - got_rows[uid][k][:vocab]).max())
        top2 = np.sort(rw)[-2:]
        margin = float(top2[1] - top2[0])
        assert g[k] == int(np.argsort(rw)[-2]), (uid, k)
        assert margin <= 2 * gap, (uid, k, margin, gap)
        turns.append({"uid": uid, "at": k, "margin": margin, "gap": gap})
    return turns
