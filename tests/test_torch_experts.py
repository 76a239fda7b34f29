"""Expert-resident MoE serving in the port against the reference: the LRU
(eviction order, capacity 0, order under skew, hit rate monotone in
capacity), ``zipf_trace`` bit-equal to the reference's, the store's bytes
equal to ``weight_bytes_report``'s expert rows and to the reference
store's, a cached copy bit-equal to its backing entry, the offline
precision assignment (hot experts, the map's round trip, the weight-rule
error), and on the reference's tiny MoE config both engines' tokens with
the store and after ``refresh_experts`` equal to dense-resident serving
and to the reference's, with the reference's guard messages."""

import jax
import numpy as np
import pytest
import torch

from repro.analysis import messages as jmsg
from repro.configs.base import ArchConfig as JArchConfig
from repro.core import policy as jp
from repro.models import serving_transforms as jst
from repro.models.registry import build_model as j_build_model
from repro.nn.module import unbox
from repro.serve import engine as jeng
from repro.serve import experts as jex
from repro_torch import bridge
from repro_torch.analysis import messages as tmsg
from repro_torch.configs.base import ArchConfig as TArchConfig
from repro_torch.core import policy as tp
from repro_torch.models import serving_transforms as tst
from repro_torch.models.registry import build_model as t_build_model
from repro_torch.serve import engine as teng
from repro_torch.serve import experts as tex

E = 4
TINY_MOE = dict(
    name="tiny-moe", family="moe", n_layers=2, d_model=32, n_heads=2,
    n_kv=2, head_dim=16, d_ff=32, vocab=97, n_experts=E, top_k=2,
    capacity_factor=2.0, moe_group_tokens=8, scan_layers=False,
    tied_embeddings=False)
TINY_DENSE = dict(name="tiny-dense", family="llama", n_layers=1, d_model=32,
                  n_heads=2, n_kv=2, head_dim=16, d_ff=32, vocab=97,
                  scan_layers=False, tied_embeddings=False)
# at most one routing group each: one probe shape an engine
PROMPTS = [np.array([3, 5, 7, 11, 13], np.int32),
           np.array([2, 4, 6], np.int32),
           np.array([1, 2, 3, 4, 5, 6, 7, 8], np.int32)]


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


def _stacks(fields: dict, key: int):
    jcfg = JArchConfig(**fields)
    jmodel = j_build_model(jcfg)
    jparams = jax.device_get(unbox(jmodel.init(jax.random.PRNGKey(key))))
    tcfg = TArchConfig(**fields)
    tmodel = t_build_model(tcfg, device="cpu")
    return (jcfg, jmodel, jparams, tcfg, tmodel,
            bridge.from_repro_params(jparams, tcfg, device="cpu"))


@pytest.fixture(scope="module")
def moe():
    return _stacks(TINY_MOE, 0)


@pytest.fixture(scope="module")
def dense():
    return _stacks(TINY_DENSE, 1)


def _policy(mod, name: str):
    return mod.QuantPolicy() if name == "fp32" else mod.preset(name)


# ------------------------------------------------------------------- LRU
def test_lru_eviction_order():
    cache = tex.ExpertCache(2)
    for e in (0, 1, 2, 3):  # 0 and 1 evicted in insertion order
        assert not cache.access(e)
        cache.admit(e, f"v{e}")
    assert cache.keys() == [2, 3] and cache.evictions == 2
    assert cache.access(2)  # a hit refreshes recency: 2 is now MRU
    assert cache.keys() == [3, 2]
    assert cache.admit(1, "v1") == 3 and cache.keys() == [2, 1]
    assert cache.hits == 1 and cache.misses == 4
    with pytest.raises(ValueError, match="must be >= 0"):
        tex.ExpertCache(-1)


def test_lru_capacity_zero_disables():
    cache = tex.ExpertCache(0)
    assert not cache.access(0)
    assert cache.admit(0, "v") is None
    assert len(cache) == 0 and cache.misses == 1 and cache.hit_rate == 0.0


def _trace_hit_rate(alpha, capacity, n=16, steps=300):
    cache = tex.ExpertCache(capacity)
    for row in tex.zipf_trace(n, steps, alpha=alpha, top_k=2, seed=3):
        for e in np.nonzero(row)[0]:
            if not cache.access(int(e)):
                cache.admit(int(e), None)
    return cache.hit_rate


def test_lru_order_under_skew():
    cache = tex.ExpertCache(4)
    for row in tex.zipf_trace(16, 400, alpha=2.0, top_k=2, seed=5):
        for e in np.nonzero(row)[0]:
            if not cache.access(int(e)):
                cache.admit(int(e), None)
    assert 0 in cache and 1 in cache  # the two hottest Zipf ranks


def test_hit_rate_monotone_in_capacity():
    rates = [_trace_hit_rate(1.5, c) for c in (1, 2, 4, 8, 16)]
    assert all(a <= b + 1e-12 for a, b in zip(rates, rates[1:]))
    assert rates[-1] > rates[0]
    assert _trace_hit_rate(1.5, 4) > _trace_hit_rate(0.0, 4)


@pytest.mark.parametrize("alpha,top_k,seed", [(0.0, 2, 0), (1.5, 2, 3),
                                              (2.0, 3, 7)])
def test_zipf_trace_is_the_references(alpha, top_k, seed):
    got = tex.zipf_trace(16, 64, alpha=alpha, top_k=top_k, seed=seed)
    want = jex.zipf_trace(16, 64, alpha=alpha, top_k=top_k, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert (got.sum(axis=1) == top_k).all()


# ----------------------------------------------------------------- store
def test_store_bytes_match_weight_bytes_report(moe):
    jcfg, _, jparams, tcfg, _, tparams = moe
    served = tst.compress_weights(tparams, tp.preset("w4a8_abfp"))
    rep = tst.weight_bytes_report(tparams, served)
    store = tex.ExpertStore(served, capacity=0, model_name=tcfg.name)
    rows = [r for r in rep["sites"] if "/experts." in r["site"]]
    assert len(rows) == tcfg.n_layers * E
    stats = store.stats()
    assert stats["store_bytes"] == sum(r["resident_bytes"] for r in rows)
    assert stats["dense_bytes"] == sum(r["dense_bytes"] for r in rows)
    # and the reference store's bytes on the same weights
    jstore = jex.ExpertStore(jst.compress_weights(jparams,
                                                  jp.preset("w4a8_abfp")),
                             capacity=0, model_name=jcfg.name)
    jstats = jstore.stats()
    for key in ("store_bytes", "dense_bytes", "n_sites", "n_experts"):
        assert stats[key] == jstats[key], key
    assert store.sites == jstore.sites


def test_store_cache_bytes_and_counters(moe):
    tcfg, tparams = moe[3], moe[5]
    served = tst.compress_weights(tparams, tp.preset("w4a8_abfp"))
    store = tex.ExpertStore(served, capacity=1, model_name=tcfg.name)
    loads = np.zeros((tcfg.n_layers, E))
    loads[:, 1] = 10.0
    loads[:, 3] = 4.0
    store.observe(loads)
    stats = store.stats()
    for site in store.sites:  # the heaviest expert ends most recent
        assert store.caches[site].keys() == [1]
        assert stats["sites"][site]["counts"][1] == 10.0
    per_expert_dense = stats["dense_bytes"] // (tcfg.n_layers * E)
    assert stats["cache_bytes"] == tcfg.n_layers * per_expert_dense
    assert stats["resident_bytes"] == (stats["store_bytes"]
                                       + stats["cache_bytes"])
    assert stats["hot_bytes"] + stats["cold_bytes"] == \
        stats["resident_bytes"]
    with pytest.raises(ValueError, match="load rows"):
        store.observe(np.ones((3, E)))


def test_store_cached_copy_matches_backing_entry(moe):
    tcfg, tparams = moe[3], moe[5]
    served = tst.compress_weights(tparams, tp.preset("w4a8_abfp"))
    store = tex.ExpertStore(served, capacity=2, model_name=tcfg.name)
    store.warm([2])
    for site in store.sites:
        for kind, bank in store.banks[site].items():
            cached = store.caches[site].get(2)[kind]
            assert torch.equal(cached, tst.decompress_kernel(
                bank.entries[2]))
    # materialize swaps the copy in: the bank's dense view is unchanged
    swapped = store.materialize(served)
    site = store.sites[0]
    blk = int(site.split("/")[0].split(".")[1])
    for kind in store.banks[site]:
        new = swapped["blocks"][blk]["ffn"][kind]
        assert new.entries[2] is store.caches[site].get(2)[kind]
        assert torch.equal(new.dense(torch.float32),
                           served["blocks"][blk]["ffn"][kind].dense(
                               torch.float32))


def test_store_rejects_dense_model(dense):
    tcfg, tparams = dense[3], dense[5]
    served = tst.compress_weights(tparams, tp.preset("w4a8_abfp"))
    with pytest.raises(ValueError) as e:
        tex.ExpertStore(served, capacity=1, model_name=tcfg.name)
    assert str(e.value) == tmsg.expert_non_moe_message("an expert store",
                                                       tcfg.name)


# ------------------------------------------------ precision assignment
def test_hot_experts_ordering():
    loads = np.array([[1.0, 5.0, 3.0, 5.0]])
    assert tex.hot_experts(loads, 2) == [1, 3]  # ties break low-index
    assert tex.hot_experts(loads, 0) == []
    assert tex.hot_experts(loads, 99) == [1, 3, 2, 0]
    rng = np.random.RandomState(2)
    for _ in range(20):
        lo = rng.randint(0, 4, size=(2, 8)).astype(np.float64)
        n = int(rng.randint(0, 9))
        assert tex.hot_experts(lo, n) == jex.hot_experts(lo, n)


def test_assignment_map_round_trips():
    loads = np.array([7.0, 1.0, 2.0, 9.0])
    pm = tex.assign_expert_precision(loads, tp.preset("w4a8_abfp"), n_hot=2)
    hot = {r.pattern for r in pm.rules
           if r.policy.weight.fmt_name == "int8"}
    assert hot == {"*/experts.0", "*/experts.3"}
    assert pm.resolve("block/ffn/experts.3").weight.fmt_name == "int8"
    assert pm.resolve("block/ffn/experts.1").weight.fmt_name == "int4"
    assert tp.policy_from_dict(tp.policy_to_dict(pm)) == pm
    want = jex.assign_expert_precision(loads, jp.preset("w4a8_abfp"),
                                       n_hot=2)
    assert tp.policy_to_dict(pm) == jp.policy_to_dict(want)


def test_assignment_requires_weight_rule():
    with pytest.raises(ValueError, match="enabled weight rule"):
        tex.expert_precision_map(tp.preset("fp32"), [0])


def test_route_frequencies_match_the_references(moe):
    jcfg, jmodel, jparams, tcfg, tmodel, tparams = moe
    rng = np.random.RandomState(4)
    probe = [rng.randint(0, tcfg.vocab, (1, 8)).astype(np.int32)
             for _ in range(2)]
    got = tex.route_frequencies(tmodel, tparams, probe,
                                policy=tp.preset("w4a8_abfp"))
    # the reference's route_frequencies, its probe jitted
    loads = jax.jit(lambda p, t: jmodel.expert_loads(
        p, t, policy=jp.preset("w4a8_abfp")))
    want = sum(np.asarray(loads(jparams, t)) for t in probe)
    assert got.shape == (tcfg.n_layers, E)
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="no token batches"):
        tex.route_frequencies(tmodel, tparams, [])


# ------------------------------------------------------------ the engines
def _drive(eng, refresh_at=()):
    for i, p in enumerate(PROMPTS):
        eng.submit(eng_request(eng, i, p))
    ticks = 0
    while eng._has_work():
        eng.tick()
        ticks += 1
        if ticks in refresh_at:  # mid-flight, twice (an idempotent swap)
            eng.refresh_experts()
    return {c.uid: c.tokens for c in eng.done}


def eng_request(eng, uid, prompt):
    mod = teng if isinstance(eng, teng._EngineBase) else jeng
    return mod.Request(uid=uid, prompt=prompt, max_new_tokens=8)


ENGINES = {"fixed": "ServeEngine", "paged": "PagedServeEngine"}


@pytest.fixture(scope="module")
def ref_store_tokens(moe):
    """The reference's expert-store engines' tokens under w4a8_abfp
    (capacity E // 4)."""
    jmodel, jparams = moe[1], moe[2]
    return {kind: _drive(getattr(jeng, cls)(
        jmodel, jparams, n_slots=2, max_len=64, policy=jp.preset("w4a8_abfp"),
        compress=True, expert_cache=max(1, E // 4)))
        for kind, cls in ENGINES.items()}


@pytest.mark.parametrize("kind", ["fixed", "paged"])
@pytest.mark.parametrize("name", ["fp32", "w4a8_abfp"])
def test_store_tokens_equal_dense_and_reference(moe, ref_store_tokens,
                                                kind, name):
    tmodel, tparams = moe[4], moe[5]
    cls = getattr(teng, ENGINES[kind])
    kw = dict(n_slots=2, max_len=64, policy=_policy(tp, name),
              device="cpu")
    dense_toks = _drive(cls(tmodel, tparams, **kw))
    eng = cls(tmodel, tparams, compress=True, expert_cache=max(1, E // 4),
              **kw)
    store = _drive(eng)
    assert store == dense_toks
    if name != "fp32":
        assert store == ref_store_tokens[kind]
    stats = eng.expert_stats()
    assert stats is not None and stats["n_experts"] == E
    assert stats["misses"] > 0  # the routing probe ran at admission
    if name == "fp32":  # nothing compressed: the store is the dense stacks
        assert stats["store_bytes"] == stats["dense_bytes"]
    else:
        assert 0 < stats["store_bytes"] <= 0.5 * stats["dense_bytes"]
        assert stats["resident_bytes"] < stats["dense_bytes"]


@pytest.mark.parametrize("kind", ["fixed", "paged"])
def test_refresh_experts_keeps_the_tokens(moe, ref_store_tokens, kind):
    tmodel, tparams = moe[4], moe[5]
    cls = getattr(teng, ENGINES[kind])
    kw = dict(n_slots=2, max_len=64, policy=tp.preset("w4a8_abfp"),
              compress=True, device="cpu")
    plain = _drive(cls(tmodel, tparams, **kw))
    eng = cls(tmodel, tparams, expert_cache=2, **kw)
    assert _drive(eng, refresh_at=(2, 5)) == plain
    assert plain == ref_store_tokens[kind]
    assert eng.expert_stats()["cached_experts"] > 0
    banks = [b["ffn"]["wi"] for b in eng.params["blocks"]]
    assert any(not isinstance(e, tst.CompressedKernel)
               for b in banks for e in b.entries)  # dense copies swapped in


def test_engine_guards_carry_the_references_messages(moe, dense):
    tmodel, tparams = moe[4], moe[5]
    with pytest.raises(ValueError) as e:
        teng.ServeEngine(tmodel, tparams, expert_cache=1, device="cpu")
    assert str(e.value) == jmsg.expert_cache_requires_compress_message()
    with pytest.raises(ValueError) as e:
        teng.PagedServeEngine(dense[4], dense[5],
                              policy=tp.preset("w4a8_abfp"), compress=True,
                              expert_cache=1, device="cpu")
    assert str(e.value) == jmsg.expert_non_moe_message("an expert cache",
                                                       "tiny-dense")
    eng = teng.ServeEngine(tmodel, tparams, n_slots=1, max_len=64,
                           device="cpu")
    assert eng.expert_stats() is None
    with pytest.raises(ValueError, match="no expert store"):
        eng.refresh_experts()
    for name, args in (
            ("expert_cache_capacity_message", (E, E)),
            ("expert_non_moe_message", ("an expert store", "x")),
            ("expert_precision_inversion_message", (4.0, 8.0)),
            ("expert_cache_requires_compress_message", ())):
        assert getattr(tmsg, name)(*args) == getattr(jmsg, name)(*args)
