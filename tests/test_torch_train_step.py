"""The port's train step against the reference's on opt-tiny (2 layers),
the reference's weights carried across by the bridge, batches from the
reference's loader.

- fp32: the gradient of every leaf within rtol 1e-5 of the reference's
  (largest difference over the leaf's largest magnitude; through the tied
  head, learned positions, the chunked loss and blockwise attention too),
  and a free-running 20-step loss curve within 1e-5 relative.
- w4a8_abfp with the straight-through estimator: five steps, each from the
  reference's parameters and optimizer state (anchored).  An activation
  code (or an STE mask bit) that sits at a rounding boundary flips when the
  f32 sums run in another order, and AdamW's first steps turn any
  difference in a small gradient into a full ``lr`` step, so the bar comes
  from a control: the reference against itself with one ulp added to half
  its embedding table (and, separately, taken from the other half).  The
  port's largest relative update gap must lie within 2x the control's; the
  loss within 1e-4 relative every step.
- microbatches 2 against 1 (the reference's own bar), and the loss and
  gradient norm against the reference's microbatched step.
- remat ``none`` / ``full`` / ``dots``: bit-equal gradients and steps,
  ``dots`` recomputes no weight contraction in the backward, and a forward
  that builds no graph (a served step) never enters the checkpoint.
- a fused policy: the reference's train step and the port's both raise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.data.corpus import synthetic_corpus
from repro.data.loader import LMLoader
from repro.models import build_model as j_build_model
from repro.nn.module import unbox
from repro.optim.adamw import AdamW as JAdamW
from repro.train.step import TrainStepConfig as JStepConfig
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch import tree as tt
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tp
from repro_torch.models import build_model as t_build_model
from repro_torch.optim.adamw import AdamW as TAdamW
from repro_torch.train.step import TrainStepConfig as TStepConfig
from repro_torch.train.step import make_loss_and_grads
from repro_torch.train.step import make_train_step as t_make_train_step

N_GROUP = 16


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The port's legs on one torch thread: under the suite's six workers
    more threads only contend for the cores.  No result depends on it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def s():
    jcfg = j_get_config("opt-tiny").replace(n_layers=2)
    jmodel = j_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tcfg = t_get_config("opt-tiny").replace(n_layers=2)
    stream = synthetic_corpus(30_000, vocab=256, seed=0)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tcfg=tcfg,
                tmodel=t_build_model(tcfg, device="cpu"),
                loader=LMLoader(stream, seq_len=32, global_batch=4))


def _tparams(s, jparams):
    return bridge.from_repro_params(jax.device_get(jparams), s["tcfg"],
                                    device="cpu")


def _tstate(s, jstate):
    return bridge.from_repro_opt_state(jax.device_get(jstate), s["tcfg"],
                                       device="cpu")


def _pols(name, ste=False):
    if name == "fp32":
        return jp.preset("fp32"), tp.preset("fp32")
    j = jp.preset(name, n=N_GROUP, n_layers=2)
    t = tp.preset(name, n=N_GROUP, n_layers=2)
    return (j.with_ste(True), t.with_ste(True)) if ste else (j, t)


def _port_grads(model, params, batch, policy):
    """The train step's own gradients (``make_loss_and_grads``)."""
    loss, _, grads = make_loss_and_grads(model, policy)(params, batch)
    return loss, grads


def _clone(tree):
    """A copy for a step that overwrites its parameters in place."""
    return tt.tree_map(torch.clone, tree)


def _leaf_rel(got, want):
    """Largest difference over the leaf's largest magnitude."""
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()
                 / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------------ gradients
@pytest.mark.parametrize("variant", ["plain", "chunked_loss", "blockwise"])
def test_fp32_gradients_match_per_leaf(s, variant):
    jcfg, tcfg, seq = s["jcfg"], s["tcfg"], 32
    if variant == "chunked_loss":
        jcfg, tcfg = (c.replace(logits_chunk=8) for c in (jcfg, tcfg))
    jparams = s["jparams"]
    if variant == "blockwise":  # S >= 1024: the running-softmax loop
        seq = 1024
        jcfg, tcfg = (c.replace(max_position=seq) for c in (jcfg, tcfg))
    jmodel, tmodel = j_build_model(jcfg), t_build_model(tcfg, device="cpu")
    if variant == "blockwise":
        jparams = unbox(jmodel.init(jax.random.PRNGKey(1)))
    rng = np.random.RandomState(5)
    t = rng.randint(0, jcfg.vocab, (2 if seq == 32 else 1, seq + 1))
    batch = {"tokens": t[:, :-1].astype(np.int32),
             "labels": t[:, 1:].astype(np.int32)}
    batch["labels"][:, -3:] = -1  # masked labels
    jpol, tpol = _pols("fp32")
    jloss, jg = jax.jit(jax.value_and_grad(
        lambda p: jmodel.loss(p, batch, jpol)[0]))(jparams)
    tparams = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                       device="cpu")
    tloss, tg = _port_grads(tmodel, tparams, batch, tpol)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss),
                               rtol=1e-6)
    want = jax.tree_util.tree_flatten_with_path(jg)[0]
    paths = [p for p, _ in tt.flatten_with_paths(jparams)]
    assert paths == ["/".join(str(k) for k in p) for p, _ in want]
    for path, g, (_, w) in zip(paths, tg, want):
        assert tuple(g.shape) == w.shape, path
        assert _leaf_rel(g, w) <= 1e-5, path


def test_fp32_loss_curve_matches_for_20_steps(s):
    jpol, tpol = _pols("fp32")
    jopt = JAdamW(lr=1e-3, weight_decay=0.01)
    topt = TAdamW(lr=1e-3, weight_decay=0.01)
    jstep = jax.jit(j_make_train_step(s["jmodel"], jopt, jpol))
    tstep = t_make_train_step(s["tmodel"], topt, tpol)
    jparams, jstate = s["jparams"], jopt.init(s["jparams"])
    tparams = _tparams(s, s["jparams"])
    tstate = topt.init(tparams)
    for k in range(20):
        batch = s["loader"].batch_at(k)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        tparams, tstate, tm = tstep(tparams, tstate, batch)
        assert sorted(tm) == sorted(jm) == ["aux", "ce", "grad_norm",
                                            "loss"]
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=f"step {k}")
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(tstate.count) == 20


# --------------------------------------------------------------- QAT
def _update_gap(got, want, start):
    """The norm of (got - want) over the norm of the reference's update
    (want - start), every leaf together."""
    d = u = 0.0
    for g, w, p in zip(got, want, start):
        g, w, p = (np.asarray(x, np.float64) for x in (g, w, p))
        d += ((g - w) ** 2).sum()
        u += ((w - p) ** 2).sum()
    return float(np.sqrt(d / u))


def _nudged(params, half: int):
    """``params`` with one ulp added to the first half of the embedding
    table (``half`` 0) or taken from the second half (``half`` 1)."""
    params = jax.device_get(params)
    table = np.array(params["embed"]["table"])
    flat = table.reshape(-1)
    n = flat.size // 2
    if half == 0:
        flat[:n] = np.nextafter(flat[:n], np.float32(np.inf))
    else:
        flat[n:] = np.nextafter(flat[n:], np.float32(-np.inf))
    return dict(params, embed=dict(params["embed"], table=jnp.asarray(table)))


def test_qat_w4a8_abfp_anchored_five_steps(s):
    jpol, tpol = _pols("w4a8_abfp", ste=True)
    assert tpol.name == jpol.name and tpol.input.ste and tpol.weight.ste
    jopt = JAdamW(lr=1e-3, weight_decay=0.01)
    topt = TAdamW(lr=1e-3, weight_decay=0.01)
    jstep = jax.jit(j_make_train_step(s["jmodel"], jopt, jpol))
    tstep = t_make_train_step(s["tmodel"], topt, tpol)
    jparams, jstate = s["jparams"], jopt.init(s["jparams"])
    leaves = jax.tree_util.tree_leaves
    port, control = [], []
    for k in range(5):
        batch = s["loader"].batch_at(k)
        start = leaves(jparams)
        jp1, js1, jm = jstep(jparams, jstate, batch)
        tp1, ts1, tm = tstep(_tparams(s, jparams), _tstate(s, jstate), batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-4, err_msg=f"step {k}")
        assert int(ts1.count) == int(js1.count) == k + 1
        port.append(_update_gap([t.numpy() for t in tt.leaves(tp1)],
                                leaves(jp1), start))
        control.append(max(
            _update_gap(leaves(jstep(_nudged(jparams, h), jstate,
                                     batch)[0]), leaves(jp1), start)
            for h in (0, 1)))
        jparams, jstate = jp1, js1
    print(f"relative update gaps, port: {port}; control: {control}")
    # the control flips codes: it sets a bar a reordering can reach
    assert max(control) > 1e-3
    assert max(port) <= 2 * max(control)


# --------------------------------------------------------- microbatches
def test_microbatches_match_full_batch(s):
    jpol, tpol = _pols("fp32")
    jopt, topt = JAdamW(lr=1e-3), TAdamW(lr=1e-3)
    batch = s["loader"].batch_at(0)
    tparams = _tparams(s, s["jparams"])
    t1 = t_make_train_step(s["tmodel"], topt, tpol, TStepConfig(1))
    t2 = t_make_train_step(s["tmodel"], topt, tpol, TStepConfig(2))
    p1, _, m1 = t1(_clone(tparams), topt.init(tparams), batch)
    p2, st2, m2 = t2(_clone(tparams), topt.init(tparams), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for a, b in zip(tt.leaves(p1), tt.leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)
    # and against the reference's microbatched step
    j2 = j_make_train_step(s["jmodel"], jopt, jpol, JStepConfig(2))
    _, _, jm2 = j2(s["jparams"], jopt.init(s["jparams"]), batch)
    np.testing.assert_allclose(float(m2["loss"]), float(jm2["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(m2["grad_norm"]),
                               float(jm2["grad_norm"]), rtol=1e-5)
    with pytest.raises(AssertionError):
        t_make_train_step(s["tmodel"], topt, tpol, TStepConfig(3))(
            tparams, topt.init(tparams), batch)


# ---------------------------------------------------------------- remat
class _CountMatmuls(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.mm += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("policy", ["fp32", "w4a8_abfp"])
def test_remat_modes_are_bit_equal(s, policy):
    _, tpol = _pols(policy, ste=policy != "fp32")
    batch = s["loader"].batch_at(3)
    params = _tparams(s, s["jparams"])
    grads, backward_mm, steps = {}, {}, {}
    for remat in ("none", "full", "dots"):
        model = t_build_model(s["tcfg"].replace(remat=remat), device="cpu")
        flat = tt.leaves(params)
        req = [p.detach().requires_grad_() for p in flat]
        loss, _ = model.loss(tt.unflatten(params, req), batch, tpol)
        with _CountMatmuls() as count:
            grads[remat] = torch.autograd.grad(loss, req)
        backward_mm[remat] = count.mm
        opt = TAdamW(lr=1e-3, weight_decay=0.01)
        steps[remat] = tt.leaves(t_make_train_step(model, opt, tpol)(
            _clone(params), opt.init(params), batch)[0])
    for remat in ("full", "dots"):
        assert all(torch.equal(a, b) for a, b in
                   zip(grads["none"], grads[remat])), remat
        assert all(torch.equal(a, b) for a, b in
                   zip(steps["none"], steps[remat])), remat
    # "full" runs each block's forward again (its contractions included);
    # "dots" keeps the contractions' outputs and recomputes none of them
    assert backward_mm["full"] > backward_mm["none"] == backward_mm["dots"]


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_only_where_a_graph_is_built(s, remat, monkeypatch):
    """A forward whose embeddings need no gradient (a served step, under
    grad mode or not) never enters ``torch.utils.checkpoint``; a train
    step's forward enters it once a block."""
    from repro_torch.models import lm as t_lm

    calls = []
    real = t_lm.checkpoint
    monkeypatch.setattr(t_lm, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    model = t_build_model(s["tcfg"].replace(remat=remat), device="cpu")
    params = _tparams(s, s["jparams"])
    batch = s["loader"].batch_at(0)
    assert torch.is_grad_enabled()
    model.loss(params, batch, _pols("fp32")[1])  # no leaf requires grad
    assert calls == []
    _port_grads(model, params, batch, _pols("fp32")[1])
    assert len(calls) == s["tcfg"].n_layers


# ---------------------------------------------------------- fused raises
@pytest.mark.parametrize("base", ["w4a8_abfp", "w4a8_int8_native"])
def test_fused_policy_train_step_raises_as_the_reference_does(s, base):
    jfused = jp.with_attn_backend(jp.map_policies(
        jp.preset(base, n=N_GROUP), lambda q: q.replace(fused=True)),
        "fused").with_ste(True)
    tfused = tp.with_attn_backend(tp.map_policies(
        tp.preset(base, n=N_GROUP), lambda q: q.replace(fused=True)),
        "fused").with_ste(True)
    batch = s["loader"].batch_at(0)
    jopt, topt = JAdamW(), TAdamW()
    # the reference's Pallas kernels have no JVP rule under jax.grad
    with pytest.raises((AssertionError, ValueError)):
        j_make_train_step(s["jmodel"], jopt, jfused)(
            s["jparams"], jopt.init(s["jparams"]), batch)
    tparams = _tparams(s, s["jparams"])
    with pytest.raises(ValueError, match="no backward"):
        t_make_train_step(s["tmodel"], topt, tfused)(
            tparams, topt.init(tparams), batch)
    # the same policy evaluates the weights without a graph
    with torch.no_grad():
        loss, _ = s["tmodel"].loss(tparams, batch, tfused)
    assert np.isfinite(float(loss))
