"""The port's checkpoint store and manager: a round trip of f32, bf16,
int8 and int32 leaves bit-equal (and readable by the reference's store,
as the reference's files are by the port's: one on-disk layout), an
uncommitted step ignored, retention, async writes while the step
overwrites its tensors in place, the reference's error cases — and a
checkpoint that the reference's training loop wrote, resumed in the port
(through ``bridge.read_repro_checkpoint``, stacked layers too, and by the
port's own loop reading the reference's directory) with the reference's
next-step loss."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.checkpoint.manager import CheckpointConfig as JCkConfig
from repro.configs import get_config as j_get_config
from repro.data.corpus import synthetic_corpus
from repro.data.loader import LMLoader
from repro.models import build_model as j_build_model
from repro.nn.module import unbox
from repro.optim.adamw import AdamW as JAdamW
from repro.train.loop import LoopConfig as JLoopConfig
from repro.train.loop import run as j_run
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import bridge
from repro_torch.checkpoint import store
from repro_torch.checkpoint.manager import CheckpointConfig, CheckpointManager
from repro_torch.configs import get_config as t_get_config
from repro_torch.models import build_model as t_build_model
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.train.loop import LoopConfig, run
from repro_torch.train.step import make_train_step
from repro_torch.tree import flatten_with_paths, leaves


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "a": torch.randn(4, 8, generator=g),
        "nested": {"b": torch.randn(3, generator=g).to(torch.bfloat16),
                   "c": torch.tensor(7, dtype=torch.int32),
                   "q": torch.randint(-128, 127, (5, 2), generator=g,
                                      dtype=torch.int8)},
        "blocks": [{"w": torch.randn(2, 2, generator=g)} for _ in range(2)],
    }


def _meta(tree):
    return {k: _meta(v) for k, v in tree.items()} if isinstance(tree, dict) \
        else [_meta(v) for v in tree] if isinstance(tree, list) \
        else torch.empty(tree.shape, dtype=tree.dtype, device="meta")


def _bit_equal(got, want):
    fg, fw = flatten_with_paths(got), flatten_with_paths(want)
    assert [p for p, _ in fg] == [p for p, _ in fw]
    for (p, a), (_, b) in zip(fg, fw):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert torch.equal(a.view(torch.int16) if a.dtype == torch.bfloat16
                           else a, b.view(torch.int16)
                           if b.dtype == torch.bfloat16 else b), p


def test_round_trip_is_bit_equal(tmp_path):
    d = str(tmp_path)
    t = _tree()
    store.save_pytree(d, 10, t, metadata={"step": 10})
    store.mark_committed(d, 10)
    _bit_equal(store.restore_pytree(d, 10, _meta(t)), t)
    _bit_equal(store.restore_pytree(d, 10, t), t)
    assert store.load_metadata(d, 10)["step"] == 10
    assert not [p for p in os.listdir(os.path.join(d, "step_00000010"))
                if ".tmp" in p]


def test_one_layout_for_both_packages(tmp_path):
    """The reference's store reads what the port wrote (leaf paths, bf16 as
    uint16 bits), and the port's reads what the reference wrote."""
    d = str(tmp_path)
    t = _tree(1)
    store.save_pytree(d, 3, t)
    shapes = jax.tree_util.tree_map(
        lambda x: jax.ShapeDtypeStruct(tuple(x.shape), {
            torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
            torch.int32: jnp.int32, torch.int8: jnp.int8}[x.dtype]),
        {k: v for k, v in t.items()},
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    got = j_store.restore_pytree(d, 3, shapes)
    for (p, a), (_, b) in zip(flatten_with_paths(t),
                              jax.tree_util.tree_flatten_with_path(got)[0]):
        b = np.asarray(b)
        if a.dtype == torch.bfloat16:
            b = b.view(np.uint16).astype(np.int32)
            a = a.view(torch.int16).numpy().view(np.uint16).astype(np.int32)
        np.testing.assert_array_equal(np.asarray(a), b, err_msg=p)
    jt = jax.tree_util.tree_map(
        lambda x: jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
        if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy()), t,
        is_leaf=lambda x: isinstance(x, torch.Tensor))
    j_store.save_pytree(d, 4, jt)
    _bit_equal(store.restore_pytree(d, 4, _meta(t)), t)


def test_uncommitted_and_tmp_dirs_are_ignored(tmp_path):
    d = str(tmp_path)
    store.save_pytree(d, 1, _tree())
    store.mark_committed(d, 1)
    store.save_pytree(d, 2, _tree())  # never committed (simulated crash)
    os.makedirs(os.path.join(d, "step_00000003", "params.tmp-1"))
    assert store.list_steps(d) == [1]
    assert store.list_steps(str(tmp_path / "missing")) == []
    mgr = CheckpointManager(CheckpointConfig(directory=d, async_write=False))
    mgr.save(10, {"state": _tree(0)})
    mgr.save(20, {"state": _tree(1)})
    store.save_pytree(d, 30, _tree(2))  # a crash mid-write of step 30
    assert mgr.latest_step() == 20


def test_restore_mismatches_raise(tmp_path):
    d = str(tmp_path)
    store.save_pytree(d, 1, _tree())
    bad = _meta(_tree())
    bad["a"] = torch.empty(2, 2, device="meta")
    with pytest.raises(ValueError, match="shape"):
        store.restore_pytree(d, 1, bad)
    with pytest.raises(ValueError, match="mismatch"):
        store.restore_pytree(d, 1, {"different": torch.zeros(1)})


def test_manager_cadence_and_retention(tmp_path):
    mgr = CheckpointManager(CheckpointConfig(
        directory=str(tmp_path), interval=10, keep=2, async_write=False))
    assert not mgr.should_save(5) and not mgr.should_save(0)
    assert mgr.should_save(10)
    for step in (10, 20, 30, 40):
        mgr.save(step, {"state": _tree(step)})
    assert store.list_steps(str(tmp_path)) == [30, 40]
    got = mgr.restore(40, {"state": _meta(_tree())})["state"]
    _bit_equal(got, _tree(40))


def test_async_write_under_in_place_updates(tmp_path):
    """The snapshot is the tensors at ``save``: overwriting them in place
    right after (as a donating step does) cannot reach the writer."""
    mgr = CheckpointManager(CheckpointConfig(directory=str(tmp_path),
                                             interval=1, async_write=True))
    for step in range(1, 4):
        t = {"w": torch.full((256, 256), float(step)),
             "opt": AdamWState(mu=[torch.ones(8) * step], nu=[torch.ones(8)],
                               count=torch.tensor(step, dtype=torch.int32))}
        mgr.save(step, {"params": t}, metadata={"step": step})
        t["w"].mul_(100)  # in place, while the thread may be writing
        t["opt"].mu[0].add_(5)
        t["opt"].count.add_(1)
    mgr.wait()
    assert store.list_steps(str(tmp_path)) == [1, 2, 3]
    for step in (1, 2, 3):
        got = mgr.restore(step, {"params": t})["params"]
        assert torch.equal(got["w"], torch.full((256, 256), float(step)))
        assert torch.equal(got["opt"].mu[0], torch.ones(8) * step)
        assert int(got["opt"].count) == step
        assert mgr.metadata(step) == {"step": step}


def test_async_write_failure_surfaces(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    mgr = CheckpointManager(CheckpointConfig(directory=str(blocker)))
    mgr.save(1, {"params": _tree()})
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        mgr.wait()


# --------------------------------------------- a reference run, resumed
@pytest.fixture(scope="module")
def ref_run(tmp_path_factory):
    """The reference's loop: 3 steps of opt-tiny (2 layers) checkpointed
    at step 3, then the step-4 loss an uninterrupted run reaches."""
    d = str(tmp_path_factory.mktemp("ref") / "ck")
    jcfg = j_get_config("opt-tiny").replace(n_layers=2)
    jmodel = j_build_model(jcfg)
    params = unbox(jmodel.init(jax.random.PRNGKey(0)))
    opt = JAdamW(lr=1e-3, weight_decay=0.01)
    step = jax.jit(j_make_train_step(jmodel, opt))
    loader = LMLoader(synthetic_corpus(30_000, vocab=256, seed=0),
                      seq_len=32, global_batch=4)
    ck = JCkConfig(directory=d, interval=3, async_write=False)
    j_run(step, params, opt.init(params), loader,
          JLoopConfig(total_steps=3, checkpoint=ck))
    res, _, _ = j_run(step, params, opt.init(params), loader,
                      JLoopConfig(total_steps=5))
    return d, jcfg, loader, [h["loss"] for h in res.history]


def test_reference_checkpoint_resumes_in_the_port(ref_run):
    d, jcfg, loader, losses = ref_run
    tcfg = t_get_config("opt-tiny").replace(n_layers=2)
    got = bridge.read_repro_checkpoint(d, 3, tcfg, device="cpu")
    assert got["metadata"] == {"step": 3} and int(got["opt"].count) == 3
    model = t_build_model(tcfg, device="cpu")
    opt = AdamW(lr=1e-3, weight_decay=0.01)
    _, state, m = make_train_step(model, opt)(got["params"], got["opt"],
                                              loader.batch_at(3))
    np.testing.assert_allclose(float(m["loss"]), losses[3], rtol=1e-6)
    assert int(state.count) == 4
    # the port's loop reads the reference's directory as it stands
    res, _, _ = run(make_train_step(model, opt), got["params"],
                    opt.init(got["params"]), loader,
                    LoopConfig(total_steps=5, checkpoint=CheckpointConfig(
                        directory=d, interval=100, async_write=False)))
    assert res.resumed_from == 3
    np.testing.assert_allclose([h["loss"] for h in res.history],
                               losses[3:], rtol=1e-5)


def test_stacked_reference_checkpoint_is_unstacked(tmp_path):
    """A checkpoint of the reference's scanned layout ((L, ...) leaves)
    reads into the port's list of layers."""
    jcfg = j_get_config("opt-tiny").replace(n_layers=2, scan_layers=True)
    jmodel = j_build_model(jcfg)
    params = jax.device_get(unbox(jmodel.init(jax.random.PRNGKey(2))))
    opt = JAdamW()
    state = jax.device_get(opt.init(params))
    d = str(tmp_path)
    j_store.save_pytree(d, 7, params, metadata={"step": 7}, name="params")
    j_store.save_pytree(d, 7, state, name="opt")
    j_store.mark_committed(d, 7)
    tcfg = t_get_config("opt-tiny").replace(n_layers=2)
    got = bridge.read_repro_checkpoint(d, 7, tcfg, device="cpu")
    want = bridge.from_repro_params(params, tcfg, device="cpu")
    _bit_equal(got["params"], want)
    assert len(got["params"]["blocks"]) == 2
    assert all(not torch.any(x) for x in leaves(got["opt"].mu))
    with pytest.raises(ValueError, match="n_layers"):
        bridge.read_repro_checkpoint(d, 7, tcfg.replace(n_layers=3),
                                     device="cpu")
