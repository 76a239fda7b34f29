"""The reference's fault-tolerant loop tests (``tests/test_train_loop.py``),
run on the port: logging, restart exactness, straggler detection,
preemption, microbatches and the ``ArrayBatches`` adapter — plus restart
exactness with async checkpoint writes under a QAT policy, and the port's
loop resuming a run the reference checkpointed.  The port's step
overwrites its parameters in place, so every run starts from a copy of
the fixture's (the reference's jitted step leaves its inputs alone)."""

import json
import time

import jax
import numpy as np
import pytest
import torch

from repro_torch.checkpoint import store
from repro_torch.checkpoint.manager import CheckpointConfig
from repro_torch.configs import get_config
from repro_torch.core.policy import preset
from repro_torch.data.corpus import synthetic_corpus
from repro_torch.data.loader import LMLoader
from repro_torch.models import build_model
from repro_torch.nn.module import make_generator
from repro_torch.optim.adamw import AdamW
from repro_torch.train import loop as loop_mod
from repro_torch.train.loop import ArrayBatches, LoopConfig, run
from repro_torch.train.step import TrainStepConfig, make_train_step
from repro_torch.tree import leaves, tree_map


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread beside the suite's other workers (no result
    depends on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg():
    return get_config("opt-tiny").replace(n_layers=2, d_model=64, n_heads=2,
                                          n_kv=2, head_dim=32, d_ff=128)


@pytest.fixture(scope="module")
def setup():
    model = build_model(_cfg(), device="cpu")
    params = model.init(make_generator(0, "cpu"))
    opt = AdamW(lr=1e-3)
    step = make_train_step(model, opt, cfg=TrainStepConfig())
    stream = synthetic_corpus(30_000, vocab=256, seed=0)
    loader = LMLoader(stream, seq_len=32, global_batch=4)
    return model, params, opt, step, loader


def _clone(tree):
    return tree_map(torch.clone, tree)


def _equal(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.numpy(), y.numpy())


def test_loop_runs_and_logs(setup, tmp_path):
    model, params, opt, step, loader = setup
    mpath = str(tmp_path / "metrics.jsonl")
    result, p2, o2 = run(step, _clone(params), opt.init(params), loader,
                         LoopConfig(total_steps=5, log_every=1,
                                    metrics_path=mpath))
    assert result.last_step == 4
    assert np.isfinite(result.last_metrics["loss"])
    lines = [json.loads(l) for l in open(mpath)]
    assert len(lines) == 5
    assert all("loss" in l and "time_s" in l and "grad_norm" in l
               for l in lines)
    assert int(o2.count) == 5


def test_restart_exactness(setup, tmp_path):
    """Kill after step 6, restart, and the parameters at step 10 must be
    BIT-IDENTICAL to an uninterrupted 10-step run."""
    model, params, opt, step, loader = setup
    _, p_cont, o_cont = run(step, _clone(params), opt.init(params), loader,
                            LoopConfig(total_steps=10))
    ck = CheckpointConfig(directory=str(tmp_path / "ck"), interval=3,
                          keep=3, async_write=False)
    run(step, _clone(params), opt.init(params), loader,
        LoopConfig(total_steps=6, checkpoint=ck))
    result_b, p_b, o_b = run(step, _clone(params), opt.init(params), loader,
                             LoopConfig(total_steps=10, checkpoint=ck))
    assert result_b.resumed_from == 6
    _equal(p_cont, p_b)
    _equal(o_cont, o_b)


def test_straggler_detection(setup):
    model, params, opt, step, loader = setup
    slow_steps = {3}

    def slow_step(p, o, b):
        out = step(p, o, b)
        if slow_step.i in slow_steps:
            time.sleep(1.0)
        slow_step.i += 1
        return out

    slow_step.i = 0
    result, _, _ = run(slow_step, _clone(params), opt.init(params), loader,
                       LoopConfig(total_steps=6, straggler_factor=3.0))
    assert 3 in result.stragglers


def test_preemption_saves_and_exits(setup, tmp_path):
    model, params, opt, step, loader = setup
    ck = CheckpointConfig(directory=str(tmp_path / "pre"), interval=1000,
                          async_write=False)
    cfg = LoopConfig(total_steps=50, checkpoint=ck)
    state = {"mgr": None, "i": 0}

    def wrapped(p, o, b):
        out = step(p, o, b)
        state["i"] += 1
        if state["i"] == 4:
            state["mgr"].preempted.set()
        return out

    orig = loop_mod.CheckpointManager

    class Hooked(orig):
        def __init__(self, c):
            super().__init__(c)
            state["mgr"] = self

    loop_mod.CheckpointManager = Hooked
    try:
        result, _, _ = run(wrapped, _clone(params), opt.init(params), loader, cfg)
    finally:
        loop_mod.CheckpointManager = orig
    assert result.preempted
    assert result.last_step == 3  # stopped right after the flag
    assert store.list_steps(str(tmp_path / "pre")) == [4]


def test_microbatched_grads_match_full_batch(setup):
    """Gradient accumulation: k microbatches == one full batch (linearity
    of mean-CE gradients over equal-size shards)."""
    model, params, opt, step, loader = setup
    batch = loader.batch_at(0)
    s1 = make_train_step(model, opt, preset("fp32"),
                         TrainStepConfig(microbatches=1))
    s2 = make_train_step(model, opt, preset("fp32"),
                         TrainStepConfig(microbatches=2))
    p1, _, m1 = s1(_clone(params), opt.init(params), batch)
    p2, _, m2 = s2(_clone(params), opt.init(params), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    for a, b in zip(leaves(p1), leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_array_batches_adapter():
    bs = [{"x": np.ones(2) * i} for i in range(3)]
    ab = ArrayBatches(bs, tokens_per_step=10)
    np.testing.assert_array_equal(ab.batch_at(4)["x"], np.ones(2))
    assert ab.tokens_per_step == 10


def test_donating_qat_restart_with_async_writes(setup, tmp_path):
    """The launcher's form: the step (parameters and moments overwritten
    in place) under w4a8_abfp QAT, checkpoints written by the
    async thread every 2 steps and SIGTERM handled.  Killed after step 5
    (an odd step: it resumes from step 4), the restart's losses at steps
    5-7 and its final state equal the uninterrupted run's, bit for bit."""
    model, params, opt, _, loader = setup
    pol = preset("w4a8_abfp", n=16).with_ste(True)
    step = make_train_step(model, opt, pol)
    res_a, p_a, o_a = run(step, _clone(params), opt.init(params), loader,
                          LoopConfig(total_steps=8))
    ck = CheckpointConfig(directory=str(tmp_path / "ck"), interval=2,
                          keep=2, async_write=True)
    run(step, _clone(params), opt.init(params), loader,
        LoopConfig(total_steps=5, checkpoint=ck, handle_sigterm=True))
    assert store.list_steps(ck.directory) == [4, 5]  # keep=2; 5 is the end
    store.delete_step(ck.directory, 5)  # the kill came before step 5's save
    res_b, p_b, o_b = run(step, _clone(params), opt.init(params), loader,
                          LoopConfig(total_steps=8, checkpoint=ck))
    assert res_b.resumed_from == 4
    assert [h["loss"] for h in res_b.history] == [
        h["loss"] for h in res_a.history[4:]]
    _equal(p_a, p_b)
    _equal(o_a, o_b)
