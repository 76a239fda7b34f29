"""The port's training launcher against the reference's (``python -m
repro.launch.train``), both driven through ``main`` on the CPU with the
same flags, the port's initial weights carried across from the reference's
(``Model.init`` patched; the two draw random numbers differently):

- opt-tiny ``--reduced``, plain fp32 and ``--qat`` under w4a8_abfp: the
  reference's summary keys; ``final_loss`` and the evaluation within 1e-5
  relative (fp32), within 1e-3 under QAT (free-running: a code at a
  rounding boundary flips when the f32 sums run in another order, and the
  runs part from there — ``test_torch_train_step`` anchors QAT step by
  step);
- ``--ckpt-dir``: a 6-step run preempted by a SIGTERM after step 4 (it
  checkpoints and exits) and started again reports ``resumed_from`` 4 and
  the uninterrupted run's ``final_loss`` and evaluation bit for bit; the
  reference's restart lands on the same numbers;
- the reference's exits: an image classifier, and the port's default
  device without a card; without ``--no-lint`` the launch passes the
  pre-flight gate;
- Queue A item 1: ``--arch mamba2-130m --reduced --steps 2 --recipe
  sq_gptq_w4a8`` — PTQ over an SSM tree after training.  Each of the
  port's three calibrations observes the parameters the reference's
  holds at that stage, its activation quantizers pinned to the
  reference's outputs (every code a pin changes sitting at a rounding
  boundary), and is held at ``test_torch_recipe``'s bars: statistics
  within ``STATS_BAR``, at most 0.1 % of GPTQ kernel elements a quantum
  off, alphas within 1e-5 but near-ties, the recipe's eval loss within
  1e-4 relative.
"""

import contextlib
import io
import json
import os
import signal
import sys

import jax
import numpy as np
import pytest
import torch

import repro.core.recipe as jr
import repro.launch.train as j_launch
import repro.models.quant_transforms as jqt
import repro_torch.core.recipe as tr
import repro_torch.launch.train as t_launch
import repro_torch.models.quant_transforms as tqt
from repro.configs import get_config as j_get_config
from repro.core.policy import QuantPolicy as JQuantPolicy
from repro.models import build_model as j_build_model
from repro.models.registry import Model as JModel
from repro.nn.module import unbox
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.models.registry import Model
from torch_ptq_helpers import (assert_pinned_calls_match,
                               assert_qtrees_match, assert_stats_match,
                               params_off, port_quantizer_calls,
                               reference_quantizer_calls)

FLAGS = ["--arch", "opt-tiny", "--reduced", "--corpus-tokens", "5000",
         "--seq-len", "32", "--global-batch", "4", "--warmup", "2",
         "--no-lint"]
KEYS = ["arch", "eval_loss", "eval_ppl", "final_loss", "policy",
        "resumed_from", "steps", "stragglers"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread beside the suite's other workers (no result
    depends on it)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


def _jitted_loss(monkeypatch):
    """The reference's ``Model.loss`` jitted (its launcher evaluates op by
    op, which compiles every operation on the CPU: 20 s of a QAT run)."""
    orig, cache = JModel.loss, {}

    def loss(self, params, batch, policy=JQuantPolicy(), q=None):
        key = (id(self), policy, q is None)
        if key not in cache:
            cache[key] = jax.jit(lambda p, b, q: orig(self, p, b, policy, q))
        return cache[key](params, batch, q)

    monkeypatch.setattr(JModel, "loss", loss)


def _reference(argv, monkeypatch) -> dict:
    monkeypatch.setattr(sys, "argv", ["repro.launch.train", *argv])
    _jitted_loss(monkeypatch)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert j_launch.main() == 0
    return _last_json(out.getvalue())


def _port(argv, monkeypatch, arch="opt-tiny", recipe=False) -> dict:
    """The port's ``main`` with ``Model.init`` returning the reference's
    initial weights for the same arch and seed (a fresh copy each time:
    the launcher's step overwrites them in place)."""
    jcfg = j_get_config(arch).reduced()
    tcfg = t_get_config(arch).reduced()
    if recipe:
        jcfg = jcfg.replace(scan_layers=False, remat="none")
        tcfg = tcfg.replace(scan_layers=False, remat="none")
    init = jax.device_get(unbox(j_build_model(jcfg).init(
        jax.random.PRNGKey(0))))
    monkeypatch.setattr(Model, "init", lambda self, gen: (
        bridge.from_repro_params(init, tcfg, device=self.device)))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert t_launch.main([*argv, "--device", "cpu"]) == 0
    return _last_json(out.getvalue())


def _same_summary(got, want, rtol):
    assert sorted(got) == sorted(want) == KEYS
    for key in ("arch", "policy", "steps"):  # stragglers: wall-clock
        assert got[key] == want[key], key
    for key in ("final_loss", "eval_loss", "eval_ppl"):
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   err_msg=key)


def test_qat_summary_matches_the_reference(monkeypatch, capsys):
    argv = FLAGS + ["--steps", "6", "--qat", "--policy", "w4a8_abfp"]
    want = _reference(argv, monkeypatch)
    got = _port(argv, monkeypatch)
    assert got["policy"] == "w4a8_abfp_qat"
    assert got["resumed_from"] is want["resumed_from"] is None
    _same_summary(got, want, 1e-3)
    assert "no pre-flight lint gate" not in capsys.readouterr().err


def _preempted_at(launch, monkeypatch, n: int):
    """Have ``launch``'s train step send this process a SIGTERM after its
    ``n``-th call, as a scheduler does before an eviction (the launcher's
    loop handles it: it checkpoints the next step and exits)."""
    make = launch.make_everything

    def make_everything(args):
        out = list(make(args))
        step, calls = out[5], []

        def preempted(*a):
            res = step(*a)
            calls.append(1)
            if len(calls) == n:
                os.kill(os.getpid(), signal.SIGTERM)
            return res

        out[5] = preempted
        return tuple(out)

    monkeypatch.setattr(launch, "make_everything", make_everything)


def test_preempted_run_resumes_as_the_uninterrupted_run(monkeypatch,
                                                        tmp_path):
    argv = FLAGS + ["--steps", "6"]
    whole = _port(argv, monkeypatch)
    handler = signal.getsignal(signal.SIGTERM)
    try:
        results = {}
        for name, launch, run in (("port", t_launch, _port),
                                  ("reference", j_launch, _reference)):
            ck = ["--ckpt-dir", str(tmp_path / name), "--ckpt-interval",
                  "100"]
            with monkeypatch.context() as mp:
                _preempted_at(launch, mp, 4)
                first = run(argv + ck, mp)
            assert first["steps"] == 4 and first["resumed_from"] is None
            results[name] = run(argv + ck, monkeypatch)
            assert results[name]["resumed_from"] == 4
            assert results[name]["steps"] == 6
    finally:
        signal.signal(signal.SIGTERM, handler)
    got, want = results["port"], results["reference"]
    assert got["final_loss"] == whole["final_loss"]
    assert got["eval_loss"] == whole["eval_loss"]
    _same_summary(got, want, 1e-5)
    _same_summary(whole, want, 1e-5)  # the reference resumes exactly too


def test_exits_and_notes(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["repro.launch.train", "--arch",
                                      "vit-b16"])
    with pytest.raises(SystemExit, match="image classifier"):
        j_launch.main()
    with pytest.raises(SystemExit, match="image classifier"):
        t_launch.main(["--arch", "vit-b16", "--device", "cpu"])
    if not torch.cuda.is_available():  # the default device: no fallback
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            t_launch.main(["--steps", "1"])
    capsys.readouterr()
    import repro_torch.launch.lint as t_lint

    gated, preflight = [], t_lint.preflight
    monkeypatch.setattr(t_lint, "preflight", lambda *a, **kw: (
        gated.append(kw["where"]), preflight(*a, **kw)))
    _port(FLAGS[:-1] + ["--steps", "1"], monkeypatch)
    assert gated == ["train"]  # without --no-lint the launch is gated
    assert "no pre-flight lint gate" not in capsys.readouterr().err


def test_ssm_recipe_after_training_matches_the_reference(monkeypatch):
    argv = ["--arch", "mamba2-130m", "--reduced", "--steps", "2",
            "--recipe", "sq_gptq_w4a8", "--corpus-tokens", "5000",
            "--seq-len", "32", "--global-batch", "4", "--no-lint"]
    stages, results = [], {}
    j_calibrate, t_calibrate = jqt.calibrate, tqt.calibrate
    j_apply, t_apply = jr.apply_recipe, tr.apply_recipe

    def j_cal(model, params, batches, policy, **kw):
        with reference_quantizer_calls() as calls:
            cal = j_calibrate(model, params, batches, policy, **kw)
        stages.append((params, calls, cal))
        return cal

    def keep(name, fn):
        def call(*a, **kw):
            results[name] = fn(*a, **kw)
            return results[name]
        return call

    monkeypatch.setattr(jqt, "calibrate", j_cal)
    monkeypatch.setattr(jr, "apply_recipe", keep("j", j_apply))
    want = _reference(argv, monkeypatch)

    tcfg = t_get_config("mamba2-130m").reduced().replace(
        scan_layers=False, remat="none")
    own, changed = [], []

    def t_cal(model, params, batches, policy, **kw):
        jparams, jcalls, jcal = stages[len(own)]
        own.append(params)
        anchor = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                          device="cpu")
        with port_quantizer_calls(pins=jcalls) as calls:
            cal = t_calibrate(model, anchor, batches, policy, **kw)
        changed.append(assert_pinned_calls_match(calls, jcalls))
        assert_stats_match(cal, jcal)
        return cal

    monkeypatch.setattr(tqt, "calibrate", t_cal)
    monkeypatch.setattr(tr, "apply_recipe", keep("t", t_apply))
    got = _port(argv, monkeypatch, arch="mamba2-130m", recipe=True)
    assert sorted(got) == sorted(want)
    for key in ("recipe", "recipe_policy", "recipe_calibrations", "steps"):
        assert got[key] == want[key], key
    assert got["recipe_calibrations"] == len(own) == 3
    np.testing.assert_allclose(got["final_loss"], want["final_loss"],
                               rtol=1e-5)
    jres, tres = results["j"], results["t"]
    assert tres.steps == jres.steps
    assert tres.dropped_sites == jres.dropped_sites == ("embed/attend/in",)
    # the params each calibration stood in for: the port's trained weights
    # (stage 1) and its SmoothQuant and GPTQ outputs from them
    for params, (jparams, _, _) in zip(own, stages):
        n_off, n_all = params_off(params, jparams)
        assert n_off <= n_all // 1000
    n_off, n_all = params_off(tres.params, jres.params)
    assert n_off <= n_all // 1000
    assert_qtrees_match(tres.qtree, jres.qtree, stages[-1][2], "int8")
    np.testing.assert_allclose(got["recipe_eval_loss"],
                               want["recipe_eval_loss"], rtol=1e-4)
    print(f"codes changed by the pins: {changed}; GPTQ elements a quantum "
          f"off: {n_off} of {n_all}")
