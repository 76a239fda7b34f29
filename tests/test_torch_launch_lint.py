"""``python -m repro_torch.launch.lint`` and the launchers' pre-flight gate.

The CLI gives the reference CLI's exit codes, text and JSON (``--out``
too), and the ``--all`` sweep its summary.  ``preflight`` exits 2 with the
report on stderr on an error and lets warnings through.  Both launchers
gate before ``build_model`` (patched here to fail, so a launch that gets
past the gate shows it): ``launch.serve`` with a one-page pool exits 2 on
QL305, ``launch.train --recipe no_such_recipe`` exits 2 on QL101 (before
the gate the port trained every step and failed only then), and
``--no-lint`` bypasses the gate; ``--expert-precision auto`` is gated
again once its map is assigned (QL503).
"""

import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import repro.launch.lint as j_cli
import repro_torch.launch.lint as t_cli
import repro_torch.models as t_models
from repro_torch.configs import SHAPES, get_config
from repro_torch.core.policy import preset
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _main(cli, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("argv,rc", [
    (["--arch", "qwen2-7b", "--policy", "w4a8_abfp"], 0),
    (["--arch", "qwen2-7b", "--policy", "w4a8_abfp", "--shape", "train_4k",
      "--compress"], 1),
    (["--arch", "zamba2-7b", "--recipe", "gptq", "--json"], 0),
    (["--arch", "qwen2-7b", "--policy", "w4a8_mse", "--recipe",
      "no_such_recipe", "--json"], 1),
    (["--arch", "mamba2-130m", "--policy", "w4a4_abfp", "--shape",
      "prefill_32k", "-v"], 0),
])
def test_cli_matches_the_reference(argv, rc):
    got, want = _main(t_cli, argv), _main(j_cli, argv)
    assert got[0] == want[0] == rc
    if "--json" in argv:
        g, w = json.loads(got[1]), json.loads(want[1])
        for d in w["diagnostics"]:  # QL101's hint names its package
            d["hint"] = d["hint"].replace("repro.core", "repro_torch.core")
        assert g == w
    else:
        assert got[1] == want[1]


def test_cli_writes_the_report(tmp_path):
    path = tmp_path / "report.json"
    rc, out = _main(t_cli, ["--arch", "opt-125m", "--policy", "w8a8_abfp",
                            "--out", str(path)])
    assert rc == 0 and "=> OK" in out
    payload = json.loads(path.read_text())
    assert payload["ok"] is True and payload["context"]["arch"] == "opt-125m"


def test_cli_needs_an_arch_or_all():
    with pytest.raises(SystemExit) as e:
        t_cli.main([])
    assert e.value.code == 2


def test_all_sweep_summary(tmp_path):
    path = tmp_path / "lint.json"
    rc, out = _main(t_cli, ["--all", "--json", "--out", str(path)])
    summary = {"combinations": 2252, "skipped": 2, "errors": 0,
               "warnings": 252, "ok": True}
    assert rc == 0 and json.loads(out) == summary
    payload = json.loads(path.read_text())
    assert payload["summary"] == summary
    assert len(payload["reports"]) == 2252


def test_module_entry_point():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", "--arch",
         "qwen2-7b", "--policy", "fp32", "--json"], cwd=ROOT,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout)["context"]["policy"] == "fp32"


def test_preflight_blocks_and_passes():
    cfg = get_config("qwen2-7b")
    buf = io.StringIO()
    with pytest.raises(SystemExit) as e:
        t_cli.preflight(cfg, preset("w4a8_abfp"), shape=SHAPES["train_4k"],
                        compress=True, where="train", out=buf)
    assert e.value.code == 2
    text = buf.getvalue()
    assert text.startswith("qlint: train blocked by 1 error(s):")
    assert "QL204" in text and "(bypass with --no-lint)" in text
    buf = io.StringIO()
    t_cli.preflight(cfg, preset("w8a8_e4m3"), compress=True, out=buf)
    assert "qlint [launch] QL201" in buf.getvalue()  # warnings pass


class Built(Exception):
    """Raised by the patched ``build_model``: the launch got past the
    gate."""


@pytest.fixture
def no_build(monkeypatch):
    def build_model(*a, **kw):
        raise Built()

    monkeypatch.setattr(t_models, "build_model", build_model)


def _exit(fn, argv, capsys):
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        fn(argv)
    return e.value.code, capsys.readouterr().err


def test_serve_gate_blocks_a_one_page_pool(no_build, capsys):
    argv = ["--paged", "--n-pages", "1", "--device", "cpu"]
    code, err = _exit(tserve.main, argv, capsys)
    assert code == 2
    assert err.startswith("qlint: serve blocked by 1 error(s):")
    assert "QL305" in err and "paged KV pool of 1 pages" in err
    with pytest.raises(Built):
        tserve.main(argv + ["--no-lint"])


def test_serve_gate_blocks_what_the_reference_blocks(no_build, capsys):
    """An expert cache on a dense arch (QL502) and the compressed attention
    backend over fp pages (QL601): the reference's gate refuses both; fp
    pages under paged speculation pass."""
    for argv, code in (
            (["--policy", "w8a8_abfp", "--compress", "--expert-cache",
              "2"], "QL502"),
            (["--paged", "--attn-backend", "compressed", "--kv", "fp"],
             "QL601")):
        rc, err = _exit(tserve.main, argv + ["--device", "cpu"], capsys)
        assert rc == 2 and code in err, (argv, err)
    with pytest.raises(Built):
        tserve.main(["--paged", "--speculate", "--device", "cpu"])


def test_train_gate_blocks_an_unknown_recipe(no_build, capsys):
    argv = ["--reduced", "--steps", "1", "--recipe", "no_such_recipe",
            "--device", "cpu"]
    code, err = _exit(tlaunch.main, argv, capsys)
    assert code == 2
    assert err.startswith("qlint: train blocked by 1 error(s):")
    assert "QL101" in err and "no_such_recipe" in err
    with pytest.raises(Built):
        tlaunch.main(argv + ["--no-lint"])


def test_train_gate_passes_a_clean_launch(no_build, capsys):
    with pytest.raises(Built):
        tlaunch.main(["--reduced", "--steps", "1", "--policy", "w4a8_abfp",
                      "--qat", "--device", "cpu"])
    assert "qlint" not in capsys.readouterr().err


def test_expert_precision_auto_is_gated_again(monkeypatch, capsys):
    """The map ``--expert-precision auto`` assigns is linted with its hot
    set: an inverted assignment (hot experts INT4, cold INT8) warns
    QL503 and serves, as the reference's re-gate does."""
    import repro_torch.serve.experts as t_exp

    def inverted(loads, base, *, n_hot, **kw):
        hot = t_exp.hot_experts(loads, n_hot)
        return t_exp.expert_precision_map(base, hot, hot_fmt="int4",
                                          cold_fmt="int8")

    monkeypatch.setattr(t_exp, "assign_expert_precision", inverted)
    assert tserve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--policy",
                        "w4a8_abfp", "--compress", "--expert-precision",
                        "auto", "--n-requests", "1", "--max-new-tokens",
                        "2", "--device", "cpu"]) == 0
    err = capsys.readouterr().err
    assert "qlint [serve] QL503" in err and "LESS precision" in err
