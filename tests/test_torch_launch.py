"""The port's serving launcher: same report keys as the reference launcher
(checked against a reference run at the same flags, also with a PTQ
``--recipe``), CPU only when asked, and a clear exit for every flag whose
feature is not ported yet."""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.launch import serve as tserve

FLAGS = ["--paged", "--policy", "w4a8_abfp", "--compress", "--kv", "int8",
         "--attn-backend", "compressed", "--n-requests", "3",
         "--max-new-tokens", "4", "--max-len", "64"]


def test_report_matches_reference_launcher(capsys):
    assert tserve.main(FLAGS + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.serve", *FLAGS, "--no-lint"],
        check=True, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert set(got) - set(want) == {"device"}
    timing = {"wall_s", "tokens_per_s"}
    # under its default scan-over-layers the reference counts one stacked
    # site per kernel kind; the port always counts per layer
    for key in set(want) - timing - {"compressed_sites"}:
        assert got[key] == want[key], key
    assert got["compressed_sites"] == 15
    assert got["device"] == "cpu"


@pytest.mark.parametrize("flags,needle", [
    (["--speculate"], "Speculative"),
    (["--paged", "--speculate"], "Speculative"),
    (["--paged", "--expert-cache", "2"], "MoE serving"),
    (["--paged", "--expert-precision", "auto"], "MoE serving"),
])
def test_unported_flags_exit_naming_the_roadmap(flags, needle):
    with pytest.raises(SystemExit) as e:
        tserve.main(flags + ["--device", "cpu"])
    assert "ROADMAP.md" in str(e.value) and needle in str(e.value)


@pytest.mark.parametrize("engine", [[], ["--paged"]])
def test_recipe_report_matches_reference_launcher(capsys, engine):
    """``--recipe gptq`` on opt-tiny: calibrate on synthetic prompts under
    w4a8_mse, GPTQ every decoder kernel, then serve — the reference
    launcher's report at the same flags (fixed-slot and paged)."""
    flags = ["--arch", "opt-tiny", "--recipe", "gptq", *engine,
             "--n-requests", "3", "--max-new-tokens", "4", "--max-len", "64"]
    assert tserve.main(flags + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.serve", *flags, "--no-lint"],
        check=True, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    assert set(got) - set(want) == {"device"}
    for key in set(want) - {"wall_s", "tokens_per_s"}:
        assert got[key] == want[key], key
    assert got["recipe"] == "gptq" and got["recipe_calibrations"] == 1
    assert got["arch"] == "opt-tiny-reduced" and got["policy"] == "fp32"


def test_unknown_arch_lists_the_registry():
    with pytest.raises(ValueError, match="known: \\['deit-s16', "
                       "'gemma2-9b', 'granite-3-8b', 'h2o-danube-1.8b', "
                       "'internvl2-2b', 'llama4-scout-17b-a16e', "
                       "'mamba2-130m', 'opt-125m', 'opt-tiny', "
                       "'phi3.5-moe-42b-a6.6b', 'qwen2-7b', 'vit-b16', "
                       "'whisper-large-v3', 'zamba2-7b'\\]"):
        tserve.main(["--paged", "--device", "cpu", "--arch", "gemma3-27b"])
