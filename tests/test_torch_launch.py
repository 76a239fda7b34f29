"""The port's serving launcher: same report keys as the reference launcher
(checked against a reference run at the same flags, also with a PTQ
``--recipe``, ``--speculate`` and ``--expert-cache``), CPU only when asked,
and the reference's outcome for the speculative and expert flags."""

import json
import os
import subprocess
import sys

import pytest

from repro_torch.analysis import messages as msg
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


@pytest.mark.parametrize("flags,outcome", [
    (["--speculate"], "fixed"),
    (["--paged", "--speculate"], "paged"),
    (["--paged", "--expert-cache", "2"],
     msg.expert_cache_requires_compress_message()),
    (["--paged", "--expert-precision", "auto"],
     msg.expert_non_moe_message("--expert-precision auto",
                                "qwen2-7b-reduced")),
], ids=["flags0-Speculative", "flags1-Speculative", "flags2-MoE serving",
        "flags3-MoE serving"])  # the cases' ids from before the port had
# the flags
def test_unported_flags_exit_naming_the_roadmap(capsys, flags, outcome):
    """The four flags that exited as not ported before speculative and
    expert-resident serving came to the port now do what the reference
    launcher does with them: ``--speculate`` serves (fixed-slot, or paged
    over fp pages) and reports acceptance stats; on a dense arch without
    ``--compress`` the expert flags exit with the reference's messages.
    ``--expert-precision`` on a dense arch is refused by the pre-flight
    gate first (QL502, exit code 2), as the reference's gate refuses it;
    past the gate (``--no-lint``) the launcher's own check exits."""
    argv = flags + ["--device", "cpu", "--n-requests", "2",
                    "--max-new-tokens", "5"]
    if outcome not in ("fixed", "paged"):
        if "--expert-precision" in flags:
            capsys.readouterr()
            with pytest.raises(SystemExit) as e:
                tserve.main(argv)
            assert e.value.code == 2
            assert "QL502" in capsys.readouterr().err
            argv = argv + ["--no-lint"]
        with pytest.raises(SystemExit) as e:
            tserve.main(argv)
        assert str(e.value) == outcome
        return
    assert tserve.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    spec = got["speculative"]
    assert spec["kv_cache"] == outcome and spec["draft_k"] == 4
    assert spec["drafted"] == 4 * spec["target_steps"] > 0
    assert "paged" not in got  # the report's paged block is not speculative
    assert ("page_stats" in spec) == (outcome == "paged")
    for c in got["completions"]:
        assert c["drafted_tokens"] == 4 * c["target_steps"]
        assert c["n_tokens"] == 5


def _reference_report(flags) -> dict:
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.serve", *flags, "--no-lint"],
        check=True, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return json.loads(ref.stdout.strip().splitlines()[-1])


def test_speculate_report_matches_reference_launcher(capsys):
    """``--speculate`` on ``--reduced``: the reference launcher's report
    keys, acceptance keys and per-request fields.  The two stacks draw
    other random weights, so acceptance itself is not compared; the
    draft's compression report is, but for the site count (the reference
    counts one stacked site a kernel kind under its scan)."""
    flags = ["--speculate", "--n-requests", "3", "--max-new-tokens", "6"]
    assert tserve.main(flags + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _reference_report(flags)
    assert set(got) - set(want) == {"device"} and set(want) <= set(got)
    assert set(got["speculative"]) == set(want["speculative"])
    assert ([set(c) for c in got["completions"]]
            == [set(c) for c in want["completions"]])
    for key in ("dense_weight_mb", "resident_weight_mb", "weight_bytes_ratio"):
        assert got["speculative"]["draft_weights"][key] == \
            want["speculative"]["draft_weights"][key], key
    for key in ("arch", "policy", "requests", "generated_tokens"):
        assert got[key] == want[key], key


def test_expert_cache_report_matches_reference_launcher(capsys):
    """``--compress --expert-cache 2`` on reduced Phi-3.5-MoE: the
    reference launcher's keys and the store's byte totals (the reference
    stacks both layers into one site under its scan; the port counts a
    site a layer, so the per-site counters are not compared)."""
    flags = ["--arch", "phi3.5-moe-42b-a6.6b", "--policy", "w4a8_abfp",
             "--compress", "--expert-cache", "2", "--n-requests", "3",
             "--max-new-tokens", "4"]
    assert tserve.main(flags + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    want = _reference_report(flags)
    assert set(got) - set(want) == {"device"} and set(want) <= set(got)
    assert set(got["experts"]) == set(want["experts"])
    for key in ("capacity", "n_experts", "store_bytes", "dense_bytes"):
        assert got["experts"][key] == want["experts"][key], key
    assert got["experts"]["n_sites"] == 2 and got["experts"]["misses"] > 0
    for key in ("arch", "policy", "requests", "generated_tokens",
                "completions", "dense_weight_mb", "resident_weight_mb"):
        assert got[key] == want[key], key


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


def test_expert_precision_auto_serves_a_per_expert_map(capsys):
    """``--expert-precision auto`` on reduced Phi-3.5-MoE: the routing
    probe's hottest quarter of the experts at INT8, the rest at INT4, the
    map served compressed and named as the reference names it."""
    assert tserve.main(["--arch", "phi3.5-moe-42b-a6.6b", "--policy",
                        "w4a8_abfp", "--compress", "--expert-precision",
                        "auto", "--n-requests", "2", "--max-new-tokens", "3",
                        "--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["policy"] == "w4a8_abfp+experts_int8_int4"
    auto = got["expert_precision"]
    assert auto["mode"] == "auto" and len(auto["hot_experts"]) == 1
    assert max(auto["loads"]) == auto["loads"][auto["hot_experts"][0]]
    assert got["experts"]["capacity"] == 0 and got["requests"] == 2


def test_unknown_arch_lists_the_registry():
    with pytest.raises(ValueError, match="known: \\['deit-s16', "
                       "'gemma2-9b', 'granite-3-8b', 'h2o-danube-1.8b', "
                       "'internvl2-2b', 'llama4-scout-17b-a16e', "
                       "'mamba2-130m', 'opt-125m', 'opt-tiny', "
                       "'phi3.5-moe-42b-a6.6b', 'qwen2-7b', 'vit-b16', "
                       "'whisper-large-v3', 'zamba2-7b'\\]"):
        tserve.main(["--paged", "--device", "cpu", "--arch", "gemma3-27b"])
