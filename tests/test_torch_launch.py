"""The port's serving launcher: same report keys as the reference launcher
(checked against a reference run at the same flags), CPU only when asked,
and a clear exit for every flag whose feature is not ported yet."""

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
    ([], "Fixed-slot engine"),
    (["--paged", "--speculate"], "Speculative"),
    (["--paged", "--recipe", "gptq"], "PTQ methods"),
    (["--paged", "--expert-cache", "2"], "MoE serving"),
    (["--paged", "--expert-precision", "auto"], "MoE serving"),
    (["--paged", "--attn-backend", "fused"], "flash_attention"),
])
def test_unported_flags_exit_naming_the_roadmap(flags, needle):
    with pytest.raises(SystemExit) as e:
        tserve.main(flags + ["--device", "cpu"])
    assert "ROADMAP.md" in str(e.value) and needle in str(e.value)


def test_unknown_arch_lists_the_registry():
    with pytest.raises(ValueError, match="known: \\['qwen2-7b'\\]"):
        tserve.main(["--paged", "--device", "cpu", "--arch", "opt-125m"])
