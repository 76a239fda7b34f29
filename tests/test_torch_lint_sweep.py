"""The ``--all`` grid of both analyzers, arch by arch: every (preset,
recipe) combination the port's ``sweep_combos`` yields is the
reference's, skips and their reasons included, and the port's
``lint_launch`` report of each equals the reference's ``to_dict()`` field
for field (QL602's platform reason and QL101's hint mapped; QL303 taken
out of both, since the port's follows the Hopper kernels' plans — no
shipped preset is fused, so it fires on neither side here).  The counts of
each arch are pinned, and they sum to the sweep's summary: 2,252
combinations, 2 skipped, 0 errors, 252 warnings."""

import pytest

from torch_lint_helpers import PORT, REF, port_view, without

# arch: (combinations, skipped, errors, warnings) of the --all sweep
COUNTS = {
    "deit-s16": (162, 0, 0, 8),
    "gemma2-9b": (162, 0, 0, 8),
    "granite-3-8b": (162, 0, 0, 8),
    "h2o-danube-1.8b": (162, 0, 0, 8),
    "internvl2-2b": (162, 0, 0, 8),
    "llama4-scout-17b-a16e": (162, 0, 0, 8),
    "mamba2-130m": (162, 0, 0, 62),
    "opt-125m": (162, 0, 0, 8),
    "opt-tiny": (162, 0, 0, 8),
    "phi3.5-moe-42b-a6.6b": (162, 0, 0, 8),
    "qwen2-7b": (162, 0, 0, 8),
    "vit-b16": (162, 0, 0, 8),
    "whisper-large-v3": (154, 1, 0, 42),
    "zamba2-7b": (154, 1, 0, 60),
}


def test_the_counts_sum_to_the_sweep_summary():
    assert sorted(COUNTS) == PORT.list_configs() == REF.list_configs()
    total = [sum(c[i] for c in COUNTS.values()) for i in range(4)]
    assert total == [2252, 2, 0, 252]


def _rows(s, arch):
    """The sweep's rows of one arch: ("skip", reason) or the report of
    ``lint_launch`` as ``run_sweep`` makes it."""
    rows = []
    for a, pname, rname, action, reason in s.cli.sweep_combos():
        if a != arch:
            continue
        if action == "skip":
            rows.append(((pname, rname), ("skip", reason)))
            continue
        cfg = s.get_config(arch)
        report = s.lint_launch(cfg, s.preset(pname, n_layers=cfg.n_layers),
                               rname)
        rows.append(((pname, rname), report.to_dict()))
    return rows


@pytest.mark.parametrize("arch", sorted(COUNTS))
def test_every_report_is_the_references(arch):
    want, got = _rows(REF, arch), _rows(PORT, arch)
    assert [k for k, _ in got] == [k for k, _ in want]
    n_skip = n_err = n_warn = 0
    for (key, g), (_, w) in zip(got, want):
        if isinstance(w, tuple):
            assert g == w, key
            n_skip += 1
            continue
        assert not [d for d in g["diagnostics"] if d["code"] == "QL303"]
        assert without(g, "QL303") == without(port_view(w), "QL303"), key
        n_err += g["counts"]["error"]
        n_warn += g["counts"]["warning"]
    assert (len(got), n_skip, n_err, n_warn) == COUNTS[arch]
