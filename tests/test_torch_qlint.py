"""The port's qlint against the reference's: every test of
``tests/test_qlint.py`` (the dry-run gate's twin is in
``test_torch_dryrun.py``) run on both stacks with the same fixtures, each holding the same
assertions, and the reports of both held equal ``to_dict()`` field for
field (``torch_lint_helpers.same_reports``: QL602's platform reason and
QL101's hint mapped)."""

import contextlib
import fnmatch
import io
import json

import pytest

from torch_lint_helpers import PORT, REF, both


def _brute_force_claims(patterns, sites):
    taken = set()
    claims = []
    for pat in patterns:
        claimed = [s for s in sites if s not in taken
                   and fnmatch.fnmatchcase(s, pat)]
        taken.update(claimed)
        claims.append(claimed)
    return claims


# ----------------------------------------------------------------- registry
def test_registry_rejects_unknown_code():
    for s in (REF, PORT):
        with pytest.raises(ValueError, match="unknown diagnostic code"):
            s.an.Diagnostic(code="QL999", message="nope")


def test_registry_code_groups():
    for s in (REF, PORT):
        for code, spec in s.an.CODES.items():
            assert code.startswith("QL") and len(code) == 5
            assert spec.severity in (s.an.Severity.INFO,
                                     s.an.Severity.WARNING,
                                     s.an.Severity.ERROR)
    # the same codes and severities; only QL303's title names the card's
    # shared memory where the reference's names a TPU core's VMEM
    ref = {c: (int(v.severity), v.title) for c, v in REF.an.CODES.items()}
    port = {c: (int(v.severity), v.title) for c, v in PORT.an.CODES.items()}
    assert ref.pop("QL303")[1].replace("VMEM", "shared memory") == \
        port.pop("QL303")[1]
    assert port == ref


def test_report_severity_partition():
    def body(s):
        r = s.an.Report()
        r.add("QL003", "info msg")
        r.add("QL001", "warn msg")
        r.add("QL004", "err msg")
        assert [d.code for d in r.errors] == ["QL004"]
        assert [d.code for d in r.warnings] == ["QL001"]
        assert [d.code for d in r.infos] == ["QL003"]
        assert not r.ok and r.has("QL001") and not r.has("QL301")
        assert "BLOCKED" in r.render()
        return [r]

    got = both(body)
    assert got[0].render() == body(REF)[0].render()


# ------------------------------------------------- shadowed rules: property
def test_shadowed_rule_detection_hypothesis():
    hypothesis = pytest.importorskip(
        "hypothesis", reason="property test needs hypothesis")
    st = pytest.importorskip("hypothesis.strategies")

    sites = {s: s.site_universe(s.get_config("qwen2-7b").replace(
        n_layers=4)) for s in (REF, PORT)}
    assert sites[PORT] == sites[REF]
    pattern_pool = [
        "*", "*attn*", "*ffn*", "blocks.*", "blocks.0/*", "blocks.1/*",
        "blocks.*/attn/q", "blocks.*/ffn/*", "embed/attend", "lm_head",
        "blocks.2/attn/*", "*/wi", "*/wo", "nomatch/*",
    ]

    @hypothesis.given(st.lists(st.sampled_from(pattern_pool),
                               min_size=1, max_size=6))
    @hypothesis.settings(deadline=None, max_examples=60)
    def check(patterns):
        oracle = _brute_force_claims(patterns, sites[PORT])
        reach = {}
        for s in (REF, PORT):
            pm = s.PolicyMap(rules=tuple((p, s.preset("w8a8_abfp"))
                                         for p in patterns),
                             default=s.preset("w4a4_abfp"))
            reach[s] = s.policy_lint.rule_reachability(pm, sites[s])
            for (i, matched, claimed), expect in zip(reach[s], oracle):
                assert sorted(claimed) == sorted(expect)
                assert (bool(matched) and not claimed) == (
                    bool([x for x in sites[s]
                          if fnmatch.fnmatchcase(x, patterns[i])])
                    and not expect)
        assert reach[PORT] == reach[REF]

    check()


def test_shadowed_rule_fixture():
    def body(s):
        sites = s.site_universe(s.get_config("qwen2-7b"))
        W4, W8 = s.preset("w4a4_abfp"), s.preset("w8a8_abfp")
        pm = s.PolicyMap(rules=(("*", W8), ("blocks.0/attn/q", W4)),
                         default=W4)
        r = s.lint(s.get_config("qwen2-7b"), pm)
        shadowed = [d for d in r.diagnostics if d.code == "QL001"]
        assert len(shadowed) == 1 and "rule 1" in shadowed[0].message
        assert _brute_force_claims(["*", "blocks.0/attn/q"], sites)[1] == []
        return [r]

    both(body)


def test_dead_rule_fixture():
    def body(s):
        pm = s.PolicyMap(rules=(("mamba*", s.preset("w8a8_abfp")),),
                         default=s.preset("w4a4_abfp"))
        r = s.lint(s.get_config("qwen2-7b"), pm)
        assert r.has("QL002") and not r.has("QL001")
        return [r]

    both(body)


# -------------------------------------------------- seeded bad-config fixtures
def test_layer_rules_under_scan_is_ql004():
    def body(s):
        cfg = s.get_config("qwen2-7b")
        pol = s.preset("w4a4_abfp+w8a8_ends", n_layers=cfg.n_layers)
        r = s.lint(cfg, pol, scan_layers=True)
        assert [d.code for d in r.errors] == ["QL004"]
        launch = s.lint_launch(cfg, pol)
        unrolled = s.lint(cfg, pol, scan_layers=False)
        assert launch.ok and unrolled.ok
        return [r, launch, unrolled]

    both(body)


def test_layer_rules_on_hybrid_is_ql005():
    def body(s):
        cfg = s.get_config("zamba2-7b")
        pol = s.preset("w4a4_abfp+w8a8_ends", n_layers=cfg.n_layers)
        r = s.lint(cfg, pol)
        assert "QL005" in [d.code for d in r.errors]
        return [r]

    both(body)


def test_int_overflow_is_ql301():
    def body(s):
        cfg = s.get_config("qwen2-7b").replace(d_ff=262144)
        r = s.lint(cfg, s.preset("w8a8_int8_native", n=262144))
        ql301 = [d for d in r.errors if d.code == "QL301"]
        assert ql301 and "2147483647" in ql301[0].message
        small = s.lint(cfg, s.preset("w8a8_int8_native"))
        assert not small.has("QL301")
        return [r, small]

    both(body)


def test_float_format_under_compress_is_ql201():
    def body(s):
        cfg = s.get_config("qwen2-7b")
        r = s.lint(cfg, s.preset("w8a8_e4m3"), compress=True,
                   shape=s.SHAPES["decode_32k"])
        assert r.has("QL201") and r.has("QL202")
        ok = s.lint(cfg, s.preset("w4a8_abfp"), compress=True,
                    shape=s.SHAPES["decode_32k"])
        assert ok.ok
        return [r, ok]

    both(body)


def test_compress_on_train_shape_is_ql204():
    def body(s):
        r = s.lint(s.get_config("qwen2-7b"), s.preset("w4a8_abfp"),
                   compress=True, shape=s.SHAPES["train_4k"])
        assert "QL204" in [d.code for d in r.errors]
        return [r]

    both(body)


def test_fused_group_mismatch_is_ql302():
    def body(s):
        cfg = s.get_config("qwen2-7b")  # d_model=3584, not a multiple of 96
        flat = s.preset("w4a8_abfp", n=96).replace(fused=True)
        r = s.lint(cfg, flat)
        assert any(d.code == "QL302" for d in r.errors)
        fused = s.lint(cfg, s.preset("w4a8_abfp").replace(fused=True))
        assert not fused.has("QL302")
        # at n = 64 every kernel plans, on either stack: no QL303
        assert not r.has("QL303") and not fused.has("QL303")
        return [r, fused]

    both(body)


def test_mixed_kv_modes_is_ql007():
    def body(s):
        int8_kv = s.preset("w8a8_abfp").replace(kv_cache="int8")
        pm = s.PolicyMap(rules=(("*attn*", int8_kv),),
                         default=s.preset("w4a4_abfp"))
        r = s.lint(s.get_config("qwen2-7b"), pm)
        assert len([d for d in r.errors if d.code == "QL007"]) == 1
        return [r]

    both(body)


def test_attention_blocks_not_tiling_is_ql304():
    def body(s):
        cfg = s.get_config("qwen2-7b").replace(q_block=384)
        r = s.lint(cfg, s.preset("fp32"), shape=s.SHAPES["train_4k"])
        assert "QL304" in [d.code for d in r.errors]
        ok = s.lint(s.get_config("qwen2-7b"), s.preset("fp32"),
                    shape=s.SHAPES["train_4k"])
        assert ok.ok
        return [r, ok]

    both(body)


def test_paged_geometry_diagnostics_ql305_307():
    def body(s):
        out = []
        geo = s.PageGeometry(page_size=8, n_pages=2, max_len=64,
                             prefill_chunk=16)
        r = s.lint(s.get_config("qwen2-7b"), s.preset("fp32"), pages=geo)
        ql305 = [d for d in r.errors if d.code == "QL305"]
        assert len(ql305) == 1
        with pytest.raises(ValueError) as ei:
            s.check_geometry(geo)
        assert str(ei.value) == ql305[0].message
        out.append(r)

        geo = s.PageGeometry(page_size=8, n_pages=16, max_len=64,
                             prefill_chunk=20)
        r = s.lint(s.get_config("qwen2-7b"), s.preset("fp32"), pages=geo)
        ql306 = [d for d in r.errors if d.code == "QL306"]
        assert len(ql306) == 1
        with pytest.raises(ValueError) as ei:
            s.check_geometry(geo)
        assert str(ei.value) == ql306[0].message
        out.append(r)

        geo = s.PageGeometry(page_size=32, n_pages=4, max_len=64,
                             prefill_chunk=32)
        r = s.lint(s.get_config("qwen2-7b"), s.preset("fp32"), pages=geo)
        assert r.ok and r.has("QL307")
        s.check_geometry(geo)
        out.append(r)

        geo = s.PageGeometry(page_size=8, n_pages=32, max_len=64,
                             prefill_chunk=16)
        r = s.lint(s.get_config("qwen2-7b"), s.preset("fp32"), pages=geo)
        assert r.ok and not any(d.code.startswith("QL30")
                                and d.code >= "QL305" for d in r)
        out.append(r)
        return out

    both(body)


def test_preflight_pages_gate():
    text = {}
    for s in (REF, PORT):
        buf = io.StringIO()
        with pytest.raises(SystemExit) as e:
            s.cli.preflight(s.get_config("qwen2-7b"), s.preset("fp32"),
                            pages=s.PageGeometry(page_size=8, n_pages=2,
                                                 max_len=64,
                                                 prefill_chunk=16),
                            out=buf)
        assert e.value.code == 2 and "QL305" in buf.getvalue()
        text[s] = buf.getvalue()
    assert text[PORT] == text[REF]


def test_unknown_recipe_is_ql101():
    def body(s):
        r = s.lint(s.get_config("qwen2-7b"), s.preset("w4a8_mse"),
                   "no_such_recipe")
        assert "QL101" in [d.code for d in r.errors]
        return [r]

    both(body)


# ------------------------------------------------- validator-shim equivalence
def test_scan_shim_message_matches_diagnostic():
    msgs = []
    for s in (REF, PORT):
        pol = s.preset("w4a4_abfp+w8a8_ends", n_layers=4)
        d = s.policy_lint.scan_compat_diagnostic(pol, True, "m")
        with pytest.raises(ValueError, match="scan_layers") as ei:
            s.policy.check_scan_compatible(pol, True, "m")
        assert str(ei.value) == d.message
        msgs.append(d.message)
    assert msgs[0] == msgs[1]


def test_family_shim_message_matches_diagnostic():
    msgs = []
    for s in (REF, PORT):
        pol = s.preset("w4a4_abfp+w8a8_ends", n_layers=4)
        d = s.policy_lint.layer_rules_family_diagnostic(pol, "m")
        with pytest.raises(NotImplementedError,
                           match="per-layer site") as ei:
            s.policy.reject_layer_rules(pol, "m")
        assert str(ei.value) == d.message
        msgs.append(d.message)
    assert msgs[0] == msgs[1]


def test_kv_shim_message_matches_diagnostic():
    msgs = []
    for s in (REF, PORT):
        W4, W8 = s.preset("w4a4_abfp"), s.preset("w8a8_abfp")
        pm = s.PolicyMap(rules=(("*attn*", W8.replace(kv_cache="int8")),),
                         default=W4)
        _mode, d = s.policy_lint.kv_mode_diagnostic(pm)
        with pytest.raises(ValueError, match="kv_cache") as ei:
            s.policy.kv_cache_mode(pm)
        assert str(ei.value) == d.message
        assert s.policy.kv_cache_mode(
            s.PolicyMap(rules=(("*attn*", W8),), default=W4)) == "requant"
        assert s.policy.kv_cache_mode(s.policy.NONE) == "requant"
        msgs.append(d.message)
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------- gates + CLI
def _cli(s, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = s.cli.main(argv)
    return rc, out.getvalue()


def test_cli_exit_codes():
    outs = {}
    for s in (REF, PORT):
        rc, ok = _cli(s, ["--arch", "qwen2-7b", "--policy", "w4a8_abfp"])
        assert rc == 0 and "OK" in ok
        rc, bad = _cli(s, ["--arch", "qwen2-7b", "--policy", "w4a8_abfp",
                           "--shape", "train_4k", "--compress"])
        assert rc == 1 and "QL204" in bad and "BLOCKED" in bad
        outs[s] = (ok, bad)
    assert outs[PORT] == outs[REF]


def test_cli_json_output():
    payloads = {}
    for s in (REF, PORT):
        rc, out = _cli(s, ["--arch", "zamba2-7b", "--recipe", "gptq",
                           "--json"])
        payload = json.loads(out)
        assert rc == 0 and payload["ok"] is True
        assert payload["context"]["recipe"] == "gptq"
        payloads[s] = payload
    assert payloads[PORT] == payloads[REF]


def test_preflight_blocks_and_passes():
    text = {}
    for s in (REF, PORT):
        cfg = s.get_config("qwen2-7b")
        buf = io.StringIO()
        with pytest.raises(SystemExit):
            s.cli.preflight(cfg, s.preset("w4a8_abfp"),
                            shape=s.SHAPES["train_4k"], compress=True,
                            out=buf)
        assert "QL204" in buf.getvalue()
        s.cli.preflight(cfg, s.preset("w4a8_abfp"), out=buf)  # no raise
        text[s] = buf.getvalue()
    assert text[PORT] == text[REF]


# ------------------------------------------------------ QL5xx: MoE experts
def test_ql502_expert_rules_on_dense_config():
    def body(s):
        W4, W8 = s.preset("w4a4_abfp"), s.preset("w8a8_abfp")
        pm = s.PolicyMap(name="exp", rules=(
            s.PolicyRule("*/experts.0", W8.replace(name="hot")),
            s.PolicyRule("*/experts.*", W4.replace(name="cold")),
        ), default=W4)
        r = s.lint(s.get_config("qwen2-7b").reduced(), pm)
        assert any(d.code == "QL502" for d in r.errors)
        return [r]

    both(body)


def test_expert_rules_on_moe_config_are_reachable():
    def body(s):
        cfg = s.get_config("phi3.5-moe-42b-a6.6b").reduced()
        pm = s.expert_precision_map(s.preset("w4a8_abfp"), [0])
        r = s.lint(cfg, pm)
        assert not r.has("QL502")
        assert not [d for d in r.warnings if d.code == "QL002"
                    and "experts" in d.message]
        return [r]

    both(body)


def test_ql503_precision_inversion():
    def body(s):
        cfg = s.get_config("phi3.5-moe-42b-a6.6b").reduced()
        base = s.preset("w4a8_abfp")
        inverted = s.expert_precision_map(base, [0], hot_fmt="int4",
                                          cold_fmt="int8")
        r = s.lint(cfg, inverted, experts={"hot_experts": [0]})
        ql503 = [d for d in r.warnings if d.code == "QL503"]
        assert ql503 and r.ok
        assert "LESS precision" in ql503[0].message
        good = s.expert_precision_map(base, [0])
        r2 = s.lint(cfg, good, experts={"hot_experts": [0]})
        assert not r2.has("QL503")
        return [r, r2]

    both(body)


# ------------------------------------------------- shipped grid lints clean
def test_registered_grid_lints_clean():
    """Every shipped config x preset x recipe combination lints without an
    error on the port (the CI gate's invariant).  The reference's side of
    this grid is ``test_qlint.py``'s, and ``test_torch_lint_sweep.py``
    holds every one of these reports to the reference's."""
    failures = []
    for arch, pname, rname, action, _reason in PORT.cli.sweep_combos():
        if action == "skip":
            continue
        cfg = PORT.get_config(arch)
        report = PORT.lint_launch(
            cfg, PORT.preset(pname, n_layers=cfg.n_layers), rname)
        if not report.ok:
            failures.append((arch, pname, rname, report.codes()))
    assert not failures, failures
