"""Both stacks' static analyzers side by side, for the qlint parity tests.

``REF`` and ``PORT`` bundle each package's analyzer, configs, policies,
page geometry, expert maps and lint CLI under the same names, so one test
body runs on either.  ``same_reports`` holds the port's reports to the
reference's, ``to_dict()`` field for field, after ``port_view`` maps the
two texts that name their platform or package: QL602's platform reason and
QL101's hint.
"""

from types import SimpleNamespace

import repro.analysis as j_an
import repro.analysis.kernel_lint as j_kl
import repro.analysis.policy_lint as j_pl
import repro.analysis.qlint as j_ql
import repro.configs as j_cfg
import repro.core.policy as j_pol
import repro.launch.lint as j_cli
import repro.launch.roofline as j_rf
import repro.serve.experts as j_exp
import repro.serve.kv_pages as j_pages
import repro_torch.analysis as t_an
import repro_torch.analysis.kernel_lint as t_kl
import repro_torch.analysis.policy_lint as t_pl
import repro_torch.analysis.qlint as t_ql
import repro_torch.configs as t_cfg
import repro_torch.core.policy as t_pol
import repro_torch.launch.lint as t_cli
import repro_torch.launch.roofline as t_rf
import repro_torch.serve.experts as t_exp
import repro_torch.serve.kv_pages as t_pages


class Stack(SimpleNamespace):
    """One package's analyzer surface (hashable: tests key results by
    stack)."""

    __hash__ = object.__hash__


def _stack(an, kl, pl, ql, cfg, pol, cli, rf, exp, pages):
    return Stack(
        an=an, kernel_lint=kl, policy_lint=pl, qlint=ql, lint=ql.lint,
        lint_launch=ql.lint_launch, site_universe=ql.site_universe,
        get_config=cfg.get_config, list_configs=cfg.list_configs,
        SHAPES=cfg.SHAPES, policy=pol,
        preset=pol.preset, PolicyMap=pol.PolicyMap,
        PolicyRule=pol.PolicyRule, cli=cli, roofline=rf,
        expert_precision_map=exp.expert_precision_map,
        PageGeometry=pages.PageGeometry, check_geometry=pages.check_geometry)


REF = _stack(j_an, j_kl, j_pl, j_ql, j_cfg, j_pol, j_cli, j_rf, j_exp,
             j_pages)
PORT = _stack(t_an, t_kl, t_pl, t_ql, t_cfg, t_pol, t_cli, t_rf, t_exp,
              t_pages)

# the texts that differ by design: the platform QL602 names, and the
# package QL101's hint points into
_TEXTS = (
    ("no TPU present — kernel bodies run under the Pallas interpreter "
     "(correct but reference-speed)",
     "no CUDA device present — kernel wrappers run their plain PyTorch "
     "versions (correct but reference-speed)"),
    ("see repro.core.recipe.recipe_names()",
     "see repro_torch.core.recipe.recipe_names()"),
)


def port_view(d: dict) -> dict:
    """A reference report's ``to_dict()`` in the port's words."""
    out = dict(d, diagnostics=[])
    for diag in d["diagnostics"]:
        diag = dict(diag)
        for key in ("message", "hint"):
            for ref, port in _TEXTS:
                diag[key] = diag[key].replace(ref, port)
        out["diagnostics"].append(diag)
    return out


def without(d: dict, code: str) -> dict:
    """A report's dict with one code's findings and counts taken out."""
    drop = [x for x in d["diagnostics"] if x["code"] == code]
    counts = dict(d["counts"])
    for x in drop:
        counts[x["severity"]] -= 1
    return dict(d, counts=counts, diagnostics=[
        x for x in d["diagnostics"] if x["code"] != code])


def same_reports(got, want) -> None:
    """The port's reports (``got``) equal the reference's, report for
    report and field for field."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.to_dict() == port_view(w.to_dict())


def both(body):
    """Run ``body(stack)`` on the reference and on the port; each returns
    its reports (a list), which must agree.  Returns the port's."""
    want = body(REF)
    got = body(PORT)
    same_reports(got, want)
    return got
