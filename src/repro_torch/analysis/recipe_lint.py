"""QL1xx: QuantRecipe pipeline analyses — declaration validity, pass
order, calibration (stale-stats) reachability, site-scope coverage.

All checks are symbolic: they interpret the recipe's declared pass list
against ``PASS_KINDS``'s reads/writes metadata exactly the way
``RecipeEngine`` would sequence it, without touching params or batches.
"""

from __future__ import annotations

import re

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.recipe import PASS_KINDS, QuantRecipe, _outer_needed


def _pass_loc(i: int, spec) -> str:
    return f"pass[{i}]:{spec.kind}"


def lint_recipe_declaration(recipe: QuantRecipe) -> list:
    """QL101/QL102 — the static half of ``QuantRecipe.validate()``.

    Mirrors validate()'s checks one-to-one (same failure set, lint codes
    instead of raises) so a recipe that lints clean never raises
    ``RecipeError`` at declaration time.
    """
    diags: list = []
    if not recipe.passes:
        diags.append(Diagnostic(
            code="QL101",
            message=f"recipe {recipe.name!r} has no passes",
            hint="declare at least one PassSpec",
        ))
        return diags
    qtree_written_by = None
    for i, spec in enumerate(recipe.passes):
        loc = _pass_loc(i, spec)
        kind = PASS_KINDS.get(spec.kind)
        if kind is None:
            diags.append(Diagnostic(
                code="QL101",
                site=loc,
                message=(
                    f"recipe {recipe.name!r}: unknown pass kind "
                    f"{spec.kind!r}; known: {sorted(PASS_KINDS)}"
                ),
                hint="register the pass with @quant_pass, or fix the name",
            ))
            continue
        allowed = {k for k, _ in kind.defaults}
        unknown = set(spec.opts) - allowed
        if unknown:
            diags.append(Diagnostic(
                code="QL101",
                site=loc,
                message=(
                    f"recipe {recipe.name!r}: pass {spec.kind!r} got "
                    f"unknown option(s) {sorted(unknown)}; allowed: "
                    f"{sorted(allowed)}"
                ),
                hint="drop or rename the option",
            ))
        if spec.sites.startswith("re:"):
            try:
                re.compile(spec.sites[3:])
            except re.error as e:
                diags.append(Diagnostic(
                    code="QL101",
                    site=loc,
                    message=(
                        f"recipe {recipe.name!r}: pass {spec.kind!r} has "
                        f"an invalid site regex {spec.sites!r}: {e}"
                    ),
                    hint="fix the regex (matched with re.fullmatch)",
                ))
        if kind.mutates_params and qtree_written_by is not None:
            diags.append(Diagnostic(
                code="QL102",
                site=loc,
                message=(
                    f"recipe {recipe.name!r}: param-mutating pass "
                    f"{spec.kind!r} after q-tree pass "
                    f"{qtree_written_by!r} would silently invalidate the "
                    "static alphas already solved — reorder the recipe so "
                    "weight-mutating passes run before static/rptq passes"
                ),
                hint="move smoothquant/gptq before static/rptq",
            ))
        if "qtree" in kind.writes:
            qtree_written_by = spec.kind
    return diags


def lint_recipe_calibration(recipe: QuantRecipe, *,
                            policy_enabled: bool) -> list:
    """QL103/QL106/QL107 — replay RecipeEngine's freshness tracking.

    Predicts how many calibration passes the engine will insert (a
    param-mutating pass invalidates stats; the next stats consumer forces
    a re-collect) and whether the observation policy can feed them at all.
    """
    diags: list = []
    known = [s for s in recipe.passes if s.kind in PASS_KINDS]
    needs_stats = any(PASS_KINDS[s.kind].needs_stats for s in known)
    if needs_stats and not policy_enabled:
        diags.append(Diagnostic(
            code="QL106",
            message=(
                f"recipe {recipe.name!r} consumes activation statistics "
                "but the evaluation policy is disabled (fp32) — observers "
                "only fire at quantized matmuls, so an explicit enabled "
                "calib_policy is required (the launchers fall back to "
                "preset('w4a8_mse') observers)"
            ),
            hint="pass an enabled policy, or rely on the launcher's "
                 "w4a8_mse observer fallback",
        ))
    # replay the engine: calib starts absent/stale, re-collect on demand
    n_calibrations = 0
    fresh = False
    have_outer = False
    for i, spec in enumerate(recipe.passes):
        kind = PASS_KINDS.get(spec.kind)
        if kind is None:
            continue
        if kind.needs_stats:
            need_outer = "hessian" in kind.reads
            if not fresh or (need_outer and not have_outer):
                n_calibrations += 1
                fresh = True
                have_outer = need_outer or _outer_needed(recipe.passes, i)
        if kind.mutates_params:
            fresh = False
    if n_calibrations:
        diags.append(Diagnostic(
            code="QL103",
            message=(
                f"recipe {recipe.name!r} will run {n_calibrations} "
                "calibration pass(es) (each param-mutating pass "
                "invalidates earlier statistics)"
            ),
        ))
    if any(s.kind == "gptq" for s in known):
        diags.append(Diagnostic(
            code="QL107",
            message=(
                f"recipe {recipe.name!r} quantizes weights offline (gptq): "
                "consumers drop the runtime weight quantizer "
                "(replace_enabled(policy, weight=None)) to avoid "
                "double-quantization noise"
            ),
        ))
    return diags


def lint_recipe_scopes(recipe: QuantRecipe, sites) -> list:
    """QL104/QL105 — pass site scopes vs the model's site universe."""
    diags: list = []
    qtree_claims: dict = {}
    for i, spec in enumerate(recipe.passes):
        kind = PASS_KINDS.get(spec.kind)
        if kind is None:
            continue
        loc = _pass_loc(i, spec)
        matched = [s for s in sites if spec.matches(s)]
        if not matched:
            diags.append(Diagnostic(
                code="QL105",
                site=loc,
                message=(
                    f"pass {spec.kind!r} site scope {spec.sites!r} matches "
                    f"none of the {len(sites)} matmul sites of this model "
                    "— the pass is a no-op here"
                ),
                hint="check the scope against this family's site naming "
                     "(hybrid/encdec use family-level names, no blocks.N)",
            ))
            continue
        if "qtree" in kind.writes:
            for s in matched:
                if s in qtree_claims:
                    j, earlier = qtree_claims[s]
                    diags.append(Diagnostic(
                        code="QL104",
                        site=loc,
                        message=(
                            f"q-tree pass {spec.kind!r} (scope "
                            f"{spec.sites!r}) overlaps pass[{j}] "
                            f"{earlier!r} at {s} (and possibly more "
                            "sites); later passes override earlier "
                            "static alphas leaf-wise"
                        ),
                        hint="scope the passes disjointly if the overlap "
                             "is unintended",
                    ))
                    break
            for s in matched:
                qtree_claims.setdefault(s, (i, spec.kind))
    return diags
