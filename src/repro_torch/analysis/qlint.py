"""qlint orchestrator: analyze one (config, policy, recipe, flags) tuple.

``lint()`` is the whole-pipeline entry point the CLI
(``python -m repro_torch.launch.lint``) and the launchers' pre-flight gates
call.
Everything is symbolic — the site universe comes from
``roofline.enumerate_matmul_sites``, never from built params — so linting
a 42B config costs milliseconds and allocates nothing on the card.
"""

from __future__ import annotations

from repro_torch.analysis import (backend_lint, kernel_lint, policy_lint,
                                  recipe_lint)
from repro_torch.analysis.diagnostics import Report
from repro_torch.core.policy import Policy, has_expert_rules, has_layer_rules
from repro_torch.launch.roofline import enumerate_matmul_sites


def site_universe(cfg) -> list:
    """All policy-resolution site addresses of a model config.

    The matmul sites from ``enumerate_matmul_sites`` plus the derived
    attention-block sites (``blocks.3/attn``, ``shared``, ``attn``) the
    attention layers resolve BMM/KV policies at — rules targeting those
    parents are reachable and must not lint as dead.
    """
    sites = [s for s, _K, _N, _m in enumerate_matmul_sites(cfg)]
    extra = []
    for s in sites:
        parent = None
        if s.endswith("/q"):
            parent = s[: -len("/q")]
        elif "/experts." in s:
            # MoE blocks resolve activation policies at the block site
            # (blocks.3/ffn); per-expert rows only carry the weights
            parent = s.rsplit("/experts.", 1)[0]
        if parent and parent not in sites and parent not in extra:
            extra.append(parent)
    return sites + extra


def lint(cfg, policy: Policy, recipe=None, *, shape=None,
         compress: bool = False, prequant: bool = False,
         scan_layers: bool | None = None, model_name: str = "",
         pages=None, speculative=None, experts=None, attn=None) -> Report:
    """Statically analyze a full launch tuple; returns a ``Report``.

    ``scan_layers`` defaults to the config's own setting; launchers that
    auto-unroll for layer rules pass their *final* value so QL004 reflects
    what will actually run.  ``recipe`` is a QuantRecipe/name/None.
    ``pages`` is a ``serve.kv_pages.PageGeometry`` when linting a paged
    serving launch (QL305-QL307), else None.  ``speculative`` is a dict
    (or duck-typed object) with ``draft_policy``/``draft_k`` when linting
    a speculative serving launch (QL4xx), else None — ``policy`` is then
    the TARGET side.  ``experts`` is a dict (or duck-typed object) with
    ``cache_capacity``/``hot_experts`` when linting expert-resident MoE
    serving (QL5xx); per-expert policy rules are checked even without it.
    ``attn`` is a dict with ``engine`` ('fixed'/'paged') and optional
    ``kv`` (the paged engine's resolved page storage) when linting a
    serving launch's attention-backend dispatch (QL6xx) — the QL6xx
    checks also run without it whenever the policy requests a non-auto
    attention backend.
    """
    ctx = {
        "arch": getattr(cfg, "name", "?"),
        "policy": getattr(policy, "name", "?"),
        "recipe": getattr(recipe, "name", recipe) if recipe else None,
        "shape": getattr(shape, "name", None),
        "compress": compress,
        "prequant": prequant,
        "paged": pages is not None,
        "speculative": speculative is not None,
    }
    report = Report(context=ctx)
    mat_sites = enumerate_matmul_sites(cfg)
    sites = site_universe(cfg)
    scan = cfg.scan_layers if scan_layers is None else scan_layers
    name = model_name or getattr(cfg, "name", "")

    # --- QL0xx: policy ------------------------------------------------------
    if cfg.family in policy_lint.NON_CONTRACT_FAMILIES:
        d = policy_lint.layer_rules_family_diagnostic(policy, name)
        if d:
            report.diagnostics.append(d)
        if compress or prequant:
            what = "compress_weights" if compress else "prequantize_weights"
            d = policy_lint.non_contract_layout_diagnostic(policy, None, what)
            if d:
                report.diagnostics.append(d)
    else:
        d = policy_lint.scan_compat_diagnostic(policy, scan, name)
        if d:
            report.diagnostics.append(d)
    report.extend(policy_lint.lint_policy_rules(policy, sites))
    _mode, d = policy_lint.kv_mode_diagnostic(policy)
    if d:
        report.diagnostics.append(d)
    report.extend(policy_lint.lint_tied_embed(
        cfg, policy, compress=compress, prequant=prequant))

    # --- QL1xx: recipe ------------------------------------------------------
    if recipe is not None:
        from repro_torch.core.recipe import as_recipe

        try:
            rec = as_recipe(recipe)
        except Exception as e:  # unknown name / malformed dict
            report.add("QL101", f"cannot resolve recipe {recipe!r}: {e}",
                       hint="see repro_torch.core.recipe.recipe_names()")
            rec = None
        if rec is not None:
            report.context["recipe"] = rec.name
            report.extend(recipe_lint.lint_recipe_declaration(rec))
            report.extend(recipe_lint.lint_recipe_calibration(
                rec, policy_enabled=getattr(policy, "enabled", False)))
            report.extend(recipe_lint.lint_recipe_scopes(rec, sites))

    # --- QL2xx: backend / representation -----------------------------------
    report.extend(backend_lint.lint_backend(
        cfg, policy, mat_sites, compress=compress, shape=shape))

    # --- QL3xx: kernel / launch ---------------------------------------------
    report.extend(kernel_lint.lint_kernels(
        cfg, policy, mat_sites, compress=compress, shape=shape))
    if pages is not None:
        report.extend(kernel_lint.lint_pages(pages))

    # --- QL4xx: speculative serving -----------------------------------------
    if speculative is not None:
        from repro_torch.analysis import spec_lint

        report.extend(spec_lint.lint_speculative(
            cfg, policy, speculative, paged=pages is not None,
            max_len=getattr(pages, "max_len", None)))

    # --- QL5xx: MoE expert serving ------------------------------------------
    if experts is not None or has_expert_rules(policy):
        from repro_torch.analysis import expert_lint

        report.context["experts"] = experts is not None
        report.extend(expert_lint.lint_experts(cfg, policy, experts))

    # --- QL6xx: attention backend -------------------------------------------
    from repro_torch.core.policy import policies_of

    backend_requested = any(
        getattr(p, "attn_backend", "auto") != "auto"
        for p in policies_of(policy))
    if attn is not None or backend_requested:
        from repro_torch.analysis import attn_lint

        if backend_requested:
            report.context["attn_backend"] = sorted(
                {getattr(p, "attn_backend", "auto")
                 for p in policies_of(policy)})
        report.extend(attn_lint.lint_attention(cfg, policy, attn))
    return report


def lint_launch(cfg, policy: Policy, recipe=None, **kw) -> Report:
    """Launcher-gate variant: lints with the launcher's own scan-unroll
    fallback applied (layer rules force eager unrolling before launch, so
    QL004 is reported only if the caller did NOT apply that fallback)."""
    if has_layer_rules(policy) and kw.get("scan_layers") is None:
        kw["scan_layers"] = False
    return lint(cfg, policy, recipe, **kw)
