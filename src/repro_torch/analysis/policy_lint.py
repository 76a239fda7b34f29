"""QL0xx: PolicyMap analyses — rule reachability, scan/family
compatibility, KV-cache storage, serving-transform hazards.

The compatibility checks here are the single source of truth for the
runtime validators in ``core.policy`` (``check_scan_compatible``,
``reject_layer_rules``, ``kv_cache_mode``) and
``models.serving_transforms`` (``_check_site_rules_supported``): those
call sites are thin shims raising the exact ``Diagnostic.message`` this
module produces, so lint output and runtime errors never drift apart.
"""

from __future__ import annotations

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.policy import (
    Policy,
    PolicyMap,
    has_layer_rules,
    has_site_rules,
    resolve_policy,
)

# Param-tree top-level keys whose runtime site addresses do NOT follow the
# path-derived naming serving transforms produce (hybrid: 'shared/q' at
# runtime vs 'shared/attn/q' in the tree; encdec: family-level 'attn/...'
# names vs 'encoder/...'/'decoder/...' paths).
NON_CONTRACT_KEYS = ("mamba_groups", "shared", "lora", "encoder", "decoder")

# Model families whose param layout carries those keys — the symbolic
# analogue of checking the tree itself.
NON_CONTRACT_FAMILIES = ("hybrid", "encdec")


# ---------------------------------------------------------------------------
# Shim-backing compatibility checks (message text is the runtime contract)
# ---------------------------------------------------------------------------
def scan_compat_diagnostic(policy: Policy, scan_layers: bool,
                           model_name: str = "") -> Diagnostic | None:
    """QL004 — layer-indexed rules can never match scan-over-layers sites."""
    if not (scan_layers and has_layer_rules(policy)):
        return None
    return Diagnostic(
        code="QL004",
        site="blocks.*",
        message=(
            f"PolicyMap {policy.name!r} has layer-indexed rules "
            f"({[r.pattern for r in policy.rules]}) which need per-layer "
            f"sites: run {model_name or 'the model'} with "
            "cfg.scan_layers=False (the same eager-unrolled constraint "
            "calibration already has)"
        ),
        hint="set cfg.scan_layers=False, or use layer-agnostic patterns "
             "like '*attn*'",
    )


def layer_rules_family_diagnostic(policy: Policy,
                                  model_name: str = "") -> Diagnostic | None:
    """QL005 — layer-indexed rules on a family without per-layer sites."""
    if not has_layer_rules(policy):
        return None
    return Diagnostic(
        code="QL005",
        site="blocks.*",
        message=(
            f"{model_name or 'this model family'} does not thread "
            f"per-layer site names; layer-indexed PolicyMap rules "
            f"({[r.pattern for r in policy.rules]}) are unsupported here — "
            "use pattern rules like '*attn*' / 'mamba*' instead"
        ),
        hint="replace blocks.{i} patterns with family-level ones "
             "('*attn*', 'mamba*', 'shared*')",
    )


def kv_mode_diagnostic(policy: Policy):
    """(mode, QL007-or-None) — the engine-global KV-cache storage mode.

    Cache storage is allocated once for all layers, so a map's rules must
    agree on it (fp32 rules count: storage keys off ``kv_cache`` alone).
    """
    if not isinstance(policy, PolicyMap):
        return policy.kv_cache, None
    modes = {p.kv_cache for p in policy.policies}
    if len(modes) == 1:
        return modes.pop(), None
    diag = Diagnostic(
        code="QL007",
        site="*/attn",
        message=(
            f"PolicyMap {policy.name!r} mixes kv_cache modes {sorted(modes)} "
            "(fp32 rules count: cache storage is structural); KV-cache "
            "storage is engine-global — set it on every entry with "
            "with_kv_cache(policy, mode)"
        ),
        hint="with_kv_cache(policy, mode) sets every entry, disabled "
             "rules included",
    )
    return None, diag


def non_contract_layout_diagnostic(policy: Policy, top_keys,
                                   what: str) -> Diagnostic | None:
    """QL008 — site-rule map over a param layout whose tree paths don't
    match the runtime site addresses (serving transforms would silently
    mis-resolve).  ``top_keys`` is the param tree's top-level key list, or
    None when analyzing symbolically from the model family alone."""
    if not has_site_rules(policy):
        return None
    if top_keys is not None and not any(
            k in top_keys for k in NON_CONTRACT_KEYS):
        return None
    keys_part = (f"(top-level keys {sorted(top_keys)}) "
                 if top_keys is not None else "")
    return Diagnostic(
        code="QL008",
        message=(
            f"{what} with a site-rule PolicyMap supports the "
            "TransformerLM/ViT param layout only: this tree's param paths "
            f"{keys_part}do not match the runtime "
            "site addresses, so per-site rules would silently mis-resolve "
            "— use a flat policy for hybrid/encdec families"
        ),
        hint="serve hybrid/encdec with a flat policy, or skip "
             "--compress/--prequant",
    )


# ---------------------------------------------------------------------------
# Rule-reachability analysis (first-match-wins)
# ---------------------------------------------------------------------------
def rule_reachability(policy: PolicyMap, sites) -> list:
    """Per-rule match accounting over a site universe.

    Returns ``[(rule_index, matched, claimed)]`` where ``matched`` is every
    site the rule's pattern matches and ``claimed`` the subset it actually
    wins (not taken by an earlier rule) — the brute-force semantics of
    first-match-wins, which the property test compares against.
    """
    out = []
    taken: set = set()
    for i, rule in enumerate(policy.rules):
        matched = [s for s in sites if rule.matches(s)]
        claimed = [s for s in matched if s not in taken]
        taken.update(claimed)
        out.append((i, matched, claimed))
    return out


def lint_policy_rules(policy: Policy, sites) -> list:
    """QL001/QL002/QL003 over a site universe."""
    diags: list = []
    if not isinstance(policy, PolicyMap):
        return diags
    reach = rule_reachability(policy, sites)
    for i, matched, claimed in reach:
        rule = policy.rules[i]
        loc = f"rule[{i}]:{rule.pattern}"
        if not matched:
            diags.append(Diagnostic(
                code="QL002",
                site=loc,
                message=(
                    f"rule {i} ({rule.pattern!r} -> "
                    f"{rule.policy.name}) matches none of the "
                    f"{len(sites)} matmul sites of this model"
                ),
                hint="check the pattern against the site contract "
                     "(blocks.{i}/attn/q, blocks.{i}/ffn/wi, "
                     "embed/attend, ...)",
            ))
        elif not claimed:
            winners = sorted({
                policy.rules[j].pattern
                for j, m, c in reach[:i] for s in c if s in matched
            })
            diags.append(Diagnostic(
                code="QL001",
                site=loc,
                message=(
                    f"rule {i} ({rule.pattern!r} -> {rule.policy.name}) is "
                    f"fully shadowed: every site it matches is already "
                    f"claimed by earlier rule(s) {winners} "
                    "(first-match-wins)"
                ),
                hint="move the rule earlier, or delete it",
            ))
    claimed_total = sum(len(c) for _, _, c in reach)
    defaulted = len(sites) - len({s for _, _, c in reach for s in c})
    diags.append(Diagnostic(
        code="QL003",
        message=(
            f"{claimed_total} of {len(sites)} sites match a rule; "
            f"{defaulted} fall through to the default policy "
            f"({policy.default.name})"
        ),
    ))
    return diags


def lint_tied_embed(cfg, policy: Policy, *, compress: bool,
                    prequant: bool) -> list:
    """QL006 — under offline weight transforms the tied readout keeps its
    runtime weight quantizer (the embedding table feeds the lookup too)."""
    if not (compress or prequant):
        return []
    if not getattr(cfg, "tied_embeddings", False):
        return []
    if cfg.family in ("vit",):
        return []
    pol = resolve_policy(policy, "embed/attend")
    if pol.weight is None:
        return []
    return [Diagnostic(
        code="QL006",
        site="embed/attend",
        message=(
            "tied-embedding readout is never transformed offline (the "
            "table feeds the input lookup too); the embed/attend matmul "
            f"keeps its runtime weight quantizer ({pol.weight.fmt_name})"
        ),
        hint="expected: serving_policy() pins an embed/attend keep-rule",
    )]
