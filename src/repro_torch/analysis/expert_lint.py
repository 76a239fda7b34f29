"""QL5xx: MoE expert-serving configuration checks.

The expert store/cache (``serve.experts``) has failure modes a single
policy lint cannot see: per-expert rules pointed at a dense model never
resolve (QL502, mirrored as constructor errors in ``ExpertStore`` and the
engines' ``expert_cache`` argument with the same message text), a cache
at least as large as the expert count makes the compressed backing store
pure overhead (QL501), and a precision assignment that gives the
most-routed experts FEWER weight bits than the cold ones (QL503, via the
roofline's per-expert bit report) inverts the whole point of
frequency-driven precision.
"""

from __future__ import annotations

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.messages import (
    expert_cache_capacity_message, expert_non_moe_message,
    expert_precision_inversion_message)
from repro_torch.core.policy import has_expert_rules


def _is_moe(cfg) -> bool:
    return (getattr(cfg, "family", "") == "moe"
            and getattr(cfg, "n_experts", 0) > 0)


def lint_experts(cfg, policy, experts=None) -> list[Diagnostic]:
    """Analyze expert-serving config against the arch + policy.

    ``experts`` is duck-typed (the launcher passes a dict): recognised
    entries/attributes are ``cache_capacity`` (int) and ``hot_experts``
    (list of indices — the routing-frequency hot set, when known).
    """
    get = ((experts.get if isinstance(experts, dict)
            else lambda k, d=None: getattr(experts, k, d))
           if experts is not None else lambda k, d=None: d)
    out: list[Diagnostic] = []
    moe = _is_moe(cfg)

    # --- QL502: per-expert machinery on a dense model ------------------------
    if has_expert_rules(policy) and not moe:
        out.append(Diagnostic(
            "QL502",
            expert_non_moe_message("per-expert policy rules",
                                   getattr(cfg, "name", "?")),
            hint="drop the */experts.{e} rules or serve an MoE arch "
                 "(phi3.5-moe / llama4-scout)"))
    if experts is not None and not moe:
        out.append(Diagnostic(
            "QL502",
            expert_non_moe_message("an expert cache",
                                   getattr(cfg, "name", "?")),
            hint="--expert-cache / --expert-precision only apply to MoE "
                 "configs"))
        return out

    # --- QL501: cache swallows the whole expert population -------------------
    cap = get("cache_capacity")
    if cap is not None and moe and int(cap) >= cfg.n_experts:
        out.append(Diagnostic(
            "QL501",
            expert_cache_capacity_message(int(cap), cfg.n_experts),
            hint="an LRU that never evicts is dense-resident serving with "
                 "extra bookkeeping; E//4 is the useful starting point"))

    # --- QL503: hot experts below cold experts (via roofline bits) -----------
    hot = get("hot_experts")
    if hot and moe and has_expert_rules(policy):
        try:
            from repro_torch.launch.roofline import policy_bits_report

            rep = policy_bits_report(cfg, policy)
        except Exception:
            return out  # symbolic bit accounting unavailable
        hot_set = {int(e) for e in hot}
        bits: dict[bool, list[float]] = {True: [], False: []}
        for s in rep["sites"]:
            site = s["site"]
            if "/experts." not in site:
                continue
            e = int(site.rsplit("experts.", 1)[1])
            bits[e in hot_set].append(float(s["w_bits"]))
        if bits[True] and bits[False]:
            hot_b = sum(bits[True]) / len(bits[True])
            cold_b = sum(bits[False]) / len(bits[False])
            if hot_b < cold_b:
                out.append(Diagnostic(
                    "QL503",
                    expert_precision_inversion_message(hot_b, cold_b),
                    hint="assign_expert_precision(loads, base) emits the "
                         "non-inverted map from routing counters"))
    return out
