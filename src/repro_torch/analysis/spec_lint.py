"""QL4xx: speculative-serving configuration checks.

The draft/target pair has failure modes no single-policy lint can see:
the two sides must agree on KV storage (QL401), quantized pages cannot
roll back (QL403), the draft depth must be sane (QL404) — all mirrored
as constructor errors in ``serve.speculative`` with the same message
text — and a draft that is not actually cheaper than its target (QL402)
speculates for nothing.
"""

from __future__ import annotations

from repro_torch.analysis import policy_lint
from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.messages import (spec_draft_k_message,
                                           spec_kv_mismatch_message,
                                           spec_quantized_pages_message)


def lint_speculative(cfg, target_policy, speculative, *,
                     paged: bool = False,
                     max_len: int | None = None) -> list[Diagnostic]:
    """Analyze a draft/target speculative pair.

    ``speculative`` is duck-typed (the launcher passes a dict): needs
    ``draft_policy`` and ``draft_k`` entries/attributes.
    """
    get = (speculative.get if isinstance(speculative, dict)
           else lambda k, d=None: getattr(speculative, k, d))
    draft_policy = get("draft_policy")
    draft_k = get("draft_k", 4)
    out: list[Diagnostic] = []

    # --- QL404: draft depth --------------------------------------------------
    cap = max_len if max_len is not None else 1 << 30
    if not (1 <= int(draft_k) < cap):
        out.append(Diagnostic(
            "QL404",
            spec_draft_k_message(int(draft_k), cap),
            hint="serve with 1 <= draft_k < max_len (2-8 is the useful "
                 "range; acceptance decays with depth)"))

    if draft_policy is None:
        return out

    # --- QL401: kv_cache storage agreement -----------------------------------
    dmode, ddiag = policy_lint.kv_mode_diagnostic(draft_policy)
    tmode, _tdiag = policy_lint.kv_mode_diagnostic(target_policy)
    if ddiag is not None:
        # heterogeneous draft map: surface its own QL007 under a draft
        # prefix (the main lint only sees the target policy)
        out.append(Diagnostic(ddiag.code, f"draft policy: {ddiag.message}",
                              site="draft", hint=ddiag.hint))
    if dmode is not None and tmode is not None and dmode != tmode:
        out.append(Diagnostic(
            "QL401",
            spec_kv_mismatch_message(dmode, tmode),
            hint="with_kv_cache(draft_policy, mode) aligns every rule; "
                 "drafts proposed against a different-fidelity context "
                 "tank the acceptance rate"))

    # --- QL403: quantized pages cannot roll back -----------------------------
    if paged and tmode in ("int8", "fp8"):
        out.append(Diagnostic(
            "QL403",
            spec_quantized_pages_message(tmode),
            hint="serve speculative paged with fp pages, or use the "
                 "fixed-slot engine (per-token int8 ring cache rolls "
                 "back exactly)"))

    # --- QL402: draft not cheaper than target (waste advisory) ---------------
    try:
        from repro_torch.launch.roofline import policy_bits_report

        dbits = policy_bits_report(cfg, draft_policy)["mean_weight_bits"]
        tbits = policy_bits_report(cfg, target_policy)["mean_weight_bits"]
    except Exception:
        return out  # symbolic bit accounting unavailable for this family
    if dbits >= tbits:
        out.append(Diagnostic(
            "QL402",
            f"speculative draft weights average {dbits:.1f} bits vs the "
            f"target's {tbits:.1f} — the draft is not cheaper than what "
            "it accelerates",
            hint="pick a lower-precision draft preset (e.g. w4a8_abfp "
                 "under an fp32/w8a8 target); equal-width drafting pays "
                 "two full models per token"))
    return out
