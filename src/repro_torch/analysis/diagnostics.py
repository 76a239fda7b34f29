"""qlint diagnostic registry: coded, typed findings with site addresses.

Every check the static analyzer runs emits ``Diagnostic`` instances whose
``code`` is drawn from the registry below.  Codes are stable identifiers
(the reference package's registry, code for code) grouped by subsystem:

  ``QL0xx``  policy / PolicyMap        (rule reachability, scan/family
                                        compatibility, KV-cache storage)
  ``QL1xx``  recipe / pass pipeline    (pass order, stale-stats
                                        reachability, site-scope overlap)
  ``QL2xx``  backend / representation  (compressed storage vs format
                                        legality, packing, backend fallback)
  ``QL3xx``  kernel / launch           (int32 accumulator bounds, block
                                        divisibility, the Hopper kernels'
                                        shared-memory plans)
  ``QL4xx``  speculative serving       (draft/target storage agreement,
                                        draft depth/width sanity)
  ``QL5xx``  MoE expert serving        (cache sizing, per-expert rules,
                                        precision assignment)
  ``QL6xx``  attention backend         (compressed-domain dispatch vs KV
                                        storage, silent kernel fallback)

Severity semantics mirror the pre-flight gate: ``error`` means the launch
would raise or silently mis-serve (the gate refuses to run), ``warning``
means the configuration is legal but almost certainly not what was meant
(logged, not fatal), ``info`` is advisory accounting.

This module imports nothing of the package, so the runtime shims in
``core.policy`` / kernels can share its message text without import
cycles or weight.
"""

from __future__ import annotations

import dataclasses
import enum


class Severity(enum.IntEnum):
    """Ordered so ``max(severities)`` is the report's worst finding."""

    INFO = 0
    WARNING = 1
    ERROR = 2

    def __str__(self) -> str:  # 'error', not 'Severity.ERROR'
        return self.name.lower()


@dataclasses.dataclass(frozen=True)
class CodeSpec:
    """One registered diagnostic code: identity, default severity, title."""

    code: str
    severity: Severity
    title: str


# The one registry.  Adding a code here is the only way to emit it —
# ``Diagnostic`` refuses unknown codes, so docs and analyzer can't drift.
CODES: dict[str, CodeSpec] = {}


def _register(code: str, severity: Severity, title: str) -> None:
    if code in CODES:
        raise ValueError(f"duplicate diagnostic code {code!r}")
    CODES[code] = CodeSpec(code, severity, title)


# --- QL0xx: policy / PolicyMap ---------------------------------------------
_register("QL001", Severity.WARNING, "shadowed PolicyMap rule")
_register("QL002", Severity.WARNING, "PolicyMap rule matches no site")
_register("QL003", Severity.INFO, "site coverage report")
_register("QL004", Severity.ERROR, "layer-indexed rules under scan-over-layers")
_register("QL005", Severity.ERROR, "layer-indexed rules on a family without "
                                   "per-layer sites")
_register("QL006", Severity.INFO, "tied-embedding readout keeps its runtime "
                                  "weight quantizer")
_register("QL007", Severity.ERROR, "heterogeneous kv_cache storage modes")
_register("QL008", Severity.ERROR, "site-rule map on a param layout whose "
                                   "paths don't match runtime sites")

# --- QL1xx: recipe / pass pipeline -----------------------------------------
_register("QL101", Severity.ERROR, "invalid recipe declaration")
_register("QL102", Severity.ERROR, "param-mutating pass after a q-tree pass")
_register("QL103", Severity.INFO, "re-calibration reachability")
_register("QL104", Severity.WARNING, "q-tree passes overlap in site scope")
_register("QL105", Severity.WARNING, "pass site scope matches no site")
_register("QL106", Severity.WARNING, "stats-consuming recipe under a "
                                     "disabled observation policy")
_register("QL107", Severity.INFO, "offline-quantized weights drop the "
                                  "runtime weight quantizer")

# --- QL2xx: backend / weight representation --------------------------------
_register("QL201", Severity.WARNING, "float-format weight rule under "
                                     "compressed storage stays dense")
_register("QL202", Severity.WARNING, "compression requested but no site "
                                     "stores integer codes")
_register("QL203", Severity.WARNING, "INT4 codes cannot pack two-per-byte")
_register("QL204", Severity.ERROR, "compressed storage on a training shape")
_register("QL205", Severity.WARNING, "int-format weight rule with a "
                                     "non-compressible scaler stays dense")
_register("QL206", Severity.ERROR, "fused backend without both quantizers")
_register("QL207", Severity.WARNING, "int8 compute requested but policy is "
                                     "not int8-native eligible")

# --- QL3xx: kernel / launch feasibility ------------------------------------
_register("QL301", Severity.ERROR, "int32 accumulator overflow bound "
                                   "exceeded")
_register("QL302", Severity.ERROR, "contraction dim does not tile by the "
                                   "ABFP group length")
_register("QL303", Severity.WARNING, "estimated kernel shared memory "
                                     "footprint exceeds budget")
_register("QL304", Severity.ERROR, "attention sequence does not tile by "
                                   "the attention blocks")
_register("QL305", Severity.ERROR, "paged KV pool cannot admit a maximal "
                                   "request")
_register("QL306", Severity.ERROR, "prefill chunk does not tile by the KV "
                                   "page size")
_register("QL307", Severity.WARNING, "coarse KV pages waste reserved "
                                     "capacity")

# --- QL4xx: speculative serving --------------------------------------------
_register("QL401", Severity.ERROR, "speculative draft/target kv_cache "
                                   "storage modes differ")
_register("QL402", Severity.WARNING, "speculative draft weights at least "
                                     "as wide as the target's")
_register("QL403", Severity.ERROR, "quantized KV pages under paged "
                                   "speculative serving")
_register("QL404", Severity.ERROR, "speculative draft depth out of range")

# --- QL5xx: MoE expert serving ---------------------------------------------
_register("QL501", Severity.WARNING, "expert cache at least as large as "
                                     "the expert count")
_register("QL502", Severity.ERROR, "per-expert rules on a non-MoE config")
_register("QL503", Severity.WARNING, "hot-expert precision below "
                                     "cold-expert precision")

# --- QL6xx: attention backend ----------------------------------------------
_register("QL601", Severity.ERROR, "compressed attention backend over "
                                   "dense fp KV storage")
_register("QL602", Severity.WARNING, "requested attention kernel silently "
                                     "degrades to a reference-speed path")
_register("QL603", Severity.ERROR, "fp8 KV storage on the fixed-slot "
                                   "engine")


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding: a registered code anchored at a site address.

    ``site`` is a matmul/attention site address (``blocks.3/ffn/wi``), a
    rule/pass locator (``rule[2]``, ``pass[1]:gptq``), or ``""`` for
    whole-config findings.  ``hint`` is the fix suggestion shown under the
    message in human output.
    """

    code: str
    message: str
    site: str = ""
    hint: str = ""

    def __post_init__(self):
        if self.code not in CODES:
            raise ValueError(
                f"unknown diagnostic code {self.code!r}; register it in "
                "repro_torch.analysis.diagnostics.CODES"
            )

    @property
    def severity(self) -> Severity:
        return CODES[self.code].severity

    @property
    def title(self) -> str:
        return CODES[self.code].title

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "severity": str(self.severity),
            "title": self.title,
            "site": self.site,
            "message": self.message,
            "hint": self.hint,
        }

    def render(self) -> str:
        loc = f" @ {self.site}" if self.site else ""
        out = f"{self.code} {str(self.severity):7s}{loc}: {self.message}"
        if self.hint:
            out += f"\n        fix: {self.hint}"
        return out


class Report:
    """Ordered diagnostic collection for one analyzed configuration."""

    def __init__(self, context: dict | None = None):
        self.context = dict(context or {})
        self.diagnostics: list[Diagnostic] = []

    def add(self, code: str, message: str, site: str = "",
            hint: str = "") -> Diagnostic:
        d = Diagnostic(code=code, message=message, site=site, hint=hint)
        self.diagnostics.append(d)
        return d

    def extend(self, diags) -> None:
        for d in diags:
            if not isinstance(d, Diagnostic):
                raise TypeError(f"not a Diagnostic: {d!r}")
            self.diagnostics.append(d)

    def by_severity(self, severity: Severity) -> list:
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self) -> list:
        return self.by_severity(Severity.ERROR)

    @property
    def warnings(self) -> list:
        return self.by_severity(Severity.WARNING)

    @property
    def infos(self) -> list:
        return self.by_severity(Severity.INFO)

    @property
    def ok(self) -> bool:
        """True when the configuration is launchable (no errors)."""
        return not self.errors

    def codes(self) -> list:
        return sorted({d.code for d in self.diagnostics})

    def has(self, code: str) -> bool:
        return any(d.code == code for d in self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def __len__(self) -> int:
        return len(self.diagnostics)

    def to_dict(self) -> dict:
        return {
            "context": self.context,
            "ok": self.ok,
            "counts": {
                "error": len(self.errors),
                "warning": len(self.warnings),
                "info": len(self.infos),
            },
            "diagnostics": [d.to_dict() for d in self.diagnostics],
        }

    def render(self, verbose: bool = True) -> str:
        """Human text output (the CLI's default format)."""
        head = " ".join(
            f"{k}={v}" for k, v in self.context.items() if v not in
            (None, False, "")
        )
        lines = [f"qlint {head}".rstrip()]
        shown = self.diagnostics if verbose else (
            self.errors + self.warnings)
        for d in sorted(shown, key=lambda d: (-int(d.severity), d.code)):
            lines.append("  " + d.render().replace("\n", "\n  "))
        lines.append(
            f"  => {'OK' if self.ok else 'BLOCKED'}: "
            f"{len(self.errors)} error(s), {len(self.warnings)} warning(s), "
            f"{len(self.infos)} info(s)"
        )
        return "\n".join(lines)
