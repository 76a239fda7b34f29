"""QL2xx: execution backend × weight representation × format legality.

Symbolically mirrors ``core.simulate.execution_backend``'s selection rules
and ``models.serving_transforms.compress_weights``'s per-site storage
decisions, so a config can be proven serveable before any weights exist.
"""

from __future__ import annotations

import re

from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.core.formats import IntFormat
from repro_torch.core.policy import (Policy, QuantPolicy, TensorQuant,
                                    resolve_policy)
from repro_torch.core.simulate import _int8_native_ok


def weight_compressible(tq: TensorQuant | None) -> bool:
    """Would ``compress_weights`` store this rule as integer codes?"""
    return (tq is not None and isinstance(tq.fmt, IntFormat)
            and tq.scaler in ("abfp", "channel_max"))


def symbolic_backend(pol: QuantPolicy, *, compressed_storage: bool) -> str:
    """``execution_backend``'s selection, without arrays in hand."""
    if compressed_storage:
        return "compressed"
    if not pol.enabled:
        return "ref"
    if pol.fused:
        return "fused"
    if pol.compute == "int8" and _int8_native_ok(pol):
        return "int8"
    return "ref"


def _norm_site(site: str) -> str:
    """Collapse layer indices so per-layer repeats dedupe to one finding."""
    return re.sub(r"blocks\.\d+", "blocks.*", site)


class _Dedup:
    """Collect diagnostics once per (code, normalized site, rule policy)."""

    def __init__(self):
        self.out: list = []
        self.counts: dict = {}

    def add(self, code: str, site: str, pol_name: str, message: str,
            hint: str = "") -> None:
        key = (code, _norm_site(site), pol_name)
        if key in self.counts:
            self.counts[key] += 1
            return
        self.counts[key] = 1
        self.out.append(Diagnostic(code=code, site=_norm_site(site),
                                   message=message, hint=hint))


def lint_backend(cfg, policy: Policy, sites, *, compress: bool,
                 shape=None) -> list:
    """QL201-QL207 over the model's matmul sites.

    ``sites`` is ``enumerate_matmul_sites(cfg)``'s [(site, K, N, mult)].
    """
    dd = _Dedup()
    if compress and shape is not None and shape.kind == "train":
        dd.out.append(Diagnostic(
            code="QL204",
            message=(
                "compressed storage is serving-only; shape kind "
                f"{shape.kind!r} trains (build_cell raises exactly this)"
            ),
            hint="use a prefill/decode shape, or drop --compress",
        ))
    n_compressible = 0
    for site, K, N, mult in sites:
        pol = resolve_policy(policy, site)
        tw = pol.weight
        if compress and tw is not None:
            if weight_compressible(tw):
                n_compressible += 1
                codes_len = tw.group if tw.scaler == "abfp" else K
                if tw.fmt.bits <= 4 and codes_len % 2:
                    dd.add(
                        "QL203", site, pol.name,
                        f"INT{tw.fmt.bits} codes at {site} cannot pack "
                        f"two-per-byte: stored group length {codes_len} "
                        f"({tw.scaler}) is odd, so codes stay one int8 "
                        "byte each (2x the packed footprint)",
                        hint="use an even ABFP group size",
                    )
            elif not isinstance(tw.fmt, IntFormat):
                dd.add(
                    "QL201", site, pol.name,
                    f"float-format weight rule ({tw.fmt_name!r}) at {site} "
                    "has no integer codes to store: the kernel is QDQ'd "
                    "offline but stays dense under --compress",
                    hint="expected for FP8/FP4 rules; use an int format "
                         "if code storage is the goal",
                )
            else:
                dd.add(
                    "QL205", site, pol.name,
                    f"int-format weight rule at {site} uses scaler "
                    f"{tw.scaler!r}, which compress_kernel does not "
                    "store (only 'abfp'/'channel_max' have per-group "
                    "code layouts); the kernel is QDQ'd offline but "
                    "stays dense",
                    hint="use an 'abfp' or 'channel_max' weight scaler",
                )
        stored = compress and weight_compressible(tw)
        backend = symbolic_backend(pol, compressed_storage=stored)
        if backend == "fused" and (pol.input is None or pol.weight is None):
            # ops.abfp_matmul_fused raises exactly this at trace time
            dd.add(
                "QL206", site, pol.name,
                f"fused path needs both x and w quantizers; policy "
                f"{pol.name!r} has input={pol.input} weight={pol.weight}",
                hint="disable fused for weight-only/activation-only "
                     "rules, or add the missing quantizer",
            )
        if (pol.enabled and pol.compute == "int8" and not stored
                and not _int8_native_ok(pol)):
            dd.add(
                "QL207", site, pol.name,
                f"policy {pol.name!r} requests compute='int8' but is not "
                "int8-native eligible (needs int formats, 'abfp' scalers "
                "and matched groups on both operands) — "
                f"{site} silently falls back to the ref backend",
                hint="use matched int-ABFP input/weight rules, or drop "
                     "compute='int8'",
            )
    if compress and n_compressible == 0 and sites:
        dd.out.append(Diagnostic(
            code="QL202",
            message=(
                "--compress found no int-format weight rules to compress: "
                "every site stays dense (the serve launcher warns exactly "
                "this at runtime)"
            ),
            hint="give at least one site an int-format abfp/channel_max "
                 "weight rule",
        ))
    return dd.out
