"""QL6xx: attention-backend dispatch lint (compressed-domain attention).

The per-site attention backend (``QuantPolicy.attn_backend``) selects how
the decode paths contract the KV cache: ``compressed`` feeds stored
int8/fp8 codes straight into the quantized flash kernel, ``fused`` runs
the dense flash-attention kernel on prefill self-attention, ``ref`` pins
the plain path, ``auto`` keeps the module's own choice.  Three things can
go wrong statically:

  ``QL601`` (error)   — ``compressed`` over dense fp KV storage: there
                        are no codes to contract; the decode path raises
                        the same message at trace time.
  ``QL602`` (warning) — a kernel backend was requested but a config /
                        policy / platform property silently degrades it
                        to a reference-speed path (softcap, SWA, an
                        unsupported probs quantizer, no CUDA device).
  ``QL603`` (error)   — fp8 KV storage on the fixed-slot engine: the
                        ring-buffer cache has no fp8 store; the engine
                        constructor raises the same message.

Message text is shared with the runtime raisers via
``analysis.messages`` — pasting either side finds the other.
"""

from __future__ import annotations

import torch

from repro_torch.analysis import messages as msg
from repro_torch.analysis.diagnostics import Diagnostic
from repro_torch.analysis.policy_lint import kv_mode_diagnostic
from repro_torch.core.formats import IntFormat
from repro_torch.core.policy import policies_of

_QUANTIZED = ("int8", "fp8")


def _requested_backends(policy) -> set:
    return {getattr(p, "attn_backend", "auto") for p in policies_of(policy)}


def _probs_quantizer(policy):
    """The attention-probs quantizer an enabled attn_bmm entry would
    apply (first match; entries rarely disagree on the input format)."""
    for p in policies_of(policy):
        if p.enabled and p.attn_bmm and p.input is not None:
            return p.input
    return None


def _probs_ineligibility(tq) -> str | None:
    """Why the in-kernel probs QDQ cannot mirror this quantizer (None
    when it can) — mirrors ``nn.attention._compressed_eligible``."""

    if tq.scaler != "abfp" or not tq.group:
        return f"probs quantizer scaler {tq.scaler!r} is not grouped ABFP"
    if not isinstance(tq.fmt, IntFormat):
        return (f"probs format {tq.fmt_name!r} is not an integer format "
                "(the in-kernel QDQ has no float-format body)")
    if str(tq.scale_dtype) not in ("bfloat16", "bf16"):
        return (f"probs scale_dtype {tq.scale_dtype!r} is not bfloat16 "
                "(the in-kernel QDQ stores BF16 group scales)")
    return None


def lint_attention(cfg, policy, attn=None) -> list:
    """QL601-QL603 for one launch tuple.

    ``attn`` (optional) carries the serving context: ``engine`` is
    ``"fixed"`` / ``"paged"`` (None outside a serving launch) and ``kv``
    the paged engine's resolved page storage when it overrides the
    policy's kv_cache mode (the ``--kv`` flag).
    """
    attn = attn or {}
    diags: list = []
    backends = _requested_backends(policy)
    engine = attn.get("engine")
    mode, _d = kv_mode_diagnostic(policy)  # QL007 reported by policy_lint
    storage = attn.get("kv") or mode  # actual page/slot storage format

    # --- QL601: compressed backend needs quantized storage ------------------
    if "compressed" in backends and storage is not None \
            and storage not in _QUANTIZED:
        where = ("the paged KV pool" if engine == "paged"
                 else "the ring-buffer cache")
        diags.append(Diagnostic(
            code="QL601", site="*/attn",
            message=msg.compressed_attn_storage_message(storage, where),
            hint="with_kv_cache(policy, 'int8') stores codes on every "
                 "entry; with_attn_backend(policy, 'ref') keeps QDQ-sim",
        ))

    # --- QL602: requested kernel silently degrades --------------------------
    kernel_backends = sorted(backends & {"fused", "compressed"})
    for backend in kernel_backends:
        reasons = []
        if getattr(cfg, "attn_softcap", None):
            reasons.append(
                f"logit softcap {cfg.attn_softcap} has no kernel body")
        if backend == "fused" and getattr(cfg, "window", None):
            reasons.append(
                f"sliding-window attention (window={cfg.window}) keeps "
                "the fused kernel off")
        if backend == "fused" and engine in ("fixed", "paged"):
            reasons.append(
                "the fused kernel covers square prefill self-attention "
                "only; decode steps stay on the reference path")
        if backend == "compressed":
            tq = _probs_quantizer(policy)
            why = None if tq is None else _probs_ineligibility(tq)
            if why is not None:
                reasons.append(why)
        if not torch.cuda.is_available():
            reasons.append(
                "no CUDA device present — kernel wrappers run their "
                "plain PyTorch versions (correct but reference-speed)")
        for reason in reasons:
            diags.append(Diagnostic(
                code="QL602", site="*/attn",
                message=msg.flash_fallback_message(backend, reason),
                hint="select attn_backend='ref' to make the fallback "
                     "explicit, or remove the blocking property",
            ))

    # --- QL603: fp8 storage on the fixed-slot engine ------------------------
    if engine == "fixed" and storage == "fp8":
        diags.append(Diagnostic(
            code="QL603", site="*/attn",
            message=msg.fp8_fixed_slot_message(),
            hint="serve with --paged (PagedServeEngine) or store int8",
        ))
    return diags
