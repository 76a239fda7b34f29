"""Shared message formatters for runtime errors.

Only the messages the ported modules raise live here; the wording is the
reference package's, so an error reads the same from either stack.  The
module is import-free so every layer can use it without cycles.
"""

from __future__ import annotations


def attention_block_message(S: int, T: int, bq: int, bk: int) -> str:
    """Flash/blockwise attention sequence-vs-block divisibility."""
    return (
        f"attention sequence lengths (S={S}, T={T}) do not tile by the "
        f"attention blocks (block_q={bq}, block_k={bk}); pad the sequence "
        "or choose block sizes dividing it"
    )


def abfp_group_message(K: int, n: int, where: str = "") -> str:
    """Fused-path K % group-length divisibility."""
    loc = f" at {where}" if where else ""
    return (
        f"contraction dim K={K}{loc} is not a multiple of the ABFP group "
        f"length n={n}"
    )


def page_pool_message(n_pages: int, need: int, max_len: int,
                      page_size: int) -> str:
    """Paged-KV pool too small to ever admit a maximal request (the
    admission loop would livelock on it; PagedServeEngine raises this at
    construction)."""
    return (
        f"paged KV pool of {n_pages} pages cannot admit a maximal request: "
        f"max_len={max_len} at page_size={page_size} reserves {need} pages"
    )


def page_chunk_message(chunk: int, page_size: int) -> str:
    """Chunked prefill must tile by the page size so each chunk's writes
    land in whole pages."""
    return (
        f"prefill chunk {chunk} is not a multiple of the KV page size "
        f"{page_size}; chunk writes must cover whole pages"
    )


def compressed_attn_storage_message(mode: str, where: str) -> str:
    """Compressed attention over fp KV storage: the backend contracts
    stored codes — dense fp storage has none to contract."""
    return (
        f"attention backend 'compressed' needs quantized KV storage, but "
        f"{where} holds kv_cache={mode!r} (dense fp) — store int8/fp8 "
        "entries (with_kv_cache) or select the 'ref'/'fused' backend"
    )


def scan_compat_message(policy_name: str, patterns: list,
                        model_name: str = "") -> str:
    """Layer-indexed rules can never match scan-over-layers sites."""
    return (
        f"PolicyMap {policy_name!r} has layer-indexed rules "
        f"({patterns}) which need per-layer "
        f"sites: run {model_name or 'the model'} with "
        "cfg.scan_layers=False (the same eager-unrolled constraint "
        "calibration already has)"
    )


def layer_rules_family_message(patterns: list, model_name: str = "") -> str:
    """Layer-indexed rules on a family without per-layer sites."""
    return (
        f"{model_name or 'this model family'} does not thread "
        f"per-layer site names; layer-indexed PolicyMap rules "
        f"({patterns}) are unsupported here — "
        "use pattern rules like '*attn*' / 'mamba*' instead"
    )


def kv_mode_message(policy_name: str, modes: list) -> str:
    """A map whose rules disagree on the engine-global KV storage mode."""
    return (
        f"PolicyMap {policy_name!r} mixes kv_cache modes {modes} "
        "(fp32 rules count: cache storage is structural); KV-cache "
        "storage is engine-global — set it on every entry with "
        "with_kv_cache(policy, mode)"
    )
