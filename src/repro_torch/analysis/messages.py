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


def spec_kv_mismatch_message(draft_mode: str, target_mode: str) -> str:
    """Speculative draft/target kv_cache storage modes must agree
    (QL401 / SpeculativeServeEngine constructor): the two sides replay
    the same positions against their own caches, and a mode mismatch
    means the drafts were proposed against a different-fidelity context
    than the one the target verifies."""
    return (
        f"speculative draft and target policies disagree on kv_cache "
        f"storage (draft={draft_mode!r} vs target={target_mode!r}); align "
        "both sides with with_kv_cache() before serving"
    )


def spec_quantized_pages_message(mode: str) -> str:
    """Paged speculative serving requires fp page storage (QL403 /
    SpeculativeServeEngine constructor): the quantized page write path
    needs page-aligned chunks — a k+1 verify chunk rarely is — and the
    per-(page, head) scales only ratchet upward, so a rollback could
    never undo a rejected token's scale bump."""
    return (
        f"paged speculative serving cannot store kv_cache={mode!r} pages: "
        "verify chunks are not page-aligned and page scales are monotone "
        "(a rollback cannot lower them); use fp pages or the fixed-slot "
        "engine's per-token int8 ring cache"
    )


def spec_draft_k_message(draft_k: int, max_len: int) -> str:
    """Speculative draft depth sanity bound (QL404 /
    SpeculativeServeEngine constructor)."""
    return (
        f"speculative draft depth draft_k={draft_k} is out of range: need "
        f"1 <= draft_k < max_len ({max_len})"
    )


def expert_cache_capacity_message(capacity: int, n_experts: int) -> str:
    """Expert cache at least as large as the expert count (QL501,
    advisory): nothing ever evicts, so the compressed backing entries of
    cached experts are pure overhead — serve dense-resident instead."""
    return (
        f"expert cache capacity {capacity} >= expert count {n_experts}: "
        "every expert fits resident and the LRU never evicts, so the "
        "compressed backing store is pure overhead — shrink the cache or "
        "serve dense-resident"
    )


def expert_non_moe_message(what: str, arch: str) -> str:
    """Expert-serving machinery pointed at a dense model (QL502 /
    ExpertStore + engine ``expert_cache`` constructors): per-expert sites
    only exist on MoE configs."""
    return (
        f"{what} requires an MoE config (n_experts > 0): {arch!r} has no "
        "expert banks, so per-expert sites (…/experts.{e}) never resolve"
    )


def expert_precision_inversion_message(hot_bits: float,
                                       cold_bits: float) -> str:
    """Hot experts assigned fewer weight bits than cold ones (QL503,
    advisory, computed from the roofline per-expert bit report)."""
    return (
        f"hot experts average {hot_bits:.1f} weight bits vs {cold_bits:.1f}"
        " for cold experts: the most-routed experts carry LESS precision "
        "than the rarely-routed ones — swap the assignment "
        "(hot→INT8/FP8, cold→INT4)"
    )


def expert_cache_requires_compress_message() -> str:
    """``expert_cache`` without compressed serving (engine constructors):
    the cache swaps dense copies in for compressed backing entries; with
    dense-resident params there is nothing to cache."""
    return (
        "expert_cache requires compress=True: the expert cache holds "
        "decompressed copies of compressed backing entries, and "
        "dense-resident serving has nothing to decompress"
    )


def compressed_attn_storage_message(mode: str, where: str) -> str:
    """Compressed attention over fp KV storage: the backend contracts
    stored codes — dense fp storage has none to contract."""
    return (
        f"attention backend 'compressed' needs quantized KV storage, but "
        f"{where} holds kv_cache={mode!r} (dense fp) — store int8/fp8 "
        "entries (with_kv_cache) or select the 'ref'/'fused' backend"
    )


def fp8_fixed_slot_message() -> str:
    """fp8 KV pages on the fixed-slot engine (the ``ServeEngine``
    constructor raises this)."""
    return (
        "kv_cache='fp8' is paged-only (the ring-buffer cache has no fp8 "
        "storage); serve this policy with PagedServeEngine"
    )


def flash_q_offset_message(S: int, T: int) -> str:
    """Causal flash attention with S != T needs an explicit q_offset
    (kernels.flash_attention raises this; the ref path defaults T - S)."""
    return (
        f"causal flash attention with S={S} != T={T} needs an explicit "
        "q_offset (absolute position of the first query row); without it "
        "the block mask would assume the queries start at position 0"
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


def non_contract_layout_message(what: str, top_keys) -> str:
    """A site-rule map over a param tree whose paths are not the runtime
    site addresses (hybrid, encdec): the serving transforms would resolve
    its rules at the wrong sites."""
    return (
        f"{what} with a site-rule PolicyMap supports the "
        "TransformerLM/ViT param layout only: this tree's param paths "
        f"(top-level keys {sorted(top_keys)}) do not match the runtime "
        "site addresses, so per-site rules would silently mis-resolve "
        "— use a flat policy for hybrid/encdec families"
    )
