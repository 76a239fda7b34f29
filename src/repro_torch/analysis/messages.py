"""Shared message formatters for runtime errors and QL3xx diagnostics.

The typed errors in ``kernels/`` / ``nn/attention.py`` / ``serve/`` and the
static analyzer's findings tell the same story in the same words: a user
who hits the runtime error finds the lint code by pasting the message, and
vice versa.  The wording is the reference package's, so an error reads the
same from either stack, except for the kernels' shared-memory plans
(``smem_message``), which are the Hopper kernels' own.  The module is
import-free so every layer can use it without cycles.
"""

from __future__ import annotations

INT32_MAX = 2**31 - 1


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


def int32_overflow_message(site: str, K: int, group: int, bits_x: int,
                           bits_w: int, bound: int) -> str:
    n_acc = min(group, K)
    return (
        f"int32 accumulator can overflow at {site}: contracting "
        f"{n_acc} elements of int{bits_x} x int{bits_w} codes bounds the "
        f"per-group partial sum at {bound} > {INT32_MAX} (2^31-1)"
    )


def smem_message(kernel: str, what: str, need: int, limit: int) -> str:
    """A kernel plan whose block would need more dynamic shared memory than
    an sm_90 block may use: the plans in ``kernels/`` raise it before any
    launch, and qlint reports the same text as QL303."""
    return (
        f"{kernel}: {what} needs {need} bytes a block, more shared memory "
        f"than the {limit} bytes a block may use on sm_90"
    )


def page_pool_message(n_pages: int, need: int, max_len: int,
                      page_size: int) -> str:
    """Paged-KV pool too small to ever admit a maximal request (the
    admission loop would livelock on it; PagedServeEngine raises this at
    construction and qlint flags it as QL305)."""
    return (
        f"paged KV pool of {n_pages} pages cannot admit a maximal request: "
        f"max_len={max_len} at page_size={page_size} reserves {need} pages"
    )


def page_chunk_message(chunk: int, page_size: int) -> str:
    """Chunked prefill must tile by the page size so each chunk's writes
    land in whole pages (QL306 / PagedServeEngine constructor)."""
    return (
        f"prefill chunk {chunk} is not a multiple of the KV page size "
        f"{page_size}; chunk writes must cover whole pages"
    )


def page_waste_message(page_size: int, max_len: int, waste_pct: float) -> str:
    """Coarse pages waste reserved capacity (QL307, advisory)."""
    return (
        f"KV page size {page_size} is coarse for max_len={max_len}: "
        f"worst-case reservation rounding wastes {waste_pct:.0f}% of a "
        "sequence's pages"
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
    """Compressed attention over fp KV storage (QL601 / nn.attention
    decode paths): the backend contracts stored codes — dense fp storage
    has none to contract."""
    return (
        f"attention backend 'compressed' needs quantized KV storage, but "
        f"{where} holds kv_cache={mode!r} (dense fp) — store int8/fp8 "
        "entries (with_kv_cache) or select the 'ref'/'fused' backend"
    )


def flash_fallback_message(backend: str, reason: str) -> str:
    """Flash/compressed attention request that silently degrades to a
    reference-speed path (QL602, advisory — the runtime falls back
    without a signal; this is that signal)."""
    return (
        f"attention backend {backend!r} silently degrades to a "
        f"reference-speed path: {reason}"
    )


def fp8_fixed_slot_message() -> str:
    """fp8 KV pages on the fixed-slot engine (QL603 / serve.ServeEngine
    constructor)."""
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
