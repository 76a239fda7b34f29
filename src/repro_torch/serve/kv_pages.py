"""Paged KV-cache bookkeeping: geometry, the host-side page pool, and the
resident-byte accounting the serving table reports.

The device side (page stores, codecs, the gather/scatter attention step)
lives in ``nn.attention`` / ``models.lm``; this module is deliberately
host-only (stdlib) so the engine's admission control never touches a
device tensor:

  * ``PageGeometry`` — the static shape contract: ``page_size`` tokens per
    page, ``n_pages`` physical pages in the shared pool, and
    ``max_pages_per_seq`` logical pages a single request may map.  The
    device stores allocate ``n_pages + 1`` physical pages: index
    ``n_pages`` is the *trash page* — every masked or padded write is
    routed there so the scatter stays fixed-shape with no
    conditionals (the trash page is never gathered unmasked).
  * ``PagePool`` — freelist allocation with alloc/free accounting.  The
    engine reserves a request's worst-case page count at admission
    (``pages_for(prompt + max_new_tokens)``), so decode can never deadlock
    mid-sequence waiting for a page another stalled sequence holds.
  * byte accounting — ``page_store_bytes`` / ``resident_kv_bytes`` turn a
    pool occupancy into device-memory bytes per storage format.

``check_geometry`` raises the message text of ``analysis.messages``.
"""

from __future__ import annotations

import dataclasses

from repro_torch.analysis import messages as msg


def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` cache entries (ceil division)."""
    return -(-max(n_tokens, 0) // page_size)


@dataclasses.dataclass(frozen=True)
class PageGeometry:
    """Static shape contract of a paged KV pool."""

    page_size: int  # tokens per page
    n_pages: int  # physical pages in the shared pool (excl. trash)
    max_len: int  # per-request cap: prompt + generated tokens
    prefill_chunk: int  # chunked-prefill tile (the engine's bucket)

    @property
    def max_pages_per_seq(self) -> int:
        return pages_for(self.max_len, self.page_size)

    @property
    def trash_page(self) -> int:
        """Physical index masked writes are routed to (stores allocate
        ``n_pages + 1`` pages; this one is never gathered unmasked)."""
        return self.n_pages


def check_geometry(geo: PageGeometry) -> None:
    """Raise on geometry the engine cannot serve."""
    if geo.page_size < 1 or geo.n_pages < 1:
        raise ValueError(
            f"paged KV pool needs page_size >= 1 and n_pages >= 1; got "
            f"page_size={geo.page_size} n_pages={geo.n_pages}")
    if geo.prefill_chunk % geo.page_size:
        raise ValueError(
            msg.page_chunk_message(geo.prefill_chunk, geo.page_size))
    if geo.n_pages < geo.max_pages_per_seq:
        raise ValueError(
            msg.page_pool_message(geo.n_pages, geo.max_pages_per_seq,
                                  geo.max_len, geo.page_size))


class PagePool:
    """Host-side freelist over the physical pages of a shared KV pool.

    Allocation is all-or-nothing (``alloc`` returns None rather than a
    partial grant) and every page is handed out at most once — the
    accounting asserts double-frees and leaks instead of absorbing them,
    because a page leak in the engine silently becomes an admission
    livelock under load.
    """

    def __init__(self, n_pages: int):
        self.n_pages = n_pages
        self._free = list(range(n_pages - 1, -1, -1))  # pop() -> page 0 first
        self.peak_in_use = 0
        self.total_allocs = 0
        self.total_frees = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self._free)

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int) -> list[int] | None:
        """Grant ``n`` pages or None (never a partial grant)."""
        if n > len(self._free):
            return None
        got = [self._free.pop() for _ in range(n)]
        self.total_allocs += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return got

    def free(self, pages: list[int]) -> None:
        for p in pages:
            if not (0 <= p < self.n_pages):
                raise ValueError(f"freeing page {p} outside pool "
                                 f"[0, {self.n_pages})")
            if p in self._free:
                raise ValueError(f"double-free of page {p}")
            self._free.append(p)
        self.total_frees += len(pages)

    def stats(self) -> dict:
        return {
            "pages_total": self.n_pages,
            "pages_free": self.free_pages,
            "pages_in_use": self.in_use,
            "pages_peak": self.peak_in_use,
            "page_allocs": self.total_allocs,
            "page_frees": self.total_frees,
        }


# ---------------------------------------------------------------------------
# Resident-byte accounting
# ---------------------------------------------------------------------------
def page_store_bytes(page_size: int, n_kv: int, head_dim: int,
                     n_layers: int, kv: str, fp_bytes: int = 4) -> dict:
    """Per-page device-memory bytes of one K+V page across all layers.

    ``kv``: 'fp' (native dtype, ``fp_bytes`` each), 'int8' (1-byte codes),
    or 'fp8' (1-byte e4m3 codes).  Quantized modes carry per-(page, head)
    f32 scales, reported separately as ``scale_bytes`` — they amortize
    over the whole page and stay metadata-sized (<1% of the code bytes for
    any realistic page).
    """
    elems = 2 * page_size * n_kv * head_dim * n_layers  # K and V
    if kv in ("int8", "fp8"):
        code_bytes = elems  # 1 byte per code
        scale_bytes = 2 * n_kv * n_layers * 4  # k+v f32 per (page, head)
    else:
        code_bytes = elems * fp_bytes
        scale_bytes = 0
    return {"code_bytes": code_bytes, "scale_bytes": scale_bytes,
            "page_bytes": code_bytes + scale_bytes}


def resident_kv_bytes(n_pages_in_use: int, page_size: int, n_kv: int,
                      head_dim: int, n_layers: int, kv: str,
                      fp_bytes: int = 4) -> dict:
    """Pool-occupancy bytes plus the fp16 / engine-fp equivalents the
    capacity ratios are quoted against."""
    per = page_store_bytes(page_size, n_kv, head_dim, n_layers, kv,
                           fp_bytes=fp_bytes)
    fp16 = page_store_bytes(page_size, n_kv, head_dim, n_layers, "fp",
                            fp_bytes=2)
    fp_native = page_store_bytes(page_size, n_kv, head_dim, n_layers, "fp",
                                 fp_bytes=fp_bytes)
    out = {
        "kv_resident_bytes": n_pages_in_use * per["page_bytes"],
        "kv_code_bytes": n_pages_in_use * per["code_bytes"],
        "kv_scale_bytes": n_pages_in_use * per["scale_bytes"],
        "kv_fp16_equiv_bytes": n_pages_in_use * fp16["page_bytes"],
        "kv_fp_equiv_bytes": n_pages_in_use * fp_native["page_bytes"],
    }
    if out["kv_fp16_equiv_bytes"]:
        out["kv_vs_fp16_ratio"] = round(
            out["kv_code_bytes"] / out["kv_fp16_equiv_bytes"], 4)
    return out


def attention_read_bytes(n_tokens: int, n_kv: int, head_dim: int,
                         n_layers: int, kv: str, backend: str,
                         fp_bytes: int = 4, page_size: int = 16) -> dict:
    """Attention-path bytes one decode step READS from the KV store.

    ``resident_kv_bytes`` answers "what fits"; this answers "what moves".
    A decode step's attention contracts the whole resident context
    (``n_tokens`` K+V entries per layer), and *which bytes* cross the
    memory bus depends on the attention backend (a byte model, not a
    measurement):

      * ``compressed`` — the kernel consumes stored codes directly:
        1 byte/element plus the per-(page, head) scales, nothing else.
      * any QDQ-sim backend (``auto``/``ref``/``fused``) over quantized
        storage — the codes are read AND a dense fp dequantized copy is
        materialized (written then re-read by the contraction), so the
        traffic is codes + scales + 2x the dense equivalent.
      * fp storage — the dense entries at the engine dtype.

    Keys mirror the resident accounting: ``attn_kv_read_bytes`` (total),
    ``attn_code_read_bytes`` / ``attn_scale_read_bytes`` (quantized modes),
    ``attn_fp16_equiv_read_bytes`` (what a dense fp16 read path would
    move) and ``attn_vs_fp16_read_ratio``.
    """
    elems = 2 * n_tokens * n_kv * head_dim * n_layers  # K and V, all layers
    fp16_equiv = elems * 2
    quantized = kv in ("int8", "fp8")
    scale_bytes = (pages_for(n_tokens, page_size) * 2 * n_kv * n_layers * 4
                   if quantized else 0)
    if backend == "compressed":
        code = elems
        total = code + scale_bytes
    elif quantized:
        code = elems
        total = code + scale_bytes + 2 * elems * fp_bytes  # dense round-trip
    else:
        code = 0
        total = elems * fp_bytes
    out = {
        "attn_kv_read_bytes": total,
        "attn_code_read_bytes": code,
        "attn_scale_read_bytes": scale_bytes,
        "attn_fp16_equiv_read_bytes": fp16_equiv,
    }
    if fp16_equiv:
        out["attn_vs_fp16_read_ratio"] = round(total / fp16_equiv, 4)
    return out
