"""Attention for paged serving: GQA, sliding window, paged KV (fp or
quantized) — with the INT-FP-QSim BMM hooks.

Ported so far is what the paged serve engine runs: the reference
attention path (scores materialized; the QDQ-sim oracle) and
``paged_step`` with both of its branches — dequantize-then-reference, and
the compressed branch that hands page codes to the quantized-KV attention
kernel.  Full-sequence ``apply``, the ring-buffer cache and the blockwise
path wait for their slices.

The *window* is a per-layer Python int: window >= T means global.

Serving note: the q/k/v/o projection kernels may arrive as
``CompressedKernel`` codes + scales — they flow through ``Dense.apply``
into qmatmul's execution-backend dispatch untouched.

In-place note: the reference builds a new page pool per step
(``.at[].set``); here ``_page_write`` updates the pool tensors in place
(``index_put_``) and returns the same ``PagedKVCache`` — a 7B model's pool
is not copied per token.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.analysis.messages import (compressed_attn_storage_message,
                                           page_chunk_message)
from repro_torch.core.formats import IntFormat
from repro_torch.core.policy import Policy, resolve_policy
from repro_torch.core.quantize import div_by_constant
from repro_torch.core.simulate import (attention_backend, attn_backends,
                                       qdq_activation)
from repro_torch.nn.linear import Dense
from repro_torch.nn.rotary import apply_rope

NEG_INF = -1e9  # mask value (safe in bf16/f32)


class PagedKVCache(NamedTuple):
    """One layer's paged KV store: a shared pool of fixed-size pages.

    k/v: (n_pages + 1, page_size, n_kv * head_dim) — physical pages shared
    by every slot of the serving batch; which pages belong to which
    sequence lives in the engine's per-slot page table (threaded through
    ``DecodeState.pages``), not here.  The LAST physical page is the trash
    page: masked/padded writes are routed to it so the scatter stays
    fixed-shape (it is never gathered unmasked).

    Quantized storage ('int8' / 'fp8'): k/v hold codes and
    k_scale/v_scale hold per-(page, kv_head) f32 unit scales — one scale
    amortized over the whole page.  Decode writes into a partially-filled
    page monotonically raise its scale and requantize the resident codes
    (documented drift, bounded by the page's dynamic range ratio)."""

    k: torch.Tensor
    v: torch.Tensor
    k_scale: torch.Tensor | None = None  # (n_pages + 1, n_kv) f32
    v_scale: torch.Tensor | None = None


FP8_KV_MAX = 448.0  # float8_e4m3fn finite max (the paper's serving format)
_KV_EPS = 1e-12


def paged_kv_mode(cache: PagedKVCache) -> str:
    """Storage mode from the store itself: 'fp' | 'int8' | 'fp8'."""
    if cache.k_scale is None:
        return "fp"
    return "int8" if cache.k.dtype == torch.int8 else "fp8"


def _page_encode(x4: torch.Tensor, scale: torch.Tensor, mode: str):
    """Values (..., n_kv, D) + per-(..., n_kv) unit scales -> stored codes."""
    y = x4.to(torch.float32) / scale[..., None]
    if mode == "int8":
        return torch.clamp(torch.round(y), -127, 127).to(torch.int8)
    return y.to(torch.float8_e4m3fn)


def _page_unit_scale(alpha: torch.Tensor, mode: str) -> torch.Tensor:
    qmax = 127.0 if mode == "int8" else FP8_KV_MAX
    return div_by_constant(torch.clamp_min(alpha.to(torch.float32), _KV_EPS),
                           qmax)


@dataclasses.dataclass(frozen=True)
class Attention:
    d_model: int
    n_heads: int
    n_kv: int
    head_dim: int
    qkv_bias: bool = False
    causal: bool = True
    rope_theta: float = 10000.0
    use_rope: bool = True
    softcap: float | None = None
    query_scale: float | None = None  # default 1/sqrt(head_dim)
    param_dtype: str = "float32"
    dtype: str = "float32"
    name: str = "attn"

    # ---------------------------------------------------------------- init
    def init(self, gen: torch.Generator, device="cuda") -> dict:
        return {
            "q": self._dense("q", self.n_heads * self.head_dim).init(
                gen, device),
            "k": self._dense("k", self.n_kv * self.head_dim).init(
                gen, device),
            "v": self._dense("v", self.n_kv * self.head_dim).init(
                gen, device),
            "o": self._dense("o", self.d_model,
                             self.n_heads * self.head_dim).init(gen, device),
        }

    # ------------------------------------------------------------- helpers
    def _dense(self, which: str, out_dim: int, in_dim: int | None = None):
        return Dense(
            in_dim or self.d_model, out_dim,
            use_bias=self.qkv_bias if which in ("q", "k", "v") else False,
            param_dtype=self.param_dtype, dtype=self.dtype,
            name=f"{self.name}/{which}",
        )

    def _project_qkv(self, params, x, positions, policy):
        B, S, _ = x.shape
        qh = self._dense("q", self.n_heads * self.head_dim).apply(
            params["q"], x, policy)
        kh = self._dense("k", self.n_kv * self.head_dim).apply(
            params["k"], x, policy)
        vh = self._dense("v", self.n_kv * self.head_dim).apply(
            params["v"], x, policy)
        qh = qh.reshape(B, S, self.n_heads, self.head_dim)
        kh = kh.reshape(B, S, self.n_kv, self.head_dim)
        vh = vh.reshape(B, S, self.n_kv, self.head_dim)
        if self.use_rope:
            qh = apply_rope(qh, positions, self.rope_theta)
            kh = apply_rope(kh, positions, self.rope_theta)
        return qh, kh, vh

    def _scale(self) -> float:
        return (
            self.query_scale
            if self.query_scale is not None
            else self.head_dim**-0.5
        )

    def _maybe_quant_qkv(self, policy: Policy, qh, kh, vh,
                         skip_kv: bool = False):
        """QDQ attention-BMM operands along their contraction dims:
        q,k along head_dim (QK^T); v along its seq axis (probs@V).
        ``skip_kv``: cache entries were quantized at write time — only q
        needs QDQ here.  BMM operands resolve the policy at the block site
        (``self.name``)."""
        policy = resolve_policy(policy, self.name)
        if not (policy.enabled and policy.attn_bmm and policy.input):
            return qh, kh, vh
        tq = policy.input
        qh = qdq_activation(qh, tq, axis=-1, site=self.name + "/bmm_q")
        if not skip_kv:
            kh = qdq_activation(kh, tq, axis=-1, site=self.name + "/bmm_k")
            vh = qdq_activation(vh, tq, axis=1, site=self.name + "/bmm_v")
        return qh, kh, vh

    # ------------------------------------------- attention-backend dispatch
    def _attn_probs_tq(self, pol):
        """The probs/q quantizer when attention-BMM QDQ is active."""
        if pol.enabled and pol.attn_bmm and pol.input is not None:
            return pol.input
        return None

    def _compressed_eligible(self, pol) -> bool:
        """Can the quantized-KV kernel reproduce the QDQ-sim path here?

        Softcap has no kernel body, and the in-kernel probs QDQ mirrors
        int-format ABFP with BF16 scales only — anything else takes the
        dequantize-then-reference path (the reference's own semantics).
        """
        if self.softcap is not None:
            return False
        tq = self._attn_probs_tq(pol)
        if tq is None:
            return True
        return (tq.scaler == "abfp" and bool(tq.group)
                and isinstance(tq.fmt, IntFormat)
                and tq.scale_dtype == "bfloat16")

    def _quant_q(self, pol, qh):
        """The q-operand half of ``_maybe_quant_qkv`` (kernel callers QDQ
        q outside the kernel; K/V arrive pre-quantized as cache codes)."""
        tq = self._attn_probs_tq(pol)
        if tq is None:
            return qh
        return qdq_activation(qh, tq, axis=-1, site=self.name + "/bmm_q")

    def _use_compressed(self, pol, *, mode: str, where: str) -> bool:
        """Decode-path dispatch: contract cache codes in-kernel?

        ``mode`` is the cache's actual storage format ('fp'/'int8'/'fp8').
        Raises on compressed-over-fp-storage (there are no codes to
        contract); returns False for softcap / an unsupported probs
        quantizer.
        """
        if attention_backend(pol).name != "compressed":
            return False
        if mode not in ("int8", "fp8"):
            raise ValueError(compressed_attn_storage_message(mode, where))
        return self._compressed_eligible(pol)

    # -------------------------------------------------- reference attention
    def _reference(self, qh, kh, vh, q_pos, kv_pos, window, policy,
                   kv_prequant: bool = False):
        policy = resolve_policy(policy, self.name)
        G = self.n_heads // self.n_kv
        B, S, H, D = qh.shape
        qh, kh, vh = self._maybe_quant_qkv(policy, qh, kh, vh,
                                           skip_kv=kv_prequant)
        qg = qh.reshape(B, S, self.n_kv, G, D)
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
        scores = torch.einsum("bskgd,btkd->bkgst", qg, kh).to(
            torch.float32) * self._scale()
        if self.softcap is not None and self.softcap > 0:
            scores = self.softcap * torch.tanh(scores / self.softcap)
        mask = self._mask(q_pos, kv_pos, window)  # (B, S, T)
        scores = torch.where(mask[:, None, None], scores,
                             torch.full_like(scores, NEG_INF))
        e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
        probs = e / e.sum(dim=-1, keepdim=True)
        if policy.enabled and policy.attn_bmm and policy.input is not None:
            probs = qdq_activation(probs, policy.input, axis=-1,
                                   site=self.name + "/probs")
        out = torch.einsum("bkgst,btkd->bskgd", probs.to(vh.dtype), vh)
        return out.reshape(B, S, H, D).to(getattr(torch, self.dtype))

    def _mask(self, q_pos, kv_pos, window):
        """(B, S, T) boolean validity mask given absolute positions."""
        qp = q_pos[:, :, None]
        kp = kv_pos[:, None, :]
        m = kp >= 0  # padded/unwritten slots carry position -1
        if self.causal:
            m = m & (kp <= qp)
        # window >= T means global.
        return m & (kp > qp - window)

    # ------------------------------------------------------- paged decoding
    def init_paged_cache(self, n_pages: int, page_size: int, dtype=None,
                         kv: str = "fp", device="cuda") -> PagedKVCache:
        """One layer's shared page pool (+1 trash page for masked writes).

        ``kv``: 'fp' (native dtype), 'int8', or 'fp8' (e4m3 codes); the
        quantized modes add per-(page, head) f32 scales."""
        flat = self.n_kv * self.head_dim
        P = n_pages + 1  # physical pages incl. the trash page
        if kv in ("int8", "fp8"):
            ct = torch.int8 if kv == "int8" else torch.float8_e4m3fn
            # zero scales: an unwritten page dequantizes to exactly 0
            # (an all-zero byte is +0 in e4m3, so the pool starts as bytes)
            codes = lambda: torch.zeros(
                (P, page_size, flat), dtype=torch.uint8,
                device=device).view(ct)
            scales = lambda: torch.zeros((P, self.n_kv), dtype=torch.float32,
                                         device=device)
            return PagedKVCache(k=codes(), v=codes(), k_scale=scales(),
                                v_scale=scales())
        if kv != "fp":
            raise ValueError(f"unknown paged KV storage mode {kv!r} "
                             "(expected 'fp', 'int8' or 'fp8')")
        dt = dtype or getattr(torch, self.dtype)
        return PagedKVCache(
            k=torch.zeros((P, page_size, flat), dtype=dt, device=device),
            v=torch.zeros((P, page_size, flat), dtype=dt, device=device),
        )

    def _page_write(self, cache: PagedKVCache, kh, vh, phys_tok, positions,
                    mode: str) -> PagedKVCache:
        """Scatter S new tokens per row into the page pool, IN PLACE.

        kh/vh: (B, S, n_kv, D) with invalid rows already zeroed.
        ``phys_tok``: (B, S) physical page per token (masked writes
        already routed to the trash page).  Two shapes:

          * S == 1 (decode): single-token write; quantized modes gather the
            resident page, monotonically raise its per-(page, head) scale
            and requantize the old codes against it (drift bounded by the
            scale ratio — the documented paged-KV deviation).  The op
            order (rescale old codes by s_old/s_new, round, insert, round)
            is the reference's: the drift must be the same drift.
          * S == m * page_size with page-aligned positions (prefill
            chunks): whole-page writes; the page scale is the exact max
            over the page's (masked) tokens, so prefilled pages carry no
            requantization drift at all.

        Rows that share a target page all write the trash page (several
        masked rows): their values are zeros, so the winner is immaterial.
        """
        B, S, KV, D = kh.shape
        ps = cache.k.shape[1]
        F = KV * D
        phys_tok = phys_tok.long()
        if mode == "fp":
            slot = (positions % ps).long()
            cache.k.index_put_((phys_tok, slot),
                               kh.reshape(B, S, F).to(cache.k.dtype))
            cache.v.index_put_((phys_tok, slot),
                               vh.reshape(B, S, F).to(cache.v.dtype))
            return cache
        if S == 1:
            phys = phys_tok[:, 0]  # (B,)
            slot = (positions[:, 0] % ps).long()  # (B,)
            rows = torch.arange(B, device=kh.device)

            def upd(store, scale, x4):
                old = store[phys].reshape(B, ps, KV, D)  # codes
                s_old = scale[phys]  # (B, n_kv)
                alpha = x4[:, 0].abs().amax(dim=-1)  # (B, n_kv)
                s_new = torch.maximum(s_old, _page_unit_scale(alpha, mode))
                ratio = s_old / s_new  # <= 1; 0 for untouched pages
                old_f = old.to(torch.float32) * ratio[:, None, :, None]
                if mode == "int8":
                    old_rq = torch.clamp(torch.round(old_f), -127, 127)
                else:
                    old_rq = old_f
                page = old_rq
                page[rows, slot] = (x4[:, 0].to(torch.float32)
                                    / s_new[..., None])
                if mode == "int8":
                    page = torch.clamp(torch.round(page), -127, 127)
                page = page.to(store.dtype).reshape(B, ps, F)
                store.index_put_((phys,), page)
                scale.index_put_((phys,), s_new)

            upd(cache.k, cache.k_scale, kh)
            upd(cache.v, cache.v_scale, vh)
            return cache
        if S % ps:
            raise ValueError(page_chunk_message(S, ps))
        m = S // ps
        phys_pg = phys_tok.reshape(B, m, ps)[:, :, 0]  # (B, m)

        def enc(x4):
            xg = x4.reshape(B, m, ps, KV, D)
            alpha = xg.abs().amax(dim=(2, 4))  # (B, m, n_kv)
            s = _page_unit_scale(alpha, mode)
            codes = _page_encode(xg, s[:, :, None], mode)
            return codes.reshape(B, m, ps, F), s

        kc, ks = enc(kh)
        vc, vs = enc(vh)
        cache.k.index_put_((phys_pg,), kc)
        cache.v.index_put_((phys_pg,), vc)
        cache.k_scale.index_put_((phys_pg,), ks)
        cache.v_scale.index_put_((phys_pg,), vs)
        return cache

    def paged_step(
        self,
        params: dict,
        x: torch.Tensor,  # (B, S, d_model): S=1 decode, S=chunk prefill
        cache: PagedKVCache,
        *,
        page_table: torch.Tensor,  # (B, n_logical) physical indices, -1 free
        position: torch.Tensor,  # (B,) absolute position of x[:, 0]
        n_valid: torch.Tensor,  # (B,) valid tokens in x (0 masks the row)
        policy: Policy,
        window: int | None = None,
    ) -> tuple[torch.Tensor, PagedKVCache]:
        """Unified paged write-then-attend over a token chunk.

        Projects S tokens, writes their K/V into the row's pages (invalid
        tokens — pad rows past ``n_valid`` or rows with no page mapped —
        go to the trash page), then gathers the row's full page list and
        attends with absolute positions: through the quantized-KV kernel
        on the page codes (compressed backend), or by rescaling quantized
        pages, zero-masking unwritten positions and running the reference
        attention.  Masked positions are exact zeros and ABFP seq-axis
        groups align from index 0, so requant QDQ over the gather matches
        a contiguous cache bit-for-bit.
        """
        pol = resolve_policy(policy, self.name)
        mode = paged_kv_mode(cache)
        B, S, _ = x.shape
        NL = page_table.shape[1]
        ps = cache.k.shape[1]
        trash = cache.k.shape[0] - 1
        dev = x.device
        position = position.to(torch.int32)
        n_valid = n_valid.to(torch.int32)
        steps = torch.arange(S, dtype=torch.int32, device=dev)[None]
        positions = position[:, None] + steps
        qh, kh, vh = self._project_qkv(params, x, positions, policy)
        keep = steps < n_valid[:, None]
        kh = kh * keep[..., None, None].to(kh.dtype)
        vh = vh * keep[..., None, None].to(vh.dtype)
        kv_on_write = (mode == "fp" and pol.enabled and pol.attn_bmm
                       and pol.input is not None
                       and pol.kv_cache == "on_write")
        if kv_on_write:
            # quantize ONCE at write time (per-token)
            kh = qdq_activation(kh, pol.input, axis=-1,
                                site=self.name + "/bmm_k")
            vh = qdq_activation(vh, pol.input, axis=-1,
                                site=self.name + "/bmm_v")

        # physical page per token; every masked write routes to the trash
        page_of = torch.div(positions, ps, rounding_mode="floor")
        lp = torch.clamp(page_of, 0, NL - 1).long()  # (B, S) logical pages
        phys_tok = torch.gather(page_table, 1, lp)
        ok = keep & (phys_tok >= 0) & (page_of < NL)
        phys_tok = torch.where(ok, phys_tok,
                               torch.full_like(phys_tok, trash))
        cache = self._page_write(cache, kh, vh, phys_tok, positions, mode)

        # gather the row's pages in logical order -> contiguous (B, T, ...)
        T = NL * ps
        phys_tab = torch.where(page_table >= 0, page_table,
                               torch.full_like(page_table, trash)).long()
        idx = torch.arange(T, dtype=torch.int32, device=dev)[None]  # (1, T)
        mapped = (page_table >= 0).repeat_interleave(ps, dim=1)  # (B, T)
        n_ctx = position + n_valid  # tokens visible after this write
        valid = (idx < n_ctx[:, None]) & mapped
        kv_pos = torch.where(valid, idx, torch.full_like(idx, -1))
        if window is None:
            window = T + 1
        dt = getattr(torch, self.dtype)
        if self._use_compressed(pol, mode=mode, where="the paged KV pool"):
            # gather CODES only — no dequantized dense copy, no zero-mask:
            # invalid/trash positions carry kv_pos = -1, which the kernel
            # turns into probability-exactly-0 (trash never reaches the
            # output), and the page scales broadcast over their tokens.
            gk = cache.k[phys_tab].reshape(B, T, self.n_kv, self.head_dim)
            gv = cache.v[phys_tab].reshape(B, T, self.n_kv, self.head_dim)
            sk = cache.k_scale[phys_tab].repeat_interleave(ps, dim=1)
            sv = cache.v_scale[phys_tab].repeat_interleave(ps, dim=1)
            out = attn_backends()["compressed"].fn(
                self._quant_q(pol, qh), gk, gv, sk, sv,
                positions, kv_pos, window,
                scale=self._scale(), causal=self.causal,
                probs_tq=self._attn_probs_tq(pol),
            ).to(dt)
        else:
            gk = cache.k[phys_tab]  # (B, NL, ps, F)
            gv = cache.v[phys_tab]
            if mode != "fp":
                sk = cache.k_scale[phys_tab][:, :, None, :, None]
                sv = cache.v_scale[phys_tab][:, :, None, :, None]
                gk = gk.reshape(B, NL, ps, self.n_kv, self.head_dim)
                gv = gv.reshape(B, NL, ps, self.n_kv, self.head_dim)
                gk = (gk.to(torch.float32) * sk).to(dt)
                gv = (gv.to(torch.float32) * sv).to(dt)
            gk = gk.reshape(B, T, self.n_kv, self.head_dim)
            gv = gv.reshape(B, T, self.n_kv, self.head_dim)
            # zero-mask: requant group maxima must see zeros, never trash
            gk = gk * valid[..., None, None].to(gk.dtype)
            gv = gv * valid[..., None, None].to(gv.dtype)
            out = self._reference(qh, gk, gv, positions, kv_pos, window,
                                  policy,
                                  kv_prequant=kv_on_write or mode != "fp")
        y = self._dense("o", self.d_model,
                        self.n_heads * self.head_dim).apply(
            params["o"], out.reshape(B, S, -1), policy)
        return y, cache
