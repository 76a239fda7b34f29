"""Attention: GQA, sliding window, blockwise (flash-style), KV cache (ring
buffer or paged, fp or quantized) — with the INT-FP-QSim BMM hooks.

Compute paths:
  * reference  — materializes scores; the QDQ-sim oracle.
  * blockwise  — running-softmax loop over KV blocks, taken by ``apply``
                 at sequence lengths >= ``blockwise_min_seq``.
  * flash      — the dense flash-attention kernel (``fused`` backend),
                 taken by ``apply`` where ``flash_ok`` holds.
  * decode     — ``decode_step`` over the ring-buffer cache, and
                 ``paged_step`` over the page pool; each either
                 dequantizes and runs the reference path, or (``compressed``
                 backend) hands the cache codes to the quantized-KV kernel.

The *window* is a per-layer Python int: window >= T means global.

Serving note: the q/k/v/o projection kernels may arrive as
``CompressedKernel`` codes + scales — they flow through ``Dense.apply``
into qmatmul's execution-backend dispatch untouched.

In-place note: the reference builds a new cache per step (``.at[].set``);
here ``decode_step`` and ``_page_write`` update the cache tensors in place
(``index_put_``) and return the same tensors — a 7B model's cache is not
copied per token.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.analysis.messages import (attention_block_message,
                                           compressed_attn_storage_message,
                                           page_chunk_message)
from repro_torch.core.formats import IntFormat
from repro_torch.core.policy import Policy, resolve_policy
from repro_torch.core.quantize import div_by_constant
from repro_torch.core.simulate import (attention_backend, attn_backends,
                                       qdq_activation)
from repro_torch.dist import sharding as shd
from repro_torch.nn.linear import Dense
from repro_torch.nn.rotary import apply_rope

NEG_INF = -1e9  # mask value (safe in bf16/f32)


class KVCache(NamedTuple):
    """Ring-buffer decode cache. k/v: (B, S_max, n_kv * head_dim) flat.

    int8 storage mode (policy.kv_cache == 'int8'): k/v hold int8 codes and
    k_scale/v_scale hold per-(slot, kv_head) f32 unit scales — half the
    cache bytes and half the read traffic per decode step."""

    k: torch.Tensor
    v: torch.Tensor
    # int32 scalar: high-water mark of the written positions
    length: torch.Tensor
    k_scale: torch.Tensor | None = None  # (B, S_max, n_kv) f32, int8 mode
    v_scale: torch.Tensor | None = None


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


def _kv_quantize(x4: torch.Tensor):
    """(…, n_kv, D) -> int8 codes + per-(…, head) unit scales."""
    alpha = x4.abs().amax(dim=-1)  # (..., n_kv)
    scale = div_by_constant(torch.clamp_min(alpha.to(torch.float32), 1e-12),
                            127.0)
    codes = torch.clamp(torch.round(x4.to(torch.float32) / scale[..., None]),
                        -127, 127).to(torch.int8)
    return codes, scale


def _constrain_kv(cache):
    """A ring cache's K / V laid out as ``("batch", "kv_seq", "qkv")``
    under ``use_rules``; the cache itself otherwise (its tensors are
    written in place by the serving steps)."""
    if shd.active() is None:
        return cache
    axes = ("batch", "kv_seq", "qkv")
    return cache._replace(k=shd.constrain(cache.k, axes),
                          v=shd.constrain(cache.v, axes))


def _static_alpha(q: dict | None, key: str):
    """The calibrated ``in_alpha`` of one BMM operand in a q-tree slice."""
    return None if q is None else (q.get(key) or {}).get("in_alpha")


def _kv_dequantize(codes_flat, scale, n_kv: int, head_dim: int, dtype):
    """int8 flat codes + (…, n_kv) scales -> (…, n_kv, D) values."""
    c4 = codes_flat.reshape(*codes_flat.shape[:-1], n_kv, head_dim)
    return (c4.to(torch.float32) * scale[..., None]).to(dtype)


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
    q_block: int = 512
    kv_block: int = 512
    blockwise_min_seq: int = 1024  # use blockwise above this length
    use_flash_kernel: bool = False  # flash kernel under the 'auto' backend
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

    def axes(self) -> dict:
        """The logical axes of ``init``'s tree, leaf for leaf."""
        return {
            "q": self._dense("q", self.n_heads * self.head_dim).axes(),
            "k": self._dense("k", self.n_kv * self.head_dim).axes(),
            "v": self._dense("v", self.n_kv * self.head_dim).axes(),
            "o": self._dense("o", self.d_model,
                             self.n_heads * self.head_dim).axes(),
        }

    # ------------------------------------------------------------- helpers
    def _dense(self, which: str, out_dim: int, in_dim: int | None = None):
        return Dense(
            in_dim or self.d_model, out_dim,
            use_bias=self.qkv_bias if which in ("q", "k", "v") else False,
            param_dtype=self.param_dtype, dtype=self.dtype,
            name=f"{self.name}/{which}",
            in_axis="embed" if which != "o" else "qkv",
            out_axis="qkv" if which != "o" else "embed",
        )

    def _project_qkv(self, params, x, positions, policy, q=None):
        B, S, _ = x.shape
        qh = self._dense("q", self.n_heads * self.head_dim).apply(
            params["q"], x, policy, q=None if q is None else q.get("q"))
        kh = self._dense("k", self.n_kv * self.head_dim).apply(
            params["k"], x, policy, q=None if q is None else q.get("k"))
        vh = self._dense("v", self.n_kv * self.head_dim).apply(
            params["v"], x, policy, q=None if q is None else q.get("v"))
        qh = qh.reshape(B, S, self.n_heads, self.head_dim)
        kh = kh.reshape(B, S, self.n_kv, self.head_dim)
        vh = vh.reshape(B, S, self.n_kv, self.head_dim)
        if self.use_rope:
            qh = shd.per_shard(apply_rope, qh, positions, self.rope_theta)
            kh = shd.per_shard(apply_rope, kh, positions, self.rope_theta)
        qh = shd.constrain(qh, ("batch", "seq", "heads", "head_dim"))
        kh = shd.constrain(kh, ("batch", "seq", "kv_heads", "head_dim"))
        vh = shd.constrain(vh, ("batch", "seq", "kv_heads", "head_dim"))
        return qh, kh, vh

    def _scale(self) -> float:
        return (
            self.query_scale
            if self.query_scale is not None
            else self.head_dim**-0.5
        )

    def _maybe_quant_qkv(self, policy: Policy, qh, kh, vh,
                         q: dict | None = None, skip_kv: bool = False):
        """QDQ attention-BMM operands along their contraction dims:
        q,k along head_dim (QK^T); v along its seq axis (probs@V).
        ``q``: optional static alphas {'bmm_q': {'in_alpha': ...}, ...}.
        ``skip_kv``: cache entries were quantized at write time — only q
        needs QDQ here.  BMM operands resolve the policy at the block site
        (``self.name``)."""
        policy = resolve_policy(policy, self.name)
        if not (policy.enabled and policy.attn_bmm and policy.input):
            return qh, kh, vh
        tq = policy.input
        qh = qdq_activation(qh, tq, axis=-1, site=self.name + "/bmm_q",
                            alpha=_static_alpha(q, "bmm_q"))
        if not skip_kv:
            kh = qdq_activation(kh, tq, axis=-1, site=self.name + "/bmm_k",
                                alpha=_static_alpha(q, "bmm_k"))
            vh = qdq_activation(vh, tq, axis=1, site=self.name + "/bmm_v",
                                alpha=_static_alpha(q, "bmm_v"))
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

    def _quant_q(self, pol, qh, q=None):
        """The q-operand half of ``_maybe_quant_qkv`` (kernel callers QDQ
        q outside the kernel; K/V arrive pre-quantized as cache codes)."""
        tq = self._attn_probs_tq(pol)
        if tq is None:
            return qh
        return qdq_activation(qh, tq, axis=-1, site=self.name + "/bmm_q",
                              alpha=_static_alpha(q, "bmm_q"))

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
                   q=None, kv_prequant: bool = False):
        policy = resolve_policy(policy, self.name)
        B, S, H, D = qh.shape
        KV = kh.shape[2]  # this rank's heads, under a mesh
        G = H // KV
        qh, kh, vh = self._maybe_quant_qkv(policy, qh, kh, vh, q,
                                           skip_kv=kv_prequant)
        qg = qh.reshape(B, S, KV, G, D)
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
                                   site=self.name + "/probs",
                                   alpha=_static_alpha(q, "probs"))
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

    # -------------------------------------------------- blockwise attention
    def _blockwise(self, qh, kh, vh, q_pos, kv_pos, window, policy,
                   q=None):
        """Running-softmax loop over KV blocks (the reference's recurrence,
        with its finite ``NEG_INF`` and no masked-row guard); the (S, T)
        score matrix never exists whole."""
        policy = resolve_policy(policy, self.name)
        B, S, H, D = qh.shape
        T = kh.shape[1]
        qb, kb = min(self.q_block, S), min(self.kv_block, T)
        nq, nk = S // qb, T // kb
        if S % qb or T % kb:
            raise ValueError(attention_block_message(S, T, qb, kb))
        KV = kh.shape[2]  # this rank's heads, under a mesh
        G = qh.shape[2] // KV
        scale = self._scale()
        qh, kh, vh = self._maybe_quant_qkv(policy, qh, kh, vh, q)
        tq = policy.input if (policy.enabled and policy.attn_bmm) else None
        palpha = _static_alpha(q, "probs")
        torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
        qs = qh.reshape(B, nq, qb, KV, G, D)
        qp = q_pos.reshape(B, nq, qb)
        ks = kh.reshape(B, nk, kb, KV, D)
        vs = vh.reshape(B, nk, kb, KV, D)
        kp = kv_pos.reshape(B, nk, kb)
        dev = qh.device
        outs = []
        for i in range(nq):
            qc, qpc = qs[:, i], qp[:, i]  # (B, qb, KV, G, D), (B, qb)
            m_run = torch.full((B, KV, G, qb), NEG_INF, dtype=torch.float32,
                               device=dev)
            l_run = torch.zeros((B, KV, G, qb), dtype=torch.float32,
                                device=dev)
            acc = torch.zeros((B, KV, G, qb, D), dtype=torch.float32,
                              device=dev)
            for j in range(nk):
                kc, vc, kpc = ks[:, j], vs[:, j], kp[:, j]
                s = torch.einsum("bskgd,btkd->bkgst", qc, kc).to(
                    torch.float32) * scale
                if self.softcap is not None and self.softcap > 0:
                    s = self.softcap * torch.tanh(s / self.softcap)
                mask = self._mask(qpc, kpc, window)  # (B, qb, kb)
                s = torch.where(mask[:, None, None], s,
                                torch.full_like(s, NEG_INF))
                m_new = torch.maximum(m_run, s.amax(dim=-1))
                p = torch.exp(s - m_new[..., None])
                if tq is not None:
                    p = qdq_activation(p, tq, axis=-1,
                                       site=self.name + "/probs",
                                       alpha=palpha)
                corr = torch.exp(m_run - m_new)
                l_run = l_run * corr + p.sum(dim=-1)
                pv = torch.einsum("bkgst,btkd->bkgsd", p.to(vc.dtype), vc)
                acc = acc * corr[..., None] + pv
                m_run = m_new
            out = acc / torch.clamp_min(l_run, 1e-20)[..., None]
            outs.append(out.permute(0, 3, 1, 2, 4))  # (B, qb, KV, G, D)
        out = torch.stack(outs, dim=1).reshape(B, S, H, D)
        return out.to(getattr(torch, self.dtype))

    # --------------------------------------------------------- public apply
    def apply(
        self,
        params: dict,
        x: torch.Tensor,
        *,
        positions: torch.Tensor,
        policy: Policy,
        window: int | None = None,
        q: dict | None = None,
        kv_override: tuple | None = None,  # (k, v, kv_positions) for cross
        return_kv: bool = False,
        n_valid: torch.Tensor | None = None,  # (B,) valid prefix lengths
    ):
        """Full-sequence attention (prefill).

        ``policy`` may be a PolicyMap: block-level decisions (BMM quant,
        flash eligibility) resolve at ``self.name`` while the q/k/v/o
        projections resolve at their own sub-sites inside qmatmul.

        ``n_valid``: bucketed prefill pads prompts to the bucket length;
        K/V rows at or past each row's valid length are zeroed so the
        returned ``return_kv`` tensors fill the cache exactly as an
        exact-length prefill would, and seq-axis quantizer group maxima see
        zeros, not pad-token projections.

        The flash kernel (``fused`` backend) is taken where ``flash_ok``
        holds — the reference's rule: the backend asks for it, no softcap,
        no cross-attention, S == T, and no attention-BMM QDQ.
        """
        pol = resolve_policy(policy, self.name)
        B, S, _ = x.shape
        qh, kh, vh = self._project_qkv(params, x, positions, policy, q)
        if n_valid is not None:
            steps = torch.arange(S, dtype=torch.int32, device=x.device)
            keep = (steps[None, :] < n_valid[:, None])[..., None, None]
            kh = kh * keep.to(kh.dtype)
            vh = vh * keep.to(vh.dtype)
        kv_pos = positions
        if kv_override is not None:
            kh, vh, kv_pos = kv_override
        T = kh.shape[1]
        if window is None:
            window = max(T, S) + 1
        use_block = (
            max(S, T) >= self.blockwise_min_seq
            and S % min(self.q_block, S) == 0
            and T % min(self.kv_block, T) == 0
        )
        # per-site backend: 'auto' keeps the module's opt-in flag;
        # 'fused'/'compressed' request the flash kernel ('compressed' has
        # no stored codes at prefill — dense flash is its prefill form);
        # 'ref' pins the plain paths
        backend = attention_backend(pol).name
        flash_want = (self.use_flash_kernel if backend == "auto"
                      else backend in ("fused", "compressed"))
        flash_ok = (
            flash_want
            and self.softcap is None
            and kv_override is None
            and S == T  # self-attention, standard causal layout
            and not (pol.enabled and pol.attn_bmm
                     and pol.input is not None)
        )
        if flash_ok:
            out = attn_backends()["fused"].fn(
                qh, kh, vh, scale=self._scale(), causal=self.causal,
                block_q=min(self.q_block, S), block_k=min(self.kv_block, T),
                q_offset=0,  # full-sequence self-attention: q starts at 0
            )
        else:
            fn = self._blockwise if use_block else self._reference
            # under a mesh each rank attends its own batch rows and heads
            out = shd.per_shard(fn, qh, kh, vh, positions, kv_pos, window,
                                policy, q=q)
        out = shd.constrain(out, ("batch", "seq", "heads", "head_dim"))
        y = self._dense("o", self.d_model,
                        self.n_heads * self.head_dim).apply(
            params["o"], out.reshape(B, S, -1), policy,
            q=None if q is None else q.get("o"))
        y = shd.constrain(y, ("batch", "seq_res", "embed"))
        if return_kv:
            return y, (kh.reshape(B, T, -1), vh.reshape(B, T, -1))
        return y

    def fill_cache(self, kh_flat, vh_flat, size: int,
                   policy: Policy | None = None) -> KVCache:
        """Build a ring-buffer cache from prefill K/V (B, S, flat).

        With ``policy.kv_cache == 'on_write'`` the entries are quantized
        here (K per head_dim group; V along seq — exact at prefill because
        the full sequence is present); with 'int8' they are stored as int8
        codes with per-(slot, head) scales."""
        if policy is not None:
            policy = resolve_policy(policy, self.name)
        B, S, F = kh_flat.shape
        dev = kh_flat.device
        if (policy is not None and policy.enabled and policy.attn_bmm
                and policy.input is not None
                and policy.kv_cache == "on_write"):
            kh4 = kh_flat.reshape(B, S, self.n_kv, self.head_dim)
            vh4 = vh_flat.reshape(B, S, self.n_kv, self.head_dim)
            kh4 = qdq_activation(kh4, policy.input, axis=-1,
                                 site=self.name + "/bmm_k")
            vh4 = qdq_activation(vh4, policy.input, axis=1,
                                 site=self.name + "/bmm_v")
            kh_flat = kh4.reshape(B, S, F)
            vh_flat = vh4.reshape(B, S, F)
        take = min(S, size)
        idx = torch.arange(S - take, S, device=dev) % size
        length = torch.tensor(S, dtype=torch.int32, device=dev)
        if policy is not None and policy.kv_cache == "int8":
            kc, ks = _kv_quantize(
                kh_flat.reshape(B, S, self.n_kv, self.head_dim))
            vc, vs = _kv_quantize(
                vh_flat.reshape(B, S, self.n_kv, self.head_dim))
            cache = self.init_cache(B, size, quantized=True, device=dev)
            cache.k[:, idx] = kc.reshape(B, S, F)[:, -take:]
            cache.v[:, idx] = vc.reshape(B, S, F)[:, -take:]
            cache.k_scale[:, idx] = ks[:, -take:]
            cache.v_scale[:, idx] = vs[:, -take:]
            return _constrain_kv(cache._replace(length=length))
        cache = self.init_cache(B, size, dtype=kh_flat.dtype, device=dev)
        cache.k[:, idx] = kh_flat[:, -take:]
        cache.v[:, idx] = vh_flat[:, -take:]
        return _constrain_kv(cache._replace(length=length))

    # ------------------------------------------------------------ decoding
    def init_cache(self, batch: int, max_len: int, dtype=None,
                   window: int | None = None, quantized: bool = False,
                   device="cuda") -> KVCache:
        """Ring-buffer cache of size min(max_len, window) (SWA truncates).

        ``quantized``: int8 codes + per-(slot, head) f32 scales."""
        size = max_len if window is None else min(max_len, window)
        flat = self.n_kv * self.head_dim
        length = torch.zeros((), dtype=torch.int32, device=device)
        if quantized:
            codes = lambda: torch.zeros((batch, size, flat), dtype=torch.int8,
                                        device=device)
            scales = lambda: torch.zeros((batch, size, self.n_kv),
                                         dtype=torch.float32, device=device)
            return KVCache(k=codes(), v=codes(), length=length,
                           k_scale=scales(), v_scale=scales())
        dt = dtype or getattr(torch, self.dtype)
        return KVCache(
            k=torch.zeros((batch, size, flat), dtype=dt, device=device),
            v=torch.zeros((batch, size, flat), dtype=dt, device=device),
            length=length,
        )

    def decode_step(
        self,
        params: dict,
        x: torch.Tensor,  # (B, 1, d_model)
        cache: KVCache,
        *,
        position,  # int32 scalar (aligned) or (B,) per-slot
        policy: Policy,
        window: int | None = None,
        q: dict | None = None,
    ) -> tuple[torch.Tensor, KVCache]:
        """One token per row against the ring buffer: write this token's
        K/V (in place) at ``position % size``, then attend over the slots
        whose absolute position is written and not in the future."""
        pol = resolve_policy(policy, self.name)
        B = x.shape[0]
        dev = x.device
        position = torch.as_tensor(position, dtype=torch.int32, device=dev)
        pos_vec = torch.broadcast_to(torch.atleast_1d(position), (B,))
        qh, kh, vh = self._project_qkv(params, x, pos_vec[:, None], policy,
                                       q)
        int8_cache = cache.k_scale is not None
        kv_on_write = (pol.enabled and pol.attn_bmm
                       and pol.input is not None
                       and pol.kv_cache == "on_write")
        if kv_on_write:
            # quantize ONCE at write time; reads skip the re-QDQ
            kh = qdq_activation(kh, pol.input, axis=-1,
                                site=self.name + "/bmm_k")
            vh = qdq_activation(vh, pol.input, axis=-1,
                                site=self.name + "/bmm_v")
        size = cache.k.shape[1]
        slot = (pos_vec % size).long()
        rows = torch.arange(B, device=dev)
        if int8_cache:
            # int8 storage: the quantization IS the write (per token, head)
            kc, ks = _kv_quantize(kh)  # kh: (B, 1, n_kv, D)
            vc, vs = _kv_quantize(vh)
            cache.k[rows, slot] = kc.reshape(B, -1)
            cache.v[rows, slot] = vc.reshape(B, -1)
            cache.k_scale[rows, slot] = ks[:, 0]
            cache.v_scale[rows, slot] = vs[:, 0]
        else:
            cache.k[rows, slot] = kh.reshape(B, -1).to(cache.k.dtype)
            cache.v[rows, slot] = vh.reshape(B, -1).to(cache.v.dtype)
        # length stays a scalar high-water mark even for vector positions
        cache = _constrain_kv(cache._replace(length=position.max() + 1))

        # absolute position stored in each slot of the ring buffer
        idx = torch.arange(size, dtype=torch.int32, device=dev)[None]
        slot_b = (pos_vec % size)[:, None]
        ring_rounds = torch.div(pos_vec, size,
                                rounding_mode="floor")[:, None] * size
        slot_pos = idx + torch.where(idx <= slot_b, ring_rounds,
                                     ring_rounds - size)
        unwritten = (slot_pos > pos_vec[:, None]) | (slot_pos < 0)
        slot_pos = torch.where(unwritten, torch.full_like(slot_pos, -1),
                               slot_pos)

        dt = getattr(torch, self.dtype)
        if window is None:
            window = size + 1
        qp = pos_vec[:, None]
        kp = slot_pos
        if self._use_compressed(pol, mode="int8" if int8_cache else "fp",
                                where="the ring-buffer cache"):
            # codes go straight to the kernel: reads stay 1 byte/element
            out = attn_backends()["compressed"].fn(
                self._quant_q(pol, qh, q),
                cache.k.reshape(B, size, self.n_kv, self.head_dim),
                cache.v.reshape(B, size, self.n_kv, self.head_dim),
                cache.k_scale, cache.v_scale, qp, kp, window,
                scale=self._scale(), causal=self.causal,
                probs_tq=self._attn_probs_tq(pol),
            ).to(dt)
        else:
            if int8_cache:
                kv = _kv_dequantize(cache.k, cache.k_scale, self.n_kv,
                                    self.head_dim, dt)
                vv = _kv_dequantize(cache.v, cache.v_scale, self.n_kv,
                                    self.head_dim, dt)
            else:
                kv = cache.k.reshape(B, size, self.n_kv, self.head_dim)
                vv = cache.v.reshape(B, size, self.n_kv, self.head_dim)
            out = self._reference(qh, kv, vv, qp, kp, window, policy, q=q,
                                  kv_prequant=kv_on_write or int8_cache)
        y = self._dense("o", self.d_model,
                        self.n_heads * self.head_dim).apply(
            params["o"], out.reshape(B, 1, -1), policy,
            q=None if q is None else q.get("o"))
        return shd.constrain(y, ("batch", "seq_res", "embed")), cache

    def chunk_step(
        self,
        params: dict,
        x: torch.Tensor,  # (B, S, d_model): an S-token verify/score chunk
        cache: KVCache,
        *,
        position,  # (B,) absolute position of x[:, 0] (or a scalar)
        n_valid,  # (B,) valid tokens in x (0 masks the row)
        policy: Policy,
        window: int | None = None,
        q: dict | None = None,
    ) -> tuple[torch.Tensor, KVCache]:
        """Write-then-attend over an S-token chunk against the ring buffer.

        The speculative verify pass: each chunk token attends to the whole
        cache plus the chunk's own earlier tokens (strictly causal), as S
        sequential ``decode_step`` calls would, and the returned
        activations cover every chunk position.  Tokens past a row's
        ``n_valid`` leave their slots untouched (a wrapped slot can still
        hold a live older position) and produce outputs the caller
        ignores.  The writes are in place.  Rolling back a rejection is
        the caller rewinding ``position``: entries past it are masked by
        the ring validity mask and overwritten by the next write.
        """
        pol = resolve_policy(policy, self.name)
        B, S, _ = x.shape
        dev = x.device
        size = cache.k.shape[1]
        if S > size:
            raise ValueError(
                f"chunk of {S} tokens exceeds the ring-buffer cache size "
                f"{size}; a chunk must not wrap over itself")
        position = torch.as_tensor(position, dtype=torch.int32, device=dev)
        pos_vec = torch.broadcast_to(torch.atleast_1d(position), (B,))
        n_valid = torch.as_tensor(n_valid, dtype=torch.int32, device=dev)
        steps = torch.arange(S, dtype=torch.int32, device=dev)[None]
        positions = pos_vec[:, None] + steps  # (B, S)
        qh, kh, vh = self._project_qkv(params, x, positions, policy, q)
        int8_cache = cache.k_scale is not None
        kv_on_write = (pol.enabled and pol.attn_bmm
                       and pol.input is not None
                       and pol.kv_cache == "on_write")
        if kv_on_write:
            kh = qdq_activation(kh, pol.input, axis=-1,
                                site=self.name + "/bmm_k")
            vh = qdq_activation(vh, pol.input, axis=-1,
                                site=self.name + "/bmm_v")
        rows = torch.arange(B, device=dev)[:, None]
        slot = (positions % size).long()  # (B, S)
        # invalid tail tokens (>= n_valid) keep their target slots as-is
        kf = (steps < n_valid[:, None])[..., None]  # (B, S, 1)

        def write(store, new):
            store[rows, slot] = torch.where(kf, new.to(store.dtype),
                                            store[rows, slot])

        if int8_cache:
            kc, ks = _kv_quantize(kh)  # per (token, head): rollback-exact
            vc, vs = _kv_quantize(vh)
            write(cache.k, kc.reshape(B, S, -1))
            write(cache.v, vc.reshape(B, S, -1))
            write(cache.k_scale, ks)
            write(cache.v_scale, vs)
        else:
            write(cache.k, kh.reshape(B, S, -1))
            write(cache.v, vh.reshape(B, S, -1))
        last = pos_vec + torch.clamp_min(n_valid, 1) - 1  # last written
        cache = _constrain_kv(cache._replace(length=last.max() + 1))

        # absolute position per ring slot (decode_step's formula at the
        # chunk's high-water mark)
        idx = torch.arange(size, dtype=torch.int32, device=dev)[None]
        slot_b = (last % size)[:, None]
        ring_rounds = torch.div(last, size,
                                rounding_mode="floor")[:, None] * size
        slot_pos = idx + torch.where(idx <= slot_b, ring_rounds,
                                     ring_rounds - size)
        unwritten = (slot_pos > last[:, None]) | (slot_pos < 0)
        slot_pos = torch.where(unwritten, torch.full_like(slot_pos, -1),
                               slot_pos)

        dt = getattr(torch, self.dtype)
        if window is None:
            window = size + 1
        if self._use_compressed(pol, mode="int8" if int8_cache else "fp",
                                where="the ring-buffer cache"):
            out = attn_backends()["compressed"].fn(
                self._quant_q(pol, qh, q),
                cache.k.reshape(B, size, self.n_kv, self.head_dim),
                cache.v.reshape(B, size, self.n_kv, self.head_dim),
                cache.k_scale, cache.v_scale, positions, slot_pos, window,
                scale=self._scale(), causal=self.causal,
                probs_tq=self._attn_probs_tq(pol),
            ).to(dt)
        else:
            if int8_cache:
                kv = _kv_dequantize(cache.k, cache.k_scale, self.n_kv,
                                    self.head_dim, dt)
                vv = _kv_dequantize(cache.v, cache.v_scale, self.n_kv,
                                    self.head_dim, dt)
            else:
                kv = cache.k.reshape(B, size, self.n_kv, self.head_dim)
                vv = cache.v.reshape(B, size, self.n_kv, self.head_dim)
            out = self._reference(qh, kv, vv, positions, slot_pos, window,
                                  policy, q=q,
                                  kv_prequant=kv_on_write or int8_cache)
        y = self._dense("o", self.d_model,
                        self.n_heads * self.head_dim).apply(
            params["o"], out.reshape(B, S, -1), policy,
            q=None if q is None else q.get("o"))
        return shd.constrain(y, ("batch", "seq_res", "embed")), cache

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
        q: dict | None = None,
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
        qh, kh, vh = self._project_qkv(params, x, positions, policy, q)
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
                self._quant_q(pol, qh, q), gk, gv, sk, sv,
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
                                  policy, q=q,
                                  kv_prequant=kv_on_write or mode != "fp")
        y = self._dense("o", self.d_model,
                        self.n_heads * self.head_dim).apply(
            params["o"], out.reshape(B, S, -1), policy,
            q=None if q is None else q.get("o"))
        return shd.constrain(y, ("batch", "seq_res", "embed")), cache
