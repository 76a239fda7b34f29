"""Decoder-only transformer LM for serving, with the INT-FP-QSim policy
threaded through every matmul.

Ported: parameter init, the embedding front, the LM head, full-sequence
``apply``, ``prefill`` into ring-buffer caches, the fixed-slot
``decode_step``, the paged serving step (``init_paged_state`` /
``paged_step``), the next-token losses (``cross_entropy``,
``chunked_lm_loss``), for the dense attention family and the MoE family
(every block's FFN a top-k ``nn.moe.MoE``: ``apply`` returns the summed
Switch aux loss, ``expert_loads`` the routed-token counts per layer and
expert).  The state-space family (``ssm_state > 0``: every block a
pre-norm Mamba2 mixer) has ``apply``, an exact-length ``prefill`` and
``decode_step`` over per-layer ``SSMCache``s; it has no paged state.
``apply`` and ``prefill`` take ``prefix_embeds`` (the VLM family's stub
patch embeddings, prepended to the token embeddings before the positions
are formed; decode after such a prefill simply continues at position
``n_prefix + len(prompt)``).  Every forward takes the static-scale q tree
(``q=``) of the PTQ passes.  Layers are always a Python list of per-layer
dicts with sites ``blocks.{i}/...`` — there is no scan — so layer-indexed
PolicyMap rules always resolve.  ``chunk_step`` scores a token chunk
against the ring (the speculative verify pass).  Under a gradient each
block is rematerialized as ``cfg.remat`` says (``remat_block``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantPolicy, kv_cache_mode
from repro_torch.dist import sharding as shd
from repro_torch.nn.attention import Attention
from repro_torch.nn.ffn import MLP
from repro_torch.nn.linear import Dense, Embed
from repro_torch.nn.moe import MoE
from repro_torch.nn.module import require_device, truncated_normal
from repro_torch.nn.norms import LayerNorm, RMSNorm
from repro_torch.nn.ssm import mamba_from_config

GLOBAL_WINDOW = 1 << 30
NEG_INF = -1e9


class PagedState(NamedTuple):
    """Paged KV serving state: the shared page pool + the page table.

    ``cache``: a list with one ``PagedKVCache`` per layer — one physical
    pool per layer, indexed by the SAME page table (a page index addresses
    the same slot in every layer's store).  The pools are updated in place
    by every paged step.
    ``table``: (B, max_pages_per_seq) int32 physical page per logical
    page, -1 where unmapped; owned/updated host-side by the engine's
    admission control, read by every paged step.
    """

    cache: Any  # list[PagedKVCache], one per layer
    table: torch.Tensor  # (B, n_logical) int32


class DecodeState(NamedTuple):
    """Per-layer caches + absolute position.

    Exactly one of kv / ssm / pages is populated: the fixed-slot ring
    buffer (a list with one ``KVCache`` per layer), the SSM family's
    recurrent state (a list with one ``SSMCache`` per layer) or the paged
    KV pool.
    """

    kv: Any  # list[KVCache], or None
    ssm: Any  # list[SSMCache], or None
    position: torch.Tensor  # int32 scalar (aligned) or (B,) per-slot
    pages: Any = None  # PagedState, or None


def _norm(cfg: ArchConfig):
    if cfg.norm == "ln":
        return LayerNorm(cfg.d_model, param_dtype=cfg.param_dtype,
                         dtype=cfg.dtype)
    return RMSNorm(cfg.d_model, plus_one=cfg.norm_plus_one,
                   param_dtype=cfg.param_dtype, dtype=cfg.dtype)


@dataclasses.dataclass(frozen=True)
class TransformerLM:
    cfg: ArchConfig

    @property
    def is_ssm(self) -> bool:
        return self.cfg.ssm_state > 0

    @property
    def is_moe(self) -> bool:
        return self.cfg.family == "moe" and self.cfg.n_experts > 0

    # ------------------------------------------------------ layer factories
    def _attention(self, name: str = "attn") -> Attention:
        c = self.cfg
        return Attention(
            d_model=c.d_model, n_heads=c.n_heads, n_kv=c.n_kv,
            head_dim=c.head_dim_, qkv_bias=c.qkv_bias,
            rope_theta=c.rope_theta, use_rope=(c.pos == "rope"),
            softcap=c.attn_softcap, param_dtype=c.param_dtype, dtype=c.dtype,
            q_block=c.q_block, kv_block=c.kv_block, name=name,
        )

    def _mlp(self, name: str = "ffn") -> MLP:
        c = self.cfg
        return MLP(c.d_model, c.d_ff, act=c.act, param_dtype=c.param_dtype,
                   dtype=c.dtype, name=name)

    def _moe(self, name: str = "ffn") -> MoE:
        c = self.cfg
        return MoE(
            c.d_model, c.d_ff, n_experts=c.n_experts, top_k=c.top_k,
            capacity_factor=c.capacity_factor,
            group_tokens=c.moe_group_tokens, act=c.act,
            param_dtype=c.param_dtype, dtype=c.dtype, name=name,
        )

    def _head(self) -> Dense:
        c = self.cfg
        return Dense(c.d_model, c.vocab_padded, param_dtype=c.param_dtype,
                     dtype=c.dtype, name="lm_head", in_axis="embed",
                     out_axis="vocab")

    def _embed(self) -> Embed:
        c = self.cfg
        return Embed(c.vocab_padded, c.d_model, param_dtype=c.param_dtype,
                     dtype=c.dtype)

    def _mamba(self, name: str = "mamba"):
        return mamba_from_config(self.cfg, name)

    # ----------------------------------------------------------------- init
    def _block_init(self, gen, device) -> dict:
        c = self.cfg
        if self.is_ssm:
            return {"ln": _norm(c).init(gen, device),
                    "mamba": self._mamba().init(gen, device)}
        p = {
            "ln1": _norm(c).init(gen, device),
            "attn": self._attention().init(gen, device),
            "ln2": _norm(c).init(gen, device),
            "ffn": (self._moe() if self.is_moe else self._mlp()).init(
                gen, device),
        }
        if c.post_norms:
            p["ln1_post"] = _norm(c).init(gen, device)
            p["ln2_post"] = _norm(c).init(gen, device)
        return p

    def init(self, gen: torch.Generator, device="cuda") -> dict:
        """Random parameters drawn from ``gen`` on ``device``: a nested
        dict of tensors, ``blocks`` a list of per-layer dicts."""
        c = self.cfg
        device = require_device(device)
        params: dict = {
            "embed": self._embed().init(gen, device),
            "final_norm": _norm(c).init(gen, device),
            "blocks": [self._block_init(gen, device)
                       for _ in range(c.n_layers)],
        }
        if not c.tied_embeddings:
            params["lm_head"] = self._head().init(gen, device)
        if c.pos == "learned":
            params["pos_embed"] = truncated_normal(
                gen, (c.max_position, c.d_model),
                getattr(torch, c.param_dtype), 0.02, device)
        return params

    def _block_axes(self) -> dict:
        c = self.cfg
        if self.is_ssm:
            return {"ln": _norm(c).axes(), "mamba": self._mamba().axes()}
        p = {
            "ln1": _norm(c).axes(),
            "attn": self._attention().axes(),
            "ln2": _norm(c).axes(),
            "ffn": (self._moe() if self.is_moe else self._mlp()).axes(),
        }
        if c.post_norms:
            p["ln1_post"] = _norm(c).axes()
            p["ln2_post"] = _norm(c).axes()
        return p

    def param_axes(self) -> dict:
        """The logical axes of ``init``'s tree, leaf for leaf (the
        reference's ``axes_of(init(...))`` with its blocks listed)."""
        c = self.cfg
        axes: dict = {
            "embed": self._embed().axes(),
            "final_norm": _norm(c).axes(),
            "blocks": [self._block_axes() for _ in range(c.n_layers)],
        }
        if not c.tied_embeddings:
            axes["lm_head"] = self._head().axes()
        if c.pos == "learned":
            axes["pos_embed"] = ("seq", "embed")
        return axes

    # ------------------------------------------------------------- windows
    def layer_windows_py(self):
        """Python-int per-layer attention windows."""
        c = self.cfg
        if c.alt_local_global:
            return [
                (c.window or GLOBAL_WINDOW) if i % 2 == 0 else GLOBAL_WINDOW
                for i in range(c.n_layers)
            ]
        if c.window:
            return [c.window] * c.n_layers
        return [GLOBAL_WINDOW] * c.n_layers

    # ------------------------------------------------------------- embed in
    def _embed_in(self, params, tokens, prefix_embeds=None, pos_offset=0):
        c = self.cfg
        x = self._embed().apply(params["embed"], tokens)
        if c.norm_plus_one:  # gemma convention: scale embeddings by sqrt(d)
            x = x * c.d_model**0.5
        if prefix_embeds is not None:  # before the positions are formed
            x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
        B, S = x.shape[0], x.shape[1]
        po = torch.as_tensor(pos_offset, dtype=torch.int32, device=x.device)
        if po.ndim == 1:  # per-row offsets (continuous-batching decode)
            po = po[:, None]
        positions = po + torch.arange(
            S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        positions = shd.constrain(positions, ("batch", None))
        if c.pos == "learned":
            x = x + shd.take_rows(params["pos_embed"], positions).to(x.dtype)
        elif c.pos == "sinusoidal":
            x = x + _sinusoid_at(positions, c.d_model).to(x.dtype)
        return shd.constrain(x, ("batch", "seq_res", "embed")), positions

    # ----------------------------------------------------------------- head
    def head_logits(self, params, x, policy):
        c = self.cfg
        if c.tied_embeddings:
            logits = self._embed().attend(params["embed"], x, policy)
        else:
            logits = self._head().apply(params["lm_head"], x, policy)
        if c.final_softcap:
            logits = c.final_softcap * torch.tanh(logits / c.final_softcap)
        if c.vocab_padded != c.vocab:
            logits = mask_padding(logits, c.vocab)
        return logits

    # --------------------------------------------------------------- blocks
    def _block_apply(self, bparams, x, policy, name: str, attend, q=None):
        """One decoder block -> (x, aux loss, expert load).  ``attend(attn,
        attn_params, h, q_attn)`` runs the attention half — full sequence,
        ring-buffer decode or paged — and returns its output; the rest of
        the block is the same for all.  ``q``: this block's slice of the
        static-scale q tree, or None.  The aux loss and the load (the MoE
        block's routed tokens per expert) are None outside the MoE
        family."""
        c = self.cfg
        getq = (lambda k: None) if q is None else q.get
        if self.is_ssm:  # a pre-norm Mamba2 mixer; ``attend`` is not used
            h = _norm(c).apply(bparams["ln"], x)
            return x + self._mamba(f"{name}/mamba").apply(
                bparams["mamba"], h, policy, q=getq("mamba")), None, None
        h = _norm(c).apply(bparams["ln1"], x)
        h = attend(self._attention(f"{name}/attn"), bparams["attn"], h,
                   getq("attn"))
        if c.post_norms:
            h = _norm(c).apply(bparams["ln1_post"], h)
        x = x + h
        h = _norm(c).apply(bparams["ln2"], x)
        aux = load = None
        if self.is_moe:
            h, metrics = self._moe(f"{name}/ffn").apply(
                bparams["ffn"], h, policy, q=getq("ffn"))
            aux, load = metrics["moe_aux_loss"], metrics["expert_load"]
        else:
            h = self._mlp(f"{name}/ffn").apply(bparams["ffn"], h, policy,
                                               q=getq("ffn"))
        if c.post_norms:
            h = _norm(c).apply(bparams["ln2_post"], h)
        return x + h, aux, load

    def _run_blocks(self, params, x, policy, attend, q=None, loads=None):
        """Every block in order -> (x, the summed aux loss, None outside the
        MoE family); ``attend(i, window, attn, attn_params, h, q_attn)``
        as in ``_block_apply`` with the layer index and window.  ``q``: the
        static-scale q tree ``{"blocks": [per-layer dict]}``; ``loads``: a
        list that gets each MoE block's expert load.  Under grad mode each
        block is rematerialized as ``cfg.remat`` says (``remat_block``)."""
        wl = self.layer_windows_py()
        aux = None
        block = remat_block(self.cfg.remat, self._block_apply)
        for i, bp in enumerate(params["blocks"]):
            qi = None if q is None else q["blocks"][i]
            x, a, load = block(
                bp, x, policy, f"blocks.{i}",
                lambda attn, ap, h, qa, i=i: attend(i, int(wl[i]), attn, ap,
                                                    h, qa), q=qi)
            if a is not None:
                aux = a if aux is None else aux + a
            if loads is not None:
                loads.append(load)
        return x, aux

    def _last_valid(self, x, n_valid):
        """Each row's hidden state at its last valid position (B, 1, d)."""
        B = x.shape[0]
        sel = torch.clamp_min(n_valid - 1, 0).long()[:, None, None]
        return torch.gather(x, 1, sel.expand(B, 1, x.shape[-1]))

    # ---------------------------------------------------------------- apply
    def apply(self, params, tokens, *, policy=QuantPolicy(), q=None,
              prefix_embeds=None, return_hidden: bool = False):
        """Full-sequence forward: (logits (B, P + S, vocab_padded), aux
        loss).  ``q``: static-scale q tree (calibrated activation alphas);
        ``prefix_embeds``: (B, P, d_model) embeddings put before the
        tokens."""
        x, positions = self._embed_in(params, tokens, prefix_embeds)
        x, aux = self._run_blocks(params, x, policy,
                                  self._full_attention(positions, policy), q)
        if aux is None:
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        x = _norm(self.cfg).apply(params["final_norm"], x)
        if return_hidden:
            return x, aux
        return self.head_logits(params, x, policy), aux

    @staticmethod
    def _full_attention(positions, policy):
        """``_run_blocks``' ``attend`` of a full sequence at ``positions``."""
        return lambda i, w, attn, ap, h, qa: attn.apply(
            ap, h, positions=positions, policy=policy, window=w, q=qa)

    # -------------------------------------------------------- routing probe
    @torch.no_grad()
    def expert_loads(self, params, tokens, *,
                     policy=QuantPolicy()) -> torch.Tensor:
        """Routed-token counts per expert: ``(n_layers, n_experts)`` f32.

        A routing-frequency probe for the serve-side expert store: runs the
        block stack forward and collects each MoE block's post-capacity
        ``expert_load`` metric; ``tokens`` is ``(B, S)`` and loads sum over
        the whole batch.
        """
        if not self.is_moe:
            raise TypeError(
                f"expert_loads: {self.cfg.name!r} is not an MoE config")
        x, positions = self._embed_in(params, tokens)
        loads = []
        self._run_blocks(params, x, policy,
                         self._full_attention(positions, policy),
                         loads=loads)
        return torch.stack(loads, dim=0)

    # -------------------------------------------------------------- prefill
    @torch.no_grad()
    def prefill(self, params, tokens, *, policy=QuantPolicy(),
                max_len: int | None = None, prefix_embeds=None,
                n_valid=None):
        """Forward pass that also builds the ring-buffer decode caches.

        Returns (last-position logits (B, vocab_padded), DecodeState).

        ``n_valid`` ((B,) int32) supports bucketed prefill: ``tokens`` is
        right-padded to a bucket length, K/V cache rows past each row's
        valid length are zeroed (see ``Attention.apply``) and the logits
        are taken at position ``n_valid - 1`` — token-identical to an
        exact-length prefill.  Attention family only: an SSM's recurrence
        would integrate the padded tail into its state, so SSM models
        prefill at exact length and ``n_valid`` raises there.
        """
        c = self.cfg
        kv_cache_mode(policy)  # cache storage is engine-global: reject
        # maps whose rules disagree on it here, with a clear error
        if self.is_ssm:
            if n_valid is not None:
                raise ValueError(
                    "bucketed prefill (n_valid) is attention-family only: "
                    "SSM recurrence integrates the padded tail into the "
                    "state; prefill SSM models at exact length")
            return self._ssm_prefill(params, tokens, policy, prefix_embeds)
        x, positions = self._embed_in(params, tokens, prefix_embeds)
        B, S = x.shape[0], x.shape[1]
        if n_valid is not None:
            n_valid = torch.as_tensor(n_valid, dtype=torch.int32,
                                      device=x.device)
        max_len = max_len or S
        eff_window = c.window if (c.window and not c.alt_local_global) \
            else None
        cache_size = max_len if eff_window is None \
            else min(max_len, eff_window)
        caches = []

        def attend(i, w, attn, ap, h, qa):
            h, (kf, vf) = attn.apply(ap, h, positions=positions,
                                     policy=policy, window=w,
                                     return_kv=True, n_valid=n_valid)
            caches.append(attn.fill_cache(kf, vf, cache_size,
                                          policy=policy))
            return h

        x, _ = self._run_blocks(params, x, policy, attend)
        if n_valid is None:
            pos = torch.tensor(S, dtype=torch.int32, device=x.device)
            x = x[:, -1:, :]
        else:  # last VALID position per row, not the padded column
            pos = n_valid
            x = self._last_valid(x, n_valid)
        state = DecodeState(kv=caches, ssm=None, position=pos)
        x = _norm(c).apply(params["final_norm"], x)
        logits = self.head_logits(params, x, policy)
        return logits[:, 0], state

    def _ssm_prefill(self, params, tokens, policy, prefix_embeds=None):
        """The SSM family's prefill: every block's cache after the prompt."""
        x, _ = self._embed_in(params, tokens, prefix_embeds)
        caches = []
        for i, bp in enumerate(params["blocks"]):
            h = _norm(self.cfg).apply(bp["ln"], x)
            h, cache = self._mamba(f"blocks.{i}/mamba").apply(
                bp["mamba"], h, policy, return_cache=True)
            x = x + h
            caches.append(cache)
        state = DecodeState(kv=None, ssm=caches, position=torch.tensor(
            x.shape[1], dtype=torch.int32, device=x.device))
        x = _norm(self.cfg).apply(params["final_norm"], x[:, -1:, :])
        return self.head_logits(params, x, policy)[:, 0], state

    # --------------------------------------------------------------- decode
    def init_decode_state(self, batch: int, max_len: int,
                          kv_quant: bool = False,
                          device="cuda") -> DecodeState:
        """Ring-buffer caches (one per layer, all sized by the config's
        window policy: SWA truncates), or for the SSM family one zero
        ``SSMCache`` per layer, and an aligned position 0."""
        c = self.cfg
        device = require_device(device)
        if self.is_ssm:
            m, dt = self._mamba(), getattr(torch, c.dtype)
            return DecodeState(
                kv=None, ssm=[m.init_cache(batch, dtype=dt, device=device)
                              for _ in range(c.n_layers)],
                position=torch.zeros((), dtype=torch.int32, device=device))
        eff_window = c.window if (c.window and not c.alt_local_global) \
            else None
        attn = self._attention()
        kv = [attn.init_cache(batch, max_len, dtype=getattr(torch, c.dtype),
                              window=eff_window, quantized=kv_quant,
                              device=device)
              for _ in range(c.n_layers)]
        return DecodeState(
            kv=kv, ssm=None,
            position=torch.zeros((), dtype=torch.int32, device=device))

    @torch.no_grad()
    def decode_step(self, params, token, state: DecodeState, *,
                    policy=QuantPolicy(), q=None):
        """token: (B, 1) -> (logits (B, vocab_padded), new state).  The ring
        caches are updated in place (an SSM's caches are replaced);
        ``position`` advances by one."""
        pos = state.position
        x, _ = self._embed_in(params, token, pos_offset=pos)
        if self.is_ssm:
            ssm = []
            for i, bp in enumerate(params["blocks"]):
                qi = None if q is None else q["blocks"][i].get("mamba")
                h = _norm(self.cfg).apply(bp["ln"], x)
                h, cache = self._mamba(f"blocks.{i}/mamba").decode_step(
                    bp["mamba"], h, state.ssm[i], policy=policy, q=qi)
                x = x + h
                ssm.append(cache)
            x = _norm(self.cfg).apply(params["final_norm"], x)
            return self.head_logits(params, x, policy)[:, 0], DecodeState(
                kv=None, ssm=ssm, position=pos + 1)
        caches = []

        def attend(i, w, attn, ap, h, qa):
            h, cache = attn.decode_step(ap, h, state.kv[i], position=pos,
                                        policy=policy, window=w, q=qa)
            caches.append(cache)
            return h

        x, _ = self._run_blocks(params, x, policy, attend, q)
        new_state = DecodeState(kv=caches, ssm=None, position=pos + 1)
        x = _norm(self.cfg).apply(params["final_norm"], x)
        logits = self.head_logits(params, x, policy)
        return logits[:, 0], new_state

    @torch.no_grad()
    def chunk_step(self, params, tokens, state: DecodeState, *,
                   n_valid, policy=QuantPolicy(), q=None):
        """Score a (B, S) token chunk against the fixed-slot KV cache.

        The speculative verify pass: S sequential ``decode_step`` calls
        under teacher forcing in one pass, returning logits at EVERY chunk
        position (B, S, vocab_padded).  Rows score their first ``n_valid``
        tokens; ``n_valid = 0`` masks a row.  The ring caches are updated
        in place and ``position`` advances by ``n_valid`` per row — the
        caller rolls back a rejected suffix by resetting positions.
        Attention family only: SSM recurrent state cannot rewind.
        """
        c = self.cfg
        if self.is_ssm:
            raise TypeError(
                "chunk_step is attention-family only; SSM recurrent state "
                f"cannot roll back a rejected draft suffix ({c.name})")
        pos = torch.as_tensor(state.position, dtype=torch.int32,
                              device=tokens.device)
        n_valid = torch.as_tensor(n_valid, dtype=torch.int32,
                                  device=tokens.device)
        x, _ = self._embed_in(params, tokens, pos_offset=pos)
        caches = []

        def attend(i, w, attn, ap, h, qa):
            h, cache = attn.chunk_step(ap, h, state.kv[i], position=pos,
                                       n_valid=n_valid, policy=policy,
                                       window=w, q=qa)
            caches.append(cache)
            return h

        x, _ = self._run_blocks(params, x, policy, attend, q)
        new_state = DecodeState(kv=caches, ssm=None, position=pos + n_valid)
        x = _norm(c).apply(params["final_norm"], x)
        return self.head_logits(params, x, policy), new_state

    # ---------------------------------------------------------- paged decode
    def init_paged_state(self, batch: int, *, page_size: int, n_pages: int,
                         max_pages_per_seq: int, kv: str = "fp",
                         device="cuda") -> DecodeState:
        """Paged serving state: one physical page pool per layer plus the
        per-slot page table (all -1 = nothing mapped), per-row positions.

        ``kv``: page storage — 'fp' (native dtype), 'int8' or 'fp8' codes
        with per-(page, head) scales.  Attention family only.
        """
        c = self.cfg
        if self.is_ssm:
            raise TypeError(
                "paged KV serving is attention-family only; SSM state is "
                f"O(1) per sequence and needs no pages ({c.name})")
        device = require_device(device)
        attn = self._attention()
        cache = [attn.init_paged_cache(n_pages, page_size,
                                       dtype=getattr(torch, c.dtype), kv=kv,
                                       device=device)
                 for _ in range(c.n_layers)]
        table = torch.full((batch, max_pages_per_seq), -1,
                           dtype=torch.int32, device=device)
        return DecodeState(
            kv=None, ssm=None,
            position=torch.zeros((batch,), dtype=torch.int32, device=device),
            pages=PagedState(cache=cache, table=table),
        )

    @torch.no_grad()
    def paged_step(self, params, tokens, state: DecodeState, *,
                   n_valid, policy=QuantPolicy(), q=None,
                   all_logits: bool = False):
        """One paged serving step over a (B, S) token chunk.

        S = 1 is a decode tick over every slot; S = chunk is one chunked-
        prefill tile for a prefilling slot (other rows masked with
        ``n_valid = 0``).  Writes the chunk's K/V into the pages mapped by
        ``state.pages.table`` (the pools are updated in place), attends
        over each row's gathered pages and returns (logits at each row's
        last valid token, new state) with ``position`` advanced by
        ``n_valid``.

        ``all_logits``: return logits at EVERY chunk position (B, S,
        vocab) instead of the last valid one.
        """
        c = self.cfg
        if state.pages is None:
            raise TypeError("paged_step needs a DecodeState from "
                            "init_paged_state (state.pages is None)")
        n_valid = n_valid.to(torch.int32)
        pos = state.position.to(torch.int32)
        table = state.pages.table
        x, _ = self._embed_in(params, tokens, pos_offset=pos)
        caches = []

        def attend(i, w, attn, ap, h, qa):
            h, cache = attn.paged_step(
                ap, h, state.pages.cache[i], page_table=table, position=pos,
                n_valid=n_valid, policy=policy, window=w, q=qa)
            caches.append(cache)
            return h

        x, _ = self._run_blocks(params, x, policy, attend, q)
        new_state = DecodeState(
            kv=None, ssm=None, position=pos + n_valid,
            pages=PagedState(cache=caches, table=table),
        )
        if all_logits:
            x = _norm(c).apply(params["final_norm"], x)
            return self.head_logits(params, x, policy), new_state
        x = _norm(c).apply(params["final_norm"], self._last_valid(x, n_valid))
        logits = self.head_logits(params, x, policy)
        return logits[:, 0], new_state


def _save_matmuls(ctx, op, *args, **kwargs):
    """The "dots" policy: keep the outputs of the weight contractions
    (``aten.mm`` / ``aten.addmm``: no batch dimension) and recompute the
    rest, attention's batched products included — the reference's
    ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(remat: str, fn):
    """``fn`` (a block) under the config's rematerialization: "none" keeps
    every activation, "full" recomputes the whole block in the backward,
    "dots" keeps only the weight contractions' outputs.  Only where a
    graph is built: under grad mode with an input that requires grad (a
    train step's embeddings always do; a served step's never do, and it
    pays one flag test a block).  Memory changes, the numbers do not."""
    if remat == "none":
        return fn
    if remat not in ("full", "dots"):
        raise ValueError(f"remat must be 'none', 'full' or 'dots', got "
                         f"{remat!r}")

    def block(bp, x, *args, **kw):
        if not (x.requires_grad and torch.is_grad_enabled()):
            return fn(bp, x, *args, **kw)
        extra = {}
        if remat == "dots":
            extra["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _save_matmuls)
        return checkpoint(fn, bp, x, *args, use_reentrant=False, **extra,
                          **kw)

    return block


@functools.lru_cache(maxsize=8)
def _sinusoid_table(S: int, d: int) -> np.ndarray:
    """The reference's ``_sinusoid(S, d)`` table, formed on the host as the
    reference's compiled arithmetic forms it: XLA folds the table into a
    constant, with ``10000 ** (dim / d)`` correctly rounded to f32 and the
    division by it taken as a product with its f32 reciprocal — both bit
    for bit here (numpy, float64 rounded once).  XLA's own sin and cos are
    not correctly rounded: the sines and cosines here (float64, rounded
    once) are within one unit in the last place of the reference's, and
    differ in about 1.3 % of the entries.  torch's f32 ``pow``, division,
    ``sin`` and ``cos`` on the CPU would move a quarter of them, by up to
    an ulp of the angle; the table is the same bits on every device."""
    pos = np.arange(S, dtype=np.float32)[:, None]
    expo = np.arange(0, d, 2, dtype=np.float32)[None] / np.float32(d)
    den = np.power(10000.0, expo.astype(np.float64)).astype(np.float32)
    angle = (pos * (np.float32(1.0) / den)).astype(np.float64)
    out = np.zeros((S, d), dtype=np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    out.setflags(write=False)
    return out


def _sinusoid(S: int, d: int, device="cpu") -> torch.Tensor:
    """Sinusoidal embeddings of positions 0 .. S-1 -> (S, d) f32 on
    ``device`` (the encoder's positions; see ``_sinusoid_table``)."""
    return torch.from_numpy(_sinusoid_table(S, d).copy()).to(device)


def _sinusoid_at(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal embeddings for explicit (B, S) positions -> (B, S, d)."""
    pos = positions.to(torch.float32)[..., None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=positions.device)
    angle = pos / torch.pow(torch.tensor(10000.0, device=positions.device),
                            dim / d)  # (B, S, d/2)
    out = torch.zeros(positions.shape + (d,), dtype=torch.float32,
                      device=positions.device)
    out[..., 0::2] = torch.sin(angle)
    out[..., 1::2] = torch.cos(angle)
    return out


def mask_padding(logits: torch.Tensor, n: int) -> torch.Tensor:
    """``logits`` with the columns from ``n`` on (the padded vocabulary or
    classes) set to NEG_INF, as the reference's ``jnp.where``; under
    ``use_rules`` the mask takes the vocabulary's layout."""
    pad = torch.arange(logits.shape[-1], device=logits.device) >= n
    return torch.where(shd.constrain(pad, ("vocab",)), NEG_INF, logits)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------
def _nll_sum(logits, labels):
    """(summed NLL over the labels >= 0, their count).  Under ``use_rules``
    the vocabulary is gathered first (logits arrive sharded over it): the
    gold logit's gather and the logsumexp read whole rows."""
    mask = labels >= 0
    lab = torch.clamp_min(labels, 0).long()
    lf = shd.constrain(logits.to(torch.float32), ("batch", "seq", None))
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, lab[..., None])[..., 0]
    return ((logz - gold) * mask).sum(), mask.sum()


def cross_entropy(logits, labels, vocab: int):
    """Mean CE over tokens; labels == -1 are masked."""
    nll, cnt = _nll_sum(logits, labels)
    return nll / torch.clamp_min(cnt, 1)


def chunked_lm_loss(model: TransformerLM, params, hidden, labels, policy,
                    chunk: int):
    """CE over seq chunks so (S, vocab) logits never materialize."""
    hidden = shd.constrain(hidden, ("batch", "seq", "embed"))
    B, S, D = hidden.shape
    chunk = min(chunk, S)
    assert S % chunk == 0
    nll = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.int64, device=hidden.device)
    for c0 in range(0, S, chunk):
        logits = model.head_logits(params, hidden[:, c0:c0 + chunk], policy)
        n, k = _nll_sum(logits, labels[:, c0:c0 + chunk])
        nll, cnt = nll + n, cnt + k
    return nll / torch.clamp_min(cnt, 1)
