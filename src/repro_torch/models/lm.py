"""Decoder-only transformer LM for paged serving, with the INT-FP-QSim
policy threaded through every matmul.

Ported so far: parameter init, the embedding front, the LM head and the
paged serving step (``init_paged_state`` / ``paged_step``) for the dense
attention family.  Layers are always a Python list of per-layer dicts with
sites ``blocks.{i}/...`` — there is no scan — so layer-indexed PolicyMap
rules always resolve.  Full-sequence ``apply``, prefill, the ring-buffer
decode and the MoE/SSM blocks wait for their slices.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.nn.attention import Attention
from repro_torch.nn.ffn import MLP
from repro_torch.nn.linear import Dense, Embed
from repro_torch.nn.module import require_device, truncated_normal
from repro_torch.nn.norms import LayerNorm, RMSNorm

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

    Only ``pages`` (the paged KV pool) is populated by the ported paths;
    ``kv`` / ``ssm`` keep the reference's field layout for the ring-buffer
    and SSM slices.
    """

    kv: Any
    ssm: Any
    position: torch.Tensor  # (B,) int32 per-slot
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

    def __post_init__(self):
        c = self.cfg
        if c.ssm_state > 0 or (c.family == "moe" and c.n_experts > 0):
            raise NotImplementedError(
                f"{c.name}: SSM and MoE blocks are not ported yet "
                "(ROADMAP.md Queue A); the dense attention family is")

    # ------------------------------------------------------ layer factories
    def _attention(self, name: str = "attn") -> Attention:
        c = self.cfg
        return Attention(
            d_model=c.d_model, n_heads=c.n_heads, n_kv=c.n_kv,
            head_dim=c.head_dim_, qkv_bias=c.qkv_bias,
            rope_theta=c.rope_theta, use_rope=(c.pos == "rope"),
            softcap=c.attn_softcap, param_dtype=c.param_dtype, dtype=c.dtype,
            name=name,
        )

    def _mlp(self, name: str = "ffn") -> MLP:
        c = self.cfg
        return MLP(c.d_model, c.d_ff, act=c.act, param_dtype=c.param_dtype,
                   dtype=c.dtype, name=name)

    def _head(self) -> Dense:
        c = self.cfg
        return Dense(c.d_model, c.vocab_padded, param_dtype=c.param_dtype,
                     dtype=c.dtype, name="lm_head")

    def _embed(self) -> Embed:
        c = self.cfg
        return Embed(c.vocab_padded, c.d_model, param_dtype=c.param_dtype,
                     dtype=c.dtype)

    # ----------------------------------------------------------------- init
    def _block_init(self, gen, device) -> dict:
        c = self.cfg
        p = {
            "ln1": _norm(c).init(gen, device),
            "attn": self._attention().init(gen, device),
            "ln2": _norm(c).init(gen, device),
            "ffn": self._mlp().init(gen, device),
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
    def _embed_in(self, params, tokens, pos_offset=0):
        c = self.cfg
        x = self._embed().apply(params["embed"], tokens)
        if c.norm_plus_one:  # gemma convention: scale embeddings by sqrt(d)
            x = x * c.d_model**0.5
        B, S = x.shape[0], x.shape[1]
        po = torch.as_tensor(pos_offset, dtype=torch.int32, device=x.device)
        if po.ndim == 1:  # per-row offsets (continuous-batching decode)
            po = po[:, None]
        positions = po + torch.arange(
            S, dtype=torch.int32, device=x.device)[None].expand(B, S)
        if c.pos == "learned":
            x = x + params["pos_embed"][positions.long()].to(x.dtype)
        elif c.pos == "sinusoidal":
            x = x + _sinusoid_at(positions, c.d_model).to(x.dtype)
        return x, positions

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
            logits = logits.clone()
            logits[..., c.vocab:] = NEG_INF
        return logits

    # ---------------------------------------------------------- paged decode
    def init_paged_state(self, batch: int, *, page_size: int, n_pages: int,
                         max_pages_per_seq: int, kv: str = "fp",
                         device="cuda") -> DecodeState:
        """Paged serving state: one physical page pool per layer plus the
        per-slot page table (all -1 = nothing mapped), per-row positions.

        ``kv``: page storage — 'fp' (native dtype), 'int8' or 'fp8' codes
        with per-(page, head) scales.
        """
        c = self.cfg
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
                   n_valid, policy=QuantPolicy(), all_logits: bool = False):
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
        B = tokens.shape[0]
        wl = self.layer_windows_py()
        caches = []
        for i, bp in enumerate(params["blocks"]):
            name = f"blocks.{i}"
            h = _norm(c).apply(bp["ln1"], x)
            h, cnew = self._attention(f"{name}/attn").paged_step(
                bp["attn"], h, state.pages.cache[i], page_table=table,
                position=pos, n_valid=n_valid, policy=policy,
                window=int(wl[i]),
            )
            caches.append(cnew)
            if c.post_norms:
                h = _norm(c).apply(bp["ln1_post"], h)
            x = x + h
            h = _norm(c).apply(bp["ln2"], x)
            h = self._mlp(f"{name}/ffn").apply(bp["ffn"], h, policy)
            if c.post_norms:
                h = _norm(c).apply(bp["ln2_post"], h)
            x = x + h

        new_state = DecodeState(
            kv=None, ssm=None, position=pos + n_valid,
            pages=PagedState(cache=caches, table=table),
        )
        if all_logits:
            x = _norm(c).apply(params["final_norm"], x)
            return self.head_logits(params, x, policy), new_state
        sel = torch.clamp_min(n_valid - 1, 0).long()[:, None, None]
        x = torch.gather(x, 1, sel.expand(B, 1, x.shape[-1]))
        x = _norm(c).apply(params["final_norm"], x)
        logits = self.head_logits(params, x, policy)
        return logits[:, 0], new_state


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
