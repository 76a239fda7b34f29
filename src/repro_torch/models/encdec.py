"""Whisper-large-v3 backbone: encoder-decoder transformer.

The conv/mel front end is a stub, as in the reference: callers hand in
precomputed frame embeddings (B, S_enc, d_model).  The backbone is
faithful: a bidirectional encoder with sinusoidal positions, a causal
decoder with learned positions and per-layer cross-attention,
LayerNorm/GELU, tied decoder embeddings.

Serving: ``prefill`` encodes once, projects each decoder layer's cross
K/V (sites ``cross/k`` and ``cross/v``) and decodes with a self-attention
ring cache.  ``prefill`` builds the ring with ``fill_cache(policy=)``, so
under ``kv_cache == "int8"`` it is an int8 ring (the ``compressed``
backend's decode path); ``init_decode_state`` ignores ``kv_quant`` and
builds an f32 ring, as the reference does.

Attention: the encoder's self-attention (non-causal, S = T) and the
decoder's full-sequence self-attention (causal) take the flash kernel where
``Attention.apply``'s ``flash_ok`` rule holds; cross-attention never does
(``kv_override``)
and runs the plain ``_reference`` (or ``_blockwise``) path, as in the
reference.  The cross block still projects k and v of the decoder input
before they are replaced (``Attention.apply``), so its matmul calls are
the reference's.

Parameters: ``encoder`` and ``decoder`` are lists of per-layer dicts (the
reference stacks them along a leading axis; the bridge unstacks).  Matmul
sites are family names (``attn/q``, ``mlp/wi``, ``cross/k``, ...): there
are no per-layer sites, so layer-indexed policy rules are rejected.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantPolicy, reject_layer_rules
from repro_torch.dist import sharding as shd
from repro_torch.models.lm import GLOBAL_WINDOW, _sinusoid, mask_padding
from repro_torch.nn.attention import Attention
from repro_torch.nn.ffn import MLP
from repro_torch.nn.linear import Dense, Embed
from repro_torch.nn.module import require_device, truncated_normal
from repro_torch.nn.norms import LayerNorm


class EncDecState(NamedTuple):
    kv: Any  # list of n_layers decoder self-attention KVCaches
    cross_k: torch.Tensor  # (L, B, S_enc, n_kv * head_dim)
    cross_v: torch.Tensor
    enc_pos: torch.Tensor  # (B, S_enc) int32
    position: torch.Tensor  # int32 scalar


@dataclasses.dataclass(frozen=True)
class EncDecLM:
    cfg: ArchConfig

    def _attn(self, causal: bool) -> Attention:
        c = self.cfg
        return Attention(
            d_model=c.d_model, n_heads=c.n_heads, n_kv=c.n_kv,
            head_dim=c.head_dim_, qkv_bias=True, causal=causal,
            use_rope=False, param_dtype=c.param_dtype, dtype=c.dtype,
            q_block=c.q_block, kv_block=c.kv_block,
        )

    def _mlp(self) -> MLP:
        c = self.cfg
        return MLP(c.d_model, c.d_ff, act="gelu", use_bias=True,
                   param_dtype=c.param_dtype, dtype=c.dtype)

    def _ln(self) -> LayerNorm:
        c = self.cfg
        return LayerNorm(c.d_model, param_dtype=c.param_dtype, dtype=c.dtype)

    def _embed(self) -> Embed:
        c = self.cfg
        return Embed(c.vocab_padded, c.d_model, param_dtype=c.param_dtype,
                     dtype=c.dtype)

    # ----------------------------------------------------------------- init
    def _enc_block_init(self, gen, device) -> dict:
        return {"ln1": self._ln().init(gen, device),
                "attn": self._attn(False).init(gen, device),
                "ln2": self._ln().init(gen, device),
                "mlp": self._mlp().init(gen, device)}

    def _dec_block_init(self, gen, device) -> dict:
        return {"ln1": self._ln().init(gen, device),
                "self_attn": self._attn(True).init(gen, device),
                "ln_x": self._ln().init(gen, device),
                "cross_attn": self._attn(False).init(gen, device),
                "ln2": self._ln().init(gen, device),
                "mlp": self._mlp().init(gen, device)}

    def init(self, gen: torch.Generator, device="cuda") -> dict:
        """Random parameters drawn from ``gen`` on ``device``."""
        c = self.cfg
        device = require_device(device)
        return {
            "embed": self._embed().init(gen, device),
            "pos_embed": truncated_normal(
                gen, (c.max_position, c.d_model),
                getattr(torch, c.param_dtype), 0.02, device),
            "encoder": [self._enc_block_init(gen, device)
                        for _ in range(c.encoder_layers)],
            "decoder": [self._dec_block_init(gen, device)
                        for _ in range(c.n_layers)],
            "enc_norm": self._ln().init(gen, device),
            "final_norm": self._ln().init(gen, device),
        }

    def param_axes(self) -> dict:
        """The logical axes of ``init``'s tree, leaf for leaf: the
        reference's stacked ``encoder`` / ``decoder`` axes without their
        leading ``"layers"`` entry."""
        c = self.cfg
        enc = {"ln1": self._ln().axes(), "attn": self._attn(False).axes(),
               "ln2": self._ln().axes(), "mlp": self._mlp().axes()}
        dec = {"ln1": self._ln().axes(), "self_attn": self._attn(True).axes(),
               "ln_x": self._ln().axes(),
               "cross_attn": self._attn(False).axes(),
               "ln2": self._ln().axes(), "mlp": self._mlp().axes()}
        return {
            "embed": self._embed().axes(),
            "pos_embed": ("seq", "embed"),
            "encoder": [enc for _ in range(c.encoder_layers)],
            "decoder": [dec for _ in range(c.n_layers)],
            "enc_norm": self._ln().axes(),
            "final_norm": self._ln().axes(),
        }

    # -------------------------------------------------------------- encoder
    def _enc_block(self, bp, x, positions, policy):
        """One pre-LN encoder block (non-causal self-attention + MLP)."""
        h = self._ln().apply(bp["ln1"], x)
        x = x + self._attn(False).apply(bp["attn"], h, positions=positions,
                                        policy=policy, window=GLOBAL_WINDOW)
        h = self._ln().apply(bp["ln2"], x)
        return x + self._mlp().apply(bp["mlp"], h, policy)

    def encode(self, params, frames, policy):
        """frames: (B, S_enc, d_model) stub embeddings -> (encoder states,
        their positions (B, S_enc))."""
        c = self.cfg
        B, S, _ = frames.shape
        x = frames.to(getattr(torch, c.dtype))
        x = x + _sinusoid(S, c.d_model, x.device).to(x.dtype)[None]
        x = shd.constrain(x, ("batch", "seq_res", "embed"))
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        positions = shd.constrain(positions, ("batch", None))
        for bp in params["encoder"]:
            x = self._enc_block(bp, x, positions, policy)
        return self._ln().apply(params["enc_norm"], x), positions

    # -------------------------------------------------------------- decoder
    def _dec_block(self, bp, x, positions, enc, enc_pos, policy,
                   self_cache=None, position=None, cross_kv=None):
        """One decoder block: causal self-attention (full sequence, or one
        step against ``self_cache``), cross-attention over the encoder
        states (projected here, or ``cross_kv`` (B, S_enc, KV, D) each),
        MLP.  Returns (x, the full sequence's flat (k, v) or the updated
        ring cache)."""
        self_attn, cross_attn = self._attn(True), self._attn(False)
        h = self._ln().apply(bp["ln1"], x)
        if self_cache is None:
            h, new_cache = self_attn.apply(
                bp["self_attn"], h, positions=positions, policy=policy,
                window=GLOBAL_WINDOW, return_kv=True)
        else:
            h, new_cache = self_attn.decode_step(
                bp["self_attn"], h, self_cache, position=position,
                policy=policy, window=GLOBAL_WINDOW)
        x = x + h
        h = self._ln().apply(bp["ln_x"], x)
        kh, vh = (_project_kv(cross_attn, bp["cross_attn"], enc, policy)
                  if cross_kv is None else cross_kv)
        x = x + cross_attn.apply(
            bp["cross_attn"], h, positions=positions, policy=policy,
            window=GLOBAL_WINDOW, kv_override=(kh, vh, enc_pos))
        h = self._ln().apply(bp["ln2"], x)
        return x + self._mlp().apply(bp["mlp"], h, policy), new_cache

    def _dec_in(self, params, tokens, pos):
        """Token embeddings plus the learned positions pos .. pos + S - 1
        (``pos``: int or int32 scalar tensor); and those positions."""
        x = self._embed().apply(params["embed"], tokens)
        B, S = tokens.shape
        positions = (torch.as_tensor(pos, dtype=torch.int32, device=x.device)
                     + torch.arange(S, dtype=torch.int32, device=x.device))
        x = x + params["pos_embed"][positions.long()][None].to(x.dtype)
        return x, positions[None].expand(B, S)

    def _logits(self, params, x, policy):
        c = self.cfg
        x = self._ln().apply(params["final_norm"], x)
        logits = self._embed().attend(params["embed"], x, policy)
        if c.vocab_padded != c.vocab:
            logits = mask_padding(logits, c.vocab)
        return logits

    # ---------------------------------------------------------------- apply
    def apply(self, params, tokens, *, frames=None, policy=QuantPolicy(),
              q=None, return_hidden: bool = False):
        """Teacher forcing: encode ``frames``, decode ``tokens`` ->
        (logits (B, S, vocab_padded), aux 0)."""
        del q
        reject_layer_rules(policy, "EncDecLM")
        if frames is None:
            raise ValueError("encdec requires 'frames' input")
        enc, enc_pos = self.encode(params, frames, policy)
        x, positions = self._dec_in(params, tokens, 0)
        for bp in params["decoder"]:
            x, _ = self._dec_block(bp, x, positions, enc, enc_pos, policy)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return self._ln().apply(params["final_norm"], x), aux
        return self._logits(params, x, policy), aux

    # -------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params, tokens, *, frames=None, policy=QuantPolicy(),
                max_len: int | None = None):
        """Encode, run the prompt and build the decode state: (last-position
        logits (B, vocab_padded), EncDecState)."""
        c = self.cfg
        reject_layer_rules(policy, "EncDecLM")
        if frames is None:
            raise ValueError("encdec requires 'frames' input")
        enc, enc_pos = self.encode(params, frames, policy)
        B, S = tokens.shape
        T = enc.shape[1]
        max_len = max_len or S
        x, positions = self._dec_in(params, tokens, 0)
        self_attn, cross = self._attn(True), self._attn(False)
        flat = c.n_kv * c.head_dim_
        cross_k = torch.empty((c.n_layers, B, T, flat), dtype=enc.dtype,
                              device=enc.device)
        cross_v = torch.empty_like(cross_k)
        kv = []
        for i, bp in enumerate(params["decoder"]):
            ck, cv = _project_kv(cross, bp["cross_attn"], enc, policy)
            cross_k[i] = ck.reshape(B, T, flat)
            cross_v[i] = cv.reshape(B, T, flat)
            x, (kf, vf) = self._dec_block(bp, x, positions, enc, enc_pos,
                                          policy, cross_kv=(ck, cv))
            kv.append(self_attn.fill_cache(kf, vf, max_len, policy=policy))
        logits = self._logits(params, x[:, -1:, :], policy)
        state = EncDecState(kv=kv, cross_k=cross_k, cross_v=cross_v,
                            enc_pos=enc_pos,
                            position=torch.tensor(S, dtype=torch.int32,
                                                  device=x.device))
        return logits[:, 0], state

    @torch.no_grad()
    def decode_step(self, params, token, state: EncDecState, *,
                    policy=QuantPolicy(), q=None):
        """token: (B, 1) -> (logits (B, vocab_padded), new state).  The ring
        caches are updated in place; the cross K/V are carried unchanged."""
        del q
        c = self.cfg
        reject_layer_rules(policy, "EncDecLM")
        pos = state.position
        x, positions = self._dec_in(params, token, pos)
        B, T = token.shape[0], state.cross_k.shape[2]
        kv = []
        for i, bp in enumerate(params["decoder"]):
            kh = state.cross_k[i].reshape(B, T, c.n_kv, c.head_dim_)
            vh = state.cross_v[i].reshape(B, T, c.n_kv, c.head_dim_)
            x, cache = self._dec_block(
                bp, x, positions, None, state.enc_pos, policy,
                self_cache=state.kv[i], position=pos, cross_kv=(kh, vh))
            kv.append(cache)
        logits = self._logits(params, x, policy)
        return logits[:, 0], state._replace(kv=kv, position=pos + 1)

    def init_decode_state(self, batch: int, max_len: int,
                          enc_len: int = 128, kv_quant: bool = False,
                          device="cuda") -> EncDecState:
        """Zero f32 rings (``kv_quant`` is accepted for the interface's sake
        and ignored, as in the reference), zero cross K/V of ``enc_len``
        positions and position 0."""
        del kv_quant
        c = self.cfg
        device = require_device(device)
        dt = getattr(torch, c.dtype)
        attn = self._attn(True)
        flat = c.n_kv * c.head_dim_
        return EncDecState(
            kv=[attn.init_cache(batch, max_len, dtype=dt, device=device)
                for _ in range(c.n_layers)],
            cross_k=torch.zeros((c.n_layers, batch, enc_len, flat),
                                dtype=dt, device=device),
            cross_v=torch.zeros((c.n_layers, batch, enc_len, flat),
                                dtype=dt, device=device),
            enc_pos=torch.arange(enc_len, dtype=torch.int32,
                                 device=device)[None].expand(batch, enc_len)
            .contiguous(),
            position=torch.zeros((), dtype=torch.int32, device=device))


def _project_kv(attn: Attention, params, enc, policy):
    """Cross-attention K/V projections of the encoder states (no rope),
    through the ``cross/k`` and ``cross/v`` sites -> (B, T, KV, D) each."""
    B, T, _ = enc.shape
    out = []
    for which in ("k", "v"):
        dense = Dense(attn.d_model, attn.n_kv * attn.head_dim,
                      use_bias=attn.qkv_bias, param_dtype=attn.param_dtype,
                      dtype=attn.dtype, name=f"cross/{which}",
                      in_axis="embed", out_axis="qkv")
        out.append(dense.apply(params[which], enc, policy).reshape(
            B, T, attn.n_kv, attn.head_dim))
    return tuple(out)
