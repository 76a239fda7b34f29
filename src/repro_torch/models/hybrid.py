"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention block
applied every k-th layer with per-invocation LoRA deltas (arXiv:2411.15242).

Layout: n_layers = G groups x [(k-1) Mamba2 blocks + 1 shared-attention
invocation].  The shared block's base weights are one parameter set; each
invocation adds its own low-rank delta W + A_g @ B_g and attends over
concat(hidden, initial embedding) (2 d_model wide) through the shared QKV.

Quantization: the *effective* weights (base + LoRA) go through the QDQ
chokepoint, which is what a deployment would quantize.  Compressed q / k /
v kernels are decompressed before the delta is folded in.

Parameters: ``mamba_groups`` is a list of G lists of (k-1) block dicts
(``{"ln", "mamba"}``) and ``lora`` a list of G dicts ``{q, k, v: {A, B}}``
(the reference stacks both along leading axes).  Matmul sites are family
names (``mamba/in_proj``, ``shared/q``, ``mlp/wi``, ...): there are no
per-layer sites, so layer-indexed policy rules are rejected.

The shared block's attention is the plain ``Attention._reference`` /
``_blockwise`` path, in the reference as here: no flash kernel.  At decode
its ring cache is written in place at ``position % max_len`` (one position
for the whole batch); the Mamba2 caches are replaced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantPolicy, reject_layer_rules
from repro_torch.core.simulate import qmatmul
from repro_torch.dist import sharding as shd
from repro_torch.models.lm import (GLOBAL_WINDOW, _norm, mask_padding,
                                   remat_body)
from repro_torch.nn.attention import Attention, KVCache
from repro_torch.nn.ffn import MLP
from repro_torch.nn.linear import Embed
from repro_torch.nn.module import require_device, truncated_normal
from repro_torch.nn.norms import RMSNorm
from repro_torch.nn.rotary import apply_rope
from repro_torch.nn.ssm import mamba_from_config


class HybridState(NamedTuple):
    kv: Any  # list of G shared-attention KVCaches
    ssm: Any  # list of G lists of (k-1) SSMCaches
    x0: torch.Tensor  # initial embedding (B, 1, d) of the prompt's last token
    position: torch.Tensor  # int32 scalar


@dataclasses.dataclass(frozen=True)
class HybridLM:
    cfg: ArchConfig

    @property
    def k(self) -> int:
        return self.cfg.shared_attn_every

    @property
    def n_groups(self) -> int:
        assert self.cfg.n_layers % self.k == 0, (self.cfg.n_layers, self.k)
        return self.cfg.n_layers // self.k

    def _mamba(self):
        return mamba_from_config(self.cfg)

    def _attn(self) -> Attention:
        c = self.cfg
        # the shared block attends over concat(x, x0): d_in = 2 d_model
        return Attention(
            d_model=2 * c.d_model, n_heads=c.n_heads, n_kv=c.n_kv,
            head_dim=c.head_dim_, rope_theta=c.rope_theta, use_rope=True,
            param_dtype=c.param_dtype, dtype=c.dtype,
            q_block=c.q_block, kv_block=c.kv_block,
        )

    def _mlp(self) -> MLP:
        c = self.cfg
        return MLP(c.d_model, c.d_ff, act=c.act, param_dtype=c.param_dtype,
                   dtype=c.dtype)

    def _embed(self) -> Embed:
        c = self.cfg
        return Embed(c.vocab_padded, c.d_model, param_dtype=c.param_dtype,
                     dtype=c.dtype)

    # ----------------------------------------------------------------- init
    def _mamba_block_init(self, gen, device) -> dict:
        return {"ln": _norm(self.cfg).init(gen, device),
                "mamba": self._mamba().init(gen, device)}

    def _lora_init(self, gen, device) -> dict:
        c = self.cfg
        pdt = getattr(torch, c.param_dtype)
        dims = {"q": c.n_heads * c.head_dim_, "k": c.n_kv * c.head_dim_,
                "v": c.n_kv * c.head_dim_}
        return {nm: {"A": truncated_normal(gen, (2 * c.d_model, c.lora_rank),
                                           pdt, 0.02, device),
                     "B": torch.zeros((c.lora_rank, od), dtype=pdt,
                                      device=device)}
                for nm, od in dims.items()}

    def init(self, gen: torch.Generator, device="cuda") -> dict:
        """Random parameters drawn from ``gen`` on ``device``."""
        c = self.cfg
        device = require_device(device)
        att = self._attn()
        params = {
            "embed": self._embed().init(gen, device),
            "mamba_groups": [[self._mamba_block_init(gen, device)
                              for _ in range(self.k - 1)]
                             for _ in range(self.n_groups)],
            "shared": {
                "ln1": RMSNorm(2 * c.d_model, param_dtype=c.param_dtype,
                               dtype=c.dtype).init(gen, device),
                "attn": att.init(gen, device),
                "ln2": _norm(c).init(gen, device),
                "mlp": self._mlp().init(gen, device),
            },
            "lora": [self._lora_init(gen, device)
                     for _ in range(self.n_groups)],
            "final_norm": _norm(c).init(gen, device),
        }
        # the shared o projection maps back to d_model: the attention is
        # built 2 d_model wide, so its o kernel is replaced
        hd = att.n_heads * att.head_dim
        params["shared"]["attn"]["o"] = {"kernel": truncated_normal(
            gen, (hd, c.d_model), getattr(torch, c.param_dtype), hd ** -0.5,
            device)}
        return params

    def param_axes(self) -> dict:
        """The logical axes of ``init``'s tree, leaf for leaf: the
        reference's stacked ``mamba_groups`` (G, k-1, ...) and ``lora``
        (G, ...) axes without their leading ``"layers"`` entries."""
        c = self.cfg
        block = {"ln": _norm(c).axes(), "mamba": self._mamba().axes()}
        lora = {nm: {"A": ("embed", "lora"), "B": ("lora", "qkv")}
                for nm in ("q", "k", "v")}
        return {
            "embed": self._embed().axes(),
            "mamba_groups": [[block for _ in range(self.k - 1)]
                             for _ in range(self.n_groups)],
            "shared": {
                "ln1": RMSNorm(2 * c.d_model).axes(),
                "attn": self._attn().axes(),
                "ln2": _norm(c).axes(),
                "mlp": self._mlp().axes(),
            },
            "lora": [lora for _ in range(self.n_groups)],
            "final_norm": _norm(c).axes(),
        }

    # ------------------------------------------------------------- internals
    def _mamba_block(self, bp, x, policy):
        """One pre-norm Mamba2 block of a group (full sequence)."""
        h = _norm(self.cfg).apply(bp["ln"], x)
        return x + self._mamba().apply(bp["mamba"], h, policy)

    def _group(self, group, x, lora, shared, x0, positions, policy):
        """One group of the full sequence: its Mamba2 blocks, then the
        shared block with the group's LoRA."""
        for bp in group:
            x = self._mamba_block(bp, x, policy)
        return self._shared_block(shared, lora, x, x0, positions, policy)[0]

    def _shared_qkv(self, sparams, lora, h2, policy):
        """QKV with the invocation's LoRA folded into the effective
        weights."""
        dt = getattr(torch, self.cfg.dtype)
        out = {}
        for nm in ("q", "k", "v"):
            w = sparams["attn"][nm]["kernel"]
            if type(w).__name__ == "CompressedKernel":
                # int-stored serving weights: the LoRA deltas ride in fp,
                # so the dense kernel is rebuilt before they are folded in
                from repro_torch.models.serving_transforms import \
                    decompress_kernel

                w = decompress_kernel(w, dtype=dt)
            torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
            delta = (lora[nm]["A"].to(torch.float32)
                     @ lora[nm]["B"].to(torch.float32)).to(w.dtype)
            out[nm] = qmatmul(h2, w + delta, policy, site=f"shared/{nm}",
                              compute_dtype=dt)
        return out

    def _shared_block(self, sparams, lora, x, x0, positions, policy,
                      cache: KVCache | None = None, position=None):
        """Shared attention (+ MLP) over concat(x, x0).  Returns (x, the
        full sequence's flat (k, v) or the updated ring cache)."""
        c = self.cfg
        att = self._attn()
        B, S = x.shape[0], x.shape[1]
        h2 = RMSNorm(2 * c.d_model, param_dtype=c.param_dtype,
                     dtype=c.dtype).apply(sparams["ln1"],
                                          torch.cat([x, x0], dim=-1))
        proj = self._shared_qkv(sparams, lora, h2, policy)
        qh = shd.unflatten(proj["q"], -1, (c.n_heads, c.head_dim_))
        kh = shd.unflatten(proj["k"], -1, (c.n_kv, c.head_dim_))
        vh = shd.unflatten(proj["v"], -1, (c.n_kv, c.head_dim_))
        qh = shd.per_shard(apply_rope, qh, positions, c.rope_theta)
        kh = shd.per_shard(apply_rope, kh, positions, c.rope_theta)
        qh = shd.constrain(qh, ("batch", "seq", "heads", "head_dim"))
        if cache is None:  # the full sequence
            use_block = (S >= att.blockwise_min_seq
                         and S % att.q_block == 0)
            fn = att._blockwise if use_block else att._reference
            out = shd.per_shard(fn, qh, kh, vh, positions, positions,
                                GLOBAL_WINDOW, policy)
            new_cache = (kh.reshape(B, S, -1), vh.reshape(B, S, -1))
        else:  # decode: this token's K/V into the ring, at one position
            size = cache.k.shape[1]
            slot = position % size
            shd.put_rows(cache.k, slot, kh.reshape(B, -1).to(cache.k.dtype))
            shd.put_rows(cache.v, slot, vh.reshape(B, -1).to(cache.v.dtype))
            new_cache = KVCache(
                shd.constrain(cache.k, ("batch", "kv_seq", "qkv")),
                shd.constrain(cache.v, ("batch", "kv_seq", "qkv")),
                position + 1)
            idx = torch.arange(size, dtype=torch.int32, device=x.device)
            rounds = torch.div(position, size, rounding_mode="floor") * size
            spos = idx + torch.where(idx <= slot, rounds, rounds - size)
            spos = torch.where((spos > position) | (spos < 0),
                               torch.full_like(spos, -1), spos)
            kv = shd.unflatten(cache.k, -1, (c.n_kv, c.head_dim_))
            vv = shd.unflatten(cache.v, -1, (c.n_kv, c.head_dim_))
            qp = position.reshape(1, 1).expand(B, 1)
            kp = spos[None].expand(B, size)
            out = shd.per_shard(att._reference, qh, kv, vv, qp, kp,
                                GLOBAL_WINDOW, policy)
        y = qmatmul(shd.merge_last(out), sparams["attn"]["o"]["kernel"],
                    policy, site="shared/o",
                    compute_dtype=getattr(torch, c.dtype))
        x = x + y.to(x.dtype)
        h = _norm(c).apply(sparams["ln2"], x)
        x = x + self._mlp().apply(sparams["mlp"], h, policy)
        return shd.constrain(x, ("batch", "seq_res", "embed")), new_cache

    def _logits(self, params, x, policy):
        c = self.cfg
        x = _norm(c).apply(params["final_norm"], x)
        logits = self._embed().attend(params["embed"], x, policy)
        if c.vocab_padded != c.vocab:
            logits = mask_padding(logits, c.vocab)
        return logits

    def _front(self, params, tokens):
        """Token embeddings (the x0 every shared invocation sees) and
        positions 0 .. S-1."""
        x = self._embed().apply(params["embed"], tokens)
        B, S = tokens.shape
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        return x, positions

    # ---------------------------------------------------------------- apply
    def apply(self, params, tokens, *, policy=QuantPolicy(), q=None,
              return_hidden: bool = False, prefix_embeds=None):
        """Full-sequence forward: (logits (B, S, vocab_padded), aux 0)."""
        del prefix_embeds, q
        reject_layer_rules(policy, "HybridLM")
        x, positions = self._front(params, tokens)
        x0 = x  # the initial embedding, seen by every shared invocation
        # under grad mode each group is recomputed in the backward unless
        # cfg.remat is "none" (the reference checkpoints its group body)
        group = remat_body(self.cfg.remat, self._group)
        for gp, lora in zip(params["mamba_groups"], params["lora"]):
            x = group(gp, x, lora, params["shared"], x0, positions, policy)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return _norm(self.cfg).apply(params["final_norm"], x), aux
        return self._logits(params, x, policy), aux

    # -------------------------------------------------------------- serving
    @torch.no_grad()
    def prefill(self, params, tokens, *, policy=QuantPolicy(),
                max_len: int | None = None):
        """Forward pass that also builds the decode state: (last-position
        logits (B, vocab_padded), HybridState)."""
        reject_layer_rules(policy, "HybridLM")
        x, positions = self._front(params, tokens)
        B, S = tokens.shape
        max_len = max_len or S
        x0 = x
        att = self._attn()
        kv, ssm = [], []
        for group, lora in zip(params["mamba_groups"], params["lora"]):
            caches = []
            for bp in group:
                h = _norm(self.cfg).apply(bp["ln"], x)
                h, mc = self._mamba().apply(bp["mamba"], h, policy,
                                            return_cache=True)
                x = x + h
                caches.append(mc)
            x, (kf, vf) = self._shared_block(params["shared"], lora, x, x0,
                                             positions, policy)
            kv.append(att.fill_cache(kf, vf, max_len, policy=policy))
            ssm.append(caches)
        logits = self._logits(params, x[:, -1:, :], policy)
        state = HybridState(kv=kv, ssm=ssm, x0=x0[:, -1:, :],
                            position=torch.tensor(S, dtype=torch.int32,
                                                  device=x.device))
        return logits[:, 0], state

    def init_decode_state(self, batch: int, max_len: int,
                          kv_quant: bool = False,
                          device="cuda") -> HybridState:
        """Zero caches and position 0.  ``kv_quant`` is accepted for the
        interface's sake: the shared block keeps its ring in the model's
        dtype, as the reference does."""
        del kv_quant
        c = self.cfg
        device = require_device(device)
        dt = getattr(torch, c.dtype)
        att, m = self._attn(), self._mamba()
        return HybridState(
            kv=[att.init_cache(batch, max_len, dtype=dt, device=device)
                for _ in range(self.n_groups)],
            ssm=[[m.init_cache(batch, dtype=dt, device=device)
                  for _ in range(self.k - 1)]
                 for _ in range(self.n_groups)],
            x0=torch.zeros((batch, 1, c.d_model), dtype=dt, device=device),
            position=torch.zeros((), dtype=torch.int32, device=device))

    @torch.no_grad()
    def decode_step(self, params, token, state: HybridState, *,
                    policy=QuantPolicy(), q=None):
        """token: (B, 1) -> (logits (B, vocab_padded), new state).

        As in the reference, the shared block's x0 is this token's own
        embedding, and ``state.x0`` is carried through unchanged."""
        del q
        reject_layer_rules(policy, "HybridLM")
        x = self._embed().apply(params["embed"], token)
        pos = state.position
        positions = pos.reshape(1, 1).expand(x.shape[0], 1)
        x0 = x
        kv, ssm = [], []
        for g, (group, lora) in enumerate(zip(params["mamba_groups"],
                                              params["lora"])):
            caches = []
            for bp, mc in zip(group, state.ssm[g]):
                h = _norm(self.cfg).apply(bp["ln"], x)
                h, mc = self._mamba().decode_step(bp["mamba"], h, mc,
                                                  policy=policy)
                x = x + h
                caches.append(mc)
            x, kvc = self._shared_block(params["shared"], lora, x, x0,
                                        positions, policy,
                                        cache=state.kv[g], position=pos)
            kv.append(kvc)
            ssm.append(caches)
        logits = self._logits(params, x, policy)
        return logits[:, 0], HybridState(kv=kv, ssm=ssm, x0=state.x0,
                                         position=pos + 1)
