"""Vision-transformer classifier (ViT/DeiT) with the INT-FP-QSim policy
threaded through every contraction.

The paper's second domain (§III, ViT/DeiT W4A4/W4A8 tables): a pre-LN
encoder over non-overlapping image patches with a cls-token (or mean-pool)
classification head.  Everything reuses the LM building blocks — the patch
projection is ``nn.patch_embed`` (conv-as-matmul through ``qmatmul``),
blocks are ``nn.attention`` (bidirectional: ``causal=False``, no RoPE,
learned position embeddings) + ``nn.ffn``, and the head is a quantized
``nn.linear.Dense``.  Under the ``fused`` backends every matmul is
``abfp_matmul`` / ``abfp_matmul_int8`` and, with attention-BMM QDQ off,
every attention call is the non-causal ``flash_attention`` kernel.

Calibration contract: the block naming matches ``TransformerLM``
(``blocks.{i}/attn/...``, ``blocks.{i}/ffn/...``) so the PTQ passes of
``models.quant_transforms`` (static MSE trees, SmoothQuant, GPTQ, RPTQ)
apply to the encoder unchanged; ``patch_embed/in`` and ``head/in`` have no
place in the block tree and are reported as dropped.  Layers are always a
Python list of per-layer dicts (there is no scan), so those sites fire
layer by layer whatever ``scan_layers`` says; ``scan_layers=True`` still
rejects layer-indexed policy rules, as the reference does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig, pad_to
from repro_torch.core.policy import QuantPolicy, check_scan_compatible
from repro_torch.nn.attention import Attention
from repro_torch.nn.ffn import MLP
from repro_torch.nn.linear import Dense
from repro_torch.nn.module import require_device, truncated_normal
from repro_torch.nn.norms import LayerNorm, RMSNorm
from repro_torch.nn.patch_embed import PatchEmbed

NEG_INF = -1e9


def _norm(cfg: ArchConfig):
    if cfg.norm == "ln":
        return LayerNorm(cfg.d_model, param_dtype=cfg.param_dtype,
                         dtype=cfg.dtype)
    return RMSNorm(cfg.d_model, plus_one=cfg.norm_plus_one,
                   param_dtype=cfg.param_dtype, dtype=cfg.dtype)


@dataclasses.dataclass(frozen=True)
class VisionTransformer:
    cfg: ArchConfig

    # ------------------------------------------------------------ builders
    @property
    def seq_len(self) -> int:
        return self.cfg.vit_seq_len

    @property
    def n_classes_padded(self) -> int:
        # padded like the reference's head (its kernel divides a mesh axis)
        return pad_to(self.cfg.n_classes, 128)

    def _patch_embed(self) -> PatchEmbed:
        c = self.cfg
        return PatchEmbed(
            image_size=c.image_size, patch_size=c.patch_size,
            n_channels=c.n_channels, d_model=c.d_model,
            param_dtype=c.param_dtype, dtype=c.dtype, name="patch_embed",
        )

    def _attention(self, name: str = "attn") -> Attention:
        c = self.cfg
        return Attention(
            d_model=c.d_model, n_heads=c.n_heads, n_kv=c.n_kv,
            head_dim=c.head_dim_, qkv_bias=c.qkv_bias, causal=False,
            use_rope=False, softcap=c.attn_softcap,
            param_dtype=c.param_dtype, dtype=c.dtype,
            q_block=c.q_block, kv_block=c.kv_block, name=name,
        )

    def _mlp(self, name: str = "ffn") -> MLP:
        c = self.cfg
        return MLP(c.d_model, c.d_ff, act=c.act, param_dtype=c.param_dtype,
                   dtype=c.dtype, name=name)

    def _head(self) -> Dense:
        c = self.cfg
        return Dense(c.d_model, self.n_classes_padded, use_bias=True,
                     param_dtype=c.param_dtype, dtype=c.dtype, name="head")

    # ----------------------------------------------------------------- init
    def _block_init(self, gen, device) -> dict:
        c = self.cfg
        return {
            "ln1": _norm(c).init(gen, device),
            "attn": self._attention().init(gen, device),
            "ln2": _norm(c).init(gen, device),
            "ffn": self._mlp().init(gen, device),
        }

    def init(self, gen: torch.Generator, device="cuda") -> dict:
        """Random parameters drawn from ``gen`` on ``device``: a nested
        dict of tensors, ``blocks`` a list of per-layer dicts."""
        c = self.cfg
        device = require_device(device)
        pdt = getattr(torch, c.param_dtype)
        params: dict = {
            "patch_embed": self._patch_embed().init(gen, device),
            "pos_embed": truncated_normal(gen, (self.seq_len, c.d_model),
                                          pdt, 0.02, device),
            "final_norm": _norm(c).init(gen, device),
            "head": self._head().init(gen, device),
        }
        if c.pool == "cls":
            params["cls"] = truncated_normal(gen, (c.d_model,), pdt, 0.02,
                                             device)
        params["blocks"] = [self._block_init(gen, device)
                            for _ in range(c.n_layers)]
        return params

    # --------------------------------------------------------------- blocks
    def _block_apply(self, bparams, x, positions, policy, q=None,
                     name="block"):
        c = self.cfg
        getq = (lambda k: None) if q is None else q.get
        h = _norm(c).apply(bparams["ln1"], x)
        h = self._attention(f"{name}/attn").apply(
            bparams["attn"], h, positions=positions, policy=policy,
            q=getq("attn"))
        x = x + h
        h = _norm(c).apply(bparams["ln2"], x)
        h = self._mlp(f"{name}/ffn").apply(bparams["ffn"], h, policy,
                                           q=getq("ffn"))
        return x + h

    def _run_blocks(self, params, x, positions, policy, q=None):
        c = self.cfg
        check_scan_compatible(policy, c.scan_layers, c.name)
        for i, bp in enumerate(params["blocks"]):
            qi = None if q is None else q["blocks"][i]
            x = self._block_apply(bp, x, positions, policy, qi,
                                  name=f"blocks.{i}")
        return x

    # ---------------------------------------------------------------- apply
    def apply(self, params, images, *, policy=QuantPolicy(), q=None,
              return_hidden: bool = False):
        """images (B, H, W, C) -> (logits (B, n_classes_padded), aux).
        ``q``: static-scale q tree ``{"blocks": [per-layer dict]}``."""
        c = self.cfg
        getq = (lambda k: None) if q is None else q.get
        x = self._patch_embed().apply(params["patch_embed"], images, policy,
                                      q=getq("patch_embed"))
        B = x.shape[0]
        if c.pool == "cls":
            cls = params["cls"].to(x.dtype)[None, None].expand(
                B, 1, c.d_model)
            x = torch.cat([cls, x], dim=1)
        S = x.shape[1]
        x = x + params["pos_embed"][:S].to(x.dtype)[None]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device)[None].expand(B, S)
        x = self._run_blocks(params, x, positions, policy, q)
        x = _norm(c).apply(params["final_norm"], x)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if return_hidden:
            return x, aux
        pooled = x[:, 0] if c.pool == "cls" else x.mean(dim=1)
        logits = self._head().apply(params["head"], pooled, policy,
                                    q=getq("head"))
        if self.n_classes_padded != c.n_classes:
            logits = logits.clone()
            logits[..., c.n_classes:] = NEG_INF
        return logits, aux


# ---------------------------------------------------------------------------
# Facade (the `build_model` interface subset that applies to classifiers)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class VitModel:
    """Uniform facade: batch dicts carry 'images' (B, H, W, C) and 'labels'
    (B,), as numpy (the PTQ drivers hand them in so) or tensors; they go to
    the model's device."""

    cfg: ArchConfig
    inner: VisionTransformer
    device: torch.device

    def init(self, gen: torch.Generator):
        return self.inner.init(gen, self.device)

    def _field(self, batch, key: str) -> torch.Tensor:
        return torch.as_tensor(batch[key], device=self.device)

    def apply(self, params, batch, policy=QuantPolicy(), q=None,
              return_hidden: bool = False):
        return self.inner.apply(params, self._field(batch, "images"),
                                policy=policy, q=q,
                                return_hidden=return_hidden)

    def loss(self, params, batch, policy=QuantPolicy(), q=None):
        """Softmax CE over classes + top-1 accuracy (the padded classes sit
        at ``NEG_INF`` and add nothing to either)."""
        logits, aux = self.apply(params, batch, policy, q)
        labels = self._field(batch, "labels").long()
        lf = logits.to(torch.float32)
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels[:, None])[:, 0]
        ce = (logz - gold).mean()
        acc = (torch.argmax(logits, dim=-1) == labels).to(
            torch.float32).mean()
        return ce, {"ce": ce, "acc": acc, "aux": aux}
