"""Uniform model facade so the launcher and the engines see one interface:

    model = build_model(cfg, device="cuda")
    params = model.init(gen)                     # nested dict of tensors
    logits, aux = model.apply(params, batch, policy, q)
    loss, metrics = model.loss(params, batch, policy, q)
    logits, state = model.prefill(params, batch, policy, max_len, n_valid)
    logits, state = model.decode_step(params, token, state, policy)
    logits, state = model.chunk_step(params, tokens, state, n_valid=...)
    state = model.init_paged_state(n_slots, ...)
    logits, state = model.paged_step(params, tokens, state, n_valid=...)

The dense decoder family, the state-space family (``TransformerLM`` with
Mamba2 blocks), the Zamba2 hybrid (``HybridLM``: no paged state, and a
``HybridState`` the engines do not take), the vision family (``VitModel``:
``init``, ``apply``, ``loss`` over image batches), the encoder-decoder
family (``EncDecLM``: ``batch["frames"]`` beside the tokens; no paged
state, and an ``EncDecState`` the engines do not take) and the VLM family
(``TransformerLM`` with ``batch["patch_embeds"]`` prepended; its loss drops
the patch positions) are ported, and so is the MoE family
(``TransformerLM`` with top-k ``nn.moe.MoE`` FFNs: ``loss`` adds 0.01 x
the Switch aux loss, ``expert_loads`` probes the routing).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.encdec import EncDecLM
from repro_torch.models.hybrid import HybridLM
from repro_torch.models.lm import (TransformerLM, chunked_lm_loss,
                                   cross_entropy)
from repro_torch.models.vit import VisionTransformer, VitModel
from repro_torch.nn.module import require_device


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig
    inner: Any
    device: torch.device

    def init(self, gen: torch.Generator):
        return self.inner.init(gen, self.device)

    @property
    def is_moe(self) -> bool:
        return getattr(self.inner, "is_moe", False)

    def _tokens(self, batch):
        """``batch["tokens"]`` as an int tensor on the model's device (the
        PTQ drivers hand numpy batches in)."""
        return torch.as_tensor(batch["tokens"], device=self.device)

    def _split_batch(self, batch):
        """(tokens, the family's extra inputs): ``frames`` for encdec, the
        ``patch_embeds`` as ``prefix_embeds`` for vlm; a missing one is a
        ``KeyError``, as in the reference."""
        kw = {}
        if self.cfg.family == "encdec":
            kw["frames"] = torch.as_tensor(batch["frames"],
                                           device=self.device)
        if self.cfg.family == "vlm":
            kw["prefix_embeds"] = torch.as_tensor(batch["patch_embeds"],
                                                  device=self.device)
        return self._tokens(batch), kw

    def apply(self, params, batch, policy=QuantPolicy(), q=None,
              return_hidden: bool = False):
        tokens, kw = self._split_batch(batch)
        return self.inner.apply(params, tokens, policy=policy, q=q,
                                return_hidden=return_hidden, **kw)

    def loss(self, params, batch, policy=QuantPolicy(), q=None):
        """Next-token CE (+ 0.01 x the MoE aux loss; 0 for other families).
        Labels: ``batch['labels']``, -1 masked; for vlm they cover the text
        only, and the patch positions' logits are dropped."""
        c = self.cfg
        labels = torch.as_tensor(batch["labels"], device=self.device)
        n_prefix = (batch["patch_embeds"].shape[1] if c.family == "vlm"
                    else 0)
        if c.logits_chunk > 0 and isinstance(self.inner, TransformerLM):
            hidden, aux = self.apply(params, batch, policy, q,
                                     return_hidden=True)
            ce = chunked_lm_loss(self.inner, params, hidden[:, n_prefix:],
                                 labels, policy, c.logits_chunk)
        else:
            logits, aux = self.apply(params, batch, policy, q)
            ce = cross_entropy(logits[:, n_prefix:], labels, c.vocab)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch, policy=QuantPolicy(),
                max_len: int | None = None, n_valid=None):
        # n_valid (bucketed prefill) only when given: HybridLM and
        # EncDecLM take none
        tokens, kw = self._split_batch(batch)
        if n_valid is not None:
            kw["n_valid"] = n_valid
        return self.inner.prefill(params, tokens, policy=policy,
                                  max_len=max_len, **kw)

    def expert_loads(self, params, tokens, *, policy=QuantPolicy()):
        """Routing-frequency probe: (n_layers, n_experts) routed-token
        counts (MoE TransformerLM family only; raises TypeError else)."""
        return self.inner.expert_loads(
            params, torch.as_tensor(tokens, device=self.device),
            policy=policy)

    def init_decode_state(self, batch: int, max_len: int, **kw):
        """Fixed-slot decode state: ring buffers, SSM caches, both in a
        ``HybridState``, or rings and cross K/V in an ``EncDecState``."""
        return self.inner.init_decode_state(batch, max_len,
                                            device=self.device, **kw)

    def decode_step(self, params, token, state, policy=QuantPolicy()):
        return self.inner.decode_step(params, token, state, policy=policy)

    def chunk_step(self, params, tokens, state, *, n_valid,
                   policy=QuantPolicy()):
        """All-position scoring of a token chunk (speculative verify)."""
        return self.inner.chunk_step(params, tokens, state,
                                     n_valid=n_valid, policy=policy)

    def init_paged_state(self, batch: int, **kw):
        """Paged-KV serving state (TransformerLM family only)."""
        return self.inner.init_paged_state(batch, device=self.device, **kw)

    def paged_step(self, params, tokens, state, *, n_valid,
                   policy=QuantPolicy(), all_logits: bool = False):
        return self.inner.paged_step(params, tokens, state,
                                     n_valid=n_valid, policy=policy,
                                     all_logits=all_logits)


def build_model(cfg: ArchConfig, device="cuda") -> Model | VitModel:
    """The model facade for ``cfg`` on ``device`` (default: the card; with
    no card that default raises — pass ``device="cpu"`` to ask for the CPU).
    """
    if cfg.family == "vit":
        return VitModel(cfg, VisionTransformer(cfg), require_device(device))
    if cfg.family == "hybrid":
        return Model(cfg, HybridLM(cfg), require_device(device))
    if cfg.family == "encdec":
        return Model(cfg, EncDecLM(cfg), require_device(device))
    # dense / moe / ssm / vlm all ride on TransformerLM
    return Model(cfg, TransformerLM(cfg), require_device(device))
