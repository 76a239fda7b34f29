"""Uniform model facade so the launcher and the engines see one interface:

    model = build_model(cfg, device="cuda")
    params = model.init(gen)                     # nested dict of tensors
    logits, aux = model.apply(params, batch, policy, q)
    loss, metrics = model.loss(params, batch, policy, q)
    logits, state = model.prefill(params, batch, policy, max_len, n_valid)
    logits, state = model.decode_step(params, token, state, policy)
    state = model.init_paged_state(n_slots, ...)
    logits, state = model.paged_step(params, tokens, state, n_valid=...)

The dense decoder family, the state-space family (``TransformerLM`` with
Mamba2 blocks), the Zamba2 hybrid (``HybridLM``: no paged state, and a
``HybridState`` the engines do not take) and the vision family
(``VitModel``: ``init``, ``apply``, ``loss`` over image batches) are
ported.  MoE (ROADMAP.md Queue A item 4) and the encoder-decoder and VLM
families (item 3) raise with the item that will bring them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantPolicy
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

    def apply(self, params, batch, policy=QuantPolicy(), q=None,
              return_hidden: bool = False):
        return self.inner.apply(params, self._tokens(batch), policy=policy,
                                q=q, return_hidden=return_hidden)

    def loss(self, params, batch, policy=QuantPolicy(), q=None):
        """Next-token CE (+ 0.01 aux, zero for the ported families).
        Labels: ``batch['labels']``, -1 masked."""
        c = self.cfg
        labels = torch.as_tensor(batch["labels"], device=self.device)
        if c.logits_chunk > 0 and isinstance(self.inner, TransformerLM):
            hidden, aux = self.apply(params, batch, policy, q,
                                     return_hidden=True)
            ce = chunked_lm_loss(self.inner, params, hidden, labels, policy,
                                 c.logits_chunk)
        else:
            logits, aux = self.apply(params, batch, policy, q)
            ce = cross_entropy(logits, labels, c.vocab)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def prefill(self, params, batch, policy=QuantPolicy(),
                max_len: int | None = None, n_valid=None):
        # n_valid (bucketed prefill) only when given: HybridLM takes none
        kw = {} if n_valid is None else {"n_valid": n_valid}
        return self.inner.prefill(params, self._tokens(batch), policy=policy,
                                  max_len=max_len, **kw)

    def init_decode_state(self, batch: int, max_len: int, **kw):
        """Fixed-slot decode state: ring buffers, SSM caches, or both in
        a ``HybridState``."""
        return self.inner.init_decode_state(batch, max_len,
                                            device=self.device, **kw)

    def decode_step(self, params, token, state, policy=QuantPolicy()):
        return self.inner.decode_step(params, token, state, policy=policy)

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
    if cfg.family not in ("dense", "ssm"):
        item = 4 if cfg.family == "moe" else 3
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet — "
            f"ROADMAP.md Queue A item {item}; the dense, ssm, hybrid and "
            "vision families are")
    return Model(cfg, TransformerLM(cfg), require_device(device))
