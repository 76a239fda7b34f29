"""Uniform model facade so the launcher and the engines see one interface:

    model = build_model(cfg, device="cuda")
    params = model.init(gen)                     # nested dict of tensors
    state = model.init_paged_state(n_slots, ...)
    logits, state = model.paged_step(params, tokens, state, n_valid=...)

Only the dense decoder family is ported; the other families raise with the
ROADMAP item that will bring them.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core.policy import QuantPolicy
from repro_torch.models.lm import TransformerLM
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
        return False

    def init_paged_state(self, batch: int, **kw):
        """Paged-KV serving state (TransformerLM family only)."""
        return self.inner.init_paged_state(batch, device=self.device, **kw)

    def paged_step(self, params, tokens, state, *, n_valid,
                   policy=QuantPolicy(), all_logits: bool = False):
        return self.inner.paged_step(params, tokens, state,
                                     n_valid=n_valid, policy=policy,
                                     all_logits=all_logits)


def build_model(cfg: ArchConfig, device="cuda") -> Model:
    """The model facade for ``cfg`` on ``device`` (default: the card; with
    no card that default raises — pass ``device="cpu"`` to ask for the CPU).
    """
    if cfg.family != "dense":
        raise NotImplementedError(
            f"model family {cfg.family!r} ({cfg.name}) is not ported yet — "
            "ROADMAP.md Queue A lists it; the dense decoder family is")
    return Model(cfg, TransformerLM(cfg), require_device(device))
