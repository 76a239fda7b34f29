"""Optimizers: AdamW with f32 moments, global-norm clip, schedules (the
reference's ``optim/compression`` is a cross-pod all-reduce and waits for
the distribution slice)."""

from repro_torch.optim.adamw import AdamW, AdamWState, apply_updates
from repro_torch.optim.clip import clip_by_global_norm, global_norm
from repro_torch.optim.schedule import warmup_cosine

__all__ = ["AdamW", "AdamWState", "apply_updates", "warmup_cosine",
           "clip_by_global_norm", "global_norm"]
