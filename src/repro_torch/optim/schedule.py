"""LR schedules."""

from __future__ import annotations

import math

import torch

from repro_torch.core.quantize import div_by_constant


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak`` over ``warmup`` steps, then a cosine decay
    to ``floor * peak`` at ``total``; ``lr(step)`` takes the step as a
    tensor (the optimizer's int32 count) and returns an f32 tensor, op for
    op as the reference forms it."""

    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = div_by_constant(peak * s, max(warmup, 1))
        t = torch.clamp(div_by_constant(s - warmup, max(total - warmup, 1)),
                        0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (
            1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, cos)

    return lr
