"""Global-norm gradient clipping."""

from __future__ import annotations

import torch

from repro_torch.tree import leaves


def global_norm(tree) -> torch.Tensor:
    """sqrt of the summed squares of every leaf (in f32), the leaves added
    in the reference's order."""
    return torch.sqrt(
        sum(torch.sum(leaf.to(torch.float32) ** 2) for leaf in leaves(tree)))


def clip_by_global_norm(grads, max_norm: float):
    """(``grads``, scaled in place to a global norm of at most ``max_norm``;
    their global norm before clipping).  The reference's numbers: it
    returns scaled copies, and scaling the tensors themselves keeps a
    second gradient tree off the train step's peak.  ``max_norm / norm``
    is a true division (PyTorch forms ``scalar / tensor`` as a reciprocal
    times the scalar)."""
    norm = global_norm(grads)
    scale = torch.clamp(
        torch.full_like(norm, max_norm) / torch.clamp_min(norm, 1e-12),
        max=1.0)
    with torch.no_grad():
        for g in leaves(grads):
            g.mul_(scale)
    return grads, norm
