"""Patch embedding: conv-as-matmul patchification through the quant chokepoint.

A ViT patch projection is a Conv2d with kernel_size == stride == P, which is
exactly an unfold into non-overlapping (P, P, C) patches followed by a dense
projection.  It is implemented that way so the projection routes through
``core.simulate.qmatmul`` (via ``nn.linear.Dense``) and is quantized —
formats, ABFP grouping, static scales, the fused kernels — identically to
every other contraction of the port.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.policy import Policy
from repro_torch.nn.linear import Dense


def extract_patches(images: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, N, P*P*C) non-overlapping patch rows.

    Row-major patch order (top-left to bottom-right), each patch flattened
    as (ph, pw, c) — the layout a stride-P Conv2d contracts over.
    """
    B, H, W, C = images.shape
    assert H % patch == 0 and W % patch == 0, (H, W, patch)
    gh, gw = H // patch, W // patch
    x = images.reshape(B, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # (B, gh, gw, P, P, C)
    return x.reshape(B, gh * gw, patch * patch * C)


@dataclasses.dataclass(frozen=True)
class PatchEmbed:
    """Quantized patchifier: unfold + Dense(P*P*C -> d_model) + bias."""

    image_size: int
    patch_size: int
    n_channels: int
    d_model: int
    param_dtype: str = "float32"
    dtype: str = "float32"
    name: str = "patch_embed"

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def patch_dim(self) -> int:
        return self.patch_size**2 * self.n_channels

    def _proj(self) -> Dense:
        # ViT's conv projection carries a bias
        return Dense(self.patch_dim, self.d_model, use_bias=True,
                     param_dtype=self.param_dtype, dtype=self.dtype,
                     name=self.name)

    def init(self, gen: torch.Generator, device="cuda") -> dict:
        return self._proj().init(gen, device)

    def apply(self, params: dict, images: torch.Tensor, policy: Policy, *,
              q: dict | None = None) -> torch.Tensor:
        """(B, H, W, C) images -> (B, N, d_model) patch tokens."""
        B, H, W, C = images.shape
        assert H == W == self.image_size and C == self.n_channels, (
            tuple(images.shape), self.image_size, self.n_channels)
        patches = extract_patches(images.to(getattr(torch, self.dtype)),
                                  self.patch_size)
        return self._proj().apply(params, patches, policy, q=q)
