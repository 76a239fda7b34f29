"""RMSNorm / LayerNorm (fp32 statistics, cast back to activation dtype)."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RMSNorm:
    dim: int
    eps: float = 1e-6
    plus_one: bool = False  # gemma convention: scale = (1 + w)
    param_dtype: str = "float32"
    dtype: str = "float32"

    def init(self, gen=None, device="cuda") -> dict:
        init = torch.zeros if self.plus_one else torch.ones
        return {"scale": init((self.dim,),
                              dtype=getattr(torch, self.param_dtype),
                              device=device)}

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        scale = params["scale"].to(torch.float32)
        if self.plus_one:
            scale = 1.0 + scale
        return (y * scale).to(getattr(torch, self.dtype))


@dataclasses.dataclass(frozen=True)
class LayerNorm:
    dim: int
    eps: float = 1e-5
    param_dtype: str = "float32"
    dtype: str = "float32"

    def init(self, gen=None, device="cuda") -> dict:
        pdt = getattr(torch, self.param_dtype)
        return {
            "scale": torch.ones((self.dim,), dtype=pdt, device=device),
            "bias": torch.zeros((self.dim,), dtype=pdt, device=device),
        }

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mean) * (var + self.eps) ** -0.5
        y = y * params["scale"].to(torch.float32) + params["bias"].to(
            torch.float32)
        return y.to(getattr(torch, self.dtype))
