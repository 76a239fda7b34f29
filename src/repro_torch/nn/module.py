"""What parameter initialisation needs.

Parameters are plain nested dicts of tensors; their logical axes are a
separate tree of the same structure (each layer's ``axes()``,
``Model.param_axes()``), which ``repro_torch.dist.sharding`` maps onto a
mesh.  Randomness is an explicit
``torch.Generator``; ``device`` is explicit and defaults to ``"cuda"`` at
every entry point — ``require_device`` raises when the requested device is
not there instead of carrying on elsewhere.
"""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``torch.device(device)``, raising if it is CUDA and there is no card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' explicitly to run on the CPU")
    return dev


def make_generator(seed: int, device) -> torch.Generator:
    """A seeded generator on ``device`` (parameters are drawn on the device
    they live on)."""
    gen = torch.Generator(device=require_device(device))
    gen.manual_seed(seed)
    return gen


def truncated_normal(gen: torch.Generator, shape, dtype, stddev: float = 0.02,
                     device="cuda") -> torch.Tensor:
    """``stddev`` * a standard normal truncated to [-2, 2]."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=gen)
    return (stddev * t).to(dtype)
