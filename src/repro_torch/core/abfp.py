"""Adaptive Block Floating Point (paper §II-B2, eqn (4)).

ABFP dynamically scales vectors of length ``n`` along the dot-product
(contraction) dimension with per-vector ``max(|x|)`` scales kept in BF16
(the paper stores scales in BF16; a second-level scale quantization from
VS-Quant is explicitly out of scope, as in the paper).

All functions are plain PyTorch; the CUDA kernels in
``repro_torch.kernels`` implement the fused serving paths and are held
against these functions.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import Format
from repro_torch.core.quantize import maybe_ste, quantize
from repro_torch.dist import sharding as shd

_EPS = 1e-12


def _to_groups(x: torch.Tensor, axis: int, n: int):
    """Reshape ``axis`` into (groups, n), padding with zeros if needed.

    Returns (grouped, pad, k) where ``grouped`` has shape x.shape with
    ``axis`` replaced by (G, n) moved to the last two dims.
    """
    axis = axis % x.ndim
    x = shd.whole_along(x, (axis,))  # a mesh-sharded axis is gathered
    k = x.shape[axis]
    pad = (-k) % n
    xm = torch.movedim(x, axis, -1)
    if pad:
        xm = torch.nn.functional.pad(xm, (0, pad))
    g = (k + pad) // n
    return xm.reshape(*xm.shape[:-1], g, n), pad, k


def _from_groups(xg: torch.Tensor, axis: int, pad: int, k: int, ndim: int):
    axis = axis % ndim
    xm = xg.reshape(*xg.shape[:-2], xg.shape[-2] * xg.shape[-1])
    if pad:
        xm = xm[..., :k]
    return torch.movedim(xm, -1, axis)


def abfp_scales(x: torch.Tensor, axis: int = -1, n: int = 64,
                scale_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-vector max scales (eqn (4)); shape = x.shape with axis -> G.

    Scales are constants under differentiation (the PWL STE of eqn (5)
    differentiates w.r.t. x only), hence the detach.
    """
    xg, _, _ = _to_groups(x.detach(), axis, n)
    alpha = xg.abs().amax(dim=-1)
    # BF16 scales (paper: "scales themselves are left in BF16");
    # round-to-nearest — a max that rounds down is clipped to the top code.
    a16 = alpha.to(scale_dtype)
    return torch.clamp_min(a16.to(torch.float32), _EPS)


def abfp_qdq(x: torch.Tensor, fmt: Format, axis: int = -1, n: int = 64,
             ste: bool = False, scale_dtype=torch.bfloat16) -> torch.Tensor:
    """Simulated ABFP quantization of ``x`` along ``axis`` (groups of n)."""
    xg, pad, k = _to_groups(x, axis, n)
    alpha = abfp_scales(x, axis, n, scale_dtype)[..., None]
    yg = maybe_ste(xg, alpha, fmt, ste)
    return _from_groups(yg, axis, pad, k, x.ndim)


def abfp_quantize(x: torch.Tensor, fmt: Format, axis: int = -1, n: int = 64,
                  dtype=torch.int8, scale_dtype=torch.bfloat16):
    """Real ABFP quantization: returns (codes grouped, scales, (pad, k)).

    ``codes`` has shape x.shape with axis -> (G, n) moved last;
    ``scales`` has the matching (..., G) shape.  Used by the native-int8
    compute path and by compressed weight storage.
    """
    xg, pad, k = _to_groups(x, axis, n)
    alpha = abfp_scales(x, axis, n, scale_dtype)
    codes, scale = quantize(xg, alpha[..., None], fmt, dtype=dtype)
    return codes, scale[..., 0], (pad, k)
