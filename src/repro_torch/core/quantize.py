"""Quantize / de-quantize primitives (paper eqns (1)-(3), (6)-(9)).

All QDQ functions take ``alpha`` — the clipping range — and map it onto the
format's largest magnitude: ``scale = alpha / fmt.qmax_pos`` so that
``x = alpha`` lands exactly on the top code.  This matches the paper's
``s = qmax / alpha`` with ``x_q = clip(round(s*x))`` and ``x_hat = x_q / s``.

``qdq_ste`` is the QAT forward/backward: identical forward, with the
piecewise-linear estimator of eqn (5): ``dQ/dx = 1{|x| <= alpha}``.
"""

from __future__ import annotations

import torch

from repro_torch.core.formats import Format

_EPS = 1e-12


def _as_tensor(alpha, like: torch.Tensor) -> torch.Tensor:
    if isinstance(alpha, torch.Tensor):
        return alpha
    return torch.as_tensor(alpha, dtype=torch.float32, device=like.device)


def div_by_constant(x: torch.Tensor, value: float) -> torch.Tensor:
    """``x / value`` as a correctly rounded division on every device.

    On CUDA, PyTorch turns division by a Python scalar into multiplication
    by its reciprocal, which is one ulp off for most divisors; scales are
    pinned bit patterns here (a scale one ulp off flips codes that sit on a
    rounding boundary), so the divisor goes in as a tensor on ``x``'s
    device, which takes the true-division kernel.
    """
    return x / torch.full((), value, dtype=x.dtype, device=x.device)


def _unit_scale(alpha: torch.Tensor, fmt: Format) -> torch.Tensor:
    """Step/scale mapping clip-range ``alpha`` to the top code of ``fmt``."""
    return div_by_constant(torch.clamp_min(alpha.abs(), _EPS), fmt.qmax_pos)


def qdq(x: torch.Tensor, alpha, fmt: Format) -> torch.Tensor:
    """Simulated quantization: DQ(Q(x; alpha, fmt)).

    ``alpha`` broadcasts against ``x`` (per-tensor scalar, per-channel, or
    per-group after reshaping — see ``repro_torch.core.abfp``).
    """
    scale = _unit_scale(_as_tensor(alpha, x), fmt).to(torch.float32)
    xs = x.to(torch.float32) / scale
    return (fmt.qdq_unit(xs) * scale).to(x.dtype)


def quantize(x: torch.Tensor, alpha, fmt: Format, dtype=torch.int8):
    """Real quantization to integer codes (storage / native-int8 compute).

    Returns ``(codes, scale)`` with ``x ≈ codes * scale``.
    Only defined for integer formats.
    """
    scale = _unit_scale(_as_tensor(alpha, x), fmt).to(torch.float32)
    codes = fmt.quantize_unit(x.to(torch.float32) / scale, dtype=dtype)
    return codes, scale


def dequantize(codes: torch.Tensor, scale: torch.Tensor,
               dtype=torch.float32):
    return codes.to(torch.float32) * scale.to(torch.float32)


# ---------------------------------------------------------------------------
# 4-bit code packing (compressed weight storage)
# ---------------------------------------------------------------------------
def pack_int4_codes(codes: torch.Tensor) -> torch.Tensor:
    """Pack signed 4-bit codes two-per-byte along the last dim (even length).

    Element ``2i`` lands in the low nibble, ``2i+1`` in the high nibble; each
    nibble is the code's 4-bit two's complement.  Inverse of
    ``unpack_int4_codes``.
    """
    if codes.shape[-1] % 2:
        raise ValueError(
            f"pack_int4_codes needs an even last dim, got {tuple(codes.shape)}"
        )
    c = codes.to(torch.int32)
    lo = c[..., 0::2] & 0xF
    hi = c[..., 1::2] & 0xF
    return (lo | (hi << 4)).to(torch.uint8)


def unpack_int4_codes(packed: torch.Tensor) -> torch.Tensor:
    """uint8 nibble pairs -> int8 codes; last dim doubles."""
    p = packed.to(torch.int32)
    lo = p & 0xF
    hi = (p >> 4) & 0xF
    c = torch.stack([lo, hi], dim=-1).reshape(
        *p.shape[:-1], p.shape[-1] * 2
    )
    return torch.where(c >= 8, c - 16, c).to(torch.int8)


# ---------------------------------------------------------------------------
# QAT: piecewise-linear straight-through estimator (paper eqn (5)).
# ---------------------------------------------------------------------------
class _QdqSte(torch.autograd.Function):
    """Forward = ``qdq``; backward passes the gradient where |x| <= alpha.

    Scales are dynamic (ABFP max) or static (calibrated): not learned, so
    they receive no gradient (eqn (5) differentiates w.r.t. x only).
    """

    @staticmethod
    def forward(ctx, x, alpha, fmt):
        ctx.save_for_backward(x, alpha.abs())
        return qdq(x, alpha, fmt)

    @staticmethod
    def backward(ctx, g):
        x, a = ctx.saved_tensors
        return g * (x.abs() <= a).to(g.dtype), None, None


def qdq_ste(x: torch.Tensor, alpha, fmt: Format) -> torch.Tensor:
    return _QdqSte.apply(x, _as_tensor(alpha, x), fmt)


def maybe_ste(x, alpha, fmt, ste: bool):
    """Dispatch between plain QDQ (PTQ / eval) and STE QDQ (QAT)."""
    if ste:
        return qdq_ste(x, alpha, fmt)
    return qdq(x, alpha, fmt)
