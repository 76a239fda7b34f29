"""Numerical formats for INT-FP-QSim (PyTorch twin of ``repro.core.formats``).

The paper (§II-A) fixes weights to 4-bit and explores activations in:
INT4, INT8, FP4-E2M1, FP4-E1M2 and FP8-E4M3, with ABFP scales in BF16.

A format is a frozen dataclass exposing:
  * ``qmax_pos`` — the largest representable magnitude (α maps onto this).
  * ``qdq_unit(x)`` — quantize-dequantize of a tensor already scaled into the
    format's native range (i.e. |x| <= qmax_pos after clipping).

Integer formats use symmetric narrow-range quantization (``s = qmax/α``,
eqns (1)-(3) of the paper).  Float formats are generic saturating
minifloats: no inf/nan encodings, subnormals supported, round-to-nearest-
even (``torch.round``).

E4M3 follows OCP semantics: bias 7 and max normal 448 (the all-ones
exponent is used for normals, mantissa 111 reserved for NaN -> 1.75*2^8).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class IntFormat:
    """Symmetric signed integer format with ``bits`` total bits."""

    bits: int
    narrow_range: bool = True  # clip to +/-(2^(b-1)-1); standard symmetric

    @property
    def name(self) -> str:
        return f"int{self.bits}"

    @property
    def qmax_pos(self) -> float:
        return float(2 ** (self.bits - 1) - 1)

    @property
    def qmin(self) -> float:
        if self.narrow_range:
            return -self.qmax_pos
        return -float(2 ** (self.bits - 1))

    @property
    def levels(self) -> int:
        return int(self.qmax_pos - self.qmin) + 1

    def qdq_unit(self, x: torch.Tensor) -> torch.Tensor:
        """QDQ a tensor already expressed in integer units (scale applied)."""
        return torch.clamp(torch.round(x), self.qmin, self.qmax_pos)

    def quantize_unit(self, x: torch.Tensor,
                      dtype=torch.int8) -> torch.Tensor:
        """Quantize (no dequant) to a storage dtype (int8 codes, or a float
        dtype holding the same integers for float-domain contractions)."""
        return torch.clamp(torch.round(x), self.qmin, self.qmax_pos).to(dtype)


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    """Saturating minifloat: ``exp_bits`` exponent, ``man_bits`` mantissa.

    ``bias`` defaults to ``2^(E-1)-1``.  OCP-style formats whose top
    exponent code holds normals override ``max_value``.
    """

    exp_bits: int
    man_bits: int
    bias: int | None = None
    max_value: float | None = None  # override for OCP-style formats

    @property
    def name(self) -> str:
        return f"e{self.exp_bits}m{self.man_bits}"

    @property
    def bits(self) -> int:
        return 1 + self.exp_bits + self.man_bits

    @property
    def _bias(self) -> int:
        if self.bias is not None:
            return self.bias
        return 2 ** (self.exp_bits - 1) - 1

    @property
    def max_biased_exp(self) -> int:
        # No inf/nan encodings by default: all exponent codes are numeric.
        return 2**self.exp_bits - 1

    @property
    def min_normal_exp(self) -> int:
        # biased exponent 0 encodes subnormals.
        return 1 - self._bias

    @property
    def qmax_pos(self) -> float:
        if self.max_value is not None:
            return float(self.max_value)
        frac = 2.0 - 2.0 ** (-self.man_bits)
        return frac * 2.0 ** (self.max_biased_exp - self._bias)

    def qdq_unit(self, x: torch.Tensor) -> torch.Tensor:
        """Round ``x`` to the nearest representable minifloat (saturating).

        Exponent extraction is ``torch.frexp`` and the quantum is built
        with ``torch.ldexp`` — both exact, so outputs always sit on the
        representable grid (a ``log2``/``exp2`` pair is an approximation
        and can land off-grid for large-exponent formats such as e5m2).
        """
        dtype = x.dtype
        xf = x.to(torch.float32)
        absx = xf.abs()
        # Exponent of each element; zeros map to the subnormal exponent.
        safe = torch.where(absx > 0, absx, torch.ones_like(absx))
        # frexp: safe = m * 2**ex with m in [0.5, 1) => floor(log2) = ex - 1
        e = torch.frexp(safe).exponent - 1
        e = torch.clamp(e, self.min_normal_exp,
                        self.max_biased_exp - self._bias)
        quantum = torch.ldexp(torch.ones_like(xf), e - self.man_bits)
        q = torch.round(xf / quantum) * quantum  # round-half-even
        # Rounding up can bump the exponent (1.96 -> 2.0); still
        # representable because the mantissa wraps to 0 at e+1.
        limit = self.qmax_pos
        q = torch.clamp(q, -limit, limit)
        q = torch.where(absx == 0, torch.zeros_like(q), q)
        return q.to(dtype)


Format = Union[IntFormat, FloatFormat]

# ---------------------------------------------------------------------------
# The formats studied in the paper.
# ---------------------------------------------------------------------------
INT4 = IntFormat(bits=4)
INT8 = IntFormat(bits=8)
FP4_E2M1 = FloatFormat(exp_bits=2, man_bits=1)  # bias 1, max 6.0
FP4_E1M2 = FloatFormat(exp_bits=1, man_bits=2)  # bias 0, max 3.5
FP8_E4M3 = FloatFormat(exp_bits=4, man_bits=3, max_value=448.0)  # OCP
FP8_E5M2 = FloatFormat(exp_bits=5, man_bits=2, bias=15, max_value=57344.0)

BY_NAME: dict[str, Format] = {
    f.name: f for f in (INT4, INT8, FP4_E2M1, FP4_E1M2, FP8_E4M3, FP8_E5M2)
}
BY_NAME["int2"] = IntFormat(bits=2)
BY_NAME["int3"] = IntFormat(bits=3)
BY_NAME["int6"] = IntFormat(bits=6)


def get_format(name: str) -> Format:
    try:
        return BY_NAME[name.lower()]
    except KeyError as e:
        raise ValueError(
            f"unknown format {name!r}; known: {sorted(BY_NAME)}"
        ) from e


def representable_values(fmt: Format) -> np.ndarray:
    """Enumerate all non-negative representable magnitudes (for tests)."""
    if isinstance(fmt, IntFormat):
        return np.arange(0.0, fmt.qmax_pos + 1.0)
    vals = {0.0}
    for be in range(fmt.max_biased_exp + 1):
        for m in range(2**fmt.man_bits):
            if be == 0:  # subnormal
                v = (m / 2**fmt.man_bits) * 2.0**fmt.min_normal_exp
            else:
                v = (1.0 + m / 2**fmt.man_bits) * 2.0 ** (be - fmt._bias)
            if v <= fmt.qmax_pos:
                vals.add(float(v))
    return np.array(sorted(vals))
