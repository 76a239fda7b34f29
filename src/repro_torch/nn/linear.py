"""Dense layer with the INT-FP-QSim quantization chokepoint attached.

Kernels are stored flat (K, N) — multi-dim heads are reshaped by callers —
so the quant simulator and the kernels all see one canonical contraction
layout.

Supports the SmoothQuant folded form: if params carry a 'smooth' vector the
input is divided by it (the kernel has been pre-multiplied), eqns in
core/smoothquant.py.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.policy import Policy
from repro_torch.core.simulate import qmatmul
from repro_torch.nn.module import truncated_normal


@dataclasses.dataclass(frozen=True)
class Dense:
    in_dim: int
    out_dim: int
    use_bias: bool = False
    param_dtype: str = "float32"
    dtype: str = "float32"
    name: str = "dense"
    init_std: float | None = None  # default: 1/sqrt(in_dim) scaled normal

    def init(self, gen: torch.Generator, device="cuda") -> dict:
        std = self.init_std
        if std is None:
            std = self.in_dim**-0.5
        pdt = getattr(torch, self.param_dtype)
        p = {"kernel": truncated_normal(gen, (self.in_dim, self.out_dim),
                                        pdt, std, device)}
        if self.use_bias:
            p["bias"] = torch.zeros((self.out_dim,), dtype=pdt, device=device)
        return p

    def apply(self, params: dict, x: torch.Tensor, policy: Policy, *,
              q: dict | None = None) -> torch.Tensor:
        """q: optional quant-state slice {'in_alpha': ...} for static scales.

        ``policy`` may be a site-addressed PolicyMap — qmatmul resolves
        it against this layer's site address (``self.name``).  The kernel
        may be dense or a ``CompressedKernel`` (int codes + group scales):
        qmatmul's execution-backend dispatch consumes the codes directly."""
        dt = getattr(torch, self.dtype)
        if "smooth" in params:  # SmoothQuant runtime-divide form
            x = x / params["smooth"].to(x.dtype)
        in_alpha = None if q is None else q.get("in_alpha")
        y = qmatmul(x, params["kernel"], policy, site=self.name,
                    in_alpha=in_alpha, compute_dtype=dt)
        y = y.to(dt)
        if self.use_bias:
            y = y + params["bias"].to(y.dtype)
        return y


@dataclasses.dataclass(frozen=True)
class Embed:
    """Token embedding (+ optional tied readout).

    ``vocab`` here is the *padded* vocab (multiple of 256); logits for padded
    ids are masked by the model head.
    """

    vocab: int
    dim: int
    param_dtype: str = "float32"
    dtype: str = "float32"
    name: str = "embed"

    def init(self, gen: torch.Generator, device="cuda") -> dict:
        # 0.02 std (GPT-2/OPT convention): with tied readout a std-1 table
        # would put init logits at ~sqrt(d) scale and CE ~10x ln(V).
        return {"table": truncated_normal(
            gen, (self.vocab, self.dim), getattr(torch, self.param_dtype),
            0.02, device)}

    def apply(self, params: dict, ids: torch.Tensor) -> torch.Tensor:
        return params["table"][ids.long()].to(getattr(torch, self.dtype))

    def attend(self, params: dict, x: torch.Tensor,
               policy: Policy) -> torch.Tensor:
        """Tied-readout logits: x @ table.T (quantized like any linear)."""
        dt = getattr(torch, self.dtype)
        y = qmatmul(x, params["table"].t(), policy,
                    site=self.name + "/attend", compute_dtype=dt)
        return y.to(dt)
