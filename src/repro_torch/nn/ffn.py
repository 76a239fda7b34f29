"""Feed-forward blocks: dense (relu/gelu/silu) and gated (swiglu/geglu)."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.core.policy import Policy
from repro_torch.nn.linear import Dense

_ACTS = {
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
}

GATED = {"swiglu": "silu", "geglu": "gelu", "reglu": "relu"}


@dataclasses.dataclass(frozen=True)
class MLP:
    d_model: int
    d_ff: int
    act: str = "swiglu"  # gated or plain activation name
    use_bias: bool = False
    param_dtype: str = "float32"
    dtype: str = "float32"
    name: str = "mlp"

    @property
    def gated(self) -> bool:
        return self.act in GATED

    def _wi(self):
        return Dense(self.d_model, self.d_ff, use_bias=self.use_bias,
                     param_dtype=self.param_dtype, dtype=self.dtype,
                     name=f"{self.name}/wi")

    def _wo(self):
        return Dense(self.d_ff, self.d_model, use_bias=self.use_bias,
                     param_dtype=self.param_dtype, dtype=self.dtype,
                     name=f"{self.name}/wo")

    def init(self, gen: torch.Generator, device="cuda") -> dict:
        p = {"wi": self._wi().init(gen, device),
             "wo": self._wo().init(gen, device)}
        if self.gated:
            p["wg"] = self._wi().init(gen, device)
        return p

    def apply(self, params: dict, x: torch.Tensor,
              policy: Policy) -> torch.Tensor:
        h = self._wi().apply(params["wi"], x, policy)
        if self.gated:
            g = self._wi().apply(params["wg"], x, policy)
            h = _ACTS[GATED[self.act]](g) * h
        else:
            h = _ACTS[self.act](h)
        return self._wo().apply(params["wo"], h, policy)
