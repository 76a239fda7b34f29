"""Static calibration (paper §II-B1).

The paper uses per-channel max calibration for weights and MSE calibration
for activations (TensorRT-style), plus "static max" where the max over a
calibration subset is reused at inference.

Calibration runs sample batches through the model with an observer that
accumulates per-tensor / per-channel statistics, then solves for the clip
range alpha.  The statistics stay tensors on the device the activations
live on (absmax, per-channel min / max, the reservoir rows and the f64
X^T X of GPTQ): nothing is copied to the host per site or batch.  Only the
reservoir's row indices are drawn on the host, with the reference's numpy
generator, and gathered on the device.  The resulting ``{site: alpha}``
map becomes the static-scale q tree threaded through model apply (see
``repro_torch.models.quant_transforms``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import Format
from repro_torch.core.quantize import qdq


# ---------------------------------------------------------------------------
# Observers: running statistics over calibration batches.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class RunningStats:
    """Accumulates |x| max / moments; channel axis optional (last dim)."""

    absmax: torch.Tensor | float = 0.0  # 0-d f32 tensor once updated
    ch_absmax: torch.Tensor | None = None
    ch_min: torch.Tensor | None = None
    ch_max: torch.Tensor | None = None
    count: int = 0
    samples: list = dataclasses.field(default_factory=list)
    max_samples: int = 8
    collect_outer: bool = False  # accumulate X^T X for GPTQ Hessians
    outer: torch.Tensor | None = None  # (C, C) float64

    def update(self, x: torch.Tensor) -> None:
        flat = x.detach().to(torch.float32).reshape(-1, x.shape[-1])
        if self.collect_outer:
            f = flat.to(torch.float64)
            o = f.T @ f
            self.outer = o if self.outer is None else self.outer + o
        cmax = flat.abs().amax(dim=0)
        cmin_v = flat.amin(dim=0)
        cmax_v = flat.amax(dim=0)
        prev = torch.as_tensor(self.absmax, dtype=torch.float32,
                               device=flat.device)
        self.absmax = torch.maximum(cmax.amax(), prev)
        if self.ch_absmax is None:
            self.ch_absmax, self.ch_min, self.ch_max = cmax, cmin_v, cmax_v
        else:
            self.ch_absmax = torch.maximum(self.ch_absmax, cmax)
            self.ch_min = torch.minimum(self.ch_min, cmin_v)
            self.ch_max = torch.maximum(self.ch_max, cmax_v)
        self.count += flat.shape[0]
        if len(self.samples) < self.max_samples:
            # Keep a bounded reservoir of rows for MSE search: the
            # reference's index draw, gathered on the device.
            take = min(4096, flat.shape[0])
            idx = np.random.RandomState(self.count).choice(
                flat.shape[0], size=take, replace=False
            )
            self.samples.append(flat[torch.from_numpy(idx).to(flat.device)])


# ---------------------------------------------------------------------------
# Solvers: statistics -> clip range alpha.
# ---------------------------------------------------------------------------
def max_alpha(stats: RunningStats, per_channel: bool = False) -> torch.Tensor:
    if per_channel:
        return torch.clamp_min(stats.ch_absmax, 1e-8)
    return torch.clamp_min(
        torch.as_tensor(stats.absmax, dtype=torch.float32), 1e-8)


def linspace_fracs(num: int) -> torch.Tensor:
    """The candidate fractions ``jnp.linspace(1/num, 1, num)`` in float32,
    bit for bit (``torch.linspace`` uses another formula).  The reference's
    compiled form is ``start * (1 - step) + stop * step`` with ``step = i *
    (1/(num - 1))`` (the divide by a constant becomes a multiply by its
    float32 reciprocal) and the final add fused with ``i * r`` into one
    rounding (``fma(i, r, start * (1 - step))``), the stop appended.  Done
    here in numpy: ``i * r`` is exact in float64 (24 x 24 bits)."""
    f32 = np.float32
    start, stop = f32(1.0 / num), f32(1.0)
    if num == 1:
        return torch.from_numpy(np.array([start], np.float32))
    i = np.arange(num - 1, dtype=np.float32)
    r = f32(1.0) / f32(num - 1)
    step = i * r
    head = start * (f32(1.0) - step)
    out = (i.astype(np.float64) * np.float64(r)
           + head.astype(np.float64)).astype(np.float32)
    return torch.from_numpy(np.append(out, stop).astype(np.float32))


# candidates whose QDQ'd copies are alive at once: bounds the search's
# working memory (4 f32 temporaries of this many elements)
_SEARCH_ELEMS = 1 << 25


def _grid_errors(x: torch.Tensor, amax: torch.Tensor, fracs: torch.Tensor,
                 fmt: Format, per_channel: bool) -> torch.Tensor:
    """Mean squared QDQ error of ``x`` at each candidate ``amax * frac``:
    (num,) or (num, C).  The squared errors are the reference's f32 values;
    they are summed in float64, so the order of the sum moves no choice
    but a near-tie's."""
    rows = x.shape[0]
    chunk = max(1, _SEARCH_ELEMS // max(1, x.numel()))
    out = []
    for c0 in range(0, fracs.shape[0], chunk):
        f = fracs[c0:c0 + chunk]
        a = amax[None] * f.reshape((-1,) + (1,) * amax.ndim)  # (k[, C])
        a = a.reshape(a.shape[0], 1, -1)  # (k, 1, 1 or C)
        err = (qdq(x[None], a, fmt) - x[None]) ** 2  # (k, R, C)
        if per_channel:
            out.append(err.sum(dim=1, dtype=torch.float64) / rows)
        else:
            out.append(err.sum(dim=(1, 2), dtype=torch.float64)
                       / x.numel())
    return torch.cat(out)


def mse_alpha(
    stats: RunningStats,
    fmt: Format,
    num_candidates: int = 100,
    per_channel: bool = False,
) -> torch.Tensor:
    """Grid-search alpha minimizing E||QDQ(x; a) - x||^2 (paper §II-B1).

    Candidates sweep (i/num) * absmax for i in 1..num, following the
    TensorRT-style linear search the paper builds on.
    """
    x = torch.cat(stats.samples, dim=0)  # (rows, C)
    amax = max_alpha(stats, per_channel=per_channel).to(x.device)
    fracs = linspace_fracs(num_candidates).to(x.device)
    errs = _grid_errors(x, amax, fracs, fmt, per_channel)
    best = torch.argmin(errs, dim=0)
    return amax * fracs[best]


def mse_alpha_tensor(
    x: torch.Tensor, fmt: Format, num_candidates: int = 100
) -> torch.Tensor:
    """One-shot per-tensor MSE alpha for an in-memory tensor (weights)."""
    x = x.reshape(-1, x.shape[-1])
    amax = torch.clamp_min(x.abs().amax(), 1e-8)
    fracs = linspace_fracs(num_candidates).to(x.device)
    errs = _grid_errors(x, amax, fracs, fmt, per_channel=False)
    return amax * fracs[torch.argmin(errs)]


# ---------------------------------------------------------------------------
# Whole-model calibration driver.
# ---------------------------------------------------------------------------
class Calibrator:
    """Collects activation stats at every quantized matmul site.

    Usage:
        calib = Calibrator()
        with calib.observing():
            model.apply(params, batch, policy)   # qdq_activation taps in
        qstate = calib.solve(fmt, method='mse')
    """

    _ACTIVE: list["Calibrator"] = []

    def __init__(self, collect_outer: bool = False) -> None:
        self.stats: dict[str, RunningStats] = {}
        self.collect_outer = collect_outer

    # --- observation hooks -------------------------------------------------
    def observe(self, site: str, x: torch.Tensor) -> None:
        st = self.stats.setdefault(
            site, RunningStats(collect_outer=self.collect_outer)
        )
        st.update(x)

    def observing(self):
        calib = self

        class _Ctx:
            def __enter__(self):
                Calibrator._ACTIVE.append(calib)
                return calib

            def __exit__(self, *exc):
                Calibrator._ACTIVE.remove(calib)
                return False

        return _Ctx()

    @classmethod
    def active(cls) -> "Calibrator | None":
        return cls._ACTIVE[-1] if cls._ACTIVE else None

    # --- solving ------------------------------------------------------------
    def solve(
        self,
        fmt: Format,
        method: str = "mse",
        per_channel: bool = False,
        num_candidates: int = 100,
    ) -> dict[str, torch.Tensor]:
        """Returns {site: alpha} — the QuantState for static activation quant."""
        out = {}
        for site, st in self.stats.items():
            if method == "max":
                out[site] = max_alpha(st, per_channel=per_channel)
            elif method == "mse":
                out[site] = mse_alpha(
                    st, fmt, num_candidates=num_candidates,
                    per_channel=per_channel,
                )
            else:
                raise ValueError(f"unknown calibration method {method!r}")
        return out
