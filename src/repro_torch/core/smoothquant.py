"""SmoothQuant (paper §II-B3): migrate quantization difficulty acts->weights.

Per-channel smoothing factors  s_j = a_j^alpha / w_j^(1-alpha)  with
alpha = 0.5 (the paper fixes 0.5 for all layers).  Activations are divided by
``s`` and weights multiplied, a mathematical identity pre-quantization that
tames activation outliers.

Folding: where the preceding op is a (RMS/Layer)Norm with a scale parameter,
``1/s`` folds into the norm scale for free; otherwise the layer keeps an
explicit ``smooth`` vector applied to its input.  Both paths are supported
by nn.linear.Dense via the ``smooth`` param entry; the model-level driver
lives in ``repro_torch.models.quant_transforms``.

The smoothing factors are computed on the host in numpy float32, as the
reference computes them: they are (K,) vectors, and neither PyTorch's CPU
``sqrt``/``pow`` nor a device's ``powf`` rounds as numpy's does.  They go
back to the statistics' device; the kernels and norms are scaled there.
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def smoothing_factors(act_absmax, weight_absmax,
                      alpha: float = 0.5) -> torch.Tensor:
    """s_j = max|X_j|^alpha / max|W_j|^(1-alpha), clipped away from 0;
    a float32 tensor on ``act_absmax``'s device (the CPU for numpy)."""
    dev = (act_absmax.device if isinstance(act_absmax, torch.Tensor)
           else "cpu")
    a = np.maximum(_host(act_absmax).astype(np.float32), 1e-5)
    w = np.maximum(_host(weight_absmax).astype(np.float32), 1e-5)
    s = a**alpha / w ** (1.0 - alpha)
    # Guard degenerate channels (dead activations): keep scale at 1.
    s = np.where(~np.isfinite(s) | (s < 1e-5), 1.0, s)
    return torch.from_numpy(s.astype(np.float32)).to(dev)


def smooth_linear(w: torch.Tensor, act_absmax, alpha: float = 0.5):
    """Compute (s, w*s) for a (K, N) kernel given input-channel absmax (K,)."""
    w_absmax = w.abs().amax(dim=tuple(range(1, w.ndim)))
    s = smoothing_factors(act_absmax, w_absmax, alpha).to(w.device)
    return s, w * s.reshape((-1,) + (1,) * (w.ndim - 1))


def fold_into_norm(norm_scale: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Fold 1/s into a preceding norm's scale parameter."""
    return norm_scale / s.to(norm_scale.dtype)
