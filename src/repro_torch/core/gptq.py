"""GPTQ (paper §II-B4): approximate second-order weight quantization.

The IST-DASLab algorithm on the weights' device in float64: iterate input
channels in blocks, quantize each row of the (K_in, N_out) kernel against
per-output-channel (optionally per-group) scales, and propagate the weighted
error to the remaining channels through the inverse Hessian Cholesky factor
(``torch.linalg``).  Two things come off the device: the act-order
permutation, which is numpy's ``argsort`` of the Hessian diagonal (not
stable on ties, so the port takes numpy's order), and the summed loss.

H = sum_b X_b X_b^T over calibration activations (the constant 2 cancels).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.formats import FloatFormat, Format, IntFormat
from repro_torch.core.quantize import div_by_constant


@dataclasses.dataclass
class GPTQConfig:
    percdamp: float = 0.01
    blocksize: int = 128
    group_size: int = -1  # -1: one scale per output channel over all K
    actorder: bool = False


def float_exponent(x: torch.Tensor) -> torch.Tensor:
    """``floor(log2(|x|))`` of float32 values, taken as the reference takes
    it: ``log2`` rounded to float32, then floored — just below a power of
    two the rounded log2 reaches the integer.  The log2 is taken in float64
    and rounded once to float32, so the exponent does not hang on the last
    bit of a device's float32 ``log2``.  Zeros give 0."""
    absx = x.abs()
    safe = torch.where(absx > 0, absx, torch.ones_like(absx))
    return torch.floor(torch.log2(safe.to(torch.float64)).to(torch.float32))


def _float_qdq(x: torch.Tensor, fmt: FloatFormat) -> torch.Tensor:
    """Minifloat QDQ of float32 values ``x``, in float64: the exponent from
    ``float_exponent``, the quantum an exact power of two, round half to
    even, saturate."""
    e = torch.clamp(float_exponent(x), fmt.min_normal_exp,
                    fmt.max_biased_exp - fmt._bias)
    ones = torch.ones_like(x, dtype=torch.float64)
    quantum = torch.ldexp(ones, (e - fmt.man_bits).to(torch.int32))
    q = torch.round(x.to(torch.float64) / quantum) * quantum
    q = torch.clamp(q, -fmt.qmax_pos, fmt.qmax_pos)
    return torch.where(x == 0, torch.zeros_like(q), q)


def _quant_col(row: torch.Tensor, scale: torch.Tensor, fmt: Format,
               out: torch.Tensor | None = None) -> torch.Tensor:
    """QDQ one input-channel row (N,) against per-channel scales (N,)
    (into ``out`` when given)."""
    if isinstance(fmt, IntFormat):
        q = torch.div(row, scale).round_().clamp_(fmt.qmin, fmt.qmax_pos)
        return torch.mul(q, scale, out=out)
    # the float32 image of the scaled row, as the reference quantizes it
    return torch.mul(_float_qdq((row / scale).to(torch.float32), fmt),
                     scale, out=out)


def gptq_quantize(w: torch.Tensor, hessian: torch.Tensor, fmt: Format,
                  cfg: GPTQConfig = GPTQConfig()) -> tuple[torch.Tensor, dict]:
    """Quantize kernel ``w (K, N)`` given Hessian ``H (K, K)``, on ``w``'s
    device.

    Returns (w_qdq float32, info).  ``w_qdq`` replaces the kernel; the
    caller should then run with a policy that does NOT re-quantize weights
    (w4a16-style) or accepts the idempotent re-quantization error.
    """
    dev = w.device
    w = w.detach().to(torch.float64).clone()
    K, N = w.shape
    H = torch.as_tensor(hessian).to(dev, torch.float64).clone()
    assert H.shape == (K, K)

    dead = torch.diagonal(H) == 0
    di = dead.nonzero()[:, 0]
    H[di, di] = 1.0
    w[dead, :] = 0.0

    perm = None
    if cfg.actorder:
        order = np.argsort(-torch.diagonal(H).cpu().numpy())
        perm = torch.from_numpy(order).to(dev)
        w = w[perm, :]
        H = H[perm][:, perm]

    damp = cfg.percdamp * torch.diagonal(H).mean()
    H.diagonal().add_(damp)

    # Inverse Hessian upper-Cholesky (as in the reference implementation).
    Hinv = torch.linalg.inv(H)
    # Symmetrize for numerical safety before Cholesky.
    Hinv = (Hinv + Hinv.T) / 2.0
    eye = torch.eye(K, dtype=torch.float64, device=dev)
    U = torch.linalg.cholesky(Hinv + 1e-12 * eye).T  # upper triangular

    group = cfg.group_size if cfg.group_size > 0 else K
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    scale = None
    for i1 in range(0, K, cfg.blocksize):
        i2 = min(i1 + cfg.blocksize, K)
        W1 = w[i1:i2, :].clone()
        Q1 = torch.zeros_like(W1)
        E1 = torch.zeros_like(W1)
        U1 = U[i1:i2, i1:i2]
        # row views made once a block: the column loop is launch-bound
        w_rows, q_rows, e_rows = W1.unbind(0), Q1.unbind(0), E1.unbind(0)
        u_rows, u_diag = U1.unbind(0), torch.diagonal(U1).unbind(0)
        for i in range(i2 - i1):
            k = i1 + i
            if k % group == 0:
                # refresh per-output-channel scales over the next group rows
                # (of w, not W1: rows of this block are not written back yet)
                g2 = min(k + group, K)
                alpha = torch.clamp_min(w[k:g2, :].abs().amax(dim=0), 1e-8)
                scale = div_by_constant(alpha, fmt.qmax_pos)
            q = _quant_col(w_rows[i], scale, fmt, out=q_rows[i])
            err = torch.sub(w_rows[i], q, out=e_rows[i]).div_(u_diag[i])
            if i + 1 < i2 - i1:
                W1[i + 1:].sub_(torch.outer(u_rows[i][i + 1:], err))
        loss += (E1 ** 2 / 2.0).sum()
        w[i1:i2, :] = Q1
        if i2 < K:
            w[i2:, :] -= U[i1:i2, i2:].T @ E1

    if perm is not None:
        w = w[torch.argsort(perm), :]

    info = {"loss": float(loss), "dead": int(dead.sum())}
    return w.to(torch.float32), info


def hessian_from_samples(samples: torch.Tensor) -> torch.Tensor:
    """H = X^T X for rows-of-activations ``samples (rows, K)``."""
    x = torch.as_tensor(samples).to(torch.float64)
    return x.T @ x
