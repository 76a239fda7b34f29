"""Fused ABFP quantize-dequantize: CUDA kernel wrapper + plain version.

``abfp_qdq`` replaces the TPU kernel ``repro/kernels/abfp_qdq.py::abfp_qdq``
(body ``_kernel``, helper ``_qdq_tile``): per group of ``n`` along the last
dim of ``x (M, K)``, the group max is rounded to a bf16 scale, floored at
1e-12, and the group is quantized to ``fmt`` and dequantized — one read and
one write of ``x``.  The reference runs it on no model path (tests only);
its group QDQ is the one ``abfp_matmul`` applies to both operands, and the
two kernels share that device code (``csrc/abfp_qdq.cuh``).

On an H100 the call is bound by bytes (8 per element).  A CUDA tensor
launches the kernel (``csrc/abfp_qdq.cu``) or raises; a CPU tensor runs
``abfp_qdq_plain``, which is bit-exact against the kernel and against the
reference.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.formats import Format, IntFormat
from repro_torch.core.quantize import div_by_constant
from repro_torch.kernels import build


def format_args(fmt: Format) -> tuple:
    """The kernels' description of a format: (is_int, qmax, qmin, man_bits,
    min_exp, max_exp) — see ``QdqFormat`` in ``csrc/abfp_qdq.cuh``."""
    if isinstance(fmt, IntFormat):
        return 1, float(fmt.qmax_pos), float(fmt.qmin), 0, 0, 0
    return (0, float(fmt.qmax_pos), 0.0, int(fmt.man_bits),
            int(fmt.min_normal_exp), int(fmt.max_biased_exp - fmt._bias))


def _check(x: torch.Tensor, n: int):
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    M, K = x.shape
    if K % n:
        raise ValueError(
            f"last dim K={K} is not a multiple of the ABFP group length "
            f"n={n}")
    return M, K


def qdq_groups(xg: torch.Tensor, fmt: Format) -> torch.Tensor:
    """QDQ a (..., G, n) f32 block against its per-group max — the ops of
    the reference's ``_qdq_tile`` with bf16 scales."""
    alpha = xg.abs().amax(dim=-1, keepdim=True)
    alpha = torch.clamp_min(alpha.to(torch.bfloat16).to(torch.float32),
                            1e-12)
    scale = div_by_constant(alpha, fmt.qmax_pos)
    if isinstance(fmt, IntFormat):
        q = torch.clamp(torch.round(xg / scale), fmt.qmin, fmt.qmax_pos)
        return q * scale
    return fmt.qdq_unit(xg / scale) * scale


def abfp_qdq_plain(x: torch.Tensor, fmt: Format, n: int = 64) -> torch.Tensor:
    """Plain PyTorch version of ``abfp_qdq`` (same arguments)."""
    M, K = _check(x, n)
    xg = x.to(torch.float32).reshape(M, K // n, n)
    return qdq_groups(xg, fmt).reshape(M, K).to(x.dtype)


def _bind(lib: ctypes.CDLL):
    fn = lib.repro_abfp_qdq
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, ctypes.c_longlong, i, i, i, f, f, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def abfp_qdq(x: torch.Tensor, fmt: Format, n: int = 64) -> torch.Tensor:
    """Fused ABFP QDQ along the last dim of a 2-D f32 tensor ``(M, K)``."""
    if x.device.type == "cpu":
        return abfp_qdq_plain(x, fmt, n)
    if x.device.type != "cuda":
        raise ValueError(f"abfp_qdq: unsupported device {x.device}")
    M, K = _check(x, n)
    if x.dtype != torch.float32:
        raise ValueError(f"abfp_qdq: x must be float32, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("abfp_qdq: x must be contiguous")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    fn = _bind(build.load("abfp_qdq"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), M, K, n, *format_args(fmt),
                 stream)
    abfp_qdq.launches += 1
    if err != 0:
        raise RuntimeError(f"abfp_qdq kernel launch failed: CUDA error {err}")
    return y


abfp_qdq.launches = 0  # kernel launches made through this wrapper
