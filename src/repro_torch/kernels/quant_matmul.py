"""Compressed-domain quantized matmul: CUDA kernel wrapper + plain version.

``quant_matmul`` replaces the TPU kernel
``repro/kernels/quant_matmul.py::quant_matmul`` (body
``_stored_codes_kernel``):

    y[m, c] = sum_g sx[m, g] * ws[c, g] * (xc[m, g, :] . wc[c, g, :])

``x (M, K)`` f32 is ABFP-quantized per group of ``n`` along K inside the
call; the weight arrives as stored integer codes ``(N, G, n)`` int8 — or
``(N, G, n // 2)`` uint8 nibble pairs when ``packed`` — plus f32 unit
scales ``(N, G)``.  Group products are summed as integers, the per-group
rescale and the sum across groups are f32.

On an H100 the call is bound by reading the weight codes once at decode
(M = a handful of rows: about N*K bytes of int8 codes, half that for
packed 4-bit codes) and by integer multiply-accumulate at prefill; the
kernel (``csrc/quant_matmul.cu``) therefore reads packed codes as stored
and unpacks them in registers, and quantizes x once in a first stage
instead of once per output tile.  See the source for the design.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
``quant_matmul_plain``, which the CPU tests hold against the reference
package and which a chip run holds the kernel against.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core import abfp as abfp_mod
from repro_torch.core.formats import Format, IntFormat
from repro_torch.core.quantize import unpack_int4_codes
from repro_torch.kernels import build


def group_contract(xc: torch.Tensor, xs: torch.Tensor, wc: torch.Tensor,
                   ws: torch.Tensor, *, max_abs_product: float
                   ) -> torch.Tensor:
    """``y[.., c] = sum_g xs[.., g] * ws[c, g] * (xc[.., g, :] . wc[c, g, :])``.

    ``xc (..., G, n)`` and ``wc (N, G, n)`` hold integer-valued codes (any
    dtype); the group dot products are exact integers.  PyTorch has no
    integer matmul on CUDA and an int32 einsum is slow on the CPU, so the
    codes are contracted in floating point: float32 is exact while
    ``n * max|xc * wc| < 2**24`` (n = 64 int8 x int8: 1,032,256), float64
    beyond that.  TF32 would break that exactness, so it is switched off.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    n = xc.shape[-1]
    dt = torch.float32 if n * max_abs_product < 2 ** 24 else torch.float64
    lead = xc.shape[:-2]
    G = xc.shape[-2]
    xg = xc.reshape(-1, G, n).to(dt).permute(1, 0, 2)      # (G, M, n)
    wg = wc.to(dt).permute(1, 2, 0)                        # (G, n, N)
    partial = torch.bmm(xg, wg).permute(1, 0, 2)           # (M, G, N)
    partial = partial.to(torch.float32)
    xs2 = xs.reshape(-1, G).to(torch.float32)
    y = ((partial * xs2[:, :, None])
         * ws.to(torch.float32).t()[None]).sum(dim=1)
    return y.reshape(*lead, wc.shape[0])


def _check_shapes(x, w_codes, w_scales, n: int, packed: bool):
    if x.ndim != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if w_codes.ndim != 3:
        raise ValueError(
            f"w_codes must be (N, G, n) grouped codes, got "
            f"{tuple(w_codes.shape)}")
    M, K = x.shape
    N, G, n2 = w_codes.shape
    if packed:
        n2 *= 2
    if n2 != n:
        raise ValueError(
            f"stored group length {n2} (w_codes.shape="
            f"{tuple(w_codes.shape)}, packed={packed}) != requested n={n}")
    if G * n != K:
        raise ValueError(
            f"stored codes cover K={G * n} (G={G}, n={n}) but x has K={K}")
    if tuple(w_scales.shape) != (N, G):
        raise ValueError(
            f"w_scales shape {tuple(w_scales.shape)} != (N, G)=({N}, {G})")
    return M, K, N, G


def quant_matmul_plain(x: torch.Tensor, w_codes: torch.Tensor,
                       w_scales: torch.Tensor, fmt_x: Format, n: int = 64,
                       packed: bool = False) -> torch.Tensor:
    """Plain PyTorch version of ``quant_matmul`` (same arguments)."""
    _check_shapes(x, w_codes, w_scales, n, packed)
    codes = unpack_int4_codes(w_codes) if packed else w_codes
    xc, xs, _ = abfp_mod.abfp_quantize(
        x.to(torch.float32), fmt_x, axis=-1, n=n, dtype=torch.float32)
    w_bound = 8.0 if packed else 128.0
    return group_contract(xc, xs, codes, w_scales,
                          max_abs_product=fmt_x.qmax_pos * w_bound)


def _bind(lib: ctypes.CDLL):
    fn = lib.repro_quant_matmul
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, f, p]
        fn.restype = ctypes.c_int
    return fn


def quant_matmul(x: torch.Tensor, w_codes: torch.Tensor,
                 w_scales: torch.Tensor, fmt_x: Format, n: int = 64,
                 packed: bool = False) -> torch.Tensor:
    """Compressed-domain matmul: ``x (M, K)`` f32 vs stored weight codes.

    ``w_codes``: (N, G, n) int8 codes, or (N, G, n // 2) uint8 nibble pairs
    when ``packed`` (G * n == K); ``w_scales``: (N, G) f32 unit scales.
    Returns (M, N) f32.  Only x is quantized (against the integer format
    ``fmt_x``, bf16 group scales); the dense kernel is never materialized.
    """
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_codes, w_scales, fmt_x, n, packed)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    M, K, N, G = _check_shapes(x, w_codes, w_scales, n, packed)
    if not isinstance(fmt_x, IntFormat) or fmt_x.bits > 8:
        raise ValueError(
            f"quant_matmul quantizes x to int8 codes; got format {fmt_x}")
    cpl = 32 if packed else 16  # codes a lane takes per step in the kernel
    lpg = n // cpl
    if n % cpl or lpg & (lpg - 1) or lpg > 32:
        raise ValueError(
            f"quant_matmul kernel needs a group length that is {cpl} times "
            f"a power of two <= 32 (packed={packed}); got n={n}")
    want = torch.uint8 if packed else torch.int8
    for name, t, dt in (("x", x, torch.float32), ("w_codes", w_codes, want),
                        ("w_scales", w_scales, torch.float32)):
        if t.dtype != dt:
            raise ValueError(f"quant_matmul: {name} must be {dt}, got "
                             f"{t.dtype}")
        if t.device != x.device:
            raise ValueError(f"quant_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous")
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if M == 0:
        return y
    xc = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, G), dtype=torch.float32, device=x.device)
    fn = _bind(build.load("quant_matmul"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), w_codes.data_ptr(), w_scales.data_ptr(),
                 xc.data_ptr(), sx.data_ptr(), y.data_ptr(), M, N, K, n,
                 int(packed), float(fmt_x.qmax_pos), float(fmt_x.qmin),
                 stream)
    quant_matmul.launches += 1
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    return y


quant_matmul.launches = 0  # kernel launches made through this wrapper
