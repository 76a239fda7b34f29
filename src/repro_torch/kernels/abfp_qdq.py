"""Fused ABFP quantize-dequantize: CUDA kernel wrapper + plain version.

``abfp_qdq`` replaces the TPU kernel ``repro/kernels/abfp_qdq.py::abfp_qdq``
(body ``_kernel``, helper ``_qdq_tile``): per group of ``n`` along the last
dim of ``x (M, K)``, the group max is rounded to a bf16 scale, floored at
1e-12, and the group is quantized to ``fmt`` and dequantized in f32, then
written back in ``x``'s dtype (f32, bf16 or f16) — one read and one write
of ``x``.  The reference runs it on no model path (tests only); its group
QDQ is the one ``abfp_matmul`` applies to both operands, and the kernel
that QDQs ``x`` before ``abfp_matmul``'s decode and SIMT contractions is
this one (``csrc/abfp_qdq.cuh``).

On an H100 the call is bound by bytes (8 an element in f32, 4 in bf16 /
f16).  A CUDA tensor launches the kernel (``csrc/abfp_qdq.cu``, planned
by ``plan_qdq``) or raises; a CPU tensor runs ``abfp_qdq_plain``, which is
bit-exact against the kernel and against the reference.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core.formats import Format, IntFormat
from repro_torch.core.quantize import div_by_constant
from repro_torch.kernels import build, refuse_grad

SMS = 132  # streaming multiprocessors of an H100 SXM

# qdq_stream_kernel's constants (abfp_qdq.cuh)
QDQ_THREADS = 128        # most threads of a block (kStreamThreads)
QDQ_MAX_VPL = 8          # most loads a lane holds of a group (kStreamMaxVpl)
QDQ_ROWS_WARPS = 8       # warps of a qdq_rows_kernel block (kQdqWarps)
QDQ_MODES = ("int", "minifloat", "generic")  # QdqMode
# the dtypes the kernel takes, by the C entry's dtype code
QDQ_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def format_args(fmt: Format) -> tuple:
    """The kernels' description of a format: (is_int, qmax, qmin, man_bits,
    min_exp, max_exp) — see ``QdqFormat`` in ``csrc/abfp_qdq.cuh``."""
    if isinstance(fmt, IntFormat):
        return 1, float(fmt.qmax_pos), float(fmt.qmin), 0, 0, 0
    return (0, float(fmt.qmax_pos), 0.0, int(fmt.man_bits),
            int(fmt.min_normal_exp), int(fmt.max_biased_exp - fmt._bias))


def minifloat_fast(fmt: Format) -> bool:
    """Whether the kernels take a minifloat's exponent and quantum from the
    bits and multiply by the quantum's reciprocal (``qdq_unit_minifloat``):
    every quantum 2^(e - man_bits) and its reciprocal a normal f32."""
    if isinstance(fmt, IntFormat):
        return False
    _, _, _, man, lo, hi = format_args(fmt)
    return all(-126 <= e - man <= 126 for e in (lo, hi))


def stream_blocks_per_sm(elems: int) -> int:
    """Resident ``qdq_stream_kernel`` blocks an SM (its launch bounds,
    ``stream_blocks_per_sm`` of the header) for a lane holding ``elems``
    elements of a group: 16 up to 4 (f32, one load), 12 up to 16, else 8."""
    return 16 if elems <= 4 else 12 if elems <= 16 else 8


def qdq_lanes(loads: int) -> tuple[int, int]:
    """(lanes, loads a lane) for a group of ``loads`` loads: the widest
    power-of-two set of at most 32 lanes that divides them."""
    lanes = min(loads & -loads, 32)  # largest power of two dividing loads
    return lanes, loads // lanes


class QdqPlan(NamedTuple):
    """How one QDQ of contiguous groups launches (``plan_qdq``); the C
    entries take it as a ``repro::QdqPlan``."""
    kernel: str     # "qdq_stream_kernel" or "qdq_rows_kernel"
    vec: bool       # 16-byte loads (else one element a load)
    width: int      # elements a load
    lanes: int      # lanes a group (a power of two <= 32)
    vpl: int        # loads a lane holds of a group
    mode: str       # "int", "minifloat" (bits) or "generic" (rows kernel)
    threads: int    # threads a block
    blocks: int     # blocks


class _PlanC(ctypes.Structure):
    _fields_ = [(name, ctypes.c_int) for name in (
        "rows_kernel", "vec", "lanes", "vpl", "mode", "threads", "blocks")]


def plan_struct(plan: QdqPlan) -> _PlanC:
    """The plan as the C entries take it (``repro::QdqPlan``)."""
    return _PlanC(int(plan.kernel == "qdq_rows_kernel"), int(plan.vec),
                  plan.lanes, plan.vpl, QDQ_MODES.index(plan.mode),
                  plan.threads, plan.blocks)


def plan_qdq(n_groups: int, n: int, itemsize: int, aligned: bool,
             fmt: Format, sms: int = SMS) -> QdqPlan:
    """The launch of a QDQ of ``n_groups`` contiguous groups of ``n``
    elements of ``itemsize`` bytes; ``aligned``: both base pointers are
    16-byte aligned.  16-byte loads where every group starts on the
    16-byte grid, else one element a load; a group longer than
    ``QDQ_MAX_VPL`` loads a lane, or a minifloat whose quanta are not all
    normal (``minifloat_fast``), takes ``qdq_rows_kernel``.  Blocks of 128
    threads, at most ``stream_blocks_per_sm`` an SM (a grid-stride loop
    beyond); a call too small to give every SM a block of 128 takes blocks
    of 64 or 32 threads, so that its groups still spread over the SMs."""
    mode = ("int" if isinstance(fmt, IntFormat)
            else "minifloat" if minifloat_fast(fmt) else "generic")
    vec = aligned and (n * itemsize) % 16 == 0
    width = 16 // itemsize if vec else 1
    lanes, vpl = qdq_lanes(n // width)
    if vpl > QDQ_MAX_VPL or mode == "generic":
        return QdqPlan("qdq_rows_kernel", False, 1, 32, -(-n // 32), mode,
                       QDQ_ROWS_WARPS * 32,
                       max(1, -(-n_groups // QDQ_ROWS_WARPS)))
    threads_needed = n_groups * lanes
    threads = next((t for t in (QDQ_THREADS, 64)
                    if -(-threads_needed // t) >= sms), 32)
    blocks = max(1, min(-(-threads_needed // threads),
                        sms * stream_blocks_per_sm(vpl * width)))
    return QdqPlan("qdq_stream_kernel", vec, width, lanes, vpl, mode,
                   threads, blocks)


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
        fn.argtypes = [p, p, ctypes.c_longlong, i, i, p, i, f, f, i, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def abfp_qdq(x: torch.Tensor, fmt: Format, n: int = 64) -> torch.Tensor:
    """Fused ABFP QDQ along the last dim of a 2-D f32, bf16 or f16 tensor
    ``(M, K)``; returns a tensor of ``x``'s dtype."""
    refuse_grad("abfp_qdq", x)
    if x.device.type == "cpu":
        return abfp_qdq_plain(x, fmt, n)
    if x.device.type != "cuda":
        raise ValueError(f"abfp_qdq: unsupported device {x.device}")
    M, K = _check(x, n)
    if x.dtype not in QDQ_DTYPES:
        raise ValueError(f"abfp_qdq: x must be float32, bfloat16 or float16, "
                         f"got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("abfp_qdq: x must be contiguous")
    y = torch.empty_like(x)
    if x.numel() == 0:
        return y
    plan = plan_qdq(M * (K // n), n, x.element_size(),
                    x.data_ptr() % 16 == 0 and y.data_ptr() % 16 == 0, fmt)
    fn = _bind(build.load("abfp_qdq"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), y.data_ptr(), M * (K // n), n,
                 QDQ_DTYPES.index(x.dtype), ctypes.byref(plan_struct(plan)),
                 *format_args(fmt), stream)
    abfp_qdq.launches += 1
    abfp_qdq.launches_by_kernel[plan.kernel] += 1
    if err != 0:
        raise RuntimeError(f"abfp_qdq kernel launch failed: CUDA error {err}")
    return y


abfp_qdq.launches = 0  # kernel launches made through this wrapper
abfp_qdq.launches_by_kernel = {"qdq_stream_kernel": 0, "qdq_rows_kernel": 0}
