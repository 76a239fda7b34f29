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
packed 4-bit codes); at a prefill chunk (M = 256) bytes and int8
tensor-core operations take about the same time.  The kernels
(``csrc/quant_matmul.cu``) read packed codes as stored and unpack them on
chip, and quantize x once in a first stage instead of once per output
tile.  Up to 16 rows ``contract_kernel`` contracts by ``__dp4a``; above 16
rows (and for group lengths it is not built for) ``int8_mma_kernel`` runs
the contraction on the int8 tensor cores, on the grid that
``plan_int8_contract`` chooses.  See the source for the design.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
``quant_matmul_plain``, which the CPU tests hold against the reference
package and which a chip run holds the kernel against.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.analysis.messages import abfp_group_message
from repro_torch.core import abfp as abfp_mod
from repro_torch.core.formats import Format, IntFormat
from repro_torch.core.quantize import unpack_int4_codes
from repro_torch.kernels import build
from repro_torch.kernels.abfp_qdq import format_args, qdq_groups


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


_SMEM_MAX = 232448  # dynamic shared memory a block may use on sm_90
SMS = 132  # streaming multiprocessors of an H100 SXM
CONTRACT_MAX_M = 16  # rows up to which quant_matmul takes contract_kernel
MMA_BM = 64  # output rows of an int8_mma_kernel block (kMmaBM)
MMA_BN = 128  # output columns of an int8_mma_kernel block (kMmaBN)
MMA_STAGES = 4  # its shared-memory ring depth (kMmaStages)
MMA_CHUNK_MAX = 128  # codes of a group one ring stage holds, at most


def mma_row_bytes(b: int) -> int:
    """Bytes of a shared-memory row holding ``b`` bytes of codes: an odd
    number of 16-byte units, so 8 consecutive rows hit 8 bank groups."""
    return b if (b // 16) % 2 else b + 16


def mma_chunk(n: int, packed: bool) -> int:
    """Codes of a group one ring stage of ``int8_mma_kernel`` holds: the
    whole group up to 128 codes, else the largest multiple of 16 (packed:
    32) <= 128 that divides n."""
    if n <= MMA_CHUNK_MAX:
        return n
    step = 32 if packed else 16
    return next((c for c in range(MMA_CHUNK_MAX, step, -step) if n % c == 0),
                step)


class Int8ContractPlan(NamedTuple):
    """How ``int8_mma_kernel`` launches for one shape
    (``plan_int8_contract``)."""
    block_rows: int  # rows of x a block (MMA_BM)
    chunk: int       # codes of a group a ring stage holds
    splits: int      # K splits of whole groups
    grid: tuple      # (column tiles, row tiles, splits)
    smem_bytes: int  # dynamic shared memory of one block

    @property
    def tiles(self) -> int:
        """Output tiles (one ticket each when K is split)."""
        return self.grid[0] * self.grid[1]


def plan_int8_contract(M: int, N: int, K: int, n: int,
                       packed: bool = False) -> Int8ContractPlan:
    """The grid of ``int8_mma_kernel`` at x codes (M, K) against weight
    codes (N, K), groups of n along K (``packed``: the weight as nibble
    pairs).  A block owns ``MMA_BM`` x ``MMA_BN`` outputs; where those
    tiles alone give fewer blocks than the ``SMS`` SMs, K is split into
    whole groups until they do (at most one split per group).  Its ring
    holds ``MMA_STAGES`` stages of (BM, chunk) x codes, (128, chunk)
    weight codes or (128, chunk / 2) packed bytes, rows padded by
    ``mma_row_bytes``, and the BM + 128 scales of the chunk's group.
    Raises where the kernel cannot take the group length or the shape
    overflows its 32-bit offsets."""
    step = 32 if packed else 16
    if n <= 0 or n % step:
        raise ValueError(
            f"the int8 tensor-core contraction needs a group length that is "
            f"a multiple of {step} (packed={packed}); got n={n}")
    if max(M, N) * K >= 2 ** 31:
        raise ValueError(f"int8 tensor-core contraction: M={M} or N={N} "
                         f"times K={K} codes exceeds 2^31 (32-bit offsets)")
    cols = -(-N // MMA_BN)
    bm = MMA_BM
    rows = -(-M // bm)
    splits = max(1, min(K // n, -(-SMS // max(cols * rows, 1))))
    chunk = mma_chunk(n, packed)
    stage = (bm * mma_row_bytes(chunk)
             + MMA_BN * mma_row_bytes(chunk // 2 if packed else chunk)
             + 4 * (bm + MMA_BN))
    smem = MMA_STAGES * stage
    if smem > _SMEM_MAX:
        raise ValueError(f"int8 tensor-core contraction: n={n} needs "
                         f"{smem} bytes of shared memory, more than a block "
                         "has")
    return Int8ContractPlan(bm, chunk, splits, (cols, rows, splits), smem)


def quant_matmul_plan(M: int, N: int, K: int, n: int, packed: bool
                      ) -> Int8ContractPlan | None:
    """The contraction ``quant_matmul`` launches: None for
    ``contract_kernel`` (M <= 16 and a group length it is built for: 16,
    packed 32, codes a lane times a power of two <= 32), else the plan of
    ``int8_mma_kernel``."""
    cpl = 32 if packed else 16  # codes a lane of contract_kernel takes
    lpg = n // cpl
    if (M <= CONTRACT_MAX_M and n > 0 and n % cpl == 0
            and lpg & (lpg - 1) == 0 and lpg <= 32):
        return None
    return plan_int8_contract(M, N, K, n, packed)


def _bind(lib: ctypes.CDLL):
    fn = lib.repro_quant_matmul
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 8 + [i] * 7 + [f, f, p]
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
    plan = quant_matmul_plan(M, N, K, n, packed)  # raises on other n
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
    _check_aligned("quant_matmul", w_codes=w_codes, x_codes=xc)
    fn = _bind(build.load("quant_matmul"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        partial = None if plan is None else split_partials(plan, M, N,
                                                           x.device, stream)
        tickets = (None if partial is None
                   else _tickets(x.device, stream, plan.tiles))
        err = fn(x.data_ptr(), w_codes.data_ptr(), w_scales.data_ptr(),
                 xc.data_ptr(), sx.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 None if tickets is None else tickets.data_ptr(),
                 y.data_ptr(), M, N, K, n, int(packed),
                 0 if plan is None else plan.block_rows,
                 1 if plan is None else plan.splits,
                 float(fmt_x.qmax_pos), float(fmt_x.qmin), stream)
    quant_matmul.launches += 1
    if err != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{err}")
    return y


quant_matmul.launches = 0  # kernel launches made through this wrapper


def _check_aligned(name: str, **tensors) -> None:
    """The contractions copy codes in 16-byte pieces: their base addresses
    must be 16-byte aligned."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte "
                             f"boundary, got address {t.data_ptr():#x}")


# ---------------------------------------------------------------------------
# Dense weights: both operands QDQ'd per call
# ---------------------------------------------------------------------------
# ``abfp_matmul`` replaces ``repro/kernels/quant_matmul.py::abfp_matmul``
# (body ``_fp_kernel``): ``DQ(Q(x)) @ DQ(Q(w))`` with x ``(M, K)`` and w
# ``(K, N)`` f32 QDQ'd per group of n along K (any int or minifloat format,
# bf16 group scales) and an f32 contraction.  ``abfp_matmul_int8`` replaces
# ``::abfp_matmul_int8`` (body ``_int8_kernel``): integer codes of both
# operands, exact integer group sums, each rescaled as ``(P * sx) * sw`` in
# f32 and summed over groups.  The kernels (in ``csrc/quant_matmul.cu``)
# quantize the weight at every call, as the TPU kernels do.
#
# Both have two regimes on an H100, chosen by ``plan_abfp_matmul``.  Decode
# (M <= 16, n = 32 or 64) is bound by reading the f32 weight once (4 K N
# bytes); the on-chip quantization and the M products per weight element
# fit under that time if they overlap the loads.  Its kernels split K into
# whole groups across blocks so that every shape puts about eight waves of
# blocks on the 132 SMs (k,v at N = 512 has only 8 column tiles), stream
# the weight through a 4-stage ring of asynchronous copies, and sum the
# split partials in a fixed order in the last block of each column tile.
# ``abfp_matmul``'s QDQs each column group within one half-warp (shuffles,
# no barrier).  ``abfp_matmul_int8``'s makes the weight's int codes in the
# same pass, four lanes a column, and contracts them with x's codes by
# ``__dp4a``: each row's group sum is a whole int32 after two shuffle
# rounds, then rescaled; groups are added in order within a split, splits
# in split order.  No (N, K) code scratch: a call is two launches (x codes,
# decode kernel).  Prefill (M > 16): ``abfp_matmul`` keeps the 64 x 64
# tiled f32 contraction, bound by its multiply-adds; ``abfp_matmul_int8``
# writes w's codes once, transposed and coalesced (whole 128-byte runs of
# a column), then contracts them on the int8 tensor cores with
# ``int8_mma_kernel``, as ``quant_matmul`` does above 16 rows (three
# launches); reading the f32 weight once then bounds it.


def _check_dense(x, w, n: int):
    if x.ndim != 2 or w.ndim != 2:
        raise ValueError(f"x must be (M, K) and w (K, N); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(
            f"contraction mismatch: x has K={K} but w has K={K2} "
            f"(x.shape={tuple(x.shape)}, w.shape={tuple(w.shape)})")
    if K % n:
        raise ValueError(abfp_group_message(K, n))
    return M, K, N


def abfp_matmul_plain(x: torch.Tensor, w: torch.Tensor, fmt_x: Format,
                      fmt_w: Format, n: int = 64) -> torch.Tensor:
    """Plain PyTorch version of ``abfp_matmul`` (same arguments)."""
    M, K, N = _check_dense(x, w, n)
    G = K // n
    xq = qdq_groups(x.to(torch.float32).reshape(M, G, n), fmt_x)
    wq = qdq_groups(w.to(torch.float32).t().reshape(N, G, n), fmt_w)
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
    return torch.matmul(xq.reshape(M, K), wq.reshape(N, K).t())


def abfp_matmul_int8_plain(x: torch.Tensor, w: torch.Tensor,
                           fmt_x: IntFormat, fmt_w: IntFormat,
                           n: int = 64) -> torch.Tensor:
    """Plain PyTorch version of ``abfp_matmul_int8`` (same arguments)."""
    _check_dense(x, w, n)
    xc, xs, _ = abfp_mod.abfp_quantize(x.to(torch.float32), fmt_x, axis=-1,
                                       n=n, dtype=torch.float32)
    wc, ws, _ = abfp_mod.abfp_quantize(w.to(torch.float32), fmt_w, axis=0,
                                       n=n, dtype=torch.float32)
    return group_contract(xc, xs, wc, ws,
                          max_abs_product=fmt_x.qmax_pos * fmt_w.qmax_pos)


def _check_cuda_operands(name: str, x, w):
    for arg, t in (("x", x), ("w", w)):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: {arg} must be float32, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _bind_fp(lib: ctypes.CDLL):
    fn = lib.repro_abfp_matmul
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fmt = [i, f, f, i, i, i]  # format_args
        fn.argtypes = [p] * 6 + [i] * 6 + fmt + fmt + [p]
        fn.restype = ctypes.c_int
    return fn


def _bind_int8(lib: ctypes.CDLL):
    fn = lib.repro_abfp_matmul_int8
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 9 + [i] * 7 + [f] * 4 + [p]
        fn.restype = ctypes.c_int
    return fn


DECODE_MAX_M = 16  # rows up to which abfp_matmul takes the decode kernel
_DEC_BN = 64  # columns per decode block (kDecBN)
_DEC_STAGES = 4  # shared-memory ring depth (kStages)
DECODE_GROUPS = (32, 64)  # group lengths the decode kernel is built for
# Decode blocks aimed for, in waves of one block per SM: a few dozen
# groups' work a block or less, so that blocks that start late or run
# slow leave a short tail (8 beat 2 and 4 and matched 16 on an H100).
DECODE_WAVES = 8


class AbfpPlan(NamedTuple):
    """How ``abfp_matmul`` or ``abfp_matmul_int8`` launches for one shape
    (``plan_abfp_matmul``)."""
    regime: str      # "decode" (fp_ / int8_decode_kernel) or "prefill"
    block_rows: int  # rows of x a block holds (the kernel's BM)
    tiles: int       # blocks along the output (column tiles x row blocks)
    splits: int      # K splits of whole groups (decode; 1 for prefill)
    smem_bytes: int  # dynamic shared memory of one contraction block


def plan_abfp_matmul(M: int, N: int, K: int, n: int,
                     int8: bool = False) -> AbfpPlan:
    """The regime and grid of ``abfp_matmul`` (``int8``: of
    ``abfp_matmul_int8``) at (M, K) x (K, N), groups of n along K.  Decode
    (M <= 16, n = 32 or 64), the same grid for both: 64-column tiles times
    K splits of whole groups, at most one split per group: enough splits
    for two waves of blocks on the ``SMS`` SMs, and beyond that up to
    ``DECODE_WAVES`` waves as long as a split keeps two groups or more (a
    block of one group has no next group to load while it computes).  Its
    ring stage holds an (n, 64 + 4) f32 w tile and the x tile: (BM, n) f32
    values, or for int8 (BM, n) codes and BM scales.  Otherwise the
    prefill kernels: ``abfp_matmul``'s, one block per 64 x 64 output tile
    (it raises if its tiles do not fit in a block's shared memory);
    ``abfp_matmul_int8``'s int8_mma_kernel on the grid of
    ``plan_int8_contract`` (int8 weight codes)."""
    G = K // n
    bm = 4 if M <= 4 else 8 if M <= 8 else 16
    if M <= DECODE_MAX_M and n in DECODE_GROUPS:
        x_tile = bm * n + 4 * bm if int8 else 4 * bm * n
        smem = _DEC_STAGES * (4 * n * (_DEC_BN + 4) + x_tile)
        tiles = -(-N // _DEC_BN)
        two = -(-2 * SMS // max(tiles, 1))
        aim = -(-DECODE_WAVES * SMS // max(tiles, 1))
        splits = max(1, min(G, max(two, min(aim, G // 2))))
        return AbfpPlan("decode", bm, tiles, splits, smem)
    if int8:
        mma = plan_int8_contract(M, N, K, n)
        return AbfpPlan("prefill", mma.block_rows, mma.tiles, mma.splits,
                        mma.smem_bytes)
    smem = 4 * (64 * n + 64 * n + 256)
    if smem > _SMEM_MAX:
        raise ValueError(f"abfp_matmul kernel: group length n={n} needs "
                         "more shared memory than a block has")
    return AbfpPlan("prefill", 64, -(-N // 64) * -(-M // 64), 1, smem)


def split_bounds(G: int, splits: int) -> list[tuple[int, int]]:
    """Groups ``[lo, hi)`` of each K split, as the decode kernel cuts them
    (``split * G / S``)."""
    return [(s * G // splits, (s + 1) * G // splits) for s in range(splits)]


# Zeroed int32 tickets, one per column tile, and the split partials' f32
# scratch, each cached per (device, stream): calls on one stream run in
# order, so one buffer serves them all.  The last block of a tile to
# finish resets its ticket, so the tickets are zero again at the end of
# every launch.  A plan splits K only when it has fewer than
# ``DECODE_WAVES * SMS`` tiles (int8_mma_kernel: fewer than ``SMS``).
_TICKETS: dict[tuple[int | None, int], torch.Tensor] = {}
_PARTIALS: dict[tuple[int | None, int], torch.Tensor] = {}


def split_partials(plan, M: int, N: int, device, stream: int = 0
                   ) -> torch.Tensor | None:
    """The flat f32 scratch, of at least S M N floats, in which a split-K
    kernel (a decode kernel, or int8_mma_kernel; ``plan`` an ``AbfpPlan``
    or ``Int8ContractPlan``) writes its (S, M, N) split partials; None where
    it writes y directly (one split).  Cached per (device, stream) and
    grown as needed."""
    if plan.splits == 1:
        return None
    device = torch.device(device)
    key = (device.index, stream)
    size = plan.splits * M * N
    buf = _PARTIALS.get(key)
    if buf is None or buf.numel() < size:
        buf = _PARTIALS[key] = torch.empty(size, dtype=torch.float32,
                                           device=device)
    return buf


def _tickets(device: torch.device, stream: int, tiles: int) -> torch.Tensor:
    key = (device.index, stream)
    t = _TICKETS.get(key)
    if t is None or t.numel() < tiles:
        t = _TICKETS[key] = torch.zeros(max(tiles, DECODE_WAVES * SMS),
                                        dtype=torch.int32, device=device)
    return t


def abfp_matmul(x: torch.Tensor, w: torch.Tensor, fmt_x: Format,
                fmt_w: Format, n: int = 64) -> torch.Tensor:
    """Fused fp-path ABFP matmul: ``x (M, K)`` f32 @ ``w (K, N)`` f32, both
    QDQ'd per group of n along K; returns (M, N) f32.  Any M and N; K must
    be a multiple of n."""
    if x.device.type == "cpu":
        return abfp_matmul_plain(x, w, fmt_x, fmt_w, n)
    if x.device.type != "cuda":
        raise ValueError(f"abfp_matmul: unsupported device {x.device}")
    M, K, N = _check_dense(x, w, n)
    _check_cuda_operands("abfp_matmul", x, w)
    plan = plan_abfp_matmul(M, N, K, n)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    xq = torch.empty_like(x)
    decode = plan.regime == "decode"
    vec = N % 4 == 0 and w.data_ptr() % 16 == 0  # 16-byte weight copies
    fn = _bind_fp(build.load("quant_matmul"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        partial = split_partials(plan, M, N, x.device, stream)
        tickets = (None if partial is None
                   else _tickets(x.device, stream, plan.tiles))
        err = fn(x.data_ptr(), w.data_ptr(), xq.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 None if tickets is None else tickets.data_ptr(),
                 y.data_ptr(), M, N, K, n, plan.splits if decode else 0,
                 int(vec), *format_args(fmt_x), *format_args(fmt_w), stream)
    abfp_matmul.launches += 1
    if err != 0:
        raise RuntimeError(f"abfp_matmul kernel launch failed: CUDA error "
                           f"{err}")
    return y


abfp_matmul.launches = 0  # kernel launches made through this wrapper


def abfp_matmul_int8(x: torch.Tensor, w: torch.Tensor, fmt_x: IntFormat,
                     fmt_w: IntFormat, n: int = 64) -> torch.Tensor:
    """Native-int ABFP matmul: int codes of x per (row, group) and of w per
    (group, column), exact integer group sums, f32 rescale and sum over
    groups; returns (M, N) f32.  Any M and N; K must be a multiple of n."""
    if x.device.type == "cpu":
        return abfp_matmul_int8_plain(x, w, fmt_x, fmt_w, n)
    if x.device.type != "cuda":
        raise ValueError(f"abfp_matmul_int8: unsupported device {x.device}")
    M, K, N = _check_dense(x, w, n)
    _check_cuda_operands("abfp_matmul_int8", x, w)
    for fmt in (fmt_x, fmt_w):
        if not isinstance(fmt, IntFormat) or fmt.bits > 8:
            raise ValueError(f"abfp_matmul_int8 takes int formats of at most "
                             f"8 bits; got {fmt}")
    plan = plan_abfp_matmul(M, N, K, n, int8=True)  # raises on other n
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    G = K // n
    dev = x.device
    decode = plan.regime == "decode"
    xc = torch.empty((M, K), dtype=torch.int8, device=dev)
    sx = torch.empty((M, G), dtype=torch.float32, device=dev)
    # the prefill kernels' (N, K) codes and (N, G) scales of w
    wc = None if decode else torch.empty((N, K), dtype=torch.int8, device=dev)
    sw = None if decode else torch.empty((N, G), dtype=torch.float32,
                                         device=dev)
    vec = N % 4 == 0 and w.data_ptr() % 16 == 0  # 16-byte weight copies
    fn = _bind_int8(build.load("quant_matmul"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        partial = split_partials(plan, M, N, dev, stream)
        tickets = (None if partial is None
                   else _tickets(dev, stream, plan.tiles))
        err = fn(x.data_ptr(), w.data_ptr(), xc.data_ptr(), sx.data_ptr(),
                 None if wc is None else wc.data_ptr(),
                 None if sw is None else sw.data_ptr(),
                 None if partial is None else partial.data_ptr(),
                 None if tickets is None else tickets.data_ptr(),
                 y.data_ptr(), M, N, K, n, plan.splits,
                 0 if decode else plan.block_rows, int(vec),
                 float(fmt_x.qmax_pos), float(fmt_x.qmin),
                 float(fmt_w.qmax_pos), float(fmt_w.qmin), stream)
    abfp_matmul_int8.launches += 1
    if err != 0:
        raise RuntimeError(f"abfp_matmul_int8 kernel launch failed: CUDA "
                           f"error {err}")
    return y


abfp_matmul_int8.launches = 0  # kernel launches made through this wrapper
