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
chip.  Up to 16 rows one launch of ``quant_decode_kernel`` does the whole
call: K split into whole groups across blocks (``plan_quant_decode``), the
weight's codes streamed once through a ring of asynchronous copies, x's
codes made on chip once a block and a ``__dp4a`` contraction; up to 4 rows
of a layer wide enough to fill the card without a K split (wi,wg,
lm_head) x is quantized in a first launch and ``contract_kernel`` streams
each column's codes along K (``ContractPlan``), which measured faster
there.  Above 16 rows (and for group lengths the decode kernels are not
built for) x is quantized once in a first stage and
``mma_contract_kernel`` runs the contraction on the int8 tensor cores, on
the grid that ``plan_mma_contract`` chooses.  Any group length n that divides K: each
group's codes are zero-padded to ``pad_group(n)`` (a multiple of 16,
packed 32), which adds exactly 0 to its sum; stored codes off that grid
are copied into a padded buffer first.  See the source for the design.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
``quant_matmul_plain``, which the CPU tests hold against the reference
package and which a chip run holds the kernel against.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.analysis.messages import abfp_group_message, smem_message
from repro_torch.core import abfp as abfp_mod
from repro_torch.core.formats import Format, IntFormat
from repro_torch.core.quantize import unpack_int4_codes
from repro_torch.kernels import build, refuse_inputs
from repro_torch.kernels.abfp_qdq import (SMS, format_args, plan_qdq,
                                         plan_struct, qdq_groups)
from repro_torch.kernels.ops import SMEM_MAX


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


MMA_BM = 64  # output rows of an mma_contract_kernel block (kMmaBM)
MMA_BN = 128  # output columns of an mma_contract_kernel block (kMmaBN)
MMA_STAGES = 4  # its shared-memory ring depth (kMmaStages)
MMA_CHUNK_MAX = 128  # bytes of a row's x codes one ring stage holds, at most
# bytes of an x code of each code type of mma_contract_kernel (``codes``):
# int8 x and weight codes, int8 x against packed 4-bit weight codes, bf16
# unit codes of both
CODE_BYTES = {"int8": 1, "packed": 1, "bf16": 2}


def pad_group(n: int, packed: bool = False) -> int:
    """The group length of the code layouts the contractions read: ``n``
    rounded up to a multiple of 16 (``packed``: 32); the codes past n are
    zeros, which add exactly 0 to a group sum."""
    step = 32 if packed else 16
    return -(-n // step) * step


def pad_group_codes(w_codes: torch.Tensor, n: int, packed: bool = False
                    ) -> torch.Tensor:
    """Stored weight codes (N, G, n) — packed: (N, G, n / 2) bytes — as the
    contractions read them: each group zero-padded to ``pad_group(n)``
    codes (the tensor itself where n is on that grid)."""
    n_pad = pad_group(n, packed)
    if n_pad == n:
        return w_codes
    N, G, width = w_codes.shape
    out = w_codes.new_zeros((N, G, n_pad // 2 if packed else n_pad))
    out[:, :, :width] = w_codes
    return out


def mma_row_bytes(b: int) -> int:
    """Bytes of a shared-memory row holding ``b`` bytes of codes: an odd
    number of 16-byte units, so 8 consecutive rows hit 8 bank groups."""
    return b if (b // 16) % 2 else b + 16


def mma_chunk(n: int, packed: bool = False, code_bytes: int = 1) -> int:
    """Codes of a group one ring stage of ``mma_contract_kernel`` holds:
    the whole group up to 128 bytes of x codes a row (``code_bytes`` each),
    else the largest multiple of 16 (packed: 32) codes within that which
    divides n."""
    most = MMA_CHUNK_MAX // code_bytes
    if n <= most:
        return n
    step = 32 if packed else 16
    return next((c for c in range(most, step, -step) if n % c == 0), step)


class MmaPlan(NamedTuple):
    """How ``mma_contract_kernel`` launches for one shape
    (``plan_mma_contract``)."""
    block_rows: int  # rows of x a block (MMA_BM)
    chunk: int       # codes of a group a ring stage holds
    splits: int      # K splits of whole groups
    grid: tuple      # (column tiles, row tiles, splits)
    smem_bytes: int  # dynamic shared memory of one block

    @property
    def tiles(self) -> int:
        """Output tiles (one ticket each when K is split)."""
        return self.grid[0] * self.grid[1]


def plan_mma_contract(M: int, N: int, K: int, n: int,
                      codes: str = "int8") -> MmaPlan:
    """The grid of ``mma_contract_kernel`` at x codes (M, K) against weight
    codes (N, K), groups of n along K; ``codes`` is "int8", "packed"
    (int8 x codes, the weight as nibble pairs) or "bf16" (unit codes of
    both).  A block owns ``MMA_BM`` x ``MMA_BN`` outputs; where those
    tiles alone give fewer blocks than the ``SMS`` SMs, K is split into
    whole groups until they do (at most one split per group).  Its ring
    holds ``MMA_STAGES`` stages of (BM, chunk) x codes, (128, chunk)
    weight codes or (128, chunk / 2) packed bytes, rows padded by
    ``mma_row_bytes``, and the BM + 128 scales of the chunk's group.
    Raises where the kernel cannot take the group length (n a multiple of
    16, packed 32: ``pad_group`` makes one) or the shape overflows its
    32-bit offsets."""
    packed = codes == "packed"
    xb = CODE_BYTES[codes]
    step = 32 if packed else 16
    if n <= 0 or n % step:
        raise ValueError(
            f"the tensor-core contraction needs a group length that is "
            f"a multiple of {step} ({codes} codes); got n={n}")
    if max(M, N) * K * xb >= 2 ** 31:
        raise ValueError(f"tensor-core contraction: M={M} or N={N} times "
                         f"K={K} codes of {xb} bytes exceeds 2^31 bytes "
                         "(32-bit offsets)")
    cols = -(-N // MMA_BN)
    bm = MMA_BM
    rows = -(-M // bm)
    splits = max(1, min(K // n, -(-SMS // max(cols * rows, 1))))
    chunk = mma_chunk(n, packed, xb)
    stage = (bm * mma_row_bytes(chunk * xb)
             + MMA_BN * mma_row_bytes(chunk // 2 if packed else chunk * xb)
             + 4 * (bm + MMA_BN))
    smem = MMA_STAGES * stage
    if smem > SMEM_MAX:
        raise ValueError(smem_message(
            "tensor-core contraction", f"group length n={n} ({codes} codes)",
            smem, SMEM_MAX))
    return MmaPlan(bm, chunk, splits, (cols, rows, splits), smem)


def plan_int8_contract(M: int, N: int, K: int, n: int,
                       packed: bool = False) -> MmaPlan:
    """``plan_mma_contract`` for int8 codes (``packed``: against nibble
    pairs)."""
    return plan_mma_contract(M, N, K, n, "packed" if packed else "int8")


# quant_decode_kernel's shape (``kQdBN``, ``kQdSlice``, ``kQdStages`` in
# the source) and its grid: 256 columns a block; each column's codes
# streamed in 128-byte slices through two ring stages; splits for about
# 6 x 132 blocks, but at most 8 (the last block of a tile adds them).  At
# the main-path layers 8 splits measured best, or within 7 % of the best
# (PERF.md, the splits sweep of chip_smoke.py).
QD_BN = 256
QD_SLICE = 128
QD_STAGES = 2
QD_BLOCKS = 6 * SMS
QD_SPLITS_MAX = 8


class QuantDecodePlan(NamedTuple):
    """How ``quant_decode_kernel`` launches for one shape
    (``plan_quant_decode``)."""
    block_rows: int  # rows of x a block holds (the kernel's BM)
    tiles: int       # 256-column tiles (one ticket each when K is split)
    splits: int      # K splits of whole groups
    t_max: int       # groups of the longest split (x's codes a block holds)
    smem_bytes: int  # dynamic shared memory of one block


def qd_stage_bytes(B: int) -> int:
    """Bytes of a ring stage of ``quant_decode_kernel`` at B bytes of a
    column's codes a group: 256 rows of a 128-byte slice, each 144 bytes
    (nine 16-byte units) apart, and the f32 scales of the groups a slice
    holds (128 / B, at least one)."""
    groups = QD_SLICE // B if B < QD_SLICE else 1
    return QD_BN * (QD_SLICE + 16 + 4 * groups)


def qd_smem_bytes(B: int, bm: int, n_pad: int, t_max: int) -> int:
    """Dynamic shared memory of a ``quant_decode_kernel`` block: the ring,
    then x's (t_max, bm, n_pad) codes and (t_max, bm) scales."""
    return QD_STAGES * qd_stage_bytes(B) + t_max * bm * (n_pad + 4)


def plan_quant_decode(M: int, N: int, K: int, n_pad: int,
                      packed: bool) -> QuantDecodePlan:
    """The grid of ``quant_decode_kernel`` at x (M, K) against weight codes
    (N, K) in groups of n_pad codes (``pad_group``'s; K = G n_pad here),
    M <= 16: 256-column tiles times K splits of whole groups, enough splits
    for about ``QD_BLOCKS`` blocks but at most ``QD_SPLITS_MAX`` (and one a
    group), and more where x's codes of the longest split would not fit in
    a block's shared memory beside the ring.  Rows a block holds: 4, 8 or
    16."""
    G = K // n_pad
    bm = 4 if M <= 4 else 8 if M <= 8 else 16
    tiles = -(-N // QD_BN)
    splits = max(1, min(G, QD_SPLITS_MAX, -(-QD_BLOCKS // tiles)))
    B = n_pad // 2 if packed else n_pad
    while True:
        t_max = max(1, -(-G // splits))
        smem = qd_smem_bytes(B, bm, n_pad, t_max)
        if smem <= SMEM_MAX:
            return QuantDecodePlan(bm, tiles, splits, t_max, smem)
        if t_max == 1:
            raise ValueError(smem_message(
                "quant_matmul decode kernel", f"a group of {n_pad} codes",
                smem, SMEM_MAX))
        splits += 1


CONTRACT_CN = 32  # output columns of a contract_kernel block
# columns from which up to 4 rows take contract_kernel: N / 32 blocks of
# eight warps, at least 4 a SM with no K split (wi,wg: 592; q,o: 112)
CONTRACT_MIN_N = 4 * SMS * CONTRACT_CN


class ContractPlan(NamedTuple):
    """``quantize_rows_kernel``, then ``contract_kernel`` (no K split): up
    to 4 rows of a layer at least ``CONTRACT_MIN_N`` columns wide."""
    block_rows: int  # rows of x a block holds (4)
    blocks: int      # 32-column blocks
    splits: int      # 1: the whole of K a warp


def quant_matmul_plan(M: int, N: int, K: int, n: int, packed: bool
                      ) -> QuantDecodePlan | ContractPlan | MmaPlan:
    """The kernels ``quant_matmul`` launches, planned on the padded group
    length n_pad = ``pad_group(n, packed)`` at K = G n_pad.  Up to 16 rows
    with a padded group the decode kernels are built for (16, packed 32,
    codes times a power of two <= 32): ``ContractPlan`` for up to 4 rows
    at N >= ``CONTRACT_MIN_N`` (the two-launch kernel measured faster
    there), else ``plan_quant_decode`` (one launch).  Otherwise the plan
    of ``mma_contract_kernel``."""
    n_pad = pad_group(n, packed)
    K_pad = K // n * n_pad if n > 0 else K
    lpg = n_pad // (32 if packed else 16)  # 16-byte pieces of a group
    if M <= DECODE_MAX_M and n > 0 and lpg & (lpg - 1) == 0 and lpg <= 32:
        if M <= 4 and N >= CONTRACT_MIN_N:
            return ContractPlan(4, -(-N // CONTRACT_CN), 1)
        return plan_quant_decode(M, N, K_pad, n_pad, packed)
    return plan_int8_contract(M, N, K_pad, n_pad, packed)


def _bind(lib: ctypes.CDLL):
    fn = lib.repro_quant_matmul
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 8 + [i] * 9 + [f, f, p]
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
    refuse_inputs("quant_matmul", x, w_codes, w_scales)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_codes, w_scales, fmt_x, n, packed)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    M, K, N, G = _check_shapes(x, w_codes, w_scales, n, packed)
    if not isinstance(fmt_x, IntFormat) or fmt_x.bits > 8:
        raise ValueError(
            f"quant_matmul quantizes x to int8 codes; got format {fmt_x}")
    return _quant_matmul(x, w_codes, w_scales, fmt_x, n, packed,
                         quant_matmul_plan(M, N, K, n, packed))


def _quant_matmul(x, w_codes, w_scales, fmt_x, n, packed, plan):
    """``quant_matmul`` on a CUDA tensor with the kernels of ``plan`` (one
    ``quant_matmul_plan`` returns, or another valid for the shape: what
    ``chip_smoke.py`` compares them with)."""
    M, K, N, G = _check_shapes(x, w_codes, w_scales, n, packed)
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
    if y.numel() == 0 or K == 0:
        return y.zero_()
    n_pad = pad_group(n, packed)
    codes = pad_group_codes(w_codes, n, packed)  # w_codes itself on the grid
    decode = isinstance(plan, QuantDecodePlan)
    kernel = 0 if decode else 1 if isinstance(plan, ContractPlan) else 2
    # x's codes and scales: written by a first stage, except that the
    # one-launch decode kernel makes them on chip
    xc = sx = None
    if not decode:
        xc = torch.empty((M, G * n_pad), dtype=torch.int8, device=x.device)
        sx = torch.empty((M, G), dtype=torch.float32, device=x.device)
    _check_aligned("quant_matmul", w_codes=codes)
    fn = _bind(build.load("quant_matmul"))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        partial = split_partials(plan, M, N, x.device, stream)
        tickets = (None if partial is None
                   else _tickets(x.device, stream, plan.tiles))
        err = fn(x.data_ptr(), codes.data_ptr(), w_scales.data_ptr(),
                 *(None if t is None else t.data_ptr()
                   for t in (xc, sx, partial, tickets)),
                 y.data_ptr(), M, N, K, n, n_pad, int(packed),
                 kernel, plan.splits,
                 plan.t_max if decode else 0,
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
# quantize the weight at every call, as the TPU kernels do.  Both take
# every n that divides K.
#
# ``plan_abfp_matmul`` chooses the regime.  Decode (M <= 16, n = 32 or 64)
# is bound by reading the f32 weight once (4 K N bytes); the on-chip
# quantization and the M products per weight element fit under that time
# if they overlap the loads.  Its kernels split K into whole groups across
# blocks so that every shape puts about eight waves of blocks on the 132
# SMs (k,v at N = 512 has only 8 column tiles), stream the weight through a
# 4-stage ring of asynchronous copies, and sum the split partials in a
# fixed order in the last block of each column tile.  ``abfp_matmul``'s
# QDQs each column group within one half-warp (shuffles, no barrier).
# ``abfp_matmul_int8``'s makes the weight's int codes in the same pass,
# four lanes a column, and contracts them with x's codes by ``__dp4a``:
# each row's group sum is a whole int32 after two shuffle rounds, then
# rescaled; groups are added in order within a split, splits in split
# order.  No (N, K) code scratch: a call is two launches (x codes, decode
# kernel).
#
# Every other (M, n) takes the prefill regime, three launches on the
# tensor cores: x's codes, w's codes written once, transposed and
# coalesced (whole 128-byte runs of a column), then ``mma_contract_kernel``
# (as ``quant_matmul`` above 16 rows); each group's codes are zero-padded
# to ``pad_group(n)``.  ``abfp_matmul_int8`` writes int8 codes.
# ``abfp_matmul`` writes x = u sx and w = v sw as bf16 unit codes u, v
# (exact for the formats ``bf16_holds_codes`` accepts) and f32 scales, and
# forms each group's P = u . v on the bf16 tensor cores with f32 sums:
# exact for int codes, so it is then bit for bit ``abfp_matmul_int8``.  A
# format whose unit codes bf16 cannot hold takes the "simt" regime: the x
# QDQ and a 64 x 64 (or 32 x 64) tiled f32 contraction on the CUDA cores.


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
        fn.argtypes = [p] * 9 + [i] * 9 + fmt + fmt + [p, p]
        fn.restype = ctypes.c_int
    return fn


def _bind_int8(lib: ctypes.CDLL):
    fn = lib.repro_abfp_matmul_int8
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 9 + [i] * 8 + [f] * 4 + [p]
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
    regime: str      # "decode", "prefill" (tensor cores) or "simt"
    block_rows: int  # rows of x a block holds (the kernel's BM)
    tiles: int       # blocks along the output (column tiles x row blocks)
    splits: int      # K splits of whole groups (1 for simt)
    smem_bytes: int  # dynamic shared memory of one contraction block
    n_pad: int       # group length of the code scratch (prefill), else n


_COL_TILE, _COL_ROWS = 32, 128  # quantize_cols_kernel (kColTile, kColRows)


def _col_stage_smem(n: int, n_pad: int, code_bytes: int) -> int:
    """Dynamic shared memory of a ``quantize_cols_kernel`` block
    (``col_tile_smem``): the (rows, 32) f32 tile, its scales, and the
    padded code tile."""
    rows = max(n, _COL_ROWS)
    words = rows // n * n_pad * code_bytes // 4 + 1
    return 4 * (rows * _COL_TILE + rows // n * _COL_TILE + _COL_TILE * words)


def bf16_holds_codes(fmt: Format) -> bool:
    """Whether bf16 holds every unit code of ``fmt`` (the values its
    ``qdq_unit`` returns) exactly: an int format whose codes have magnitude
    <= 256 (at most 9 bits), or a minifloat of at most 7 mantissa bits
    whose grid lies inside bf16's exponent range (smallest quantum >=
    2**-133, largest exponent <= 127) and whose top value bf16 holds.  The
    rule by which ``abfp_matmul`` contracts on the bf16 tensor cores."""
    if isinstance(fmt, IntFormat):
        return max(fmt.qmax_pos, -fmt.qmin) <= 256
    top = torch.tensor(fmt.qmax_pos, dtype=torch.float32)
    return (fmt.man_bits <= 7
            and fmt.min_normal_exp - fmt.man_bits >= -133
            and fmt.max_biased_exp - fmt._bias <= 127
            and bool(top.to(torch.bfloat16).to(torch.float32) == top))


def plan_abfp_matmul(M: int, N: int, K: int, n: int, int8: bool = False,
                     formats: tuple = ()) -> AbfpPlan:
    """The regime and grid of ``abfp_matmul`` (``int8``: of
    ``abfp_matmul_int8``) at (M, K) x (K, N), groups of n along K
    (``formats``: ``abfp_matmul``'s formats of x and w).

    Decode (M <= 16, n = 32 or 64), the same grid for both: 64-column
    tiles times K splits of whole groups, at most one split per group:
    enough splits for two waves of blocks on the ``SMS`` SMs, and beyond
    that up to ``DECODE_WAVES`` waves as long as a split keeps two groups
    or more (a block of one group has no next group to load while it
    computes).  Its ring stage holds an (n, 64 + 4) f32 w tile and the x
    tile: (BM, n) f32 values, or for int8 (BM, n) codes and BM scales.

    Otherwise "prefill": ``mma_contract_kernel`` on the grid of
    ``plan_mma_contract`` at the padded group length n_pad =
    ``pad_group(n)`` (int8 codes; bf16 unit codes for ``abfp_matmul``),
    after the two quantize stages (it raises if their tiles do not fit in
    a block's shared memory).  ``abfp_matmul`` with a format for which
    ``bf16_holds_codes`` fails takes "simt" instead: one block per 64 x 64
    output tile (32 x 64 where a long group would not fit; it raises if
    neither does)."""
    G = K // n
    bm = 4 if M <= 4 else 8 if M <= 8 else 16
    if M <= DECODE_MAX_M and n in DECODE_GROUPS:
        x_tile = bm * n + 4 * bm if int8 else 4 * bm * n
        smem = _DEC_STAGES * (4 * n * (_DEC_BN + 4) + x_tile)
        tiles = -(-N // _DEC_BN)
        two = -(-2 * SMS // max(tiles, 1))
        aim = -(-DECODE_WAVES * SMS // max(tiles, 1))
        splits = max(1, min(G, max(two, min(aim, G // 2))))
        return AbfpPlan("decode", bm, tiles, splits, smem, n)
    if int8 or all(bf16_holds_codes(f) for f in formats):
        codes = "int8" if int8 else "bf16"
        n_pad = pad_group(n)
        col = _col_stage_smem(n, n_pad, CODE_BYTES[codes])
        if col > SMEM_MAX:
            raise ValueError(smem_message(
                "abfp_matmul_int8" if int8 else "abfp_matmul",
                f"quantizing w in groups of n={n}", col, SMEM_MAX))
        mma = plan_mma_contract(M, N, G * n_pad, n_pad, codes)
        return AbfpPlan("prefill", mma.block_rows, mma.tiles, mma.splits,
                        mma.smem_bytes, n_pad)
    for rows in (64, 32):
        smem = 4 * (rows * n + 64 * n + 256)
        if smem <= SMEM_MAX:
            return AbfpPlan("simt", rows, -(-N // 64) * -(-M // rows), 1,
                            smem, n)
    raise ValueError(smem_message(
        "abfp_matmul", f"the f32 contraction in groups of n={n}", smem,
        SMEM_MAX))


def split_bounds(G: int, splits: int) -> list[tuple[int, int]]:
    """Groups ``[lo, hi)`` of each K split, as the decode kernel cuts them
    (``split * G / S``)."""
    return [(s * G // splits, (s + 1) * G // splits) for s in range(splits)]


# Zeroed int32 tickets, one per column tile, and the split partials' f32
# scratch, each cached per (device, stream): calls on one stream run in
# order, so one buffer serves them all.  The last block of a tile to
# finish resets its ticket, so the tickets are zero again at the end of
# every launch.  A plan splits K only when it has fewer than
# ``DECODE_WAVES * SMS`` tiles (mma_contract_kernel: fewer than ``SMS``).
_TICKETS: dict[tuple[int | None, int], torch.Tensor] = {}
_PARTIALS: dict[tuple[int | None, int], torch.Tensor] = {}


def split_partials(plan, M: int, N: int, device, stream: int = 0
                   ) -> torch.Tensor | None:
    """The flat f32 scratch, of at least S M N floats, in which a split-K
    kernel (a decode kernel, or mma_contract_kernel; ``plan`` an
    ``AbfpPlan``, ``QuantDecodePlan`` or ``MmaPlan``) writes its (S, M, N)
    split partials; None where it writes y directly (one split).  Cached
    per (device, stream) and grown as needed."""
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


_FP_REGIMES = ("decode", "prefill", "simt")  # repro_abfp_matmul's codes


def abfp_matmul(x: torch.Tensor, w: torch.Tensor, fmt_x: Format,
                fmt_w: Format, n: int = 64) -> torch.Tensor:
    """Fused fp-path ABFP matmul: ``x (M, K)`` f32 @ ``w (K, N)`` f32, both
    QDQ'd per group of n along K; returns (M, N) f32.  Any M and N; K must
    be a multiple of n."""
    refuse_inputs("abfp_matmul", x, w)
    if x.device.type == "cpu":
        return abfp_matmul_plain(x, w, fmt_x, fmt_w, n)
    if x.device.type != "cuda":
        raise ValueError(f"abfp_matmul: unsupported device {x.device}")
    M, K, N = _check_dense(x, w, n)
    _check_cuda_operands("abfp_matmul", x, w)
    plan = plan_abfp_matmul(M, N, K, n, formats=(fmt_x, fmt_w))
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    G, dev = K // n, x.device
    sx = wc = sw = None
    if plan.regime == "prefill":  # bf16 unit codes and f32 scales
        xs = torch.empty((M, G * plan.n_pad), dtype=torch.bfloat16,
                         device=dev)
        sx = torch.empty((M, G), dtype=torch.float32, device=dev)
        wc = torch.empty((N, G * plan.n_pad), dtype=torch.bfloat16,
                         device=dev)
        sw = torch.empty((N, G), dtype=torch.float32, device=dev)
        x_qdq = None
    else:  # QDQ'd f32 x, by abfp_qdq's kernel
        xs = torch.empty_like(x)
        x_qdq = plan_qdq(M * G, n, 4, x.data_ptr() % 16 == 0
                         and xs.data_ptr() % 16 == 0, fmt_x)
    vec = N % 4 == 0 and w.data_ptr() % 16 == 0  # 16-byte weight copies
    fn = _bind_fp(build.load("quant_matmul"))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        partial = split_partials(plan, M, N, dev, stream)
        tickets = (None if partial is None
                   else _tickets(dev, stream, plan.tiles))
        err = fn(x.data_ptr(), w.data_ptr(), xs.data_ptr(),
                 *(None if t is None else t.data_ptr()
                   for t in (sx, wc, sw, partial, tickets)),
                 y.data_ptr(), M, N, K, n, plan.n_pad,
                 _FP_REGIMES.index(plan.regime), plan.splits,
                 plan.block_rows, int(vec), *format_args(fmt_x),
                 *format_args(fmt_w),
                 None if x_qdq is None else ctypes.byref(plan_struct(x_qdq)),
                 stream)
    abfp_matmul.launches += 1
    if x_qdq is not None:
        abfp_matmul.launches_by_kernel[x_qdq.kernel] += 1
    if err != 0:
        raise RuntimeError(f"abfp_matmul kernel launch failed: CUDA error "
                           f"{err}")
    return y


abfp_matmul.launches = 0  # kernel launches made through this wrapper
# launches of its x pre-pass (the decode and simt regimes), by kernel
abfp_matmul.launches_by_kernel = {"qdq_stream_kernel": 0,
                                  "qdq_rows_kernel": 0}


def abfp_matmul_int8(x: torch.Tensor, w: torch.Tensor, fmt_x: IntFormat,
                     fmt_w: IntFormat, n: int = 64) -> torch.Tensor:
    """Native-int ABFP matmul: int codes of x per (row, group) and of w per
    (group, column), exact integer group sums, f32 rescale and sum over
    groups; returns (M, N) f32.  Any M and N; K must be a multiple of n."""
    refuse_inputs("abfp_matmul_int8", x, w)
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
    plan = plan_abfp_matmul(M, N, K, n, int8=True)
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    G = K // n
    dev = x.device
    decode = plan.regime == "decode"
    xc = torch.empty((M, G * plan.n_pad), dtype=torch.int8, device=dev)
    sx = torch.empty((M, G), dtype=torch.float32, device=dev)
    # the prefill kernels' (N, G n_pad) codes and (N, G) scales of w
    wc = None if decode else torch.empty((N, G * plan.n_pad),
                                         dtype=torch.int8, device=dev)
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
                 y.data_ptr(), M, N, K, n, plan.n_pad, plan.splits,
                 0 if decode else plan.block_rows, int(vec),
                 float(fmt_x.qmax_pos), float(fmt_x.qmin),
                 float(fmt_w.qmax_pos), float(fmt_w.qmin), stream)
    abfp_matmul_int8.launches += 1
    if err != 0:
        raise RuntimeError(f"abfp_matmul_int8 kernel launch failed: CUDA "
                           f"error {err}")
    return y


abfp_matmul_int8.launches = 0  # kernel launches made through this wrapper
