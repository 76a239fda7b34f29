"""Attention over quantized KV codes: CUDA kernel wrapper + plain version.

``flash_attention_quant`` replaces the TPU kernel
``repro/kernels/flash_attention_quant.py::flash_attention_quant`` (bodies
``_kernel_exact``, ``_kernel_online``, ``_kernel_phased``).  The serving
engines store KV as int8 / fp8-e4m3 codes with f32 unit scales; this
function consumes the codes directly — dequantized on chip, never as a
dense fp copy in device memory.

Parity contract (inherited from the reference): masking uses the finite
``NEG_INF`` (-1e9) and probabilities are ``exp(s - max) / sum``, so masked
positions carry exact zeros; ``kv_pos < 0`` marks padded / unwritten /
trash entries.  A row with no valid key degenerates to the uniform mean
(the dequantize-then-reference path yields 0 there; engines ignore dead
rows).  Three bodies, chosen by ``block_k`` and ``probs_n``:

  exact   single KV tile: full-row softmax + optional ABFP probs QDQ
  online  several tiles, no probs QDQ: running max / denominator
  phased  several tiles + probs QDQ: statistics pass, then QDQ'd P.V

Layouts are the front-end's own — ``q (B, S, H, D)``, codes
``(B, T, KV, D)``, scales ``(B, T, KV)`` — so a gathered page list goes in
without a transposed copy; query head ``h`` reads KV head ``h // (H // KV)``.

On the card ``plan_attention`` picks one of five kernels a call
(``csrc/flash_attention_quant.cu``; see the source for their designs):

  attention_decode_kernel   the exact body at S = 1 (every paged decode
      step): a cluster of up to 8 blocks a (batch, KV head), each owning a
      range of whole 64-key tiles and probs groups, softmax statistics and
      P.V partials exchanged through distributed shared memory and added
      in block order, ranges no row can see neither loaded nor multiplied.
      At B = 4, T = 512: 16 clusters x 8 blocks, one wave.
  attention_decode_long_kernel  every other call at S = 1 (the decode step
      of a long context: the exact body past the decode kernel's shared
      memory, the online and phased bodies): the same clusters, the seen
      units (64 keys, or lcm(64, n)) dealt out as contiguous ranges, K
      then V streamed through a ring of 64-key stages, the range's scores
      kept in shared memory between the two passes, each bk tile's
      maximum and f64 sum exchanged through distributed shared memory and
      m, l formed by the reference's recurrence over the tiles, P.V on
      the bf16 tensor cores at f32 accuracy; a dead row loads V alone and
      sums its columns once.
  attention_prefill_kernel  the exact body at S >= ``PREFILL_MIN_S``
      positions (the paged prefill chunk): 64 rows a block, P.V on the
      bf16 tensor cores at f32 accuracy (the probabilities split into
      three bf16 terms, codes exact in bf16), key tiles no row can see
      skipped; bound by its operations at B = 4, S = 64, T = 512.
  attention_long_kernel     every other call at S >= ``PREFILL_MIN_S``
      (the paged prefill chunk of a context past about 520 keys: exact,
      online and phased bodies): 64 rows a tile, the tile's seen 64-key
      units dealt out over a cluster of ``long_cluster(T)`` blocks, two
      passes streaming K / V through shared memory (the scores and their
      statistics, the scores kept in a scratch the wrapper allocates;
      then the probabilities and P.V), statistics and P.V partials
      exchanged through distributed shared memory; a tile where no
      position sees a key sums V's columns once.
  attention_kernel          S >= 2 with probs groups neither 64-row
      kernel takes, and S = 1 past both decode kernels' shared memory (f32
      on the CUDA cores, one block a (batch, KV head, position tile), its
      key tiles in order).

All but the last form each score as the plain version's own f32
multiply-add chain (bit for bit, so no probs-QDQ code flips against it);
every kernel serves all query heads of a KV head in one block, so codes
are read once.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
``flash_attention_quant_plain``.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.analysis.messages import (abfp_group_message,
                                           attention_block_message,
                                           smem_message)
from repro_torch.core.quantize import div_by_constant
from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.ops import SMEM_MAX

NEG_INF = -1e9  # mask value — matches nn.attention.NEG_INF
M_INIT = -1e30  # running-max init; exp(M_INIT - m_new) underflows to 0

_ROWS_MAX = 16          # query rows (positions x grouped heads) per block

# attention_prefill_kernel: rows a block serves (4 m16 tiles), keys a K / V
# tile holds, and the fewest query positions a call must have to take it.
# At T = 512 (chip_smoke.py's route sweep, PERF.md) attention_kernel takes
# 0.080-0.082 ms at S = 1 and 0.107-0.113 from S = 2; the prefill kernel
# 0.087-0.089 at every S: decode keeps attention_kernel.
PREFILL_ROWS = 64
PREFILL_KEYS = 64
PREFILL_MIN_S = 2

# attention_decode_kernel: blocks a cluster may hold (the portable cluster
# size) and the tile its ranges are whole multiples of.
DECODE_CLUSTER = 8
DECODE_TILE = 64
# attention_decode_long_kernel: stages of its copy ring (the kernel's
# kDLStages: pass 1 holds two tiles while two more arrive).
DECODE_LONG_STAGES = 4

# attention_long_kernel: blocks a 64-row tile may be split over (the
# portable cluster size), and the fewest 64-key units each is dealt when
# every unit is seen.
LONG_CLUSTER = 8
LONG_UNITS = 8
# ... and the most device memory a call's stored scores may take: past it
# pass 2 forms the scores again.  On the H100 (chip_smoke.py) the store
# saves 19 % of the kernel at the paged chunk of max_len 8192 (1.165 against
# 1.444 ms), which needs exactly this (1,024 blocks x 16 tiles of 16 KB);
# the store grows with S x T, so longer contexts or more slots recompute.
LONG_SCRATCH_MAX = 256 << 20


def _probs_qdq(p: torch.Tensor, *, n: int, qmax: float, qmin: float):
    """ABFP QDQ of probabilities, groups of n along the last (kv) dim —
    the ops of ``core.abfp.abfp_qdq`` for an int format with bf16 scales."""
    pg = p.reshape(*p.shape[:-1], p.shape[-1] // n, n)
    alpha = pg.abs().amax(dim=-1, keepdim=True)
    alpha = torch.clamp_min(alpha.to(torch.bfloat16).to(torch.float32),
                            1e-12)
    scale = div_by_constant(alpha, qmax)
    q = torch.clamp(torch.round(pg / scale), qmin, qmax)
    return (q * scale).reshape(p.shape)


def _tiling(S: int, T: int, block_k: int, probs_n: int) -> int:
    bk = T if block_k in (0, T) else block_k
    if T % bk:
        raise ValueError(attention_block_message(S, T, S, bk))
    if probs_n and bk % probs_n:
        raise ValueError(abfp_group_message(bk, probs_n, where="attn probs"))
    return bk


class AttentionPlan(NamedTuple):
    """How ``flash_attention_quant`` launches on the card
    (``plan_attention``)."""
    kernel: str                 # attention_{decode,decode_long,prefill,
                                # long,}_kernel
    positions: int              # query positions a block serves (BQ)
    rows: int                   # rows of a block (prefill: padded to 64)
    grid: tuple[int, int, int]  # (position tiles | cluster, KV heads, batch)
    smem_bytes: int             # dynamic shared memory of one block
    keys: int                   # keys a block owns (decode: its range)
    cluster: int = 1            # long: blocks a 64-row tile is split over
                                # (decode_long: blocks a (batch, KV head))
    slots: int = 0              # long: score tiles a block stores (0: the
                                # scores are formed again in pass 2)


def prefill_smem_bytes(T: int, D: int) -> int:
    """Dynamic shared memory of an ``attention_prefill_kernel`` block, as
    the kernel lays it out: q's 64 rows and one K tile in f32 (rows D + 4
    apart), two stages of raw codes (rows D + 16 bytes apart), 64 score
    rows (a row holds whole tiles, plus 8), kv_pos and both scales of
    every key, then 16 bytes of counters, 64 q positions and two ints a
    tile."""
    tiles = -(-T // PREFILL_KEYS)
    return (2 * PREFILL_ROWS * (D + 4) * 4 + 2 * PREFILL_KEYS * (D + 16)
            + 4 * PREFILL_ROWS * (tiles * PREFILL_KEYS + 8)
            + 12 * tiles * PREFILL_KEYS + 16 + 4 * PREFILL_ROWS + 8 * tiles)


def _prefill_groups(probs_n: int) -> bool:
    """Probability groups the prefill kernel takes: none, or groups that
    tile its 64-key tiles (n divides 64) or are whole tiles (64 divides n)."""
    return (probs_n == 0 or PREFILL_KEYS % probs_n == 0
            or probs_n % PREFILL_KEYS == 0)


def plan_attention_prefill(B: int, S: int, T: int, H: int, KV: int,
                           D: int) -> AttentionPlan:
    """``attention_prefill_kernel``'s plan: 64 rows a block, 64 // G
    positions evened out over the chunk (S = 64, G = 7: 8 positions, 56
    rows, 8 x KV x B blocks)."""
    bq = min(S, PREFILL_ROWS // (H // KV))
    tiles = -(-S // bq)
    bq = -(-S // tiles)
    return AttentionPlan("attention_prefill_kernel", bq, PREFILL_ROWS,
                         (tiles, KV, B), prefill_smem_bytes(T, D), T)


def long_cluster(T: int) -> int:
    """Blocks of ``attention_long_kernel``'s cluster: doubled from 1 while
    every block would still get ``LONG_UNITS`` 64-key units of T (T = 1024:
    2, 2048: 4, from 4096: 8)."""
    units = -(-T // PREFILL_KEYS)
    c = 1
    while c < LONG_CLUSTER and units >= 2 * c * LONG_UNITS:
        c *= 2
    return c


def long_smem_bytes(T: int, D: int) -> int:
    """Dynamic shared memory of an ``attention_long_kernel`` block, as the
    kernel lays it out: q's 64 rows and one K tile in f32 (rows D + 4
    apart), a bf16 V tile (rows D + 8 apart), one unit's 64 score rows (72
    floats apart), two ring stages (16 KB for a unit's K codes, rows D + 16
    bytes apart, or its stored scores; its V codes; 64 k scales, v scales
    and kv_pos), the (m, l) of 64 rows from 8 blocks, l and q_pos a row, 16
    bytes of counters, then two ints a unit."""
    units = -(-T // PREFILL_KEYS)
    stage = (4 * PREFILL_ROWS * PREFILL_KEYS + PREFILL_KEYS * (D + 16)
             + 12 * PREFILL_KEYS)
    return (2 * PREFILL_ROWS * (D + 4) * 4 + PREFILL_KEYS * (D + 8) * 2
            + PREFILL_ROWS * (PREFILL_KEYS + 8) * 4 + 2 * stage
            + LONG_CLUSTER * PREFILL_ROWS * 8 + 8 * PREFILL_ROWS + 16
            + 8 * units)


def long_slots(T: int, probs_n: int, cluster: int) -> int:
    """Score tiles (64 rows x 64 keys, f32) an ``attention_long_kernel``
    block may store in pass 1: its share of T's units over ``cluster``
    blocks, whole groups of ``probs_n // 64`` units (T = 8192, n = 64, 8
    blocks: 16)."""
    span = probs_n // PREFILL_KEYS if probs_n > PREFILL_KEYS else 1
    groups = -(-(-(-T // PREFILL_KEYS)) // span)
    return -(-groups // cluster) * span


def plan_attention_long(B: int, S: int, T: int, H: int, KV: int, D: int,
                        probs_n: int, store: bool | None = None
                        ) -> AttentionPlan:
    """``attention_long_kernel``'s plan: the prefill kernel's 64-row tiles
    (S = 64, G = 7: 8 positions), each split over a cluster of
    ``long_cluster(T)`` blocks; grid (C x tiles, KV, B) (T = 8192: 64 x 4 x
    4).  ``store``: pass 1 stores each unit's scores for pass 2 (``slots``
    tiles a block), else pass 2 forms them again (the same bits); by
    default it stores where that takes at most ``LONG_SCRATCH_MAX`` bytes."""
    bq = min(S, PREFILL_ROWS // (H // KV))
    tiles = -(-S // bq)
    bq = -(-S // tiles)
    C = long_cluster(T)
    plan = AttentionPlan("attention_long_kernel", bq, PREFILL_ROWS,
                         (C * tiles, KV, B), long_smem_bytes(T, D), T, C,
                         long_slots(T, probs_n, C))
    if store is None:
        store = long_scratch_bytes(plan) <= LONG_SCRATCH_MAX
    return plan if store else plan._replace(slots=0)


def long_scratch_bytes(plan: AttentionPlan) -> int:
    """Device memory a call under ``plan`` allocates for pass 1's stored
    scores: ``slots`` tiles of 64 x 64 f32 a block (0 when pass 2 forms
    the scores again)."""
    return math.prod(plan.grid) * plan.slots * PREFILL_ROWS * PREFILL_KEYS * 4


def decode_unit(probs_n: int) -> int:
    """Keys of the units the decode kernels deal out: 64, or the least
    multiple of 64 and ``probs_n`` (whole probs groups)."""
    return math.lcm(DECODE_TILE, probs_n) if probs_n else DECODE_TILE


def decode_range(T: int, probs_n: int) -> tuple[int, int]:
    """(blocks of a cluster C, keys of a block's range L) of
    ``attention_decode_kernel``: L the fewest whole units
    (``decode_unit``) that cover T in at most ``DECODE_CLUSTER`` ranges,
    C = ceil(T / L); the last range may be short."""
    unit = decode_unit(probs_n)
    units = -(-T // unit)
    keys = unit * -(-units // DECODE_CLUSTER)
    return -(-T // keys), keys


def decode_smem_bytes(G: int, L: int, D: int) -> int:
    """Dynamic shared memory of an ``attention_decode_kernel`` block, as
    the kernel lays it out: q's G rows (f32), L rows of K codes (D + 16
    bytes apart) and of V codes (D), G x L f32 scores, the C blocks' P.V
    partials of its output columns (G x (D + 8) f32 at most), k scale, v
    scale and kv_pos of each key, 16 row maxima and 16 partial sums of
    each of 8 blocks, and the 8 warps' G x D f32 P.V partials."""
    return (4 * G * D + L * (D + 16) + L * D + 4 * G * L
            + 4 * G * (D + DECODE_CLUSTER) + 12 * L
            + 8 * DECODE_CLUSTER * _ROWS_MAX + 32 * G * D)


def plan_attention_decode(B: int, T: int, H: int, KV: int, D: int,
                          probs_n: int) -> AttentionPlan:
    """``attention_decode_kernel``'s plan: one cluster of C blocks a
    (batch, KV head), grid (C, KV, B); a block serves the G query heads of
    its KV head over its L keys (T = 512, n = 64: C = 8, L = 64)."""
    C, L = decode_range(T, probs_n)
    G = H // KV
    return AttentionPlan("attention_decode_kernel", 1, G, (C, KV, B),
                         decode_smem_bytes(G, L, D), L)


def decode_long_smem_bytes(G: int, L: int, T: int, D: int, unit: int,
                           bk: int) -> int:
    """Dynamic shared memory of an ``attention_decode_long_kernel`` block,
    as the kernel lays it out: q's G rows and G score rows of L keys (f32,
    rows L + 8 apart), the ring (``DECODE_LONG_STAGES`` stages of a 64-key
    tile's codes, rows D + 16 bytes apart, its scales and kv_pos) and a
    bf16 V tile (rows D + 8 apart), or, during the statistics, the
    maximum, sum and factor (f32) of each of G rows in each of the T / bk
    tiles, whichever is larger; the C blocks' P.V partials of its output
    columns (G x (D + 8) f32 at most), two sums (f64) and a maximum (f32)
    of 16 rows from 8 blocks, l of 16 rows, an int a 64-key tile of T, a
    unit of T, two a tile of L and two a block, then 16 bytes of
    counters."""
    tiles = -(-T // DECODE_TILE)
    units = -(-tiles // (unit // DECODE_TILE))
    stage = DECODE_TILE * (D + 16) + 8 * DECODE_TILE
    ring = DECODE_LONG_STAGES * stage + 2 * DECODE_TILE * (D + 8)
    return (4 * G * D + 4 * G * (L + 8) + max(ring, 12 * G * (T // bk))
            + 4 * G * (D + DECODE_CLUSTER) + 20 * DECODE_CLUSTER * _ROWS_MAX
            + 4 * _ROWS_MAX
            + 4 * (tiles + units + 2 * (L // DECODE_TILE)
                   + 2 * DECODE_CLUSTER) + 16)


def plan_attention_decode_long(B: int, T: int, H: int, KV: int, D: int,
                               bk: int, probs_n: int) -> AttentionPlan:
    """``attention_decode_long_kernel``'s plan: one cluster of C = min(8,
    units of T) blocks a (batch, KV head), grid (C, KV, B); a block holds
    up to ``keys`` = its share of every unit of T (the most a dead row or
    a row that sees them all deals it) and the statistics of every bk
    tile (T = 8192, bk = 512, n = 64: C = 8, 1,024 keys, 96,464 bytes;
    past T = 45,056 at G = 7, D = 128, bk = 512 the block outgrows shared
    memory)."""
    G = H // KV
    unit = decode_unit(probs_n)
    units = -(-T // unit)
    C = min(DECODE_CLUSTER, units)
    L = -(-units // C) * unit
    return AttentionPlan(
        "attention_decode_long_kernel", 1, G, (C, KV, B),
        decode_long_smem_bytes(G, L, T, D, unit, bk), L, C)


def plan_attention_kernel(B: int, S: int, H: int, KV: int, D: int,
                          bk: int) -> AttentionPlan:
    """``attention_kernel``'s plan: 16 // G positions, (R x bk) f32 scores
    a block."""
    bq = max(1, min(S, _ROWS_MAX // (H // KV)))
    rows = bq * (H // KV)
    smem = 4 * (rows * D + 4 * _ROWS_MAX + max(rows * bk, 8 * rows * D))
    return AttentionPlan("attention_kernel", bq, rows, (-(-S // bq), KV, B),
                         smem, bk)


def plan_attention(B: int, S: int, T: int, H: int, KV: int, D: int,
                   bk: int, probs_n: int) -> AttentionPlan:
    """The kernel, block and grid of one call.  The exact body (bk == T)
    takes ``attention_decode_kernel`` at S = 1 and
    ``attention_prefill_kernel`` at S >= ``PREFILL_MIN_S`` positions,
    where their shared memory holds it; every other call at S = 1 (the
    exact body past the decode kernel's ranges, the online and phased
    bodies, any probs group) ``attention_decode_long_kernel``, and from
    ``PREFILL_MIN_S`` positions ``attention_long_kernel``, where theirs
    holds it; anything else ``attention_kernel``."""
    if S < PREFILL_MIN_S:
        if bk == T:
            plan = plan_attention_decode(B, T, H, KV, D, probs_n)
            if plan.smem_bytes <= SMEM_MAX:
                return plan
        plan = plan_attention_decode_long(B, T, H, KV, D, bk, probs_n)
        if plan.smem_bytes <= SMEM_MAX:
            return plan
    if S >= PREFILL_MIN_S and _prefill_groups(probs_n):
        if bk == T and prefill_smem_bytes(T, D) <= SMEM_MAX:
            return plan_attention_prefill(B, S, T, H, KV, D)
        plan = plan_attention_long(B, S, T, H, KV, D, probs_n)
        if plan.smem_bytes <= SMEM_MAX:
            return plan
    return plan_attention_kernel(B, S, H, KV, D, bk)


def flash_attention_quant_plain(
    qh, k_codes, v_codes, k_scale, v_scale, q_pos, kv_pos, window: int, *,
    scale: float, causal: bool = True, probs_n: int = 0,
    probs_qmax: float = 0.0, probs_qmin: float = 0.0, block_k: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention_quant`` (same arguments),
    tile loop and all, so each body's arithmetic can be held against it."""
    B, S, H, D = qh.shape
    T, KV = k_codes.shape[1], k_codes.shape[2]
    G = H // KV
    bk = _tiling(S, T, block_k, probs_n)
    k = (k_codes.to(torch.float32) * k_scale[..., None]).to(qh.dtype)
    v = (v_codes.to(torch.float32) * v_scale[..., None]).to(qh.dtype)
    qg = qh.reshape(B, S, KV, G, D)
    qp = q_pos[:, :, None]
    kp = kv_pos[:, None, :]
    mask = kp >= 0
    if causal:
        mask = mask & (kp <= qp)
    mask = mask & (kp > qp - window)  # (B, S, T)

    # a tile's scores (B, KV, G, S, bk) as the kernels' own f32 chain, fmaf
    # over d = 0 .. D - 1 from 0: the product exact in f64, the sum rounded
    # to f64 then f32 (an fmaf up to a double-rounding tie).  A library
    # product sums in its own order, which depends on the shape (at S = 1
    # on an H100 most scores differ from the chain in the last bit), and a
    # last bit moves a probability across a probs-QDQ boundary now and then.
    q_d = qg.permute(0, 2, 3, 1, 4)[..., None, :].double()
    k_d = k.permute(0, 2, 1, 3)[:, :, None, None].double()

    def scores(t0):
        kt = k_d[..., t0:t0 + bk, :]
        s32 = torch.zeros((B, KV, G, S, kt.shape[-2]), dtype=torch.float32,
                          device=qh.device)
        s64 = torch.empty(s32.shape, dtype=torch.float64, device=qh.device)
        for d in range(D):
            s64.copy_(s32).addcmul_(q_d[..., d], kt[..., d])
            s32.copy_(s64)
        return torch.where(mask[:, None, None, :, t0:t0 + bk], s32 * scale,
                           torch.full_like(s32, NEG_INF))

    def pv(p, t0):
        return torch.einsum("bkgst,btkd->bkgsd", p.to(v.dtype),
                            v[:, t0:t0 + bk])

    qdq = dict(n=probs_n, qmax=probs_qmax, qmin=probs_qmin)
    tiles = range(0, T, bk)
    if bk == T:  # exact
        s = scores(0)
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        p = e / e.sum(dim=-1, keepdim=True)
        if probs_n:
            p = _probs_qdq(p, **qdq)
        acc = pv(p, 0)
    else:
        stat = (B, KV, G, S, 1)
        m = torch.full(stat, M_INIT, dtype=torch.float32, device=qh.device)
        l = torch.zeros(stat, dtype=torch.float32, device=qh.device)
        acc = torch.zeros((B, KV, G, S, D), dtype=torch.float32,
                          device=qh.device)
        for t0 in tiles:  # online recurrence (phased: statistics only)
            s = scores(t0)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            # a tile's sum as the f32 nearest the exact one (taken in f64):
            # a reduction's own order is the library's, and its last bits
            # move a probability across a probs-QDQ boundary now and then
            l = l * corr + p.double().sum(dim=-1, keepdim=True).to(
                torch.float32)
            if not probs_n:
                acc = acc * corr + pv(p, t0)
            m = m_new
        if probs_n:  # phased: second sweep with the final statistics
            for t0 in tiles:
                p = _probs_qdq(torch.exp(scores(t0) - m) / l, **qdq)
                acc = acc + pv(p, t0)
        else:
            acc = acc / torch.clamp_min(l, 1e-30)
    return acc.permute(0, 3, 1, 2, 4).reshape(B, S, H, D).to(qh.dtype)


# the C entry's kernel selector
_KERNEL_IDS = {"attention_kernel": 0, "attention_prefill_kernel": 1,
               "attention_decode_kernel": 2, "attention_long_kernel": 3,
               "attention_decode_long_kernel": 4}


def _bind(lib: ctypes.CDLL):
    fn = lib.repro_flash_attention_quant
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 8 + [i] * 11 + [f, i, f, f, i, i, i, i, i, p,
                                            i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention_quant(
    qh: torch.Tensor,        # (B, S, H, D) f32 (caller applies any q QDQ)
    k_codes: torch.Tensor,   # (B, T, KV, D) int8 / float8_e4m3fn codes
    v_codes: torch.Tensor,   # (B, T, KV, D)
    k_scale: torch.Tensor,   # (B, T, KV) f32 per-token unit scales
    v_scale: torch.Tensor,   # (B, T, KV) f32
    q_pos: torch.Tensor,     # (B, S) int32 absolute query positions
    kv_pos: torch.Tensor,    # (B, T) int32 absolute kv positions; -1 invalid
    window: int,             # sliding window (>= seq len: global)
    *,
    scale: float,
    causal: bool = True,
    probs_n: int = 0,        # ABFP probs-QDQ group length; 0 disables
    probs_qmax: float = 0.0,
    probs_qmin: float = 0.0,
    block_k: int = 0,        # 0: single KV tile (the exact body)
) -> torch.Tensor:
    """Attention over quantized KV codes; returns (B, S, H, D) f32.

    ``kernels.ops.flash_attention_quant_gqa`` is the front-end that owns
    padding and block selection; this entry enforces the tiling contract
    and launches the kernel ``plan_attention`` picks (or, for CPU tensors,
    runs the plain version).
    """
    args = (qh, k_codes, v_codes, k_scale, v_scale, q_pos, kv_pos)
    refuse_grad("flash_attention_quant", *args)
    kw = dict(scale=scale, causal=causal, probs_n=probs_n,
              probs_qmax=probs_qmax, probs_qmin=probs_qmin, block_k=block_k)
    if qh.device.type == "cpu":
        return flash_attention_quant_plain(*args, int(window), **kw)
    if qh.device.type != "cuda":
        raise ValueError(
            f"flash_attention_quant: unsupported device {qh.device}")
    B, S, H, D = qh.shape
    T, KV = k_codes.shape[1], k_codes.shape[2]
    plan = plan_attention(B, S, T, H, KV, D, _tiling(S, T, block_k, probs_n),
                          probs_n)
    return _flash_attention_quant(*args, int(window), plan=plan, **kw)


def _flash_attention_quant(qh, k_codes, v_codes, k_scale, v_scale, q_pos,
                           kv_pos, window: int, *, plan: AttentionPlan,
                           scale: float, causal: bool, probs_n: int,
                           probs_qmax: float, probs_qmin: float,
                           block_k: int) -> torch.Tensor:
    """``flash_attention_quant`` on CUDA tensors with the kernel of
    ``plan`` (the one ``plan_attention`` returns, or ``attention_kernel``'s
    plan for the same call: what ``chip_smoke.py`` compares them with)."""
    B, S, H, D = qh.shape
    T, KV = k_codes.shape[1], k_codes.shape[2]
    bk = _tiling(S, T, block_k, probs_n)
    if H % KV:
        raise ValueError(f"H={H} query heads do not group over KV={KV}")
    G = H // KV
    if G > _ROWS_MAX or D % 16 or D > 128:
        raise ValueError(
            "flash_attention_quant kernel takes head_dim a multiple of 16 "
            f"up to 128 and at most {_ROWS_MAX} query heads per KV head; "
            f"got D={D}, H/KV={G}")
    if k_codes.dtype not in (torch.int8, torch.float8_e4m3fn):
        raise ValueError(
            f"KV codes must be int8 or float8_e4m3fn, got {k_codes.dtype}")
    shapes = (("qh", qh, (B, S, H, D), torch.float32),
              ("k_codes", k_codes, (B, T, KV, D), k_codes.dtype),
              ("v_codes", v_codes, (B, T, KV, D), k_codes.dtype),
              ("k_scale", k_scale, (B, T, KV), torch.float32),
              ("v_scale", v_scale, (B, T, KV), torch.float32),
              ("q_pos", q_pos, (B, S), torch.int32),
              ("kv_pos", kv_pos, (B, T), torch.int32))
    for name, t, shape, dt in shapes:
        if tuple(t.shape) != shape or t.dtype != dt:
            raise ValueError(
                f"flash_attention_quant: {name} must be {shape} {dt}, got "
                f"{tuple(t.shape)} {t.dtype}")
        if t.device != qh.device:
            raise ValueError(f"flash_attention_quant: {name} on {t.device}, "
                             f"qh on {qh.device}")
        if not t.is_contiguous():
            raise ValueError(
                f"flash_attention_quant: {name} must be contiguous")
    kernel = _KERNEL_IDS[plan.kernel]
    if plan.kernel == "attention_prefill_kernel" and (
            bk != T or not _prefill_groups(probs_n)):
        raise ValueError(
            "attention_prefill_kernel runs the exact body (block_k = T) "
            f"with probs groups dividing or divided by {PREFILL_KEYS}; "
            f"got block_k={bk}, T={T}, probs_n={probs_n}")
    C = plan.cluster
    if plan.kernel == "attention_long_kernel" and (
            not _prefill_groups(probs_n) or plan.positions * G > PREFILL_ROWS
            or not 1 <= C <= LONG_CLUSTER or D % (2 * C)
            or plan.grid[0] != C * -(-S // plan.positions)
            or (plan.slots and plan.slots < long_slots(T, probs_n, C))):
        raise ValueError(
            "attention_long_kernel takes 64-row tiles split over up to "
            f"{LONG_CLUSTER} blocks (long_cluster(T)), slots for a block's share of the "
            f"units (or none) and probs groups dividing or divided by "
            f"{PREFILL_KEYS}; got probs_n={probs_n}, positions="
            f"{plan.positions}, grid={plan.grid}, cluster={C}, "
            f"slots={plan.slots}")
    L = plan.keys
    if plan.kernel == "attention_decode_kernel" and (
            bk != T or S != 1 or L <= 0 or L % DECODE_TILE
            or (probs_n and L % probs_n) or -(-T // L) > DECODE_CLUSTER):
        raise ValueError(
            "attention_decode_kernel runs the exact body (block_k = T) at "
            f"S = 1 over at most {DECODE_CLUSTER} ranges of whole "
            f"{DECODE_TILE}-key tiles and probs groups; got block_k={bk}, "
            f"T={T}, S={S}, keys={L}, probs_n={probs_n}")
    if plan.kernel == "attention_decode_long_kernel" and (
            S != 1 or not 1 <= C <= DECODE_CLUSTER or plan.grid[0] != C
            or L % decode_unit(probs_n)
            or L < -(-(-(-T // decode_unit(probs_n))) // C)
            * decode_unit(probs_n)):
        raise ValueError(
            "attention_decode_long_kernel takes S = 1 over clusters of up "
            f"to {DECODE_CLUSTER} blocks, each holding its share of T's "
            f"units (decode_unit(probs_n) keys each); got S={S}, T={T}, "
            f"grid={plan.grid}, cluster={C}, keys={L}, probs_n={probs_n}")
    if kernel:
        # 16-byte code copies, 8-byte q loads
        for name, t in (("qh", qh), ("k_codes", k_codes),
                        ("v_codes", v_codes)):
            if t.data_ptr() % 16:
                raise ValueError(f"flash_attention_quant: {name} must be "
                                 "16-byte aligned")
    if plan.smem_bytes > SMEM_MAX:
        raise ValueError(smem_message(
            "flash_attention_quant",
            f"a ({plan.rows} x {bk}) score tile (use a smaller block_k)",
            plan.smem_bytes, SMEM_MAX))
    mode = 0 if bk == T else (2 if probs_n else 1)
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=qh.device)
    if out.numel() == 0:
        return out
    # attention_long_kernel's pass-1 score tiles, per block (T = 8192, S =
    # 64, B = 4: 1,024 blocks x 16 tiles of 16 KB = 256 MiB; none where the
    # plan has pass 2 form the scores again)
    scratch = None
    if plan.kernel == "attention_long_kernel" and plan.slots:
        scratch = torch.empty(long_scratch_bytes(plan) // 4,
                              dtype=torch.float32, device=qh.device)
    fn = _bind(build.load("flash_attention_quant"))
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qh.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(), q_pos.data_ptr(),
                 kv_pos.data_ptr(), out.data_ptr(), B, S, T, H, KV, D,
                 plan.positions, bk, mode, int(window), int(causal),
                 float(scale), int(probs_n), float(probs_qmax),
                 float(probs_qmin), int(k_codes.dtype == torch.float8_e4m3fn),
                 kernel, L, C, plan.smem_bytes,
                 None if scratch is None else scratch.data_ptr(), plan.slots,
                 stream)
    flash_attention_quant.launches += 1
    flash_attention_quant.launches_by_kernel[plan.kernel] += 1
    if err != 0:
        raise RuntimeError(
            f"flash_attention_quant kernel launch failed: CUDA error {err}")
    return out


flash_attention_quant.launches = 0  # kernel launches through this wrapper
# ... and of each of its five kernels
flash_attention_quant.launches_by_kernel = {
    "attention_kernel": 0, "attention_prefill_kernel": 0,
    "attention_decode_kernel": 0, "attention_long_kernel": 0,
    "attention_decode_long_kernel": 0}
