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

On an H100 at serving sizes (B = 4, T = 512: about 2 MB of codes) a call is
bound by latency and f32 multiply-adds, not by bandwidth; the kernel
(``csrc/flash_attention_quant.cu``) lets one block serve all query heads of
a KV head so codes are read once.  See the source for the design.

A CUDA tensor launches the kernel or raises; a CPU tensor runs
``flash_attention_quant_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.messages import (abfp_group_message,
                                           attention_block_message)
from repro_torch.core.quantize import div_by_constant
from repro_torch.kernels import build

NEG_INF = -1e9  # mask value — matches nn.attention.NEG_INF
M_INIT = -1e30  # running-max init; exp(M_INIT - m_new) underflows to 0

_ROWS_MAX = 16          # query rows (positions x grouped heads) per block
_SMEM_MAX = 232448      # dynamic shared memory a block may use on sm_90


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

    def scores(t0):
        s = torch.einsum("bskgd,btkd->bkgst", qg, k[:, t0:t0 + bk]) * scale
        return torch.where(mask[:, None, None, :, t0:t0 + bk], s,
                           torch.full_like(s, NEG_INF))

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
            l = l * corr + p.sum(dim=-1, keepdim=True)
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


def _bind(lib: ctypes.CDLL):
    fn = lib.repro_flash_attention_quant
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 8 + [i] * 11 + [f, i, f, f, i, p]
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
    and launches the kernel (or, for CPU tensors, runs the plain version).
    """
    args = (qh, k_codes, v_codes, k_scale, v_scale, q_pos, kv_pos)
    kw = dict(scale=scale, causal=causal, probs_n=probs_n,
              probs_qmax=probs_qmax, probs_qmin=probs_qmin, block_k=block_k)
    if qh.device.type == "cpu":
        return flash_attention_quant_plain(*args, int(window), **kw)
    if qh.device.type != "cuda":
        raise ValueError(
            f"flash_attention_quant: unsupported device {qh.device}")
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
    bq = max(1, min(S, _ROWS_MAX // G))
    rows = bq * G
    smem = 4 * (rows * D + 4 * _ROWS_MAX + max(rows * bk, 8 * rows * D))
    if smem > _SMEM_MAX:
        raise ValueError(
            f"flash_attention_quant: a ({rows} x {bk}) score tile needs "
            f"{smem} bytes of shared memory (> {_SMEM_MAX}); use a smaller "
            "block_k")
    mode = 0 if bk == T else (2 if probs_n else 1)
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=qh.device)
    if out.numel() == 0:
        return out
    fn = _bind(build.load("flash_attention_quant"))
    with torch.cuda.device(qh.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qh.data_ptr(), k_codes.data_ptr(), v_codes.data_ptr(),
                 k_scale.data_ptr(), v_scale.data_ptr(), q_pos.data_ptr(),
                 kv_pos.data_ptr(), out.data_ptr(), B, S, T, H, KV, D, bq,
                 bk, mode, int(window), int(causal), float(scale),
                 int(probs_n), float(probs_qmax), float(probs_qmin),
                 int(k_codes.dtype == torch.float8_e4m3fn), stream)
    flash_attention_quant.launches += 1
    if err != 0:
        raise RuntimeError(
            f"flash_attention_quant kernel launch failed: CUDA error {err}")
    return out


flash_attention_quant.launches = 0  # kernel launches through this wrapper
