"""Front-ends over the kernels: layout, padding and block selection.

``fit_block()`` — the block-size back-off the front-ends use: a tiled
dimension must divide its block, so the preferred block is halved until it
does.

Unlike the reference's wrappers, these take any M and N: the CUDA kernels
mask ragged edges themselves, so there is no tiling contract to meet.
"""

from __future__ import annotations

# Dynamic shared memory a block may use on sm_90 (227 KiB, the opt-in
# maximum): the one budget the kernels' plans and qlint's QL303 read.  It
# is set before the kernel modules are imported, which read it from here.
SMEM_MAX = 232448

import torch

from repro_torch.core.policy import QuantPolicy
from repro_torch.kernels import abfp_qdq as _qdq_mod
from repro_torch.kernels import flash_attention as _fa_mod
from repro_torch.kernels import flash_attention_quant as _faq_mod
from repro_torch.kernels import quant_matmul as _mm_mod


def fit_block(dim: int, start: int = 256, multiple: int = 1) -> int:
    """Largest block <= ``start`` that divides ``dim``.

    Halves ``start`` until it divides ``dim`` (bottoming out at
    ``multiple``); ``multiple`` > 1 keeps the result a multiple of the
    group length (blocks are counted in units of ``multiple``).
    """
    if multiple > 1:
        if dim % multiple:
            raise ValueError(
                f"dim={dim} is not a multiple of the group unit "
                f"{multiple}; cannot pick a block size"
            )
        return fit_block(dim // multiple, max(start // multiple, 1)) * multiple
    b = start
    while dim % b and b > 1:
        b //= 2
    return b


def abfp_qdq(x, fmt, n: int = 64):
    """Fused QDQ over the last dim; leading dims are flattened to rows."""
    shape = x.shape
    y = _qdq_mod.abfp_qdq(x.reshape(-1, shape[-1]).contiguous(), fmt, n=n)
    return y.reshape(shape)


def flash_attention_gqa(qh, kh, vh, scale: float | None = None,
                        causal: bool = True, q_offset: int | None = None,
                        block_q: int = 128, block_k: int = 128):
    """(B, S, H, D) GQA front-end for the dense flash kernel.

    Heads fold into the batch dim; KV heads are not repeated to the query
    head count — the kernel reads KV head ``h // (H // KV)`` for query head
    ``h``, the values the reference's repeat would give it.  No softcap or
    window support (callers keep the plain paths for those variants).
    """
    B, S, H, D = qh.shape
    T, KV = kh.shape[1], kh.shape[2]
    q = qh.transpose(1, 2).reshape(B * H, S, D).contiguous()
    k = kh.transpose(1, 2).reshape(B * KV, T, D).contiguous()
    v = vh.transpose(1, 2).reshape(B * KV, T, D).contiguous()
    o = _fa_mod.flash_attention(q, k, v, scale=scale, causal=causal,
                                q_offset=q_offset, block_q=block_q,
                                block_k=block_k)
    return o.reshape(B, H, S, D).transpose(1, 2)


def flash_attention_quant_gqa(qh, k_codes, v_codes, k_scale, v_scale,
                              q_pos, kv_pos, window=None,
                              scale: float | None = None,
                              causal: bool = True,
                              probs_tq=None,
                              block_k: int = 512,
                              single_block_max: int = 2048):
    """(B, S, H, D) GQA front-end for the quantized-KV attention kernel.

    ``k_codes``/``v_codes``: (B, T, KV, D) int8/fp8 codes straight from the
    cache (a paged gather — never dequantized); ``k_scale``/``v_scale``:
    (B, T, KV) f32 per-token unit scales (page scales broadcast over their
    tokens by the caller); ``q_pos`` (B, S) / ``kv_pos`` (B, T) absolute
    positions with -1 marking invalid KV slots; ``window`` a sliding-window
    length (None = global).

    ``probs_tq``: the policy's input TensorQuant when attention-probability
    QDQ is active — must be an int-format ABFP quantizer; T is zero-padded
    to a multiple of its group so groups tile exactly (padded positions
    carry ``kv_pos = -1`` and land on probability 0, matching the
    reference's zero-padded groups bit-for-bit).

    Body choice: padded T <= ``single_block_max`` takes the exact body
    (K/V read once); longer contexts the online body, or the phased one
    when the probs QDQ is on.
    """
    B, S, H, D = qh.shape
    T = k_codes.shape[1]
    n = 0
    qmax = qmin = 0.0
    if probs_tq is not None:
        fmt = probs_tq.fmt
        n = int(probs_tq.group)
        qmax, qmin = float(fmt.qmax_pos), float(fmt.qmin)
    scale = D ** -0.5 if scale is None else scale
    if n:
        T_pad = -(-T // n) * n
    elif T > single_block_max:
        T_pad = -(-T // 128) * 128  # keep fit_block away from tiny tilings
    else:
        T_pad = T
    kv_pos = kv_pos.to(torch.int32)
    if T_pad > T:
        p = T_pad - T
        pad = torch.nn.functional.pad
        # fp8 tensors pad through their byte view (0x00 is +0 in e4m3)
        byte = lambda c: (c.view(torch.uint8) if c.dtype.is_floating_point
                          else c)
        k_codes = pad(byte(k_codes), (0, 0, 0, 0, 0, p)).view(k_codes.dtype)
        v_codes = pad(byte(v_codes), (0, 0, 0, 0, 0, p)).view(v_codes.dtype)
        k_scale = pad(k_scale, (0, 0, 0, p))
        v_scale = pad(v_scale, (0, 0, 0, p))
        kv_pos = pad(kv_pos, (0, p), value=-1)
    if T_pad <= single_block_max:
        bk = 0  # single KV tile: the exact (serving) body, K/V read once
    else:
        bk = fit_block(T_pad, start=block_k, multiple=n if n else 1)
    if window is None:
        window = T + S + 1  # > any position delta: global attention
    return _faq_mod.flash_attention_quant(
        qh.contiguous(), k_codes.contiguous(), v_codes.contiguous(),
        k_scale.to(torch.float32).contiguous(),
        v_scale.to(torch.float32).contiguous(),
        q_pos.to(torch.int32).contiguous(), kv_pos.contiguous(), int(window),
        scale=scale, causal=causal, probs_n=n, probs_qmax=qmax,
        probs_qmin=qmin, block_k=bk,
    )


def quant_matmul_fused(x, wk, tq_x):
    """Compressed-domain kernel dispatch: (…, K) x stored codes + scales.

    ``wk`` is a ``CompressedKernel``; packed INT4 codes go to the kernel as
    stored (it unpacks nibbles in registers — the wrapper never expands
    them in device memory).  x is zero-padded to the stored (padded)
    contraction length so codes and activations tile identically.
    """
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).to(torch.float32)
    if wk.pad:
        x2 = torch.nn.functional.pad(x2, (0, wk.pad))
    y = _mm_mod.quant_matmul(
        x2.contiguous(), wk.codes, wk.scale, tq_x.fmt, n=wk.group,
        packed=wk.packed,
    )
    return y.reshape(*shape[:-1], wk.codes.shape[0])


def abfp_matmul_fused(x, w, policy: QuantPolicy):
    """Dispatch the fused kernel for a (…, K) x (K, N) quantized matmul:
    ``abfp_matmul_int8`` when ``policy.compute == 'int8'``, else
    ``abfp_matmul``; groups of the input quantizer's length along K."""
    tq_x, tq_w = policy.input, policy.weight
    if tq_x is None or tq_w is None:
        raise ValueError(
            f"fused path needs both x and w quantizers; policy "
            f"{policy.name!r} has input={tq_x} weight={tq_w}"
        )
    n = tq_x.group
    shape = x.shape
    x2 = x.reshape(-1, shape[-1]).to(torch.float32).contiguous()
    w = w.to(torch.float32).contiguous()
    if policy.compute == "int8":
        y = _mm_mod.abfp_matmul_int8(x2, w, tq_x.fmt, tq_w.fmt, n=n)
    else:
        y = _mm_mod.abfp_matmul(x2, w, tq_x.fmt, tq_w.fmt, n=n)
    return y.reshape(*shape[:-1], w.shape[1])
