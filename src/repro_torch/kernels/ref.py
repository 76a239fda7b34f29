"""Plain PyTorch oracles for the kernels (the ground truth in tests).

These re-derive the math independently of ``core.abfp``'s helpers where
practical, so kernel bugs and library bugs cannot cancel.  Each mirrors
the function of the same name in the reference package's ``kernels/ref``.
"""

from __future__ import annotations

import torch

from repro_torch.analysis.messages import abfp_group_message
from repro_torch.core.formats import Format, IntFormat
from repro_torch.core.quantize import div_by_constant


def _group_scales(x: torch.Tensor, axis: int, n: int,
                  scale_dtype=torch.bfloat16) -> torch.Tensor:
    """Per-group max(|x|) scales along ``axis``, rounded to bf16, floored."""
    xm = torch.movedim(x, axis, -1)
    g = xm.shape[-1] // n
    xg = xm.reshape(*xm.shape[:-1], g, n)
    alpha = xg.abs().amax(dim=-1)
    return torch.clamp_min(alpha.to(scale_dtype).to(torch.float32), 1e-12)


def abfp_qdq_ref(x: torch.Tensor, fmt: Format, n: int = 64,
                 axis: int = -1) -> torch.Tensor:
    """Reference ABFP quantize-dequantize along ``axis``."""
    axis = axis % x.ndim
    xm = torch.movedim(x, axis, -1)
    if xm.shape[-1] % n:
        raise ValueError(abfp_group_message(xm.shape[-1], n,
                                            where="abfp_qdq_ref"))
    g = xm.shape[-1] // n
    xg = xm.reshape(*xm.shape[:-1], g, n).to(torch.float32)
    scale = div_by_constant(_group_scales(x, axis, n)[..., None],
                            fmt.qmax_pos)
    yg = fmt.qdq_unit(xg / scale) * scale
    return torch.movedim(yg.reshape(xm.shape), -1, axis).to(x.dtype)


def abfp_matmul_ref(x: torch.Tensor, w: torch.Tensor, fmt_x: Format,
                    fmt_w: Format, n: int = 64) -> torch.Tensor:
    """Reference fused ABFP matmul: QDQ both operands along K, f32 dot."""
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
    xq = abfp_qdq_ref(x, fmt_x, n, axis=-1)
    wq = abfp_qdq_ref(w, fmt_w, n, axis=0)
    return torch.matmul(xq.to(torch.float32), wq.to(torch.float32))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        scale: float | None = None, causal: bool = True,
                        q_offset: int | None = None) -> torch.Tensor:
    """Reference attention: materialized softmax(QK^T·scale)V, causal.

    ``q_offset`` is the absolute position of query row 0; under causal it
    defaults to ``T - S`` (queries are the trailing suffix of the KV
    timeline).  The kernel refuses to guess and requires it when S != T.
    """
    BH, S, D = q.shape
    T = k.shape[1]
    scale = D ** -0.5 if scale is None else scale
    torch.backends.cuda.matmul.allow_tf32 = False
    s = torch.einsum("bsd,btd->bst", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        if q_offset is None:
            q_offset = T - S
        dev = q.device
        mask = (torch.arange(T, device=dev)[None, :]
                <= torch.arange(S, device=dev)[:, None] + q_offset)
        s = torch.where(mask[None], s, torch.full_like(s, -1e30))
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    out = torch.einsum("bst,btd->bsd", p, v.to(torch.float32))
    return out.to(q.dtype)


def int8_matmul_ref(x: torch.Tensor, w: torch.Tensor, fmt_x: Format,
                    fmt_w: Format, n: int = 64) -> torch.Tensor:
    """Reference native-int path: per-group int codes, exact integer group
    sums, per-group rescale."""
    if not (isinstance(fmt_x, IntFormat) and isinstance(fmt_w, IntFormat)):
        raise TypeError(
            "int8_matmul_ref accumulates integer codes: both formats must "
            f"be IntFormat, got fmt_x={fmt_x!r} fmt_w={fmt_w!r}")
    M, K = x.shape
    K2, N = w.shape
    if K != K2:
        raise ValueError(
            f"contraction mismatch: x has K={K} but w has K={K2}")
    if K % n:
        raise ValueError(abfp_group_message(K, n, where="int8_matmul_ref"))
    g = K // n
    sx = div_by_constant(_group_scales(x, -1, n), fmt_x.qmax_pos)  # (M, g)
    sw = div_by_constant(_group_scales(w, 0, n), fmt_w.qmax_pos)   # (N, g)
    xg = x.to(torch.float32).reshape(M, g, n)
    wg = torch.movedim(w.to(torch.float32), 0, -1).reshape(N, g, n)
    xc = torch.clamp(torch.round(xg / sx[..., None]), fmt_x.qmin,
                     fmt_x.qmax_pos)
    wc = torch.clamp(torch.round(wg / sw[..., None]), fmt_w.qmin,
                     fmt_w.qmax_pos)
    # integer-valued products summed in f64: exact, like the int32 sums
    partial = torch.einsum("mgk,ngk->mgn", xc.double(),
                           wc.double()).to(torch.float32)
    return torch.einsum("mgn,mg,ng->mn", partial, sx, sw)
