"""Dense flash attention: CUDA kernel wrapper + plain version.

``flash_attention`` replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention`` (body ``_kernel``):
``softmax(q k^T * scale) v`` over ``q (BH, S, D)`` and ``k, v (BHkv, T,
D)`` with the reference's online softmax per key tile, ``NEG_INF = -1e30``
for masked scores and its guards for rows that are masked so far (their
``p`` and correction are 0, never ``exp(NEG_INF - NEG_INF)``).  Causality
keeps key ``t`` for query row ``i`` where ``t <= i + q_offset``; a causal
call with ``S != T`` must pass ``q_offset``.

The reference takes K/V with as many heads as q (its front-end repeats KV
heads); here ``BHkv`` may be ``BH / G`` and query head ``bh`` reads key head
``bh // G`` — the same values, without the repeated copy.

On an H100 at prefill lengths a call is bound by f32 multiply-adds; the
kernel is ``csrc/flash_attention.cu``.  A CUDA tensor launches it or
raises; a CPU tensor runs ``flash_attention_plain``, which walks the
reference's key tiles (``block_k``) with its recurrence op for op.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.analysis.messages import flash_q_offset_message
from repro_torch.kernels import build

NEG_INF = -1e30
_D_MAX = 128  # largest head_dim the kernel takes


def _shapes(q, k, v, causal: bool, q_offset):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention takes q (BH, S, D) and k, v (BHkv, T, D); got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    BH, S, D = q.shape
    BHkv, T, Dk = k.shape
    if Dk != D or BH % BHkv:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)} does not group over k "
            f"{tuple(k.shape)} (head_dim must match, BH a multiple of BHkv)")
    if q_offset is None:
        if causal and S != T:
            raise ValueError(flash_q_offset_message(S, T))
        q_offset = 0
    return BH, S, D, BHkv, T, int(q_offset)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float | None = None, causal: bool = True,
                          q_offset: int | None = None, block_q: int = 128,
                          block_k: int = 128) -> torch.Tensor:
    """Plain PyTorch version of ``flash_attention`` (same arguments).  Rows
    are independent, so ``block_q`` changes nothing; the key tiles of
    ``fit_block(T, block_k)`` are walked as the reference walks them."""
    from repro_torch.kernels.ops import fit_block  # lazy: no import cycle

    BH, S, D, BHkv, T, q_offset = _shapes(q, k, v, causal, q_offset)
    G = BH // BHkv
    scale = D ** -0.5 if scale is None else scale
    bk = fit_block(T, start=block_k)
    dev = q.device
    torch.backends.cuda.matmul.allow_tf32 = False  # f32 means f32
    qg = q.to(torch.float32).reshape(BHkv, G * S, D)
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    qpos = (q_offset + torch.arange(S, device=dev)).repeat(G)  # (G*S,)
    m = torch.full((BHkv, G * S, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros((BHkv, G * S, D), dtype=torch.float32, device=dev)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for t0 in range(0, T, bk):
        s = torch.einsum("bsd,btd->bst", qg, kf[:, t0:t0 + bk]) * scale
        if causal:
            kpos = t0 + torch.arange(bk, device=dev)
            s = torch.where(kpos[None, None, :] <= qpos[None, :, None], s,
                            neg)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.where(s <= NEG_INF / 2, zero, torch.exp(s - m_new))
        corr = torch.where(m <= NEG_INF / 2, zero, torch.exp(m - m_new))
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + torch.einsum("bst,btd->bsd", p,
                                        vf[:, t0:t0 + bk])
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)
    return out.reshape(BH, S, D).to(q.dtype)


def _bind(lib: ctypes.CDLL):
    fn = lib.repro_flash_attention
    if not fn.argtypes:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 4 + [i] * 5 + [f, i, i, p]
        fn.restype = ctypes.c_int
    return fn


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float | None = None, causal: bool = True,
                    q_offset: int | None = None, block_q: int = 128,
                    block_k: int = 128) -> torch.Tensor:
    """Flash attention over ``q (BH, S, D)``, ``k, v (BHkv, T, D)``;
    returns ``(BH, S, D)`` in q's dtype.  ``q_offset`` is the absolute
    position of query row 0 (causal: ``t <= i + q_offset``); it defaults to
    0 when ``S == T`` and must be given otherwise.  ``block_q``/``block_k``
    are the reference's tiling; the kernel tiles by its own sizes."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal, q_offset,
                                     block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    BH, S, D, BHkv, T, q_offset = _shapes(q, k, v, causal, q_offset)
    if D > _D_MAX:
        raise ValueError(f"flash_attention kernel takes head_dim <= "
                         f"{_D_MAX}; got D={D}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise ValueError(f"flash_attention: {name} must be float32, got "
                             f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    scale = D ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _bind(build.load("flash_attention"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BH, S, T, D, BH // BHkv, float(scale), int(causal),
                 q_offset, stream)
    flash_attention.launches += 1
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    return out


flash_attention.launches = 0  # kernel launches made through this wrapper
