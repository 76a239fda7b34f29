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

On the card ``plan_flash`` plans every call for ``flash_mma_kernel``
(``csrc/flash_attention.cu``; see the source for its design): a block
serves three m16 tiles of rows (position x G + head) of one KV head, an
early, a middle and a late one, so K / V tiles are copied once for all G
query heads and causal work is even across blocks; scores and P.V run on
the tensor cores as three tf32 products a product (f32 accuracy), the
softmax on the score fragments, the K / V tiles copied two deep by
``cp.async``.  Head dimensions up to 128 take the kernel instantiated for
the next of 16, 32, 64, 128 (zero-padded on chip).  A CUDA tensor
launches it or raises; a CPU tensor runs ``flash_attention_plain``, which
walks the reference's key tiles (``block_k``) with its recurrence op for
op.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.analysis.messages import flash_q_offset_message
from repro_torch.kernels import build, refuse_grad
from repro_torch.kernels.ops import SMEM_MAX

NEG_INF = -1e30

# flash_mma_kernel: rows a block serves (3 m16 tiles), keys a K / V tile
# holds and the head dimensions it is instantiated for (every plan fits
# in ``SMEM_MAX``: 214,272 bytes at D = 128)
FLASH_ROWS = 48
FLASH_KEYS = 64
FLASH_WIDTHS = (16, 32, 64, 128)


class FlashPlan(NamedTuple):
    """How ``flash_attention`` launches on the card (``plan_flash``)."""
    kernel: str       # flash_mma_kernel
    head_dim: int     # the instantiation: D zero-padded to this width
    rows: int         # rows (position x G + head) a block serves
    grid: int         # blocks: row tiles x B*KV, 1-D
    smem_bytes: int   # dynamic shared memory of one block


def flash_smem_bytes(dp: int) -> int:
    """Dynamic shared memory of a ``flash_mma_kernel`` block, as the kernel
    lays it out: q's 48 rows split into big and small terms, two stages of
    a 64-key K tile and V tile (rows ``dp + 4`` floats apart), p's big and
    small terms (rows of 72 floats), and the four key parts' row maxima."""
    return 4 * ((dp + 4) * (2 * FLASH_ROWS + 4 * FLASH_KEYS)
                + 2 * FLASH_ROWS * (FLASH_KEYS + 8) + 4 * FLASH_ROWS)


def plan_flash(B: int, S: int, T: int, H: int, KV: int, D: int,
               causal: bool = True) -> FlashPlan:
    """The kernel, instantiation and grid of one call: every call the
    wrapper takes (D <= 128) fits ``flash_mma_kernel``'s shared memory, so
    it is the only route.  A block serves 48 rows, three m16 tiles of
    one KV head; the fixed-slot prefill's largest call (S = T = 192, H =
    28, KV = 4) is 28 x 4 = 112 blocks, one wave.  ``causal`` changes no
    number here (the kernel spreads each head's m16 tiles over its blocks
    either way)."""
    if not 1 <= D <= FLASH_WIDTHS[-1]:
        raise ValueError(f"flash_attention kernel takes head_dim 1 .. "
                         f"{FLASH_WIDTHS[-1]}; got D={D}")
    dp = next(w for w in FLASH_WIDTHS if w >= D)
    row_tiles = -(-S * (H // KV) // FLASH_ROWS)
    plan = FlashPlan("flash_mma_kernel", dp, FLASH_ROWS, row_tiles * B * KV,
                     flash_smem_bytes(dp))
    assert plan.smem_bytes <= SMEM_MAX
    return plan


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
        fn.argtypes = [p] * 4 + [i] * 5 + [f] + [i] * 4 + [p]
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
    refuse_grad("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, scale, causal, q_offset,
                                     block_q, block_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    BH, S, D, BHkv, T, q_offset = _shapes(q, k, v, causal, q_offset)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.float32:
            raise ValueError(f"flash_attention: {name} must be float32, got "
                             f"{t.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    G = BH // BHkv
    # the BHkv (batch, KV head) pairs as B x 1 KV head of G query heads
    plan = plan_flash(BHkv, S, T, G, 1, D, causal)
    scale = D ** -0.5 if scale is None else scale
    # 16-byte copies where every row starts on a 16-byte boundary
    vec = D % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (q, k, v))
    fn = _bind(build.load("flash_attention"))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 BHkv, S, T, D, G, float(scale), int(causal), q_offset,
                 plan.head_dim, int(vec), stream)
    flash_attention.launches += 1
    flash_attention.launches_by_kernel[plan.kernel] += 1
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: CUDA error {err}")
    return out


flash_attention.launches = 0  # kernel launches made through this wrapper
# ... by kernel (one kernel: plan_flash routes every call to it)
flash_attention.launches_by_kernel = {"flash_mma_kernel": 0}
