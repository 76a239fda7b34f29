"""``abfp_matmul_int8`` at decode (M <= 16): the plan of its decode kernel
and an emulation of that kernel's arithmetic, against the plain version and
the reference package (``kernels.ref.int8_matmul_ref`` and the Pallas
kernel in interpret mode), on the same numpy inputs.

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
the plain version there); what it computes is pinned here, step by step:
x's code words laid out in shared memory as the kernel permutes them, each
thread's quarter of a column group packed four rows to a ``__dp4a`` word,
the quarters' exact integer sums joined, ``((float)P * sx) * sw`` in f32,
groups added in order within a split, splits in split order.

Tolerances: rtol = atol = 1e-5 against the plain version and the reference
(same codes, same exact integer group sums; only the f32 sum over groups
runs in another order), and bit-equal where K = n (one group: one rescale,
no sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import get_format as j_get_format
from repro.kernels import quant_matmul as j_mm
from repro.kernels import ref as jref
from repro_torch.core import abfp as abfp_mod
from repro_torch.core.formats import get_format as t_get_format
from repro_torch.kernels import quant_matmul as t_mm

# (K, N) of qwen2-7b's dense layers and lm_head; the reduced config's q
# (G = 1), wo (G = 2) and its ragged lm_head (N = 503); ragged N
DECODE_SHAPES = [(3584, 3584), (3584, 512), (3584, 18944), (18944, 3584),
                 (3584, 152064), (64, 64), (128, 64), (64, 503), (640, 77),
                 (64, 130)]


def _x(seed, M, K):
    """Activation-like values: normal, a few outlier columns, a zero row
    (its groups take the 1e-12 scale floor)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K) * (1 + 7 * (rng.rand(1, K) > 0.9))
    if M > 1:
        x[1] = 0.0
    return x.astype(np.float32)


def _w(seed, K, N):
    return (np.random.RandomState(seed).randn(K, N) / np.sqrt(K)).astype(
        np.float32)


@pytest.mark.parametrize("n", [64, 32])
@pytest.mark.parametrize("M", [1, 2, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("K,N", DECODE_SHAPES)
def test_int8_decode_plan_is_the_fp_grid(K, N, M, n):
    """Same tiles and whole-group splits as ``abfp_matmul``'s decode plan
    (so the shared tickets cover it), at least two waves of blocks on 132
    SMs unless K has too few groups; only the ring's x tile differs."""
    plan = t_mm.plan_abfp_matmul(M, N, K, n, int8=True)
    fp = t_mm.plan_abfp_matmul(M, N, K, n)
    assert plan.regime == "decode"
    assert plan._replace(smem_bytes=0) == fp._replace(smem_bytes=0)
    bm = plan.block_rows
    assert bm == (4 if M <= 4 else 8 if M <= 8 else 16) and bm % 2 == 0
    G = K // n
    bounds = t_mm.split_bounds(G, plan.splits)
    assert bounds[0][0] == 0 and bounds[-1][1] == G
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert sum((hi - lo) * n for lo, hi in bounds) == K
    assert plan.tiles * plan.splits >= 2 * t_mm.SMS or plan.splits == G
    assert plan.tiles <= t_mm.DECODE_WAVES * t_mm.SMS or plan.splits == 1
    # 4 stages of an (n, 68) f32 w tile, (BM, n) int8 x codes, BM scales
    assert plan.smem_bytes == 4 * (4 * n * 68 + bm * n + 4 * bm)
    # three blocks fit on an SM (the kernel's launch bound)
    assert 3 * plan.smem_bytes <= 227 * 1024


def test_int8_decode_plan_at_the_main_path_shapes():
    grid = {(K, N): (p.tiles, p.splits) for K, N in DECODE_SHAPES[:5]
            for p in [t_mm.plan_abfp_matmul(4, N, K, 64, int8=True)]}
    assert grid == {(3584, 3584): (56, 19), (3584, 512): (8, 33),
                    (3584, 18944): (296, 4), (18944, 3584): (56, 19),
                    (3584, 152064): (2376, 1)}


@pytest.mark.parametrize("M,n", [(17, 64), (64, 64), (192, 32), (4, 16),
                                 (4, 512), (16, 128)])
def test_int8_other_rows_and_groups_take_the_prefill_path(M, n):
    """Above 16 rows, or a group length the decode kernel is not built for,
    the three-launch path on mma_contract_kernel's grid: 64 x 128 tiles, K
    split into whole groups until the blocks fill the 132 SMs, a
    ring of whole groups (chunks of at most 128 codes) that fits in a
    block's shared memory at any group length (abfp_matmul's bf16 ring
    too, at n = 512)."""
    plan = t_mm.plan_abfp_matmul(M, 3584, 4096, n, int8=True)
    mma = t_mm.plan_int8_contract(M, 3584, 4096, n)
    assert plan.regime == "prefill"
    assert plan.block_rows == mma.block_rows == 64
    assert plan.tiles == mma.tiles == -(-3584 // 128) * -(-M // 64)
    assert plan.splits == mma.splits == max(
        1, min(4096 // n, -(-t_mm.SMS // plan.tiles)))
    assert plan.smem_bytes == mma.smem_bytes
    assert 0 < plan.smem_bytes <= 232448
    if n == 512:  # abfp_matmul's bf16 contraction takes it as well
        fp = t_mm.plan_abfp_matmul(M, 3584, 4096, n)
        assert fp.regime == "prefill" and fp.n_pad == n
        assert 0 < fp.smem_bytes <= 232448


def _x_slots(xc_group: torch.Tensor) -> torch.Tensor:
    """x's (M, n) codes of one group as the kernel's ring holds them: code
    word q (codes 4q .. 4q + 3) at word (q % 4) * n / 16 + q / 4."""
    M, n = xc_group.shape
    words = xc_group.reshape(M, n // 4, 4)
    slots = torch.empty_like(words)
    for q in range(n // 4):
        slots[:, (q % 4) * (n // 16) + q // 4] = words[:, q]
    return slots


def _int8_decode_emulation(x, w, fx, fw, n, plan):
    """``int8_decode_kernel``'s arithmetic: per split and group, each
    quarter t of a column group (quads 4j + t: rows 16j + 4t + b) dotted
    with x's words read from slots t * n/16 + j, the quarters' int sums
    joined exactly (lanes t, t^1, then t, t^2), the whole sum rescaled as
    ((float)P * sx) * sw; groups in order within a split, splits in
    order."""
    M, K = x.shape
    N = w.shape[1]
    xc, sx, _ = abfp_mod.abfp_quantize(x, fx, axis=-1, n=n,
                                       dtype=torch.float32)
    wc, sw, _ = abfp_mod.abfp_quantize(w, fw, axis=0, n=n,
                                       dtype=torch.float32)
    xc, wc = xc.to(torch.int64), wc.to(torch.int64)  # (M, G, n), (N, G, n)
    Q = n // 16
    y = torch.zeros((M, N))
    for lo, hi in t_mm.split_bounds(K // n, plan.splits):
        acc = torch.zeros((M, N))
        for g in range(lo, hi):
            slots = _x_slots(xc[:, g])                 # (M, n/4, 4)
            part = []
            for t in range(4):
                p = torch.zeros((M, N), dtype=torch.int64)
                for j in range(Q):
                    rows = [16 * j + 4 * t + b for b in range(4)]
                    wword = wc[:, g, rows]             # (N, 4): one column
                    xword = slots[:, t * Q + j]        # (M, 4): same k
                    p += xword @ wword.t()
                part.append(p)
            P = (part[0] + part[1]) + (part[2] + part[3])  # exact int32
            assert P.abs().max() < 2 ** 31
            acc = acc + ((P.to(torch.float32) * sx[:, g, None])
                         * sw[None, :, g])
        y = y + acc
    return y


@pytest.mark.parametrize("fx,fw", [("int8", "int4"), ("int8", "int8"),
                                   ("int4", "int4")])
@pytest.mark.parametrize("M,K,N,n", [(4, 1024, 40, 64), (16, 512, 130, 32),
                                     (3, 640, 77, 32), (1, 3584, 9, 64),
                                     (5, 192, 64, 64)])
def test_int8_decode_emulation_is_the_plain_function(fx, fw, M, K, N, n):
    """The emulated kernel against ``abfp_matmul_int8_plain`` and the
    reference oracle within 1e-5; a CPU tensor runs the plain version."""
    x = torch.from_numpy(_x(M * K + N, M, K))
    w = torch.from_numpy(_w(N + K, K, N))
    tx, tw = t_get_format(fx), t_get_format(fw)
    plan = t_mm.plan_abfp_matmul(M, N, K, n, int8=True)
    assert plan.regime == "decode" and 1 <= plan.splits <= K // n
    want = t_mm.abfp_matmul_int8_plain(x, w, tx, tw, n=n)
    got = _int8_decode_emulation(x, w, tx, tw, n, plan)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    oracle = jref.int8_matmul_ref(jnp.asarray(x.numpy()),
                                  jnp.asarray(w.numpy()), j_get_format(fx),
                                  j_get_format(fw), n=n)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)
    before = t_mm.abfp_matmul_int8.launches
    assert torch.equal(t_mm.abfp_matmul_int8(x, w, tx, tw, n=n), want)
    assert t_mm.abfp_matmul_int8.launches == before


@pytest.mark.parametrize("fx,fw", [("int8", "int4"), ("int8", "int8")])
@pytest.mark.parametrize("M,N,n", [(1, 64, 64), (7, 77, 64), (16, 130, 64),
                                   (4, 40, 32), (2, 503, 32)])
def test_int8_decode_one_group_is_bit_exact(fx, fw, M, N, n):
    """K = n: one group, one rescale, nothing to sum in another order: the
    emulated kernel, the plain version and the reference's oracle agree bit
    for bit.  The reference's Pallas kernel (interpret mode) agrees within
    1e-5: jitted, XLA turns its ``alpha / qmax`` into ``alpha * (1 /
    qmax)``, one ulp off the true division (ROADMAP, Queue C)."""
    x = _x(M + 31 * N, M, n)
    w = _w(3 * N + n, n, N)
    tx, tw = t_get_format(fx), t_get_format(fw)
    plan = t_mm.plan_abfp_matmul(M, N, n, n, int8=True)
    assert plan.regime == "decode" and plan.splits == 1
    got = _int8_decode_emulation(torch.from_numpy(x), torch.from_numpy(w),
                                 tx, tw, n, plan)
    want = t_mm.abfp_matmul_int8_plain(torch.from_numpy(x),
                                       torch.from_numpy(w), tx, tw, n=n)
    assert torch.equal(got, want)
    oracle = jref.int8_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                  j_get_format(fx), j_get_format(fw), n=n)
    assert np.array_equal(got.numpy(), np.asarray(oracle))
    kernel = j_mm.abfp_matmul_int8(jnp.asarray(x), jnp.asarray(w),
                                   j_get_format(fx), j_get_format(fw), n=n,
                                   block_m=M, block_n=N, block_k=n,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=1e-5,
                               atol=1e-5)
