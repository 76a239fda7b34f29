"""``quant_matmul`` at decode (M <= 16): the plans of ``quant_decode_kernel``
and of ``contract_kernel`` (up to 4 rows of a wide layer) and an emulation
of each kernel's arithmetic, against the plain version and the reference
package (its Pallas ``quant_matmul`` in interpret mode) on the same numpy
inputs.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain version there).  What it computes is pinned here step by step: x's
codes and scales made per (row, group) as ``quantize_rows_kernel`` makes
them, written in the order the contraction reads them (packed: for each
weight word, the x codes of its low nibbles, then of its high nibbles);
each group's weight bytes read by its column's thread 16 bytes at a time
and contracted by __dp4a; packed nibbles moved to the top of their bytes
(16 x the signed code); the exact integer sum carried over the group and
shifted back by 4; the group sum rescaled as ``((float)P * sx) * sw`` in
f32, groups added in order within a K split, the split partials in split
order.  ``contract_kernel`` (up to 4 rows of a wide layer) is emulated
lane by lane: a group's exact sum over its lanes, the fold on each lane,
the lanes' sums added by a butterfly.

Tolerances: rtol = atol = 1e-5 against the plain version and the reference
(same codes, same exact integer group sums; only the f32 sum over groups
runs in another order), and bit-equal to the plain version where K = n
(one group: one rescale, no sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import get_format as j_get_format
from repro.kernels import ops as jkops
from repro.kernels.quant_matmul import quant_matmul as j_quant_matmul
from repro_torch.core import abfp as abfp_mod
from repro_torch.core.formats import get_format as t_get_format
from repro_torch.core.quantize import pack_int4_codes
from repro_torch.kernels import quant_matmul as t_mm

INT8 = t_get_format("int8")

# (name, K, N) of qwen2-7b's dense layers and lm_head, the plan of the
# one-launch decode kernel at M = 4, packed, n = 64: (tiles, groups,
# splits), and the kernel quant_matmul takes there
MAIN_SHAPES = [("wo", 18944, 3584, 14, 296, 8, "decode"),
               ("q,o", 3584, 3584, 14, 56, 8, "decode"),
               ("k,v", 3584, 512, 2, 56, 8, "decode"),
               ("wi,wg", 3584, 18944, 74, 56, 8, "contract"),
               ("lm_head", 3584, 152064, 594, 56, 2, "contract")]


def _x(seed, M, K):
    """Activation-like values: normal, a few outlier columns, a zero row
    (its groups take the 1e-12 scale floor)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K) * (1 + 7 * (rng.rand(1, K) > 0.9))
    if M > 1:
        x[1] = 0.0
    return x.astype(np.float32)


def _stored(seed, N, G, n, packed):
    """Stored weight codes (N, G, n) int8 in the format's range and f32
    unit scales (N, G)."""
    rng = np.random.RandomState(seed)
    lo, hi = (-8, 8) if packed else (-128, 128)
    codes = rng.randint(lo, hi, size=(N, G, n)).astype(np.int8)
    scales = (rng.rand(N, G) * 0.02 + 1e-3).astype(np.float32)
    return codes, scales


# --------------------------------------------------------------------------
# the plan
# --------------------------------------------------------------------------
def _check_plan(plan, M, N, K_pad, n_pad, packed):
    """What every decode plan must satisfy: the output covered by
    256-column tiles, K cut into whole groups (every split at least one),
    about 6 x 132 blocks where K has groups enough (at most 8 splits), x's
    codes of the longest split and the ring within a block's shared
    memory."""
    G = K_pad // n_pad
    B = n_pad // 2 if packed else n_pad
    assert plan.block_rows == (4 if M <= 4 else 8 if M <= 8 else 16)
    assert plan.tiles == -(-N // 256)
    assert 1 <= plan.splits <= max(G, 1)
    bounds = t_mm.split_bounds(G, plan.splits)
    assert bounds[0][0] == 0 and bounds[-1][1] == G
    assert all(hi - lo >= 1 for lo, hi in bounds) or G == 0
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    aim = max(1, min(G, t_mm.QD_SPLITS_MAX,
                     -(-t_mm.QD_BLOCKS // plan.tiles)))
    assert plan.splits >= aim  # more only where x's codes would not fit
    assert plan.t_max == max(1, max(hi - lo for lo, hi in bounds))
    assert plan.smem_bytes == t_mm.qd_smem_bytes(B, plan.block_rows, n_pad,
                                                 plan.t_max)
    assert 0 < plan.smem_bytes <= 232448


@pytest.mark.parametrize("name,K,N,tiles,G,splits,kernel", MAIN_SHAPES)
def test_plan_at_the_main_path_shapes(name, K, N, tiles, G, splits, kernel):
    """At M = 4 with packed groups of 64: the one-launch plan has
    256-column tiles and splits for about 6 x 132 blocks but at most 8;
    quant_matmul takes it on the narrow layers and contract_kernel (one
    block per 32 columns, no split) on wi,wg and lm_head."""
    decode = t_mm.plan_quant_decode(4, N, K, 64, True)
    assert (decode.tiles, K // 64, decode.splits) == (tiles, G, splits)
    assert decode.splits == min(8, -(-6 * t_mm.SMS // tiles))
    _check_plan(decode, 4, N, K, 64, True)
    plan = t_mm.quant_matmul_plan(4, N, K, 64, True)
    if kernel == "decode":
        assert plan == decode
    else:
        assert plan == t_mm.ContractPlan(4, N // 32, 1)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("M", [1, 3, 4, 5, 8, 16])
@pytest.mark.parametrize("K,N,n", [(3584, 3584, 64), (18944, 3584, 64),
                                   (3584, 512, 32), (640, 77, 64),
                                   (64, 503, 64), (512, 64, 64),
                                   (3840, 130, 40), (96, 130, 32),
                                   (3584, 130, 512), (7 * 16, 130, 16)])
def test_plan_at_every_row_count_and_ragged_shapes(K, N, n, M, packed):
    """Every plan of the decode set, at ragged N and K, short and long
    groups, in either code layout."""
    n_pad = t_mm.pad_group(n, packed)
    lanes = n_pad // (32 if packed else 16)
    plan = t_mm.quant_matmul_plan(M, N, K, n, packed)
    if lanes & (lanes - 1) or lanes > 32:
        assert isinstance(plan, t_mm.MmaPlan)
        return
    assert isinstance(plan, t_mm.QuantDecodePlan)
    _check_plan(plan, M, N, K // n * n_pad, n_pad, packed)


@pytest.mark.parametrize("n,packed", [(512, False), (1024, True),
                                      (512, True), (256, False)])
@pytest.mark.parametrize("M", [1, 8, 16])
def test_long_groups_fit_the_same_ring(n, packed, M):
    """The longest groups the decode kernel takes (512 bytes of a column)
    stream through the same 128-byte slices; x's codes of a split fit."""
    plan = t_mm.quant_matmul_plan(M, 3584, 4 * n, n, packed)
    assert isinstance(plan, t_mm.QuantDecodePlan)
    _check_plan(plan, M, 3584, 4 * n, n, packed)


def test_long_splits_are_cut_to_fit():
    """Where x's codes of a split would overflow a block (one tile row of
    lm_head-wide N at K = 18944, 16 rows), the plan adds splits until
    they fit."""
    G = 18944 // 64
    plan = t_mm.quant_matmul_plan(16, 152064, 18944, 64, True)
    assert plan.splits > -(-t_mm.QD_BLOCKS // plan.tiles)
    _check_plan(plan, 16, 152064, 18944, 64, True)
    fewer = -(-G // (plan.splits - 1))
    assert t_mm.qd_smem_bytes(32, 16, 64, fewer) > 232448


def test_stage_rows_are_odd_multiples_of_16_bytes():
    """A stage row (a column's 128-byte slice) is 144 bytes, nine 16-byte
    units, so the eight columns of a 16-byte load phase fall on distinct
    banks; a stage holds the scales of every group a slice can hold."""
    for B in (16, 32, 64, 128, 256, 512):
        groups = max(1, 128 // B)
        assert t_mm.qd_stage_bytes(B) == 256 * (144 + 4 * groups)
    assert (144 // 16) % 2 == 1


@pytest.mark.parametrize("M,rows", [(1, 4), (4, 4), (5, 8), (8, 8), (9, 16),
                                    (16, 16)])
def test_rows_pick_the_contraction(M, rows):
    """The rows a block holds (the __dp4a contraction's BM): 4, 8 or 16,
    the least that covers M, on wide and on single-tile layers."""
    plan = t_mm.quant_matmul_plan(M, 3584, 3584, 64, True)
    assert plan.block_rows == rows
    one = t_mm.quant_matmul_plan(M, 200, 3584, 64, True)
    assert one.tiles == 1 and one.block_rows == rows


@pytest.mark.parametrize("M,N,n,packed,kernel", [
    (4, 18944, 64, True, "contract"), (1, 152064, 64, True, "contract"),
    (4, 16896, 64, True, "contract"), (4, 16895, 64, True, "decode"),
    (5, 18944, 64, True, "decode"), (16, 152064, 64, True, "decode"),
    (4, 18944, 512, False, "contract"), (4, 18944, 40, True, "contract"),
    (4, 18944, 96, True, "mma"), (17, 18944, 64, True, "mma")])
def test_wide_layers_up_to_4_rows_take_contract_kernel(M, N, n, packed,
                                                       kernel):
    """Up to 4 rows at N >= 4 x 132 x 32 (every SM gets 4 blocks of 32
    columns with no K split), for the group lengths the decode kernels
    take, quant_matmul quantizes x in a first launch and runs
    contract_kernel; 5 to 16 rows and narrower layers take the one-launch
    kernel, other group lengths and more rows the tensor cores."""
    plan = t_mm.quant_matmul_plan(M, N, 3584 // n * n, n, packed)
    want = {"contract": t_mm.ContractPlan, "decode": t_mm.QuantDecodePlan,
            "mma": t_mm.MmaPlan}[kernel]
    assert isinstance(plan, want)
    if kernel == "contract":
        assert plan == t_mm.ContractPlan(4, -(-N // 32), 1)


# --------------------------------------------------------------------------
# the kernels' arithmetic
# --------------------------------------------------------------------------
def _x_slot(i: int) -> int:
    """``qd_x_slot``: the byte of x's packed code row holding code i."""
    return (i & ~7) | ((i & 1) << 2) | ((i >> 1) & 3)


def _kernel_x_codes(x: torch.Tensor, n: int, n_pad: int, qmax: float,
                    qmin: float):
    """x's codes and scales as the kernel makes them, one (row, group) at a
    time: max |x| over the group, rounded to bf16, floored at 1e-12,
    divided by qmax; each code rintf(x / s) clipped to [qmin, qmax]; the
    pad codes n .. n_pad zero."""
    M, K = x.shape
    G = K // n
    codes = torch.zeros((M, G, n_pad), dtype=torch.int64)
    scales = torch.empty((M, G), dtype=torch.float32)
    for m in range(M):
        for g in range(G):
            v = x[m, g * n:(g + 1) * n]
            alpha = v.abs().max().to(torch.bfloat16).to(torch.float32)
            s = torch.clamp(alpha, min=1e-12) / torch.tensor(
                qmax, dtype=torch.float32)
            codes[m, g, :n] = torch.clamp(torch.round(v / s), qmin,
                                          qmax).to(torch.int64)
            scales[m, g] = s
    return codes, scales


def _le_words(b: np.ndarray) -> np.ndarray:
    """(..., 4k) bytes -> (..., k) little-endian 32-bit words."""
    return np.ascontiguousarray(b.astype(np.uint8)).view(np.uint32)


def _dp4a(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The sum of the four int8 products of two 32-bit words."""
    av = np.ascontiguousarray(a)[..., None].view(np.int8).astype(np.int64)
    bv = np.ascontiguousarray(b)[..., None].view(np.int8).astype(np.int64)
    return (av.reshape(*a.shape, 4) * bv.reshape(*b.shape, 4)).sum(-1)


def _group_sums(xrow_bytes, wbytes, packed):
    """Exact group sums P (M, N) of one group: x's code row (M, n_pad) in
    the kernel's byte order, the weight's B bytes (N, B) as stored.  A
    column's thread reads them 16 bytes at a time; packed: each weight word
    split into lo = (w << 4) & 0xF0F0F0F0 and hi = w & 0xF0F0F0F0 against
    x words 2i and 2i + 1 of the piece's 32 x bytes; the int sum carried
    over the pieces and, packed, shifted back by 4."""
    M = xrow_bytes.shape[0]
    N, B = wbytes.shape
    XP = 32 if packed else 16
    P = np.zeros((M, N), dtype=np.int64)
    for r in range(B // 16):
        w = _le_words(wbytes[:, 16 * r:16 * r + 16])           # (N, 4)
        xw = _le_words(xrow_bytes[:, XP * r:XP * r + XP])      # (M, XP/4)
        for i in range(4):
            if packed:
                lo = (w[:, i] << np.uint32(4)) & np.uint32(0xF0F0F0F0)
                hi = w[:, i] & np.uint32(0xF0F0F0F0)
                P += _dp4a(lo[None, :], xw[:, None, 2 * i])
                P += _dp4a(hi[None, :], xw[:, None, 2 * i + 1])
            else:
                P += _dp4a(w[None, :, i], xw[:, None, i])
    assert np.abs(P).max() < 2 ** 31
    if packed:
        assert not (P % 16).any()
        P = P >> 4
    return P


def _quant_decode_emulation(x, stored, scales, n, packed, plan):
    """``quant_decode_kernel``'s arithmetic on x (M, K) f32, the stored
    weight codes (as the wrapper hands them over: zero-padded per group to
    n_pad; packed bytes) and scales (N, G)."""
    M, K = x.shape
    G = K // n
    n_pad = t_mm.pad_group(n, packed)
    wb = t_mm.pad_group_codes(stored, n, packed).numpy().view(np.uint8)
    xc, sx = _kernel_x_codes(x, n, n_pad, INT8.qmax_pos, INT8.qmin)
    order = [_x_slot(i) if packed else i for i in range(n_pad)]
    xrow = np.zeros((M, G, n_pad), dtype=np.int8)
    xrow[:, :, order] = xc.numpy().astype(np.int8)
    partials = []
    for lo, hi in t_mm.split_bounds(G, plan.splits):
        acc = torch.zeros((M, scales.shape[0]))
        for g in range(lo, hi):
            P = torch.from_numpy(
                _group_sums(xrow[:, g].view(np.uint8), wb[:, g], packed))
            acc = acc + ((P.to(torch.float32) * sx[:, g, None])
                         * scales[None, :, g])
        partials.append(acc)
    y = partials[0]
    for p in partials[1:]:
        y = y + p
    return y


def _reference(x, codes, scales, n):
    M, K = x.shape
    N = codes.shape[0]
    return np.asarray(j_quant_matmul(
        jnp.asarray(x), jnp.asarray(codes), jnp.asarray(scales),
        j_get_format("int8"), n=n, block_m=jkops.fit_block(M),
        block_n=jkops.fit_block(N), block_k=K, interpret=True))


EMULATED = [(4, 512, 40, 64), (1, 256, 9, 64), (3, 320, 77, 32),
            (5, 256, 24, 64), (16, 128, 64, 64), (2, 1024, 17, 512)]


@pytest.mark.parametrize("packed,M,K,N,n", [
    *((True, *c) for c in EMULATED), *((False, *c) for c in EMULATED),
    (True, 8, 240, 24, 40), (False, 8, 240, 24, 24), (False, 4, 96, 33, 16),
    (False, 6, 60, 20, 5)])
def test_emulation_is_the_plain_function(packed, M, K, N, n):
    """The emulated kernel against ``quant_matmul_plain`` and the
    reference's Pallas kernel (interpret mode) within 1e-5; a CPU tensor
    runs the plain version and counts no launch."""
    G = K // n
    x = _x(M * K + N + n, M, K)
    c, s = _stored(N + G + int(packed), N, G, n, packed)
    codes, scales = torch.from_numpy(c), torch.from_numpy(s)
    stored = pack_int4_codes(codes) if packed else codes
    plan = t_mm.quant_matmul_plan(M, N, K, n, packed)
    assert isinstance(plan, t_mm.QuantDecodePlan)
    xt = torch.from_numpy(x)
    got = _quant_decode_emulation(xt, stored, scales, n, packed, plan)
    want = t_mm.quant_matmul_plain(xt, stored, scales, INT8, n=n,
                                   packed=packed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _reference(x, c, s, n),
                               rtol=1e-5, atol=1e-5)
    before = t_mm.quant_matmul.launches
    assert torch.equal(t_mm.quant_matmul(xt, stored, scales, INT8, n=n,
                                         packed=packed), want)
    assert t_mm.quant_matmul.launches == before


@pytest.mark.parametrize("packed,M,N,n", [
    (True, 1, 64, 64), (True, 7, 77, 64), (True, 16, 130, 32),
    (True, 4, 503, 40), (True, 2, 33, 512), (False, 1, 64, 64),
    (False, 7, 77, 64), (False, 16, 130, 32), (False, 4, 503, 24),
    (False, 2, 33, 512)])
def test_one_group_is_bit_exact(packed, M, N, n):
    """K = n: one group, one rescale, nothing summed in another order: the
    emulated kernel and the plain version agree bit for bit, and the
    reference within 1e-5."""
    x = _x(M + 31 * N + n, M, n)
    c, s = _stored(3 * N + n, N, 1, n, packed)
    codes, scales = torch.from_numpy(c), torch.from_numpy(s)
    stored = pack_int4_codes(codes) if packed else codes
    plan = t_mm.quant_matmul_plan(M, N, n, n, packed)
    assert isinstance(plan, t_mm.QuantDecodePlan) and plan.splits == 1
    xt = torch.from_numpy(x)
    got = _quant_decode_emulation(xt, stored, scales, n, packed, plan)
    want = t_mm.quant_matmul_plain(xt, stored, scales, INT8, n=n,
                                   packed=packed)
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), _reference(x, c, s, n),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("packed", [True, False])
def test_one_group_splits_sum_in_split_order(packed):
    """K = 8 groups on one 64-column tile: every split is one group, so the
    emulation's sum over splits is the plain sum over groups in order, and
    they agree within 1e-5."""
    M, N, n = 4, 64, 64
    K = 8 * n
    plan = t_mm.quant_matmul_plan(M, N, K, n, packed)
    assert plan.splits == K // n and plan.t_max == 1
    x = _x(11, M, K)
    c, s = _stored(12, N, K // n, n, packed)
    codes, scales = torch.from_numpy(c), torch.from_numpy(s)
    stored = pack_int4_codes(codes) if packed else codes
    xt = torch.from_numpy(x)
    got = _quant_decode_emulation(xt, stored, scales, n, packed, plan)
    want = t_mm.quant_matmul_plain(xt, stored, scales, INT8, n=n,
                                   packed=packed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def _contract_emulation(x, stored, scales, n, packed):
    """``contract_kernel``'s arithmetic (one warp's columns): x's codes as
    ``quantize_rows_kernel`` writes them, (M, G, n_pad); per step of 32
    lanes x CPL codes (packed 32, int8 16) a lane's exact int sum over its
    codes, summed over the lpg = n_pad / CPL lanes of its group (shuffles,
    exact), folded on every lane as ``((float)P * sx) * sw`` into that
    lane's f32 sum; at the end the group leaders' sums (the other lanes
    give 0) added by a butterfly over 32 lanes (xor 16, 8, 4, 2, 1)."""
    M, K = x.shape
    G = K // n
    n_pad = t_mm.pad_group(n, packed)
    wk = t_mm.pad_group_codes(stored, n, packed)
    if packed:
        from repro_torch.core.quantize import unpack_int4_codes
        wk = unpack_int4_codes(wk)
    wk = wk.to(torch.int64).reshape(wk.shape[0], G * n_pad)
    xc, sx = _kernel_x_codes(x, n, n_pad, INT8.qmax_pos, INT8.qmin)
    xc = xc.reshape(M, G * n_pad)
    cpl = 32 if packed else 16
    lpg = n_pad // cpl
    N = wk.shape[0]
    acc = torch.zeros((32, M, N), dtype=torch.float32)
    for k0 in range(0, G * n_pad, 32 * cpl):
        for lane in range(0, 32, lpg):  # group leaders
            k = k0 + lane * cpl
            if k >= G * n_pad:
                break
            g = k // n_pad
            P = xc[:, k:k + n_pad] @ wk[:, k:k + n_pad].t()  # exact
            assert P.abs().max() < 2 ** 31
            acc[lane] = acc[lane] + ((P.to(torch.float32) * sx[:, g, None])
                                     * scales[None, :, g])
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[[lane ^ o for lane in range(32)]]
    return acc[0]


@pytest.mark.parametrize("packed,M,K,N,n", [
    (True, 4, 3584, 8, 64), (True, 1, 512, 9, 32), (True, 3, 2048, 7, 1024),
    (True, 4, 640, 5, 40), (False, 4, 3584, 8, 64), (False, 2, 480, 6, 16),
    (False, 4, 2048, 5, 512), (False, 4, 240, 7, 24)])
def test_contract_emulation_is_the_plain_function(packed, M, K, N, n):
    """The emulated contract_kernel against ``quant_matmul_plain`` and the
    reference's Pallas kernel (interpret mode) within 1e-5, at K = 3.5
    steps of a warp (lanes idle in the last), one group a step, one group
    a lane and padded groups."""
    G = K // n
    x = _x(7 * M + K + n, M, K)
    c, s = _stored(5 * N + G + int(packed), N, G, n, packed)
    codes, scales = torch.from_numpy(c), torch.from_numpy(s)
    stored = pack_int4_codes(codes) if packed else codes
    xt = torch.from_numpy(x)
    got = _contract_emulation(xt, stored, scales, n, packed)
    want = t_mm.quant_matmul_plain(xt, stored, scales, INT8, n=n,
                                   packed=packed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _reference(x, c, s, n),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("packed,n", [(True, 64), (True, 40), (False, 64),
                                      (False, 16)])
def test_contract_one_group_is_bit_exact(packed, n):
    """K = n: one group, folded once by its leader lane; the butterfly adds
    exact zeros, so the emulated contract_kernel is the plain version bit
    for bit."""
    M, N = 4, 33
    x = _x(n + 5, M, n)
    c, s = _stored(n + 6, N, 1, n, packed)
    codes, scales = torch.from_numpy(c), torch.from_numpy(s)
    stored = pack_int4_codes(codes) if packed else codes
    xt = torch.from_numpy(x)
    got = _contract_emulation(xt, stored, scales, n, packed)
    assert torch.equal(got, t_mm.quant_matmul_plain(
        xt, stored, scales, INT8, n=n, packed=packed))


@pytest.mark.parametrize("n,n_pad", [(64, 64), (32, 32), (40, 64), (5, 16),
                                     (512, 512)])
def test_x_codes_are_abfp_quantize_codes(n, n_pad):
    """x's codes and scales made as the kernel makes them are bit for bit
    ``abfp_quantize``'s (the plain version's), with zero pad codes."""
    M, G = 5, 3
    x = torch.from_numpy(_x(n + 7, M, G * n))
    got, sx = _kernel_x_codes(x, n, n_pad, INT8.qmax_pos, INT8.qmin)
    want, ws, _ = abfp_mod.abfp_quantize(x, INT8, axis=-1, n=n,
                                         dtype=torch.float32)
    assert torch.equal(got[..., :n], want.to(torch.int64))
    assert not got[..., n:].any()
    assert torch.equal(sx, ws.reshape(M, G))


def test_packed_x_order_meets_each_weight_nibble():
    """For every 32-bit weight word of a packed group, x words 2i and 2i +
    1 of the kernel's x row hold the x codes of the word's low and high
    nibbles, in byte order: code 8q + 2b + h at byte 8q + 4h + b."""
    n_pad = 64
    slots = [_x_slot(i) for i in range(n_pad)]
    assert sorted(slots) == list(range(n_pad))
    for q in range(n_pad // 8):
        for h in range(2):
            for b in range(4):
                assert slots[8 * q + 2 * b + h] == 8 * q + 4 * h + b


def test_cpu_tensor_runs_the_plain_version():
    """A CPU tensor takes the plain version at decode and counts no
    launch."""
    x = torch.from_numpy(_x(3, 4, 256))
    c, s = _stored(4, 24, 4, 64, True)
    stored = pack_int4_codes(torch.from_numpy(c))
    before = t_mm.quant_matmul.launches
    got = t_mm.quant_matmul(x, stored, torch.from_numpy(s), INT8, n=64,
                            packed=True)
    assert t_mm.quant_matmul.launches == before
    assert torch.equal(got, t_mm.quant_matmul_plain(
        x, stored, torch.from_numpy(s), INT8, n=64, packed=True))
