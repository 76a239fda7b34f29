"""The int8 tensor-core contraction (``mma_contract_kernel`` on int8 and
packed codes): its plan, its routing, and an emulation of its arithmetic
against the plain versions and the reference package on the same numpy
inputs.

The kernel runs only on the card (``chip_smoke.py`` holds it against the
plain versions there).  What it computes is pinned here step by step: a
group's codes staged in chunks of at most 128, contracted in K steps of 32
codes (and one of 16 where a chunk has 16 left over) into an exact integer
sum that carries across the chunks of a group; packed weight bytes
expanded on chip into 16 x each signed code in element order, so the sum
is 16 P and is shifted back by 4; the group sum rescaled as
``((float)P * sx) * sw`` in f32 and added to the output's sum, groups in
order within a K split, the split partials in split order.

Tolerances: rtol = atol = 1e-5 against the plain versions and the
reference (same codes, same exact integer group sums; only the f32 sum
over groups runs in another order), and bit-equal where K = n (one group:
one rescale, no sum).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.formats import get_format as j_get_format
from repro.kernels import ops as jkops
from repro.kernels import ref as jref
from repro.kernels.quant_matmul import quant_matmul as j_quant_matmul
from repro_torch.core import abfp as abfp_mod
from repro_torch.core.formats import get_format as t_get_format
from repro_torch.core.quantize import pack_int4_codes
from repro_torch.kernels import quant_matmul as t_mm

INT8 = t_get_format("int8")

# (K, N) of qwen2-7b's dense layers
LAYERS = {"q,o": (3584, 3584), "k,v": (3584, 512), "wi,wg": (3584, 18944),
          "wo": (18944, 3584)}


def _smem_bytes(bm, chunk, packed):
    """4 ring stages: x codes, weight codes or packed bytes, scales."""
    row = t_mm.mma_row_bytes
    stage = (bm * row(chunk) + 128 * row(chunk // 2 if packed else chunk)
             + 4 * (bm + 128))
    return 4 * stage


def _check_plan(plan, M, N, K, n, packed):
    """What every plan must satisfy: whole output covered, K cut into whole
    groups, a full wave of blocks where K has groups enough, a ring that
    fits in one block's shared memory."""
    G = K // n
    bm = plan.block_rows
    assert bm == t_mm.MMA_BM == 64
    assert plan.grid == (-(-N // 128), -(-M // bm), plan.splits)
    assert plan.tiles == plan.grid[0] * plan.grid[1]
    assert 1 <= plan.splits <= max(G, 1)
    # a full wave of blocks on the SMs where K has groups enough
    assert plan.tiles * plan.splits >= t_mm.SMS or plan.splits == max(G, 1)
    if plan.tiles >= t_mm.SMS:
        assert plan.splits == 1
    if plan.splits > 1:  # the fewest splits that fill the wave
        assert plan.tiles * (plan.splits - 1) < t_mm.SMS
    bounds = t_mm.split_bounds(G, plan.splits)
    assert sum(hi - lo for lo, hi in bounds) == G
    assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))
    assert n % plan.chunk == 0 and plan.chunk <= 128
    assert plan.chunk % (32 if packed else 16) == 0
    assert plan.smem_bytes == _smem_bytes(bm, plan.chunk, packed)
    assert plan.smem_bytes <= 232448


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("M", [64, 128, 192, 256])
@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_plan_at_the_main_path_shapes(layer, M, packed):
    K, N = LAYERS[layer]
    plan = t_mm.plan_int8_contract(M, N, K, 64, packed)
    _check_plan(plan, M, N, K, 64, packed)
    assert plan.chunk == 64
    assert (plan.splits > 1) == (plan.tiles < t_mm.SMS)


def test_plan_grids_of_the_prefill_chunk_and_bucket():
    """The paged prefill chunk (M = 256, packed int4) and the fixed-slot
    engine's longest prefill bucket (M = 192, int8 codes)."""
    got = {(M, layer): (p.block_rows, p.grid, p.smem_bytes)
           for M, packed in ((256, True), (192, False))
           for layer, (K, N) in LAYERS.items()
           for p in [t_mm.plan_int8_contract(M, N, K, 64, packed)]}
    assert got == {
        (256, "q,o"): (64, (28, 4, 2), 48128),
        (256, "k,v"): (64, (4, 4, 9), 48128),
        (256, "wi,wg"): (64, (148, 4, 1), 48128),
        (256, "wo"): (64, (28, 4, 2), 48128),
        (192, "q,o"): (64, (28, 3, 2), 64512),
        (192, "k,v"): (64, (4, 3, 11), 64512),
        (192, "wi,wg"): (64, (148, 3, 1), 64512),
        (192, "wo"): (64, (28, 3, 2), 64512),
    }


@pytest.mark.parametrize("M,K,N,n,packed", [
    (17, 640, 77, 32, False), (33, 96, 130, 48, False), (1, 64, 5, 64, True),
    (300, 1024, 1000, 128, True), (129, 4096, 17, 256, False),
    (64, 0, 64, 64, False), (16, 3584, 512, 48, False),
    (4, 3584, 18944, 96, True), (250, 18944, 3584, 64, True)])
def test_plan_at_ragged_shapes(M, K, N, n, packed):
    _check_plan(t_mm.plan_int8_contract(M, N, K, n, packed), M, N, K, n,
                packed)


@pytest.mark.parametrize("n,packed,chunk", [
    (16, False, 16), (32, False, 32), (48, False, 48), (64, True, 64),
    (80, False, 80), (96, True, 96), (128, False, 128), (160, False, 80),
    (160, True, 32), (176, False, 16), (256, True, 128), (384, False, 128),
    (512, True, 128), (1024, False, 128)])
def test_plan_chunks_whole_groups(n, packed, chunk):
    """A stage holds one group up to 128 codes, else the largest multiple
    of 16 (packed: 32) up to 128 that divides the group."""
    plan = t_mm.plan_int8_contract(256, 3584, 8 * n, n, packed)
    assert plan.chunk == t_mm.mma_chunk(n, packed) == chunk
    _check_plan(plan, 256, 3584, 8 * n, n, packed)


@pytest.mark.parametrize("n,packed", [(8, False), (40, False), (24, False),
                                      (16, True), (48, True), (0, False)])
def test_plan_refuses_other_group_lengths(n, packed):
    with pytest.raises(ValueError, match="multiple of"):
        t_mm.plan_int8_contract(64, 128, 4 * max(n, 1), n, packed)


@pytest.mark.parametrize("M,n,packed,kernel", [
    (1, 64, True, "decode"), (4, 32, True, "decode"),
    (16, 64, False, "decode"), (16, 512, False, "decode"),
    (17, 64, True, "mma"), (256, 64, True, "mma"), (64, 32, False, "mma"),
    (4, 48, False, "mma"), (16, 96, True, "mma"), (4, 80, False, "mma"),
    (2, 1024, False, "mma"), (4, 2048, True, "mma")])
def test_quant_matmul_routing(M, n, packed, kernel):
    """quant_decode_kernel up to 16 rows for the group lengths it is built
    for; mma_contract_kernel above 16 rows, and for every other multiple of
    16 (packed: 32) at any M."""
    plan = t_mm.quant_matmul_plan(M, 3584, 4 * n, n, packed)
    if kernel == "decode":
        assert plan == t_mm.plan_quant_decode(M, 3584, 4 * n, n, packed)
    else:
        assert plan == t_mm.plan_int8_contract(M, 3584, 4 * n, n, packed)


@pytest.mark.parametrize("M,n,regime", [
    (4, 64, "decode"), (16, 32, "decode"), (17, 64, "prefill"),
    (192, 64, "prefill"), (4, 48, "prefill"), (192, 48, "prefill"),
    (1, 16, "prefill"), (8, 256, "prefill")])
def test_abfp_int8_routing(M, n, regime):
    """abfp_matmul_int8: the decode kernel up to 16 rows for n = 32 or 64,
    otherwise the prefill regime on mma_contract_kernel's grid."""
    plan = t_mm.plan_abfp_matmul(M, 3584, 8 * n, n, int8=True)
    assert plan.regime == regime
    if regime == "prefill":
        mma = t_mm.plan_int8_contract(M, 3584, 8 * n, n)
        assert (plan.block_rows, plan.tiles, plan.splits,
                plan.smem_bytes) == (mma.block_rows, mma.tiles, mma.splits,
                                     mma.smem_bytes)


@pytest.mark.parametrize("n", [40, 8])
def test_abfp_int8_pads_group_lengths_off_the_16_grid(n):
    """A group length off the 16 grid takes the prefill regime on the
    contraction's plan at the padded length (40 -> 48, 8 -> 16)."""
    plan = t_mm.plan_abfp_matmul(32, 64, 4 * n, n, int8=True)
    n_pad = t_mm.pad_group(n)
    assert n_pad == -(-n // 16) * 16 and plan.n_pad == n_pad
    mma = t_mm.plan_int8_contract(32, 64, 4 * n_pad, n_pad)
    assert plan.regime == "prefill"
    assert (plan.block_rows, plan.tiles, plan.splits, plan.smem_bytes) == (
        mma.block_rows, mma.tiles, mma.splits, mma.smem_bytes)


def test_misaligned_codes_are_refused():
    buf = torch.zeros(64, dtype=torch.int8)
    t_mm._check_aligned("quant_matmul", w_codes=buf)
    with pytest.raises(ValueError, match="16-byte boundary"):
        t_mm._check_aligned("quant_matmul", w_codes=buf[1:])


def _nibbles_x16(v: np.ndarray) -> np.ndarray:
    """The kernel's expansion of a 16-bit word of two packed bytes
    (elements 2i .. 2i + 3) into one 32-bit word: u = __byte_perm(v, 0,
    0x1100) (bytes v0 v0 v1 v1), then ((u << 4) & 0x00F000F0) |
    (u & 0xF000F000)."""
    v = v.astype(np.uint64)
    b0, b1 = v & 0xFF, (v >> 8) & 0xFF
    u = b0 | (b0 << 8) | (b1 << 16) | (b1 << 24)
    return (((u << 4) & 0x00F000F0) | (u & 0xF000F000)).astype(np.uint32)


def test_unpacking_gives_16x_the_codes_in_element_order():
    """All 65,536 pairs of packed bytes: the four bytes of the expanded
    word, read as int8, are 16 x elements 2i .. 2i + 3 as the package's own
    packing stores them."""
    v = np.arange(1 << 16, dtype=np.uint32)
    got = _nibbles_x16(v).view(np.int8).reshape(-1, 4).astype(np.int32)
    pairs = torch.from_numpy(v.astype(np.uint16).view(np.uint8)
                             .reshape(-1, 2).astype(np.int32))
    codes = torch.stack([pairs & 0xF, pairs >> 4], -1).reshape(-1, 4)
    codes = torch.where(codes >= 8, codes - 16, codes)
    np.testing.assert_array_equal(got, 16 * codes.numpy())
    repacked = pack_int4_codes(codes.to(torch.int8))
    assert torch.equal(repacked, pairs.to(torch.uint8))


def _expand_packed(packed: torch.Tensor) -> torch.Tensor:
    """(N, K/2) packed bytes -> (N, K) int64, 16 x each code, as a warp
    builds its weight fragments: two bytes (four codes) a 32-bit word."""
    N, half = packed.shape
    words = packed.numpy().reshape(N, half // 2, 2).copy().view(np.uint16)
    x16 = _nibbles_x16(words[..., 0]).view(np.int8)
    return torch.from_numpy(x16.reshape(N, 2 * half).astype(np.int64))


def _mma_emulation(xc, sx, wk, sw, n, plan, packed):
    """``mma_contract_kernel``'s arithmetic on int8 codes.  xc (M, K) and wk (N, K) integer
    codes in the kernel's K order (wk 16 x the codes when ``packed``), sx
    (M, G), sw (N, G).  Per split, per group, per chunk of ``plan.chunk``
    codes: K steps of 32 (a last step of 16 where the chunk leaves one)
    into an exact integer sum carried over the group's chunks; the sum
    (packed: 16 P, shifted back by 4) rescaled as ((float)P * sx) * sw and
    added to the split's sum;
    splits added in split order."""
    M, K = xc.shape
    N = wk.shape[0]
    C = plan.chunk
    xc, wk = xc.to(torch.int64), wk.to(torch.int64)
    partials = []
    for lo, hi in t_mm.split_bounds(K // n, plan.splits):
        acc = torch.zeros((M, N))
        for g in range(lo, hi):
            P = torch.zeros((M, N), dtype=torch.int64)
            for k0 in range(g * n, (g + 1) * n, C):
                steps = [(k, 32) for k in range(0, C - 31, 32)]
                if C % 32:
                    steps.append((C - 16, 16))
                for k, width in steps:
                    a = xc[:, k0 + k:k0 + k + width]
                    b = wk[:, k0 + k:k0 + k + width]
                    P += a @ b.t()
            assert P.abs().max() < 2 ** 31  # the int32 accumulator
            if packed:  # the sum of 16 x the codes: exactly 16 P
                assert bool((P % 16 == 0).all())
                P = P >> 4
            acc = acc + ((P.to(torch.float32) * sx[:, g, None])
                         * sw[None, :, g])
        partials.append(acc)
    y = partials[0]
    for p in partials[1:]:
        y = y + p
    return y


def _x(seed, M, K):
    """Activation-like values: normal, a few outlier columns, a zero row
    (its groups take the 1e-12 scale floor)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K) * (1 + 7 * (rng.rand(1, K) > 0.9))
    if M > 1:
        x[1] = 0.0
    return x.astype(np.float32)


def _stored(seed, N, G, n, packed):
    """Stored weight codes (N, G, n) over the format's whole range (int4:
    -8 .. 7) and f32 unit scales (N, G)."""
    rng = np.random.RandomState(seed)
    lo, hi = (-8, 8) if packed else (-128, 128)
    codes = rng.randint(lo, hi, size=(N, G, n)).astype(np.int8)
    scales = (rng.rand(N, G) * 0.02 + 1e-3).astype(np.float32)
    return codes, scales


def _quant_matmul_emulation(x, codes, scales, n, packed):
    M, K = x.shape
    N = codes.shape[0]
    xc, sx, _ = abfp_mod.abfp_quantize(x, INT8, axis=-1, n=n,
                                       dtype=torch.float32)
    plan = t_mm.plan_int8_contract(M, N, K, n, packed)
    if packed:
        wk = _expand_packed(pack_int4_codes(codes).reshape(N, K // 2))
    else:
        wk = codes.reshape(N, K)
    return _mma_emulation(xc.reshape(M, K), sx, wk, scales, n, plan, packed)


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("M,K,N,n", [
    (17, 640, 77, 32), (33, 384, 130, 64), (70, 256, 40, 128),
    (20, 512, 24, 256), (5, 192, 9, 96), (40, 1024, 16, 64),
    (8, 4096, 16, 2048)])
def test_quant_matmul_emulation_is_the_plain_function(M, K, N, n, packed):
    """The emulated kernel (split K where the plan splits it) against
    ``quant_matmul_plain`` within 1e-5; a CPU tensor runs the plain
    version and launches nothing."""
    x = torch.from_numpy(_x(M * K + N, M, K))
    c, s = _stored(N + n, N, K // n, n, packed)
    codes, scales = torch.from_numpy(c), torch.from_numpy(s)
    got = _quant_matmul_emulation(x, codes, scales, n, packed)
    stored = pack_int4_codes(codes) if packed else codes
    want = t_mm.quant_matmul_plain(x, stored, scales, INT8, n=n,
                                   packed=packed)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    before = t_mm.quant_matmul.launches
    assert torch.equal(t_mm.quant_matmul(x, stored, scales, INT8, n=n,
                                         packed=packed), want)
    assert t_mm.quant_matmul.launches == before


@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("M,K,N,n", [(24, 128, 16, 32), (20, 128, 8, 64)])
def test_quant_matmul_emulation_is_the_reference_kernel(M, K, N, n, packed):
    """Against the reference's Pallas ``quant_matmul`` (interpret mode) on
    the same codes, at a tiny shape."""
    x = _x(7 * M + n, M, K)
    c, s = _stored(M + N, N, K // n, n, packed)
    want = j_quant_matmul(jnp.asarray(x), jnp.asarray(c), jnp.asarray(s),
                          j_get_format("int8"), n=n,
                          block_m=jkops.fit_block(M),
                          block_n=jkops.fit_block(N), block_k=K,
                          interpret=True)
    got = _quant_matmul_emulation(torch.from_numpy(x), torch.from_numpy(c),
                                  torch.from_numpy(s), n, packed)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _abfp_int8_emulation(x, w, fx, fw, n):
    M, K = x.shape
    N = w.shape[1]
    xc, sx, _ = abfp_mod.abfp_quantize(x, fx, axis=-1, n=n,
                                       dtype=torch.float32)
    wc, sw, _ = abfp_mod.abfp_quantize(w, fw, axis=0, n=n,
                                       dtype=torch.float32)
    plan = t_mm.plan_abfp_matmul(M, N, K, n, int8=True)
    assert plan.regime == "prefill"
    mma = t_mm.plan_int8_contract(M, N, K, n)
    # quantize_cols_kernel's (N, K) codes: a column's groups contiguous
    return _mma_emulation(xc.reshape(M, K), sx, wc.reshape(N, K), sw, n,
                          mma, False)


@pytest.mark.parametrize("fx,fw", [("int8", "int4"), ("int8", "int8")])
@pytest.mark.parametrize("M,K,N,n", [
    (17, 640, 77, 64), (64, 384, 40, 48), (4, 480, 24, 48),
    (33, 512, 130, 128), (20, 1024, 12, 512)])
def test_abfp_int8_emulation_is_the_plain_function(fx, fw, M, K, N, n):
    """The emulated prefill regime against ``abfp_matmul_int8_plain`` and
    the reference's oracle ``int8_matmul_ref`` within 1e-5."""
    x = _x(M + 3 * K, M, K)
    w = (np.random.RandomState(N + K).randn(K, N) / np.sqrt(K)).astype(
        np.float32)
    tx, tw = t_get_format(fx), t_get_format(fw)
    got = _abfp_int8_emulation(torch.from_numpy(x), torch.from_numpy(w),
                               tx, tw, n)
    want = t_mm.abfp_matmul_int8_plain(torch.from_numpy(x),
                                       torch.from_numpy(w), tx, tw, n=n)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    oracle = jref.int8_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                  j_get_format(fx), j_get_format(fw), n=n)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("n", [32, 48, 64])
@pytest.mark.parametrize("M,N", [(33, 77), (64, 130), (17, 8)])
def test_one_group_is_bit_exact(M, N, n):
    """K = n: one group, one rescale, nothing summed in another order: the
    emulated kernel is bit-equal to the plain versions (abfp_matmul_int8's
    and, where the group length packs, quant_matmul's with int8 and packed
    codes), and to the reference's oracle."""
    x = _x(M * n + N, M, n)
    w = (np.random.RandomState(N * n).randn(n, N) / np.sqrt(n)).astype(
        np.float32)
    tx, tw = INT8, t_get_format("int4")
    got = _abfp_int8_emulation(torch.from_numpy(x), torch.from_numpy(w),
                               tx, tw, n)
    want = t_mm.abfp_matmul_int8_plain(torch.from_numpy(x),
                                       torch.from_numpy(w), tx, tw, n=n)
    assert torch.equal(got, want)
    oracle = jref.int8_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                  j_get_format("int8"), j_get_format("int4"),
                                  n=n)
    assert np.array_equal(got.numpy(), np.asarray(oracle))
    for packed in (False, True) if n % 32 == 0 else (False,):
        c, s = _stored(M + n, N, 1, n, packed)
        codes, scales = torch.from_numpy(c), torch.from_numpy(s)
        stored = pack_int4_codes(codes) if packed else codes
        got = _quant_matmul_emulation(torch.from_numpy(x), codes, scales, n,
                                      packed)
        want = t_mm.quant_matmul_plain(torch.from_numpy(x), stored, scales,
                                       INT8, n=n, packed=packed)
        assert torch.equal(got, want)
