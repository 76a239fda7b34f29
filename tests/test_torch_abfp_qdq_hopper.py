"""``abfp_qdq`` on Hopper: the input dtypes the reference takes, the
arithmetic of ``qdq_stream_kernel`` and its lane plan, on the CPU.

  * bf16 and f16 inputs: the reference computes in f32 and writes its
    output in ``x.dtype``; the port's wrapper (here its plain version) and
    ``ops.abfp_qdq`` are BIT-EQUAL to the reference's oracle
    ``abfp_qdq_ref`` for every format, on activation-like values and on
    the edge cases of ``chip_smoke.qdq_extremes`` that hold no subnormal —
    which is why the kernel must take these dtypes on the card.  (XLA's
    CPU backend flushes subnormals to zero, so on them the oracle differs
    from the port in the sign of a zero: -0 where x / scale is a tiny
    negative number, +0 under the flush.)
  * A numpy emulation of the kernel's arithmetic (minifloat exponent and
    quantum from the bits, multiplication by the quantum's power-of-two
    reciprocal, output rounded to the dtype once) is BIT-EQUAL to
    ``abfp_qdq_plain`` on zeros, subnormals, exact ties, groups at the
    1e-12 floor and maxima near 3e38: the rewrites change no bit.
  * ``plan_qdq``'s lane plan: a power-of-two set of lanes, and the
    kernel's index arithmetic (emulated) touches every element once.
"""

import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.core.formats import get_format as j_get_format
from repro.kernels import ref as jref
from repro_torch.core.formats import BY_NAME, FloatFormat, IntFormat
from repro_torch.core.formats import get_format as t_get_format
from repro_torch.kernels import abfp_qdq as t_qdq
from repro_torch.kernels import build
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as t_mm

FORMATS = sorted(BY_NAME)
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, jnp.float16)}
BITS = {4: (torch.int32, np.uint32), 2: (torch.int16, np.uint16)}


# rows of qdq_extremes whose values and quotients x / scale are all normal
# or zero: zeros, the 1e-12 floor, ties, activation-like
NORMAL_KINDS = [0, 1, 4, 6]


def _inputs(fmt: str, n: int, dtype: str, seed: int = 0,
            kinds=slice(None)) -> torch.Tensor:
    """Activation-like rows (one all zero) over the edge cases' rows
    ``kinds``, as ``dtype``: (16 + kinds, 4 n)."""
    rng = np.random.RandomState(seed)
    act = rng.randn(16, 4 * n) * (1 + 7 * (rng.rand(1, 4 * n) > 0.9))
    act[1] = 0.0
    x = np.concatenate([act.astype(np.float32),
                        chip_smoke.qdq_extremes(fmt, n, dtype, seed)[kinds]])
    return torch.from_numpy(x).to(DTYPES[dtype][0])


def _bits(t: torch.Tensor) -> np.ndarray:
    signed, unsigned = BITS[t.element_size()]
    return t.contiguous().view(signed).numpy().view(unsigned)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_half_inputs_bit_equal_to_the_oracle(fmt, dtype):
    x = _inputs(fmt, 64, dtype, kinds=NORMAL_KINDS)
    before = t_qdq.abfp_qdq.launches
    got = t_qdq.abfp_qdq(x, t_get_format(fmt), n=64)
    front = tops.abfp_qdq(x.reshape(1, *x.shape), t_get_format(fmt), n=64)
    assert t_qdq.abfp_qdq.launches == before  # CPU: the plain version
    assert got.dtype == front.dtype == x.dtype
    xj = jnp.asarray(x.float().numpy()).astype(DTYPES[dtype][1])
    oracle = np.asarray(jref.abfp_qdq_ref(xj, j_get_format(fmt), n=64))
    want = oracle.view(np.uint16)
    np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(_bits(front[0]), want)


def _bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 -> nearest bf16 (ties to even), as f32 (finite or inf)."""
    b = a.view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def _kernel_emulation(x: np.ndarray, fmt, n: int) -> np.ndarray:
    """qdq_stream_kernel's arithmetic on f32 values, in numpy f32: the
    group max, its bf16 round and floor, alpha / qmax and x / scale (IEEE
    divisions); ints: rint and clamp; minifloats: exponent from the bits
    (biased - 127, clamped), quantum and reciprocal from bits, rint of
    xs * reciprocal times the quantum, saturation, 0 kept 0 (+0)."""
    f32 = np.float32
    M, K = x.shape
    xg = x.reshape(M, K // n, n)
    amax = np.abs(xg).max(axis=-1, keepdims=True)
    alpha = np.maximum(_bf16_round(amax), f32(1e-12))
    s = alpha / f32(fmt.qmax_pos)
    xs = xg / s
    if isinstance(fmt, IntFormat):
        u = np.clip(np.rint(xs), f32(fmt.qmin), f32(fmt.qmax_pos))
    else:
        _, _, _, man, lo, hi = t_qdq.format_args(fmt)
        ax = np.abs(xs)
        e = np.clip((ax.view(np.uint32) >> 23).astype(np.int32) - 127,
                    lo, hi)
        quantum = ((e - man + 127).astype(np.uint32) << 23).view(f32)
        inv = ((man - e + 127).astype(np.uint32) << 23).view(f32)
        q = np.rint(xs * inv) * quantum
        q = np.clip(q, f32(-fmt.qmax_pos), f32(fmt.qmax_pos))
        u = np.where(ax == 0, f32(0.0), q)
    y = (u * s).astype(f32)
    assert y.dtype == np.float32
    return y.reshape(M, K)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fmt", FORMATS)
def test_kernel_arithmetic_is_the_plain_version(fmt, dtype):
    tfmt = t_get_format(fmt)
    for n in (48, 64):
        x = _inputs(fmt, n, dtype, seed=n)
        y = _kernel_emulation(x.float().numpy(), tfmt, n)
        got = torch.from_numpy(y).to(x.dtype)  # one round to the dtype
        want = t_qdq.abfp_qdq_plain(x, tfmt, n=n)
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _covered(plan, n_groups: int, n: int) -> np.ndarray:
    """How often qdq_stream_kernel's index arithmetic (emulated for every
    thread of the planned grid) touches each element."""
    T = plan.blocks * plan.threads
    tid = np.arange(T, dtype=np.int64)
    L = plan.lanes
    lane, first = tid % L, tid // L
    sets = T // L
    w0 = (tid & ~31) // L  # the warp's first set: its loop condition
    counts = np.zeros(n_groups * n, np.int64)
    k = 0
    while True:
        live = w0 + k * sets < n_groups
        if not live.any():
            return counts
        g = first + k * sets
        ok = live & (g < n_groups)
        for j in range(plan.vpl):
            load = g[ok] * plan.vpl * L + j * L + lane[ok]
            for e in range(plan.width):
                counts += np.bincount(load * plan.width + e,
                                      minlength=counts.size)
        k += 1


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("n", [16, 20, 32, 40, 48, 56, 64, 128])
def test_lane_plan_covers_every_element_once(n, itemsize, aligned):
    fmt = BY_NAME["int8"]
    for n_groups, sms in ((7, 132), (224, 132), (1000, 3)):
        plan = t_qdq.plan_qdq(n_groups, n, itemsize, aligned, fmt, sms=sms)
        assert plan.kernel == "qdq_stream_kernel"
        assert plan.vec == (aligned and n * itemsize % 16 == 0)
        assert plan.width == (16 // itemsize if plan.vec else 1)
        L = plan.lanes
        assert 1 <= L <= 32 and L & (L - 1) == 0
        assert L * plan.vpl * plan.width == n
        assert 1 <= plan.vpl <= t_qdq.QDQ_MAX_VPL
        assert L == 32 or (n // plan.width // L) % 2  # the widest set
        assert plan.threads in (32, 64, 128) and plan.threads % L == 0
        assert plan.blocks <= sms * t_qdq.stream_blocks_per_sm(
            plan.vpl * plan.width)
        assert (_covered(plan, n_groups, n) == 1).all()


def test_plan_at_the_timed_shapes():
    i8, e4m3 = BY_NAME["int8"], BY_NAME["e4m3"]
    head = t_qdq.plan_qdq(256 * 56, 64, 4, True, i8)
    assert head == t_qdq.QdqPlan("qdq_stream_kernel", True, 4, 16, 1,
                                 "int", 128, 1792)
    # a whole wi weight: 16 resident blocks an SM, a grid-stride loop
    weight = t_qdq.plan_qdq(18944 * 56, 64, 4, True, e4m3)
    assert (weight.mode, weight.threads, weight.blocks) == (
        "minifloat", 128, 16 * t_qdq.SMS)
    bf16 = t_qdq.plan_qdq(256 * 56, 64, 2, True, i8)
    assert (bf16.lanes, bf16.vpl, bf16.width, bf16.blocks) == (8, 1, 8, 896)
    # abfp_matmul's pre-pass: 224 and 1,184 groups spread over the SMs
    for groups, shape in ((4 * 56, (32, 112)), (4 * 296, (128, 148))):
        plan = t_qdq.plan_qdq(groups, 64, 4, True, i8)
        assert (plan.threads, plan.blocks) == shape
    # off the 16-byte grid: one element a load; too long a group: one
    # warp a group
    assert not t_qdq.plan_qdq(224, 64, 4, False, i8).vec
    for n in (36, 2048):
        assert t_qdq.plan_qdq(3, n, 4, True, i8).kernel == "qdq_rows_kernel"


def test_minifloat_fast_form_covers_the_registry():
    quanta = []
    for name, fmt in BY_NAME.items():
        if isinstance(fmt, IntFormat):
            assert not t_qdq.minifloat_fast(fmt)
            continue
        assert t_qdq.minifloat_fast(fmt), name
        _, _, _, man, lo, hi = t_qdq.format_args(fmt)
        quanta += [lo - man, hi - man]
    assert (min(quanta), max(quanta)) == (-16, 14)
    # a quantum below the normal range keeps qdq_unit (frexpf / ldexpf)
    wide = FloatFormat(exp_bits=8, man_bits=7)
    assert not t_qdq.minifloat_fast(wide)
    plan = t_qdq.plan_qdq(4, 64, 4, True, wide)
    assert (plan.mode, plan.kernel) == ("generic", "qdq_rows_kernel")


def _c_params(source: str, entry: str) -> list:
    text = (build.CSRC_DIR / source).read_text()
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
    return [p.strip() for p in m.group(1).split(",")]


def _argtypes(bind, entry: str) -> list:
    fn = types.SimpleNamespace(argtypes=None, restype=None)
    return bind(types.SimpleNamespace(**{entry: fn})).argtypes


def test_kernel_sources_agree_with_the_planner():
    """The header's constants and QdqPlan are the planner's; both C
    entries take the plan as the wrappers bind them; abfp_matmul's
    pre-pass goes through launch_qdq."""
    hdr = (build.CSRC_DIR / "abfp_qdq.cuh").read_text()
    for name, value in (("kStreamThreads", t_qdq.QDQ_THREADS),
                        ("kStreamMaxVpl", t_qdq.QDQ_MAX_VPL),
                        ("kQdqWarps", t_qdq.QDQ_ROWS_WARPS)):
        assert re.search(rf"constexpr int {name} = {value};", hdr), name
    body = re.search(r"struct QdqPlan \{(.*?)\};", hdr, re.S).group(1)
    fields = re.findall(r"int (\w+);", body)
    assert fields == [f for f, _ in t_qdq._PlanC._fields_]
    blocks = re.search(r"stream_blocks_per_sm\(int elems\) \{\s*return "
                       r"elems <= 4 \? (\d+) : elems <= 16 \? (\d+) : "
                       r"(\d+);", hdr)
    assert [t_qdq.stream_blocks_per_sm(e) for e in (4, 16, 17)] == [
        int(b) for b in blocks.groups()]
    assert re.search(r"enum QdqMode \{ kQdqInt = 0, kQdqMinifloat = 1, "
                     r"kQdqGeneric = 2 \};", hdr)
    assert t_qdq.QDQ_MODES == ("int", "minifloat", "generic")
    for kernel in ("qdq_stream_kernel", "qdq_rows_kernel"):
        assert re.search(rf"__global__ void[^;{{]*\n{kernel}\(", hdr)
    qdq = _c_params("abfp_qdq.cu", "repro_abfp_qdq")
    assert len(qdq) == len(_argtypes(t_qdq._bind, "repro_abfp_qdq"))
    assert qdq[5] == "const void* plan"
    fp = _c_params("quant_matmul.cu", "repro_abfp_matmul")
    assert len(fp) == len(_argtypes(t_mm._bind_fp, "repro_abfp_matmul"))
    assert fp[-2] == "const void* x_qdq_plan"
    qm = (build.CSRC_DIR / "quant_matmul.cu").read_text()
    assert "repro::launch_qdq(" in qm and "qdq_rows_kernel<" not in qm
