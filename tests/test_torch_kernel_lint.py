"""QL303 on the port: it fires at a site exactly where the kernel that site
launches would refuse the call, with the refusal's own text.

A dense fused site launches ``abfp_matmul`` (``abfp_matmul_int8`` under
compute='int8'), planned by ``plan_abfp_matmul``; the plan raises where
``quantize_cols_kernel``'s tile of a group no longer fits a block's
shared memory: ``abfp_matmul`` from n = 1,216 (233,728 bytes; 1,200 needs
230,656), ``abfp_matmul_int8`` from n = 1,456 (233,216; 1,440 needs
230,656), against ``SMEM_MAX`` = 232,448.  A compressed site under a fused
policy launches ``quant_matmul`` (``quant_matmul_plan``), which plans
every group length up to 8,192 and refuses only calls past its 32-bit
offsets.  The reference's QL303 is a TPU VMEM estimate that fires from
about n = 7,937: where the two disagree, the port's verdict is the
plan's.
"""

import io

import pytest

from repro_torch.analysis.kernel_lint import PLAN_ROWS, lint_kernels
from repro_torch.analysis.qlint import lint
from repro_torch.configs import SHAPES, ShapeSpec, get_config
from repro_torch.core.formats import get_format
from repro_torch.core.policy import PolicyMap, preset
from repro_torch.kernels import ops
from repro_torch.kernels import quant_matmul as qm
from repro_torch.launch.lint import preflight
from torch_lint_helpers import REF

CFG = get_config("qwen2-7b")
N = 4096


def fused(n: int, int8: bool = False):
    """w4a8's formats (int8 x, int4 w) in groups of n, on the fused path."""
    pol = preset("w4a8_abfp", n=n).replace(fused=True)
    return pol.replace(compute="int8") if int8 else pol


def rows(M: int) -> ShapeSpec:
    """A decode shape whose matmuls have M rows."""
    return ShapeSpec(f"decode_{M}", 1, M, "decode")


def plan_error(M, K, N, n, int8):
    try:
        qm.plan_abfp_matmul(M, N, K, n, int8=int8, formats=(
            get_format("int8"), get_format("int4")))
    except ValueError as e:
        return str(e)
    return None


def ql303(policy, K, N, *, shape=None, compress=False):
    diags = lint_kernels(CFG, policy, [("blocks.0/ffn/wi", K, N, 1)],
                         compress=compress, shape=shape)
    return [d for d in diags if d.code == "QL303"]


def test_one_shared_memory_budget():
    assert ops.SMEM_MAX == qm.SMEM_MAX == 232448 == 227 * 1024
    assert PLAN_ROWS == (1, 16, 256)


@pytest.mark.parametrize("n,int8,refused", [
    (1200, False, False), (1216, False, True),
    (1440, True, False), (1456, True, True),
])
@pytest.mark.parametrize("M", [1, 16, 256])
def test_ql303_fires_exactly_where_the_plan_raises(n, int8, refused, M):
    K = 4 * n
    want = plan_error(M, K, N, n, int8)
    assert (want is not None) == refused
    got = ql303(fused(n, int8), K, N, shape=rows(M))
    if want is None:
        assert got == []
        return
    assert [d.message for d in got] == [want]
    assert got[0].site == "blocks.*/ffn/wi" and str(got[0].severity) == \
        "warning"
    assert "more shared memory than the 232448 bytes" in want


@pytest.mark.parametrize("n,int8", [(1200, False), (1216, False),
                                    (1440, True), (1456, True)])
def test_without_a_shape_the_three_row_counts_are_planned(n, int8):
    K = 4 * n
    errors = [plan_error(M, K, N, n, int8) for M in PLAN_ROWS]
    got = ql303(fused(n, int8), K, N)
    first = next((e for e in errors if e is not None), None)
    assert [d.message for d in got] == ([] if first is None else [first])


def test_the_wrapper_and_the_lint_say_the_same():
    """The CUDA wrapper plans before it allocates or launches: the text it
    would raise on the card is the plan's, which the lint reports."""
    for fn, n, int8 in ((qm.abfp_matmul, 1216, False),
                        (qm.abfp_matmul_int8, 1456, True)):
        with pytest.raises(ValueError) as e:
            qm.plan_abfp_matmul(256, N, 4 * n, n, int8=int8, formats=(
                get_format("int8"), get_format("int4")))
        assert str(e.value).startswith(fn.__name__ + ":")
        assert [d.message for d in ql303(fused(n, int8), 4 * n, N)] == [
            str(e.value)]


@pytest.mark.parametrize("n", [64, 1216, 4096, 8192])
def test_compressed_sites_plan_quant_matmul(n):
    """At a compressed site under a fused, aligned int-ABFP policy the
    lint asks ``quant_matmul_plan`` (packed int4 codes): it plans every
    group length here, so QL303 stays quiet where the dense fused path
    refuses n >= 1,216 — and fires, with the plan's text, at a call past
    the kernel's 32-bit offsets."""
    pol = fused(n)
    K = 4 * n
    for M in PLAN_ROWS:
        qm.quant_matmul_plan(M, N, K, n, True)  # plans
    assert ql303(pol, K, N, compress=True) == []
    M = 1 << 24
    with pytest.raises(ValueError, match="32-bit offsets") as e:
        qm.quant_matmul_plan(M, N, K, n, True)
    got = ql303(pol, K, N, compress=True, shape=rows(M))
    assert [d.message for d in got] == [str(e.value)]


def test_unaligned_or_unfused_sites_launch_no_kernel():
    # compressed codes in groups of 64, x quantized in groups of 32: the
    # plain grouped contraction, no quant_matmul
    pol = preset("w4a8_abfp").replace(fused=True)
    pol = pol.replace(input=pol.input.replace(group=32))
    assert ql303(pol, 4 * 1216, N, compress=True) == []
    # the same group on the non-fused backends: no kernel, no plan
    assert ql303(preset("w4a8_abfp", n=1216), 4 * 1216, N) == []


@pytest.mark.parametrize("n,K,N_", [
    (8192, 8192, 4096),    # both fire (the reference's VMEM estimate too)
    (2048, 8192, 4096),    # only the port's plan refuses it
    (1024, 3584 * 2, 3584),  # neither
])
def test_the_references_ql303_inputs(n, K, N_):
    """At the reference's own QL303 inputs the port's verdict is the
    plan's, whatever the reference's estimate says."""
    ref = [d for d in REF.kernel_lint.lint_kernels(
        REF.get_config("qwen2-7b"),
        REF.preset("w4a8_abfp", n=n).replace(fused=True),
        [("blocks.0/ffn/wi", K, N_, 1)], compress=False)
        if d.code == "QL303"]
    got = ql303(fused(n), K, N_)
    errors = [plan_error(M, K, N_, n, False) for M in PLAN_ROWS]
    first = next((e for e in errors if e is not None), None)
    assert [d.message for d in got] == ([] if first is None else [first])
    # the reference's estimate fires only at its own VMEM budget
    assert bool(ref) == (n == 8192)
    assert bool(got) == (n >= 1216)


def test_ql303_warns_and_the_gate_lets_it_through():
    """QL303 keeps the reference's WARNING severity, so the pre-flight
    gate blocks exactly what the reference's blocks."""
    cfg = CFG.replace(d_model=4864, d_ff=4864 * 4)  # 4 x 1216 groups
    pm = PolicyMap(rules=(("*ffn*", fused(1216)),),
                   default=preset("w4a8_abfp"))
    r = lint(cfg, pm)
    assert r.has("QL303") and r.ok
    preflight(cfg, pm, out=io.StringIO())  # warns, does not block
    decode = lint(cfg, pm, shape=SHAPES["decode_32k"])
    assert decode.has("QL303") and decode.ok
