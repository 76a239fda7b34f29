"""SmoothQuant, GPTQ and RPTQ of the port vs the reference on the same
numpy inputs.

Tolerances:
  * SmoothQuant (``smoothing_factors``, ``smooth_linear``,
    ``fold_into_norm``): bit-equal.
  * GPTQ on the reference's own Hessian: bit-equal, except at rounding
    ties (rule e: LAPACK's and ``torch.linalg``'s inverse and Cholesky
    factor may differ in the last bits of float64): in each output column
    the first element that differs must be one the reference rounded from
    within 1e-9 of a boundary.  The count is printed.
  * The minifloat exponent (rule g): float32 ``log2`` rounded, then
    floored, equal to numpy's at and within 4 ulps of every power of two in
    e2m1's and e4m3's exponent range; the QDQ of those values bit-equal.
  * RPTQ (``solve``, ``fold_permutation``): equal.
"""

import numpy as np
import pytest
import torch

from repro.core import gptq as jg
from repro.core import rptq as jr
from repro.core import smoothquant as js
from repro.core.formats import get_format as j_fmt
from repro_torch.core import gptq as tg
from repro_torch.core import rptq as tr
from repro_torch.core import smoothquant as ts
from repro_torch.core.formats import get_format as t_fmt
from torch_ptq_helpers import assert_gptq_equal_but_ties, reference_gptq_units


def _absmax_pair(seed=0, n=512):
    rng = np.random.RandomState(seed)
    a = np.abs(rng.standard_t(3, n)).astype(np.float32) * 4
    w = np.abs(rng.standard_normal(n)).astype(np.float32)
    a[:4] = 0.0  # dead activation channels
    w[4:8] = 0.0  # dead weight rows
    a[8] = 1e-9
    return a, w


@pytest.mark.parametrize("alpha", [0.5, 0.75, 0.25])
def test_smoothing_factors_bit_equal(alpha):
    a, w = _absmax_pair()
    got = ts.smoothing_factors(torch.from_numpy(a), torch.from_numpy(w),
                               alpha)
    want = js.smoothing_factors(a, w, alpha)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_smooth_linear_and_fold_into_norm_bit_equal():
    a, _ = _absmax_pair(1, 96)
    w = np.random.RandomState(2).standard_normal((96, 40)).astype(np.float32)
    s_t, w_t = ts.smooth_linear(torch.from_numpy(w), torch.from_numpy(a))
    s_j, w_j = js.smooth_linear(w, a)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(w_t.numpy(), np.asarray(w_j))
    scale = np.random.RandomState(3).uniform(0.5, 2, 96).astype(np.float32)
    got = ts.fold_into_norm(torch.from_numpy(scale), s_t)
    want = js.fold_into_norm(scale, s_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _gptq_problem(seed=0, K=160, N=24):
    """A Hessian from heavy-tailed activations with two dead input
    channels; K crosses one 128-row block."""
    rng = np.random.RandomState(seed)
    x = rng.standard_t(5, (300, K)).astype(np.float32)
    x *= rng.uniform(0.2, 2.0, K).astype(np.float32)
    x[:, [3, 77]] = 0.0
    H = x.astype(np.float64).T @ x.astype(np.float64)
    w = (rng.standard_normal((K, N)) * 0.1).astype(np.float32)
    return w, H


@pytest.mark.parametrize("actorder", [False, True])
@pytest.mark.parametrize("group_size", [-1, 32])
@pytest.mark.parametrize("fmt", ["int4", "int8", "e2m1", "e4m3"])
def test_gptq_matches_reference(monkeypatch, fmt, group_size, actorder):
    w, H = _gptq_problem()
    jcfg = jg.GPTQConfig(group_size=group_size, actorder=actorder)
    want, units, jinfo = reference_gptq_units(monkeypatch, w, H, fmt, jcfg)
    got, info = tg.gptq_quantize(
        torch.from_numpy(w), torch.from_numpy(H), t_fmt(fmt),
        tg.GPTQConfig(group_size=group_size, actorder=actorder))
    assert got.dtype == torch.float32 and got.shape == w.shape
    perm = np.argsort(-np.where(np.diag(H) == 0, 1.0, np.diag(H))) \
        if actorder else None
    n_el, n_cols = assert_gptq_equal_but_ties(got.numpy(), want, units, fmt,
                                              perm)
    print(f"gptq {fmt} g={group_size} actorder={actorder}: {n_el} elements "
          f"in {n_cols} columns past a rounding tie")
    assert info["dead"] == jinfo["dead"] == 2
    np.testing.assert_allclose(info["loss"], jinfo["loss"], rtol=1e-9)
    assert not got[[3, 77]].any()


def test_gptq_blocksize_and_damping_options(monkeypatch):
    """Non-default block size and damping, group 16 crossing blocks of 48."""
    w, H = _gptq_problem(seed=1, K=120, N=16)
    kw = dict(percdamp=0.05, blocksize=48, group_size=16)
    want, units, _ = reference_gptq_units(monkeypatch, w, H, "int4",
                                          jg.GPTQConfig(**kw))
    got, _ = tg.gptq_quantize(torch.from_numpy(w), torch.from_numpy(H),
                              t_fmt("int4"), tg.GPTQConfig(**kw))
    assert_gptq_equal_but_ties(got.numpy(), want, units, "int4")


def _power_of_two_edges(fmt):
    """Every power of two in the format's exponent range (and one past each
    end), with the 4 float32 neighbours on either side."""
    lo = fmt.min_normal_exp - fmt.man_bits - 1
    hi = fmt.max_biased_exp - fmt._bias + 2
    vals = []
    for k in range(lo, hi + 1):
        p = np.float32(2.0 ** k)
        down = up = p
        vals.append(p)
        for _ in range(4):
            down = np.nextafter(down, np.float32(0))
            up = np.nextafter(up, np.float32(np.inf))
            vals += [down, up]
    v = np.array(vals, np.float32)
    return np.concatenate([v, -v, [np.float32(0)]])


@pytest.mark.parametrize("fmt", ["e2m1", "e4m3"])
def test_float_exponent_at_powers_of_two(fmt):
    """Rule (g): just below a power of two numpy's float32 log2 rounds up
    to the integer; the port's exponent follows it, and so does the QDQ."""
    v = _power_of_two_edges(t_fmt(fmt))
    got = tg.float_exponent(torch.from_numpy(v)).numpy()
    absv = np.abs(v)
    want = np.floor(np.log2(np.where(absv > 0, absv, np.float32(1))))
    np.testing.assert_array_equal(got, want)
    nz = absv > 0
    true_exp = np.floor(np.log2(absv[nz].astype(np.float64)))
    assert (want[nz] > true_exp).any()  # the edge the rule is about
    qdq_t = tg._float_qdq(torch.from_numpy(v), t_fmt(fmt)).numpy()
    qdq_j = jg._float_qdq_np(v, j_fmt(fmt))
    np.testing.assert_array_equal(qdq_t, qdq_j)


@pytest.mark.parametrize("num_clusters", [4, 8])
def test_rptq_solve_and_fold_match_reference(num_clusters):
    rng = np.random.RandomState(5)
    ch_min = (-np.abs(rng.standard_t(3, 96)) * rng.uniform(0.1, 4, 96)
              ).astype(np.float32)
    ch_max = (np.abs(rng.standard_t(3, 96)) * rng.uniform(0.1, 4, 96)
              ).astype(np.float32)
    want = jr.solve(ch_min, ch_max, num_clusters=num_clusters)
    got = tr.solve(ch_min, ch_max, num_clusters=num_clusters)
    for key in ("perm", "cluster_of", "cluster_alpha", "alpha_per_channel"):
        np.testing.assert_array_equal(getattr(got, key), getattr(want, key))
    a = rng.standard_normal((32, 96)).astype(np.float32)
    b = rng.standard_normal((96, 16)).astype(np.float32)
    pa, pb = tr.fold_permutation(torch.from_numpy(a), torch.from_numpy(b),
                                 got.perm)
    ja, jb = jr.fold_permutation(a, b, want.perm)
    np.testing.assert_array_equal(pa.numpy(), ja)
    np.testing.assert_array_equal(pb.numpy(), jb)
    x = rng.standard_normal((8, 32)).astype(np.float32)
    np.testing.assert_allclose((x @ pa.numpy()) @ pb.numpy(), (x @ a) @ b,
                               rtol=1e-5, atol=1e-5)
