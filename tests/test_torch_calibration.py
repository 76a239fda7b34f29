"""Calibration statistics and the static solvers of the port vs the
reference (``repro.core.calibration``), on the same numpy activations.

Tolerances:
  * ``RunningStats``: absmax, per-channel abs max / min / max, the row count
    and the reservoir rows EXACT (the same numpy index draw, gathered); the
    float64 X^T X within 1e-12 relative (another BLAS sums the products in
    another order).
  * ``max_alpha``: exact.
  * ``mse_alpha`` / ``mse_alpha_tensor``: the chosen alpha EXACT, except at
    a near-tie (rule c): the reference takes each candidate's f32 mean error
    in its own summation order, so ``argmin`` may pick another candidate
    where two errors are equal within that sum's rounding.  Every such
    difference is counted and shown to be one: the two candidates' exact
    (float64) mean errors, computed from the reference's own elementwise
    errors, differ by no more than the float32 summation bound
    ``n * 2**-24 * (E_a + E_b)``.
  * The candidate grid: bit-equal to ``jnp.linspace``.
  * An opt-tiny forward observes the reference's set of sites, with the
    reference's row counts.  Two independent calibrations agree call by
    call up to the first int8 activation code that differs, which must sit
    at a rounding boundary (``torch_ptq_helpers.STATS_BAR``, ``TIE_BAR``);
    with each quantizer's output pinned to the reference's, every site's
    statistics (X^T X included) agree within ``STATS_BAR``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import calibration as jc
from repro.core import policy as jp
from repro.core.formats import get_format as j_fmt
from repro.models import build_model as j_build_model
from repro.models import quant_transforms as jqt
from repro.nn.module import unbox
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import calibration as tc
from repro_torch.core import policy as tp
from repro_torch.core.formats import get_format as t_fmt
from repro_torch.models import build_model as t_build_model
from repro_torch.models import quant_transforms as tqt
from torch_ptq_helpers import (assert_equal_but_near_ties,
                               assert_free_calls_match,
                               assert_pinned_calls_match, assert_stats_match,
                               port_quantizer_calls,
                               reference_quantizer_calls)

FORMATS = ("int4", "int8", "e2m1", "e4m3")


def _batches(seed=0, channels=24, shapes=((4, 50), (3, 7), (2, 90))):
    """Heavy-tailed activations with per-channel ranges (outlier channels,
    one dead channel), batches of different leading shapes."""
    rng = np.random.RandomState(seed)
    scale = rng.uniform(0.1, 3.0, channels).astype(np.float32)
    scale[5] = 20.0
    out = []
    for lead in shapes:
        x = rng.standard_t(4, size=lead + (channels,)).astype(np.float32)
        x = x * scale
        x[..., 7] = 0.0
        out.append(x)
    return out


def _stats_pair(batches, collect_outer=False, max_samples=8):
    jst = jc.RunningStats(collect_outer=collect_outer,
                          max_samples=max_samples)
    tst = tc.RunningStats(collect_outer=collect_outer,
                          max_samples=max_samples)
    for x in batches:
        jst.update(x)
        tst.update(torch.from_numpy(x))
    return jst, tst


@pytest.mark.parametrize("max_samples", [8, 2])
def test_running_stats_match_reference(max_samples):
    jst, tst = _stats_pair(_batches(), collect_outer=True,
                           max_samples=max_samples)
    assert float(tst.absmax) == jst.absmax
    for key in ("ch_absmax", "ch_min", "ch_max"):
        np.testing.assert_array_equal(getattr(tst, key).numpy(),
                                      getattr(jst, key))
    assert tst.count == jst.count == 200 + 21 + 180
    assert len(tst.samples) == len(jst.samples) == min(3, max_samples)
    for a, b in zip(tst.samples, jst.samples):
        np.testing.assert_array_equal(a.numpy(), b)
    assert tst.outer.dtype == torch.float64
    np.testing.assert_allclose(tst.outer.numpy(), jst.outer, rtol=1e-12,
                               atol=1e-12 * np.abs(jst.outer).max())


def test_reservoir_is_bounded_like_the_reference():
    """More than 4096 rows a batch: the reservoir keeps 4096 of them, the
    rows the reference's ``RandomState(count)`` draw picks."""
    x = np.random.RandomState(3).standard_normal((2, 2500, 8)).astype(
        np.float32)
    jst, tst = _stats_pair([x])
    assert tst.samples[0].shape == (4096, 8)
    np.testing.assert_array_equal(tst.samples[0].numpy(), jst.samples[0])


@pytest.mark.parametrize("num", [1, 2, 3, 10, 37, 100, 256, 1000])
def test_candidate_grid_is_jnp_linspace_bit_for_bit(num):
    got = tc.linspace_fracs(num).numpy()
    want = np.asarray(jnp.linspace(1.0 / num, 1.0, num))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("per_channel", [False, True])
def test_max_alpha_matches_reference(per_channel):
    jst, tst = _stats_pair(_batches(seed=1))
    got = tc.max_alpha(tst, per_channel=per_channel).numpy()
    want = np.asarray(jc.max_alpha(jst, per_channel=per_channel))
    np.testing.assert_array_equal(got, want)
    empty = tc.RunningStats()
    assert float(tc.max_alpha(empty)) == float(
        jc.max_alpha(jc.RunningStats()))


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("fmt", FORMATS)
def test_mse_alpha_matches_reference(fmt, per_channel):
    jst, tst = _stats_pair(_batches(seed=2))
    got = tc.mse_alpha(tst, t_fmt(fmt), per_channel=per_channel).numpy()
    want = np.asarray(jc.mse_alpha(jst, j_fmt(fmt), per_channel=per_channel))
    assert got.shape == want.shape and got.dtype == np.float32
    x = np.concatenate(jst.samples, axis=0)
    amax = jc.max_alpha(jst, per_channel=per_channel)
    n_ties = assert_equal_but_near_ties(got, want, amax, x, fmt,
                                        per_channel)
    print(f"mse_alpha {fmt} per_channel={per_channel}: {n_ties} near-ties "
          f"of {got.size}")
    assert n_ties <= max(1, got.size // 10)


@pytest.mark.parametrize("fmt", FORMATS)
def test_mse_alpha_tensor_matches_reference(fmt):
    w = np.random.RandomState(4).standard_t(5, (64, 48)).astype(np.float32)
    got = tc.mse_alpha_tensor(torch.from_numpy(w), t_fmt(fmt)).numpy()
    want = np.asarray(jc.mse_alpha_tensor(jnp.asarray(w), j_fmt(fmt)))
    amax = np.maximum(np.abs(w).max(), np.float32(1e-8))
    assert_equal_but_near_ties(got, want, amax, w, fmt, per_channel=False)


@pytest.fixture(scope="module")
def calibrated():
    """Both stacks calibrated on the same two opt-tiny batches under
    w4a8_mse (bridged weights), each on its own, with every activation
    quantizer call recorded; and the port calibrated once more with each
    call's output pinned to the reference's."""
    jcfg = j_get_config("opt-tiny").replace(n_layers=2)
    jmodel = j_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tcfg = t_get_config("opt-tiny").replace(n_layers=2)
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                       device="cpu")
    rng = np.random.RandomState(1)
    batches = [{"tokens": rng.randint(0, jcfg.vocab, (2, 16)).astype(
        np.int32)} for _ in range(2)]
    jpol = jp.preset("w4a8_mse", n_layers=2)
    tpol = tp.preset("w4a8_mse", n_layers=2)
    with reference_quantizer_calls() as jcalls:
        jcal = jqt.calibrate(jmodel, jparams, batches, jpol,
                             collect_outer=True)
    with port_quantizer_calls() as tcalls:
        tcal = tqt.calibrate(tmodel, tparams, batches, tpol,
                             collect_outer=True)
    with port_quantizer_calls(pins=jcalls) as pcalls:
        pcal = tqt.calibrate(tmodel, tparams, batches, tpol,
                             collect_outer=True)
    return dict(jcal=jcal, tcal=tcal, pcal=pcal, jcalls=jcalls,
                tcalls=tcalls, pcalls=pcalls, n_forwards=len(batches))


def test_sites_observed_on_an_opt_tiny_forward(calibrated):
    """Two independent calibrations: the same sites in the same order, each
    with the reference's row count.  Call by call, each forward's inputs
    agree within STATS_BAR of the reference's range up to the first call
    whose int8 codes differ, and every code that differs there sits within
    TIE_BAR of a rounding boundary (f32 contractions summed in another
    order move a value across it); the rest of that forward inherits the
    change and is held, pinned, by the test below."""
    c = calibrated
    jcal, tcal = c["jcal"], c["tcal"]
    assert list(tcal.stats) == list(jcal.stats)
    want = {"embed/attend/in"}
    for i in range(2):
        want |= {f"blocks.{i}/attn/{s}" for s in (
            "q/in", "k/in", "v/in", "o/in", "bmm_q", "bmm_k", "bmm_v",
            "probs")}
        want |= {f"blocks.{i}/ffn/wi/in", f"blocks.{i}/ffn/wo/in"}
    assert set(tcal.stats) == want
    for site, jst in jcal.stats.items():
        assert tcal.stats[site].count == jst.count, site
    origins, inherited = assert_free_calls_match(
        c["tcalls"], c["jcalls"], c["n_forwards"])
    print(f"independent calibrations: {origins} codes first differ at a "
          f"rounding boundary, {inherited} of {len(c['jcalls'])} calls "
          f"inherit")


def test_pinned_calibration_matches_reference_at_every_site(calibrated):
    """The port's observation forward with each activation quantizer's
    output pinned to the reference's call: every call's input within
    STATS_BAR of the reference's, each code the pin changed within TIE_BAR
    of a rounding boundary, and every site's absmax, per-channel abs max /
    min / max and reservoir rows within STATS_BAR of its range, X^T X within
    STATS_BAR of its largest entry."""
    c = calibrated
    changed = assert_pinned_calls_match(c["pcalls"], c["jcalls"])
    assert_stats_match(c["pcal"], c["jcal"])
    print(f"pinned calibration: {changed} codes changed by a pin, all at "
          f"a rounding boundary")


def test_calibrator_solve_on_bridged_stats(calibrated):
    """``Calibrator.solve`` over a bridged reference calibrator: 'max'
    exact, 'mse' exact but near-ties; an unknown method raises as the
    reference does."""
    jcal = calibrated["jcal"]
    tcal = bridge.from_repro_calibrator(jcal, device="cpu")
    got = tcal.solve(t_fmt("int8"), method="max", per_channel=True)
    want = jcal.solve(j_fmt("int8"), method="max", per_channel=True)
    for site in want:
        np.testing.assert_array_equal(got[site].numpy(),
                                      np.asarray(want[site]))
    got = tcal.solve(t_fmt("int8"), method="mse")
    want = jcal.solve(j_fmt("int8"), method="mse")
    ties = 0
    for site, st in jcal.stats.items():
        ties += assert_equal_but_near_ties(
            got[site].numpy(), np.asarray(want[site]), jc.max_alpha(st),
            np.concatenate(st.samples), "int8", per_channel=False)
    print(f"Calibrator.solve mse: {ties} near-ties of {len(want)} sites")
    with pytest.raises(ValueError, match="unknown calibration method"):
        tcal.solve(t_fmt("int8"), method="median")
