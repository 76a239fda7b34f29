"""What the PTQ parity tests of the port share: the near-tie account of the
MSE grid search (rule c), the rounding-tie account of GPTQ (rule e), the
activation quantizers of a calibration forward recorded call by call in both
stacks (and, for the port, pinned to the reference's outputs)."""

import contextlib
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.simulate as j_sim
import repro.nn.attention as j_attn
import repro_torch.core.simulate as t_sim
import repro_torch.nn.attention as t_attn
from repro.core import calibration as jc
from repro.core import gptq as jg
from repro.core.formats import IntFormat
from repro.core.formats import get_format as j_fmt
from repro.core.quantize import qdq as j_qdq

# An observed activation of the port against the reference's, as a share of
# the reference's range: f32 contractions summed in another order (measured
# at most 6e-7 on opt-tiny).
STATS_BAR = 1e-5
# How near a rounding boundary a code that differs must sit, in quanta of its
# quantizer: an int8 per-tensor quantum is 1/127 of the range, so inputs
# within STATS_BAR move a value by at most 127 * STATS_BAR of a quantum (plus
# the scale's own last bits).
TIE_BAR = 2e-3


def reference_candidate_errors(x, amax, fmt_name, per_channel):
    """The exact (float64) mean of the reference's own f32 elementwise
    errors at each of its 100 candidates, and the count of terms in each
    mean: (100, C) or (100, 1), n."""
    fmt = j_fmt(fmt_name)
    xj = jnp.asarray(x)
    fracs = jnp.linspace(0.01, 1.0, 100)
    elem = jax.lax.map(lambda f: (j_qdq(xj, amax * f, fmt) - xj) ** 2,
                       fracs)
    axis = 1 if per_channel else (1, 2)
    exact = np.asarray(elem).astype(np.float64).mean(axis=axis)
    n = x.shape[0] if per_channel else x.size
    return exact.reshape(100, -1), n


def assert_equal_but_near_ties(got, want, amax, x, fmt_name, per_channel):
    """``got == want`` elementwise, except where the two chosen candidates
    are a near-tie of the reference's f32 mean error: their exact mean
    errors differ by no more than the float32 summation bound
    ``n * 2**-24 * (E_a + E_b)``.  Returns how many differ (each shown to be
    a near-tie)."""
    got = np.atleast_1d(np.asarray(got))
    want = np.atleast_1d(np.asarray(want))
    diff = np.nonzero(got != want)[0]
    if diff.size == 0:
        return 0
    exact, n = reference_candidate_errors(x, amax, fmt_name, per_channel)
    am = np.atleast_1d(np.asarray(amax))
    fr = np.asarray(jnp.linspace(0.01, 1.0, 100))
    for c in diff:
        a = am[c if am.size > 1 else 0]
        i_got = int(np.argmin(np.abs(a * fr - got[c])))
        i_want = int(np.argmin(np.abs(a * fr - want[c])))
        e_got, e_want = exact[i_got, c], exact[i_want, c]
        bound = n * 2.0 ** -24 * (e_got + e_want)
        assert abs(e_got - e_want) <= bound, (
            f"channel {c}: candidates {i_got} vs {i_want} are not a near-"
            f"tie: exact errors {e_got!r} vs {e_want!r}, bound {bound!r}")
    return int(diff.size)


def reference_gptq_units(monkeypatch, w, hessian, fmt_name, cfg):
    """Run the reference's ``gptq_quantize`` recording, for every quantized
    row, the scaled values it rounds (``row / scale``): (w_qdq, units (K, N)
    in the order the rows are quantized)."""
    units = []
    orig = jg._quant_col

    def rec(row, scale, fmt):
        units.append(np.asarray(row / scale, np.float64))
        return orig(row, scale, fmt)

    monkeypatch.setattr(jg, "_quant_col", rec)
    out, info = jg.gptq_quantize(w, hessian, j_fmt(fmt_name), cfg)
    monkeypatch.setattr(jg, "_quant_col", orig)
    return out, np.stack(units), info


def tie_distance(units, fmt_name):
    """How far each scaled value sits from its rounding boundary, in units
    of its own quantum (0 = a tie)."""
    fmt = j_fmt(fmt_name)
    u = np.asarray(units, np.float64)
    if isinstance(fmt, IntFormat):
        return np.abs(np.abs(u - np.floor(u)) - 0.5)
    x = u.astype(np.float32)
    absx = np.abs(x)
    e = np.floor(np.log2(np.where(absx > 0, absx, 1.0)))
    e = np.clip(e, fmt.min_normal_exp, fmt.max_biased_exp - fmt._bias)
    q = x.astype(np.float64) / np.ldexp(1.0, (e - fmt.man_bits).astype(
        np.int32))
    return np.abs(np.abs(q - np.floor(q)) - 0.5)


def assert_gptq_equal_but_ties(got, want, units, fmt_name, perm=None,
                               tie=1e-9):
    """GPTQ outputs equal except at rounding ties (rule e): in each output
    column the first element that differs must be one the reference
    rounded from within ``tie`` of a boundary (later elements of the column
    inherit the changed error feedback).  Returns (elements that differ,
    columns with a tie)."""
    got, want = np.asarray(got), np.asarray(want)
    diff = got != want
    if not diff.any():
        return 0, 0
    order = np.arange(got.shape[0]) if perm is None else np.asarray(perm)
    dist = tie_distance(units, fmt_name)  # rows in quantization order
    cols = np.nonzero(diff.any(axis=0))[0]
    for n in cols:
        first = next(i for i, k in enumerate(order) if diff[k, n])
        assert dist[first, n] <= tie, (
            f"column {n}: row {order[first]} differs but sat "
            f"{dist[first, n]!r} quanta from a rounding boundary")
    return int(diff.sum()), int(cols.size)


# ------------------------------------------------------------------------
# Activation quantizer calls of a calibration forward
# ------------------------------------------------------------------------
class QuantizerCall(NamedTuple):
    site: str
    x: np.ndarray     # the quantizer's input: what the observer sees
    out: np.ndarray   # its QDQ output
    qmax: float       # the format's top code


def _call(site, tq, x, out):
    # calibration mode: a per-tensor int scale from the input's own max
    # (either stack's IntFormat)
    assert type(tq.fmt).__name__ == "IntFormat" and tq.scaler in (
        "static", "dynamic_max"), tq
    return QuantizerCall(site, x, out, float(tq.fmt.qmax_pos))


@contextlib.contextmanager
def reference_quantizer_calls():
    """Record the reference's activation quantizer calls, in order."""
    calls = []
    orig = j_sim.qdq_activation

    def tap(x, tq, **kw):
        out = orig(x, tq, **kw)
        if tq is not None:
            assert kw.get("alpha") is None, "not a calibration forward"
            calls.append(_call(kw.get("site", ""), tq, np.asarray(x),
                               np.asarray(out)))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_sim, "qdq_activation", tap)
        mp.setattr(j_attn, "qdq_activation", tap)
        yield calls


@contextlib.contextmanager
def port_quantizer_calls(pins=None):
    """Record the port's activation quantizer calls, in order.  With
    ``pins`` (the reference's calls of the same forward) each call records
    its own output and then returns the pinned call's, so a code flipped at
    a rounding boundary does not carry into the rest of the forward."""
    calls = []
    orig = t_sim.qdq_activation

    def tap(x, tq, **kw):
        out = orig(x, tq, **kw)
        if tq is None:
            return out
        assert kw.get("alpha") is None, "not a calibration forward"
        calls.append(_call(kw.get("site", ""), tq,
                           x.detach().cpu().numpy().copy(),
                           out.detach().cpu().numpy().copy()))
        if pins is None:
            return out
        pin = pins[len(calls) - 1]
        assert pin.site == calls[-1].site, (pin.site, calls[-1].site)
        assert pin.out.shape == tuple(out.shape), pin.site
        return torch.from_numpy(pin.out.copy()).to(out.device, out.dtype)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_sim, "qdq_activation", tap)
        mp.setattr(t_attn, "qdq_activation", tap)
        yield calls


def compare_calls(got, want):
    """(noise, changed, tie) of one quantizer call: the largest difference
    of the inputs as a share of the reference's range; how many codes
    differ; the farthest a differing code's reference value sits from its
    rounding boundary, in quanta (0.0 when none differ)."""
    assert got.site == want.site and got.x.shape == want.x.shape, (
        got.site, want.site)
    rng = max(float(np.abs(want.x).max()), 1e-8)
    noise = float(np.abs(got.x - want.x).max()) / rng

    def units(c):
        scale = (np.float32(max(float(np.abs(c.x).max()), 1e-8))
                 / np.float32(c.qmax))
        return c.x.astype(np.float64) / scale, np.rint(c.out / scale)

    u, code_want = units(want)
    _, code_got = units(got)
    changed = code_got != code_want
    tie = (float(np.abs(np.abs(u - np.floor(u)) - 0.5)[changed].max())
           if changed.any() else 0.0)
    return noise, int(changed.sum()), tie


def assert_pinned_calls_match(got_calls, want_calls):
    """Every call of a pinned forward: inputs within STATS_BAR of the
    reference's, and every code the pin changed within TIE_BAR of a
    rounding boundary.  Returns how many codes the pins changed."""
    assert [c.site for c in got_calls] == [c.site for c in want_calls]
    changed = 0
    for got, want in zip(got_calls, want_calls):
        noise, n, tie = compare_calls(got, want)
        assert noise <= STATS_BAR, (want.site, noise)
        assert tie <= TIE_BAR, (want.site, n, tie)
        changed += n
    return changed


def assert_free_calls_match(got_calls, want_calls, n_forwards):
    """Two independent calibrations, forward by forward: every call up to
    and including the first one whose codes differ has inputs within
    STATS_BAR of the reference's, and every code that differs there sits
    within TIE_BAR of a rounding boundary; the later calls of that forward
    inherit the change and are not held.  Returns (codes that first differ,
    calls that inherit)."""
    assert [c.site for c in got_calls] == [c.site for c in want_calls]
    per = len(want_calls) // n_forwards
    assert per * n_forwards == len(want_calls)
    origins = inherited = 0
    for f in range(n_forwards):
        pairs = list(zip(got_calls, want_calls))[f * per:(f + 1) * per]
        for j, (got, want) in enumerate(pairs):
            noise, n, tie = compare_calls(got, want)
            assert noise <= STATS_BAR, (f, want.site, noise)
            assert tie <= TIE_BAR, (f, want.site, n, tie)
            if n:
                origins += n
                inherited += per - j - 1
                break
    return origins, inherited


def assert_stats_match(tcal, jcal, bar=STATS_BAR):
    """Every site's statistics: the same sites in the same order and row
    counts; absmax, per-channel abs max / min / max and the reservoir rows
    within ``bar`` of the site's range; X^T X within ``bar`` of its largest
    entry."""
    assert list(tcal.stats) == list(jcal.stats)
    host = lambda t: np.asarray(t.detach().cpu().numpy()
                                if isinstance(t, torch.Tensor) else t)
    for site, want in jcal.stats.items():
        got = tcal.stats[site]
        assert got.count == want.count, site
        rng = max(float(np.abs(want.ch_absmax).max()), 1e-8)
        for name in ("absmax", "ch_absmax", "ch_min", "ch_max"):
            np.testing.assert_allclose(
                host(getattr(got, name)), np.asarray(getattr(want, name)),
                rtol=0, atol=bar * rng, err_msg=f"{site} {name}")
        np.testing.assert_allclose(
            np.concatenate([host(x) for x in got.samples]),
            np.concatenate(want.samples), rtol=0, atol=bar * rng,
            err_msg=f"{site} samples")
        assert (got.outer is None) == (want.outer is None), site
        if want.outer is not None:
            np.testing.assert_allclose(
                host(got.outer), want.outer, rtol=0,
                atol=bar * float(np.abs(want.outer).max()),
                err_msg=f"{site} outer")


# ------------------------------------------------------------------------
# Recipe results: q trees and params against the reference's
# ------------------------------------------------------------------------
def qtree_leaves(tree):
    for i, b in enumerate(tree["blocks"]):
        for g, leaves in b.items():
            for k, v in leaves.items():
                yield f"blocks.{i}/{g}/{k}", v["in_alpha"]


def site_of(key):
    """q-tree key -> the calibration site its alpha was solved from."""
    i_g, leaf = key.rsplit("/", 1)
    if leaf == "wg":
        leaf = "wi"
    return f"{i_g}/{leaf}" + ("" if leaf.startswith("bmm_")
                              or leaf == "probs" else "/in")


def assert_qtrees_match(tq, jq, jcal, fmt, per_channel=False):
    """Alphas equal (1e-5 relative) except near-ties; returns the count."""
    jleaves = dict(qtree_leaves(jax.device_get(jq)))
    tleaves = dict(qtree_leaves(tq))
    assert sorted(tleaves) == sorted(jleaves)
    ties = 0
    for key, want in jleaves.items():
        got = tleaves[key].numpy()
        want = np.asarray(want)
        close = np.abs(got - want) <= 1e-5 * np.abs(want)
        if close.all():
            continue
        st = jcal.stats[site_of(key)]
        amax = jc.max_alpha(st, per_channel=per_channel)
        ties += assert_equal_but_near_ties(
            np.where(close, want, got), want, amax,
            np.concatenate(st.samples), fmt, per_channel)
    return ties


def leaf_at(tree, path):
    """The leaf at a jax key path of a port (torch) or reference tree, as
    numpy."""
    for k in path:
        tree = tree[k.key if hasattr(k, "key") else k.idx]
    return tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(
        tree)


def params_off(params, jparams, others=STATS_BAR):
    """Params from statistics that agree within f32 noise.  A kernel
    element counts as a quantum off when it is more than 1e-4 of its
    column's largest magnitude from the reference's (an int4 quantum is at
    least 1/8 of it; a GPTQ scale taken from a column max that differs in
    its last bit moves the column by about 1e-7); every other leaf within
    ``others`` of its largest magnitude (SmoothQuant's factors from such
    statistics differ in their last bits; None: not held).  Returns (kernel
    elements a quantum off, kernel elements)."""
    n_off = n_all = 0
    for path, want in jax.tree_util.tree_leaves_with_path(
            jax.device_get(jparams)):
        got, want = leaf_at(params, path), np.asarray(want)
        if "kernel" in str(path[-1]):
            col = np.abs(want).max(axis=0, keepdims=True)
            n_off += int((np.abs(got - want) > 1e-4 * col).sum())
            n_all += want.size
        elif others is not None:
            np.testing.assert_allclose(
                got, want, rtol=0,
                atol=others * float(np.abs(want).max()), err_msg=str(path))
    return n_off, n_all
