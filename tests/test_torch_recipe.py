"""The recipe engine of the port vs the reference (``repro.core.recipe``),
on opt-tiny (2 layers) with bridged weights.

Tolerances:
  * registry names, dict round-trips, validation / stale-statistics
    messages, step logs, calibration counts and dropped sites: equal.
  * single-pass recipes on a bridged reference ``Calibrator``: SmoothQuant
    params bit-equal; GPTQ params equal except at rounding ties (at most
    0.1 % of elements, counted); q-tree alphas equal except at near-ties of
    the MSE search (rule c, counted and shown to be ties).
  * ``smoothquant+gptq+static_mse`` from the port's own calibrations,
    each anchored to the reference's run at the same stage (its params,
    its activation quantizer outputs; every code an anchor changes shown to
    sit at a rounding boundary): every site's statistics within
    ``STATS_BAR``, alphas within 1e-5 relative but near-ties, at most
    0.1 % of GPTQ weight elements a quantum off, eval loss within 1e-4
    relative of the reference's ``model.loss(..., q=)``.
  * Two independent runs (each stack calibrating itself) are held to the
    same steps, calibration counts and dropped sites, and to twice the
    spread the reference shows against itself under a one-ulp change of
    its embedding table, which is read in the same test and breaks the
    bars above.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import calibration as jc
from repro.core import policy as jp
from repro.core import recipe as jr
from repro.models import build_model as j_build_model
from repro.models import quant_transforms as jqt
from repro.models import serving_transforms as jst
from repro.nn.module import unbox
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tp
from repro_torch.core import recipe as tr
from repro_torch.models import build_model as t_build_model
from repro_torch.models import quant_transforms as tqt
from repro_torch.models import serving_transforms as tst
from torch_ptq_helpers import (assert_pinned_calls_match,
                               assert_qtrees_match, assert_stats_match,
                               leaf_at, params_off, port_quantizer_calls,
                               qtree_leaves, reference_quantizer_calls)

L = 2
METHODS = ("static_mse", "smoothquant+static_mse", "gptq+static_mse",
           "smoothquant+gptq+static_mse", "rptq_w4a8")


@pytest.fixture(scope="module")
def stacks():
    jcfg = j_get_config("opt-tiny").replace(n_layers=L)
    jmodel = j_build_model(jcfg)
    jparams = unbox(jmodel.init(jax.random.PRNGKey(0)))
    tcfg = t_get_config("opt-tiny").replace(n_layers=L)
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                       device="cpu")
    rng = np.random.RandomState(1)
    batches = [{"tokens": rng.randint(0, jcfg.vocab, (2, 32)).astype(
        np.int32)} for _ in range(2)]
    ev = rng.randint(0, jcfg.vocab, (2, 32)).astype(np.int32)
    labels = np.roll(ev, -1, axis=1)
    labels[:, -1] = -1
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tcfg=tcfg,
                tmodel=tmodel, tparams=tparams, batches=batches,
                eval={"tokens": ev, "labels": labels})


def _pols(name="w4a8_mse"):
    return jp.preset(name, n_layers=L), tp.preset(name, n_layers=L)


# ---------------------------------------------------------------- registry
def test_registry_and_dict_round_trip():
    assert tr.recipe_names() == jr.recipe_names()
    assert set(tr.PASS_KINDS) == set(jr.PASS_KINDS)
    for k, kind in tr.PASS_KINDS.items():
        ref = jr.PASS_KINDS[k]
        assert (kind.reads, kind.writes, kind.defaults) == (
            ref.reads, ref.writes, ref.defaults)
    names = jr.recipe_names() + ["smoothquant+gptq+static_mse",
                                 "gptq+rptq"]
    for name in names:
        d = tr.recipe_to_dict(tr.get_recipe(name))
        assert d == jr.recipe_to_dict(jr.get_recipe(name)), name
        assert tr.recipe_from_dict(d) == tr.get_recipe(name)
        assert tr.as_recipe(d).passes == tr.get_recipe(name).passes
        assert tr.quantizes_weights_offline(name) == \
            jr.quantizes_weights_offline(name)


def _error(mod, fn):
    with pytest.raises(mod.RecipeError) as e:
        fn(mod)
    return type(e.value).__name__, str(e.value)


@pytest.mark.parametrize("case", [
    "empty", "unknown_kind", "unknown_option", "bad_regex", "mutate_after",
    "unknown_name", "unknown_part", "not_a_recipe", "duplicate"])
def test_validation_errors_match_reference(case):
    def make(mod):
        Q, P = mod.QuantRecipe, mod.PassSpec
        if case == "empty":
            return Q("r").validate()
        if case == "unknown_kind":
            return Q("r", (P("awq"),)).validate()
        if case == "unknown_option":
            return Q("r", (P("gptq", options={"bits": 3}),)).validate()
        if case == "bad_regex":
            return Q("r", (P("static", sites="re:(ffn"),)).validate()
        if case == "mutate_after":
            return Q("r", (P("static"), P("smoothquant"))).validate()
        if case == "unknown_name":
            return mod.get_recipe("awq_w4")
        if case == "unknown_part":
            return mod.get_recipe("gptq+awq")
        if case == "not_a_recipe":
            return mod.as_recipe(3)
        return mod.register_recipe(Q("gptq", (P("gptq"),)))

    assert _error(tr, make) == _error(jr, make)


def test_stale_statistics_errors_match_reference(stacks):
    """Without a ``calibrate_fn``: statistics missing, lacking Hessians,
    or collected before a param-mutating pass — the same errors, and the
    same error when a calibration observes nothing (a fused policy's
    kernels never reach the observer) or the observation policy is fp32."""
    s = stacks
    jcal = jqt.calibrate(s["jmodel"], s["jparams"], s["batches"][:1],
                         _pols()[0])
    tcal = bridge.from_repro_calibrator(jcal, device="cpu")
    cases = [("gptq", None), ("gptq", "cal"), ("smoothquant+static_mse",
                                                "cal")]
    for name, cal in cases:
        msgs = []
        for mod, params, calib in ((jr, s["jparams"], jcal),
                                   (tr, s["tparams"], tcal)):
            eng = mod.RecipeEngine(policy=mod.policy_preset("w4a8_mse"),
                                   n_layers=L)
            with pytest.raises(mod.StaleCalibrationError) as e:
                eng.run(name, params, calib=calib if cal else None)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    empty = []
    for mod, calibrator, params in ((jr, jc.Calibrator, s["jparams"]),
                                    (tr, tqt.Calibrator, s["tparams"])):
        eng = mod.RecipeEngine(policy=mod.policy_preset("w4a8_mse"),
                               n_layers=L,
                               calibrate_fn=lambda p, o: calibrator())
        with pytest.raises(mod.RecipeError) as e:
            eng.run("static_mse", params)
        empty.append(str(e.value))
    assert empty[0] == empty[1] and "observed no sites" in empty[1]
    # a fused observation policy (P-fp: fused matmuls, no attention-BMM
    # QDQ): its kernels never reach the observer, nothing is observed
    fused = tp.with_attn_backend(tp.map_policies(
        tp.preset("w4a8_abfp", n=16),
        lambda q: q.replace(fused=True, attn_bmm=False)), "fused")
    with pytest.raises(tr.RecipeError, match="observed no sites"):
        tr.apply_recipe("static_mse", s["tmodel"], s["tparams"],
                        s["batches"][:1], _pols()[1], calib_policy=fused)
    msgs = []
    for mod, model, params in ((jr, s["jmodel"], s["jparams"]),
                               (tr, s["tmodel"], s["tparams"])):
        with pytest.raises(mod.RecipeError) as e:
            mod.apply_recipe("gptq", model, params, s["batches"],
                             mod.policy_preset("w4a8_mse"),
                             calib_policy=mod.policy_preset("fp32"))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------- engine runs
@pytest.fixture(scope="module")
def method_runs(stacks):
    """The methods table's five recipes, each stack calibrating itself."""
    s = stacks
    jpol, tpol = _pols()
    out = {}
    for name in METHODS:
        jres = jr.apply_recipe(name, s["jmodel"], s["jparams"],
                               s["batches"], jpol)
        tres = tr.apply_recipe(name, s["tmodel"], s["tparams"],
                               s["batches"], tpol)
        out[name] = (jres, tres)
    return out


@pytest.mark.parametrize("name", METHODS)
def test_step_log_and_calibrations_match_reference(method_runs, name):
    jres, tres = method_runs[name]
    assert tres.steps == jres.steps
    assert tres.n_calibrations == jres.n_calibrations
    assert tres.dropped_sites == jres.dropped_sites == ("embed/attend/in",)
    assert tres.n_calibrations == {"static_mse": 1, "rptq_w4a8": 1,
                                   "smoothquant+gptq+static_mse": 3}.get(
                                       name, 2)
    leaf = tres.qtree["blocks"][1]["attn"]["q"]["in_alpha"]
    assert isinstance(leaf, torch.Tensor) and leaf.device.type == "cpu"


def _assert_params_match(tparams, jparams, exact=False):
    """Kernels / norms equal; returns (elements that differ, total)."""
    jflat = jax.tree_util.tree_leaves_with_path(jax.device_get(jparams))
    n_diff = n_all = 0
    for path, want in jflat:
        got = leaf_at(tparams, path)
        d = got != np.asarray(want)
        n_diff += int(d.sum())
        n_all += d.size
        if exact or "kernel" not in str(path[-1]):
            assert not d.any(), path
    return n_diff, n_all


@pytest.mark.parametrize("name", ["static_mse", "static_max", "smoothquant",
                                  "gptq", "rptq"])
def test_single_pass_on_bridged_calibrator(stacks, name):
    s = stacks
    jpol, tpol = _pols()
    jcal = jqt.calibrate(s["jmodel"], s["jparams"], s["batches"], jpol,
                         collect_outer=True)
    tcal = bridge.from_repro_calibrator(jcal, device="cpu")
    jres = jr.RecipeEngine(policy=jpol, n_layers=L).run(
        name, s["jparams"], calib=jcal)
    tres = tr.RecipeEngine(policy=tpol, n_layers=L).run(
        name, s["tparams"], calib=tcal)
    assert tres.steps == jres.steps and tres.n_calibrations == 0
    assert tres.dropped_sites == jres.dropped_sites
    n_diff, n_all = _assert_params_match(tres.params, jres.params,
                                         exact=name != "gptq")
    assert n_diff <= n_all // 1000, (n_diff, n_all)
    if jres.qtree is not None:
        ties = assert_qtrees_match(tres.qtree, jres.qtree, jcal, "int8",
                                    per_channel=name == "rptq")
        print(f"{name}: {ties} near-tie alphas")
    if name == "rptq":
        for site, perm in jres.artifacts["rptq_perms"].items():
            np.testing.assert_array_equal(
                tres.artifacts["rptq_perms"][site], perm)
    if name == "gptq":
        assert set(tres.artifacts["gptq"]) == set(jres.artifacts["gptq"])
        print(f"gptq: {n_diff} of {n_all} elements past rounding ties")


def _pipeline_spread(res, jres, ev, model, jmodel, pol, jpol):
    """(share of GPTQ kernel elements a quantum off; the largest alpha
    difference over its leaf's largest alpha; the eval loss gap over the
    reference's loss) of a run of one recipe against the reference's."""
    n_off, n_all = params_off(res.params, jres.params, others=None)
    jleaves = dict(qtree_leaves(jax.device_get(jres.qtree)))
    leaves = dict(qtree_leaves(res.qtree))
    alpha = max(float(np.abs(np.asarray(leaves[k]) - np.asarray(v)).max()
                      / np.abs(np.asarray(v)).max())
                for k, v in jleaves.items())
    jl = _loss(jmodel, jres, ev, jpol)
    return (n_off / n_all, alpha,
            abs(_loss(model, res, ev, pol) - jl) / abs(jl))


def _loss(model, res, ev, pol):
    """The eval loss of a GPTQ recipe's result: weights as GPTQ left them
    (``weight=None``), activations through the q tree."""
    if isinstance(res.params["embed"]["table"], torch.Tensor):
        out, _ = model.loss(res.params, ev,
                            tp.replace_enabled(pol, weight=None),
                            q=res.qtree)
    else:
        out, _ = model.loss(res.params, jax.tree_util.tree_map(
            jnp.asarray, ev), jp.replace_enabled(pol, weight=None),
            q=res.qtree)
    return float(out)


def test_pipeline_on_the_ports_calibration_matches_reference(stacks):
    """``smoothquant+gptq+static_mse``: the port's engine on its own three
    calibrations vs the reference's engine on its own.  Each calibration of
    the port is its own observation forward and statistics, with two
    anchors to the reference's run at the same stage: it observes the
    params the reference holds there (the port's own differ only in
    SmoothQuant's last bits, held below, and the int4 weight QDQ of the
    observation forward turns such bits into code flips at ties), and
    every activation quantizer's output is pinned to the reference's call
    (each code a pin changes shown to sit at a rounding boundary).  Held:
    every site's statistics at every stage within STATS_BAR; the params
    each stage stood in for, and the result, with at most 0.1 % of GPTQ
    kernel elements a quantum off; the alphas within 1e-5 relative but
    near-ties; the eval loss within 1e-4 relative of the reference's
    ``model.loss(..., q=)``."""
    s = stacks
    jpol, tpol = _pols()
    name = "smoothquant+gptq+static_mse"
    stages = []   # the reference's (params, quantizer calls, calibrator)

    def j_calibrate(params, collect_outer):
        with reference_quantizer_calls() as calls:
            cal = jqt.calibrate(s["jmodel"], params, s["batches"], jpol,
                                collect_outer=collect_outer)
        stages.append((params, calls, cal))
        return cal

    jres = jr.RecipeEngine(policy=jpol, n_layers=L,
                           calibrate_fn=j_calibrate).run(name, s["jparams"])
    own_params, changed = [], []

    def t_calibrate(params, collect_outer):
        jparams, jcalls, jcal = stages[len(own_params)]
        own_params.append(params)
        anchor = bridge.from_repro_params(jax.device_get(jparams),
                                          s["tcfg"], device="cpu")
        with port_quantizer_calls(pins=jcalls) as calls:
            cal = tqt.calibrate(s["tmodel"], anchor, s["batches"], tpol,
                                collect_outer=collect_outer)
        changed.append(assert_pinned_calls_match(calls, jcalls))
        assert_stats_match(cal, jcal)
        return cal

    tres = tr.RecipeEngine(policy=tpol, n_layers=L,
                           calibrate_fn=t_calibrate).run(name, s["tparams"])
    assert tres.steps == jres.steps and tres.n_calibrations == 3
    assert tres.dropped_sites == jres.dropped_sites
    for own, (jparams, _, _) in zip(own_params, stages):
        n_off, n_all = params_off(own, jparams)
        assert n_off <= n_all // 1000
    n_off, n_all = params_off(tres.params, jres.params)
    ties = assert_qtrees_match(tres.qtree, jres.qtree, stages[-1][2],
                                "int8")
    jl = _loss(s["jmodel"], jres, s["eval"], jpol)
    tl = _loss(s["tmodel"], tres, s["eval"], tpol)
    print(f"{name}: codes changed by a pin {changed}, {n_off} of {n_all} "
          f"GPTQ elements a quantum off, {ties} near-tie alphas, loss gap "
          f"{abs(tl - jl) / abs(jl):.3g}")
    assert n_off <= n_all // 1000
    assert abs(tl - jl) <= 1e-4 * abs(jl)


def test_independent_calibrations_spread_as_the_reference_does(
        stacks, method_runs):
    """Why the pipeline above is anchored.  Readings of
    ``smoothquant+gptq+static_mse``: the reference against itself with one
    ulp added to the first half of its embedding table, and the port's
    free run (each stack calibrating itself) against the reference.  The
    reference's own spread breaks the bars the anchored pipeline meets
    (0.1 % of GPTQ elements a quantum off, alphas within 1e-5): an
    activation code flipped at a rounding boundary moves every later
    statistic, and GPTQ's error feedback on opt-tiny's nearly singular
    Hessians (128 tokens against K = 128) carries it across whole columns.
    The port's free run spreads no more than twice as far."""
    s = stacks
    jpol, tpol = _pols()
    name = "smoothquant+gptq+static_mse"
    jres, tres = method_runs[name]
    params = jax.device_get(s["jparams"])
    table = np.array(params["embed"]["table"])
    flat = table.reshape(-1)
    half = flat.size // 2
    flat[:half] = np.nextafter(flat[:half], np.float32(np.inf))
    params = dict(params, embed=dict(params["embed"],
                                     table=jnp.asarray(table)))
    jself = jr.apply_recipe(name, s["jmodel"], params, s["batches"], jpol)
    ref = _pipeline_spread(jself, jres, s["eval"], s["jmodel"],
                           s["jmodel"], jpol, jpol)
    port = _pipeline_spread(tres, jres, s["eval"], s["tmodel"],
                            s["jmodel"], tpol, jpol)
    print(f"{name}: GPTQ share a quantum off, alpha spread, loss gap: "
          f"reference vs itself + 1 ulp {ref}, port free run {port}")
    assert ref[0] > 1e-3 and ref[1] > 1e-5
    assert port[0] <= 2 * ref[0] and port[1] <= 2 * ref[1]


# ------------------------------------------------------------ the shims
def test_deprecated_shims_warn_and_delegate(stacks):
    s = stacks
    jpol, tpol = _pols()
    jcal = jqt.calibrate(s["jmodel"], s["jparams"], s["batches"], jpol,
                         collect_outer=True)
    tcal = bridge.from_repro_calibrator(jcal, device="cpu")
    from repro_torch.core.formats import get_format
    calls = [
        lambda: tqt.apply_smoothquant(s["tparams"], tcal),
        lambda: tqt.apply_gptq(s["tparams"], tcal, get_format("int4")),
        lambda: tqt.rptq_qtree(tcal, L),
        lambda: tqt.static_qtree(tcal, get_format("int8"), L),
        lambda: tqt.static_qtree(tcal, tpol, L, return_report=True),
    ]
    for call in calls:
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            call()
        assert any(issubclass(x.category, DeprecationWarning)
                   and "QuantRecipe pipeline" in str(x.message) for x in w)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        sq = tqt.apply_smoothquant(s["tparams"], tcal)
        want = jqt.apply_smoothquant(s["jparams"], jcal)
        _qt, dropped = tqt.static_qtree(tcal, tpol, L, method="max",
                                        return_report=True)
        _jq, jdropped = jqt.static_qtree(jcal, jpol, L, method="max",
                                         return_report=True)
    _assert_params_match(sq, want, exact=True)
    assert dropped == jdropped


@pytest.mark.parametrize("policy", ["w4a8_abfp", "w4a8_mse", "w4a16"])
def test_prequantize_weights_matches_reference(stacks, policy):
    s = stacks
    jpol, tpol = (jp.preset(policy, n=16), tp.preset(policy, n=16))
    got = tst.prequantize_weights(s["tparams"], tpol)
    want = jst.prequantize_weights(s["jparams"], jpol)
    _assert_params_match(got, want, exact=True)
    assert got["embed"]["table"] is s["tparams"]["embed"]["table"]
