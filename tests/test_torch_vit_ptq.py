"""PTQ over the vision encoder in the port vs the reference, on the reduced
ViT (2 layers, 32x32 images in 8x8 patches, 17 tokens) with bridged
weights and the reference's calibration images (``synthetic_images``
through an ``ImageLoader``): the passes of ``models.quant_transforms`` and
the recipe engine run on ``VitModel`` through ``model.apply`` unchanged.

Calibration observes under w4a8_mse and the static solve runs at w4a4_mse,
as the reference's ``vit_table`` does.  Each of the port's calibrations is
anchored to the reference's run at the same stage (its params; every
activation quantizer's output pinned to the reference's, each code a pin
changes shown to sit at a rounding boundary), as
``tests/test_torch_recipe.py`` holds opt-tiny's.  Held:

  * every site's statistics within ``STATS_BAR``; the same sites, and the
    same dropped sites (``head/in`` and ``patch_embed/in``: the block tree
    has no place for them);
  * alphas within 1e-5 relative but near-ties of the MSE search;
  * the reference's q tree carried across drives the port's encoder to the
    reference's logits (rtol / atol 1e-4);
  * ``smoothquant+gptq+static_mse``: at most 0.1 % of GPTQ kernel elements
    a quantum off, eval loss within 1e-4 relative of the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as j_get_config
from repro.core import policy as jp
from repro.core import recipe as jr
from repro.data.images import ImageLoader, synthetic_images
from repro.models import build_model as j_build_model
from repro.models import quant_transforms as jqt
from repro.nn.module import unbox
from repro_torch import bridge
from repro_torch.configs import get_config as t_get_config
from repro_torch.core import policy as tp
from repro_torch.core import recipe as tr
from repro_torch.models import build_model as t_build_model
from repro_torch.models import quant_transforms as tqt
from torch_ptq_helpers import (assert_pinned_calls_match,
                               assert_qtrees_match, assert_stats_match,
                               params_off, port_quantizer_calls,
                               reference_quantizer_calls)

L = 2
DROPPED = ("head/in", "patch_embed/in")
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def stacks():
    jcfg = j_get_config("vit-b16").reduced().replace(scan_layers=False)
    jmodel = j_build_model(jcfg)
    jparams = unbox(jax.jit(jmodel.init)(jax.random.PRNGKey(0)))
    tcfg = t_get_config("vit-b16").reduced().replace(scan_layers=False)
    tmodel = t_build_model(tcfg, device="cpu")
    tparams = bridge.from_repro_params(jax.device_get(jparams), tcfg,
                                       device="cpu")
    x, y = synthetic_images(12, image_size=32, n_classes=10, seed=1)
    loader = ImageLoader(x[:8], y[:8], global_batch=2, seed=77)
    return dict(jcfg=jcfg, jmodel=jmodel, jparams=jparams, tmodel=tmodel,
                tparams=tparams,
                batches=[loader.batch_at(i) for i in range(2)],
                eval={"images": x[8:], "labels": y[8:]})


def _pols(name):
    return jp.preset(name, n_layers=L), tp.preset(name, n_layers=L)


def _anchored_run(s, name):
    """``name`` run by each stack's engine at w4a4_mse, every calibration
    observing under w4a8_mse; the port's calibrations anchored to the
    reference's stages.  Returns (reference result, port result, the
    reference's stages, the params the port's engine held at each
    calibration)."""
    jpol, tpol = _pols("w4a4_mse")
    jobs, tobs = _pols("w4a8_mse")
    stages = []  # the reference's (params, quantizer calls, calibrator)

    def j_calibrate(params, collect_outer):
        with reference_quantizer_calls() as calls:
            cal = jqt.calibrate(s["jmodel"], params, s["batches"], jobs,
                                collect_outer=collect_outer)
        stages.append((params, calls, cal))
        return cal

    jres = jr.RecipeEngine(policy=jpol, n_layers=L,
                           calibrate_fn=j_calibrate).run(name, s["jparams"])
    own = []

    def t_calibrate(params, collect_outer):
        jparams, jcalls, jcal = stages[len(own)]
        own.append(params)
        anchor = bridge.from_repro_params(jax.device_get(jparams),
                                          s["jcfg"], device="cpu")
        with port_quantizer_calls(pins=jcalls) as calls:
            cal = tqt.calibrate(s["tmodel"], anchor, s["batches"], tobs,
                                collect_outer=collect_outer)
        assert_pinned_calls_match(calls, jcalls)
        assert_stats_match(cal, jcal)
        return cal

    tres = tr.RecipeEngine(policy=tpol, n_layers=L,
                           calibrate_fn=t_calibrate).run(name, s["tparams"])
    assert tres.steps == jres.steps
    assert tres.n_calibrations == jres.n_calibrations == len(stages)
    assert tres.dropped_sites == jres.dropped_sites == DROPPED
    return jres, tres, stages, own


def test_static_mse_matches_reference(stacks):
    s = stacks
    jres, tres, stages, _ = _anchored_run(s, "static_mse")
    jcal = stages[0][2]
    # every linear input, attention-BMM operand and probs site of the
    # encoder, and the two the block tree drops
    assert len(jcal.stats) == L * 10 + 2
    assert {"patch_embed/in", "head/in"} <= set(jcal.stats)
    ties = assert_qtrees_match(tres.qtree, jres.qtree, jcal, "int4")
    print(f"static_mse: {ties} near-tie alphas")
    # the reference's q tree carried across: the reference's logits
    jpol, tpol = _pols("w4a4_mse")
    qtree = bridge.from_repro_qtree(jax.device_get(jres.qtree),
                                    device="cpu")
    images = s["eval"]["images"]
    want = jax.jit(lambda p, x, q: s["jmodel"].apply(
        p, {"images": x}, jpol, q=q)[0])(s["jparams"], jnp.asarray(images),
                                         jres.qtree)
    got, _ = s["tmodel"].apply(s["tparams"], {"images": images}, tpol,
                               q=qtree)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sq_gptq_static_mse_matches_reference(stacks):
    s = stacks
    name = "smoothquant+gptq+static_mse"
    jres, tres, stages, own = _anchored_run(s, name)
    assert tres.n_calibrations == 3
    for params, (jparams, _, _) in zip(own, stages):
        n_off, n_all = params_off(params, jparams)
        assert n_off <= n_all // 1000
    n_off, n_all = params_off(tres.params, jres.params)
    assert n_off <= n_all // 1000
    assert set(tres.artifacts["gptq"]) == set(jres.artifacts["gptq"])
    ties = assert_qtrees_match(tres.qtree, jres.qtree, stages[-1][2], "int4")
    jpol, tpol = _pols("w4a4_mse")
    jloss = jax.jit(lambda p, b, q: s["jmodel"].loss(
        p, b, jp.replace_enabled(jpol, weight=None), q=q)[0])(
            jres.params, jax.tree_util.tree_map(jnp.asarray, s["eval"]),
            jres.qtree)
    tloss, _ = s["tmodel"].loss(tres.params, s["eval"],
                                tp.replace_enabled(tpol, weight=None),
                                q=tres.qtree)
    print(f"{name}: {n_off} of {n_all} GPTQ elements a quantum off, {ties} "
          f"near-tie alphas, loss {float(tloss)} vs {float(jloss)}")
    assert abs(float(tloss) - float(jloss)) <= 1e-4 * abs(float(jloss))
